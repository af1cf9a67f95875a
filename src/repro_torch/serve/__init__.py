"""Serving plane of the port: continuous batching over a paged KV cache."""
