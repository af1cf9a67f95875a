"""Serving plane of the port: continuous batching over a paged KV cache,
and ``generate`` over it."""
from repro_torch.serve.serve_loop import generate, greedy_sample

__all__ = ["generate", "greedy_sample"]
