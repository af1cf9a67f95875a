"""Elastic worker-set pieces of the port (backup workers)."""
