"""Observability of the port (``percentile`` for now)."""
