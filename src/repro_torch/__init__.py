"""PyTorch / CUDA port of the ``repro`` package.

Mirrors ``repro``'s module names; the JAX package stays the reference the
tests compare against.  This package imports ``torch`` and never ``jax``
or ``repro``.
"""
