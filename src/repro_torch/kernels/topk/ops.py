"""Public entries of DGC sparsification: ``sparsify`` through the backend
seam, ``compress`` (the CUDA kernel itself) and the sparse wire format's
byte count."""
from __future__ import annotations

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.topk.ref import threshold_for_density, topk_ref
from repro_torch.kernels.topk.topk import (LAUNCHES, reset_launches,
                                           topk_compress)

compress = topk_compress


def sparsify(g, e, threshold, *, backend: str = "auto"):
    """Fused threshold-sparsify + error accumulation of ``c = g + e``.
    Returns (kept fp32 [R, C], new_e fp32 [R, C]).  ``backend`` follows
    ``kernels.backend.resolve_backend``: a CUDA ``g`` launches the kernel
    (or raises), a CPU ``g`` takes the plain version."""
    if g.dim() != 2 or (e is not None and e.shape != g.shape):
        raise ValueError(f"sparsify: want g, e [R, C], got {tuple(g.shape)}")
    if resolve_backend(backend, g) == "kernel":
        return topk_compress(g.float().contiguous(),
                             None if e is None else e.float().contiguous(),
                             threshold)
    return topk_ref(g, e, threshold)


def wire_bytes(numel: int, density: float) -> int:
    """(4 B index + 4 B value) per surviving element."""
    return int(numel * density) * 8


__all__ = ["LAUNCHES", "compress", "reset_launches", "sparsify",
           "threshold_for_density", "topk_ref", "wire_bytes"]
