"""Public entries of TernGrad: ``ternarize`` through the backend seam,
``compress`` (the CUDA kernel itself), ``decompress`` and the wire
format's byte count."""
from __future__ import annotations

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.terngrad.ref import (ternarize_ref,
                                              terngrad_decompress_ref,
                                              terngrad_ref)
from repro_torch.kernels.terngrad.terngrad import (LAUNCHES, reset_launches,
                                                   terngrad_compress,
                                                   terngrad_ternarize)

compress = terngrad_compress
decompress = terngrad_decompress_ref


def ternarize(gc, u, s, *, backend: str = "auto"):
    """Stochastic ternarize of pre-clipped rows against an external scale
    (``[]`` or one per segment), through the backend seam: a CUDA ``gc``
    launches the kernel (or raises), a CPU ``gc`` takes the plain
    version."""
    if gc.dim() != 2 or u.shape != gc.shape:
        raise ValueError(f"ternarize: want gc, u [R, C], got "
                         f"{tuple(gc.shape)}, {tuple(u.shape)}")
    if resolve_backend(backend, gc) == "kernel":
        return terngrad_ternarize(gc.float().contiguous(),
                                  u.float().contiguous(), s)
    return ternarize_ref(gc, u, s)


def wire_bytes(numel: int) -> int:
    """2 bits per element (16 ternary digits per 32-bit word) + 4 B
    scale."""
    return numel // 4 + 4


__all__ = ["LAUNCHES", "compress", "decompress", "reset_launches",
           "ternarize", "ternarize_ref", "terngrad_ref", "wire_bytes"]
