"""Public entries of QSGD: ``quantize`` through the backend seam,
``compress`` (the CUDA kernel itself), ``decompress`` and the wire
format's byte count."""
from __future__ import annotations

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.qsgd.qsgd import (LAUNCHES, qsgd_compress,
                                           reset_launches)
from repro_torch.kernels.qsgd.ref import qsgd_decompress_ref, qsgd_ref

compress = qsgd_compress
decompress = qsgd_decompress_ref


def quantize(g, u, *, s_levels: int = 127, segments: int = 1,
             backend: str = "auto"):
    """s-level stochastic quantize through the backend seam: a CUDA ``g``
    launches the kernel (or raises), a CPU ``g`` takes the plain version.
    Returns (levels int8 [R, C], norm fp32 ``[]`` or ``[segments]``)."""
    if g.dim() != 2 or u.shape != g.shape:
        raise ValueError(f"quantize: want g, u [R, C], got "
                         f"{tuple(g.shape)}, {tuple(u.shape)}")
    if resolve_backend(backend, g) == "kernel":
        return qsgd_compress(g.float().contiguous(), u.float().contiguous(),
                             s_levels, segments)
    return qsgd_ref(g, u, s_levels, segments)


def wire_bytes(numel: int, s_levels: int = 127) -> int:
    """8-bit levels (s = 127) + 4 B norm."""
    return numel + 4


__all__ = ["LAUNCHES", "compress", "decompress", "qsgd_ref", "quantize",
           "reset_launches", "wire_bytes"]
