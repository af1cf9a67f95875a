"""Public entries of the 1-bit kernel: ``encode_ef`` through the backend
seam, and the wire-byte accounting of the 1-bit format."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.onebit.fused import (LAUNCHES, onebit_encode_ef,
                                              reset_launches)
from repro_torch.kernels.onebit.ref import onebit_encode_ef_ref


def encode_ef(g, e=None, valid=None, *, gain: float = 1.0,
              symmetric: bool = False, backend: str = "auto"):
    """Fused 1-bit encode + EF residual (module ``ref`` for the contract).

    ``backend`` follows ``kernels.backend.resolve_backend``: a CUDA ``g``
    launches the CUDA kernel (or raises), a CPU ``g`` takes the plain
    version.  Inputs are cast to fp32 (and ``valid`` to bool) first, as
    the JAX entry casts them."""
    if g.dim() != 2:
        raise ValueError(f"encode_ef: want g [R, C], got {tuple(g.shape)}")
    for name, t in (("e", e), ("valid", valid)):
        if t is not None and t.shape != g.shape:
            raise ValueError(f"encode_ef: {name} {tuple(t.shape)} does not "
                             f"match g {tuple(g.shape)}")
    if resolve_backend(backend, g) == "kernel":
        return onebit_encode_ef(
            g.float().contiguous(),
            None if e is None else e.float().contiguous(),
            None if valid is None else (valid != 0).contiguous(),
            gain=gain, symmetric=symmetric)
    return onebit_encode_ef_ref(g, e, valid, gain=gain, symmetric=symmetric)


def wire_bytes(numel: int) -> int:
    """Bytes on the wire per tensor: 1 bit per element + 4 B scale per row
    (accounted at 256-wide rows)."""
    return numel // 8 + 4 * max(1, numel // 256)


__all__ = ["LAUNCHES", "encode_ef", "onebit_encode_ef_ref", "reset_launches",
           "wire_bytes"]
