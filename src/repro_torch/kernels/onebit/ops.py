"""Public entries of the 1-bit kernels: ``compress`` and ``encode_ef``
through the backend seam, ``decompress``, the wire format's bit packing
and its wire-byte accounting."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.onebit.fused import (LAUNCHES, onebit_encode_ef,
                                              reset_launches)
from repro_torch.kernels.onebit.onebit import onebit_compress
from repro_torch.kernels.onebit.ref import (onebit_decompress_ref,
                                            onebit_encode_ef_ref, onebit_ref)


def compress(g, e, *, backend: str = "auto"):
    """Symmetric 1-bit compress of ``c = g + e`` [R, C]: ``(signs int8,
    scale f32 [R, 1], new_e f32)`` (module ``ref.onebit_ref`` for the
    contract), through the backend seam: a CUDA ``g`` launches the CUDA
    kernel (or raises), a CPU ``g`` takes the plain version."""
    if g.dim() != 2 or e.shape != g.shape:
        raise ValueError(f"compress: want g, e [R, C], got {tuple(g.shape)}"
                         f", {tuple(e.shape)}")
    if resolve_backend(backend, g) == "kernel":
        return onebit_compress(g.float().contiguous(),
                               e.float().contiguous())
    return onebit_ref(g, e)


decompress = onebit_decompress_ref


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


def pack_bits(signs):
    """int8 signs {-1, +1} [..., C] (C % 32 == 0) -> int32 words
    [..., C // 32]: the on-the-wire format, 1 bit per gradient element.

    Bit ``j`` of word ``w`` is ``signs[..., 32 w + j] > 0``, the JAX
    package's ``uint32`` layout.  The words are held as int32 with the
    same 32 bits (torch has no shifts for uint32 on the CPU); the sums
    are taken in int64 and folded into the int32 range."""
    *lead, C = signs.shape
    bits = (signs > 0).reshape(*lead, C // 32, 32)
    words = torch.zeros(bits.shape[:-1], dtype=torch.int64,
                        device=signs.device)
    for j in range(32):
        words |= bits[..., j].to(torch.int64) << j
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_bits(words, C=None):
    """int32 words [..., W] -> int8 signs {-1, +1} [..., 32 W] (the first
    ``C`` of them when given)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1      # arithmetic shift: bit j
    signs = (2 * bits - 1).to(torch.int8).reshape(*words.shape[:-1], -1)
    return signs if C is None else signs[..., :C]


def wire_bytes(numel: int) -> int:
    """Bytes on the wire per tensor: 1 bit per element + 4 B scale per row
    (accounted at 256-wide rows)."""
    return numel // 8 + 4 * max(1, numel // 256)


__all__ = ["LAUNCHES", "compress", "decompress", "encode_ef",
           "onebit_encode_ef_ref", "onebit_ref", "pack_bits",
           "reset_launches", "unpack_bits", "wire_bytes"]
