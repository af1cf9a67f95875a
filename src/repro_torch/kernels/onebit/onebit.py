"""Launch wrapper of the CUDA kernel ``csrc/onebit_compress.cu``, which
replaces the Pallas kernel ``repro.kernels.onebit.onebit.onebit_compress``
(symmetric 1-bit compress: signs, ``mean|c|`` per row and the residual;
the source says what bounds it on an H100 and what its design does about
it).

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream,
raises on a launch error, and counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.onebit.fused import LAUNCHES, _check


def onebit_compress(g, e):
    """g, e fp32 [R, C] on the card.  Returns ``(signs int8 [R, C],
    scale fp32 [R, 1], new_e fp32 [R, C])`` as ``ref.onebit_ref`` does."""
    if g.device.type != "cuda" or g.dim() != 2 or g.numel() == 0:
        raise ValueError("onebit_compress: g must be a non-empty 2-d CUDA "
                         f"tensor, got {tuple(g.shape)} on {g.device}")
    R, C = g.shape
    for name, t in (("g", g), ("e", e)):
        _check(name, t, (R, C), torch.float32, g.device, "onebit_compress")
    signs = torch.empty((R, C), dtype=torch.int8, device=g.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=g.device)
    new_e = torch.empty_like(g)
    rc = library().repro_onebit_compress(
        g.data_ptr(), e.data_ptr(), signs.data_ptr(), scale.data_ptr(),
        new_e.data_ptr(), R, C,
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"onebit_compress kernel launch failed: CUDA error {rc}")
    LAUNCHES["onebit_compress"] += 1
    return signs, scale, new_e
