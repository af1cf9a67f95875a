"""Launch wrapper of the CUDA kernel ``csrc/onebit_encode_ef.cu``, which
replaces the Pallas kernel ``repro.kernels.onebit.fused.onebit_encode_ef``
(fused 1-bit encode + error-feedback residual; the source says what
bounds it on an H100 and what its design does about it).

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream,
raises on a launch error, and counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import library

# launch counts of both 1-bit kernels (``onebit.py`` counts its own)
LAUNCHES = {"onebit_encode_ef": 0, "onebit_compress": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, t, shape, dtype, device, kernel="onebit_encode_ef"):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{kernel}: {name} must be {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be contiguous and "
                         "16-byte aligned")


def onebit_encode_ef(g, e=None, valid=None, *, gain: float = 1.0,
                     symmetric: bool = False):
    """g fp32 [R, C]; e fp32 [R, C] or None; valid bool [R, C] or None, all
    on the card.  Returns ``(signs int8 [R,C], sp [R,1], sn [R,1],
    out [R,C], new_e [R,C])`` as ``ref.onebit_encode_ef_ref`` does."""
    if g.device.type != "cuda" or g.dim() != 2 or g.numel() == 0:
        raise ValueError("onebit_encode_ef: g must be a non-empty 2-d CUDA "
                         f"tensor, got {tuple(g.shape)} on {g.device}")
    R, C = g.shape
    _check("g", g, (R, C), torch.float32, g.device)
    if e is not None:
        _check("e", e, (R, C), torch.float32, g.device)
    if valid is not None:
        _check("valid", valid, (R, C), torch.bool, g.device)
    signs = torch.empty((R, C), dtype=torch.int8, device=g.device)
    sp = torch.empty((R, 1), dtype=torch.float32, device=g.device)
    sn = torch.empty_like(sp)
    out = torch.empty_like(g)
    new_e = torch.empty_like(g)
    rc = library().repro_onebit_encode_ef(
        g.data_ptr(), None if e is None else e.data_ptr(),
        None if valid is None else valid.data_ptr(), signs.data_ptr(),
        sp.data_ptr(), sn.data_ptr(), out.data_ptr(), new_e.data_ptr(),
        R, C, float(gain), int(symmetric),
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"onebit_encode_ef kernel launch failed: CUDA error {rc}")
    LAUNCHES["onebit_encode_ef"] += 1
    return signs, sp, sn, out, new_e
