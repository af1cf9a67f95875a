"""Plain PyTorch versions of the two 1-bit kernels (Seide et al.): the CPU
paths of ``ops.compress`` and ``ops.encode_ef`` and the yardsticks
``chip_smoke.py`` holds the CUDA kernels against.

They compute what ``repro/kernels/onebit/ref.py``'s ``onebit_ref``,
``onebit_decompress_ref`` and ``onebit_encode_ef_ref`` compute,
expression for expression, with the same signatures and outputs.
"""
from __future__ import annotations

import torch


def onebit_ref(g, e):
    """g, e [R, C] -> (signs int8 in {-1, +1}, scale [R, 1] f32, new_e):
    ``c = g + e`` (``c >= 0`` -> +1), ``scale = mean|c|`` per row,
    ``new_e = c - sign * scale``."""
    c = g.float() + e.float()
    signs = torch.where(c >= 0, 1, -1).to(torch.int8)
    scale = c.abs().mean(-1, keepdim=True)
    decompressed = signs.float() * scale
    new_e = c - decompressed
    return signs, scale, new_e


def onebit_decompress_ref(signs, scale):
    return signs.float() * scale


def onebit_encode_ef_ref(g, e=None, valid=None, *, gain: float = 1.0,
                         symmetric: bool = False):
    """g [R, C]; e, valid optional [R, C] (valid: nonzero = real element).

    Returns ``(signs int8 [R,C], sp f32 [R,1], sn f32 [R,1], out f32 [R,C],
    new_e f32 [R,C])``: ``c_in = g + gain*e`` is quantized to its signs
    (``c_in >= 0`` -> +1), each sign bin decodes to the mean of the valid
    values that fell into it (both to ``mean|c_in|`` when ``symmetric``),
    masked elements decode to 0, and ``new_e = (g + e) - out``."""
    g = g.float()
    if e is not None:
        e = e.float()
        cin = g + gain * e
        ctrue = g + e
    else:
        cin = ctrue = g
    signs = torch.where(cin >= 0, 1, -1).to(torch.int8)
    if valid is not None:
        valid = valid != 0
    if symmetric:
        sp = sn = cin.abs().mean(-1, keepdim=True)
    else:
        pos = signs > 0
        neg = ~pos
        if valid is not None:
            pos = pos & valid
            neg = neg & valid
        npos = pos.sum(-1, keepdim=True).clamp_min(1)
        nneg = neg.sum(-1, keepdim=True).clamp_min(1)
        sp = torch.where(pos, cin, 0.0).sum(-1, keepdim=True) / npos
        sn = torch.where(neg, -cin, 0.0).sum(-1, keepdim=True) / nneg
    recon = torch.where(signs > 0, sp, -sn)
    out = recon if valid is None else torch.where(valid, recon, 0.0)
    return signs, sp, sn, out, ctrue - out
