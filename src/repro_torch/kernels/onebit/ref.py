"""Plain PyTorch version of the fused 1-bit encode + error-feedback kernel
(Seide et al.): the CPU path of ``ops.encode_ef`` and the yardstick
``chip_smoke.py`` holds the CUDA kernel against.

It computes what ``repro/kernels/onebit/ref.py::onebit_encode_ef_ref``
computes, expression for expression, with the same signature and the same
five outputs.
"""
from __future__ import annotations

import torch


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
