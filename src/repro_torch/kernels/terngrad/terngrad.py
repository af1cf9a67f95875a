"""Launch wrappers of the CUDA kernel ``csrc/terngrad.cu``, which replaces
both Pallas kernels of ``repro.kernels.terngrad.terngrad``:
``terngrad_ternarize`` (external scale, no clip: the segment codec's
entry) and ``terngrad_compress`` (clip to ``clip_sigma`` standard
deviations, then ternarize: the compressor's entry).  One ``__global__``
function serves both, as one kernel body does in JAX; each wrapper has its
own launch count.  The source says what bounds it on an H100 and what its
design does about it.

The clip's ``std`` (ddof 0) is a reduction taken here, outside the
kernel, as in JAX and with the plain version's own call, so sigma is bit
for bit the plain version's.  The scale ``max|clip(g)|`` is
``min(max|g|, sigma)`` (or ``max|g|`` without a clip), the same value
exactly: with a clip, the kernel folds ``max|g|`` into its pass against
the provisional scale ``sigma`` and a finishing kernel settles the scale
on the device (``csrc/terngrad.cu``); with ``clip_sigma=0`` the max comes
first and the kernel runs against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segments as SG
from repro_torch.kernels.build import library
from repro_torch.kernels.terngrad.ref import std0

LAUNCHES = {"terngrad_ternarize": 0, "terngrad_compress": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(name, g, u, sigma, s):
    R, C = SG.check_rows(name, g)
    SG.check(name, "u", u, (R, C), torch.float32, g.device)
    s, rows_per_segment = SG.scalars(name, s, R, g.device)
    if sigma is not None:
        sigma, _ = SG.scalars(name, sigma, R, g.device)
    out = torch.empty((R, C), dtype=torch.int8, device=g.device)
    rc = library().repro_terngrad(
        g.data_ptr(), u.data_ptr(),
        None if sigma is None else sigma.data_ptr(), s.data_ptr(),
        out.data_ptr(), R, C, rows_per_segment, SG.stream(g.device))
    SG.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def terngrad_ternarize(gc, u, s):
    """gc, u fp32 [R, C] on the card; s ``[]`` or ``[S]`` -> int8 [R, C]
    as ``ref.ternarize_ref``."""
    return _launch("terngrad_ternarize", gc, u, None, s)


def terngrad_compress(g, u, clip_sigma: float = 2.5):
    """g, u fp32 [R, C] on the card -> (tern int8 [R, C], scale fp32 [])
    as ``ref.terngrad_ref``.  With a clip, two kernels (the pass against
    the provisional scale and the finishing one), one launch counted."""
    if not clip_sigma:
        lo, hi = torch.aminmax(g)
        s = torch.maximum(-lo, hi)
        return _launch("terngrad_compress", g, u, None, s), s
    name = "terngrad_compress"
    R, C = SG.check_rows(name, g)
    SG.check(name, "u", u, (R, C), torch.float32, g.device)
    sigma = (std0(g) * clip_sigma).reshape(1)
    stats = torch.zeros(2, dtype=torch.float32, device=g.device)
    out = torch.empty((R, C), dtype=torch.int8, device=g.device)
    rc = library().repro_terngrad_compress(
        g.data_ptr(), u.data_ptr(), sigma.data_ptr(), stats.data_ptr(),
        out.data_ptr(), R, C, SG.stream(g.device))
    SG.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out, stats[1]
