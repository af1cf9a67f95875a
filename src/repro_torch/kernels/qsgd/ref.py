"""Plain PyTorch version of QSGD (Alistarh et al.): s-level stochastic
quantization ``Q(g_i) = ||g|| * sign(g_i) * xi_i / s`` with
``p = |g_i| / ||g|| * s`` and ``xi = floor(p) + Bernoulli(frac(p))``.  The
uniform draw ``u`` is an input.  Expression for expression
``repro/kernels/qsgd/ref.py``, with the norm taken per segment (one per
worker in the segment codec); the CPU path of ``ops`` and the yardstick
``chip_smoke.py`` holds the CUDA kernel against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segments import by_segment, per_segment


def l2_norms(g, segments: int = 1):
    """The l2 norm of each of ``segments`` equal row blocks of ``g``:
    fp32 ``[]`` for one segment, else ``[segments]`` (each block reduced
    alone on the card: ``segments.per_segment``)."""
    norm = per_segment(lambda t, dim: torch.linalg.vector_norm(t, dim=dim),
                       g.float().reshape(segments, -1))
    return norm[0] if segments == 1 else norm


def qsgd_ref(g, u, s_levels: int = 127, segments: int = 1):
    """g, u [R, C] -> (levels int8 [R, C], norm fp32 ``[]`` or
    ``[segments]``)."""
    norm = l2_norms(g, segments)
    g3, n3 = by_segment(g.float(), norm)
    p = g3.abs() / torch.clamp_min(n3, 1e-30) * s_levels
    lo = torch.floor(p)
    lvl = lo + (u.reshape(g3.shape) < (p - lo)).float()
    lvl = torch.clamp(lvl, 0, s_levels)
    return (torch.sign(g3) * lvl).to(torch.int8).reshape(g.shape), norm


def qsgd_decompress_ref(q, norm, s_levels: int = 127):
    q3, n3 = by_segment(q.float(), norm)
    return (q3 * (n3 / s_levels)).reshape(q.shape)
