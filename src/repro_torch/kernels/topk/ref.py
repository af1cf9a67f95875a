"""Plain PyTorch version of DGC-style sparsification (Lin et al.): the
CPU path of ``ops.sparsify`` and the yardstick ``chip_smoke.py`` holds the
CUDA kernel against (``repro/kernels/topk/ref.py``, expression for
expression), and the quantile threshold that chooses what is kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.segments import by_segment


def topk_ref(g, e, threshold):
    """g, e [R, C] (``e`` None: no residual); threshold ``[]`` or one per
    segment ``[S]``.  Returns (kept fp32 [R, C], zero below the threshold;
    new_e = c - kept)."""
    c = g.float() if e is None else g.float() + e.float()
    c3, t = by_segment(c, threshold)
    out = torch.where(c3.abs() >= t, c3, 0.0).reshape(c.shape)
    return out, c - out


def quantile_rows(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(row, q)`` (linear interpolation) of every row of
    ``x`` [S, n]: fp32 [S].

    The position follows jax's ``_quantile`` in float32: ``q`` and ``n``
    are rounded to float32 and ``pos = q * (n - 1)`` is taken in float32,
    so for n above 2^24 it picks the element jax picks, not the one a
    float64 formula would.  The two order statistics come from one
    ``torch.topk`` from the nearer end (``torch.quantile`` refuses more
    than 2^24 elements, and a full sort would also return int64 indices
    of the whole row).  A row holding a NaN gives NaN, as in jax."""
    n = x.shape[-1]
    nf = np.float32(n)
    pos = np.float32(q) * (nf - np.float32(1))
    lo_f, hi_f = np.floor(pos), np.ceil(pos)
    hw = pos - lo_f
    lw = np.float32(1) - hw
    lo = int(min(max(lo_f, 0), n - 1))
    hi = int(min(max(hi_f, 0), n - 1))
    if n - lo <= hi + 1:                  # from the top: descending values
        k = n - lo
        top = torch.topk(x, k, dim=-1, largest=True, sorted=True).values
        low_v, high_v = top[:, k - 1], top[:, k - 1 - (hi - lo)]
    else:                                 # from the bottom: ascending
        bottom = torch.topk(x, hi + 1, dim=-1, largest=False,
                            sorted=True).values
        low_v, high_v = bottom[:, lo], bottom[:, hi]
    # low * lw + high * hw with the high term fused, as XLA's CPU
    # backend contracts jax's expression into one FMA
    out = fma_f32(high_v, float(hw), low_v * float(lw))
    return torch.where(x.isnan().any(-1), torch.nan, out)


def fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for fp32 ``a``, ``c`` and an fp32-exact ``b``, rounded
    once to fp32, as a fused multiply-add rounds it.  The product is exact
    in float64; the float64 sum's rounding error (TwoSum) settles the one
    case a second rounding could get wrong, a float64 sum that lands on
    the midpoint of two fp32 neighbours."""
    t = a.double() * b
    c64 = c.double()
    s = t + c64
    bb = s - t
    err = (t - (s - bb)) + (c64 - bb)
    f = s.float()
    other = torch.nextafter(f, torch.where(s > f.double(), torch.inf,
                                           -torch.inf).float())
    mid = (f.double() + other.double()) / 2
    tie = (s == mid) & (err != 0)
    exact = torch.where(err > 0, torch.maximum(f, other),
                        torch.minimum(f, other))
    return torch.where(tie, exact, f)


def threshold_for_density(g, e, density: float, segments: int = 1):
    """Quantile threshold that keeps ~``density`` of ``|g + e|`` (``e``
    None: of ``|g|``), over the unpadded elements: fp32 ``[]``, or one per
    segment ``[segments]`` when the leading axis holds that many."""
    c = g.float() if e is None else g.float() + e.float()
    th = quantile_rows(c.abs().reshape(segments, -1), 1.0 - density)
    return th[0] if segments == 1 else th
