"""Plain PyTorch version of TernGrad (Wen et al.): ``g -> s * sign(g) * b``
with ``b ~ Bernoulli(|g| / s)`` and ``s = max|g|`` after clipping to
``clip_sigma`` standard deviations.  The uniform draw ``u`` is an input,
so the kernel and this version see the same bits.  Expression for
expression ``repro/kernels/terngrad/ref.py``; the CPU path of ``ops`` and
the yardstick ``chip_smoke.py`` holds the CUDA kernels against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segments import by_segment


def std0(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Standard deviation at ddof 0, as ``jnp.std`` takes it
    (``torch.std`` defaults to correction 1)."""
    var, _ = torch.var_mean(x, dim=dim, correction=0)
    return var.sqrt()


def terngrad_ref(g, u, clip_sigma: float = 2.5):
    """g, u [R, C] -> (tern int8 {-1, 0, 1} [R, C], scale fp32 [])."""
    g32 = g.float()
    if clip_sigma:
        sigma = std0(g32)
        g32 = torch.clamp(g32, -clip_sigma * sigma, clip_sigma * sigma)
    s = g32.abs().max()
    p = g32.abs() / torch.clamp_min(s, 1e-30)
    b = (u < p).to(torch.int8)
    return torch.sign(g32).to(torch.int8) * b, s


def ternarize_ref(gc, u, s):
    """Plain version of ``terngrad_ternarize``: pre-clipped rows ``gc``
    [R, C] against an external scale ``s`` (``[]`` or one per segment
    ``[S]``) -> int8 [R, C]."""
    gc3, s3 = by_segment(gc.float(), s)
    p = gc3.abs() / torch.clamp_min(s3, 1e-30)
    b = (u.reshape(gc3.shape) < p).to(torch.int8)
    return (torch.sign(gc3).to(torch.int8) * b).reshape(gc.shape)


def terngrad_decompress_ref(tern, s):
    """int8 [R, C] times the scale (``[]`` or per segment ``[S]``)."""
    t3, s3 = by_segment(tern.float(), s)
    return (t3 * s3).reshape(tern.shape)
