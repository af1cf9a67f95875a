"""Plain PyTorch versions of the flash-attention kernels (fp32 math).

They compute what ``repro/kernels/flash_attention/ref.py`` computes, in
the same layouts: the CPU path of ``ops.attention`` / ``ops.decode`` and
the yardstick ``chip_smoke.py`` holds the CUDA kernels against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, S, H, hd]; k, v [B, S, KV, hd] (KV divides H).  fp32 math."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        kj = torch.arange(S, device=q.device)[None, :]
        mask = kj <= qi
        if window:
            mask &= kj > qi - window
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def decode_mask(pos, L: int, window: int = 0):
    """Per-row cache mask [B, L] for positions ``pos`` [B].  ``window > 0``
    treats the cache as a ring buffer: slot j holds the newest position
    p_j <= pos with p_j % W == j, valid iff it has been written (>= 0)."""
    idx = torch.arange(L, device=pos.device)[None, :]
    pos = pos.long()[:, None]
    if window:
        age = (pos - idx) % window        # floor mod, as in jnp
        return (pos - age) >= 0
    return idx <= pos


def decode_ref(q, ck, cv, pos, *, window: int = 0):
    """One-token decode, repeat-free grouped einsum over the cache.

    q [B, 1, H, hd]; ck, cv [B, L, KV, hd]; pos [B] int (each row decodes
    at its own position)."""
    B, _, H, hd = q.shape
    L, KV = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,blkd->bkgql", qg.float(),
                     ck.float()) / math.sqrt(hd)
    mask = decode_mask(pos, L, window)[:, None, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", p, cv.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_split_ref(q, ck, cv, pos, *, window: int = 0, chunk: int = 64):
    """The split-K decode as the CUDA kernel computes it, in plain PyTorch
    (fp32 math); used by the tests.  Per chunk of ``chunk`` cache rows, a
    partial (m, l, acc) for every query head: m the chunk's largest visible
    score (at least -1e30), l and acc the sums of exp(s - m) and of
    exp(s - m) v.  A chunk with no visible row gives the empty partial
    (m = -1e30, l = 0, acc = 0).  The partials merge with weights
    exp(m_i - M) over the non-empty ones (an empty partial weighs exactly
    0): out = sum w_i acc_i / max(sum w_i l_i, 1e-30)."""
    B, _, H, hd = q.shape
    L, KV = ck.shape[1], ck.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd) / math.sqrt(hd)
    mask = decode_mask(pos, L, window)                 # [B, L]
    ms, ls, accs = [], [], []
    for c0 in range(0, L, chunk):
        s = torch.einsum("bkgd,bckd->bkgc", qg, ck[:, c0:c0 + chunk].float())
        s = torch.where(mask[:, None, None, c0:c0 + chunk], s, -math.inf)
        m = s.amax(-1).clamp_min(NEG_INF)              # [B, KV, G]
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckd->bkgd", p,
                                 cv[:, c0:c0 + chunk].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    filled = l > 0
    M = torch.where(filled, m, NEG_INF).amax(0)
    w = torch.where(filled, torch.exp(m - M), 0.0)
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)
