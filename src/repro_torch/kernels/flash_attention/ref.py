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
