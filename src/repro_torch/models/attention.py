"""GQA / MQA / MHA attention, full, sliding-window and cross, with
optional qkv / output biases and Qwen2-VL's M-RoPE (the JAX package's
``models/attention.py``).

The plain PyTorch math below is the ``ref`` path; the kernel path routes
through ``repro_torch.kernels.flash_attention`` (the CUDA kernels) by the
backend seam: ``kernels.backend.resolve_backend`` turns the config's
``attn_backend`` (``"auto"`` by default) into ``kernel`` for CUDA tensors
and ``ref`` for CPU tensors.  The full-sequence kernel path goes through
``attention_grad``, so training gets gradients through it.
Cross-attention (``kv_x`` / ``cross_kv``, Whisper's decoder) always takes
the plain path, as in the reference: its keys come from another sequence
length, and the reference reaches no ``pallas_call`` there.

Cache layouts
-------------
full   : {"k": [B, Smax, KV, hd], "v": [B, Smax, KV, hd]}  write at position t
window : {"k": [B, W,    KV, hd], "v": ...}                ring buffer, write at t % W

``attention_decode`` writes the new row into the cache in place (the JAX
version returns a new cache): the cache is the largest tensor a decode
step touches, and a copy per layer per step would double its traffic.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.flash_attention.ref import decode_mask
from repro_torch.models.common import (apply_mrope, apply_rope, dense,
                                       dense_init)

NEG_INF = -1e9


def attn_init(gen, cfg, dtype=torch.float32, device="cpu", cross=False):
    """Self- or cross-attention weights (``cross`` makes the same leaves,
    as in the reference)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, H * hd, cfg.use_bias, dtype, device),
        "wk": dense_init(gen, d, KV * hd, cfg.use_bias, dtype, device),
        "wv": dense_init(gen, d, KV * hd, cfg.use_bias, dtype, device),
        "wo": dense_init(gen, H * hd, d, cfg.use_bias, dtype, device),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _repeat_kv(k, n_rep):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _sdpa(q, k, v, mask):
    """q [B,Sq,H,hd] k/v [B,Sk,H,hd] mask [1,1,Sq,Sk] or broadcastable."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _causal_mask(s, device):
    """query i may see key j <= i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    return (kj <= qi)[None, None]


def _window_mask(s, window, device):
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    return ((kj <= qi) & (kj > qi - window))[None, None]


def _rotate(q, k, positions, cfg):
    """RoPE, or M-RoPE when the config has ``mrope_sections`` (then
    positions are [B, 3, S])."""
    if cfg.mrope_sections:
        return (apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def attention_forward(p, x, positions, cfg, *, causal=True, window=0,
                      kv_x=None, use_rope=True):
    """Training / prefill / encoder forward.  x [B, S, d]; positions [B,
    S] ([B, 3, S] with M-RoPE).  ``kv_x`` [B, Sk, d]: cross-attention,
    keys and values from ``kv_x``, no rope, every key visible, plain path.

    The kernel path feeds the *unrepeated* k/v to the flash kernel (query
    head h reads KV head h // (H/KV)).  Returns (out, {"k", "v"}) with the
    full k/v for prefill reuse."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = _split_heads(dense(p["wq"], x), H, hd)
    k = _split_heads(dense(p["wk"], src), KV, hd)
    v = _split_heads(dense(p["wv"], src), KV, hd)
    if use_rope and kv_x is None:
        q, k = _rotate(q, k, positions, cfg)
    if kv_x is None and resolve_backend(cfg.attn_backend, q) == "kernel":
        out = FA.attention_grad(q, k, v, causal=causal,
                                window=window if causal else 0)
    else:
        S = q.shape[1]
        if kv_x is not None or not causal:
            mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool,
                              device=x.device)
        elif window:
            mask = _window_mask(S, window, x.device)
        else:
            mask = _causal_mask(S, x.device)
        out = _sdpa(q, _repeat_kv(k, H // KV), _repeat_kv(v, H // KV), mask)
    out = dense(p["wo"], out.reshape(out.shape[:2] + (H * hd,)))
    return out, {"k": k, "v": v}


def init_cache(cfg, batch: int, max_len: int, dtype, window: int = 0,
               device="cpu"):
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    L = window if window else max_len
    return {"k": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device)}


def attention_decode(p, x, pos, cache, cfg, *, window=0, cross_kv=None,
                     use_rope=True):
    """One-token decode step.  x [B, 1, d]; pos [B] int (each row at its
    own position; with M-RoPE all three position rows are ``pos``, as the
    JAX package broadcasts its scalar position).  ``window > 0`` ->
    ring-buffer cache of that length.  ``cross_kv`` {"k", "v"} [B, Sk,
    KV, hd]: cross-attention over precomputed encoder keys and values
    (plain path; ``cache`` unused and returned as it is).

    Writes row ``pos`` (``pos % window``) of each batch row into ``cache``
    in place.  Returns (out [B, 1, d], cache)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = x.shape[0]
    q = _split_heads(dense(p["wq"], x), H, hd)
    if cross_kv is not None:
        kr = _repeat_kv(cross_kv["k"], H // KV)
        vr = _repeat_kv(cross_kv["v"], H // KV)
        mask = torch.ones((1, 1, 1, kr.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, kr, vr, mask)
        return dense(p["wo"], out.reshape(B, 1, H * hd)), cache
    k = _split_heads(dense(p["wk"], x), KV, hd)
    v = _split_heads(dense(p["wv"], x), KV, hd)
    if use_rope:
        posb = (pos[:, None, None].expand(B, 3, 1) if cfg.mrope_sections
                else pos[:, None])
        q, k = _rotate(q, k, posb, cfg)

    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(B, device=x.device)
    slot = (pos % window) if window else pos
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    if resolve_backend(cfg.attn_backend, q) == "kernel":
        out = FA.decode(q, ck, cv, pos, window=window)
    else:
        out = _gqa_decode_sdpa(q, ck, cv, decode_mask(pos, ck.shape[1], window))
    out = dense(p["wo"], out.reshape(B, 1, H * hd))
    return out, cache


def _gqa_decode_sdpa(q, ck, cv, mask):
    """Grouped-query decode attention WITHOUT materializing repeated K/V.

    q [B,1,H,hd]; ck/cv [B,L,KV,hd]; mask [B, L] (a row per batch row)."""
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bqkgd,blkd->bkgql", qg.float(), ck.float())
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", probs.to(cv.dtype), cv)
    return out.reshape(B, 1, H, hd)
