"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; the JAX
package's ``models/mla.py``).

KV activations are compressed into a rank-``kv_lora_rank`` latent c_kv
plus a shared (per-token, head-agnostic) rope key.  The decode cache holds
only ``{c_kv [B, L, r], k_rope [B, L, rd]}``: cache bytes per token are
``kv_lora_rank + qk_rope_dim`` elements per layer.

This is the "naive" formulation: K/V are re-expanded from the latent at
attention time, with the score scale ``1/sqrt(nd + rd)`` and a ``-1e9``
mask.  The reference keeps it outside Pallas, and so it stays plain
PyTorch on every device (the flash kernels take no shared rope key).

``mla_decode`` carries a position per batch row: it writes each row's
latent at its own position in place and masks each row's own prefix.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import _causal_mask
from repro_torch.models.common import apply_rope, dense, dense_init

NEG_INF = -1e9


def mla_init(gen, cfg, dtype=torch.float32, device="cpu"):
    d, H = cfg.d_model, cfg.num_heads
    r, rd, nd, vd = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    b = cfg.use_bias
    return {"w_q": dense_init(gen, d, H * (nd + rd), b, dtype, device),
            "w_dkv": dense_init(gen, d, r, b, dtype, device),
            "w_krope": dense_init(gen, d, rd, b, dtype, device),
            "w_uk": dense_init(gen, r, H * nd, b, dtype, device),
            "w_uv": dense_init(gen, r, H * vd, b, dtype, device),
            "w_o": dense_init(gen, H * vd, d, b, dtype, device)}


def _project_q(p, x, positions, cfg):
    H, nd, rd = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = dense(p["w_q"], x).reshape(x.shape[:2] + (H, nd + rd))
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)


def _expand_kv(p, c_kv, cfg):
    H, nd, vd = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    k_nope = dense(p["w_uk"], c_kv).reshape(c_kv.shape[:2] + (H, nd))
    v = dense(p["w_uv"], c_kv).reshape(c_kv.shape[:2] + (H, vd))
    return k_nope, v


def _attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg):
    """Scores of the per-head nope part plus the shared rope key, masked
    by ``mask`` (broadcastable to [B, H, Sq, Sk]) -> the w_o output."""
    H, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    dt = torch.promote_types(q_nope.dtype, c_kv.dtype)
    k_nope, v = _expand_kv(p, c_kv.to(dt), cfg)
    s_nope = torch.einsum("bqhd,bkhd->bhqk", q_nope.to(dt), k_nope)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.to(dt), k_rope.to(dt))
    scores = (s_nope + s_rope).float() * (1.0 / math.sqrt(nd + rd))
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    B, S = out.shape[:2]
    return dense(p["w_o"], out.reshape(B, S, H * vd))


def mla_forward(p, x, positions, cfg):
    """Training / prefill forward.  x [B, S, d]; positions [B, S].
    Returns (out, cache={c_kv [B, S, r], k_rope [B, S, rd]})."""
    q_nope, q_rope = _project_q(p, x, positions, cfg)
    c_kv = dense(p["w_dkv"], x)                                 # [B, S, r]
    k_rope = apply_rope(dense(p["w_krope"], x)[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]              # [B, S, rd]
    out = _attend(p, q_nope, q_rope, c_kv, k_rope,
                  _causal_mask(x.shape[1], x.device), cfg)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device="cpu"):
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p, x, pos, cache, cfg):
    """One-token decode.  x [B, 1, d]; pos [B] int (each row at its own
    position).  Writes row ``pos`` of each batch row's latents into
    ``cache`` in place; returns (out [B, 1, d], cache)."""
    B = x.shape[0]
    q_nope, q_rope = _project_q(p, x, pos[:, None], cfg)
    c_new = dense(p["w_dkv"], x)                                # [B, 1, r]
    kr_new = apply_rope(dense(p["w_krope"], x)[..., None, :], pos[:, None],
                        cfg.rope_theta)[..., 0, :]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    rows = torch.arange(B, device=x.device)
    c_kv[rows, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, pos] = kr_new[:, 0].to(k_rope.dtype)
    L = c_kv.shape[1]
    mask = (torch.arange(L, device=x.device)[None] <= pos[:, None])
    out = _attend(p, q_nope, q_rope, c_kv, k_rope, mask[:, None, None, :],
                  cfg)
    return out, cache
