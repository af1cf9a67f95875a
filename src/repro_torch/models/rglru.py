"""Griffin recurrent block: temporal conv + RG-LRU (arXiv:2402.19427; the
JAX package's ``models/rglru.py``).

The RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
is a linear first-order recurrence.  The JAX package runs it through
``jax.lax.associative_scan``; here it is a log-depth doubling scan in
fp32: ceil(log2 S) combines of (a, b) pairs on whole tensors, no loop
over tokens.  Both are exact up to fp32 rounding, which they round in
other orders.  Decode carries (h, conv buffer), constant in sequence
length.  No kernel: the reference reaches no ``pallas_call`` here.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, dense, dense_init

_C = 8.0  # Griffin's fixed scaling constant


def rglru_init(gen, cfg, dtype=torch.float32, device="cpu"):
    """The JAX init's distributions; ``lam`` (fp32 whatever ``dtype``) is
    the reference's own draw from ``np.random.RandomState(0)``."""
    d, w, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    # Lambda parametrized so a = exp(-C * softplus(lam) * sigmoid(rg)) starts
    # near the Griffin init (a^C in [0.9, 0.999]).
    lam0 = np.log(np.expm1(-np.log(np.random.RandomState(0).uniform(
        0.9, 0.999, size=(w,)) ** (1.0 / _C))))
    conv_w = torch.randn(cw, w, generator=gen, device=device,
                         dtype=torch.float32) / math.sqrt(cw)
    return {
        "w_x": dense_init(gen, d, w, False, dtype, device),
        "w_gate_branch": dense_init(gen, d, w, False, dtype, device),
        "w_out": dense_init(gen, w, d, False, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(w, dtype=dtype, device=device),
        "w_rg": dense_init(gen, w, w, False, dtype, device),
        "w_ig": dense_init(gen, w, w, False, dtype, device),
        "lam": torch.tensor(lam0, dtype=torch.float32, device=device),
    }


def _causal_conv(p, u, buf=None):
    """u [B, S, w]; width-cw causal conv.  buf [B, cw-1, w] is the decode
    context (last cw-1 inputs); returns (y, new_buf) in the promoted dtype
    of u and buf, as the reference's concatenation gives."""
    cw = p["conv_w"].shape[0]
    if buf is None:
        buf = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    dt = torch.promote_types(buf.dtype, u.dtype)
    ext = torch.cat([buf.to(dt), u.to(dt)], dim=1)          # [B, cw-1+S, w]
    S = u.shape[1]
    y = sum(ext[:, i:i + S] * p["conv_w"][i].to(dt) for i in range(cw))
    y = y + p["conv_b"].to(dt)
    return y, ext[:, ext.shape[1] - (cw - 1):]


def _gates(p, u):
    r = torch.sigmoid(dense(p["w_rg"], u).float())
    i = torch.sigmoid(dense(p["w_ig"], u).float())
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)            # [B, S, w]
    gated_in = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (
        i * u.float())
    return a, gated_in


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 with h_{-1} = 0, by doubling:
    after the step of stride s every (a_t, b_t) holds the combine of the
    2s pairs ending at t, as ``associative_scan``'s ``(a1 a2, a2 b1 +
    b2)``.  Returns h."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_forward(p, x, h0=None, conv_buf=None):
    """Full-sequence forward.  x [B, S, d] -> (out, (h_last, conv_buf))."""
    gelu_branch = activation("gelu", dense(p["w_gate_branch"], x))
    u = dense(p["w_x"], x)
    u, new_buf = _causal_conv(p, u, conv_buf)
    a, b = _gates(p, u)
    if h0 is not None:
        # fold the initial state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    h = linear_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    out = dense(p["w_out"], h.to(x.dtype) * gelu_branch)
    return out, (h[:, -1].to(x.dtype), new_buf)


def rglru_init_state(cfg, batch: int, dtype, device="cpu"):
    w, cw = cfg.lru_width or cfg.d_model, cfg.conv_width
    return {"h": torch.zeros((batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p, x, state):
    """One-token step.  x [B, 1, d]; returns (out, new state in the
    state's dtypes)."""
    gelu_branch = activation("gelu", dense(p["w_gate_branch"], x))
    u = dense(p["w_x"], x)
    u, new_conv = _causal_conv(p, u, state["conv"])
    a, b = _gates(p, u)                                     # [B, 1, w]
    h = a[:, 0] * state["h"].float() + b[:, 0]
    out = dense(p["w_out"], h[:, None].to(x.dtype) * gelu_branch)
    return out, {"h": h.to(state["h"].dtype),
                 "conv": new_conv.to(state["conv"].dtype)}
