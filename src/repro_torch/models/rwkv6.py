"""RWKV-6 "Finch" time mix + channel mix (arXiv:2404.05892; the JAX
package's ``models/rwkv6.py``).

A per-head (hs x hs) matrix state with data-dependent decay w_t made by a
LoRA on the token-shifted input, the bonus u, receptance / key / value /
gate projections, and the squared-ReLU channel mix with receptance.  As
in the reference, the five-way ddlerp token shift is one learned lerp per
stream.  The JAX package walks the sequence with ``jax.lax.scan``; here
it is a loop over tokens with the same fp32 einsums.  The state ``S``
stays fp32 whatever the cache dtype, and so do ``mu``, ``w0``, ``wA``,
``wB`` and ``u`` under bf16 parameters.  No kernel: the reference reaches
no ``pallas_call`` here.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense, dense_init, norm_apply, norm_init

_DECAY_LORA = 64


def rwkv_init(gen, cfg, dtype=torch.float32, device="cpu"):
    d, hs = cfg.d_model, cfg.rwkv_head_size
    H = d // hs

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32)

    def full(v):
        return torch.full((d,), v, dtype=torch.float32, device=device)

    return {
        # token-shift lerp coefficients per stream
        "mu": {s: full(0.5) for s in ("r", "k", "v", "g", "w")},
        "w_r": dense_init(gen, d, d, False, dtype, device),
        "w_k": dense_init(gen, d, d, False, dtype, device),
        "w_v": dense_init(gen, d, d, False, dtype, device),
        "w_g": dense_init(gen, d, d, False, dtype, device),
        "w_o": dense_init(gen, d, d, False, dtype, device),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-5.0),
        "wA": normal(d, _DECAY_LORA) * 0.01,
        "wB": normal(_DECAY_LORA, d) * 0.01,
        "u": normal(H, hs) * 0.1,
        "gn": norm_init("layernorm", d, device=device),  # per-head group norm
        # channel mix
        "cm_mu": {s: full(0.5) for s in ("k", "r")},
        "cm_k": dense_init(gen, d, cfg.d_ff, False, dtype, device),
        "cm_v": dense_init(gen, cfg.d_ff, d, False, dtype, device),
        "cm_r": dense_init(gen, d, d, False, dtype, device),
    }


def _token_shift(x, prev):
    """x [B, S, d]; prev [B, d] (the token before x) -> shifted x."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decay(p, xw):
    raw = p["w0"] + torch.tanh(xw.float() @ p["wA"]) @ p["wB"]
    return torch.exp(-torch.exp(raw))               # in (0, 1)


def token_step(k_t, v_t, r_t, w_t, u, S_h):
    """One token of the time mix: (y_t [B, H, hs], the next state)."""
    kv = torch.einsum("bhk,bhv->bhkv", k_t.float(), v_t.float())
    y_t = torch.einsum("bhk,bhkv->bhv", r_t.float(), S_h + u * kv)
    return y_t, w_t.float()[..., None] * S_h + kv


def _wkv(k, v, r, w, u, S_h):
    """The token loop: k/v/r/w [B, S, H, hs], state S_h [B, H, hs, hs]
    fp32 -> (y [B, S, H, hs] fp32, the last state)."""
    ys = []
    for t in range(k.shape[1]):
        y_t, S_h = token_step(k[:, t], v[:, t], r[:, t], w[:, t], u, S_h)
        ys.append(y_t)
    return torch.stack(ys, dim=1), S_h


def time_mix_forward(p, x, cfg, state=None):
    """x [B, S, d]; state {"S": [B, H, hs, hs] fp32, "shift": [B, d]} or
    None.  Returns (out, new_state)."""
    B, S, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    if state is None:
        state = {"S": x.new_zeros((B, H, hs, hs), dtype=torch.float32),
                 "shift": x.new_zeros((B, d))}
    xx = _token_shift(x, state["shift"])
    r = dense(p["w_r"], _mix(x, xx, p["mu"]["r"])).reshape(B, S, H, hs)
    k = dense(p["w_k"], _mix(x, xx, p["mu"]["k"])).reshape(B, S, H, hs)
    v = dense(p["w_v"], _mix(x, xx, p["mu"]["v"])).reshape(B, S, H, hs)
    g = torch.nn.functional.silu(dense(p["w_g"], _mix(x, xx, p["mu"]["g"])))
    w = _decay(p, _mix(x, xx, p["mu"]["w"])).reshape(B, S, H, hs)
    u = p["u"][None, :, :, None]
    y, S_h = _wkv(k, v, r, w, u, state["S"].float())
    y = y.reshape(B, S, d)
    y = norm_apply("layernorm", p["gn"], y.to(x.dtype))
    out = dense(p["w_o"], y * g)
    return out, {"S": S_h, "shift": x[:, -1]}


def channel_mix_forward(p, x, cfg, shift=None):
    B, S, d = x.shape
    if shift is None:
        shift = x.new_zeros((B, d))
    xx = _token_shift(x, shift)
    k = dense(p["cm_k"], _mix(x, xx, p["cm_mu"]["k"]))
    k = torch.relu(k).square()
    r = torch.sigmoid(dense(p["cm_r"], _mix(x, xx, p["cm_mu"]["r"])))
    return r * dense(p["cm_v"], k), x[:, -1]


def rwkv_init_state(cfg, batch: int, dtype, device="cpu"):
    d, hs = cfg.d_model, cfg.rwkv_head_size
    H = d // hs
    return {"S": torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                             device=device),
            "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device)}


def rwkv_block_decode(p_tm, p_cm, ln1, ln2, cfg, x, st):
    """One-token step for a full rwkv block (time mix + channel mix).
    x [B, 1, d]; returns (x, new state in the state's dtypes)."""
    h, new_tm = time_mix_forward(
        p_tm, norm_apply("layernorm", ln1, x), cfg,
        {"S": st["S"], "shift": st["shift_tm"]})
    x = x + h
    h, new_shift_cm = channel_mix_forward(
        p_cm, norm_apply("layernorm", ln2, x), cfg, st["shift_cm"])
    x = x + h
    return x, {"S": new_tm["S"].to(st["S"].dtype),
               "shift_tm": new_tm["shift"].to(st["shift_tm"].dtype),
               "shift_cm": new_shift_cm.to(st["shift_cm"].dtype)}
