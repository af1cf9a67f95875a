"""Token-choice top-k MoE with sort-based capacity dispatch (the JAX
package's ``models/moe.py``).

The survey's hybrid-parallelism discussion (§3.2.4) maps MoE onto the
"parameter dimension": experts are a stacked ``[E, d, ff]`` axis, and
token dispatch is the all-to-all of parameter-heavy layers.

Dispatch is sort-based (no [T, E, C] one-hot): assignments -> stable sort
by expert id -> per-expert positions from cumulative counts -> gather
into an ``[E, C, d]`` buffer -> batched expert SwiGLU -> gather back and
the gate-weighted combine.  Shapes depend only on (T, K, E, C).

``per_row=True`` makes every batch row its own dispatch group with its own
capacity, as the JAX package's serving step gets by vmapping decode over
slots at batch 1: at decode each slot routes alone (T = 1, C = ⌈K·factor
/ E⌉) and never drops a token, whatever the other slots chose.  The
groups share one batched expert product (``[E, groups·C, d]``).

The router runs in fp32.  There is no Pallas kernel here in the
reference, so the expert products stay ``torch.bmm``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, mlp_apply, mlp_init


def moe_init(gen, cfg, dtype=torch.float32, device="cpu"):
    """The JAX package's distributions: router ``normal / sqrt(d)`` in
    fp32, stacked experts ``normal / sqrt(in)``, a SwiGLU shared expert of
    width ``moe_d_ff * num_shared_experts``."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def normal(*shape, fan_in):
        return (torch.randn(*shape, generator=gen, device=device,
                            dtype=torch.float32) / math.sqrt(fan_in)).to(dtype)

    p = {"router": dense_init(gen, d, E, False, torch.float32, device),
         "w_gate": normal(E, d, ff, fan_in=d),
         "w_up": normal(E, d, ff, fan_in=d),
         "w_down": normal(E, ff, d, fan_in=ff)}
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.num_shared_experts, "swiglu",
                               cfg.use_bias, dtype, device)
    return p


def _capacity(T: int, K: int, E: int, factor: float) -> int:
    c = int((T * K * factor + E - 1) // E)
    return max(c, 1)


def _take(x, idx):
    """x [G, N, d] rows at idx [G, M] -> [G, M, d]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def moe_apply(p, x, cfg, per_row: bool = False):
    """x [B, S, d] -> (out [B, S, d], aux loss, a 0-d fp32 tensor).

    One dispatch group of T = B·S tokens, or with ``per_row`` B groups of
    T = S (the aux loss is then the mean of the groups')."""
    B, S, d = x.shape
    G, T = (B, S) if per_row else (1, B * S)
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(T, K, E, cfg.capacity_factor)
    xt = x.reshape(G, T, d)

    logits = xt.float() @ p["router"]["w"]                      # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert_ids = torch.topk(probs, K, dim=-1)             # [G, T, K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- load-balance aux loss (Switch-style)
    me = probs.mean(1)                                          # [G, E]
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(1)
    aux = (cfg.router_aux_coef * E * (me * ce).sum(-1)).mean()

    # ---- sort-based dispatch: slot (e, c) takes the c-th token routed to e
    flat_e = expert_ids.reshape(G, T * K)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)      # [G, T*K]
    sorted_e = flat_e.gather(1, sort_idx)
    counts = torch.zeros(G, E, dtype=flat_e.dtype, device=x.device
                         ).scatter_add(1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(1) - counts

    slot = torch.arange(E * C, device=x.device)
    slot_c, slot_e = slot % C, slot // C
    slot_valid = slot_c < counts[:, slot_e]                     # [G, E*C]
    slot_sorted_idx = (starts[:, slot_e] + slot_c).clamp_max(T * K - 1)
    slot_token = sort_idx.gather(1, slot_sorted_idx) // K       # source token
    buf = torch.where(slot_valid[..., None], _take(xt, slot_token),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)

    # ---- batched expert FFN (swiglu)
    h = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(buf, p["w_up"].to(x.dtype))
    out_buf = torch.bmm(h, p["w_down"].to(x.dtype))             # [E, G*C, d]
    out_buf = out_buf.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: the slot of each sorted assignment, then unsort
    pos_in_e = (torch.arange(T * K, device=x.device)
                - starts.gather(1, sorted_e))                   # [G, T*K]
    valid = pos_in_e < C
    dest = (sorted_e * C + pos_in_e.clamp_max(C - 1)).clamp_max(E * C - 1)
    out_sorted = _take(out_buf, dest) * valid[..., None].to(x.dtype)
    inv = torch.empty_like(sort_idx).scatter(
        1, sort_idx, torch.arange(T * K, device=x.device)
        .expand(G, -1).contiguous())                            # unsort perm
    out_flat = _take(out_sorted, inv)                           # [G, T*K, d]
    out = (out_flat.reshape(G, T, K, d)
           * gate.to(x.dtype)[..., None]).sum(2)                # [G, T, d]

    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt, "swiglu")
    return out.reshape(B, S, d), aux
