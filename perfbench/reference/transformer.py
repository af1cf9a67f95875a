"""Plain PyTorch decoder-only transformer: the yardstick the benchmark holds
the program's training and serving against.

It follows the published architectures of the benchmark's configurations
(StableLM-2 and the Qwen2 language backbone of Qwen2-VL), written from
their descriptions and the configuration files in ``perfbench/configs``:
token embedding, pre-norm blocks of grouped-query attention with rotary
positions (Qwen2-VL's multimodal rotary sections over three position
rows, all equal for text) and a SwiGLU MLP, a final norm and an untied
output head.  Everything is fp32 plain ``torch`` operations; nothing of
the program is imported.

Weights are a flat dict of named tensors (``weight_specs`` lists them),
dense weights laid out ``[in, out]`` and applied as ``x @ w``.  Any dtype
is accepted: every weight is cast to fp32 where it is used, so the bf16
weights a served model is made with are read exactly.

``lowp`` selects the control precisions of the correctness check
(``perfbench/reference/lowp.py``): every matrix product's inputs are
rounded to that format first (``"tf32"``, ``"fp8"``), which is what the
lower-precision paths a later change might take would compute.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.lowp import round_operand


# --------------------------------------------------------------- the shape
def dims(cfg: Dict) -> Dict:
    """The sizes the reference needs, read from a configuration file's
    published keys."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // H
    rot = int(round(hd * cfg.get("partial_rotary_factor", 1.0)))
    sections = (cfg.get("rope_scaling") or {}).get("mrope_section")
    rms = "rms_norm_eps" in cfg
    return dict(
        d=d, H=H, KV=cfg["num_key_value_heads"], hd=hd,
        ff=cfg["intermediate_size"], V=cfg["vocab_size"],
        L=cfg["num_hidden_layers"], theta=float(cfg["rope_theta"]),
        rot=rot, sections=tuple(sections) if sections else (),
        norm="rmsnorm" if rms else "layernorm",
        eps=float(cfg["rms_norm_eps"] if rms else cfg["layer_norm_eps"]),
        qkv_bias=bool(cfg.get("use_qkv_bias", False)),
        tied=bool(cfg.get("tie_word_embeddings", False)))


def weight_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight as ``(name, shape, kind)``; ``kind`` is how the
    benchmark draws it: ``embed``, ``dense`` (fan-in scaled), ``scale``
    (norm gains about 1) or ``bias``."""
    m = dims(cfg)
    d, H, KV, hd, ff, V = m["d"], m["H"], m["KV"], m["hd"], m["ff"], m["V"]
    out = [("embed", (V, d), "embed")]
    norm = ["scale"] + (["bias"] if m["norm"] == "layernorm" else [])
    for i in range(m["L"]):
        p = f"layers.{i}."
        for n in ("ln1", "ln2"):
            out += [(p + f"{n}.{k}", (d,), "scale" if k == "scale" else "bias")
                    for k in norm]
        out += [(p + "wq", (d, H * hd), "dense"), (p + "wk", (d, KV * hd), "dense"),
                (p + "wv", (d, KV * hd), "dense"), (p + "wo", (H * hd, d), "dense")]
        if m["qkv_bias"]:
            out += [(p + "bq", (H * hd,), "bias"), (p + "bk", (KV * hd,), "bias"),
                    (p + "bv", (KV * hd,), "bias")]
        out += [(p + "w_gate", (d, ff), "dense"), (p + "w_up", (d, ff), "dense"),
                (p + "w_down", (ff, d), "dense")]
    out += [(f"final_norm.{k}", (d,), "scale" if k == "scale" else "bias")
            for k in norm]
    if not m["tied"]:
        out.append(("lm_head", (d, V), "dense"))
    return out


# ------------------------------------------------------------ the pieces
def _mm(x, w, lowp):
    return round_operand(x, lowp) @ round_operand(w.float(), lowp)


def _norm(W, prefix, x, m):
    scale = W[prefix + ".scale"].float()
    if m["norm"] == "rmsnorm":
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + m["eps"])
        return y * scale
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + m["eps"]) * scale \
        + W[prefix + ".bias"].float()


def _rotary(positions, m, device):
    """cos, sin [S, rot/2] at integer ``positions`` [S] (text: all three
    rotary sections of Qwen2-VL see the same position)."""
    half = m["rot"] // 2
    inv = 1.0 / (m["theta"] ** (torch.arange(half, dtype=torch.float64,
                                             device=device) / half))
    if m["sections"]:
        # section s of the frequency bands turns by position row s; for
        # text the rows are equal, so every band sees ``positions``
        assert sum(m["sections"]) == half
    ang = positions.double()[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rotate(x, cos, sin, rot):
    """x [S, n, hd]: the first ``rot`` dims turn in two halves."""
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, xp], dim=-1)


def _attention(q, k, v, m, q_block: int, lowp):
    """Causal attention, q [S, H, hd], k/v [S, KV, hd], in blocks of query
    rows so the scores of a long prompt fit."""
    S, H, hd = q.shape
    rep = H // m["KV"]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    kt = round_operand(k, lowp).permute(1, 2, 0)            # [H, hd, S]
    vt = round_operand(v, lowp).permute(1, 0, 2)            # [H, S, hd]
    outs = []
    for a in range(0, S, q_block):
        b = min(S, a + q_block)
        qb = round_operand(q[a:b], lowp).permute(1, 0, 2)   # [H, n, hd]
        s = torch.matmul(qb, kt[:, :, :b]) / math.sqrt(hd)  # [H, n, b]
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.matmul(round_operand(p, lowp), vt[:, :b])
                    .permute(1, 0, 2))
    return torch.cat(outs, dim=0)                           # [S, H, hd]


def _layer(W, i, x, cos, sin, m, q_block, lowp):
    p = f"layers.{i}."
    S = x.shape[0]
    H, KV, hd = m["H"], m["KV"], m["hd"]
    h = _norm(W, p + "ln1", x, m)
    q, k, v = (_mm(h, W[p + n], lowp) for n in ("wq", "wk", "wv"))
    if m["qkv_bias"]:
        q = q + W[p + "bq"].float()
        k = k + W[p + "bk"].float()
        v = v + W[p + "bv"].float()
    q = _rotate(q.reshape(S, H, hd), cos, sin, m["rot"])
    k = _rotate(k.reshape(S, KV, hd), cos, sin, m["rot"])
    a = _attention(q, k, v.reshape(S, KV, hd), m, q_block, lowp)
    x = x + _mm(a.reshape(S, H * hd), W[p + "wo"], lowp)
    h = _norm(W, p + "ln2", x, m)
    g = F.silu(_mm(h, W[p + "w_gate"], lowp)) * _mm(h, W[p + "w_up"], lowp)
    return x + _mm(g, W[p + "w_down"], lowp)


def hidden(W: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor, *,
           q_block: int = 1024, remat: bool = False,
           lowp: Optional[str] = None) -> torch.Tensor:
    """One sequence ``tokens`` [S] -> the final-normed hidden states [S, d]
    (fp32).  ``remat`` recomputes each layer in the backward, so a
    training reference keeps one layer's attention scores at a time."""
    m = dims(cfg)
    S = tokens.shape[0]
    x = W["embed"][tokens].float()
    cos, sin = _rotary(torch.arange(S, device=tokens.device), m, tokens.device)
    for i in range(m["L"]):
        if remat:
            x = checkpoint(_layer, W, i, x, cos, sin, m, q_block, lowp,
                           use_reentrant=False)
        else:
            x = _layer(W, i, x, cos, sin, m, q_block, lowp)
    return _norm(W, "final_norm", x, m)


def logits(W, cfg, h, lowp=None):
    """Output logits [n, V] of hidden rows ``h`` [n, d]."""
    head = W["embed"].T if dims(cfg)["tied"] else W["lm_head"]
    return _mm(h, head, lowp)


def loss(W, cfg, tokens, labels, *, lowp=None, remat=True):
    """Mean next-token cross-entropy of one row (fp32)."""
    h = hidden(W, cfg, tokens, remat=remat, lowp=lowp)
    return F.cross_entropy(logits(W, cfg, h, lowp), labels.long())
