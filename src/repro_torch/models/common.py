"""Shared building blocks over plain dicts of tensors (the JAX package's
``models/common.py``): dense, RMSNorm / LayerNorm, activations, RoPE and
Qwen2-VL's M-RoPE, cross-entropy, the SwiGLU / GELU MLP.

Weights keep the JAX layout: a dense weight is ``[in, out]`` and applies
as ``x @ w``, so parameters carry over from the JAX package unchanged.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _generator(device, seed: int) -> torch.Generator:
    """The init's generator on ``device``; a ``meta`` init (shapes only,
    the dry-run's) draws nothing and takes a CPU generator."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev
                           ).manual_seed(seed)


def to_tensor(a):
    """A leaf of a parameter tree from the JAX package (numpy, or tensors
    a checkpoint load made) as a writable CPU tensor of its dtype."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- dense
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = False, dtype=torch.float32, device="cpu"):
    """``normal / sqrt(in)`` weights, drawn in fp32 then cast (as the JAX
    init does)."""
    w = torch.randn(in_dim, out_dim, generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(in_dim)
    p = {"w": w.to(dtype)}
    if use_bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------- norm
def norm_init(kind: str, dim: int, dtype=torch.float32, device="cpu"):
    p = {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=dtype, device=device)
    return p


def norm_apply(kind: str, p, x, eps: float = 1e-5):
    """RMSNorm or LayerNorm in fp32, cast back to x's dtype."""
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    else:  # layernorm
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        x32 = (x32 - mu) * torch.rsqrt(var + eps)
    y = x32 * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- activation
def activation(name: str, x):
    """``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation
    (``F.gelu`` defaults to the exact erf form)."""
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu_sq":
        return torch.relu(x).square()
    raise ValueError(name)


# ---------------------------------------------------------------------- RoPE
def _rope_cos_sin(positions, half_dim: int, theta: float):
    """positions [...]; returns cos/sin of shape positions.shape + (half_dim,)."""
    freqs = 1.0 / (theta ** (torch.arange(half_dim, dtype=torch.float32,
                                          device=positions.device)
                             / half_dim))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, positions, theta: float):
    """x [B, S, H, hd]; positions [B, S] -> rotated x (llama half-split)."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1] // 2, theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta: float):
    """Qwen2-VL M-RoPE.  x [B, S, H, hd]; positions3 [B, 3, S]; sections
    half-dims (t, h, w) summing to hd // 2: each frequency band turns by
    its own position row (temporal / height / width)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    dev = positions3.device
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=dev) / half))
    sec_ids = torch.tensor([i for i, n in enumerate(sections)
                            for _ in range(n)], device=dev)   # [half]
    pos = positions3.float()[:, sec_ids, :]                    # [B, half, S]
    angles = pos.transpose(1, 2) * freqs                       # [B, S, half]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- loss
def cross_entropy(logits, labels, mask=None, vocab_size: int | None = None):
    """Mean next-token CE.  logits [..., Vpad]; labels [...] int.

    ``vocab_size`` masks padded vocab entries (Vpad >= V); ``mask`` [...]
    weights the tokens (the mean runs over the masked-in ones)."""
    logits = logits.float()
    if vocab_size is not None and logits.shape[-1] > vocab_size:
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols < vocab_size, logits, -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ------------------------------------------------------------------ mlp
def mlp_init(gen, d_model: int, d_ff: int, act: str, use_bias: bool,
             dtype=torch.float32, device="cpu"):
    if act == "swiglu":
        return {"w_gate": dense_init(gen, d_model, d_ff, use_bias, dtype,
                                     device),
                "w_up": dense_init(gen, d_model, d_ff, use_bias, dtype, device),
                "w_down": dense_init(gen, d_ff, d_model, use_bias, dtype,
                                     device)}
    return {"w_up": dense_init(gen, d_model, d_ff, use_bias, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, use_bias, dtype, device)}


def mlp_apply(p, x, act: str):
    if act == "swiglu":
        h = F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        h = activation(act, dense(p["w_up"], x))
    return dense(p["w_down"], h)
