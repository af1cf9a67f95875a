"""Decoder-only dense / GQA language model (the JAX package's
``models/transformer.py``, dense part).

Parameters are plain dicts of tensors: ``embed [V, d]``,
``lm_head [d, V]`` (untied configs), ``final_norm`` and ``layers``, a
list with one dict per layer.  The JAX package stacks layers into scan
groups (``plan_segments``); here the stack is a Python loop,
``from_jax_params`` un-stacks a JAX parameter tree into this layout, and
``leaf_layout`` maps it back onto the JAX package's leaves (the order the
data-parallel engine plans, compresses and reduces gradients in).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import LeafLayout, get_path, leaf_paths, tree_map
from repro_torch.models import attention as attn
from repro_torch.models.common import (cross_entropy, dense, mlp_apply,
                                       mlp_init, norm_apply, norm_init)

KINDS = ("attn",)


# --------------------------------------------------------------- segment plan
def plan_segments(cfg: ModelConfig) -> List[Tuple[str, Any]]:
    """The JAX package's layer grouping: [("plain", sig) | ("scan",
    (sig, ...), n_groups), ...] with sig = (kind, use_moe).  The port runs
    layers one by one; it reads the plan to un-stack JAX parameters."""
    bad = sorted(set(cfg.layer_kinds) - set(KINDS))
    if bad or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA layers only "
            f"(got kinds {bad or cfg.layer_kinds}, attn_type {cfg.attn_type})")
    sigs = [(kind, False) for kind in cfg.layer_kinds]
    pat_len = len(cfg.block_pattern)
    pattern = tuple(sigs[:pat_len])
    n_groups = 0
    while (n_groups + 1) * pat_len <= len(sigs) and all(
            sigs[n_groups * pat_len + j] == pattern[j] for j in range(pat_len)):
        n_groups += 1
    segments: List[Tuple[str, Any]] = []
    if n_groups:
        segments.append(("scan", pattern, n_groups))
    segments += [("plain", sig) for sig in sigs[n_groups * pat_len:]]
    return segments


# ------------------------------------------------------------------ layer ops
def _layer_init(gen, cfg: ModelConfig, dtype, device):
    return {"ln1": norm_init(cfg.norm, cfg.d_model, device=device),
            "ln2": norm_init(cfg.norm, cfg.d_model, device=device),
            "mixer": attn.attn_init(gen, cfg, dtype, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.use_bias,
                            dtype, device)}


def _layer_forward(p, cfg: ModelConfig, x, positions, window):
    """Full-sequence forward for one layer.  Returns (x, {"k", "v"})."""
    h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
    out, state = attn.attention_forward(p["mixer"], h, positions, cfg,
                                        causal=True, window=window)
    x = x + out
    h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.act), state


def _layer_decode(p, cfg: ModelConfig, x, pos, cache, window):
    """One-token decode for one layer.  Returns (x, cache)."""
    h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
    out, cache = attn.attention_decode(p["mixer"], h, pos, cache, cfg,
                                       window=window)
    x = x + out
    h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.act), cache


# ----------------------------------------------------------------- model init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cpu"):
    """Seeded init with the JAX package's distributions: embed
    ``normal * 0.02``, lm_head ``normal / sqrt(d)``, dense weights
    ``normal / sqrt(in)``, norm scales ones.  The draws differ from
    ``jax.random``'s; tests carry weights over with ``from_jax_params``."""
    plan_segments(cfg)                                 # rejects other families
    gen = torch.Generator(device=device).manual_seed(seed)
    V, d = cfg.vocab_size, cfg.d_model

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32)

    params: Dict[str, Any] = {
        "embed": (normal(V, d) * 0.02).to(dtype),
        "final_norm": norm_init(cfg.norm, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (normal(d, V) / np.sqrt(d)).to(dtype)
    params["layers"] = [_layer_init(gen, cfg, dtype, device)
                        for _ in range(cfg.num_layers)]
    return params


def from_jax_params(cfg: ModelConfig, tree):
    """The JAX package's parameter tree (leaves as numpy arrays) -> the
    port's parameters (CPU tensors, same dtype).  Scan segments are
    un-stacked along their leading group axis into one dict per layer."""
    to_t = lambda a: torch.from_numpy(np.array(a))     # writable copy
    layers = []
    for seg, p_seg in zip(plan_segments(cfg), tree["segments"]):
        if seg[0] == "plain":
            layers.append(tree_map(to_t, p_seg))
            continue
        _, pattern, n_groups = seg
        for g in range(n_groups):
            for j in range(len(pattern)):
                layers.append(tree_map(lambda a, _g=g: to_t(np.array(a)[_g]),
                                       p_seg[j]))
    params = {"embed": to_t(tree["embed"]),
              "final_norm": tree_map(to_t, tree["final_norm"]),
              "layers": layers}
    if "lm_head" in tree:
        params["lm_head"] = to_t(tree["lm_head"])
    return params


def leaf_layout(cfg: ModelConfig, params) -> LeafLayout:
    """The JAX package's parameter leaves over the port's ``params`` (or a
    gradient tree of the same structure), in ``jax.tree.leaves`` order:
    the top-level keys sorted, and within a scan segment, for each member
    of the pattern, each layer parameter stacked over the segment's
    groups.  Leaf names are the JAX key paths joined by ``/``."""
    leaves = []

    def add(prefix, bases):
        """One leaf per tensor under ``bases[0]``, stacked over ``bases``."""
        for path in leaf_paths(get_path(params, bases[0])):
            leaves.append(("/".join(map(str, prefix + path)),
                           tuple(b + path for b in bases)))

    for key in sorted([k for k in params if k != "layers"] + ["segments"]):
        if key != "segments":
            add((key,), [(key,)])
            continue
        layer = 0
        for si, seg in enumerate(plan_segments(cfg)):
            if seg[0] == "plain":
                add(("segments", si), [("layers", layer)])
                layer += 1
                continue
            _, pattern, n_groups = seg
            P = len(pattern)
            for j in range(P):
                add(("segments", si, j),
                    [("layers", layer + j + g * P) for g in range(n_groups)])
            layer += n_groups * P
    return LeafLayout(tuple(n for n, _ in leaves), tuple(p for _, p in leaves))


def _logits(params, cfg: ModelConfig, x):
    x = norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return dense({"w": params["lm_head"]}, x)


# ------------------------------------------------------------------- forward
def forward(params, cfg: ModelConfig, tokens, positions=None,
            compute_dtype=torch.bfloat16, return_cache: bool = False,
            window_override: int = 0):
    """Full-sequence forward.  tokens [B, S] int.  Returns (logits,
    caches | None); caches hold each layer's full k/v.

    window_override: sliding-window mask for plain attention layers — the
    prefill-side twin of ``decode_step``'s ring-buffer override."""
    B, S = tokens.shape
    x = params["embed"].to(compute_dtype)[tokens]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    caches: List[Any] = []
    for p in params["layers"]:
        x, st = _layer_forward(p, cfg, x, positions, window_override)
        if return_cache:
            caches.append(st)
    return _logits(params, cfg, x), (caches if return_cache else None)


def loss_fn(params, cfg: ModelConfig, batch, compute_dtype=torch.bfloat16):
    """Next-token CE.  batch: {tokens, labels[, mask, positions]}.  Returns
    (loss, {"ce", "aux"}); the dense decoder has no auxiliary loss."""
    logits, _ = forward(params, cfg, batch["tokens"],
                        positions=batch.get("positions"),
                        compute_dtype=compute_dtype)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"),
                       vocab_size=cfg.vocab_size)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def prefill(params, cfg: ModelConfig, tokens, positions=None,
            compute_dtype=torch.bfloat16, window_override: int = 0):
    """Forward over the prompt: last-token logits [B, 1, V] and the
    per-layer k/v states."""
    logits, caches = forward(params, cfg, tokens, positions=positions,
                             compute_dtype=compute_dtype, return_cache=True,
                             window_override=window_override)
    return logits[:, -1:], caches


# --------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, window_override: int = 0, device="cpu"):
    """One ``{"k", "v"}`` cache per layer (ring buffers of length
    ``window_override`` when it is set)."""
    return [attn.init_cache(cfg, batch, max_len, dtype,
                            window=window_override, device=device)
            for _ in range(cfg.num_layers)]


def decode_step(params, cfg: ModelConfig, caches, token, pos,
                compute_dtype=torch.bfloat16, window_override: int = 0):
    """One decode step.  token [B, 1] int; pos [B] int, the position of
    each row's token (rows decode at their own positions).  Updates the
    caches in place; returns (logits [B, 1, V], caches)."""
    x = params["embed"].to(compute_dtype)[token]
    for i, p in enumerate(params["layers"]):
        x, caches[i] = _layer_decode(p, cfg, x, pos, caches[i],
                                     window_override)
    return _logits(params, cfg, x), caches


def _state_to_cache(st, max_len: int, dtype, window: int = 0):
    """One layer's prefill k/v [B, S, KV, hd] -> its ``init_cache`` layout:
    position t at slot t (full) or t % W (ring buffer, last W kept)."""
    L = window if window else max_len

    def fill(a):
        B, S = a.shape[:2]
        if not window and S > max_len:
            raise ValueError(f"prompt length {S} > max_len {max_len}")
        ts = torch.arange(max(0, S - window) if window else 0, S,
                          device=a.device)
        out = torch.zeros((B, L) + a.shape[2:], dtype=dtype, device=a.device)
        out[:, ts % window if window else ts] = a[:, ts].to(dtype)
        return out

    return {name: fill(a) for name, a in st.items()}


def cache_from_prefill(cfg: ModelConfig, fwd_caches, max_len: int,
                       dtype=torch.bfloat16, window_override: int = 0):
    """Prefill states -> the decode caches ``init_cache`` lays out, so a
    prompt is consumed by one batched forward pass."""
    return [_state_to_cache(st, max_len, dtype, window_override)
            for st in fwd_caches]
