"""Decoder-only language model of the port (the JAX package's
``models/transformer.py``): dense GQA / MHA, MoE (with a dense prefix),
MLA, M-RoPE with a vision stub, qkv biases, RMSNorm or LayerNorm, and the
recurrent kinds: Griffin's RG-LRU beside ``local`` sliding-window layers
(RecurrentGemma) and RWKV-6.  Whisper's encoder-decoder is
``models/whisper.py``.

Parameters are plain dicts of tensors: ``embed [Vpad, d]``,
``lm_head [d, Vpad]`` (untied configs), ``final_norm`` and ``layers``, a
list with one dict per layer (``ln1``, ``ln2``, ``mixer`` and ``mlp`` or
``moe``; an rwkv layer's channel mix lives in its ``mixer``).  The JAX
package stacks layers into scan groups (``plan_segments``: a repeating
pattern such as (rglru, rglru, local), then plain stragglers); here the
stack is a Python loop, ``from_jax_params`` un-stacks a JAX parameter
tree into this layout, and ``leaf_layout`` maps it back onto the JAX
package's leaves (the order the data-parallel engine plans, compresses
and reduces gradients in).

Caches, one per layer: attention ``{"k", "v"}`` (a ring buffer of
``cfg.window`` rows for ``local`` layers), MLA's latents, RG-LRU's
``{"h", "conv"}`` and RWKV's ``{"S", "shift_tm", "shift_cm"}``: a
recurrent layer's state *is* its decode cache.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import LeafLayout, get_path, leaf_paths, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (_generator, cross_entropy, dense,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, to_tensor)
from repro_torch.models.moe import moe_apply, moe_init

KINDS = ("attn", "local", "rglru", "rwkv")


# --------------------------------------------------------------- segment plan
def plan_segments(cfg: ModelConfig) -> List[Tuple[str, Any]]:
    """The JAX package's layer grouping: [("plain", sig) | ("scan",
    (sig, ...), n_groups), ...] with sig = (kind, use_moe): a plain
    prefix of the ``first_k_dense`` layers of an MoE stack, then one scan
    segment of the repeating pattern, then plain stragglers.  The port
    runs layers one by one; it reads the plan to un-stack JAX parameters."""
    bad = sorted(set(cfg.layer_kinds) - set(KINDS))
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")
    sigs = _layer_sigs(cfg)
    segments: List[Tuple[str, Any]] = []
    i = 0
    while i < len(sigs) and cfg.moe and i < cfg.first_k_dense:
        segments.append(("plain", sigs[i]))
        i += 1
    pat_len = len(cfg.block_pattern)
    remaining = sigs[i:]
    pattern = tuple(remaining[:pat_len])
    n_groups = 0
    while (n_groups + 1) * pat_len <= len(remaining) and all(
            remaining[n_groups * pat_len + j] == pattern[j]
            for j in range(pat_len)):
        n_groups += 1
    if n_groups:
        segments.append(("scan", pattern, n_groups))
        i += n_groups * pat_len
    segments += [("plain", sig) for sig in sigs[i:]]
    return segments


def _layer_sigs(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    """(kind, use_moe) of every layer, in order."""
    return [(kind, bool(cfg.moe and i >= cfg.first_k_dense
                        and kind in ("attn", "local")))
            for i, kind in enumerate(cfg.layer_kinds)]


# ------------------------------------------------------------------ layer ops
def _layer_init(gen, cfg: ModelConfig, sig, dtype, device):
    kind, use_moe = sig
    p = {"ln1": norm_init(cfg.norm, cfg.d_model, device=device),
         "ln2": norm_init(cfg.norm, cfg.d_model, device=device)}
    if kind == "rglru":
        p["mixer"] = rglru_mod.rglru_init(gen, cfg, dtype, device)
    elif kind == "rwkv":
        p["mixer"] = rwkv_mod.rwkv_init(gen, cfg, dtype, device)
        return p                         # the channel mix lives in mixer
    elif cfg.attn_type == "mla":
        p["mixer"] = mla_mod.mla_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = attn.attn_init(gen, cfg, dtype, device)
    if use_moe:
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.use_bias,
                            dtype, device)
    return p


def _window(cfg: ModelConfig, kind: str, window_override: int) -> int:
    """A ``local`` layer's ring / mask width is the config's window; plain
    attention layers take the serving override."""
    return cfg.window if kind == "local" else window_override


def _layer_forward(p, cfg: ModelConfig, sig, x, positions, window_override):
    """Full-sequence forward for one layer.  Returns (x, aux, state)."""
    kind, use_moe = sig
    h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if kind == "rglru":
        out, (h_last, conv_buf) = rglru_mod.rglru_forward(p["mixer"], h)
        state = {"h": h_last, "conv": conv_buf}
    elif kind == "rwkv":
        out, tm = rwkv_mod.time_mix_forward(p["mixer"], h, cfg)
        x = x + out
        h2 = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
        out2, shift_cm = rwkv_mod.channel_mix_forward(p["mixer"], h2, cfg)
        return x + out2, None, {"S": tm["S"], "shift_tm": tm["shift"],
                                "shift_cm": shift_cm}
    elif cfg.attn_type == "mla":
        out, state = mla_mod.mla_forward(p["mixer"], h, positions, cfg)
    else:
        out, state = attn.attention_forward(
            p["mixer"], h, positions, cfg, causal=True,
            window=_window(cfg, kind, window_override))
    x = x + out
    h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
    if use_moe:
        out, aux = moe_apply(p["moe"], h, cfg)
    else:
        out, aux = mlp_apply(p["mlp"], h, cfg.act), None
    return x + out, aux, state


def _rank(tree, r: int):
    """Tensor rank ``r``'s slice of a rank-stacked tree."""
    return tree_map(lambda t: t[r], tree)


def _tp_sum(partials):
    """The row-parallel partial products of the ranks, summed in rank
    order (``tensor_reduce``, over the tensor line ``decode_step`` set
    when each rank is a process; imported here, as ``parallel`` imports
    the engines)."""
    from repro_torch.parallel.staged import tensor_reduce
    return tensor_reduce(torch.stack(partials))[0]


def _layer_decode(p, cfg: ModelConfig, sig, x, pos, cache, window_override,
                  tp_axis=None, moe_per_row=True):
    """One-token decode for one layer.  Returns (x, cache): attention
    caches are written in place, a recurrent layer returns its new state.

    tp_axis: the mixer and MLP leaves and the cache are rank-stacked on
    dimension 0 (``serve.tp``); each rank held decodes its heads and
    hidden slice against its own cache rows, and the row-parallel partial
    products (wo, w_down) are summed with ``tensor_reduce`` before each
    residual add.  Dense GQA layers only (``decode_step`` checks)."""
    kind, use_moe = sig
    if kind == "rwkv":
        return rwkv_mod.rwkv_block_decode(p["mixer"], p["mixer"], p["ln1"],
                                          p["ln2"], cfg, x, cache)
    window = _window(cfg, kind, window_override)
    h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if kind == "rglru":
        out, cache = rglru_mod.rglru_decode(p["mixer"], h, cache)
    elif cfg.attn_type == "mla":
        out, cache = mla_mod.mla_decode(p["mixer"], h, pos, cache, cfg)
    elif tp_axis is None:
        out, cache = attn.attention_decode(p["mixer"], h, pos, cache, cfg,
                                           window=window)
    else:
        out = _tp_sum([
            attn.attention_decode(_rank(p["mixer"], r), h, pos,
                                  _rank(cache, r), cfg, window=window)[0]
            for r in range(cache["k"].shape[0])])
    x = x + out
    h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
    if use_moe:
        out, _ = moe_apply(p["moe"], h, cfg, per_row=moe_per_row)
    elif tp_axis is None:
        out = mlp_apply(p["mlp"], h, cfg.act)
    else:
        out = _tp_sum([mlp_apply(_rank(p["mlp"], r), h, cfg.act)
                       for r in range(p["mlp"]["w_up"]["w"].shape[0])])
    return x + out, cache


# ----------------------------------------------------------------- model init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cpu", vocab_pad_multiple: int = 1):
    """Seeded init with the JAX package's distributions: embed
    ``normal * 0.02``, lm_head ``normal / sqrt(d)``, dense and expert
    weights ``normal / sqrt(in)``, norm scales ones (fp32), the MoE router
    in fp32, RG-LRU's ``lam`` and RWKV's lerp, decay and bonus leaves in
    fp32.  The vocab is padded to a multiple of ``vocab_pad_multiple``.
    The draws differ from ``jax.random``'s; tests carry weights over with
    ``from_jax_params``."""
    plan_segments(cfg)                                 # rejects unknown kinds
    gen = _generator(device, seed)
    V, d = cfg.padded_vocab(vocab_pad_multiple), cfg.d_model

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32)

    params: Dict[str, Any] = {
        "embed": (normal(V, d) * 0.02).to(dtype),
        "final_norm": norm_init(cfg.norm, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (normal(d, V) / np.sqrt(d)).to(dtype)
    params["layers"] = [_layer_init(gen, cfg, sig, dtype, device)
                        for sig in _layer_sigs(cfg)]
    return params


def from_jax_params(cfg: ModelConfig, tree):
    """The JAX package's parameter tree (leaves as numpy arrays, or the
    tensors a checkpoint load made) -> the port's parameters (CPU tensors,
    same dtype).  Plain segments (an MoE stack's dense prefix, a pattern's
    stragglers) map to one layer each; scan segments are un-stacked along
    their leading group axis into one dict per layer."""
    layers = []
    for seg, p_seg in zip(plan_segments(cfg), tree["segments"]):
        if seg[0] == "plain":
            layers.append(tree_map(to_tensor, p_seg))
            continue
        _, pattern, n_groups = seg
        for g in range(n_groups):
            for j in range(len(pattern)):
                layers.append(tree_map(lambda a, _g=g: to_tensor(a[_g]),
                                       p_seg[j]))
    params = {"embed": to_tensor(tree["embed"]),
              "final_norm": tree_map(to_tensor, tree["final_norm"]),
              "layers": layers}
    if "lm_head" in tree:
        params["lm_head"] = to_tensor(tree["lm_head"])
    return params


def leaf_layout(cfg: ModelConfig, params) -> LeafLayout:
    """The JAX package's parameter leaves over the port's ``params`` (or a
    gradient tree of the same structure), in ``jax.tree.leaves`` order:
    the top-level keys sorted, and within a scan segment, for each member
    of the pattern, each layer parameter stacked over the segment's
    groups.  Leaf names are the JAX key paths joined by ``/``."""
    leaves = []

    def add(prefix, bases, stacked=False):
        """One leaf per tensor under ``bases[0]``, stacked over ``bases``
        (``stacked``: a scan segment's, even of one group)."""
        for path in leaf_paths(get_path(params, bases[0])):
            leaves.append(("/".join(map(str, prefix + path)),
                           tuple(b + path for b in bases), stacked))

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
                    [("layers", layer + j + g * P) for g in range(n_groups)],
                    stacked=True)
            layer += n_groups * P
    return LeafLayout(tuple(n for n, _, _ in leaves),
                      tuple(p for _, p, _ in leaves),
                      tuple(s for _, _, s in leaves))


def _logits(params, cfg: ModelConfig, x):
    x = norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return dense({"w": params["lm_head"]}, x)


# ------------------------------------------------------------------- forward
def _group_forward(ps, cfg: ModelConfig, sigs, x, aux_total, positions,
                   window_override):
    """Layers ``ps`` (one layer group, or one plain layer) in order.
    Returns (x, aux_total, states)."""
    states = []
    for p, sig in zip(ps, sigs):
        x, aux, st = _layer_forward(p, cfg, sig, x, positions,
                                    window_override)
        if aux is not None:
            aux_total = aux_total + aux
        states.append(st)
    return x, aux_total, states


def _hidden(params, cfg: ModelConfig, tokens, positions, vision_embeds,
            compute_dtype, return_cache, window_override, remat):
    """Embedding and layers: (x before the final norm, aux, caches)."""
    B, S = tokens.shape
    x = params["embed"].to(compute_dtype)[tokens]
    if vision_embeds is not None:
        P = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(compute_dtype), x[:, P:]], dim=1)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.mrope_sections:
            positions = positions[:, None].expand(B, 3, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: List[Any] = []
    layers, i = params["layers"], 0
    for seg in plan_segments(cfg):
        if seg[0] == "plain":
            groups, sigs = [layers[i:i + 1]], (seg[1],)
        else:
            _, sigs, n_groups = seg
            P = len(sigs)
            groups = [layers[i + g * P:i + (g + 1) * P]
                      for g in range(n_groups)]
        for ps in groups:
            if remat and seg[0] == "scan" and not return_cache:
                # per-layer-group activation remat (the reference's
                # jax.checkpoint of its scan body)
                x, aux_total = checkpoint(
                    lambda ps_, x_, a_, _sigs=sigs: _group_forward(
                        ps_, cfg, _sigs, x_, a_, positions,
                        window_override)[:2],
                    ps, x, aux_total, use_reentrant=False)
            else:
                x, aux_total, sts = _group_forward(
                    ps, cfg, sigs, x, aux_total, positions, window_override)
                if return_cache:
                    caches += sts
            i += len(ps)
    return x, aux_total, caches if return_cache else None


def forward(params, cfg: ModelConfig, tokens, positions=None,
            vision_embeds=None, compute_dtype=torch.bfloat16,
            return_cache: bool = False, window_override: int = 0,
            remat: bool = False):
    """Full-sequence forward.  Returns (logits, aux, caches | None): aux is
    the sum of the MoE layers' load-balance losses (0 without MoE), caches
    each layer's state (``{k, v}``, MLA's ``{c_kv, k_rope}`` or a
    recurrent layer's final state).

    tokens [B, S] int.  positions: [B, S] ([B, 3, S] with M-RoPE; the
    default broadcasts ``arange(S)`` to all three rows).  vision_embeds
    [B, P, d]: the vision stub, written over the leading P token slots.
    window_override: sliding-window mask for plain attention layers — the
    prefill-side twin of ``decode_step``'s ring-buffer override (``local``
    layers always mask to ``cfg.window``).

    remat: recompute each layer group of ``plan_segments``' scan segment
    in the backward (``torch.utils.checkpoint``, non-reentrant; plain
    layers are not recomputed, as in the reference)."""
    x, aux, caches = _hidden(params, cfg, tokens, positions, vision_embeds,
                             compute_dtype, return_cache, window_override,
                             remat)
    return _logits(params, cfg, x), aux, caches


def loss_fn(params, cfg: ModelConfig, batch, compute_dtype=torch.bfloat16,
            remat: bool = False):
    """Next-token CE + the MoE aux loss.  batch: {tokens, labels[, mask,
    positions, vision_embeds]}.  Returns (loss, {"ce", "aux"})."""
    logits, aux, _ = forward(params, cfg, batch["tokens"],
                             positions=batch.get("positions"),
                             vision_embeds=batch.get("vision_embeds"),
                             compute_dtype=compute_dtype, remat=remat)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"),
                       vocab_size=cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, tokens, positions=None,
            vision_embeds=None, compute_dtype=torch.bfloat16,
            window_override: int = 0):
    """Forward over the prompt: last-token logits [B, 1, Vpad] and the
    per-layer states.  Only the last position goes through the final norm
    and the output projection (the reference projects every position and
    keeps the last: the same values row by row, without the [B, S, Vpad]
    logits, 20 GB per row at S=32768 and a 152k vocab)."""
    x, _, caches = _hidden(params, cfg, tokens, positions, vision_embeds,
                           compute_dtype, True, window_override, False)
    return _logits(params, cfg, x[:, -1:]), caches


# --------------------------------------------------------------------- decode
def _layer_cache(cfg: ModelConfig, sig, batch, max_len, dtype,
                 window_override=0, device="cpu"):
    kind, _ = sig
    if kind == "rglru":
        return rglru_mod.rglru_init_state(cfg, batch, dtype, device)
    if kind == "rwkv":
        return rwkv_mod.rwkv_init_state(cfg, batch, dtype, device)
    if cfg.attn_type == "mla":
        return mla_mod.mla_init_cache(cfg, batch, max_len, dtype, device)
    return attn.init_cache(cfg, batch, max_len, dtype,
                           window=_window(cfg, kind, window_override),
                           device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, window_override: int = 0, device="cpu"):
    """One cache per layer: ``{"k", "v"}`` (ring buffers of ``cfg.window``
    rows for ``local`` layers, of ``window_override`` for the others when
    it is set), MLA's latents ``{"c_kv", "k_rope"}``, RG-LRU's ``{"h",
    "conv"}`` or RWKV's ``{"S" (fp32), "shift_tm", "shift_cm"}``."""
    return [_layer_cache(cfg, sig, batch, max_len, dtype, window_override,
                         device) for sig in _layer_sigs(cfg)]


def paged_layers(cfg: ModelConfig, window_override: int = 0) -> List[bool]:
    """Per layer, whether its cache has a sequence axis that pages (full
    attention, MLA's latents); ring buffers and recurrent states stay
    per slot (the JAX package's ``serve.cache._seq_from_end`` != 0)."""
    return [kind in ("attn", "local") and (
                cfg.attn_type == "mla"
                or not _window(cfg, kind, window_override))
            for kind, _ in _layer_sigs(cfg)]


def decode_step(params, cfg: ModelConfig, caches, token, pos,
                compute_dtype=torch.bfloat16, window_override: int = 0,
                tp_axis=None, moe_per_row: bool = True):
    """One decode step.  token [B, 1] int; pos [B] int, the position of
    each row's token (rows decode at their own positions).  Updates the
    attention caches in place and puts each recurrent layer's new state
    in its place in ``caches``; returns (logits [B, 1, Vpad], caches).

    tp_axis: tensor-parallel decode (``serve.tp.TPContext.tp_axis``).
    ``params`` then come from ``TPContext.shard_params`` (wq, wk, wv,
    w_gate, w_up split by column and wo, w_down by row, stacked rank-major
    on dimension 0; embeddings, norms and lm_head replicated), every cache
    leaf is rank-major ``[ranks, ..., KV/tp, hd]``, and ``cfg`` is the
    rank-local config (``num_heads/tp``, ``num_kv_heads/tp``), as the JAX
    package's engine passes it inside its ``shard_map``.  A string names
    the axis of logical ranks, all ``tp`` of them held here and decoded
    in turn; a ``core.collectives.DistAxis`` is the group of ``tp``
    processes, each holding its own rank ``[1, ...]``, and the partials
    are gathered over it and summed in rank order (the same bits).

    moe_per_row: each row routes alone (the serving engine's slots, as
    the reference's engine vmaps its decode over them); False routes the
    B tokens as one dispatch group with one capacity, as the reference's
    ``decode_step`` called on a batch does (the dry-run's serve step)."""
    if tp_axis is not None and (
            cfg.moe or cfg.attn_type == "mla"
            or any(k not in ("attn", "local") for k in cfg.layer_kinds)):
        raise ValueError(
            f"tensor-parallel decode supports dense GQA layers only "
            f"(got moe={cfg.moe}, attn_type={cfg.attn_type}, kinds "
            f"{sorted(set(cfg.layer_kinds))})")
    x = params["embed"].to(compute_dtype)[token]
    line = contextlib.nullcontext()
    if tp_axis is not None and not isinstance(tp_axis, str):
        from repro_torch.parallel.staged import tensor_axis
        line = tensor_axis(tp_axis)
    with line:
        for i, (p, sig) in enumerate(zip(params["layers"],
                                         _layer_sigs(cfg))):
            x, caches[i] = _layer_decode(p, cfg, sig, x, pos, caches[i],
                                         window_override, tp_axis,
                                         moe_per_row)
    return _logits(params, cfg, x), caches


def _seq_from_end(cfg: ModelConfig) -> int:
    """The sequence axis of an attention cache leaf, counted from its end:
    2 for MLA's latents ``[.., L, r]``, 3 for ``[.., L, KV, hd]``."""
    return 2 if cfg.attn_type == "mla" else 3


def _state_to_cache(cfg: ModelConfig, sig, st, max_len: int, dtype,
                    window_override: int = 0):
    """One layer's prefill state -> its ``init_cache`` layout: position t
    at slot t (full) or t % W (ring buffer, last W kept; MLA keeps full
    latents).  A recurrent layer's final state *is* its decode cache, its
    leaves cast to the ``init_cache`` template's dtypes (RWKV's ``S``
    stays fp32 whatever ``dtype``)."""
    kind, _ = sig
    if kind in ("rglru", "rwkv"):
        tmpl = _layer_cache(cfg, sig, 1, max_len, dtype, window_override)
        return {name: a.to(tmpl[name].dtype) for name, a in st.items()}
    window = 0 if cfg.attn_type == "mla" else _window(cfg, kind,
                                                      window_override)
    L = window if window else max_len

    def fill(a):
        ax = a.dim() - _seq_from_end(cfg)
        S = a.shape[ax]
        if not window and S > max_len:
            raise ValueError(f"prompt length {S} > max_len {max_len}")
        ts = torch.arange(max(0, S - window) if window else 0, S,
                          device=a.device)
        out = torch.zeros(a.shape[:ax] + (L,) + a.shape[ax + 1:],
                          dtype=dtype, device=a.device)
        out.index_copy_(ax, ts % window if window else ts,
                        a.index_select(ax, ts).to(dtype))
        return out

    return {name: fill(a) for name, a in st.items()}


def cache_from_prefill(cfg: ModelConfig, fwd_caches, max_len: int,
                       dtype=torch.bfloat16, window_override: int = 0):
    """Prefill states -> the decode caches ``init_cache`` lays out, so a
    prompt is consumed by one batched forward pass."""
    return [_state_to_cache(cfg, sig, st, max_len, dtype, window_override)
            for sig, st in zip(_layer_sigs(cfg), fwd_caches)]
