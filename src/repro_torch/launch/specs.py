"""Shape stand-ins and sharding specs for every (arch x shape) (the JAX
package's ``launch/specs.py``).

``train_input_specs(cfg, shape)`` gives the dry-run's inputs as tensors on
the ``meta`` device (shape and dtype, no storage); ``cache_specs`` /
``batch_specs_tree`` assign specs with divisibility-aware fallbacks (e.g.
long_500k batch=1: the batch axis cannot shard, so the sequence axis of
attention caches shards over ``data`` instead, and SSM states shard heads
over ``model``).  A spec is a tuple with one entry per dimension: None,
an axis name, or a tuple of axis names (the reference's
``PartitionSpec``, as ``tuple(spec)`` gives it).

The port's trees keep one entry per layer where the reference stacks
layers on a leading axis, so a port spec is the reference's without its
leading None.  Meshes are ``launch.mesh.LogicalMesh`` (or anything with
``axis_names`` and ``devices.shape``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.parallelism import data_axes
from repro_torch.core.tree import get_path, set_path, tree_map

VOCAB_PAD = 16       # model-axis shard count
VISION_PATCHES = 256
SWA_WINDOW = 4096    # sliding-window override for dense archs at long_500k


def _div(n: int, k: int) -> bool:
    return n % k == 0


def _batch_axes(multi_pod: bool):
    """``data_axes`` as one spec entry: a one-axis tuple is its axis, as
    ``PartitionSpec`` normalizes it."""
    dp = data_axes(multi_pod)
    return dp[0] if len(dp) == 1 else dp


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _walk(tree, fn, path=()):
    """``fn(names, leaf)`` over a tree of dicts and lists, names as the
    reference's key names (dict keys, ``"[i]"`` for list entries)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


# ------------------------------------------------------------------ batches
def batch_shardable(shape: InputShape, mesh) -> bool:
    sizes = mesh_axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    return _div(shape.global_batch, dp)


def train_input_specs(cfg: ModelConfig, shape: InputShape,
                      batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The step's inputs as tensors on the ``meta`` device (shapes only)
    at the shape's global batch, or at ``batch``."""
    B, S = batch or shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.is_encoder_decoder:
        # conv/mel frontend stub: precomputed frame embeddings
        return {"frames": empty((B, cfg.max_source_positions, cfg.d_model),
                                bf16),
                "tokens": empty((B, S), i32),
                "labels": empty((B, S), i32)}
    specs = {"tokens": empty((B, S), i32), "labels": empty((B, S), i32)}
    if cfg.family == "vlm":
        # ViT stub: precomputed patch embeddings + M-RoPE position ids
        specs["vision_embeds"] = empty((B, VISION_PATCHES, cfg.d_model), bf16)
        specs["positions"] = empty((B, 3, S), i32)
    return specs


def batch_specs_tree(cfg: ModelConfig, shape: InputShape, mesh,
                     multi_pod: bool) -> Dict[str, Tuple]:
    shard_b = batch_shardable(shape, mesh)
    b = _batch_axes(multi_pod) if shard_b else None
    return {name: (b,) + (None,) * (t.dim() - 1)
            for name, t in train_input_specs(cfg, shape).items()}


# ------------------------------------------------------------------- caches
def decode_window(cfg: ModelConfig, shape: InputShape) -> int:
    """window_override for the serve step (0 = full cache)."""
    if shape.name != "long_500k":
        return 0
    if cfg.attn_type == "mla":
        return 0          # MLA latent cache makes full 500k memory-feasible
    if cfg.family in ("dense", "vlm", "moe"):
        return SWA_WINDOW  # sub-quadratic requirement: sliding window
    return 0              # hybrid/ssm already have bounded state


def cache_leaf_spec(names, shape_t: Sequence[int], *, multi_pod: bool,
                    shard_batch: bool, model_n: int, data_n: int,
                    policy: str = "auto") -> Tuple:
    name = names[-1] if names else ""
    dp = _batch_axes(multi_pod)
    b = dp if shard_batch else None
    nd = len(shape_t)

    def model_split(*dims):
        """pick the first trailing dim divisible by the model axis."""
        for di in dims:
            if _div(shape_t[di], model_n):
                return di
        return None

    if name in ("k", "v"):           # [..., B, L, KV, hd]
        lead = (None,) * (nd - 4)
        if policy == "attn_hints_seq":
            # flash-decoding storage: sequence over model, batch over data
            l_spec = "model" if _div(shape_t[nd - 3], model_n) else None
            return lead + (b, l_spec, None, None)
        if policy == "seq_data":
            # batch over model, sequence over data
            b_spec = "model" if _div(shape_t[nd - 4], model_n) else None
            l_spec = dp if _div(shape_t[nd - 3], data_n) else None
            return lead + (b_spec, l_spec, None, None)
        l_spec = None if shard_batch else (dp if _div(shape_t[nd - 3],
                                                      data_n) else None)
        mi = model_split(nd - 2, nd - 1)
        tail = [b, l_spec, None, None]
        if mi is not None:
            tail[mi - (nd - 4)] = "model"
        return lead + tuple(tail)
    if name in ("c_kv", "k_rope"):   # [..., B, L, r]
        lead = (None,) * (nd - 3)
        l_spec = None if shard_batch else (dp if _div(shape_t[nd - 2],
                                                      data_n) else None)
        r_spec = "model" if _div(shape_t[nd - 1], model_n) else None
        return lead + (b, l_spec, r_spec)
    if name == "S":                  # [..., B, H, hs, hs]
        lead = (None,) * (nd - 4)
        h_spec = "model" if _div(shape_t[nd - 3], model_n) else None
        return lead + (b, h_spec, None, None)
    if name in ("h", "shift", "shift_tm", "shift_cm"):   # [..., B, w]
        lead = (None,) * (nd - 2)
        w_spec = "model" if _div(shape_t[nd - 1], model_n) else None
        return lead + (b, w_spec)
    if name == "conv":               # [..., B, cw-1, w]
        lead = (None,) * (nd - 3)
        w_spec = "model" if _div(shape_t[nd - 1], model_n) else None
        return lead + (b, None, w_spec)
    return (None,) * nd


def cache_specs(cache_shapes, mesh, multi_pod: bool, shard_batch: bool,
                policy: str = "auto"):
    """Specs of a cache tree.  ``policy``: ``auto`` (heads or head_dim
    over model), ``seq_data``, ``attn_hints`` (as ``auto``: the
    reference's XLA hints are not ported, its storage layout is) and
    ``attn_hints_seq`` (sequence over model)."""
    sizes = mesh_axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1) * sizes.get("pod", 1)
    return _walk(cache_shapes, lambda names, leaf: cache_leaf_spec(
        names, tuple(leaf.shape), multi_pod=multi_pod,
        shard_batch=shard_batch, model_n=model_n, data_n=data_n,
        policy=policy))


# --------------------------------------------------------------- optimizers
def opt_state_specs(opt_state, pspecs, layout):
    """Optimizer-state specs derived from the param specs (the optimizer
    shard lives with the parameter shard): same-shape moments (Adam's m
    and v, trees like the parameters) and Adafactor's factored vr / vc
    (its ``f``, a list in ``layout``'s leaf order).  ``layout`` is the
    model's ``LeafLayout``: the reference derives each state leaf's spec
    from its parameter's, found by the state leaf's path in the
    reference's tree.  The step count ``t`` (a Python int here) has no
    spec.

    As in the reference, its lookup takes a list entry only by a "[i]"
    name, which its paths never carry (``SequenceKey`` gives "0"), so
    every leaf stacked under a list — a scan segment's — is replicated,
    and only the leaves reached through dicts (embed, lm_head,
    final_norm, Whisper's stacked layers) take their parameter's
    spec."""
    def ref_spec(i):
        """The reference's parameter spec of its leaf i, as its lookup
        finds it (None when the path crosses a list)."""
        if any(part.isdigit() for part in layout.names[i].split("/")):
            return None
        spec = get_path(pspecs, layout.parts[i][0])
        return (None,) + spec if layout.is_stacked(i) else spec

    def derive(spec, moment: str, ndim: int):
        if spec is None:
            return (None,) * ndim
        if moment == "vr" and len(spec) >= 2:     # param shape minus last dim
            return spec[:-1]
        if moment == "vc" and len(spec) >= 2:     # minus second-to-last dim
            return spec[:-2] + spec[-1:]
        return spec if len(spec) == ndim else (None,) * ndim

    out = {}
    for key, sub in opt_state.items():
        if key == "f":
            out[key] = [{m: derive(ref_spec(i), m, t.dim())
                         for m, t in entry.items()}
                        for i, entry in enumerate(sub)]
        elif isinstance(sub, (dict, list)):
            tree = tree_map(lambda t: None, sub)
            for i, parts in enumerate(layout.parts):
                stacked = layout.is_stacked(i)
                t0 = get_path(sub, parts[0])
                spec = derive(ref_spec(i), key, t0.dim() + stacked)
                for path in parts:
                    set_path(tree, path, spec[1:] if stacked else spec)
            out[key] = tree
    return out
