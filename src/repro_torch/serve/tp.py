"""Tensor-parallel decode for the serving plane (the JAX package's
``serve/tp.py``), over ``tp`` ranks: logical ranks in one process, or
one process per rank of a ``torch.distributed`` group.

The training side's Megatron decomposition, reused for inference:

  * wq/wk/wv and w_gate/w_up are **column-sharded** (each rank owns
    ``H/tp`` query heads, ``KV/tp`` kv heads, ``ff/tp`` hidden),
  * wo and w_down are **row-sharded**, their partial products summed by
    ``parallel.staged.tensor_reduce`` inside ``decode_step(tp_axis=...)``,
  * cache leaves are sharded on the **KV-head axis** (``ndim - 2`` of every
    attention cache leaf: contiguous rows and paged pools alike), so each
    rank holds only its heads' history,
  * embeddings / norms / lm_head stay replicated.

As in the hybrid engine, the tensor axis is dimension 0: a sharded leaf
is its ``tp`` shards stacked rank-major (``shard_params``), a cache leaf
``[tp, ..., KV/tp, hd]`` (``serve.cache.shard_kv``), so rank r's slice is
one contiguous block and its ``flash_decode`` launch sees ``H/tp`` heads.
Each rank runs the ordinary decode against the head-shrunk config
``cfg_local``.  Serving TP is restricted to pure-GQA decoders (no MoE /
MLA and no biases: a row-parallel bias would be added ``tp`` times).

Two modes, one layout:

  * **logical** (``axis=None``): every rank's shard in this process, the
    ranks decoded one after another on one device and their row-parallel
    partials summed in rank order (``tensor_reduce`` over dimension 0);
  * **per rank** (``axis``, a ``core.collectives.DistAxis`` of ``tp``
    ranks): this process keeps only its own shard, a ``[1, ...]`` block
    of the same rank-major layout (``shard_params``, ``shard_cache``), and
    decodes its heads alone; ``tensor_reduce`` under
    ``parallel.staged.tensor_axis(axis)`` all-gathers the ranks' partials
    and sums them in rank order, so the bits are the logical mode's.

The JAX package maps the ranks onto ``tp`` devices under ``shard_map``
and checks the device count; logical ranks need no device count, and per
rank the group's size is the check.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import get_path, leaf_paths, set_path, tree_map
from repro_torch.serve.cache import shard_kv

_COL = frozenset({"wq", "wk", "wv", "w_gate", "w_up"})
_ROW = frozenset({"wo", "w_down"})

Spec = Tuple[Optional[str], ...]


def check_tp_supported(cfg: ModelConfig, tp: int) -> None:
    bad = [k for k in cfg.layer_kinds if k not in ("attn", "local")]
    if bad:
        raise ValueError(f"tp decode needs attention-only stacks, got {bad}")
    if cfg.attn_type == "mla":
        raise ValueError("tp decode does not shard MLA latent caches")
    if cfg.moe:
        raise ValueError("tp decode does not support MoE layers")
    if cfg.use_bias:
        raise ValueError("tp decode requires use_bias=False "
                         "(row-parallel bias would be applied tp times)")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads}")


def _spec(path, t) -> Spec:
    names = [k for k in path if isinstance(k, str)]
    if any(n in _COL for n in names):
        return (None,) * (t.dim() - 1) + ("model",)
    if any(n in _ROW for n in names):
        return (None,) * (t.dim() - 2) + ("model", None)
    return (None,) * t.dim()


def param_specs(params) -> Any:
    """Per leaf, the axis name of each dimension (the JAX package builds a
    ``PartitionSpec``): column weights shard their last axis, row weights
    their second-to-last; the rest replicate."""
    out = tree_map(lambda t: None, params)
    for p in leaf_paths(params):
        set_path(out, p, _spec(p, get_path(params, p)))
    return out


def store_specs(store) -> Any:
    """Every cache leaf of a pure-GQA decoder is ``[..., KV, hd]``-shaped
    (contiguous ``[B, L, KV, hd]``, pools ``[Np, page, KV, hd]``): shard
    the KV-head axis at ndim - 2."""
    return tree_map(lambda t: (None,) * (t.dim() - 2) + ("model", None),
                    store)


class TPContext:
    """The shards of ``tp`` tensor ranks.  ``axis``: a ``DistAxis`` of
    ``tp`` ranks, of which this process is rank ``axis.rank`` and keeps
    only its own shard (module docstring)."""

    def __init__(self, cfg: ModelConfig, tp: int, axis=None):
        check_tp_supported(cfg, tp)
        if axis is not None and axis.size != tp:
            raise ValueError(f"tp={tp} over a process group of "
                             f"{axis.size} ranks (they must be equal)")
        self.tp = tp
        self.cfg = cfg
        self.axis = axis
        # the ranks this process holds, rank-major
        self.ranks = list(range(tp)) if axis is None else [axis.rank]
        # each rank runs the ordinary decode math at 1/tp the heads
        self.cfg_local = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // tp,
            num_kv_heads=cfg.num_kv_heads // tp)

    def shard_params(self, params) -> Any:
        """``params`` with every sharded leaf cut into its ``tp`` shards
        along the spec's "model" dimension and the shards this process
        holds stacked rank-major on a new dimension 0 (a copy: all ``tp``
        of them, or per rank its own as ``[1, ...]``); replicated leaves
        are the same tensors."""
        specs = param_specs(params)
        out = tree_map(lambda t: t, params)
        for p in leaf_paths(params):
            spec = get_path(specs, p)
            if "model" in spec:
                chunks = get_path(params, p).chunk(
                    self.tp, dim=spec.index("model"))
                set_path(out, p, torch.stack([chunks[r]
                                              for r in self.ranks]))
        return out

    def shard_cache(self, caches) -> Any:
        """A cache tree in the global layout -> rank-major leaves (per
        rank, its own heads as ``[1, ..., KV/tp, hd]``)."""
        return tree_map(lambda t: shard_kv(t, self.tp, self.rank), caches)

    @property
    def rank(self) -> Optional[int]:
        """This process's tensor rank, or None when it holds them all."""
        return None if self.axis is None else self.axis.rank

    @property
    def tp_axis(self):
        """What ``decode_step(tp_axis=)`` takes: the axis name on the
        logical ranks, the ``DistAxis`` per rank."""
        return "model" if self.axis is None else self.axis
