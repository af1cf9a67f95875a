"""Parallelization methods (survey §3.2) as sharding rules over the port's
parameter trees (the JAX package's ``core/parallelism.py``).

Every parameter tensor gets a role, read from its key path, and with it a
spec over the mesh axes ("data", "model"): a tuple with one axis name (or
None) per dimension, where the JAX package builds a ``PartitionSpec``:

  column-parallel [in, out]   -> ("data", "model")   (TP on out, FSDP on in)
  row-parallel    [in, out]   -> ("model", "data")
  embedding       [V, d]      -> ("model", "data")   (vocab-parallel)
  MoE experts     [E, d, ff]  -> ("model", "data", None)  (expert-parallel)
  vectors / biases            -> replicated

Stacked layers get leading None axes.  ``model_axis_dim`` turns a role
into the one dimension a leaf shards over the tensor axis: the hybrid
mesh planner (``parallel.mesh_plan``) cuts each logical device's block
on it.

``data_axes`` names the axes that shard a batch (the dry-run's specs
read it).  The reference's ``batch_spec`` has no caller in either
package and is not ported.  Its decode-attention and MoE sharding hints
(``set_attn_decode_hints``, ``attn_decode_constraint``,
``set_moe_sharding_hints``, ``moe_constraint``) are requests to XLA's
partitioner; the port's logical devices have no partitioner to ask, so
they are not ported (ROADMAP records the decision).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

COL = ("data", "model")
ROW = ("model", "data")

# classification by the innermost meaningful key name
_COL_NAMES = {"wq", "wk", "wv", "w_q", "w_dkv", "w_krope", "w_uk", "w_uv",
              "w_gate", "w_up", "cm_k", "cm_r", "w_r", "w_k", "w_v", "w_g",
              "w_x", "w_gate_branch", "w_rg", "w_ig"}
_ROW_NAMES = {"wo", "w_o", "w_down", "w_out", "cm_v"}
_MOE_STACKED = {"w_gate", "w_up", "w_down"}


def _path_names(path: Sequence) -> list:
    """A key path (dict keys and list indices, as ``core.tree.leaf_paths``
    gives) or a ``/``-joined leaf name (``LeafLayout.names``) as the
    reference's name list: a list index ``i`` is ``"[i]"``."""
    if isinstance(path, str):
        path = path.split("/")
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


def _trailing_spec(names: list, ndim: int) -> Tuple[Optional[str], ...]:
    """Spec for the trailing dims based on the leaf's role."""
    # skip dense-dict wrappers
    core = [n for n in names if n not in ("w", "b")]
    name = core[-1] if core else ""
    is_bias = names and names[-1] == "b"

    if is_bias or ndim <= 1:
        return (None,) * min(ndim, 1)
    if name == "embed":
        return ("model", "data")
    if name == "lm_head":
        return ("data", "model")
    if name in ("dec_pos", "u"):
        return (None, None)
    if name == "router":
        return ("data", None)
    if name == "conv_w":
        return (None, "model")
    if name == "wA":
        return ("data", None)
    if name == "wB":
        return (None, "data")
    in_moe = "moe" in core and "shared" not in core
    if in_moe and name in _MOE_STACKED:
        if name == "w_down":
            return ("model", None, "data")
        return ("model", "data", None)
    if name in _COL_NAMES:
        return COL
    if name in _ROW_NAMES:
        return ROW
    # unknown 2D+ leaf: replicate (safe default)
    return (None,) * min(ndim, 2)


def param_specs(params, multi_pod: bool = False, policy: str = "fsdp"):
    """A tree like ``params`` whose leaves are each tensor's spec (a tuple
    of axis names or None, one per dimension).  ``multi_pod`` is the
    reference's argument; as there, the specs do not depend on it (the
    pod axis shards only batches).

    policy:
      fsdp    : weights sharded over both data (ZeRO-3) and model (TP).
      tp_only : weights sharded over model only, replicated over data.
    """
    assert policy in ("fsdp", "tp_only"), policy

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        ndim = len(tree.shape)
        trailing = _trailing_spec(_path_names(path), ndim)
        if policy == "tp_only":
            trailing = tuple(None if ax == "data" else ax for ax in trailing)
        return (None,) * (ndim - len(trailing)) + tuple(trailing)

    return walk(params, ())


def model_axis_dim(path, ndim: int) -> Optional[int]:
    """Dimension index a leaf shards over the "model"/tensor mesh axis,
    under the same role rules as ``param_specs``; None for leaves the role
    table replicates (biases, vectors, unknown 2D+ leaves).

    ``path`` is a key path or a ``/``-joined leaf name; ``ndim`` the
    leaf's rank *excluding* any leading stacked-stage dimension (pass
    ``leaf.dim() - 1`` for stage-stacked leaves and add 1 to the
    result)."""
    trailing = _trailing_spec(_path_names(path), ndim)
    lead = ndim - len(trailing)
    for i, ax in enumerate(trailing):
        if ax == "model":
            return lead + i
    return None



def data_axes(multi_pod: bool = False):
    """Mesh axes that shard the batch dimension."""
    return ("pod", "data") if multi_pod else ("data",)
