"""Cost and memory counts of one step, the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference reads XLA's compiled artifact: ``cost_analysis()`` for HLO
FLOPs and bytes, ``memory_analysis()`` for buffer sizes, and the HLO text
for collective bytes.  PyTorch runs eagerly and has no HLO, so the port
counts the step's aten operations as they run on the ``meta`` device
(shapes only, nothing allocated):

  flops           ``torch.utils.flop_counter.FlopCounterMode``: matmul,
                  bmm, convolution and attention products.  On meta the
                  attention takes its plain version (``kernels.backend``),
                  so the count is the plain version's products, the
                  masked blocks that the flash kernel skips included.
  bytes_accessed  ``ByteCounter``: each aten op's input and output bytes,
                  views counting 0 — the same unfused upper bound as the
                  reference's HLO bytes.
  peak bytes      ``MetaMemory``: the most bytes of meta storage alive at
                  once, under ``kernels.backend.meta_as_card`` (the flash
                  entries allocate only their outputs, as on the card),
                  with the card's transients that no meta storage stands
                  for (``card_transient``) and the BLAS workspaces the
                  card holds (``CARD_WORKSPACE_BYTES``).  It is the byte
                  count the dry-run decides a card run's batch by, before
                  the run; the card run itself reads
                  ``torch.cuda.max_memory_allocated``.

Collectives: ``CollectiveCounter`` counts the ``_c10d_functional``
collectives that the dry-run's step issues when ``launch.spmd`` runs it
on DTensors over a fake process group of the production mesh's size:
each one's result bytes by the reference's five kinds (the convention of
its ``hlo_analysis.py``: an all-gather's gathered tensor, a
reduce-scatter's shard) and, through ``_traffic`` with the size of the
op's own group, ``traffic_weighted``.  The HLO text parser
``collective_bytes`` has nothing to parse and is not ported;
``_group_size``, its group-size reader, stays with its parity test.

  op               result bytes R, group size S   traffic per device
  all-reduce       R                               2 (S-1)/S * R
  all-gather       R (the gathered tensor)         (S-1)/S * R
  reduce-scatter   R (the shard)                   (S-1) * R   (input = S*R)
  all-to-all       R                               (S-1)/S * R
  collective-permute R                             R
"""
from __future__ import annotations

import contextlib
import contextvars
import re
import weakref
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# ops whose output shares its input's storage though the schema says
# otherwise (matmul's reshapes, autograd's detach)
_ALIASES = {"aten::_unsafe_view", "aten::detach", "aten::alias",
            "aten::lift_fresh"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# What the card allocates beside the ops' outputs, measured against
# torch.cuda.max_memory_allocated around every aten op of the dry-run's
# steps (tools/torch_memory_probe.py, H100, torch 2.11): the cuBLAS and
# cuBLASLt workspaces, held from the first matmul on, and two ops whose
# CUDA kernels take a temporary as large as a tensor they touch.  The
# softmax backward is the attention backward's plain replay, so it sits
# at every training step's peak: without it the count missed 1.25-2.0
# GiB per batch row ([B, H, 4096, 4096] fp32) of Whisper-large-v3 and
# TinyLlama-1.1B at train_4k.
CARD_WORKSPACE_BYTES = 64 * 2 ** 20
_CARD_TRANSIENT = {
    "aten::_softmax_backward_data": lambda args, out: _nbytes(out),
    "aten::logsumexp": lambda args, out: _nbytes(args[0]),
}


def card_transient(func, args, out) -> int:
    """Bytes the card's kernel for ``func`` holds above its inputs and
    outputs while it runs (0 for the ops not measured to hold any)."""
    rule = _CARD_TRANSIENT.get(func._schema.name)
    return rule(args, out) if rule else 0


class ByteCounter(TorchDispatchMode):
    """Sums each aten op's input and output bytes (an in-place op reads
    and writes its output: both count); views count 0."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func._schema.name in _ALIASES):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


class MetaMemory(TorchDispatchMode):
    """Live and peak bytes of the meta storages the ops under it make
    (factories included: build the state inside the mode).  A storage
    counts once, from the op that made it until its last tensor dies;
    an op's card transient (``card_transient``) counts at the peak while
    the op runs, above its outputs."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._ids = set()

    def _free(self, key, n):
        self._ids.discard(key)
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        if id(st) in self._ids:
            return
        n = st.nbytes()
        self._ids.add(id(st))
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, id(st), n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self.track(t)
        extra = card_transient(func, args, out)
        if extra and out.device.type == "meta":
            self.peak = max(self.peak, self.live + extra)
        return out


def count_cost(fn: Callable, *args) -> Tuple[Dict[str, float], object]:
    """Run ``fn(*args)`` (meta tensors) counting its FLOPs and bytes.
    Returns ({"flops", "bytes_accessed"}, fn's result)."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with flops, nbytes:
        out = fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.bytes)}, out


# -------------------------------------------------- collective traffic model
# The reference's per-collective model (module docstring).  The counter
# below reads each op's group size from the op's own process group;
# ``_group_size`` reads it from HLO text, as the reference's parser does,
# and is kept with its parity test.
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _group_size(line: str) -> int:
    """Group size S of a collective from its replica_groups (iota form
    ``[G,S]<=[N]`` or an explicit ``{{...}}`` list); 2 when unknown."""
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    return 2    # unknown: conservative (factor (S-1)/S ~ 1/2 .. 1)


def _traffic(op: str, result_bytes: int, s: int) -> float:
    """Per-device ring traffic of one collective (module docstring)."""
    if s <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (s - 1) / s * result_bytes
    if op == "all-gather":
        return (s - 1) / s * result_bytes
    if op == "reduce-scatter":
        return float(s - 1) * result_bytes
    if op == "all-to-all":
        return (s - 1) / s * result_bytes
    return float(result_bytes)      # collective-permute


# the reference's five kinds, in its order, and the ``_c10d_functional``
# ops (their ``_coalesced`` and autograd twins included) that issue them;
# DTensor issues no point-to-point op, so collective-permute stays 0
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
_C10D_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's shard-dimension move
}
# bookkeeping of the functional collectives: no bytes move
_C10D_QUIET = {"wait_tensor", "_wrap_tensor_autograd"}


def _group_name(func, args, kwargs) -> str:
    """The group-name argument of a ``_c10d_functional`` op (its last
    positional string, or ``group_name``)."""
    if kwargs and "group_name" in kwargs:
        return kwargs["group_name"]
    names = [a for a in args if isinstance(a, str)]
    if not names:
        raise ValueError(f"{func}: no group name among its arguments")
    return names[-1]


_WEIGHT = contextvars.ContextVar("collective_weight", default=1)


@contextlib.contextmanager
def collective_weight(n: int):
    """Within the block each collective counts ``n`` times: one of ``n``
    steps of one shape run once stands for all of them (RWKV-6's token
    loop in the dry-run's partitioned count)."""
    token = _WEIGHT.set(_WEIGHT.get() * n)
    try:
        yield
    finally:
        _WEIGHT.reset(token)


class CollectiveCounter(TorchDispatchMode):
    """Result bytes of the collectives issued under it (the
    ``_c10d_functional`` ops and DTensor's ``shard_dim_alltoall``), by the
    reference's kinds, and their per-device ring traffic
    (``traffic_weighted``, ``_traffic`` with the size of the op's own
    process group).  DTensor operations pass through (``NotImplemented``)
    so that the collectives DTensor's sharding propagation issues for
    them reach the mode.  Any other ``_c10d_functional`` op (a broadcast)
    raises: it has none of the five kinds.  Under ``collective_weight(n)``
    each collective counts ``n`` times."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.traffic = 0.0
        self.last_op = None         # the DTensor op seen last

    def record(self) -> Dict[str, float]:
        """The reference's record: the five kinds and
        ``traffic_weighted``."""
        return dict(self.bytes, traffic_weighted=self.traffic)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.last_op = str(func)
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace.startswith("_c10d_functional") or (
                func.namespace == "_dtensor"
                and "alltoall" in func._schema.name):
            name = func._schema.name.split("::")[-1]
            if name not in _C10D_QUIET:
                kind = _C10D_KINDS.get(name)
                if kind is None:
                    raise NotImplementedError(
                        f"{func}: a collective of none of the reference's "
                        f"kinds {COLLECTIVE_KINDS}")
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                s = _resolve_process_group(
                    _group_name(func, args, kwargs)).size()
                r = sum(_nbytes(t) for t in _tensors(out))
                n = _WEIGHT.get()
                self.bytes[kind] += n * r
                self.traffic += n * _traffic(kind, r, s)
        return out
