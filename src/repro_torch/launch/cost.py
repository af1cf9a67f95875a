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

Collectives: the dry-run's devices are logical and the port has no
partitioner, so a record's step issues no collective and its
``collectives`` is null.  The worker axis of data-parallel training runs
over ``torch.distributed`` (``core.collectives.DistAxis``), but the
dry-run's meshes do not yet; the traffic model of the reference
(``_traffic``, ``_group_size``) is kept for the dry-run's collectives
(ROADMAP queue A item 9g).  The HLO text parser ``collective_bytes`` has
nothing to parse and is not ported.

  op               result bytes R, group size S   traffic per device
  all-reduce       R                               2 (S-1)/S * R
  all-gather       R (the gathered tensor)         (S-1)/S * R
  reduce-scatter   R (the shard)                   (S-1) * R   (input = S*R)
  all-to-all       R                               (S-1)/S * R
  collective-permute R                             R
"""
from __future__ import annotations

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
# No caller yet: a dry-run record's ``collectives`` is null.  The
# reference's per-collective model is kept here, with parity tests, for the
# dry-run over torch.distributed meshes that will fill that field (ROADMAP
# queue A item 9g).
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
