"""``CommPlan``: the communication plan every gradient exchange of the
port executes (the JAX package's ``comm/plan.py``, ``wire="modeled"``
part).

A plan is built once per (leaf shapes × worker count) and owns:

  * the fused-bucket layout (backward-order fusion of the leaves into
    ~``bucket_mb`` buckets) and the TicTac / random / layer transfer
    **issue order**, from ``core.comm_scheduler``, shared by the executed
    exchange and the analytic timeline so they cannot drift apart;
  * the **topology** schedule each bucket is reduced with
    (``comm.transport``), over the worker axis;
  * the ``wire`` mode.  ``modeled``: compression happens per worker
    before the exchange (``Compressor.roundtrip``), the schedule moves
    full-precision payloads, and wire bytes are the compressor's analytic
    accounting.  ``measured`` (encoded planes inside the schedule:
    ``exchange``, ``ps_exchange`` and the measured byte models) is ROADMAP
    queue A item 4, and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.transport import SCHEDULES
from repro_torch.core.comm_scheduler import (LayerCost, LinkModel, bucketize,
                                             random_order, schedule_no_overlap,
                                             schedule_overlap, tictac_order)
from repro_torch.core.compression import Compressor

WIRE_MODES = ("modeled", "measured")
_MEASURED = ("wire='measured' (codec payloads inside the schedule) is not "
             "ported yet: ROADMAP queue A item 4")

Shape = Tuple[int, ...]


def _numel(shape: Shape) -> int:
    return int(np.prod(shape)) if shape else 1


def bucket_order(n: int, order: str, layers: Sequence[LayerCost],
                 seed: int) -> List[int]:
    if order == "tictac":
        return tictac_order(layers)
    if order == "random":
        return random_order(layers, seed)
    if order == "layer":
        return list(range(n))
    raise ValueError(order)


def plan_buckets(leaf_shapes: Sequence[Shape], bucket_mb: float, order: str,
                 back_s_per_byte: float, seed: int
                 ) -> Tuple[List[List[int]], List[int], List[LayerCost]]:
    """Fuse gradient leaves (backward = reverse leaf order) into buckets of
    ~bucket_mb and choose the transfer issue order."""
    layers = [LayerCost(f"g{i}", back_s_per_byte * _numel(s) * 4,
                        _numel(s) * 4) for i, s in enumerate(leaf_shapes)]
    fused = bucketize(layers, bucket_mb * 1e6)
    buckets = [[int(nm[1:]) for nm in b.name.split("+")] for b in fused]
    order_idx = bucket_order(len(fused), order, fused, seed)
    return buckets, order_idx, fused


def scatter_flat(flat, idxs, leaf_shapes, out):
    """Split a fused bucket vector back into its leaves (into ``out``)."""
    off = 0
    for i in idxs:
        shape = leaf_shapes[i]
        size = _numel(shape)
        out[i] = flat[off:off + size].reshape(shape)
        off += size
    return out


@dataclasses.dataclass
class CommPlan:
    """One executable exchange plan (see the module docstring)."""
    n: int                           # workers on the axis
    topology: str
    compressor: Compressor
    wire: str
    buckets: List[List[int]]
    order: List[int]                 # issue order over bucket indices
    fused: List[LayerCost]
    leaf_shapes: List[Shape]
    link: LinkModel = LinkModel()

    @classmethod
    def plan(cls, leaf_shapes: Sequence[Shape], *, n: int,
             topology: str = "ring",
             compressor: Compressor = Compressor("none"),
             wire: str = "modeled", bucket_mb: float = 4.0,
             order: str = "tictac", back_s_per_byte: float = 2e-12,
             seed: int = 0, link: LinkModel = LinkModel()) -> "CommPlan":
        if wire not in WIRE_MODES:
            raise ValueError(f"wire={wire!r} (want {WIRE_MODES})")
        if wire == "measured":
            raise NotImplementedError(_MEASURED)
        if topology not in SCHEDULES:
            raise ValueError(f"unknown topology {topology!r}")
        shapes = [tuple(s) for s in leaf_shapes]
        buckets, order_idx, fused = plan_buckets(
            shapes, bucket_mb, order, back_s_per_byte, seed)
        return cls(n=n, topology=topology, compressor=compressor, wire=wire,
                   buckets=buckets, order=order_idx, fused=fused,
                   leaf_shapes=shapes, link=link)

    def bucket_len(self, b: int) -> int:
        return sum(_numel(self.leaf_shapes[i]) for i in self.buckets[b])

    # ------------------------------------------------- exact (fp32) ops
    def reduce_grads(self, grads: List[List[torch.Tensor]]
                     ) -> List[torch.Tensor]:
        """Full-precision bucketed mean-allreduce in plan issue order.

        ``grads[w]`` is worker w's leaf list.  Each bucket is fused into
        one [n, L] tensor, reduced by the topology schedule over the worker
        axis and divided by n; every worker holds the same mean, and the
        mean leaves come back once.  The bucket's leaves are dropped from
        ``grads`` as soon as they are fused, so the workers' gradients
        leave memory as the exchange proceeds."""
        if len(grads) != self.n:
            raise ValueError(f"plan is for {self.n} workers, got "
                             f"{len(grads)}")
        reduce_leaf = SCHEDULES[self.topology]
        out: List[torch.Tensor] = [None] * len(self.leaf_shapes)
        for b in self.order:                   # the executed schedule
            idxs = self.buckets[b]
            ref = grads[0][idxs[0]]
            flat = torch.empty((self.n, self.bucket_len(b)),
                               dtype=torch.float32, device=ref.device)
            for w, leaves in enumerate(grads):
                torch.cat([leaves[i].float().reshape(-1) for i in idxs],
                          out=flat[w])
                for i in idxs:
                    leaves[i] = None
            red = reduce_leaf(flat)[0] / self.n
            del flat
            scatter_flat(red, idxs, self.leaf_shapes, out)
        return out

    def exchange(self, *args, **kwargs):
        raise NotImplementedError(_MEASURED)

    def ps_exchange(self, *args, **kwargs):
        raise NotImplementedError(
            "arch='ps' is not ported yet: ROADMAP queue A item 6")

    # --------------------------------------------------------- accounting
    def modeled_timeline(self) -> Dict[str, float]:
        """Iteration-time projections for the exact bucket plan this
        engine executes — the no-overlap vs overlap comparison."""
        return {
            "no_overlap_s": schedule_no_overlap(self.fused, self.link),
            "overlap_s": schedule_overlap(self.fused, self.link,
                                          self.order),
            "n_buckets": len(self.fused),
        }

    def modeled_event_bytes(self) -> int:
        """The compressor's analytic per-push accounting over the plan's
        leaves (what ``roundtrip`` reports; the ``wire="modeled"`` step
        increment per worker)."""
        return sum(self.compressor.wire_bytes(s) for s in self.leaf_shapes)

    def measured_step_tx_bytes(self, arch: str = "allreduce") -> int:
        raise NotImplementedError(_MEASURED)

    def fp32_step_tx_bytes(self) -> int:
        raise NotImplementedError(_MEASURED)
