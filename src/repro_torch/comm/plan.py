"""``CommPlan``: the communication plan every gradient exchange of the
port executes (the JAX package's ``comm/plan.py``).

A plan is built once per (leaf shapes × worker count) and owns:

  * the fused-bucket layout (backward-order fusion of the leaves into
    ~``bucket_mb`` buckets) and the TicTac / random / layer transfer
    **issue order**, from ``core.comm_scheduler``, shared by the executed
    exchange and the analytic timeline so they cannot drift apart;
  * the **topology** schedule each bucket is reduced with
    (``comm.transport``), over the worker axis: ``reduce_grads`` and
    ``exchange`` take an ``axis`` (``core.collectives``; every worker
    logical in this process by default, one per ``torch.distributed``
    rank with a ``DistAxis``), and the caller hands in the leaf lists of
    the workers this process holds;
  * the **codec** (``comm.codecs``) and the ``wire`` mode:

      wire="modeled"   compression happens per worker before the exchange
                       (``Compressor.roundtrip``), the schedule moves
                       full-precision payloads (``reduce_grads``), and wire
                       bytes are the compressor's analytic accounting.
      wire="measured"  the schedule itself carries encoded planes
                       (``exchange``: encode -> permute -> decode-
                       accumulate, per-worker EF for the lossy hops), and
                       wire bytes are counted from those planes: the
                       shape-static parts from the plan
                       (``measured_step_tx_bytes``), dgc's data-dependent
                       sparse elements per step from the ``sent_elems``
                       the exchange returns.

  ``bsp/*/none`` is identical under both modes: the exact codec routes
  through the full-precision schedules, bit for bit.

``ps_exchange`` is the centralized (``arch="ps"``) form of ``exchange``:
an encoded ring reduce-scatter, SGD on each worker's shard and an exact
all-gather (``core.parameter_server``).  ``hop_model`` and
``emit_trace`` put the exchange a step ran onto the trace timeline
(``obs.trace``) as the plan's own model of it.  ``reduce_dtype`` is the
dtype gradients travel in on the uncompressed exchange: "bfloat16" (the
hybrid engine's ``bf16r`` precision) rounds the pushed words to bf16 and
halves the exact schedules' bytes (``word_bytes`` 2); codec planes and
the parameter all-gathers are unaffected.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.codecs import SPARSE_ELEM_BYTES, SegmentCodec, codec_for
from repro_torch.comm.transport import (SCHEDULES, compressed_allreduce,
                                        compressed_allreduce_ef,
                                        compressed_reduce_scatter,
                                        compressed_reduce_scatter_ef,
                                        fp32_schedule_bytes, pad_for_schedule,
                                        schedule_tx_bytes)
from repro_torch.core.comm_scheduler import (LayerCost, LinkModel, bucketize,
                                             random_order, schedule_no_overlap,
                                             schedule_overlap, tictac_order)
from repro_torch.core.collectives import Axis, LogicalAxis
from repro_torch.core.compression import Compressor
from repro_torch.core.parameter_server import all_gather_flat, shard_of_flat

WIRE_MODES = ("modeled", "measured")

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


def modeled_event_bytes(compressor: Compressor,
                        leaf_shapes: Sequence[Shape]) -> int:
    """The compressor's analytic per-push accounting over leaves of
    ``leaf_shapes`` (what ``Compressor.roundtrip`` and the simulator
    report): the one implementation every engine's modeled wire
    increment uses."""
    return sum(compressor.wire_bytes(tuple(s)) for s in leaf_shapes)


def scatter_flat(flat, idxs, leaf_shapes, out):
    """Split a fused bucket vector back into its leaves (into ``out``)."""
    off = 0
    for i in idxs:
        shape = leaf_shapes[i]
        size = _numel(shape)
        out[i] = flat[off:off + size].reshape(shape)
        off += size
    return out


def fuse(lists, idxs: Sequence[int], leaf_shapes: Sequence[Shape],
         length: int) -> torch.Tensor:
    """Leaves ``idxs`` of every worker's leaf list as one fp32
    [workers, length] tensor (zero-padded past the leaves).  The fused
    leaves are dropped from ``lists`` (assigned None), so the workers'
    tensors leave memory as an exchange proceeds; ``lists`` may be any
    indexable, such as a ``core.tree.LeafView``."""
    L = sum(_numel(leaf_shapes[i]) for i in idxs)
    flat = None
    for w, leaves in enumerate(lists):
        parts = [leaves[i].float().reshape(-1) for i in idxs]
        if flat is None:
            flat = torch.empty((len(lists), length), dtype=torch.float32,
                               device=parts[0].device)
            flat[:, L:] = 0
        torch.cat(parts, out=flat[w, :L])
        del parts
        for i in idxs:
            leaves[i] = None
    return flat


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
    # dtype gradients travel in on the uncompressed exchange: "bfloat16"
    # halves the wire words of the exact schedules (codec payloads are
    # already quantized planes and are unaffected; parameter all-gathers
    # always travel exact fp32)
    reduce_dtype: str = "float32"

    @classmethod
    def plan(cls, leaf_shapes: Sequence[Shape], *, n: int,
             topology: str = "ring",
             compressor: Compressor = Compressor("none"),
             wire: str = "modeled", bucket_mb: float = 4.0,
             order: str = "tictac", back_s_per_byte: float = 2e-12,
             seed: int = 0, link: LinkModel = LinkModel(),
             reduce_dtype: str = "float32") -> "CommPlan":
        if wire not in WIRE_MODES:
            raise ValueError(f"wire={wire!r} (want {WIRE_MODES})")
        if topology not in SCHEDULES:
            raise ValueError(f"unknown topology {topology!r}")
        shapes = [tuple(s) for s in leaf_shapes]
        buckets, order_idx, fused = plan_buckets(
            shapes, bucket_mb, order, back_s_per_byte, seed)
        return cls(n=n, topology=topology, compressor=compressor, wire=wire,
                   buckets=buckets, order=order_idx, fused=fused,
                   leaf_shapes=shapes, link=link,
                   reduce_dtype=reduce_dtype)

    # ------------------------------------------------------------ derived
    @property
    def codec(self) -> SegmentCodec:
        return codec_for(self.compressor)

    @property
    def in_schedule(self) -> bool:
        """True when payloads are encoded inside the schedule (measured
        wire mode with a lossy method)."""
        return self.wire == "measured" and self.compressor.method != "none"

    @property
    def word_bytes(self) -> int:
        """Bytes per word of the uncompressed gradient exchange (4 fp32,
        2 when ``reduce_dtype="bfloat16"``)."""
        return getattr(torch, self.reduce_dtype).itemsize

    def _exact_tx(self, codec, length: int) -> float:
        """``static_tx_bytes`` with the exchange's word width applied to
        the exact codec (lossy codec planes are unaffected)."""
        base = codec.static_tx_bytes(length)
        if codec.exact and self.word_bytes != 4:
            return base * self.word_bytes / 4
        return base

    def bucket_len(self, b: int) -> int:
        return sum(_numel(self.leaf_shapes[i]) for i in self.buckets[b])

    def chunk_lens(self) -> List[int]:
        """The distinct 1/n chunk lengths of the buckets' padded flat
        vectors, ascending: the segment lengths a chunked schedule hands
        its codec, one worker's segment per row."""
        return sorted({pad_for_schedule(self.bucket_len(b), self.n)
                       // self.n for b in range(len(self.buckets))})

    def _axis(self, axis) -> Axis:
        ax = axis if axis is not None else LogicalAxis(self.n)
        if ax.size != self.n:
            raise ValueError(f"plan is for {self.n} workers, the axis has "
                             f"{ax.size}")
        return ax

    def _fuse(self, lists, b: int, length: int, ax: Axis) -> torch.Tensor:
        if len(lists) != len(ax.ids):
            raise ValueError(f"this process holds {len(ax.ids)} of the "
                             f"plan's {self.n} workers, got {len(lists)} "
                             "lists")
        return fuse(lists, self.buckets[b], self.leaf_shapes, length)

    # ------------------------------------------------- exact (fp32) ops
    def reduce_grads(self, grads: List[List[torch.Tensor]], axis=None
                     ) -> List[torch.Tensor]:
        """Full-precision bucketed mean-allreduce in plan issue order.

        ``grads[r]`` is the leaf list of worker ``axis.ids[r]``, one per
        worker this process holds (all n on the default logical axis).
        Each bucket is fused into one [k, L] tensor, reduced by the
        topology schedule over the worker axis and divided by n; every
        worker holds the same mean, and the mean leaves come back once, on
        every process.  The bucket's leaves are dropped from ``grads`` as
        soon as they are fused."""
        ax = self._axis(axis)
        reduce_leaf = SCHEDULES[self.topology]
        rdt = getattr(torch, self.reduce_dtype)
        out: List[torch.Tensor] = [None] * len(self.leaf_shapes)
        for b in self.order:                   # the executed schedule
            flat = self._fuse(grads, b, self.bucket_len(b), ax)
            if rdt != torch.float32:
                flat = flat.to(rdt)            # the bf16 wire words
            red = reduce_leaf(flat, ax)[0].float() / self.n
            del flat
            scatter_flat(red, self.buckets[b], self.leaf_shapes, out)
        return out

    # ---------------------------------------- codec-in-schedule exchange
    def exchange(self, grads: List[List[torch.Tensor]],
                 ef: Optional[List[List[torch.Tensor]]], gen=None,
                 axis=None):
        """Mean-allreduce with encoded payloads inside the topology
        schedule.  ``grads[r]`` and ``ef[r]`` (None for the stateless
        quantizers) are the leaf lists of worker ``axis.ids[r]``, one per
        worker this process holds, consumed bucket by bucket; ``gen``
        drives the stochastic codecs.  Returns ``(mean leaves, new ef
        lists or None, sent_elems [k])``, ``sent_elems`` for the held
        workers; ``measured_bytes`` of its sum over all workers is dgc's
        per-step sparse payload."""
        ax = self._axis(axis)
        comp, codec = self.compressor, self.codec
        gain = comp.ef_gain if comp.method == "onebit" else 1.0
        out: List[torch.Tensor] = [None] * len(self.leaf_shapes)
        new_ef = (None if ef is None else
                  [[None] * len(self.leaf_shapes) for _ in ax.ids])
        sent = None
        for b in self.order:
            idxs = self.buckets[b]
            L = self.bucket_len(b)
            P = pad_for_schedule(L, self.n)
            g_flat = self._fuse(grads, b, P, ax)
            if ef is not None:
                # the transport applies the (over-relaxed) compensation,
                # runs fused encode+EF hops and returns the telescoped
                # next-step residual
                e_flat = self._fuse(ef, b, P, ax)
                red, new_e, nz = compressed_allreduce_ef(
                    g_flat, e_flat, self.topology, codec, gen, gain=gain,
                    axis=ax)
                del e_flat
                for row, lists in enumerate(new_ef):
                    scatter_flat(new_e[row, :L], idxs, self.leaf_shapes,
                                 lists)
                del new_e
            else:
                red, _, nz = compressed_allreduce(g_flat, self.topology,
                                                  codec, gen, axis=ax)
            del g_flat
            sent = nz if sent is None else sent + nz
            # every worker decodes the same sum: the first held one's is
            # the mean
            scatter_flat(red[0, :L] / self.n, idxs, self.leaf_shapes, out)
            del red
        return out, new_ef, sent

    def ps_exchange(self, params, grads: List[List[torch.Tensor]],
                    ef: Optional[List[List[torch.Tensor]]], gen, lr: float,
                    axis=None):
        """The centralized counterpart of ``exchange``: per bucket in issue
        order, a compressed ring reduce-scatter of the workers' gradients
        with their EF (the PS push), SGD on each worker's 1/n shard with
        ``g_shard / n`` (the server work) and a full-precision all-gather
        of the updated shards (the pull: parameters travel exact).

        ``params`` is the replicated parameter leaf list (any indexable,
        e.g. a ``core.tree.LeafView``); ``grads``, ``ef`` and ``axis`` as
        in ``exchange``.  Returns ``(new parameter leaves, new ef lists or
        None, sent_elems [k])`` for the held workers."""
        ax = self._axis(axis)
        k = len(ax.ids)
        comp, codec = self.compressor, self.codec
        gain = comp.ef_gain if comp.method == "onebit" else 1.0
        out: List[torch.Tensor] = [None] * len(self.leaf_shapes)
        new_ef = (None if ef is None else
                  [[None] * len(self.leaf_shapes) for _ in ax.ids])
        sent = None
        for b in self.order:
            idxs = self.buckets[b]
            L = self.bucket_len(b)
            P = pad_for_schedule(L, self.n)
            g_flat = self._fuse(grads, b, P, ax)
            if ef is not None:
                e_flat = self._fuse(ef, b, P, ax)
                g_shard, new_e, nz = compressed_reduce_scatter_ef(
                    g_flat, e_flat, codec, gen, gain=gain, axis=ax)
                del e_flat
                for row, lists in enumerate(new_ef):
                    scatter_flat(new_e[row, :L], idxs, self.leaf_shapes,
                                 lists)
                del new_e
            else:
                g_shard, _, nz = compressed_reduce_scatter(g_flat, codec,
                                                           gen, axis=ax)
            del g_flat
            sent = nz if sent is None else sent + nz
            p_flat = torch.cat([params[i].float().reshape(-1)
                                for i in idxs])[None]
            p_shard = shard_of_flat(p_flat.expand(k, L), ax)
            new_shard = p_shard - lr * (g_shard / self.n)
            del p_flat, p_shard, g_shard
            # every worker gathers the same vector: the first held one's
            # is the pull
            full = all_gather_flat(new_shard, L, ax)[0]
            scatter_flat(full, idxs, self.leaf_shapes, out)
            del new_shard, full
        return out, new_ef, sent

    # -------------------------------------------------------------- trace
    def hop_model(self, b: int, arch: str = "allreduce"
                  ) -> List[Tuple[str, float]]:
        """The per-hop wire model of one exchange of bucket ``b``: (hop
        kind, mean per-worker tx bytes) pairs mirroring the aggregate
        ``measured_step_tx_bytes`` accounting, so the hops of all buckets
        sum to it (shape-static part; dgc adds its sparse payload at the
        step level)."""
        codec = self.codec if self.in_schedule else codec_for(
            Compressor("none"))
        n = self.n
        if n == 1:
            return []
        L = self.bucket_len(b)
        P = pad_for_schedule(L, n)
        m = P // n
        e = lambda length: self._exact_tx(codec, length)
        if arch == "ps":
            # gradient reduce-scatter encoded, parameter all-gather fp32
            return ([("rs", float(e(m)))] * (n - 1)
                    + [("ag", float(4 * m))] * (n - 1))
        topo = self.topology
        if topo in ("ring", "psum"):
            return ([("rs", float(e(m)))] * (n - 1)
                    + [("ag", float(e(m)))] * (n - 1))
        if topo == "butterfly":
            if codec.exact:
                return [("exchange", float(e(P)))] * int(math.log2(n))
            rs = [("rs", float(e((n >> (k + 1)) * m)))
                  for k in range(int(math.log2(n)))]
            return rs + [("ag", float(e(m)))] * (n - 1)
        if topo == "tree":
            half = (n - 1) / n * e(P)
            return [("reduce", float(half)), ("broadcast", float(half))]
        if topo == "fully_connected":
            return [("send", float(e(P)))] * (n - 1)
        raise ValueError(topo)

    def emit_trace(self, rec, *, arch: str = "allreduce",
                   pid: str = "train", tid: str = "loop",
                   clock=None) -> None:
        """Emit the exchange this plan just executed onto the trace
        timeline: an ``exchange`` span holding one span per fused bucket
        in issue order, each with its ``hop`` instants.  These are the
        plan's own deterministic model of what ran (virtual clock only,
        byte-reproducible), with the modeled no-overlap, TicTac and
        issue-order bounds the analyzer compares, rounded to keep traces
        byte-stable."""
        if not rec.enabled:
            return
        comp = self.compressor
        no_overlap_s = schedule_no_overlap(self.fused, self.link)
        tictac_s = schedule_overlap(self.fused, self.link,
                                    tictac_order(self.fused))
        issue_s = schedule_overlap(self.fused, self.link, self.order)
        rec.begin("exchange", pid=pid, tid=tid, cat="comm", clock=clock,
                  topology=self.topology, codec=comp.method,
                  backend=getattr(comp, "backend", "auto"),
                  wire_mode=self.wire, arch=arch,
                  n_buckets=len(self.buckets),
                  step_tx_bytes=self.measured_step_tx_bytes(arch),
                  modeled_no_overlap_us=round(no_overlap_s * 1e6, 3),
                  modeled_tictac_overlap_us=round(tictac_s * 1e6, 3),
                  modeled_issue_overlap_us=round(issue_s * 1e6, 3))
        for b in self.order:
            hops = self.hop_model(b, arch)
            rec.begin(f"bucket{b}", pid=pid, tid=tid, cat="comm",
                      elems=self.bucket_len(b),
                      padded=pad_for_schedule(self.bucket_len(b), self.n),
                      leaves=len(self.buckets[b]),
                      tx_bytes=int(sum(x for _, x in hops)))
            for h, (kind, nbytes) in enumerate(hops):
                # mean per-worker bytes can be fractional (tree halves);
                # keep the fraction so hop sums match the accounting
                rec.instant("hop", pid=pid, tid=tid, cat="comm",
                            hop=h, kind=kind, tx_bytes=round(nbytes, 3))
            rec.end(pid=pid, tid=tid)
        rec.end(pid=pid, tid=tid)

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
        return modeled_event_bytes(self.compressor, self.leaf_shapes)

    def measured_step_tx_bytes(self, arch: str = "allreduce") -> int:
        """Shape-static measured bytes ONE worker puts on the wire per BSP
        step, recomputed per bucket from the plan.  For the exact codec
        this is the fp32 schedule; for ``ps`` the gradient reduce-scatter
        is encoded and the parameter all-gather is fp32.  Add
        ``measured_bytes(sent_elems)`` for dgc."""
        codec = self.codec if self.in_schedule else codec_for(
            Compressor("none"))
        # bf16 reduce halves the exact codec's wire words (its accounting
        # is linear in length, so scaling the schedule total is exact);
        # lossy planes and the fp32 parameter all-gather are unaffected
        scale = (self.word_bytes / 4
                 if codec.exact and self.word_bytes != 4 else 1.0)
        total = 0.0
        for b in range(len(self.buckets)):
            P = pad_for_schedule(self.bucket_len(b), self.n)
            if arch == "ps":
                m = P // self.n
                rs = (self.n - 1) * codec.static_tx_bytes(m) * scale
                ag = (self.n - 1) * 4 * m          # params travel exact
                total += rs + ag
            else:
                total += schedule_tx_bytes(self.topology, self.n, P,
                                           codec) * scale
        return int(total)

    def measured_bytes(self, sent_elems: int) -> int:
        """Data-dependent measured bytes of ``sent_elems`` sparse elements
        (dgc's per-step payload)."""
        return int(sent_elems) * SPARSE_ELEM_BYTES

    def fp32_step_tx_bytes(self) -> int:
        """The full-precision schedule's per-worker tx bytes per step: the
        baseline compressed-payload ratios are quoted against."""
        return int(sum(
            fp32_schedule_bytes(self.topology, self.n,
                                pad_for_schedule(self.bucket_len(b), self.n))
            for b in range(len(self.buckets))))
