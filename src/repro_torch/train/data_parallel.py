"""Data parallelism with compressed, bucketed, topology-explicit
communication (survey §3.3): the JAX package's
``train/data_parallel.py::DeviceEngine``, BSP / allreduce part.

K logical workers share one device (``core.collectives``).  Each BSP step
runs every worker's forward and backward on its own batch (one after
another on the engine's device) and turns its gradient tree into the
reference's leaf list (``core.tree.LeafLayout``, stacking each
layer-stacked leaf and freeing the per-layer gradients as it goes).  Then,
by ``wire`` mode:

  modeled    ``Compressor.roundtrip`` with the worker's error-feedback
             residuals (one fused encode+EF pass per leaf), then the
             bucketed allreduce of the reconstructed gradients in
             ``CommPlan`` issue order (TicTac by default) over the
             topology's exact schedule.  Wire bytes: the compressor's
             analytic accounting per worker push.
  measured   the raw gradients go through ``CommPlan.exchange``: per
             bucket, the topology's codec schedule with encoded planes
             inside it and each worker's EF inside the schedule.  Wire
             bytes: the plan's shape-static plane bytes times K plus 8 B
             per sparse element the step shipped (dgc).  ``bsp/*/none``
             runs the exact schedule, bit for bit as under ``modeled``.

and finally the SGD update ``p - lr * mean``.  The other sync models
(ssp, asp, sma), ``arch="ps"``, backup workers and straggler detection
raise, naming their ROADMAP queue A item.

Each phase of the step runs under a ``torch.profiler.record_function``
range (``forward_backward``, ``stack_and_compress``, ``allreduce``,
``sgd_update``; the measured exchange is ``allreduce``), so a profile
splits the step's device time by phase (``tools/torch_train_profile.py``);
outside a profile a range costs a few microseconds of host time.

``torch.Generator``s seeded from (seed, step, worker) drive the stochastic
methods: one per worker for the modeled roundtrip, one (worker index K)
for the measured exchange, which draws every worker's noise at once.
They are not the JAX package's key streams.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comm.plan import WIRE_MODES, CommPlan
from repro_torch.core.comm_scheduler import LinkModel
from repro_torch.core.compression import EF_METHODS, Compressor
from repro_torch.core.sync import ElasticWorkerSet, default_periods
from repro_torch.core.tree import LeafLayout, tree_map
from repro_torch.elastic.backup import participation_weights

ARCHS = ("allreduce", "ps")                   # §3.3.1 architectures


@dataclasses.dataclass(frozen=True)
class DataParallelConfig:
    num_workers: int = 8
    lr: float = 0.1
    sync: str = "bsp"                # bsp (ssp | asp | sma: queue A item 6)
    arch: str = "allreduce"          # allreduce (ps: queue A item 6)
    periods: Optional[Tuple[int, ...]] = None   # worker speeds
    topology: str = "ring"           # key into core.allreduce.TOPOLOGIES
    compressor: Compressor = Compressor("none")
    backup: int = 0                  # BSP backup workers (queue A item 7)
    detect: bool = False             # straggler detection (queue A item 7)
    bucket_mb: float = 4.0           # gradient bucket fusion size
    order: str = "tictac"            # "tictac" | "random" | "layer"
    link: LinkModel = LinkModel()
    back_s_per_byte: float = 2e-12   # modeled backward s per gradient byte
    wire: str = "modeled"            # modeled | measured
    seed: int = 0


def _unported(cfg: DataParallelConfig) -> Optional[str]:
    if cfg.sync != "bsp":
        return f"sync={cfg.sync!r}: ROADMAP queue A item 6"
    if cfg.arch != "allreduce":
        return f"arch={cfg.arch!r}: ROADMAP queue A item 6"
    if cfg.backup or cfg.detect:
        return "backup workers and straggler detection: ROADMAP queue A item 7"
    return None


class DeviceEngine(ElasticWorkerSet):
    """BSP data parallelism over K workers on one device:
    ``init / step / finalize`` plus a composed ``run`` returning
    ``(params, history, wire_bytes)``, like the reference's engine.

    ``grad_fn(params, batch) -> (loss, grads)`` with ``grads`` a tree like
    ``params``; ``layout`` maps such a tree onto the reference's leaves
    (``LeafLayout.of_tree(params)`` when not given)."""

    def __init__(self, cfg: DataParallelConfig, grad_fn: Callable,
                 layout: Optional[LeafLayout] = None, device="cuda"):
        if cfg.arch not in ARCHS:
            raise ValueError(f"arch={cfg.arch!r} (supported: {ARCHS})")
        if cfg.wire not in WIRE_MODES:
            raise ValueError(f"wire={cfg.wire!r} (supported: {WIRE_MODES})")
        why = _unported(cfg)
        if why:
            raise NotImplementedError(f"not ported yet: {why}")
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.layout = layout
        self.device = torch.device(device)
        self.periods = cfg.periods or default_periods(cfg.num_workers)
        if len(self.periods) != cfg.num_workers:
            raise ValueError("periods must name every worker")
        self.slowdowns: List[float] = [1.0] * cfg.num_workers
        self._dropped = 0
        self._plan: Optional[CommPlan] = None
        self._wire_total = 0

    @property
    def _ef_active(self) -> bool:
        return self.cfg.compressor.method in EF_METHODS

    # ------------------------------------------------------------- planning
    def _layout(self, params) -> LeafLayout:
        if self.layout is None:
            self.layout = LeafLayout.of_tree(params)
        return self.layout

    def _ensure_plan(self, params) -> CommPlan:
        """The engine's single ``CommPlan``, built once over the
        reference's leaf shapes and shared by the executed exchange, the
        timeline model and the wire accounting."""
        if self._plan is None:
            cfg = self.cfg
            self._plan = CommPlan.plan(
                self._layout(params).shapes(params), n=cfg.num_workers,
                topology=cfg.topology, compressor=cfg.compressor,
                wire=cfg.wire, bucket_mb=cfg.bucket_mb, order=cfg.order,
                back_s_per_byte=cfg.back_s_per_byte, seed=cfg.seed,
                link=cfg.link)
        return self._plan

    def modeled_timeline(self, params) -> Dict[str, float]:
        """Iteration-time projections for the exact bucket plan this engine
        executes."""
        return self._ensure_plan(params).modeled_timeline()

    def per_event_wire_bytes(self, params) -> int:
        """Modeled bytes one worker puts on the wire per gradient push."""
        return self._ensure_plan(params).modeled_event_bytes()

    def wire_bytes_per_step(self, params) -> int:
        """Modeled bytes per BSP step summed over workers."""
        return self.per_event_wire_bytes(params) * self.cfg.num_workers

    # --------------------------------------------------------- bsp stepping
    def _generator(self, t: int, w: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            (self.cfg.seed * 1_000_003 + t) * 31 + w)

    def _step_bsp(self, st, batches, t):
        cfg = self.cfg
        K = cfg.num_workers
        comp = cfg.compressor
        layout = self._layout(st["params"])
        plan = self._ensure_plan(st["params"])
        drop = self.backup_drop(cfg.backup)
        weights = participation_weights(K, drop)
        sent: List[List[torch.Tensor]] = []
        losses = []
        for w in range(K):
            with record_function("forward_backward"):
                loss, grads = self.grad_fn(st["params"], batches(t, w))
            leaves = layout.leaves(grads, consume=True)
            del grads
            ef_new = None
            with record_function("stack_and_compress"):
                if comp.method != "none" and not plan.in_schedule:
                    ef = None if st["ef"] is None else st["ef"][w]
                    leaves, ef_new, _ = comp.roundtrip(
                        leaves, ef, self._generator(t, w))
                    del ef
                else:
                    leaves = list(leaves)
            wt = float(weights[w])
            if wt != 1.0:
                leaves = [x * wt for x in leaves]
            if ef_new is not None and wt > 0:
                st["ef"][w] = ef_new
            sent.append(leaves)
            losses.append(float(loss))
            del leaves, ef_new
        nz = 0
        with record_function("allreduce"):
            if plan.in_schedule:
                # encoded planes inside the schedule; each worker's EF is
                # consumed and renewed by the exchange (keeping a dropped
                # worker's residual comes with backup workers, item 7)
                avg, ef_new, sent_elems = plan.exchange(
                    sent, st["ef"], self._generator(t, K))
                if ef_new is not None:
                    st["ef"] = ef_new
                nz = int(sent_elems.sum())
            else:
                avg = plan.reduce_grads(sent)
        lr = cfg.lr
        with record_function("sgd_update"):
            st["params"] = layout.update(st["params"], avg,
                                         lambda p, g: p - lr * g)
        if cfg.wire == "measured":
            # every step from the plan: the shape-static plane bytes of
            # the whole schedule plus dgc's sparse payload (all workers)
            st["wire"] += plan.measured_step_tx_bytes() * K \
                + plan.measured_bytes(nz)
        else:
            st["wire"] += plan.modeled_event_bytes() * (K - len(drop))
        self._dropped += len(drop)
        # participant-mean loss, float64 like the reference's accounting
        part = [losses[w] for w in range(K) if w not in drop]
        ev = dict(step=t, loss=float(np.mean(part)), max_staleness=0)
        if drop:
            ev["dropped"] = sorted(drop)
        return st, [ev]

    # -------------------------------------------------- engine protocol
    def init(self, params) -> Dict[str, Any]:
        params = tree_map(lambda x: x.to(self.device), params)
        ef = None
        if self._ef_active:
            shapes = self._layout(params).shapes(params)
            ef = [self.cfg.compressor.init_state(
                torch.empty(s, device=self.device) for s in shapes)
                for _ in range(self.cfg.num_workers)]
        return dict(params=params, ef=ef, wire=0)

    def step(self, st, batches: Callable[[int, int], Any], t: int):
        st, ev = self._step_bsp(st, batches, t)
        self._wire_total = st["wire"]
        return st, ev

    def finalize(self, st):
        return st["params"]

    def wire_bytes(self) -> int:
        return self._wire_total

    def extra_metrics(self) -> Dict[str, Any]:
        m: Dict[str, Any] = {"wire_mode": self.cfg.wire}
        if self._plan is not None:
            m["measured_step_tx_bytes"] = self._plan.measured_step_tx_bytes()
            m["fp32_step_tx_bytes"] = self._plan.fp32_step_tx_bytes()
        return m

    def run(self, params, batches: Callable[[int, int], Any], steps: int):
        """batches(t, worker) -> batch.  Returns (params, history,
        wire_bytes)."""
        st = self.init(params)
        hist: List[dict] = []
        for t in range(steps):
            st, ev = self.step(st, batches, t)
            hist.extend(ev)
        return self.finalize(st), hist, st["wire"]
