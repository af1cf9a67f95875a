"""Data parallelism with compressed, bucketed, topology-explicit
communication (survey §3.3): the JAX package's
``train/data_parallel.py::DeviceEngine`` over the survey's Table 1,
{bsp, ssp, asp, sma} x {allreduce, ps}.

K logical workers share one device (``core.collectives.LogicalAxis``),
or each worker is one ``torch.distributed`` rank (``group=``:
``core.collectives.DistAxis``, one process per worker as one device per
worker in the reference); gradients travel as the reference's leaf list
(``core.tree.LeafLayout``).

  sync=bsp        every step runs each worker's forward and backward on its
                  own batch (one after another), then by ``wire`` mode:
                  modeled, ``Compressor.roundtrip`` with the worker's EF
                  residuals and a full-precision exchange; measured, the
                  raw gradients through the codec schedules of
                  ``CommPlan`` (each worker's EF inside the schedule).
  sync=ssp | asp  the simulator's deterministic tick schedule
                  (``core.sync.firing_schedule`` over
                  ``effective_periods()``) replayed: each firing worker
                  pushes the gradient of its stale pulled parameters, in
                  the simulator's event order.  The reference computes
                  every worker's gradient each tick under ``shard_map`` and
                  uses the firing ones; on one card only the firing workers
                  compute, which gives the same values.
  sync=sma        CROSSBOW synchronous model averaging: K replicas, a
                  center that is a ``CommPlan`` exchange of the replicas,
                  and ``r - lr g - mu (r - center)``.
  arch=allreduce  decentralized: the bucketed topology exchange, the update
                  replicated.
  arch=ps         centralized: the reduce-scatter / shard update /
                  all-gather path of ``core.parameter_server``.  Under BSP
                  it runs over the same bucket plan and issue order as
                  allreduce (``make_bucketed_ps_update``, or the encoded
                  ``CommPlan.ps_exchange`` when measured); under SSP/ASP
                  each firing worker's push is a per-leaf reduce-scatter in
                  which the other workers contribute exact zeros.

Wire bytes: ``modeled`` is the compressor's analytic accounting per push
(the simulator's); ``measured`` is the plan's shape-static plane bytes
times K plus 8 B per sparse element shipped (dgc).  SSP/ASP pushes are
counted as modeled bytes per event in both modes, as in the reference.

Backup workers (``backup=k``, bsp only): each step the k slowest workers
(``ElasticWorkerSet.backup_drop``: the scheduled ranking, or with
``detect`` the measured step-time EMA of each worker's batch fetch) send
with weight 0 and the participants with K/(K-k); a dropped worker's EF
residual is kept on both wire modes.  ``reshard``, ``export_state`` and
``import_state`` are the elastic interface (``elastic.recovery``).  The
workers are logical, so a resize needs no more devices (the reference
checks its device count; over a process group the group's rank count
bounds it).

Each phase runs under a ``torch.profiler.record_function`` range
(``forward_backward``, ``stack_and_compress``, ``allreduce`` for the
exchange or the PS round, ``sgd_update``), so a profile splits the step's
device time by phase (``tools/torch_train_profile.py``).

``torch.Generator``s seeded from (seed, step or event, worker) drive the
stochastic methods (``core.sync.event_generator``): one per worker for the
modeled roundtrip, one (worker index K) for the measured exchange.  They
are not the JAX package's key streams.  A rank computes its worker's
gradient with that worker's generator and draws the exchange's whole
noise blocks, keeping its rows, so a process group reproduces the
logical engine's numbers.

Over a process group (``DeviceEngine(..., group=)``) each rank holds the
replicated parameters and its own worker's EF row only (EF memory cut by
K), runs the exchange or the PS round over ``DistAxis``, gathers the K
losses (the float64 worker-order mean, as on the logical axis) and dgc's
sparse counts, and only rank 0 writes the trace.  Under SSP/ASP every
rank replays the same firing schedule and only the firing worker's rank
computes: it broadcasts the event's loss and, under allreduce, its
(compressed) leaves, while under PS the other ranks push exact zeros; a
rank keeps its own worker's pulled parameters.  Under SMA a rank holds
its own replica.  With backup workers every rank derives the same drop
set; with detection each rank times its own worker's batch fetch and
every rank's detector observes the K times gathered in worker order.

The elastic interface runs over the group too.  Worker j runs on rank j,
as the reference rebuilds its mesh over the first M live devices: a
resize to M workers moves the engine onto the group of the first M ranks
(``launch.dist.prefix_group``), each survivor's EF row (or SMA replica)
travels from its old rank to its new one, a grown rank starts with zero
EF and receives the parameters (SMA: the old workers' center) by
broadcast, and a rank past M idles: it takes no part in the step's
collectives, receives each step's events and wire count from rank 0, and
still joins every resize and snapshot.  Before each resize rank 0's
schedule (periods, slowdowns, detector, async clocks) is broadcast, so
an idle rank's copy never goes stale.  ``export_state`` gathers every
worker's rows to rank 0, which returns the logical engine's ``(arrays,
meta)``; the other ranks return the same tree with their own rows and
None for the rest (``snapshot_template``: a restore reads no other
rank's rows), and ``snapshot_writer`` is true on rank 0 only.
``import_state`` keeps the rank's own rows.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comm.plan import (WIRE_MODES, CommPlan, fuse, plan_buckets,
                                   scatter_flat)
from repro_torch.core.collectives import (DistAxis, LogicalAxis, axis_of,
                                          gather_values)
from repro_torch.core.comm_scheduler import LinkModel
from repro_torch.core.compression import EF_METHODS, Compressor
from repro_torch.core.parameter_server import (all_gather_flat, make_ps_step,
                                               pad_to_multiple, sgd_update_fn,
                                               shard_of_flat)
from repro_torch.core.sync import (ElasticWorkerSet, default_periods,
                                   event_generator, firing_schedule)
from repro_torch.core.tree import (LeafLayout, get_path, leaf_paths,
                                   set_path, tree_map)
from repro_torch.elastic.backup import participation_weights
from repro_torch.obs.trace import NullRecorder, get_recorder
from repro_torch.train.train_loop import fold_in

DEVICE_SYNCS = ("bsp", "ssp", "asp", "sma")   # device-executable sync models
ARCHS = ("allreduce", "ps")                   # §3.3.1 architectures


@dataclasses.dataclass(frozen=True)
class DataParallelConfig:
    num_workers: int = 8
    lr: float = 0.1
    sync: str = "bsp"                # bsp | ssp | asp | sma
    arch: str = "allreduce"          # allreduce | ps
    staleness: int = 3               # SSP bound s
    periods: Optional[Tuple[int, ...]] = None   # worker speeds
    topology: str = "ring"           # key into core.allreduce.TOPOLOGIES
    compressor: Compressor = Compressor("none")
    backup: int = 0                  # BSP backup workers: drop the k slowest
    # measured straggler detection: per-worker step-time EMA replaces the
    # scheduled ranking in the backup drop set (elastic/detector.py)
    detect: bool = False
    bucket_mb: float = 4.0           # gradient bucket fusion size
    order: str = "tictac"            # "tictac" | "random" | "layer"
    link: LinkModel = LinkModel()
    back_s_per_byte: float = 2e-12   # modeled backward s per gradient byte
    wire: str = "modeled"            # modeled | measured
    sma_mu: float = 0.1              # SMA correction strength
    seed: int = 0


def make_bucketed_ps_update(leaf_shapes, lr: float, bucket_mb: float = 4.0,
                            order: str = "tictac",
                            back_s_per_byte: float = 2e-12, seed: int = 0):
    """Centralized (params, grads) -> new parameter leaves: the same
    fused-bucket plan and issue order as ``CommPlan.reduce_grads``, but
    each bucket takes the parameter-server path of
    ``core.parameter_server``: reduce-scatter the bucket's summed
    gradient, SGD-update each worker's 1/n shard (the "server" work,
    ZeRO-style) and all-gather the updated shards back.  Traffic per
    worker equals the ring allreduce's; update work drops by n.

    ``params`` is the replicated leaf list (any indexable, e.g. a
    ``core.tree.LeafView``), ``grads[r]`` the leaf list of worker
    ``axis.ids[r]`` (every worker on the default logical axis), consumed
    bucket by bucket."""
    shapes = [tuple(s) for s in leaf_shapes]
    buckets, order_idx, _ = plan_buckets(shapes, bucket_mb, order,
                                         back_s_per_byte, seed)

    def ps_update(params, grads, axis=None):
        k = len(grads)
        out: List[torch.Tensor] = [None] * len(shapes)
        for b in order_idx:
            idxs = buckets[b]
            pb = torch.cat([params[i].float().reshape(-1) for i in idxs])
            gb = fuse(grads, idxs, shapes, pb.shape[0])
            ax = axis_of(gb, axis)
            step = make_ps_step(sgd_update_fn(lr, mean_over=ax.size), ax)
            (new_pb,), _ = step([pb[None].expand(k, -1)], [gb], None)
            del pb, gb
            scatter_flat(new_pb[0], idxs, shapes, out)
            del new_pb
        return out

    return ps_update


def make_bucketed_allreduce(params_example, topology: str = "ring",
                            bucket_mb: float = 4.0, order: str = "tictac",
                            back_s_per_byte: float = 2e-12, seed: int = 0,
                            layout: Optional[LeafLayout] = None):
    """Workers' leaf lists -> their mean leaf list, for
    ``make_train_step(..., reduce_fn=...)``: the reference's leaves (over
    ``layout``, ``LeafLayout.of_tree(params_example)`` by default) fused
    into ~bucket_mb buckets in backward order, issued in the chosen
    transfer order, each reduced with the topology-explicit schedule.  A
    thin wrapper over ``CommPlan.reduce_grads`` (the exact full-precision
    path); the plan takes the worker count from the lists it is given, or
    from ``axis`` (``reduce_grads(grads, axis=)``, ``grads`` then the lists
    of the workers this process holds)."""
    layout = layout or LeafLayout.of_tree(params_example)
    plan = CommPlan.plan(layout.shapes(params_example), n=1,
                         topology=topology, bucket_mb=bucket_mb, order=order,
                         back_s_per_byte=back_s_per_byte, seed=seed)

    def reduce_grads(grads: List[List[torch.Tensor]],
                     axis=None) -> List[torch.Tensor]:
        n = len(grads) if axis is None else axis.size
        p = plan if n == plan.n else dataclasses.replace(plan, n=n)
        with record_function("allreduce"):
            return p.reduce_grads(grads, axis)

    reduce_grads.fused_layers = plan.fused
    reduce_grads.order = plan.order
    reduce_grads.plan = plan
    return reduce_grads


def _worker_mean(values) -> np.float32:
    """The fp32 mean over workers (``jax.lax.pmean`` of fp32 metrics)."""
    vals = [np.float32(float(v)) for v in values]
    total = vals[0]
    for v in vals[1:]:
        total = np.float32(total + v)
    return np.float32(total / np.float32(len(vals)))


def make_sharded_train_step(train_step: Callable, workers: int,
                            compressed: bool, axis=None):
    """Lift a ``make_train_step`` step (built with ``reduce_fn``, e.g.
    ``make_bucketed_allreduce``'s) over ``workers`` workers: the
    reference's ``shard_map`` over the worker axis, run as

      1. the gradient, cast and compression of each worker this process
         holds, in turn, on its slice of the stacked batch (``[workers,
         ...]`` leaves), with its generator (the step's with the worker
         index folded in) and, when ``compressed``, its row of the stacked
         EF leaves;
      2. ``reduce_fn`` once over those workers' leaf lists;
      3. the optimizer once, on this process's replica of the parameters.

    ``axis`` (``core.collectives``) says which workers this process holds:
    all of them by default, on one device; with a ``DistAxis`` each rank
    runs its own worker, and its EF leaves are ``[1, ...]`` (its row).
    Metrics are the fp32 mean over all workers (``pmean``), gathered
    across processes in worker order.  The step has the ``train_loop``
    contract ``step(state, stacked_batch, gen) -> (state, metrics)`` and,
    as ``make_train_step``'s, updates the state in place (each worker
    renews its row of the EF)."""
    worker, update = train_step._worker, train_step._update
    if train_step._reduce_fn is None:
        raise ValueError("make_sharded_train_step needs a step built with "
                         "reduce_fn (e.g. make_bucketed_allreduce)")
    ax = axis if axis is not None else LogicalAxis(workers)
    if ax.size != workers:
        raise ValueError(f"{workers} workers on an axis of {ax.size}")

    def step(state, batch, gen: Optional[torch.Generator] = None):
        ef = state["ef"] if compressed else None
        sent, per_worker = [], []
        for row, w in enumerate(ax.ids):
            loss, mets, leaves, wire = worker(
                state["params"], tree_map(lambda x: x[w], batch),
                None if ef is None else [e[row] for e in ef],
                None if gen is None else fold_in(gen, w))
            sent.append(leaves)
            per_worker.append(dict(mets, loss=loss, wire_bytes=wire))
            del leaves
        if axis is None:
            mean = train_step._reduce_fn(sent)
        else:
            mean = train_step._reduce_fn(sent, axis=ax)
        del sent
        state, mets = update(state, mean, per_worker[0],
                             per_worker[0]["loss"],
                             per_worker[0]["wire_bytes"])
        for m in per_worker:
            m["lr"] = mets["lr"]
        return state, {k: _worker_mean(gather_values(
            ax, [m[k] for m in per_worker])) for k in mets}

    return step


def async_replay_step(st, batches, t, bound: Optional[int], *, K: int,
                      push_grad: Callable, apply_fn: Callable,
                      event_wire: int, eff_periods: Tuple[int, ...],
                      axis=None):
    """Replay the simulator's deterministic tick schedule: each tick's
    firing events apply in the simulator's worker order, each worker
    pushing the gradient of its stale pulled parameters.

    ``push_grad(w, pulled, batch, event) -> (loss, leaves)`` computes
    worker w's (compressed) gradient leaves and renews its EF;
    ``apply_fn(params, leaves, w)`` applies one push through the
    architecture, on every process (``leaves`` is None where this process
    does not hold w).  Only the firing workers compute: a non-firing
    worker's gradient and EF would be discarded, and a firing worker's
    pulled parameters cannot change within its tick (each worker fires at
    most once per tick), so computing at its event gives the reference's
    values.

    ``axis`` (every worker logical by default) says which workers this
    process holds: ``st["pulled"]`` has one entry per held worker, and
    the firing worker's process broadcasts the event's loss.  The
    schedule's scalars (versions, batch clocks, tick) advance alike on
    every process, so all of them enter each event's collectives in the
    same order."""
    ax = axis if axis is not None else LogicalAxis(K)
    held = ax.ids
    events = []
    while st["updates"] - st["updates_base"] < \
            (t + 1 - st["step_base"]) * K:
        st["tick"] += 1
        # the same deterministic schedule the simulator executes
        firing = firing_schedule(st["tick"], eff_periods, st["batch_idx"],
                                 bound)
        if not firing:
            continue
        # a worker's batch index only advances at its own events, so its
        # batch is cached until it fires (invalidated below)
        for w in held:
            if st["batch_cache"][w] is None:
                st["batch_cache"][w] = batches(st["batch_idx"][w], w)
        for w in firing:
            row = held.index(w) if w in held else None
            loss, leaves = (push_grad(w, st["pulled"][row],
                                      st["batch_cache"][w], st["updates"])
                            if row is not None else (0.0, None))
            # float64 carries the fp32 loss exactly
            loss = ax.broadcast(torch.tensor(
                [float(loss)], dtype=torch.float64, device=ax.device), w)
            staleness = st["server_ver"] - st["pulled_ver"][w]
            st["params"] = apply_fn(st["params"], leaves, w)
            del leaves
            st["server_ver"] += 1
            st["updates"] += 1
            if row is not None:
                st["pulled"][row] = st["params"]   # pull = reference rebind
            st["pulled_ver"][w] = st["server_ver"]
            st["batch_idx"][w] += 1
            st["batch_cache"][w] = None
            st["wire"] += event_wire
            events.append(dict(step=st["updates"], loss=float(loss[0]),
                               max_staleness=staleness, worker=w))
    return st, events


def _tree_bytes(tree) -> int:
    tensors = (get_path(tree, p) for p in leaf_paths(tree))
    return sum(t.numel() * t.element_size() for t in tensors)


def _dist_axis(cfg: DataParallelConfig, group) -> DistAxis:
    """The worker axis over ``group``: one worker per rank."""
    import torch.distributed as dist
    axis = DistAxis(group, dist.get_backend(group))
    if axis.size != cfg.num_workers:
        raise ValueError(f"{cfg.num_workers} workers on a process group of "
                         f"{axis.size} ranks")
    return axis


def broadcast_object(world: DistAxis, obj, src: int = 0):
    """``obj`` (any picklable value) of ``world``'s worker ``src`` on
    every rank of it."""
    box = [obj]
    world._dist.broadcast_object_list(box, src=world._peer(src),
                                      group=world.group)
    return box[0]



class DeviceEngine(ElasticWorkerSet):
    """{bsp, ssp, asp, sma} x {allreduce, ps} over K workers on one device:
    ``init / step / finalize`` plus a composed ``run`` returning
    ``(params, history, wire_bytes)``, like the reference's engine.

    ``grad_fn(params, batch) -> (loss, grads)`` with ``grads`` a tree like
    ``params``; ``layout`` maps such a tree onto the reference's leaves
    (``LeafLayout.of_tree(params)`` when not given).

    ``group`` (a ``torch.distributed`` process group of ``num_workers``
    ranks, ``dist.group.WORLD`` for the default one) runs one worker per
    rank (module docstring), resizable up to the group's size."""

    def __init__(self, cfg: DataParallelConfig, grad_fn: Callable,
                 layout: Optional[LeafLayout] = None, device="cuda",
                 group=None):
        if cfg.sync not in DEVICE_SYNCS:
            raise ValueError(f"sync={cfg.sync!r} (supported: {DEVICE_SYNCS})")
        if cfg.arch not in ARCHS:
            raise ValueError(f"arch={cfg.arch!r} (supported: {ARCHS})")
        if cfg.wire not in WIRE_MODES:
            raise ValueError(f"wire={cfg.wire!r} (supported: {WIRE_MODES})")
        if cfg.sync == "sma":
            if cfg.compressor.method != "none":
                raise ValueError("sma exchanges replicas, not gradients: "
                                 "it has no compression path")
            if cfg.arch != "allreduce":
                raise ValueError("sma is a decentralized exchange; use "
                                 "arch='allreduce'")
        if cfg.backup and cfg.sync != "bsp":
            raise ValueError("backup workers compose with bsp only "
                             "(async modes have no round to drop from)")
        if cfg.backup >= cfg.num_workers:
            raise ValueError("backup k must leave at least one worker")
        # over a group: every rank of it (``_world``) and the active
        # workers' axis (the first num_workers ranks; None on an idle rank)
        self._world = None if group is None else _dist_axis(cfg, group)
        self._group_axis = self._world
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.layout = layout
        self.device = torch.device(device)
        self.periods = cfg.periods or default_periods(cfg.num_workers)
        if len(self.periods) != cfg.num_workers:
            raise ValueError("periods must name every worker")
        self.slowdowns: List[float] = [1.0] * cfg.num_workers
        self._dropped = 0
        self._init_detector(cfg.detect, cfg.num_workers)
        self._plan: Optional[CommPlan] = None
        self._ps_update: Optional[Callable] = None
        self._wire_total = 0

    @property
    def _ef_active(self) -> bool:
        return self.cfg.compressor.method in EF_METHODS

    @property
    def axis(self):
        """The worker axis: one worker per active rank of the process
        group (None on an idle rank), or every worker (their current
        number) in this process."""
        if self._world is not None:
            return self._group_axis
        return LogicalAxis(self.cfg.num_workers)

    @property
    def _held(self) -> List[int]:
        """The workers this process holds: all of them, its rank's, or
        none on an idle rank."""
        ax = self.axis
        return [] if ax is None else ax.ids

    @property
    def _has_idle(self) -> bool:
        return (self._world is not None
                and self.cfg.num_workers < self._world.size)

    @property
    def snapshot_writer(self) -> bool:
        """Whether this process writes the engine's snapshots: rank 0 of
        a group, or the one process of the logical axis."""
        return self._world is None or self._world.rank == 0

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
        """Modeled bytes one worker puts on the wire per gradient push
        (identical for both architectures and to the simulator's)."""
        return self._ensure_plan(params).modeled_event_bytes()

    def wire_bytes_per_step(self, params) -> int:
        """Modeled bytes per BSP step summed over workers."""
        return self.per_event_wire_bytes(params) * self.cfg.num_workers

    def _generator(self, t: int, w: int) -> torch.Generator:
        return event_generator(self.cfg.seed, t, w, self.device)

    # --------------------------------------------------------- bsp stepping
    def _step_bsp(self, st, batches, t):
        cfg = self.cfg
        K = cfg.num_workers
        plan = self._ensure_plan(st["params"])
        drop = self.backup_drop(cfg.backup)
        # one trace per run: a process group's rank 0 writes it
        rec = get_recorder() if self.axis.ids[0] == 0 else NullRecorder()
        if rec.enabled:
            # one compute span over the whole step (the reference's fused
            # dispatch: gradients, exchange, update), synchronized so its
            # wall is honest; the exchange structure emitted below is the
            # plan's deterministic model of what ran inside it
            with rec.span("compute", pid="train", tid="loop", cat="train",
                          clock=("train_step", t), workers=K, fused=True):
                losses, nz = self._bsp_body(st, batches, t, plan, drop)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        else:
            losses, nz = self._bsp_body(st, batches, t, plan, drop)
        if cfg.wire == "measured":
            # every step from the plan: the shape-static plane bytes of
            # the whole schedule plus dgc's sparse payload (all workers)
            st["wire"] += plan.measured_step_tx_bytes(cfg.arch) * K \
                + plan.measured_bytes(nz)
        else:
            st["wire"] += plan.modeled_event_bytes() * (K - len(drop))
        if rec.enabled:
            plan.emit_trace(rec, arch=cfg.arch, clock=("train_step", t))
            rec.counter("wire_bytes", {"cumulative": int(st["wire"])},
                        pid="train", cat="comm", clock=("train_step", t))
        self._dropped += len(drop)
        # participant-mean loss, float64 like the reference's accounting
        losses = gather_values(self.axis, losses)
        part = [losses[w] for w in range(K) if w not in drop]
        ev = dict(step=t, loss=float(np.mean(part)), max_staleness=0)
        if drop:
            ev["dropped"] = sorted(drop)
        return st, [ev]

    def _bsp_body(self, st, batches, t, plan: CommPlan, drop):
        """The BSP step's work: the gradient and compression of every
        worker this process holds, the exchange and the update of ``st``
        in place.  Returns (those workers' losses as floats, dgc's sparse
        elements sent by all workers)."""
        cfg = self.cfg
        K = cfg.num_workers
        ax = self.axis
        comp = cfg.compressor
        layout = self._layout(st["params"])
        weights = participation_weights(K, drop)
        if self.detector is not None:
            # each worker's batch fetch is its host work here (a straggling
            # input pipeline is the detectable straggler); the gradients
            # run asynchronously on a card, so they are not timed, and the
            # previous step's queued work drains first (a fetch that copies
            # to the card would wait for it and charge it to worker 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            fetched, took = {}, []
            for w in ax.ids:
                t0 = time.perf_counter()
                fetched[w] = batches(t, w)
                took.append(time.perf_counter() - t0)
            # every process observes all K times, in worker order, so the
            # drop sets agree
            for w, seconds in enumerate(gather_values(ax, took)):
                self.detector.observe(w, seconds)
            batches = lambda _t, w: fetched[w]   # noqa: E731
        sent: List[List[torch.Tensor]] = []
        losses = []
        for row, w in enumerate(ax.ids):
            with record_function("forward_backward"):
                loss, grads = self.grad_fn(st["params"], batches(t, w))
            leaves = layout.leaves(grads, consume=True)
            del grads
            ef_new = None
            with record_function("stack_and_compress"):
                if comp.method != "none" and not plan.in_schedule:
                    ef = None if st["ef"] is None else st["ef"][row]
                    leaves, ef_new, _ = comp.roundtrip(
                        leaves, ef, self._generator(t, w))
                    del ef
                else:
                    leaves = list(leaves)
            wt = float(weights[w])
            if wt != 1.0:
                leaves = [x * wt for x in leaves]
            if ef_new is not None and wt > 0:
                st["ef"][row] = ef_new
            sent.append(leaves)
            losses.append(float(loss))
            del leaves, ef_new
        nz = 0
        lr = cfg.lr
        params = layout.view(st["params"])
        with record_function("allreduce"):
            # the exchange; under arch="ps" it is the whole PS round
            # (push, shard update, pull)
            if plan.in_schedule:
                # encoded planes inside the schedule; the exchange consumes
                # and renews every held worker's EF (a row each), and a
                # dropped worker keeps its old residual (its push never
                # reached the server)
                kept = ({row: list(st["ef"][row])
                         for row, w in enumerate(ax.ids) if w in drop}
                        if st["ef"] is not None else {})
                if cfg.arch == "ps":
                    new, ef_new, sent_elems = plan.ps_exchange(
                        params, sent, st["ef"], self._generator(t, K), lr,
                        axis=ax)
                else:
                    avg, ef_new, sent_elems = plan.exchange(
                        sent, st["ef"], self._generator(t, K), axis=ax)
                if ef_new is not None:
                    for row, old in kept.items():
                        ef_new[row] = old
                    st["ef"] = ef_new
                nz = int(sum(gather_values(ax, sent_elems.tolist())))
            elif cfg.arch == "ps":
                if self._ps_update is None:
                    self._ps_update = make_bucketed_ps_update(
                        plan.leaf_shapes, lr, bucket_mb=cfg.bucket_mb,
                        order=cfg.order,
                        back_s_per_byte=cfg.back_s_per_byte, seed=cfg.seed)
                new = self._ps_update(params, sent, axis=ax)
            else:
                avg = plan.reduce_grads(sent, axis=ax)
        with record_function("sgd_update"):
            if cfg.arch == "ps":
                st["params"] = layout.update(st["params"], new,
                                             lambda p, x: x.to(p.dtype))
            else:
                st["params"] = layout.update(st["params"], avg,
                                             lambda p, g: p - lr * g)
        return losses, nz

    # ------------------------------------------------------------------ sma
    def _step_sma(self, st, batches, t):
        """CROSSBOW synchronous model averaging: the center is a
        ``CommPlan`` exchange of the replicas themselves (the gradient
        paths' bucket fusion and issue order) over the worker axis, taken
        before the step, and each replica this process holds moves by
        ``r - lr g - mu (r - center)``."""
        cfg = self.cfg
        K = cfg.num_workers
        ax = self.axis
        lr, mu = cfg.lr, cfg.sma_mu
        reps = st["replicas"]
        layout = self._layout(reps[0])
        plan = self._ensure_plan(reps[0])
        with record_function("allreduce"):
            center = layout.update(
                reps[0], plan.reduce_grads([layout.view(r) for r in reps],
                                           axis=ax),
                lambda p, z: z)
        losses = []
        for row, w in enumerate(ax.ids):
            with record_function("forward_backward"):
                loss, g = self.grad_fn(reps[row], batches(t, w))
            with record_function("sgd_update"):
                reps[row] = tree_map(
                    lambda r, z, gg: r - lr * gg - mu * (r - z),
                    reps[row], center, g)
            losses.append(float(loss))
            del g
        losses = gather_values(ax, losses)
        if cfg.wire == "measured":
            st["wire"] += plan.measured_step_tx_bytes("allreduce") * K
        else:
            # the simulator's accounting: one replica-sized push per worker
            st["wire"] += 4 * sum(int(np.prod(s))
                                  for s in plan.leaf_shapes) * K
        return st, [dict(step=t, loss=float(np.mean(losses)),
                         max_staleness=0)]

    # --------------------------------------------------- ssp / asp stepping
    def _push_grad(self, st, w: int, pulled, batch, event: int):
        """Worker w's gradient leaves against its pulled parameters,
        compressed with its EF row (renewed here: only firing workers
        consume their residual)."""
        comp = self.cfg.compressor
        row = self.axis.ids.index(w)
        with record_function("forward_backward"):
            loss, grads = self.grad_fn(pulled, batch)
        leaves = self._layout(pulled).leaves(grads, consume=True)
        del grads
        with record_function("stack_and_compress"):
            if comp.method == "none":
                return loss, list(leaves)
            out, ef_new, _ = comp.roundtrip(
                leaves, None if st["ef"] is None else st["ef"][row],
                self._generator(event, w))
            if ef_new is not None:
                st["ef"][row] = ef_new
        return loss, out

    def _firer_leaves(self, params, leaves, w: int):
        """Worker w's pushed leaves on every process, leaf by leaf: the
        process that holds w broadcasts them (the others pass receive
        buffers), so every replica applies the same bits."""
        ax = self.axis
        layout = self._layout(params)
        for i, shape in enumerate(self._ensure_plan(params).leaf_shapes):
            if leaves is not None:
                x, leaves[i] = leaves[i], None
            else:
                x = torch.empty(shape, dtype=get_path(
                    params, layout.parts[i][0]).dtype, device=self.device)
            yield ax.broadcast(x, w)
            del x

    def _apply(self, params, leaves, w: int):
        lr = self.cfg.lr
        with record_function("sgd_update"):
            return self._layout(params).update(
                params, self._firer_leaves(params, leaves, w),
                lambda p, g: p - lr * g)

    def _ps_push(self, params, leaves, w: int):
        """The firing worker's push through the parameter server, leaf by
        leaf: every other worker contributes exact zeros (views, no
        copies), the reduce-scatter delivers each shard to its owner,
        which applies plain SGD (the raw sum: one pusher), and the pull
        all-gathers the updated shards.  ``leaves`` is None where this
        process does not hold w."""
        ax = self.axis
        n, k = ax.size, len(ax.ids)
        layout = self._layout(params)
        update = sgd_update_fn(self.cfg.lr)
        new = []
        with record_function("allreduce"):
            for i in range(len(layout.parts)):
                p = layout.leaf(params, i)
                L = p.numel()
                zero = torch.zeros((), device=p.device).expand(n, -(-L // n))
                chunks = zero
                if leaves is not None:
                    g, _ = pad_to_multiple(leaves[i].float(), n)
                    leaves[i] = None
                    chunks = g.reshape(n, -1)
                    del g
                g_shard = ax.psum_scatter([chunks if v == w else zero
                                           for v in ax.ids])
                del chunks
                p_shard = shard_of_flat(p.float().reshape(1, L).expand(k, L),
                                        ax)
                (new_shard,), _ = update([p_shard], [g_shard], None)
                del p_shard, g_shard
                new.append(all_gather_flat(new_shard, L, ax)[0].reshape(
                    p.shape).to(p.dtype))
                del p, new_shard
        return layout.update(params, new, lambda p, x: x)

    def _step_async(self, st, batches, t, bound: Optional[int]):
        cfg = self.cfg
        return async_replay_step(
            st, batches, t, bound, K=cfg.num_workers,
            push_grad=functools.partial(self._push_grad, st),
            apply_fn=self._ps_push if cfg.arch == "ps" else self._apply,
            event_wire=self.per_event_wire_bytes(st["params"]),
            eff_periods=self.effective_periods(), axis=self.axis)

    # -------------------------------------------------- engine protocol
    def _like(self):
        """Empty tensors shaped like the parameters: the receive buffers
        of a rank that holds no current copy."""
        return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                              device=self.device),
                        self._param_meta)

    def init(self, params) -> Dict[str, Any]:
        cfg = self.cfg
        K = cfg.num_workers
        params = tree_map(lambda x: x.to(self.device), params)
        self._param_meta = tree_map(lambda x: x.to("meta"), params)
        held = self._held
        ef = None
        if self._ef_active:
            # one residual per worker this process holds
            shapes = self._layout(params).shapes(params)
            ef = [cfg.compressor.init_state(
                torch.empty(s, device=self.device) for s in shapes)
                for _ in held]
        st: Dict[str, Any] = dict(params=params, ef=ef, wire=0)
        if cfg.sync in ("ssp", "asp"):
            st.update(
                # the held workers' pulled parameters, reference rebinds
                pulled=[params] * len(held),
                pulled_ver=[0] * K,
                server_ver=0,
                tick=0,
                updates=0,
                batch_idx=[0] * K,
                batch_cache=[None] * K,
                updates_base=0,
                step_base=0)
        elif cfg.sync == "sma":
            del st["params"]
            # the held workers' replicas; updates are out of place
            st["replicas"] = [params] * len(held)
        return st

    def step(self, st, batches: Callable[[int, int], Any], t: int):
        sync = self.cfg.sync
        ev = None
        if self.axis is None:
            pass                       # an idle rank: rank 0 sends below
        elif sync == "bsp":
            st, ev = self._step_bsp(st, batches, t)
        elif sync == "ssp":
            st, ev = self._step_async(st, batches, t, self.cfg.staleness)
        elif sync == "asp":
            st, ev = self._step_async(st, batches, t, None)
        else:
            st, ev = self._step_sma(st, batches, t)
        if self._has_idle:
            ev, st["wire"], self._dropped = broadcast_object(
                self._world, (ev, st["wire"], self._dropped))
        self._wire_total = st["wire"]
        return st, ev

    def finalize(self, st):
        ax = self.axis
        if self.cfg.sync == "sma":
            # replica average, like the simulator: every replica in worker
            # order, one mean over them on either axis
            out = (None if ax is None else tree_map(
                lambda *xs: ax.all_gather(torch.stack(xs))[0].mean(0),
                *st["replicas"]))
        else:
            out = st["params"]
        if self._has_idle:
            # an idle rank's copy is stale: rank 0's on every rank
            out = tree_map(lambda x: self._world.broadcast(x, 0),
                           out if out is not None else self._like())
        return out

    def wire_bytes(self) -> int:
        return self._wire_total

    def extra_metrics(self) -> Dict[str, Any]:
        m: Dict[str, Any] = {"wire_mode": self.cfg.wire}
        if self._plan is not None:
            m["measured_step_tx_bytes"] = \
                self._plan.measured_step_tx_bytes(self.cfg.arch)
            m["fp32_step_tx_bytes"] = self._plan.fp32_step_tx_bytes()
        return m

    # --------------------------------------------------- elastic interface
    def reshard(self, st, new_workers: int, step: int = 0,
                lost: Tuple[int, ...] = ()):
        """Re-size the worker set N->M in place and return the resharded
        run-state.  Survivors (old slots minus ``lost``, in order) keep
        their EF tensors (no copy) and batch clocks; grown slots start with
        zero residuals at the batch frontier (ssp/asp) or at the
        pre-reshard center (sma).  The comm plan depends on the worker
        count and is re-planned at the next step.  Over a process group
        every rank calls it (module docstring)."""
        if self._world is not None:
            return self._reshard_ranks(st, new_workers, step, lost)
        ef = st["ef"]
        slots, grown = self._reshard_workers(new_workers, lost)
        self._plan, self._ps_update = None, None
        if ef is not None:
            st["ef"] = [ef[s] for s in slots] + [
                [torch.zeros_like(x) for x in ef[0]] for _ in range(grown)]
        if self.cfg.sync in ("ssp", "asp"):
            self._rebase_async(st, slots, grown, step)
            st["batch_cache"] = [None] * new_workers
        elif self.cfg.sync == "sma":
            reps = st["replicas"]
            center = tree_map(lambda *xs: torch.stack(xs).mean(0), *reps)
            st["replicas"] = [reps[s] for s in slots] + [center] * grown
        return st

    def _move_row(self, row, like, slots: List[int]):
        """Worker j's row of the resized set on rank j: rank ``slots[j]``
        sends its old row (a tree of tensors) to rank j, leaf by leaf;
        ``like`` (a tree of the same structure) shapes the receive
        buffers.  Returns this rank's new row, or None when it neither
        keeps nor receives one."""
        W, me = self._world, self._world.rank
        dst = next((j for j, s in enumerate(slots) if s == me and j != me),
                   None)
        src = slots[me] if me < len(slots) and slots[me] != me else None
        keep = me < len(slots) and slots[me] == me
        out = tree_map(lambda x: x, like)
        for p in leaf_paths(like):
            got = W.sendrecv(None if dst is None else get_path(row, p), dst,
                             None if src is None else get_path(like, p), src)
            set_path(out, p, get_path(row, p) if keep else got)
        return out if (keep or src is not None) else None

    def _reshard_ranks(self, st, M: int, step: int, lost: Tuple[int, ...]):
        """``reshard`` over a process group: the slot rule of the logical
        engine, with worker j on rank j (module docstring)."""
        from repro_torch.launch.dist import prefix_group
        W, cfg = self._world, self.cfg
        me, N, sync = W.rank, cfg.num_workers, cfg.sync
        if M > W.size:
            raise ValueError(f"resize to {M} workers needs {M} ranks, the "
                             f"process group has {W.size}")
        # rank 0's schedule and clocks on every rank (an idle rank's are
        # stale), then the same slot rule everywhere
        meta = broadcast_object(W, self._snapshot_meta("device", sync, st))
        self._load_snapshot_meta(meta, sync, st)
        center = None
        if sync == "sma" and me < N:
            # the old workers' mean, in worker order, before they move
            ax = self.axis
            center = tree_map(
                lambda *xs: ax.all_gather(torch.stack(xs))[0].mean(0),
                *st["replicas"])
        slots, grown = self._reshard_workers(M, lost)
        self._plan, self._ps_update = None, None
        if st["ef"] is not None:
            like = self._ef_like()
            row = self._move_row(st["ef"][0] if st["ef"] else None, like,
                                 slots)
            if row is None and me < M:          # a grown slot
                row = [torch.zeros_like(x) for x in like]
            st["ef"] = [row] if me < M else []
        if sync == "sma":
            row = self._move_row(st["replicas"][0] if st["replicas"]
                                 else None, self._like(), slots)
            if grown:
                # a grown slot starts at the old workers' center
                center = tree_map(lambda x: W.broadcast(x, 0),
                                  center if center is not None
                                  else self._like())
            st["replicas"] = ([] if me >= M else
                              [center if row is None else row])
        elif M > N:
            # the ranks that join hold no current parameters
            st["params"] = tree_map(lambda x: W.broadcast(x, 0),
                                    st["params"])
        # every rank builds the group (collective), its members use it
        group = prefix_group(M, W.group)
        self._group_axis = None if group is None else DistAxis(group,
                                                               W.backend)
        if sync in ("ssp", "asp"):
            self._rebase_async(st, slots, grown, step)
            st["pulled"] = [st["params"]] * len(self._held)
            st["batch_cache"] = [None] * M
        self._wire_total = st["wire"]
        return st

    def _ef_like(self) -> List[torch.Tensor]:
        """Empty tensors shaped like one worker's EF row."""
        like = self._like()
        return [torch.empty(s, device=self.device)
                for s in self._layout(like).shapes(like)]

    def _rows(self, rows, gather: bool):
        """The snapshot's per-worker list from this process's rows (a
        tree each): every worker's on the logical axis; over a group,
        every worker's gathered to rank 0 (host tensors there) when
        ``gather``, else (and on the other ranks) the rank's own row with
        None for the others (a restore then reads this rank's rows
        only)."""
        if self._world is None:
            return rows
        M, me = self.cfg.num_workers, self._world.rank
        own = rows[0] if rows else None
        if gather and own is not None:
            got = tree_map(lambda x: self.axis.gather(x, 0), own)
            if me == 0:
                return [tree_map(lambda g: g[j], got) for j in range(M)]
        return [own if j == me else None for j in range(M)]

    def _export(self, st, gather: bool):
        sync = self.cfg.sync
        ef = st["ef"]
        arrays: Dict[str, Any] = {
            "ef": None if ef is None else self._rows(ef, gather)}
        if sync == "sma":
            arrays["replicas"] = self._rows(st["replicas"], gather)
        else:
            arrays["params"] = st["params"]
        if sync in ("ssp", "asp"):
            arrays["pulled"] = self._rows(st["pulled"], gather)
        return arrays, self._snapshot_meta("device", sync, st)

    def export_state(self, st) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Split the run-state into (tensor tree, JSON-able meta) for
        ``checkpoint.store``: the inverse of ``import_state``.  The batch
        cache is dropped (batches are a pure function of (batch index,
        worker)); ``ef`` is a list per worker of the reference's leaves,
        where the reference stacks a worker axis.  Over a group every
        rank calls it, and rank 0's is the whole snapshot (module
        docstring)."""
        return self._export(st, gather=True)

    def snapshot_template(self, st):
        """``export_state``'s tree without the gather: the structure a
        restore loads into (each row onto its stand-in's device)."""
        return self._export(st, gather=False)

    def import_state(self, arrays: Dict[str, Any], meta: Dict[str, Any]):
        """Rebuild the run-state from an ``export_state`` snapshot.  The
        engine must already be configured at ``meta['num_workers']``;
        over a group each rank keeps its own worker's rows."""
        sync = self.cfg.sync

        def dev(tree):
            return tree_map(lambda x: x.to(self.device), tree)

        held = self._held
        ef = arrays["ef"]
        st: Dict[str, Any] = dict(
            ef=None if ef is None else [dev(ef[w]) for w in held])
        self._load_snapshot_meta(meta, sync, st)
        if sync == "sma":
            st["replicas"] = [dev(arrays["replicas"][w]) for w in held]
        else:
            st["params"] = dev(arrays["params"])
        if sync in ("ssp", "asp"):
            st.update(pulled=[dev(arrays["pulled"][w]) for w in held],
                      batch_cache=[None] * self.cfg.num_workers)
        self._wire_total = st["wire"]
        return st

    def per_device_state_bytes(self, st) -> Dict[str, int]:
        """Persistent bytes per worker: plain SGD carries no optimizer
        state; params are replicated, EF residuals are per worker."""
        params_like = (st["replicas"][0] if self.cfg.sync == "sma"
                       else st["params"])
        params = _tree_bytes(params_like)
        ef = (sum(x.numel() * x.element_size() for e in st["ef"] for x in e)
              // len(st["ef"]) if st.get("ef") else 0)
        return {"params": params, "opt": 0, "ef": ef, "total": params}

    def run(self, params, batches: Callable[[int, int], Any], steps: int):
        """batches(t, worker) -> batch.  Returns (params, history,
        wire_bytes)."""
        st = self.init(params)
        hist: List[dict] = []
        for t in range(steps):
            st, ev = self.step(st, batches, t)
            hist.extend(ev)
        return self.finalize(st), hist, st["wire"]
