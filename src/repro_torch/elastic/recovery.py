"""Checkpoint-recovery and scheduler-driven resize for Strategy engines (the
JAX package's ``elastic/recovery.py``).

``fit_elastic`` is the elastic counterpart of ``train.strategy.fit``:
it drives any Strategy engine step by step while consuming an elastic
event plan (elastic/events.py).  Semantics, in the order events fire
(always *before* the step they are scheduled at):

  slow:wNxF   straggler: the engine's speed schedule scales worker N's
              period by F — changes the async firing schedule and the
              ``bsp+backup:k`` drop set (elastic/backup.py).
  resize:M@t  scheduler grant/revoke: the engine reshards N→M live, in
              process — no rollback.  Survivor workers keep their EF
              residuals and batch clocks; data streams are re-assigned
              through ``data/partition.stream_assignment``.  A
              post-reshard checkpoint is written immediately so a later
              crash never restores across a resize boundary.
  crash:wN@t  failure: the run rolls back to the latest committed
              checkpoint, reshards to the surviving K-1 workers (slot N
              dropped), and continues — work since the checkpoint is
              lost (counted in ``metrics["recoveries"]``), the process
              survives.
  restart@t   Gandiva-style suspend/resume: snapshot now, then restore —
              exercises the full save→load→import path with zero lost
              steps.

Engine state travels through ``checkpoint.store``: tensors (params, EF
residuals, per-worker pulled copies; no PRNG state, the port's generators
being pure in (seed, step, worker)) in the sharded npz store, bookkeeping
(worker count, tick/update counters, staleness clocks) in the manifest's
``extra`` blob.  Checkpoints are atomic (store.py), so a crash mid-save
leaves the previous checkpoint intact.  Leaves restore onto the device of
the engine's own state.

Over a ``torch.distributed`` process group (``fit_elastic(...,
group=)``) every rank reads the same plan and runs the same events in
the same order: a crash drops a worker from the active set (no process
is killed), a resize grows it back, and the engine moves the rows
(``DeviceEngine``).  Only the snapshot writer (rank 0) writes, from the
rows its engine gathered; every rank waits on a barrier until each
write is durable, so no rank rolls back to a snapshot another cannot
see yet, and every rank restores from the same files, keeping its own
rows.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.store import (is_valid_checkpoint,
                                          load_checkpoint, read_manifest,
                                          save_checkpoint)
from repro_torch.core.tree import tree_map
from repro_torch.data.partition import stream_assignment
from repro_torch.elastic.events import EventPlan, merge_plans
from repro_torch.obs.trace import get_recorder

_CKPT_FMT = "step_{:06d}"


# ------------------------------------------------------- engine snapshots
def save_engine_state(path: str, engine, state, step: int,
                      history_len: int = 0,
                      extra: Optional[Dict[str, Any]] = None,
                      incremental_from: Optional[str] = None,
                      shard_bytes: int = 512 * 1024 * 1024,
                      background: bool = False
                      ) -> Optional[threading.Thread]:
    """Atomically snapshot an engine's full run-state at ``step``.
    ``extra`` adds trainer-level bookkeeping (e.g. the consumed event
    record) to the manifest next to the engine's own meta.
    ``incremental_from`` enables hash-skip shard linking against a
    previous committed snapshot (checkpoint/store.py) — restores stay
    bitwise-identical.  Engine snapshots always carry content hashes so
    the *next* cadence save can link against this one even when this
    save is full (crash/preemption commits).

    ``background=True`` dispatches only the *file write* to a daemon
    thread and returns it for the caller to join; the device→host copy of
    every leaf still happens here, synchronously (the engines and
    optimizers may update their tensors in place), so the captured
    arrays are the state at call time no matter how far the training
    loop has advanced by the time the write lands.  Over a process group
    every rank calls it (the export gathers) and the engine's snapshot
    writer alone writes.  The snapshot does not count as
    committed until the returned thread is joined — atomicity
    (store.py's rename commit) guarantees a reader meanwhile sees either
    the previous checkpoint or nothing, never a torn one."""
    arrays, meta = engine.export_state(state)
    if not getattr(engine, "snapshot_writer", True):
        return None           # another rank of the group writes it
    meta = dict(meta, step=int(step), history_len=int(history_len),
                **(extra or {}))
    if background:
        arrays = tree_map(lambda x: x.detach().to("cpu", copy=True)
                          if isinstance(x, torch.Tensor) else x, arrays)

    def write():
        save_checkpoint(path, arrays, step=int(step), extra=meta,
                        incremental_from=incremental_from,
                        shard_bytes=shard_bytes, hash_leaves=True)

    if background:
        th = threading.Thread(target=write, name=f"ckpt-write-{step}",
                              daemon=True)
        th.start()
        return th
    write()
    return None


def restore_engine_state(path: str, engine, params_like
                         ) -> Tuple[Any, Dict[str, Any]]:
    """Load a snapshot back into ``engine`` (resharding it first if the
    snapshot was taken at a different worker count).  ``params_like``
    only provides the parameter tree *structure* for decoding; the
    leaves land on the device of the engine's state.  Returns (state,
    meta)."""
    meta = read_manifest(path)["extra"]
    # one throwaway init provides the tree structure; reshard it (not a
    # second init) when the snapshot was taken at a different size
    probe = engine.init(params_like)
    if meta["num_workers"] != _engine_workers(engine):
        probe = engine.reshard(probe, meta["num_workers"],
                               step=meta["step"])
    template, _ = getattr(engine, "snapshot_template",
                          engine.export_state)(probe)
    del probe
    arrays, _step = load_checkpoint(path, template)
    state = engine.import_state(arrays, meta)
    return state, meta


def _engine_workers(engine) -> int:
    inner = getattr(engine, "inner", engine)
    return inner.cfg.num_workers


def _engine_streams(engine) -> int:
    """Batch streams the engine consumes: the data-parallel slot count.
    For the flat engines that equals the worker count; the hybrid engine
    (``parallel.HybridEngine``) spreads its workers over tensor/stage axes
    too and exposes the data axis as ``data_streams``."""
    inner = getattr(engine, "inner", engine)
    return getattr(inner, "data_streams", inner.cfg.num_workers)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest committed (manifest-bearing) step_* checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if name.startswith("step_") and is_valid_checkpoint(full):
            try:
                step = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if best is None or step > best[0]:
                best = (step, full)
    return best[1] if best else None


# --------------------------------------------------------- elastic batches
class ElasticBatches:
    """Worker→stream indirection for resizable jobs.

    The user's ``batches(t, s)`` is keyed by a *logical stream* s in
    [0, n_streams); each worker slot covers an ordered list of streams
    through ``data/partition.stream_assignment`` (identity at nominal
    size, so an unresized run sees exactly the original batches) and
    rotates through its list by step — after a shrink the M workers keep
    covering all N streams instead of starving N−M of them.  The map is
    recomputed deterministically at every resize."""

    def __init__(self, batches: Callable[[int, int], Any], n_streams: int,
                 seed: int = 0):
        self.batches = batches
        self.n_streams = n_streams
        self.seed = seed
        self.assignment = stream_assignment(n_streams, n_streams, seed)

    def assign(self, num_workers: int) -> List[List[int]]:
        self.assignment = stream_assignment(self.n_streams, num_workers,
                                            self.seed)
        return self.assignment

    def __call__(self, t: int, worker: int):
        streams = self.assignment[worker]
        return self.batches(t, streams[t % len(streams)])


# ------------------------------------------------------------ the trainer
def fit_elastic(strategy, grad_fn: Callable, params,
                batches: Callable[[int, int], Any], steps: int, plan,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 5, layout=None, device="cuda",
                resume: bool = False,
                preempt_signals: Optional[Tuple[int, ...]] = None,
                group=None):
    """Drive ``strategy``'s engine for ``steps`` global steps under an
    elastic event plan.  Returns (params, history, metrics) like
    ``Trainer.fit``; metrics additionally carry ``recoveries`` (one
    record per crash/restart), ``resizes``, ``executed_steps`` (includes
    work redone after rollbacks), ``final_workers`` and
    ``dropped_updates``.

    Real preemption: when a ``checkpoint_dir`` is given, a handler for
    ``preempt_signals`` (default: SIGTERM, main thread only) is installed
    for the duration of the run.  On delivery the loop finishes its
    in-flight step, commits a snapshot, and returns cleanly with
    ``metrics["preempted"] = True`` — the process exits 0 instead of
    dying with work lost.  A follow-up invocation with ``resume=True``
    restores the newest committed checkpoint in ``checkpoint_dir``
    (reporting ``metrics["resumed_from"]``) and finishes the remaining
    steps; plan events scheduled before the resume point are treated as
    already fired.  ``layout``, ``device`` and ``group`` are
    ``Strategy.build``'s (module docstring for a process group)."""
    if isinstance(plan, str):
        plan = EventPlan.parse(plan)
    elif not isinstance(plan, EventPlan):
        plan = merge_plans(plan)
    if plan.needs_checkpoints and checkpoint_dir is None:
        raise ValueError("plan contains crash/restart events; "
                         "fit_elastic needs a checkpoint_dir to recover "
                         "from")
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    engine = strategy.build(grad_fn, layout, device, group)
    eb = ElasticBatches(batches, n_streams=_engine_streams(engine),
                        seed=strategy.seed)
    run = plan.start()
    st = engine.init(params)
    ckpt = (lambda step: os.path.join(checkpoint_dir,
                                      _CKPT_FMT.format(step))) \
        if checkpoint_dir else None

    history: List[dict] = []
    recoveries: List[dict] = []
    resizes = 0
    executed = 0
    # recovery only ever restores checkpoints THIS run committed —
    # a reused checkpoint_dir with stale step_* dirs from an earlier
    # run must not leak foreign state into this one (resume=True is the
    # explicit opt-in for picking up a previous incarnation's snapshot)
    written: set = set()

    rec = get_recorder()

    # at most one snapshot write in flight: cadence saves dispatch the
    # file write to a background thread so the next train step overlaps
    # the disk I/O, and every consumer of "the newest committed
    # checkpoint" — a later commit (incremental links need the previous
    # snapshot durable), crash/restart recovery, and run exit — joins it
    # first
    pending_writes: List[threading.Thread] = []

    def join_writes():
        while pending_writes:
            pending_writes.pop().join()
        if group is not None:
            # the writer's snapshot is durable before any rank goes on
            import torch.distributed as dist
            dist.barrier(group=group)

    def commit(step: int, state, hist_len: int, full: bool = False,
               background: bool = False):
        # every snapshot records which plan events have already fired:
        # "fired" is not derivable from the step alone (a crash rollback
        # commits *earlier* than the crash it consumed), and a resumed
        # incarnation must not re-fire any of them.
        # Periodic cadence saves are incremental (unchanged shards are
        # hash-skipped against the newest committed snapshot); crash
        # rollback and preemption commits stay full saves.
        join_writes()
        prev = ckpt(max(written)) if (written and not full) else None
        # the span measures what the training loop actually pays: for a
        # background commit that is the device→host export + dispatch,
        # not the write itself (dispatch="async" marks those records)
        with rec.span("snapshot", pid="elastic", tid="events", cat="elastic",
                      clock=("train_step", step), step=step,
                      mode="full" if prev is None else "incremental",
                      dispatch="async" if background else "sync"):
            th = save_engine_state(ckpt(step), engine, state, step, hist_len,
                                   extra={"consumed": run.consumed_specs()},
                                   incremental_from=prev,
                                   background=background)
        if th is not None:
            pending_writes.append(th)
        if not background:
            join_writes()      # under a group: the barrier after the write
        written.add(step)

    t = 0
    resumed_from = None
    if resume:
        if not ckpt:
            raise ValueError("resume=True needs a checkpoint_dir")
        path = latest_checkpoint(checkpoint_dir)
        if path is not None:
            st, meta = restore_engine_state(path, engine, params)
            t = resumed_from = int(meta["step"])
            eb.assign(_engine_streams(engine))
            # replay the previous incarnation's consumption record so
            # nothing it lived through fires twice
            run.mark_consumed(meta.get("consumed", ()))
            # re-commit under THIS incarnation's frame: the restored
            # checkpoint's history_len counts the previous incarnation's
            # (unavailable) history, and a later rollback truncating our
            # history with it would duplicate steps in the returned
            # record
            commit(t, st, 0)
    if ckpt and not written:
        commit(t, st, 0)

    # SIGTERM-driven preemption snapshot: flag only in the handler, act
    # at the loop boundary so the in-flight step completes first
    preempted: List[int] = []
    installed: List[Tuple[int, Any]] = []
    # (per process: under a group one rank's signal would leave the
    # others waiting in the next collective, so none is installed there)
    if ckpt and group is None and \
            threading.current_thread() is threading.main_thread():
        sigs = ((signal.SIGTERM,) if preempt_signals is None
                else preempt_signals)
        for sig in sigs:
            installed.append((sig, signal.signal(
                sig, lambda signum, frame: preempted.append(signum))))

    try:
        while t < steps:
            if preempted:
                commit(t, st, len(history), full=True)
                break
            rolled_back = False
            # one event at a time: a crash rollback leaves the rest of the
            # due batch pending, to fire when the run reaches them again
            while (ev := run.take_one(t)) is not None:
                if ev.kind == "slow":
                    rec.instant("straggler", pid="elastic", tid="events",
                                cat="elastic", clock=("train_step", t),
                                worker=ev.worker, factor=ev.factor)
                    engine.set_slowdown(ev.worker, ev.factor)
                    if ckpt:
                        # commit so a later crash rollback (which restores
                        # pre-event slowdowns and never re-fires consumed
                        # events) cannot erase the straggler
                        commit(t, st, len(history))
                elif ev.kind == "resize":
                    with rec.span("resize", pid="elastic", tid="events",
                                  cat="elastic", clock=("train_step", t),
                                  from_workers=_engine_workers(engine),
                                  to_workers=ev.workers):
                        st = engine.reshard(st, ev.workers, step=t)
                        eb.assign(_engine_streams(engine))
                    resizes += 1
                    if ckpt:
                        # commit the post-reshard state so a later crash
                        # never restores across the resize boundary
                        commit(t, st, len(history))
                elif ev.kind in ("crash", "restart"):
                    # an in-flight cadence write may BE the newest
                    # committed snapshot — recovery must not race it
                    join_writes()
                    t0 = time.time()
                    # explicit begin/end (not a ``with``): the error paths
                    # below abort the run anyway, and a truncated trace is
                    # the honest record of a failed recovery
                    rec.begin("recovery", pid="elastic", tid="events",
                              cat="elastic", clock=("train_step", t),
                              kind=ev.kind,
                              worker=(ev.worker if ev.kind == "crash"
                                      else None))
                    if ev.kind == "restart":
                        # scheduler suspend: snapshot the live state first
                        # (full save — recovery must not depend on links)
                        commit(t, st, len(history), full=True)
                    if not written:
                        raise RuntimeError(
                            f"no checkpoint committed by this run in "
                            f"{checkpoint_dir!r} to recover from at step "
                            f"{t}")
                    path = ckpt(max(written))
                    if not is_valid_checkpoint(path):
                        raise RuntimeError(
                            f"checkpoint {path!r} is gone or torn; cannot "
                            f"recover at step {t}")
                    st = None      # the live state goes before the restore
                    st, meta = restore_engine_state(path, engine, params)
                    rstep = int(meta["step"])
                    history = history[:int(meta["history_len"])]
                    # checkpoints from the abandoned timeline (steps
                    # beyond the restore point) must not satisfy a later
                    # recovery
                    written = {s for s in written if s <= rstep}
                    if ev.kind == "crash":
                        # a flat engine loses one worker; a hybrid mesh
                        # loses the dead device's whole tensor*stage
                        # block (one data replica) — the engine knows
                        # (``parallel.HybridEngine.crash_plan``)
                        inner = getattr(engine, "inner", engine)
                        if hasattr(inner, "crash_plan"):
                            survivors, lost = inner.crash_plan(ev.worker)
                        else:
                            survivors = _engine_workers(engine) - 1
                            lost = (ev.worker,)
                        st = engine.reshard(st, survivors, step=rstep,
                                            lost=lost)
                        eb.assign(_engine_streams(engine))
                        commit(rstep, st, len(history), full=True)
                    rec.end(pid="elastic", tid="events",
                            restored_step=rstep, lost_steps=t - rstep,
                            workers=_engine_workers(engine))
                    recoveries.append(dict(
                        kind=ev.kind, at=t, restored_step=rstep,
                        lost_steps=t - rstep,
                        lost_worker=ev.worker if ev.kind == "crash"
                        else None,
                        workers=_engine_workers(engine),
                        wall_s=time.time() - t0))
                    t = rstep
                    rolled_back = True
                    break
            if rolled_back:
                continue
            if ckpt and t > 0 and t % checkpoint_every == 0:
                commit(t, st, len(history), background=True)
            if rec.enabled:
                # same step track as train_loop (fit_elastic drives the
                # engine directly), so engine sub-spans nest identically
                with rec.span("step", pid="train", tid="loop", cat="train",
                              clock=("train_step", t), step=t,
                              workers=_engine_workers(engine)):
                    st, evs = engine.step(st, eb, t)
            else:
                st, evs = engine.step(st, eb, t)
            history.extend(evs)
            executed += 1
            t += 1
            if executed > steps * 10 + 100:
                raise RuntimeError("elastic run not converging on its "
                                   "step target (runaway rollback loop?)")
    finally:
        # the run is not over until its last snapshot is durable
        join_writes()
        for sig, old in installed:
            signal.signal(sig, old)

    mets = engine.metrics()
    mets.update(recoveries=recoveries, resizes=resizes,
                executed_steps=executed, wasted_steps=executed - steps,
                final_workers=_engine_workers(engine),
                preempted=bool(preempted), preempt_step=(t if preempted
                                                         else None),
                resumed_from=resumed_from)
    return engine.finalize(st), history, mets
