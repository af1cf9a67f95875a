"""Parameter-synchronization models from survey §3.3.2 / Table 1 (the JAX
package's ``core/sync.py``): BSP (synchronous), SSP (bounded-asynchronous,
Cipar et al. [28]), ASP (asynchronous, Hogwild/Downpour [149, 38]) and SMA
(CROSSBOW's synchronous model averaging [89]).

Asynchrony is a deterministic discrete-event simulation: K logical workers
with heterogeneous speeds push gradients computed against the parameter
version they last pulled, and every backend replays the one schedule
``firing_schedule`` gives.  ``SimSyncEngine`` is that simulation, as
``init / step / finalize`` so the Strategy front end drives it one global
step at a time; ``run`` composes them.

Gradients are compressed per worker with the JAX package's leaf list
(``core.tree.LeafLayout``) and the worker's error-feedback residuals.
The stochastic methods draw from a ``torch.Generator`` seeded per event
(``event_generator``), which the device engine seeds the same way; the
JAX package splits one PRNG key per event, so only the deterministic
methods (``none``, ``onebit``, ``dgc``) are draw for draw comparable with
the reference.

Every engine (this simulator and the device engine) inherits
``ElasticWorkerSet``: straggler slowdowns, the ``bsp+backup:k`` drop set
(scheduled, or measured by ``elastic.detector.StepTimeEMA`` with
``detect``) and the worker-schedule half of ``reshard`` and of the
snapshots.  Engine snapshots (``export_state``) hold no PRNG state: the
port's generators are pure in (seed, step or event, worker), where the
reference snapshots its JAX key, so an engine snapshot of one package
does not load into the other.  The deprecated ``SyncEngine`` alias is not
ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import Compressor
from repro_torch.core.tree import LeafLayout, tree_map
from repro_torch.elastic.backup import drop_set
from repro_torch.elastic.detector import StepTimeEMA

SYNCS = ("bsp", "ssp", "asp", "sma")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "bsp"            # bsp | ssp | asp | sma
    num_workers: int = 4
    staleness: int = 3           # SSP bound s
    lr: float = 0.1
    sma_mu: float = 0.1          # SMA correction strength
    # deterministic worker speeds: worker i finishes every periods[i] ticks
    periods: Optional[Tuple[int, ...]] = None
    compressor: Compressor = Compressor("none")
    backup: int = 0              # BSP backup workers: drop the k slowest
    # measured straggler detection: per-worker step-time EMA replaces the
    # scheduled ranking in the backup drop set (elastic/detector.py)
    detect: bool = False
    seed: int = 0


def default_periods(num_workers: int) -> Tuple[int, ...]:
    """Heterogeneous-by-default deterministic worker speeds (worker i
    finishes every i+1 ticks): the one schedule both the simulator and the
    device backend replay."""
    return tuple(1 + i for i in range(num_workers))


def firing_schedule(tick: int, periods: Tuple[int, ...],
                    batch_idx: List[int],
                    bound: Optional[int]) -> List[int]:
    """Workers firing at this tick, in event order: worker w fires every
    ``periods[w]`` ticks unless (SSP) its batch clock is more than
    ``bound`` ahead of the slowest worker's (``bound=None`` = ASP).
    Intra-tick clock increments are visible to later workers' bound
    checks, exactly as the events apply."""
    firing = []
    scratch = list(batch_idx)
    for w, p in enumerate(periods):
        if tick % p:
            continue
        if bound is not None and scratch[w] - min(scratch) > bound:
            continue  # SSP: fast worker blocks on clock bound
        firing.append(w)
        scratch[w] += 1
    return firing


def event_generator(seed: int, t: int, worker: int,
                    device) -> torch.Generator:
    """The generator of worker ``worker``'s compression at step or event
    ``t``: the same draws on every backend of the port."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + t) * 31 + worker)


class ElasticWorkerSet:
    """The worker-schedule surface every engine inherits: straggler
    slowdowns over the base ``periods``, the backup-drop accounting and
    measured straggler detection, so the effective schedule (the async
    firing order and the backup drop set) cannot differ between the
    backends.  Subclass ``__init__`` sets ``self.cfg`` (with
    ``num_workers``, ``periods`` and ``backup`` fields), ``self.periods``,
    ``self.slowdowns`` (per worker period factors, 1.0 = none) and
    ``self._dropped``, and calls ``_init_detector``."""

    periods: Tuple[int, ...]
    slowdowns: List[float]
    _dropped: int
    detector: Optional[StepTimeEMA]

    def _init_detector(self, detect: bool, num_workers: int):
        self.detector = StepTimeEMA(num_workers) if detect else None

    def set_slowdown(self, worker: int, factor: float):
        """Apply a straggler event: worker's period scales by ``factor``
        (1.0 clears).  Affects the async firing schedule and the backup
        drop set."""
        self.slowdowns[worker] = factor

    def effective_periods(self) -> Tuple[int, ...]:
        """Base periods with active slowdowns folded in (min 1 tick): the
        schedule both the firing loop and the backup drop set use."""
        return tuple(max(1, int(round(p * s)))
                     for p, s in zip(self.periods, self.slowdowns))

    def backup_drop(self, k: int):
        """The round's backup drop set: the *measured* step-time ranking
        once detection has warmed up, else the scheduled ranking
        (``elastic.backup.drop_set``), the same rule on both backends."""
        if self.detector is not None and self.detector.ready:
            return self.detector.drop_set(k)
        return drop_set(self.periods, k, self.slowdowns)

    def dropped_updates(self) -> int:
        """Gradient pushes discarded by the backup-worker policy."""
        return self._dropped

    def extra_metrics(self) -> dict:
        """Backend-specific additions to ``Engine.metrics()``; the
        simulator has none."""
        return {}

    # ------------------------------------------- elastic reshard / snapshot
    def _reshard_workers(self, new_workers: int,
                         lost: Tuple[int, ...]) -> Tuple[List[int], int]:
        """The schedule half of ``reshard``: validate the N->M resize,
        remap ``cfg``, ``periods``, ``slowdowns`` and the detector onto the
        survivor slots (old slots minus ``lost``, in order; they keep their
        speed identity, grown slots take the default-schedule tail) and
        return ``(slots, grown)``."""
        cfg = self.cfg
        if new_workers < 1:
            raise ValueError("new_workers must be >= 1")
        if cfg.backup >= new_workers:
            raise ValueError(f"backup k={cfg.backup} needs > k workers")
        bad = [w for w in lost if w < 0 or w >= cfg.num_workers]
        if bad:
            raise ValueError(f"lost workers {bad} out of range for "
                             f"{cfg.num_workers} workers")
        survivors = [w for w in range(cfg.num_workers) if w not in set(lost)]
        slots = survivors[:new_workers]
        grown = new_workers - len(slots)
        periods = tuple([self.periods[s] for s in slots]
                        + list(default_periods(new_workers))[len(slots):])
        self.cfg = dataclasses.replace(cfg, num_workers=new_workers,
                                       periods=periods)
        self.periods = periods
        self.slowdowns = [self.slowdowns[s] for s in slots] + [1.0] * grown
        if self.detector is not None:
            self.detector.reshard(slots, new_workers)
        return slots, grown

    @staticmethod
    def _rebase_async(st, slots: List[int], grown: int, step: int) -> None:
        """ssp/asp at a reshard, a synchronization barrier: every worker
        re-pulls the current parameters at the current server version,
        survivors keep their batch clocks, grown slots start at the
        frontier, and the step<->update accounting rebases at ``step`` so
        one global step stays M updates."""
        M = len(slots) + grown
        frontier = max([st["batch_idx"][s] for s in slots] or [0])
        st["pulled"] = [st["params"]] * M
        st["pulled_ver"] = [st["server_ver"]] * M
        st["batch_idx"] = ([st["batch_idx"][s] for s in slots]
                           + [frontier] * grown)
        st["updates_base"] = st["updates"]
        st["step_base"] = step

    def _snapshot_meta(self, backend: str, mode: str, st) -> Dict[str, Any]:
        """The JSON-able half of ``export_state``: the reference's meta
        keys."""
        meta: Dict[str, Any] = dict(
            backend=backend, mode=mode, num_workers=self.cfg.num_workers,
            wire=int(st["wire"]), periods=list(self.periods),
            slowdowns=list(self.slowdowns), dropped=self._dropped,
            detector=(self.detector.state() if self.detector is not None
                      else None))
        if mode in ("ssp", "asp"):
            meta.update(pulled_ver=list(st["pulled_ver"]),
                        server_ver=int(st["server_ver"]),
                        tick=int(st["tick"]), updates=int(st["updates"]),
                        batch_idx=list(st["batch_idx"]),
                        updates_base=int(st["updates_base"]),
                        step_base=int(st["step_base"]))
        return meta

    def _load_snapshot_meta(self, meta: Dict[str, Any], mode: str,
                            st: Dict[str, Any]) -> None:
        """The schedule and bookkeeping of ``import_state``: the speed
        schedule travels with the snapshot (a resharded run's remapped
        periods survive a restore in another process)."""
        if meta["num_workers"] != self.cfg.num_workers:
            raise ValueError(
                f"snapshot has {meta['num_workers']} workers, engine has "
                f"{self.cfg.num_workers}; reshard the engine first")
        self.periods = tuple(int(p) for p in meta["periods"])
        self.cfg = dataclasses.replace(self.cfg, periods=self.periods)
        self.slowdowns = [float(s) for s in meta["slowdowns"]]
        self._dropped = int(meta["dropped"])
        if self.detector is not None:
            self.detector.load_state(meta.get("detector"))
        st["wire"] = int(meta["wire"])
        if mode in ("ssp", "asp"):
            st.update(pulled_ver=list(meta["pulled_ver"]),
                      server_ver=int(meta["server_ver"]),
                      tick=int(meta["tick"]), updates=int(meta["updates"]),
                      batch_idx=list(meta["batch_idx"]),
                      updates_base=int(meta["updates_base"]),
                      step_base=int(meta["step_base"]))


class SimSyncEngine(ElasticWorkerSet):
    """Drives ``grad_fn(params, batch) -> (loss, grads)`` under a
    synchronization model over a stream of per-worker batches.

    One *global step* is K updates' worth of progress: a full round for
    BSP/SMA, and for SSP/ASP as many whole ticks as it takes for the
    update counter to cross the next multiple of K.  ``layout`` maps the
    gradient tree onto the reference's leaves (``LeafLayout.of_tree`` of
    the parameters when not given)."""

    def __init__(self, cfg: SyncConfig, grad_fn: Callable,
                 layout: Optional[LeafLayout] = None, device="cuda"):
        if cfg.mode not in SYNCS:
            raise ValueError(f"mode={cfg.mode!r} not in {SYNCS}")
        if cfg.backup and cfg.mode != "bsp":
            raise ValueError("backup workers compose with bsp only "
                             "(async modes have no round to drop from)")
        if cfg.backup >= cfg.num_workers:
            raise ValueError("backup k must leave at least one worker")
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.layout = layout
        self.device = torch.device(device)
        periods = cfg.periods or default_periods(cfg.num_workers)
        if len(periods) != cfg.num_workers:
            raise ValueError("periods must name every worker")
        self.periods = periods
        self.slowdowns: List[float] = [1.0] * cfg.num_workers
        self._dropped = 0
        self._init_detector(cfg.detect, cfg.num_workers)
        self._wire = 0

    def _layout(self, params) -> LeafLayout:
        if self.layout is None:
            self.layout = LeafLayout.of_tree(params)
        return self.layout

    def _compress(self, st, w: int, grads, t: int):
        """Worker w's gradient tree -> its decompressed leaves, with its EF
        state renewed and the push's wire bytes counted."""
        comp = self.cfg.compressor
        leaves = self._layout(grads).leaves(grads, consume=True)
        gen = (event_generator(self.cfg.seed, t, w, self.device)
               if comp.needs_rng else None)
        out, st["comp_states"][w], wb = comp.roundtrip(
            leaves, st["comp_states"][w], gen)
        st["wire"] += wb
        return out

    def _apply(self, params, leaves):
        lr = self.cfg.lr
        return self._layout(params).update(params, leaves,
                                           lambda p, g: p - lr * g)

    # ----------------------------------------------------------- init state
    def init(self, params) -> Dict[str, Any]:
        cfg = self.cfg
        K = cfg.num_workers
        params = tree_map(lambda x: x.to(self.device), params)
        layout = self._layout(params)
        st: Dict[str, Any] = dict(
            comp_states=[cfg.compressor.init_state(layout.leaves(params))
                         for _ in range(K)],
            wire=0)
        if cfg.mode == "bsp":
            st.update(params=params)
        elif cfg.mode in ("ssp", "asp"):
            st.update(
                params=params,
                pulled=[params] * K,      # reference rebinds, not copies
                pulled_ver=[0] * K,
                server_ver=0,
                tick=0,
                updates=0,
                batch_idx=[0] * K,
                updates_base=0,
                step_base=0)
        else:
            st.update(replicas=[params] * K)
        return st

    # ------------------------------------------------------------------ BSP
    def _step_bsp(self, st, batches, t):
        K = self.cfg.num_workers
        params = st["params"]
        # backup workers: the k slowest (scheduled, or measured once
        # detection has warmed up) never reach the server this round:
        # their batch is discarded and their EF state is untouched
        drop = self.backup_drop(self.cfg.backup)
        losses, acc = [], None
        for w in range(K):
            t0 = time.perf_counter()
            if w in drop:
                if self.detector is not None:
                    # a real straggler still runs, so keep measuring it
                    # (a recovered worker must not stay dropped forever)
                    self.grad_fn(params, batches(t, w))
                    self.detector.observe(w, time.perf_counter() - t0)
                continue
            loss, g = self.grad_fn(params, batches(t, w))
            if self.detector is not None:
                self.detector.observe(w, time.perf_counter() - t0)
            leaves = self._compress(st, w, g, t)
            del g
            losses.append(float(loss))
            # the reference's sum(grads) / K, in worker order
            if acc is None:
                acc = list(leaves)
            else:
                for a, x in zip(acc, leaves):
                    a += x
            del leaves
        self._dropped += len(drop)
        n = K - len(drop)
        st["params"] = self._apply(params, [a / n for a in acc])
        ev = dict(step=t, loss=float(np.mean(losses)), max_staleness=0)
        if drop:
            ev["dropped"] = sorted(drop)
        return st, [ev]

    # ------------------------------------------------------- SSP / ASP core
    def _step_async(self, st, batches, t, bound: Optional[int]):
        """Event simulation: server clock = #updates applied.  Worker w
        recomputes every periods[w] ticks against its pulled version; SSP
        blocks a worker whose clock runs more than ``bound`` ahead of the
        slowest.  Advances whole ticks until ``updates >= (t+1) * K``."""
        K = self.cfg.num_workers
        events = []
        eff_periods = self.effective_periods()   # invariant within a step
        while st["updates"] - st["updates_base"] < \
                (t + 1 - st["step_base"]) * K:
            st["tick"] += 1
            for w in firing_schedule(st["tick"], eff_periods,
                                     st["batch_idx"], bound):
                loss, g = self.grad_fn(st["pulled"][w],
                                       batches(st["batch_idx"][w], w))
                st["batch_idx"][w] += 1
                leaves = self._compress(st, w, g, st["updates"])
                del g
                staleness = st["server_ver"] - st["pulled_ver"][w]
                st["params"] = self._apply(st["params"], leaves)
                del leaves
                st["server_ver"] += 1
                st["updates"] += 1
                st["pulled"][w] = st["params"]   # pull fresh copy after push
                st["pulled_ver"][w] = st["server_ver"]
                events.append(dict(step=st["updates"], loss=float(loss),
                                   max_staleness=staleness, worker=w))
        return st, events

    # ------------------------------------------------------------------ SMA
    def _avg(self, trees):
        K = len(trees)
        return tree_map(lambda *xs: sum(xs) / K, *trees)

    def _step_sma(self, st, batches, t):
        """CROSSBOW synchronous model averaging: independent replicas
        pulled toward the central average each step."""
        cfg = self.cfg
        lr, mu = cfg.lr, cfg.sma_mu
        center = self._avg(st["replicas"])
        losses = []
        for w in range(cfg.num_workers):
            r = st["replicas"][w]
            loss, g = self.grad_fn(r, batches(t, w))
            st["replicas"][w] = tree_map(
                lambda rr, zz, gg: rr - lr * gg - mu * (rr - zz),
                r, center, g)
            losses.append(float(loss))
            st["wire"] += sum(4 * int(np.prod(s))
                              for s in self._layout(r).shapes(r))
            del r, g
        return st, [dict(step=t, loss=float(np.mean(losses)),
                         max_staleness=0)]

    # ----------------------------------------------------------------- step
    def step(self, st, batches: Callable[[int, int], Any], t: int):
        """Advance one global step.  Returns (state, events): the per-update
        history records of this step."""
        mode = self.cfg.mode
        if mode == "bsp":
            st, ev = self._step_bsp(st, batches, t)
        elif mode == "ssp":
            st, ev = self._step_async(st, batches, t, self.cfg.staleness)
        elif mode == "asp":
            st, ev = self._step_async(st, batches, t, None)
        else:
            st, ev = self._step_sma(st, batches, t)
        self._wire = st["wire"]
        return st, ev

    def finalize(self, st):
        """Final parameters for the run-state (SMA: replica average)."""
        if self.cfg.mode == "sma":
            return self._avg(st["replicas"])
        return st["params"]

    def wire_bytes(self) -> int:
        return self._wire

    # ------------------------------------------- elastic reshard / snapshot
    def reshard(self, st, new_workers: int, step: int = 0,
                lost: Tuple[int, ...] = ()):
        """Re-size the simulated worker set N->M in place and return the
        resharded run-state.  Survivors (old slots minus ``lost``, in
        order) keep their EF state and batch clocks; grown slots start
        with zero residuals at the batch frontier (ssp/asp) or at the
        pre-reshard center (sma)."""
        mode = self.cfg.mode
        params_like = st["replicas"][0] if mode == "sma" else st["params"]
        slots, grown = self._reshard_workers(new_workers, lost)
        st["comp_states"] = (
            [st["comp_states"][s] for s in slots]
            + [self.cfg.compressor.init_state(
                self._layout(params_like).leaves(params_like))
               for _ in range(grown)])
        if mode in ("ssp", "asp"):
            self._rebase_async(st, slots, grown, step)
        elif mode == "sma":
            center = self._avg(st["replicas"])
            st["replicas"] = ([st["replicas"][s] for s in slots]
                              + [center] * grown)
        return st

    def export_state(self, st) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Split the run-state into (tensor tree, JSON-able meta) for
        ``checkpoint.store``: the inverse of ``import_state``."""
        mode = self.cfg.mode
        arrays: Dict[str, Any] = {"comp_states": st["comp_states"]}
        if mode == "sma":
            arrays["replicas"] = st["replicas"]
        else:
            arrays["params"] = st["params"]
        if mode in ("ssp", "asp"):
            arrays["pulled"] = st["pulled"]
        return arrays, self._snapshot_meta("sim", mode, st)

    def import_state(self, arrays: Dict[str, Any], meta: Dict[str, Any]):
        """Rebuild the run-state from an ``export_state`` snapshot.  The
        engine must already be configured at ``meta['num_workers']``."""
        mode = self.cfg.mode
        st: Dict[str, Any] = dict(comp_states=arrays["comp_states"])
        self._load_snapshot_meta(meta, mode, st)
        if mode == "sma":
            st["replicas"] = arrays["replicas"]
        else:
            st["params"] = arrays["params"]
        if mode in ("ssp", "asp"):
            st["pulled"] = arrays["pulled"]
        self._wire = st["wire"]
        return st

    def run(self, params, batches: Callable[[int, int], Any], steps: int):
        """batches(t, worker) -> batch.  Returns (params, history,
        wire_bytes)."""
        st = self.init(params)
        hist: List[dict] = []
        for t in range(steps):
            st, ev = self.step(st, batches, t)
            hist.extend(ev)
        return self.finalize(st), hist, st["wire"]
