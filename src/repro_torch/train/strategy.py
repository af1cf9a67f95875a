"""One declarative ``Strategy`` surface for the survey's §3.3 cross-product
(the JAX package's ``train/strategy.py``):

    Strategy.parse("ssp:3/ps/onebit@8", lr=0.01).build(grad_fn)
    Trainer(Strategy(...)).fit(grad_fn, params, batches, steps)

A spec is ``sync[:staleness]/arch/comp[:density]@workers``; a topology
name in the arch slot means allreduce over that schedule.
``registered_cells()`` lists the reference's 33 cells, and the port runs
every one on its backend:

  sim     ``core.sync.SimSyncEngine``, the deterministic discrete-event
          simulation: any sync model, any compressor.  Architecture is
          transparent there (the simulated server is the PS).
  device  ``train.data_parallel.DeviceEngine``: K logical workers on one
          device, every sync model and both architectures.

``backend="auto"`` resolves to ``device``: the port's workers are logical,
so one card holds any worker count (the reference falls back to ``sim``
when the process has fewer devices than workers).  ``wire="measured"``
needs the device backend.  ``bsp+backup:k`` drops the k slowest workers
each round, ``+detect`` ranks them by measured step times, and
``Trainer.fit(plan=...)`` runs under an elastic event plan
(``elastic.recovery.fit_elastic``).  Hybrid mesh suffixes (``@8:d2.t2``)
parse and raise (ROADMAP queue A item 6).

``kernel_backend`` is the port's seam (``auto``: the CUDA kernels for
CUDA tensors, the plain versions for CPU tensors; ``kernel``; ``ref``),
and no environment variable changes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

from repro_torch.comm.plan import WIRE_MODES
from repro_torch.core.allreduce import TOPOLOGIES
from repro_torch.core.compression import EF_METHODS, METHODS, Compressor
from repro_torch.core.sync import SimSyncEngine, SyncConfig
from repro_torch.core.tree import LeafLayout
from repro_torch.kernels.backend import KERNEL_BACKENDS
from repro_torch.train.data_parallel import (ARCHS, DataParallelConfig,
                                             DeviceEngine)
from repro_torch.train.train_loop import train_loop

SYNCS = ("bsp", "ssp", "asp", "sma")
# the reference's acceptance rows (sma is registered separately)
MATRIX_SYNCS = ("bsp", "ssp", "asp")
# the tested compression columns: the EF methods plus the baseline
MATRIX_METHODS = ("none",) + EF_METHODS
_DENSITY_DEFAULT = 0.01


class Cell(NamedTuple):
    """One point of the sync × arch × compression matrix on a backend."""
    sync: str
    arch: str
    compression: str
    backend: str


def registered_cells() -> List[Cell]:
    """Every supported Strategy cell: the reference's registry, cell for
    cell."""
    cells: List[Cell] = []
    # device: the full EF matrix, plus the stateless quantizers under BSP
    for s in MATRIX_SYNCS:
        for a in ARCHS:
            for c in MATRIX_METHODS:
                cells.append(Cell(s, a, c, "device"))
    for c in ("terngrad", "qsgd"):
        for a in ARCHS:
            cells.append(Cell("bsp", a, c, "device"))
    # sim: the staleness replay's source of truth, and SMA on both
    for s in MATRIX_SYNCS:
        for c in MATRIX_METHODS:
            cells.append(Cell(s, "allreduce", c, "sim"))
    cells.append(Cell("sma", "allreduce", "none", "sim"))
    cells.append(Cell("sma", "allreduce", "none", "device"))
    return cells


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Frozen declarative spec for one cell of the survey's taxonomy.

    ``compression`` may be a method name (a ``Compressor`` is derived with
    ``density`` and ``kernel_backend``) or a fully configured
    ``Compressor``."""
    sync: str = "bsp"
    arch: str = "allreduce"
    compression: Union[str, Compressor] = "none"
    workers: int = 4
    backend: str = "auto"            # auto | sim | device
    kernel_backend: str = "auto"     # auto | kernel | ref
    staleness: int = 3               # SSP bound s
    backup: int = 0                  # BSP backup workers
    lr: float = 0.1
    topology: str = "ring"           # allreduce schedule
    bucket_mb: float = 4.0           # gradient bucket fusion
    order: str = "tictac"            # bucket issue order
    periods: Optional[Tuple[int, ...]] = None   # worker speeds
    sma_mu: float = 0.1              # SMA correction strength
    density: float = _DENSITY_DEFAULT   # dgc density (compression as str)
    seed: int = 0
    detect: bool = False             # measured straggler detection (bsp)
    wire: str = "modeled"            # modeled | measured

    def __post_init__(self):
        if self.sync not in SYNCS:
            raise ValueError(f"sync={self.sync!r} not in {SYNCS}")
        if self.arch not in ARCHS:
            raise ValueError(f"arch={self.arch!r} not in {ARCHS}")
        method = (self.compression.method
                  if isinstance(self.compression, Compressor)
                  else self.compression)
        if method not in METHODS:
            raise ValueError(f"compression={method!r} not in {METHODS}")
        if self.backend not in ("auto", "sim", "device"):
            raise ValueError(f"backend={self.backend!r}")
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(f"kernel_backend={self.kernel_backend!r} not "
                             f"in {KERNEL_BACKENDS}")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.staleness < 0:
            raise ValueError("staleness must be >= 0")
        if self.backup < 0:
            raise ValueError("backup must be >= 0")
        if self.backup and self.sync != "bsp":
            raise ValueError("backup workers compose with bsp only")
        if self.backup >= self.workers:
            raise ValueError("backup k must leave at least one worker")
        if self.sync == "sma" and method != "none":
            raise ValueError("sma does not compose with compression; "
                             "use compression='none'")
        if self.sync == "sma" and self.arch != "allreduce":
            raise ValueError("sma exchanges replicas decentralized; use "
                             "arch='allreduce'")
        if self.wire not in WIRE_MODES:
            raise ValueError(f"wire={self.wire!r} not in {WIRE_MODES}")
        if isinstance(self.compression, Compressor) and \
                self.density != _DENSITY_DEFAULT:
            raise ValueError(
                "pass density inside the Compressor instance, not as a "
                "separate Strategy field")
        if self.detect and self.sync != "bsp":
            raise ValueError("straggler detection feeds the bsp backup "
                             "drop set; use sync='bsp'")

    @property
    def compressor(self) -> Compressor:
        if isinstance(self.compression, Compressor):
            comp = self.compression
            if self.kernel_backend != "auto" and comp.backend == "auto":
                comp = dataclasses.replace(comp,
                                           backend=self.kernel_backend)
            return comp
        return Compressor(self.compression, density=self.density,
                          backend=self.kernel_backend)

    def spec(self) -> str:
        """Canonical spec string (inverse of ``parse``)."""
        sync = self.sync + (f":{self.staleness}" if self.sync == "ssp"
                            else "")
        if self.backup:
            sync = f"bsp+backup:{self.backup}"
        if self.detect:
            sync += "+detect"
        method = (self.compression.method
                  if isinstance(self.compression, Compressor)
                  else self.compression)
        if method == "dgc":
            method += f":{self.density:g}"
        arch = self.arch
        if arch == "allreduce" and self.topology != "ring":
            arch = self.topology
        return f"{sync}/{arch}/{method}@{self.workers}"

    @classmethod
    def parse(cls, spec: str, **defaults) -> "Strategy":
        """Parse ``sync[:staleness]/arch/comp[:density]@workers`` — every
        segment after ``sync`` optional.  Keyword arguments are defaults
        for fields the spec string does not name."""
        fields = dict(defaults)
        s = spec.strip()
        if "@" in s:
            s, w = s.rsplit("@", 1)
            if ":" in w:
                raise NotImplementedError(
                    f"{spec!r}: hybrid mesh suffixes are not ported yet "
                    "(ROADMAP queue A item 6)")
            fields["workers"] = int(w)
        parts = s.split("/") if s else [""]
        if not parts[0]:
            raise ValueError(f"empty strategy spec: {spec!r}")
        if len(parts) > 3:
            raise ValueError(
                f"bad strategy spec {spec!r}: want sync[/arch[/comp]][@N]")
        sync = parts[0]
        if sync.endswith("+detect"):
            fields["detect"] = True
            sync = sync[: -len("+detect")]
        val = None
        if ":" in sync:
            sync, val = sync.split(":", 1)
        if sync == "bsp+backup":
            if val is None:
                raise ValueError(
                    f"bad strategy spec {spec!r}: bsp+backup needs a "
                    "count, e.g. bsp+backup:1")
            fields["backup"] = int(val)
            sync = "bsp"
        elif sync == "ssp":
            if val is not None:
                fields["staleness"] = int(val)
        elif val is not None:
            raise ValueError(
                f"bad strategy spec {spec!r}: only ssp takes a "
                f"staleness bound (got {sync}:{val})")
        fields["sync"] = sync
        if len(parts) > 1 and parts[1]:
            arch = parts[1]
            if arch in TOPOLOGIES:
                fields["arch"] = "allreduce"
                fields["topology"] = arch
            else:
                fields["arch"] = arch
        if len(parts) > 2 and parts[2]:
            comp = parts[2]
            if ":" in comp:
                comp, d = comp.split(":", 1)
                if comp != "dgc":
                    raise ValueError(
                        f"bad strategy spec {spec!r}: only dgc takes a "
                        f"density (got {comp}:{d})")
                fields["density"] = float(d)
            fields["compression"] = comp
        return cls(**fields)

    # ------------------------------------------------------------ backends
    def resolve_backend(self) -> str:
        if self.backend == "sim":
            if self.wire == "measured":
                # the simulator has no payloads to count: measured wire
                # accounting only exists where planes are exchanged
                raise ValueError("wire='measured' is device-only; the "
                                 "simulator models bytes, it does not "
                                 "move them")
            return "sim"
        # auto: the port's workers are logical, one device holds them all
        return "device"

    def build(self, grad_fn: Callable, layout: Optional[LeafLayout] = None,
              device="cuda") -> "Engine":
        """Construct the engine for this cell on ``device``; ``layout``
        maps the parameter tree onto the reference's leaves (see
        ``DeviceEngine``)."""
        return BACKENDS[self.resolve_backend()](self, grad_fn, layout,
                                                device)


# --------------------------------------------------------------- engines
class Engine:
    """Execution-backend protocol shared by every Strategy cell:

      init(params)              -> run-state
      step(state, batches, t)   -> (state, events)   # one global step
      finalize(state)           -> params
      metrics()                 -> {backend, spec, wire_bytes, ...}

    ``run`` composes them through the shared fit loop and returns the
    ``(params, history, wire_bytes)`` triple."""

    backend = "?"

    def __init__(self, strategy: Strategy, grad_fn: Callable,
                 layout: Optional[LeafLayout] = None, device="cuda"):
        self.strategy = strategy
        self.inner = self._make_inner(strategy, grad_fn, layout, device)

    def _make_inner(self, strategy, grad_fn, layout, device):
        raise NotImplementedError

    def init(self, params):
        return self.inner.init(params)

    def step(self, state, batches: Callable[[int, int], Any], t: int):
        return self.inner.step(state, batches, t)

    def finalize(self, state):
        return self.inner.finalize(state)

    def metrics(self) -> Dict[str, Any]:
        m = dict(backend=self.backend, spec=self.strategy.spec(),
                 wire_bytes=self.inner.wire_bytes(),
                 dropped_updates=self.inner.dropped_updates())
        m.update(self.inner.extra_metrics())
        return m

    # --------------------------------------------------- elastic interface
    # (elastic.recovery drives these; every backend implements them)
    def reshard(self, state, new_workers: int, step: int = 0,
                lost: Tuple[int, ...] = ()):
        # self.strategy stays the launched configuration: metrics() keeps
        # reporting its spec, and the current size is the engine's
        return self.inner.reshard(state, new_workers, step=step, lost=lost)

    def set_slowdown(self, worker: int, factor: float):
        self.inner.set_slowdown(worker, factor)

    def export_state(self, state):
        return self.inner.export_state(state)

    def import_state(self, arrays, meta):
        return self.inner.import_state(arrays, meta)

    def run(self, params, batches: Callable[[int, int], Any], steps: int):
        params, events, mets = fit(self, params, batches, steps)
        return params, events, mets["wire_bytes"]


class SimBackend(Engine):
    """Wraps the deterministic event simulation (``SimSyncEngine``)."""

    backend = "sim"

    def _make_inner(self, s: Strategy, grad_fn, layout, device):
        return SimSyncEngine(
            SyncConfig(mode=s.sync, num_workers=s.workers,
                       staleness=s.staleness, lr=s.lr, sma_mu=s.sma_mu,
                       periods=s.periods, compressor=s.compressor,
                       backup=s.backup, detect=s.detect, seed=s.seed),
            grad_fn, layout, device)


class DeviceBackend(Engine):
    """Wraps ``DeviceEngine``."""

    backend = "device"

    def _make_inner(self, s: Strategy, grad_fn, layout, device):
        return DeviceEngine(
            DataParallelConfig(
                num_workers=s.workers, lr=s.lr, sync=s.sync, arch=s.arch,
                staleness=s.staleness, periods=s.periods,
                topology=s.topology, compressor=s.compressor,
                backup=s.backup, bucket_mb=s.bucket_mb, order=s.order,
                detect=s.detect, wire=s.wire, sma_mu=s.sma_mu,
                seed=s.seed),
            grad_fn, layout, device)


BACKENDS: Dict[str, type] = {"sim": SimBackend, "device": DeviceBackend}


# -------------------------------------------------------------- trainer
def fit(engine: Engine, params, batches: Callable[[int, int], Any],
        steps: int):
    """The single training loop: the Engine protocol adapted onto
    ``train_loop``.  Returns (params, events, metrics); ``events`` is the
    full per-update history."""
    all_events: List[dict] = []

    def step_fn(st, t, gen=None):
        st, events = engine.step(st, batches, t)
        all_events.extend(events)
        mets = dict(
            loss=events[-1]["loss"] if events else float("nan"),
            max_staleness=max((e["max_staleness"] for e in events),
                              default=0))
        return st, mets

    state, _ = train_loop(step_fn, engine.init(params), lambda t: t, steps,
                          log_every=steps)
    return engine.finalize(state), all_events, engine.metrics()


class Trainer:
    """``Trainer(strategy).fit(grad_fn, params, batches, steps)`` builds
    the strategy's engine and drives it through the shared loop.  Returns
    (params, history, metrics).

    Passing ``plan`` (an ``elastic.events.EventPlan``, a typed plan, or a
    spec string like ``"crash:w1@5,resize:4@10"``) routes the run through
    the elastic trainer: the engine is snapshotted through
    ``checkpoint.store`` into ``checkpoint_dir`` and lives through
    crashes, resizes, restarts and straggler events in the same
    process."""

    def __init__(self, strategy: Strategy, device="cuda"):
        self.strategy = strategy
        self.device = device

    def fit(self, grad_fn: Callable, params,
            batches: Callable[[int, int], Any], steps: int, *,
            layout: Optional[LeafLayout] = None, plan=None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 5):
        if plan is not None:
            from repro_torch.elastic.recovery import fit_elastic
            return fit_elastic(self.strategy, grad_fn, params, batches,
                               steps, plan, checkpoint_dir=checkpoint_dir,
                               checkpoint_every=checkpoint_every,
                               layout=layout, device=self.device)
        engine = self.strategy.build(grad_fn, layout, self.device)
        return fit(engine, params, batches, steps)
