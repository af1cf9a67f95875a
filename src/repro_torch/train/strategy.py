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
          device, every sync model and both architectures; or, given a
          ``torch.distributed`` process group (``build(..., group=)``,
          ``Trainer(..., group=)``), one worker per rank for every
          device cell.

``backend="auto"`` resolves to ``device``: by default the port's workers
are logical, so one card holds any worker count (the reference falls
back to ``sim`` when the process has fewer devices than workers).  A
process group is the reference's one-worker-per-device layout (one
device of a hybrid mesh per rank, too); the sim backend refuses one.
``wire="measured"`` needs the device backend.  ``bsp+backup:k`` drops
the k slowest workers each round, ``+detect`` ranks them by measured
step times, and ``Trainer.fit(plan=...)`` runs under an elastic event
plan (``elastic.recovery.fit_elastic``), over a process group too.

A mesh suffix after the worker count shapes the logical devices into a
data x tensor x stage mesh with optional ZeRO state sharding, a pipeline
schedule, a precision and an optimizer (``parallel.mesh_plan``'s
grammar)::

    Strategy.parse("bsp/ring/onebit@8:d2.t2.s2")   # 3D hybrid mesh
    Strategy.parse("bsp/ps/none@4:d4.z3.adamw")    # ZeRO-3 sharded AdamW

Hybrid cells run on ``parallel.HybridEngine``; a trivial mesh
(``dK.t1.s1``, z0, sgd, fp32) is the plain ``DeviceEngine``.  A
``StagedModel`` given to the simulator or the plain device engine runs as
its stacked (unpipelined, unsharded) reference.

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
from repro_torch.parallel.mesh_plan import (OPTIMIZERS, PRECISIONS,
                                            SCHEDULES, MeshSpec,
                                            parse_suffix, suffix_spec)
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


# the acceptance matrix: every one of these cells must stay registered
# and device-executable (the reference's set, cell for cell)
ACCEPTANCE_CELLS = frozenset(
    Cell(s, a, c, "device")
    for s in MATRIX_SYNCS for a in ARCHS for c in MATRIX_METHODS)


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
    # hybrid mesh dimensions: None mesh = pure data parallelism at
    # `workers`; a non-trivial mesh, a ZeRO level, a stateful optimizer or
    # a schedule/precision/moments choice routes the cell to
    # parallel.HybridEngine
    mesh: Optional[Union[str, MeshSpec]] = None
    zero: int = 0                    # ZeRO optimizer-state level 0-3
    optimizer: str = "sgd"           # sgd | adamw
    micro_batches: int = 0           # pipeline micro-batches (0 = auto)
    schedule: str = "gpipe"          # pipeline schedule: gpipe | 1f1b
    interleave: int = 0              # 1f1b virtual stages/device (0 = auto)
    precision: str = "fp32"          # fp32 | bf16 | bf16r
    moments: str = "float32"         # adamw moment storage: float32|bfloat16
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
        if isinstance(self.mesh, str):
            object.__setattr__(self, "mesh", MeshSpec.parse(self.mesh))
        if self.mesh is not None and self.mesh.size != self.workers:
            raise ValueError(
                f"mesh {self.mesh.spec()} has {self.mesh.size} devices but "
                f"workers={self.workers}")
        if self.mesh is not None and self.mesh.is_trivial:
            # dK.t1.s1 IS plain data parallelism: normalize so equal
            # strategies compare equal and the canonical spec is minimal
            object.__setattr__(self, "mesh", None)
        if self.zero not in (0, 1, 2, 3):
            raise ValueError(f"zero={self.zero} (ZeRO levels are 0..3)")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer={self.optimizer!r} not in "
                             f"{OPTIMIZERS}")
        if self.micro_batches < 0:
            raise ValueError("micro_batches must be >= 0")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule={self.schedule!r} not in "
                             f"{SCHEDULES}")
        if self.schedule == "1f1b" and self.mesh_spec.stage < 2:
            raise ValueError("schedule='1f1b' needs a pipeline (mesh "
                             "stage >= 2); an unstaged mesh has no "
                             "schedule to choose")
        if self.interleave < 0:
            raise ValueError("interleave must be >= 0")
        if self.interleave and self.schedule != "1f1b":
            # interleaving (virtual stages) is what distinguishes the
            # 1f1b schedule's bubble; under gpipe it would silently noop
            raise ValueError("interleave (vK) composes with the 1f1b "
                             "schedule only")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision={self.precision!r} not in "
                             f"{PRECISIONS}")
        if self.moments not in ("float32", "bfloat16"):
            raise ValueError(f"moments={self.moments!r} (want float32 | "
                             "bfloat16)")
        if self.moments != "float32" and self.optimizer != "adamw":
            # only adamw has EMA moment buffers to quantize
            raise ValueError("moments='bfloat16' (qmom) requires "
                             "optimizer='adamw'")
        if self.zero and self.arch != "ps":
            # ZeRO is the sharded-state (parameter-server) architecture
            raise ValueError("zero > 0 requires arch='ps' (ZeRO shards "
                             "state through the reduce-scatter PS path)")
        if self.is_hybrid:
            if self.sync != "bsp":
                # async sync models (and SMA) compose with the data axis
                # of a mesh, not with a pipeline schedule, sharded state
                # or a stateful optimizer
                ok = (self.mesh_spec.stage == 1 and self.zero == 0
                      and self.optimizer == "sgd"
                      and self.arch == "allreduce")
                if not ok:
                    raise ValueError(
                        f"sync={self.sync!r} on a hybrid mesh needs "
                        "stage=1, zero=0, optimizer='sgd', and "
                        "arch='allreduce' (asynchrony composes with the "
                        "data axis, not the pipeline schedule or sharded "
                        "state)")
            if self.backup:
                raise ValueError("backup workers do not compose with "
                                 "hybrid meshes yet")
            if self.detect:
                # the hybrid step has no backup-drop path to feed
                raise ValueError("straggler detection does not compose "
                                 "with hybrid meshes yet")
        if self.detect and self.sync != "bsp":
            raise ValueError("straggler detection feeds the bsp backup "
                             "drop set; use sync='bsp'")

    # ------------------------------------------------------------ derived
    @property
    def mesh_spec(self) -> MeshSpec:
        """The effective mesh: the declared one, or pure data parallelism
        over all workers."""
        return self.mesh if self.mesh is not None else MeshSpec(self.workers)

    @property
    def is_hybrid(self) -> bool:
        """True when the cell needs the hybrid engine: a non-trivial
        (tensor/stage) mesh, ZeRO sharding, a stateful optimizer, or a
        non-default schedule/precision/moments dimension."""
        return ((self.mesh is not None and not self.mesh.is_trivial)
                or self.zero > 0 or self.optimizer != "sgd"
                or self.schedule != "gpipe" or self.precision != "fp32"
                or self.moments != "float32")

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
        method = self.compressor.method
        if method == "dgc":
            method += f":{self.compressor.density:g}"
        arch = self.arch
        if arch == "allreduce" and self.topology != "ring":
            arch = self.topology
        suffix = suffix_spec(self.mesh_spec, self.zero, self.optimizer,
                             self.micro_batches, self.schedule,
                             self.interleave, self.precision, self.moments)
        suffix = f":{suffix}" if suffix else ""
        return f"{sync}/{arch}/{method}@{self.workers}{suffix}"

    @classmethod
    def parse(cls, spec: str, **defaults) -> "Strategy":
        """Parse ``sync[:staleness]/arch/comp[:density]@workers[:mesh]``,
        every segment after ``sync`` optional (e.g. ``"ssp:2/ps"``,
        ``"bsp/ring/onebit@8:d2.t2.s2"``, ``"bsp/ps/none@4:d4.z3.adamw"``).
        Keyword arguments are defaults for fields the spec string does not
        name; named segments always win."""
        fields = dict(defaults)
        s = spec.strip()
        if "@" in s:
            s, w = s.rsplit("@", 1)
            if ":" in w:
                # the mesh suffix: d/t/s axes, ZeRO level, optimizer,
                # micro-batches, schedule, precision as dot tokens
                w, suffix = w.split(":", 1)
                suffix_fields, named = parse_suffix(suffix)
                for key, was_named in named.items():
                    if was_named:
                        fields[key] = suffix_fields[key]
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
        if self.is_hybrid:
            # tensor/stage axes and sharded state have no simulation: the
            # mesh IS the execution plan
            if self.backend == "sim":
                raise ValueError(
                    "hybrid cells (mesh/zero/adamw) are device-only; the "
                    "simulator has no tensor/stage axes")
            return "device"
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
              device="cuda", group=None) -> "Engine":
        """Construct the engine for this cell on ``device``; ``grad_fn``
        may be a ``parallel.StagedModel``, and ``layout`` maps the
        parameter tree onto the reference's leaves (see
        ``DeviceEngine``).  ``group``: run one worker per rank of this
        ``torch.distributed`` process group (``workers`` ranks)."""
        return BACKENDS[self.resolve_backend()](self, grad_fn, layout,
                                                device, group)


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
                 layout: Optional[LeafLayout] = None, device="cuda",
                 group=None):
        self.strategy = strategy
        self.inner = self._make_inner(strategy, grad_fn, layout, device,
                                      group)

    def _make_inner(self, strategy, grad_fn, layout, device, group):
        raise NotImplementedError

    def init(self, params):
        return self.inner.init(params)

    def step(self, state, batches: Callable[[int, int], Any], t: int):
        return self.inner.step(state, batches, t)

    def finalize(self, state):
        return self.inner.finalize(state)

    def metrics(self) -> Dict[str, Any]:
        m = dict(backend=self.backend, spec=self.strategy.spec(),
                 wire_bytes=self.inner.wire_bytes())
        if hasattr(self.inner, "dropped_updates"):
            m["dropped_updates"] = self.inner.dropped_updates()
        m.update(self.inner.extra_metrics())
        return m

    def extra_metrics(self) -> Dict[str, Any]:
        """The backend's own additions to ``metrics()``."""
        return self.inner.extra_metrics()

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

    def snapshot_template(self, state):
        """The tree a restore loads into (``export_state``'s, without a
        process group's gather where the backend has one)."""
        fn = getattr(self.inner, "snapshot_template", self.inner.export_state)
        return fn(state)

    @property
    def snapshot_writer(self) -> bool:
        """Whether this process writes the snapshots (rank 0 of a process
        group, or the only process)."""
        return getattr(self.inner, "snapshot_writer", True)

    def import_state(self, arrays, meta):
        return self.inner.import_state(arrays, meta)

    def run(self, params, batches: Callable[[int, int], Any], steps: int):
        params, events, mets = fit(self, params, batches, steps)
        return params, events, mets["wire_bytes"]


def _as_grad_fn(model_or_grad_fn):
    """A StagedModel handed to a non-hybrid backend runs as its stacked
    (unpipelined, unsharded) reference: the trajectory the hybrid engine
    is validated against."""
    from repro_torch.parallel.staged import is_staged_model, stacked_grad_fn
    if is_staged_model(model_or_grad_fn):
        return stacked_grad_fn(model_or_grad_fn)
    return model_or_grad_fn


class SimBackend(Engine):
    """Wraps the deterministic event simulation (``SimSyncEngine``)."""

    backend = "sim"

    def _make_inner(self, s: Strategy, grad_fn, layout, device, group):
        if group is not None:
            raise ValueError("the simulator runs every worker in one "
                             "process; a process group needs the device "
                             "backend")
        grad_fn = _as_grad_fn(grad_fn)
        return SimSyncEngine(
            SyncConfig(mode=s.sync, num_workers=s.workers,
                       staleness=s.staleness, lr=s.lr, sma_mu=s.sma_mu,
                       periods=s.periods, compressor=s.compressor,
                       backup=s.backup, detect=s.detect, seed=s.seed),
            grad_fn, layout, device)


class DeviceBackend(Engine):
    """Wraps the device engines: ``DeviceEngine`` for pure data
    parallelism, ``parallel.HybridEngine`` for hybrid cells (a
    non-trivial mesh, ZeRO level, stateful optimizer, schedule, precision
    or moments choice).  A trivial ``dK.t1.s1`` mesh is the same
    ``DeviceEngine`` the mesh-less spec builds."""

    backend = "device"

    def _make_inner(self, s: Strategy, grad_fn, layout, device, group):
        if s.is_hybrid:
            from repro_torch.parallel.engine import HybridConfig, HybridEngine
            return HybridEngine(
                HybridConfig(
                    mesh=s.mesh_spec, lr=s.lr, compressor=s.compressor,
                    zero=s.zero, optimizer=s.optimizer,
                    topology=s.topology, bucket_mb=s.bucket_mb,
                    order=s.order, micro_batches=s.micro_batches,
                    sync=s.sync, staleness=s.staleness, periods=s.periods,
                    sma_mu=s.sma_mu, wire=s.wire, seed=s.seed,
                    schedule=s.schedule, interleave=s.interleave,
                    precision=s.precision, moments=s.moments),
                grad_fn, layout, device, group)
        grad_fn = _as_grad_fn(grad_fn)
        return DeviceEngine(
            DataParallelConfig(
                num_workers=s.workers, lr=s.lr, sync=s.sync, arch=s.arch,
                staleness=s.staleness, periods=s.periods,
                topology=s.topology, compressor=s.compressor,
                backup=s.backup, bucket_mb=s.bucket_mb, order=s.order,
                detect=s.detect, wire=s.wire, sma_mu=s.sma_mu,
                seed=s.seed),
            grad_fn, layout, device, group)


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
    process.  ``group`` runs one worker per rank of a ``torch.distributed``
    process group (``Strategy.build``); every rank calls ``fit`` and gets
    the same parameters and history, under a plan too (rank 0 writes the
    snapshots)."""

    def __init__(self, strategy: Strategy, device="cuda", group=None):
        self.strategy = strategy
        self.device = device
        self.group = group

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
                               layout=layout, device=self.device,
                               group=self.group)
        engine = self.strategy.build(grad_fn, layout, self.device,
                                     self.group)
        return fit(engine, params, batches, steps)
