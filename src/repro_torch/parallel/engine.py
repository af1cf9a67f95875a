"""The hybrid-parallel engine: one train step over a data x tensor x stage
mesh of logical devices, with ZeRO-sharded optimizer state (the JAX
package's ``parallel/engine.py``).

``HybridEngine`` composes the three parallelization methods of the
survey's §3.2 into one step:

  stage axis    ``core.pipeline``'s GPipe or interleaved-1F1B micro-batch
                schedule (``pipeline_step``): each stage device holds a
                contiguous chunk of layers, activations hop stage to stage,
                and the backward walks the ticks in reverse, each device
                back-propagating its own calls (the graph cut at every
                hop).
  tensor axis   ``core.parallelism``'s role rules made explicit: each leaf
                is cut on its role dimension (column-parallel on the output
                dim, row-parallel on the input dim) and the StagedModel
                places the two Megatron collectives (``parallel.staged``).
  data axis     the bucketed / compressed / error-feedback exchange of
                ``comm.plan`` over the same bucket planner as the pure
                data-parallel engine, either as a topology-explicit
                allreduce (z0) or through the reduce-scatter / shard-update
                / all-gather ZeRO path of ``core.parameter_server`` (z1-z3,
                ``parallel.zero``).

**Logical devices.**  The reference runs one XLA program per device under
``shard_map``; here all D x T x S logical devices compute on the one
``device`` the engine runs on.  A data slot's forward and backward run
one after another (as the device engine's workers), its T tensor ranks as
dimension 0 of every tensor-sharded tensor, its S stages as the entries
of the pipeline's stage list.  What each logical device owns:

  * replicated state is held once: the parameters under z0-z2 (a tree
    like the caller's, every device's block a view of it) and, under z0,
    the AdamW moments;
  * sharded state is one tensor with the device grid in its leading dims:
    under z3 the parameters and under z1-z3 the moments, ``[D, S, T, m]``
    per bucket (device (d, t, s) owns row ``[d, s, t]``, the reference's
    ``P(DATA, STAGE, TENSOR)``), and the EF residuals, ``[D, S, T,
    *block]`` per leaf;
  * the gradients of one step: one full set per data slot (T x S blocks
    of it), freed bucket by bucket as the exchange consumes them.

``per_device_state_bytes`` divides each tensor by the devices it is
shared over, so it equals ``parallel.zero.state_bytes_per_device`` (plus
the AdamW step count, 4 B) however the state is stored.

The engine speaks the Engine / elastic protocol of the other backends
(init / step / finalize, export_state / import_state / reshard,
crash_plan, data_streams), so ``Trainer.fit(plan=...)`` recovers and
resizes hybrid runs; resizing rebuilds the *data* axis (tensor x stage
geometry is a property of the model and survives).  sync=ssp/asp replays
the simulator's staleness schedule per data slot and sma keeps a replica
per data slot; both need stage=1, zero=0, sgd and fp32.

Random draws (the stochastic codecs) come from ``torch.Generator``s
seeded from (seed, step, device), and a measured exchange draws from one
generator per (stage, tensor) block of the data axis; the reference
folds every axis index into one JAX key, so only the deterministic
methods (``none``, ``onebit``, ``dgc``) are draw for draw comparable
with it.

**Ranks.**  ``HybridEngine(..., group=)`` runs one device per rank of a
``torch.distributed`` group of ``data * tensor * stage`` ranks, rank r
at the reference's device order (``launch.dist.mesh_groups``: the
``[d, t, s]`` reshape of the ranks).  A rank holds its own device's
state only: its (stage, tensor) block of every parameter leaf (z0-z2),
its ``[1, 1, 1, m]`` shard of every bucket (z3 parameters, z1-z3
moments) and its EF block, every tensor with the leading dims of size 1
where the logical engine stacks its devices.  The stage axis runs
``core.pipeline.pipeline_step`` with activations and cotangents
handed between stage ranks; the tensor axis runs the Megatron operators
over the tensor line (``parallel.staged.tensor_axis``); the data axis
exchanges over the data line (``CommPlan`` with ``axis=``, the ZeRO
update with the line's reduce-scatter and all-gather).  The logical
engine runs the same cut-graph pipeline and the same per-device order of
operations, so both give the same bits.  The losses, dgc's sparse counts
and ``finalize``'s parameters are gathered over the world.  The data-axis
ssp / asp / sma cells hold the full parameters on every rank (a slot's
push is its whole gradient, gathered over its tensor line) and replay
the schedule over the data line.

**Elastic over ranks.**  The group's rank layout is the data-major grid
of ``launch.dist.mesh_groups``: data slot j on ranks ``j*ts ... (j+1)*ts -
1`` (``ts = tensor * stage``).  ``reshard`` to ``new_d`` slots moves the
engine onto the group's first ``new_d * ts`` ranks with the logical
engine's slot rule: each EF block moves to its new slot's rank at the same
(tensor, stage) coordinate (grown slots start at zero), z3 parameter and
z1+ moment shards are re-cut over the new data line (every old slot's
shard gathered along the old line, each new rank keeping its slice), and
a grown rank receives the replicated blocks from slot 0 at its
coordinate.  The group's other ranks sit idle (they take each step's
events from rank 0 and the final parameters).  The groups of every
smaller mesh are built at construction (``launch.dist.mesh_ladder``), as
``dist.new_group`` is collective over the world.  ``export_state``
gathers every shard, block and EF row to rank 0 in the logical layout
(``[D, S, T, m]`` per bucket, the parameter trees whole), so rank 0's
snapshot, the only one written, is the logical engine's file for file;
``import_state`` keeps a rank's own rows of each leaf (a rank loads only
the leaves it holds a part of, each whole: the store reads whole
leaves).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comm.codecs import SPARSE_ELEM_BYTES, codec_for, make_codec
from repro_torch.comm.plan import (CommPlan, fuse, modeled_event_bytes,
                                   scatter_flat)
from repro_torch.comm.transport import (compressed_allreduce,
                                        compressed_reduce_scatter,
                                        schedule_tx_bytes)
from repro_torch.core.collectives import DistAxis, gather_values
from repro_torch.core.compression import EF_METHODS, Compressor
from repro_torch.core.parameter_server import shard_of_flat
from repro_torch.core.pipeline import (bubble_fraction, gpipe_ticks,
                                       onefb_bubble_fraction, onefb_ticks,
                                       pipeline_step)
from repro_torch.core.precision import policy_for
from repro_torch.core.sync import default_periods, event_generator
from repro_torch.core.tree import LeafLayout, get_path, leaf_paths, tree_map
from repro_torch.launch.mesh import make_hybrid_mesh
from repro_torch.obs.trace import get_recorder
from repro_torch.parallel.mesh_plan import MeshPlan, MeshSpec, plan_mesh
from repro_torch.parallel.staged import (StagedModel, is_staged_model,
                                         tensor_axis)
from repro_torch.parallel.zero import (flatten_bucket, init_opt_state,
                                       make_optimizer_step,
                                       make_zero_bucket_update,
                                       state_bytes_per_device,
                                       wire_bytes_per_device)
from repro_torch.train.data_parallel import (async_replay_step,
                                            broadcast_object)

ASYNC_SYNCS = ("ssp", "asp")


class MeshRanks:
    """One rank's device of a hybrid mesh over a process group: its
    ``(d, t, s)`` coordinate and a ``DistAxis`` over the whole group
    (``world``) and over each of its three lines."""

    def __init__(self, mesh: MeshSpec, group):
        import torch.distributed as dist
        from repro_torch.launch.dist import mesh_groups
        backend = dist.get_backend(group)
        lines = mesh_groups(mesh.data, mesh.tensor, mesh.stage, group)
        self.coord = lines.coord
        self.world = DistAxis(group, backend)
        self.data = DistAxis(lines.data, backend)
        self.tensor = DistAxis(lines.tensor, backend)
        self.stage = DistAxis(lines.stage, backend)

    @property
    def staged_bytes(self) -> int:
        return sum(ax.staged_bytes for ax in (self.world, self.data,
                                              self.tensor, self.stage))


def emit_pipeline_trace(rec, stages: int, micro: int, *,
                        schedule: str = "gpipe", interleave: int = 1,
                        pid: str = "pipeline", clock=None) -> None:
    """The pipeline schedule this step executed, as trace spans on the
    deterministic tick clock: a ``pipe`` parent span on
    ``pipeline/schedule`` carrying the schedule's analytic bubble
    fraction, and per-stage tracks ``stage<s>`` with one span per tick:
    ``mb<k>`` while the stage device computes micro-batch k, ``bubble``
    for the fill/drain ticks where it sits idle.  Under GPipe stage s
    holds micro k = tick - s; under (interleaved) 1F1B device i is busy
    for its ``v * m`` consecutive chunk calls from tick i, computing micro
    ``(tick - i) mod m``.  This is the plan's own model of the schedule
    (``obs.analyze.pipeline_accounting`` measures the bubble back off
    these spans)."""
    if not rec.enabled:
        return
    if schedule == "1f1b":
        v = interleave
        ticks = onefb_ticks(stages, micro, v)
        analytic = onefb_bubble_fraction(stages, micro, v)
    else:
        v = 1
        ticks = gpipe_ticks(stages, micro)
        analytic = bubble_fraction(stages, micro)
    rec.begin("pipe", pid=pid, tid="schedule", cat="pipeline", clock=clock,
              stages=stages, micro=micro, ticks=ticks, schedule=schedule,
              interleave=v, analytic_bubble=round(analytic, 6))
    for s in range(stages):
        tid = f"stage{s}"
        for k in range(ticks):
            if schedule == "1f1b":
                active = s <= k < s + v * micro
                mb = (k - s) % micro
            else:
                mb = k - s
                active = 0 <= mb < micro
            rec.begin(f"mb{mb}" if active else "bubble", pid=pid, tid=tid,
                      cat="pipeline", clock=("pipe_tick", k), stage=s)
            rec.end(pid=pid, tid=tid)
    rec.end(pid=pid, tid="schedule")


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    mesh: MeshSpec = MeshSpec()
    lr: float = 0.1
    compressor: Compressor = Compressor("none")
    zero: int = 0                    # ZeRO level 0-3 (data-axis sharding)
    optimizer: str = "sgd"           # sgd | adamw
    topology: str = "ring"           # z0 data-axis allreduce schedule
    bucket_mb: float = 4.0
    order: str = "tictac"
    micro_batches: int = 0           # 0 = auto (2*stages when pipelined)
    schedule: str = "gpipe"          # pipeline schedule: gpipe | 1f1b
    interleave: int = 0              # 1f1b virtual stages/device (0 = auto 2)
    precision: str = "fp32"          # fp32 | bf16 | bf16r (core.precision)
    moments: str = "float32"         # AdamW EMA storage: float32 | bfloat16
    # sync model over the DATA axis: bsp natively; ssp/asp replay the
    # simulator's staleness schedule per data slot, sma keeps a replica
    # per data slot; all three need stage=1, zero=0, sgd
    sync: str = "bsp"
    staleness: int = 3
    periods: Optional[Tuple[int, ...]] = None   # per data-slot speeds
    sma_mu: float = 0.1
    wire: str = "modeled"            # modeled | measured
    seed: int = 0

    @property
    def num_workers(self) -> int:
        """Total logical devices: the elastic layer's worker count."""
        return self.mesh.size


class HybridEngine:
    """BSP over a d x t x s mesh of logical devices with ZeRO-0/1/2/3
    state sharding (module docstring).

    The model is either a plain ``grad_fn(params, batch) -> (loss,
    grads)`` (pure data axis: the mesh must be dK.t1.s1; ``layout`` maps
    its tree onto the reference's leaves, as for ``DeviceEngine``) or a
    ``StagedModel`` with stage-stacked params (any mesh).
    ``batches(t, w)`` is keyed by *data-parallel slot* w in [0,
    mesh.data): the tensor and stage axes share the slot's batch.
    ``group``: one device per rank of this process group (module
    docstring)."""

    def __init__(self, cfg: HybridConfig, model,
                 layout: Optional[LeafLayout] = None, device="cuda",
                 group=None):
        if cfg.zero not in (0, 1, 2, 3):
            raise ValueError(f"zero={cfg.zero} (want 0..3)")
        if cfg.optimizer not in ("sgd", "adamw"):
            raise ValueError(f"optimizer={cfg.optimizer!r}")
        if cfg.sync not in ("bsp",) + ASYNC_SYNCS + ("sma",):
            raise ValueError(f"sync={cfg.sync!r}")
        if cfg.wire not in ("modeled", "measured"):
            raise ValueError(f"wire={cfg.wire!r}")
        if cfg.sync != "bsp" and (cfg.mesh.stage != 1 or cfg.zero
                                  or cfg.optimizer != "sgd"):
            raise ValueError(
                f"sync={cfg.sync!r} composes with the data axis only: "
                "needs stage=1, zero=0, optimizer='sgd'")
        if cfg.schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule={cfg.schedule!r} (want gpipe|1f1b)")
        if cfg.schedule == "1f1b" and cfg.mesh.stage < 2:
            raise ValueError(
                "schedule='1f1b' needs a pipeline (mesh stage >= 2)")
        if cfg.interleave and cfg.schedule != "1f1b":
            raise ValueError(
                f"interleave=v{cfg.interleave} only applies to the 1f1b "
                "schedule")
        if cfg.interleave < 0:
            raise ValueError(f"interleave={cfg.interleave} (want >= 1)")
        if cfg.moments not in ("float32", "bfloat16"):
            raise ValueError(
                f"moments={cfg.moments!r} (want float32|bfloat16)")
        self._policy = policy_for(cfg.precision)   # raises on unknown name
        if cfg.sync != "bsp" and cfg.precision != "fp32":
            raise ValueError(
                f"sync={cfg.sync!r} cells run fp32 (precision="
                f"{cfg.precision!r} composes with BSP only)")
        # effective 1f1b interleave: v virtual stages per device
        self._v = (cfg.interleave or 2) if cfg.schedule == "1f1b" else 1
        self.staged = is_staged_model(model)
        if not self.staged and not cfg.mesh.is_trivial:
            raise ValueError(
                f"mesh {cfg.mesh.spec()} has tensor/stage axes; pass a "
                "repro_torch.parallel.StagedModel (a bare grad_fn cannot "
                "be pipelined or tensor-sharded)")
        self.cfg = cfg
        self.model: Optional[StagedModel] = model if self.staged else None
        self.grad_fn: Optional[Callable] = None if self.staged else model
        self.layout = layout
        self.device = torch.device(device)
        self.mesh = make_hybrid_mesh(cfg.mesh.data, cfg.mesh.tensor,
                                     cfg.mesh.stage)
        self.plan: Optional[MeshPlan] = None
        self.periods = cfg.periods or default_periods(cfg.mesh.data)
        assert len(self.periods) == cfg.mesh.data
        self.slowdowns: List[float] = [1.0] * cfg.mesh.data
        self._act_cell: List[int] = []
        self._comm: Optional[CommPlan] = None
        self._dev_event_bytes: Optional[int] = None
        self._measured_tx: Optional[int] = None
        self._event_wire: Optional[int] = None
        self._wire_total = 0
        self._skeleton = None
        self._full_shapes: List[Tuple[int, ...]] = []
        self._dtypes: List[torch.dtype] = []
        # over a group: its every rank (``_world``) and this rank's device
        # of the current mesh (``ranks``; None on a rank a resize left out)
        self.ranks: Optional[MeshRanks] = None
        self._world: Optional[DistAxis] = None
        if group is not None:
            import torch.distributed as dist

            from repro_torch.launch.dist import mesh_ladder
            if dist.get_world_size(group) != cfg.mesh.size:
                raise ValueError(
                    f"mesh {cfg.mesh.spec()} needs {cfg.mesh.size} ranks, "
                    f"the process group has {dist.get_world_size(group)}")
            mesh_ladder(cfg.mesh.data, cfg.mesh.tensor, cfg.mesh.stage,
                        group)
            self._group = group
            self._world = DistAxis(group, dist.get_backend(group))
            self.ranks = MeshRanks(cfg.mesh, group)

    # ------------------------------------------------------------ helpers
    @property
    def data_streams(self) -> int:
        """Batch streams the engine consumes (the data axis size): the
        elastic layer keys ``ElasticBatches`` on this, not on the total
        device count."""
        return self.cfg.mesh.data

    @property
    def _ef_active(self) -> bool:
        return self.cfg.compressor.method in EF_METHODS

    def _ensure_plan(self, params) -> MeshPlan:
        if self.plan is None:
            if self.layout is None:
                self.layout = LeafLayout.of_tree(params)
            self.plan = plan_mesh(
                params, self.cfg.mesh, staged=self.staged,
                bucket_mb=self.cfg.bucket_mb, order=self.cfg.order,
                micro_batches=self.cfg.micro_batches, seed=self.cfg.seed,
                layout=self.layout)
            self._full_shapes = [tuple(s) for s in
                                 self.layout.shapes(params)]
            self._dtypes = [get_path(params, parts[0]).dtype
                            for parts in self.layout.parts]
            self._skeleton = tree_map(lambda x: None, params)
            if self.cfg.schedule == "1f1b":
                s = self.cfg.mesh.stage
                if self.plan.micro < s:
                    raise ValueError(
                        f"1f1b needs micro_batches >= stages (got "
                        f"m={self.plan.micro} < s={s}); the wrap-link "
                        "FIFO gap m - s must be >= 0")
                chunk = self.plan.local_shapes[0][0]
                if chunk % self._v:
                    raise ValueError(
                        f"1f1b interleave v{self._v}: per-stage layer "
                        f"count {chunk} not divisible into v virtual "
                        "stages")
        return self.plan

    def _tree(self, leaves):
        """A tree like the caller's parameters over ``leaves`` (layout
        order); stacked leaves are split into views of their rows."""
        return self.layout.update(self._skeleton, leaves, lambda _, x: x)

    def _generator(self, t: int, idx: int) -> torch.Generator:
        return event_generator(self.cfg.seed, t, idx, self.device)

    def _exchange_generator(self, t: int, s: int, tt: int
                            ) -> torch.Generator:
        """The measured data-axis exchange's draws of block (s, tt)."""
        return self._generator(
            t, self.cfg.mesh.size + s * self.cfg.mesh.tensor + tt)

    # ------------------------------------------------ what a process holds
    @property
    def _slots(self) -> List[int]:
        """The data slots this process computes."""
        if self.ranks is not None:
            return [self.ranks.coord[0]]
        return list(range(self.cfg.mesh.data))

    def _loc(self, w: int, s: int, t: int) -> Tuple[int, int, int]:
        """Where device (w, t, s)'s row sits in the [D, S, T, ...] state
        tensors this process holds (each dim of size 1 on a rank)."""
        if self.ranks is not None:
            return 0, 0, 0
        return w, s, t

    @property
    def _data_axis(self):
        return None if self.ranks is None else self.ranks.data

    @property
    def _idle(self) -> bool:
        """A rank of the group that a resize left outside the mesh."""
        return self._world is not None and self.ranks is None

    @property
    def _has_idle(self) -> bool:
        return (self._world is not None
                and self.cfg.mesh.size < self._world.size)

    @property
    def snapshot_writer(self) -> bool:
        """Whether this process writes the engine's snapshots: rank 0 of
        a group, or the one process of the logical mesh."""
        return self._world is None or self._world.rank == 0

    @staticmethod
    def _idle_state(wire: int) -> Dict[str, Any]:
        return dict(params=None, opt=None, ef=None, wire=wire)

    # ------------------------------------------- 1f1b virtual-stage layout
    def _stage_perm(self, n_rows: int) -> np.ndarray:
        """Row permutation of a globally stacked leaf for interleaved 1F1B:
        device i must hold virtual stages {c*S + i | c < v} as its v
        contiguous local chunks (chunk-major), so the contiguous stage
        slicing of ``_block`` hands every device exactly the layers
        ``onefb_forward``'s per-chunk slice expects."""
        s, v = self.cfg.mesh.stage, self._v
        cl = n_rows // (s * v)
        idx: List[int] = []
        for i in range(s):
            for c in range(v):
                vs = c * s + i
                idx.extend(range(vs * cl, (vs + 1) * cl))
        return np.asarray(idx)

    def _permute_stacked(self, params, inverse: bool = False):
        """Reorder stacked-leaf rows into (or back out of) the 1f1b
        virtual-stage layout.  Identity for gpipe / v=1."""
        if not self.staged or self._v == 1:
            return params

        def f(leaf):
            perm = self._stage_perm(leaf.shape[0])
            if inverse:
                perm = np.argsort(perm)
            return leaf[torch.as_tensor(perm, device=leaf.device)]
        return tree_map(f, params)

    # -------------------------------------------------- device blocks
    def _block(self, leaf: torch.Tensor, i: int, s: int, t: int):
        """Device (s, t)'s block of leaf ``i`` of the leaves this process
        holds: a view of the full leaf, or on a rank (which holds its
        block only) the leaf itself."""
        if self.ranks is not None:
            return leaf
        return self._cut(leaf, i, s, t)

    def _cut(self, leaf: torch.Tensor, i: int, s: int, t: int):
        """Device (s, t)'s block of full stacked leaf ``i`` (a view): a
        contiguous chunk of layers along dim 0 and a role-dim slice along
        the tensor axis."""
        x = leaf
        if self.staged:
            chunk = x.shape[0] // self.cfg.mesh.stage
            x = x[s * chunk:(s + 1) * chunk]
        td = self.plan.tensor_dims[i]
        if self.cfg.mesh.tensor > 1 and td is not None:
            m = x.shape[td] // self.cfg.mesh.tensor
            x = x.narrow(td, t * m, m)
        return x

    def _grid(self):
        """The (stage, tensor) blocks this process holds."""
        if self.ranks is not None:
            _, t, s = self.ranks.coord
            return [(s, t)]
        S, T = self.cfg.mesh.stage, self.cfg.mesh.tensor
        return [(s, t) for s in range(S) for t in range(T)]

    def _assemble(self, blocks) -> List[torch.Tensor]:
        """The leaves this process holds from its devices' (s, t) block
        lists: full leaves on the logical mesh, a rank's own block."""
        if self.ranks is not None or self.cfg.mesh.is_trivial:
            return next(iter(blocks.values()))
        return self._assemble_full(blocks)

    def _assemble_full(self, blocks) -> List[torch.Tensor]:
        """Full leaves from every device's (s, t) block list."""
        if self.cfg.mesh.is_trivial:
            return blocks[(0, 0)]
        ref = blocks[(0, 0)]
        full = [torch.empty(shape, dtype=ref[i].dtype, device=ref[i].device)
                for i, shape in enumerate(self._full_shapes)]
        for st, lst in blocks.items():
            for i, x in enumerate(lst):
                self._cut(full[i], i, *st).copy_(x)
        return full

    def _gather_full(self, block_leaves, line: str) -> List[torch.Tensor]:
        """Full leaves on a rank from every device's block of them,
        gathered over the rank's tensor line (``line="tensor"``: the
        devices of one slot at stage 1) or the world (every (s, t) block,
        from data slot 0's devices)."""
        R, mesh = self.ranks, self.cfg.mesh
        ax = R.tensor if line == "tensor" else R.world
        rows = [ax.all_gather(x[None])[0] for x in block_leaves]
        blocks = {}
        for s in range(mesh.stage):
            for t in range(mesh.tensor):
                if line == "tensor":
                    if s != R.coord[2]:
                        continue
                    r = t
                else:
                    r = int(self.mesh.devices[0, t, s])
                blocks[(s, t)] = [x[r] for x in rows]
        return self._assemble_full(blocks)

    def _bucket_flat(self, leaves, b: int, s: int, t: int) -> torch.Tensor:
        """Flat (s, t)-local bucket vector of full ``leaves``, padded to
        a multiple of the data axis."""
        plan = self.plan
        idxs = plan.buckets[b]
        flat = flatten_bucket([self._block(leaves[i], i, s, t)
                               for i in idxs], range(len(idxs)))
        return torch.nn.functional.pad(flat, (0, (-flat.shape[0])
                                              % plan.mesh.data))

    def _shard_array(self, leaves, b: int) -> torch.Tensor:
        """[D, S, T, m] per-device flat shards of bucket ``b`` ([1, 1, 1,
        m] on a rank: its own)."""
        cfg, plan = self.cfg, self.plan
        d, t, s = cfg.mesh.data, cfg.mesh.tensor, cfg.mesh.stage
        if self.ranks is not None:
            out = torch.zeros((1, 1, 1, plan.shard_sizes[b]),
                              dtype=torch.float32, device=self.device)
            si, ti = self._grid()[0]
            out[0, 0, 0] = self._bucket_flat(leaves, b, si, ti).reshape(
                d, -1)[self.ranks.coord[0]]
            return out
        out = torch.zeros((d, s, t, plan.shard_sizes[b]),
                          dtype=torch.float32, device=self.device)
        for si, ti in self._grid():
            out[:, si, ti] = self._bucket_flat(leaves, b, si, ti).reshape(
                d, -1)
        return out

    def _materialize(self, shards: List[torch.Tensor]) -> List[torch.Tensor]:
        """Inverse of ``_shard_array``: the full stacked leaves from the
        per-bucket [D, S, T, m] shards (the data-axis all-gather; views of
        the shards when the mesh has one (s, t) block)."""
        plan = self.plan
        blocks = {}
        for st in self._grid():
            _, si, ti = self._loc(0, *st)
            out: List[Any] = [None] * len(plan.local_shapes)
            for x, b in zip(shards, plan.order):
                x = x[:, si, ti]
                if self.ranks is not None:     # ZeRO-3's gather
                    x = self.ranks.data.all_gather(x)[0]
                flat = x.reshape(-1)[:plan.bucket_sizes[b]]
                scatter_flat(flat, plan.buckets[b], plan.local_shapes, out)
            blocks[st] = out
        return self._assemble(blocks)

    # ---------------------------------------------------------------- init
    def init(self, params) -> Dict[str, Any]:
        cfg = self.cfg
        if self._idle:
            return self._idle_state(0)
        params = tree_map(lambda x: x.to(self.device), params)
        plan = self._ensure_plan(params)
        # 1f1b interleaving holds params in virtual-stage row order for
        # the whole run (identity otherwise); finalize() restores it
        params = self._permute_stacked(params)
        st: Dict[str, Any] = dict(wire=0)
        D = cfg.mesh.data
        k = len(self._slots)
        if cfg.sync in ASYNC_SYNCS:
            # async over the data axis: per-slot pulled copies of the FULL
            # stacked params (reference rebinds, like the flat engines);
            # the EF is per slot over full leaves too, since a slot's push
            # is its assembled full gradient
            st.update(
                params=params, opt=None,
                ef=([torch.zeros((k,) + s, device=self.device)
                     for s in self._full_shapes]
                    if self._ef_active else None),
                pulled=[params] * k, pulled_ver=[0] * D, server_ver=0,
                tick=0, updates=0, batch_idx=[0] * D,
                batch_cache=[None] * D, updates_base=0, step_base=0)
            return st
        if cfg.sync == "sma":
            st["replicas"] = [params] * k    # updates are out of place
            return st
        if self.ranks is not None:
            # a rank holds its own device's block of every leaf
            params = self._own_tree(params)
        leaves = self.layout.view(params)
        if cfg.zero == 3:
            st["params"] = [self._shard_array(leaves, b) for b in plan.order]
        else:
            # the optimizers update in place: the engine's own copy
            st["params"] = (params if self.ranks is not None
                            else tree_map(torch.clone, params))
        if cfg.optimizer == "adamw":
            if cfg.zero == 0:
                st["opt"] = init_opt_state("adamw", st["params"],
                                           cfg.moments)
            else:
                # one moment shard per bucket, in issue order, aligned
                # with the p/g bucket lists of the step
                mdt = getattr(torch, cfg.moments)
                st["opt"] = {
                    key: [torch.zeros(self._lead() + (plan.shard_sizes[b],),
                                      dtype=mdt, device=self.device)
                          for b in plan.order]
                    for key in ("m", "v")}
                st["opt"]["t"] = 0
        else:
            st["opt"] = None
        if self._ef_active:
            st["ef"] = [torch.zeros(self._lead() + s, device=self.device)
                        for s in plan.local_shapes]
        else:
            st["ef"] = None
        return st

    def _lead(self) -> Tuple[int, int, int]:
        """The leading [D, S, T] dims of the per-device state tensors
        this process holds ([1, 1, 1] on a rank)."""
        if self.ranks is not None:
            return (1, 1, 1)
        m = self.cfg.mesh
        return (m.data, m.stage, m.tensor)

    # ---------------------------------------------------------------- step
    def _comm_plan(self) -> CommPlan:
        """The data-axis ``CommPlan`` over one device's block shapes: the
        plan object (bucket fusion, issue order, codec, wire mode) the
        pure data-parallel engine executes."""
        if self._comm is None:
            cfg = self.cfg
            self._comm = CommPlan.plan(
                self.plan.local_shapes, n=cfg.mesh.data,
                topology=cfg.topology, compressor=cfg.compressor,
                wire=cfg.wire, bucket_mb=cfg.bucket_mb, order=cfg.order,
                seed=cfg.seed, reduce_dtype=self._policy.reduce_dtype)
        return self._comm

    def _measured_step_tx_bytes(self) -> int:
        """Shape-static measured bytes ONE device puts on the data axis
        per step, per bucket from the plan: z0 = the topology schedule;
        z1 = ring-allreduce grads + fp32 param all-gather; z2/z3 = the
        CommPlan ``ps`` accounting (RS grads + fp32 param all-gather)."""
        cfg, plan = self.cfg, self.plan
        d = cfg.mesh.data
        if d == 1:
            return 0
        comm = self._comm_plan()
        if cfg.zero == 0:
            return comm.measured_step_tx_bytes("allreduce")
        if cfg.zero >= 2:
            return comm.measured_step_tx_bytes("ps")
        # z1: compressed ring allreduce of grads + exact param all-gather
        codec = comm.codec if comm.in_schedule else make_codec("none")
        # bf16 reduce halves the exact grad words; params stay fp32
        scale = (comm.word_bytes / 4
                 if codec.exact and comm.word_bytes != 4 else 1.0)
        total = 0.0
        for b in plan.order:
            P = d * (-(-plan.bucket_sizes[b] // d))
            total += schedule_tx_bytes("ring", d, P, codec) * scale
            total += (d - 1) * 4 * (P // d)       # params travel exact
        return int(total)

    def _stage_loss_and_grads(self, leaves, batch):
        """One data slot's loss and gradient blocks through the pipeline
        schedule over its stage devices (``core.pipeline.pipeline_step``,
        the graph cut at every hop), each with its tensor ranks as
        dimension 0 of its blocks and activations.  ``leaves`` are the
        leaves this process holds (full, or a rank's block).  Returns
        (the loss, or None where the last stage is another rank's;
        ``{(s, t): gradient blocks}`` of the devices held).  Every tensor
        rank of the last stage takes the loss of its own (identical) copy
        of the output, as the reference's masked psum does."""
        cfg, plan, model = self.cfg, self.plan, self.model
        S, T = cfg.mesh.stage, cfg.mesh.tensor
        R = self.ranks
        policy = self._policy
        bf16 = policy.compute_dtype != "float32"
        x = model.inputs(batch)
        if bf16:
            x = x.to(policy.cdt)
        bsz = x.shape[0]
        micro = plan.micro
        if bsz % micro:
            raise ValueError(f"batch size {bsz} not divisible into "
                             f"{micro} micro-batches")
        mb = bsz // micro
        if not self._act_cell:
            self._act_cell.append(mb * int(np.prod(x.shape[1:]))
                                  * x.element_size())
        rows = 1 if R is not None else T        # tensor rows held
        if T > 1:
            x = x[None].expand((rows,) + tuple(x.shape))
            xm = [x[:, k * mb:(k + 1) * mb] for k in range(micro)]
        else:
            xm = [x[k * mb:(k + 1) * mb] for k in range(micro)]

        # each stage device's parameters: leaves of their own, [layers,
        # T, *block] per leaf when tensor-sharded (row j is layer j with
        # its tensor ranks' blocks on dim 0 of the layer); under bf16
        # compute the leaves are the bf16 copies, whose gradients sum
        # over the micro-batches in bf16 as the reference's cast's do
        grid = self._grid()
        held = sorted({s for s, _ in grid})
        dev: Dict[int, List[torch.Tensor]] = {}
        for s in held:
            ts = [t for s2, t in grid if s2 == s]
            if T > 1:
                blocks = [torch.stack([self._block(p, i, s, t) for t in ts],
                                      dim=1) for i, p in enumerate(leaves)]
            else:
                blocks = [self._block(p, i, s, 0)
                          for i, p in enumerate(leaves)]
            dev[s] = [(x.to(policy.cdt) if bf16 else x).detach()
                      .requires_grad_() for x in blocks]
            del blocks
        n_local = plan.local_shapes[0][0] if self.staged else 1
        per_chunk = n_local // self._v

        def call(s, c, xx):
            sp = self._tree(dev[s])
            for j in range(c * per_chunk, (c + 1) * per_chunk):
                xx = model.stage_fn(tree_map(lambda leaf: leaf[j], sp), xx,
                                    tensor_parallel=T > 1)
            return xx

        def loss_fn(ys):
            outs = torch.stack(ys)
            if T > 1:
                y = outs.transpose(0, 1).reshape((rows, bsz)
                                                 + tuple(outs.shape[3:]))
                per_rank = [model.readout(yr, batch).float()
                            for yr in y.unbind(0)]
                return per_rank[0], torch.stack(per_rank).sum()
            y = outs.reshape((bsz,) + tuple(outs.shape[2:]))
            loss = model.readout(y, batch).float()
            return loss, loss

        with tensor_axis(None if R is None else R.tensor):
            loss = pipeline_step(call, held, xm, loss_fn, stages=S,
                                 schedule=cfg.schedule, interleave=self._v,
                                 axis=None if R is None else R.stage)
        # contiguous blocks: a device's reductions (the codecs' scales)
        # then see the same layout on either axis
        out = {}
        for s, t in grid:
            r = [t2 for s2, t2 in grid if s2 == s].index(t)
            out[(s, t)] = [torch.zeros_like(p[:, r] if T > 1 else p,
                                            dtype=torch.float32)
                           if p.grad is None else
                           (p.grad[:, r] if T > 1 else p.grad).float()
                           .contiguous() for p in dev[s]]
        return None if loss is None else loss.detach(), out

    def _loss_and_grads(self, params, batch):
        """(loss or None, ``{(s, t): gradient blocks}``) of one data slot
        at the parameter tree ``params`` (already cast for compute when
        the model is a bare grad_fn)."""
        if self.staged:
            return self._stage_loss_and_grads(
                list(self.layout.leaves(params)), batch)
        loss, grads = self.grad_fn(params, batch)
        # under bf16 compute the gradients of the bf16 copy are widened:
        # the fp32 master weights are what the optimizer updates
        return loss, {(0, 0): [g.float() for g in
                               self.layout.leaves(grads, consume=True)]}

    def _bsp_body(self, st, per, t):
        """The BSP step's work on ``st`` (in place).  Returns (the held
        data slots' losses, None where another rank holds a slot's last
        stage; dgc's sparse elements this process sent)."""
        cfg = self.cfg
        comp = cfg.compressor
        comm = self._comm_plan()
        gain = comp.ef_gain if comp.method == "onebit" else 1.0
        bf16_reduce = self._policy.reduce_dtype != "float32"
        dax = self._data_axis
        if cfg.zero == 3:
            params = self._tree(self._materialize(st["params"]))
        else:
            params = st["params"]
        compute = params
        if not self.staged and self._policy.compute_dtype != "float32":
            # bf16 compute, fp32 masters: one cast serves every data slot
            compute = self._policy.cast_for_compute(params)
        losses, local = [], []          # local[row][(s, t)] -> blocks
        for w in self._slots:
            with record_function("forward_backward"):
                loss, g = self._loss_and_grads(compute, per[w])
            if bf16_reduce:
                # round the push to the bf16 wire words the measured
                # accounting counts (the exchange re-widens to fp32)
                g = {k: [x.to(self._policy.rdt) for x in v]
                     for k, v in g.items()}
            losses.append(None if loss is None else float(loss))
            local.append(g)
            del g
        del compute, params
        ef = st["ef"]
        gens = {st_: self._exchange_generator(t, *st_)
                for st_ in self._grid()}
        sent = 0
        if not comm.in_schedule and comp.method != "none":
            # modeled: each device compresses its own blocks with its EF
            with record_function("stack_and_compress"):
                for row, w in enumerate(self._slots):
                    for s, tt in self._grid():
                        ix = self._loc(w, s, tt)
                        e = (None if ef is None else [x[ix] for x in ef])
                        out, e_new, _ = comp.roundtrip(
                            local[row][(s, tt)], e, self._generator(
                                t, int(self.mesh.devices[w, tt, s])))
                        local[row][(s, tt)] = out
                        if e_new is not None:
                            for x, y in zip(ef, e_new):
                                x[ix].copy_(y)
                        del out, e_new
        if cfg.zero == 0:
            avg = {}
            with record_function("allreduce"):
                for st_ in self._grid():
                    lists = [g[st_] for g in local]
                    if comm.in_schedule:
                        e = (None if ef is None else
                             [[x[self._loc(w, *st_)] for x in ef]
                              for w in self._slots])
                        avg[st_], e_new, nz = comm.exchange(
                            lists, e, gens[st_], axis=dax)
                        if e_new is not None:
                            for row, w in enumerate(self._slots):
                                for x, y in zip(ef, e_new[row]):
                                    x[self._loc(w, *st_)].copy_(y)
                        sent += int(nz.sum())
                    else:
                        avg[st_] = comm.reduce_grads(lists, axis=dax)
                    del lists
            del local
            with record_function("sgd_update"):
                self._apply_z0(st, self._assemble(avg))
            return losses, sent
        return losses, self._zero_step(st, local, gens, gain)

    def _apply_z0(self, st, avg: List[torch.Tensor]):
        cfg = self.cfg
        if cfg.optimizer == "sgd":
            lr = cfg.lr
            st["params"] = self.layout.update(st["params"], avg,
                                              lambda p, g: p - lr * g)
            return
        grads = self._tree(avg)
        step = make_optimizer_step(cfg.optimizer, cfg.lr, cfg.moments)
        st["params"], st["opt"] = step(st["params"], grads, st["opt"])

    def _zero_step(self, st, local, gens, gain: float) -> int:
        """The z1-z3 bucket update of every (s, t) block held (one
        optimizer step over all their shards).  Returns dgc's sparse
        elements sent."""
        cfg, plan = self.cfg, self.plan
        dax = self._data_axis
        comm = self._comm_plan()
        codec = codec_for(cfg.compressor)
        ef = st["ef"]
        grid = self._grid()
        slots = self._slots
        combos = [(b, s, t) for b in plan.order for s, t in grid]
        if ef is not None and comm.in_schedule:
            # compensated input c_in = g + gain * e, per device block
            for row, w in enumerate(slots):
                for s, t in grid:
                    ix = self._loc(w, s, t)
                    local[row][(s, t)] = [
                        g.float() + gain * x[ix]
                        for g, x in zip(local[row][(s, t)], ef)]
        resids: List[torch.Tensor] = []
        sent = [0]

        def g_buckets():
            # each [D, n_b] bucket is fused when the update reaches it
            # and its blocks are dropped from the slots' lists
            for b, s, t in combos:
                yield fuse([g[(s, t)] for g in local], plan.buckets[b],
                           plan.local_shapes, plan.bucket_sizes[b])

        def grad_reduce(padded, j):
            _, s, t = combos[j]
            if cfg.zero == 1:
                red, res, nz = compressed_allreduce(padded, "ring", codec,
                                                    gens[(s, t)], axis=dax)
                shard = shard_of_flat(red, dax)
            else:
                shard, res, nz = compressed_reduce_scatter(
                    padded, codec, gens[(s, t)], axis=dax)
            resids.append(res)
            sent[0] += int(nz.sum())
            return shard

        locs = [self._loc(0, s, t)[1:] for s, t in grid]
        if cfg.zero == 3:
            p_buckets = [x[:, si, ti] for x in st["params"]
                         for si, ti in locs]
        else:
            leaves = self.layout.view(st["params"])
            p_buckets = (self._bucket_flat(leaves, b, s, t)[
                :plan.bucket_sizes[b]] for b, s, t in combos)
        opt = st["opt"]
        if opt is not None:
            opt = {k: [x[:, si, ti] for x in opt[k] for si, ti in locs]
                   for k in ("m", "v")}
            opt["t"] = st["opt"]["t"]
        update = make_zero_bucket_update(plan, cfg.zero, cfg.optimizer,
                                         cfg.lr, moment_dtype=cfg.moments,
                                         axis=dax)
        with record_function("allreduce"):
            new, opt_new = update(
                p_buckets, g_buckets(), opt,
                grad_reduce=grad_reduce if comm.in_schedule else None)
        with record_function("sgd_update"):
            if opt_new is not None:
                # the moments were updated in place (views of the state)
                st["opt"]["t"] = opt_new["t"]
            if cfg.zero == 3:
                for j, x in enumerate(new):
                    pos, (si, ti) = j // len(grid), locs[j % len(grid)]
                    st["params"][pos][:, si, ti].copy_(x)
            else:
                blocks = {st_: [None] * len(plan.local_shapes)
                          for st_ in grid}
                for (b, s, t), flat in zip(combos, new):
                    scatter_flat(flat, plan.buckets[b], plan.local_shapes,
                                 blocks[(s, t)])
                full = self._assemble(blocks)
                st["params"] = self.layout.update(
                    st["params"], full, lambda p, x: x.to(p.dtype))
            if ef is not None and comm.in_schedule:
                for (b, s, t), res in zip(combos, resids):
                    for row, w in enumerate(slots):
                        out: List[Any] = [None] * len(plan.local_shapes)
                        scatter_flat(res[row, :plan.bucket_sizes[b]],
                                     plan.buckets[b], plan.local_shapes,
                                     out)
                        ix = self._loc(w, s, t)
                        for i in plan.buckets[b]:
                            # telescoping EF: (g+e) - (g+gain*e) + hop
                            # residual
                            e = ef[i][ix]
                            e.mul_(1.0 - gain).add_(out[i].float())
        return sent[0]

    def _modeled_event_bytes(self) -> int:
        """The compressor's analytic per-device push accounting over the
        local block structure, from the plan."""
        if self._dev_event_bytes is None:
            self._dev_event_bytes = modeled_event_bytes(
                self.cfg.compressor, self.plan.local_shapes)
        return self._dev_event_bytes

    def _step_bsp(self, st, batches, t):
        cfg = self.cfg
        if self._measured_tx is None:
            self._measured_tx = self._measured_step_tx_bytes()
        per = {w: batches(t, w) for w in self._slots}
        if self.staged and cfg.mesh.stage > 1:
            bsz = int(self.model.inputs(per[self._slots[0]]).shape[0])
            if bsz % self.plan.micro:
                raise ValueError(
                    f"batch size {bsz} not divisible into "
                    f"{self.plan.micro} micro-batches")
        rec = get_recorder()
        if rec.enabled:
            with rec.span("compute", pid="train", tid="loop", cat="train",
                          clock=("train_step", t), mesh=cfg.mesh.spec(),
                          zero=cfg.zero, fused=True):
                losses, sent = self._bsp_body(st, per, t)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        else:
            losses, sent = self._bsp_body(st, per, t)
        losses, sent = self._gather_step(losses, sent)
        D = cfg.mesh.data
        if rec.enabled:
            if D > 1 and cfg.zero == 0:
                # z0 runs the CommPlan schedule on the data axis; z1-3
                # exchange through the ZeRO shard path instead, which the
                # per-step byte accounting (not bucket spans) covers
                self._comm_plan().emit_trace(rec, arch="allreduce",
                                             clock=("train_step", t))
            if self.staged and cfg.mesh.stage > 1:
                emit_pipeline_trace(rec, cfg.mesh.stage, self.plan.micro,
                                    schedule=cfg.schedule,
                                    interleave=self._v,
                                    clock=("train_step", t))
        if cfg.wire == "measured":
            # per bucket from the plan, every step: static plane bytes of
            # the data-axis schedule on every device + dgc's per-step
            # sparse payload
            st["wire"] += self._measured_tx * cfg.mesh.size \
                + SPARSE_ELEM_BYTES * sent
        else:
            st["wire"] += self._modeled_event_bytes() * cfg.mesh.size
        if rec.enabled:
            rec.counter("wire_bytes", {"cumulative": int(st["wire"])},
                        pid="train", cat="comm", clock=("train_step", t))
        ev = dict(step=t, loss=float(np.mean(np.asarray(losses,
                                                        np.float32))),
                  max_staleness=0)
        return st, [ev]

    def _gather_step(self, losses, sent: int):
        """Every data slot's loss and the whole mesh's dgc elements: as
        computed on the logical mesh, gathered over the world from each
        slot's last stage (tensor rank 0) on ranks."""
        R = self.ranks
        if R is None:
            return losses, sent
        # float64 carries the fp32 losses and the counts exactly
        x = torch.tensor([[losses[0] or 0.0, float(sent)]],
                         dtype=torch.float64, device=R.world.device)
        rows = R.world.all_gather(x)[0].tolist()
        S = self.cfg.mesh.stage
        return ([rows[int(self.mesh.devices[w, 0, S - 1])][0]
                 for w in range(self.cfg.mesh.data)],
                int(sum(r[1] for r in rows)))

    def step(self, st, batches: Callable[[int, int], Any], t: int):
        sync = self.cfg.sync
        ev = None
        if self._idle:
            pass                   # rank 0 sends the step's events below
        elif sync == "bsp":
            st, ev = self._step_bsp(st, batches, t)
        elif sync == "ssp":
            st, ev = self._step_async(st, batches, t, self.cfg.staleness)
        elif sync == "asp":
            st, ev = self._step_async(st, batches, t, None)
        else:
            st, ev = self._step_sma(st, batches, t)
        if self._has_idle:
            ev, st["wire"] = broadcast_object(self._world, (ev, st["wire"]))
        self._wire_total = st["wire"]
        return st, ev

    def finalize(self, st):
        cfg = self.cfg
        if cfg.sync == "sma":
            return tree_map(lambda *xs: self._data_rows(xs).mean(0),
                            *st["replicas"])
        if cfg.sync in ASYNC_SYNCS:
            return self._permute_stacked(st["params"], inverse=True)
        params = None
        if self._idle:
            pass
        elif cfg.zero == 3:
            params = self._tree(self._materialize(st["params"]))
        else:
            params = st["params"]
        if self.ranks is not None and not cfg.mesh.is_trivial:
            # every (s, t) block, gathered over the world
            params = self._tree(self._gather_full(
                list(self.layout.leaves(params)), "world"))
        if self._has_idle:
            # the ranks a resize left out take rank 0's
            if params is None:
                params = self._tree([
                    torch.empty(shape, dtype=dt, device=self.device)
                    for shape, dt in zip(self._full_shapes, self._dtypes)])
            params = self._tree([self._world.broadcast(x, 0) for x in
                                 self.layout.leaves(params)])
        return self._permute_stacked(params, inverse=True)

    def _data_rows(self, xs) -> torch.Tensor:
        """Every data slot's tensor [D, ...] in slot order, from the
        slots' tensors this process holds (gathered over the data line on
        a rank)."""
        x = torch.stack(xs)
        return x if self.ranks is None else self.ranks.data.all_gather(x)[0]

    def wire_bytes(self) -> int:
        return self._wire_total

    # -------------------------------------- async / sma over the data axis
    def effective_periods(self) -> Tuple[int, ...]:
        """Per data-slot speed schedule with straggler slowdowns folded
        in: the rule of ``ElasticWorkerSet.effective_periods``."""
        return tuple(max(1, int(round(p * s)))
                     for p, s in zip(self.periods, self.slowdowns))

    def _slot_loss_and_grads(self, pulled, batch):
        """One data slot's loss and full gradient leaves at stage=1:
        tensor-sharded compute inside the slot (its T ranks on dimension 0
        of the blocks, or one tensor rank per process); the blocks'
        gradients land in their slices of the full leaves (the
        reference's tensor-axis psum; gathered over the tensor line on a
        rank)."""
        if not self.staged:
            loss, g = self.grad_fn(pulled, batch)
            return loss, list(self.layout.leaves(g, consume=True))
        leaves = list(self.layout.leaves(pulled))
        if self.ranks is not None:
            (s, t), = self._grid()
            leaves = [self._cut(x, i, s, t) for i, x in enumerate(leaves)]
        loss, blocks = self._stage_loss_and_grads(leaves, batch)
        if self.ranks is not None:
            return loss, self._gather_full(next(iter(blocks.values())),
                                           "tensor")
        return loss, self._assemble_full(blocks)

    def _push_grad(self, st, w: int, pulled, batch, event: int):
        comp = self.cfg.compressor
        row = self._slots.index(w)
        with record_function("forward_backward"):
            loss, g = self._slot_loss_and_grads(pulled, batch)
        if comp.method == "none":
            return loss, g
        with record_function("stack_and_compress"):
            ef = st["ef"]
            out, ef_new, _ = comp.roundtrip(
                g, None if ef is None else [x[row] for x in ef],
                self._generator(event, w))
            if ef_new is not None:
                for x, y in zip(ef, ef_new):
                    x[row].copy_(y)
        return loss, out

    def _apply(self, params, leaves, w: int):
        lr = self.cfg.lr
        if self.ranks is not None:
            # the firing slot's ranks hand their push to every slot
            dax = self.ranks.data
            leaves = [dax.broadcast(
                leaves[i] if leaves is not None else
                torch.empty(shape, device=self.device), w)
                for i, shape in enumerate(self._full_shapes)]
        with record_function("sgd_update"):
            return self.layout.update(params, leaves,
                                      lambda p, g: p - lr * g)

    def _full_event_bytes(self) -> int:
        """Per-event modeled bytes of one slot's push: the compressor's
        accounting over the FULL stacked leaves, what the simulator
        reports for the same spec."""
        if self._event_wire is None:
            self._event_wire = modeled_event_bytes(self.cfg.compressor,
                                                   self._full_shapes)
        return self._event_wire

    def _step_async(self, st, batches, t, bound: Optional[int]):
        cfg = self.cfg
        return async_replay_step(
            st, batches, t, bound, K=cfg.mesh.data,
            push_grad=functools.partial(self._push_grad, st),
            apply_fn=self._apply, event_wire=self._full_event_bytes(),
            eff_periods=self.effective_periods(), axis=self._data_axis)

    def _step_sma(self, st, batches, t):
        cfg = self.cfg
        D = cfg.mesh.data
        lr, mu = cfg.lr, cfg.sma_mu
        reps = st["replicas"]
        center = tree_map(lambda *xs: functools.reduce(
            torch.add, list(self._data_rows(xs).unbind(0))) / D, *reps)
        losses = []
        for row, w in enumerate(self._slots):
            with record_function("forward_backward"):
                loss, g = self._slot_loss_and_grads(reps[row],
                                                    batches(t, w))
            g = self._tree(g)
            with record_function("sgd_update"):
                reps[row] = tree_map(
                    lambda r, z, gg: r - lr * gg - mu * (r - z),
                    reps[row], center, g)
            losses.append(float(loss))
            del g
        if self.ranks is not None:
            losses = gather_values(self.ranks.data, losses)
        st["wire"] += self._full_event_bytes() * D
        return st, [dict(step=t, loss=float(np.mean(np.asarray(
            losses, np.float32))), max_staleness=0)]

    # ------------------------------------------------------------- metrics
    def per_device_state_bytes(self, st) -> Dict[str, int]:
        """Measured persistent bytes per logical device, from the state
        tensors each divided by the devices it is shared over (module
        docstring): ``parallel.zero.state_bytes_per_device`` plus the
        AdamW step count.  On a rank, the bytes its own tensors hold (the
        data-axis async and sma cells keep full parameters there)."""
        cfg = self.cfg
        D, T, S = cfg.mesh.data, cfg.mesh.tensor, cfg.mesh.stage
        stacked_div = (S * T) if self.staged else 1
        shard_div = D * S * T
        if self.ranks is not None:
            # a rank's tensors are its device's own
            stacked_div = shard_div = 1

        def nbytes(tree, div):
            tensors = (get_path(tree, p) for p in leaf_paths(tree))
            return sum(x.numel() * x.element_size() // div
                       for x in tensors if x is not None)

        out = {"params": 0, "opt": 0, "ef": 0}
        if cfg.sync == "sma":
            out["params"] = nbytes(st["replicas"][0], stacked_div)
            out["total"] = out["params"]
            return out
        out["params"] = nbytes(st["params"], shard_div if cfg.zero == 3
                               else stacked_div)
        if st["opt"] is not None:
            div = stacked_div if cfg.zero == 0 else shard_div
            out["opt"] = (nbytes(st["opt"]["m"], div)
                          + nbytes(st["opt"]["v"], div) + 4)
        if st["ef"] is not None:
            out["ef"] = nbytes(st["ef"], shard_div)
        out["total"] = out["params"] + out["opt"]
        return out

    def extra_metrics(self) -> Dict[str, Any]:
        cfg, plan = self.cfg, self.plan
        m: Dict[str, Any] = dict(
            mesh=cfg.mesh.spec(), zero=cfg.zero, optimizer=cfg.optimizer,
            wire_mode=cfg.wire)
        if cfg.schedule != "gpipe":
            m["schedule"] = cfg.schedule
            m["interleave"] = self._v
        if cfg.precision != "fp32":
            m["precision"] = cfg.precision
        if cfg.moments != "float32":
            m["moments"] = cfg.moments
        if plan is not None and cfg.sync == "bsp":
            m["modeled_data_bytes_per_dev"] = wire_bytes_per_device(
                plan, cfg.zero, grad_bytes=self._modeled_event_bytes())
            m["analytic_state_bytes"] = state_bytes_per_device(
                plan, cfg.zero, cfg.optimizer, cfg.moments)
            if self._measured_tx is not None:
                m["measured_step_tx_bytes"] = self._measured_tx
            if self._act_cell and cfg.mesh.stage > 1:
                if cfg.schedule == "1f1b":
                    ticks = onefb_ticks(cfg.mesh.stage, plan.micro, self._v)
                else:
                    ticks = gpipe_ticks(cfg.mesh.stage, plan.micro)
                m["modeled_pipeline_bytes_per_dev"] = \
                    self._act_cell[0] * ticks
                if cfg.mesh.tensor > 1:
                    t = cfg.mesh.tensor
                    m["modeled_tensor_bytes_per_dev"] = int(
                        self._act_cell[0] * ticks * 2 * (t - 1) / t)
        return m

    # --------------------------------------------------- elastic interface
    def set_slowdown(self, worker: int, factor: float):
        """Record a straggler event.  Plan worker ids are flat device
        indices; a device's slowdown is recorded against its data slot
        (devices are data-major, so slot = id // (t*s)).  The hybrid step
        has no backup-drop path to feed, so the record only affects the
        async schedule and reshard bookkeeping."""
        ts = self.cfg.mesh.tensor * self.cfg.mesh.stage
        slot = worker // ts
        if not 0 <= slot < self.cfg.mesh.data or worker < 0:
            raise ValueError(f"worker {worker} out of range for mesh "
                             f"{self.cfg.mesh.spec()}")
        self.slowdowns[slot] = factor

    def crash_plan(self, worker: int) -> Tuple[int, Tuple[int, ...]]:
        """What losing device ``worker`` means for this mesh: its whole
        tensor x stage block (the model-parallel replica of one data slot)
        goes with it, so the run reshards to one fewer data replica."""
        cfg = self.cfg
        if not 0 <= worker < cfg.mesh.size:
            raise ValueError(f"worker {worker} out of range for mesh "
                             f"{cfg.mesh.spec()}")
        ts = cfg.mesh.tensor * cfg.mesh.stage
        if cfg.mesh.data <= 1:
            raise ValueError(
                f"mesh {cfg.mesh.spec()} has a single data replica; "
                "losing a device leaves nothing to reshard to")
        return cfg.mesh.size - ts, (worker // ts,)

    def reshard(self, st, new_workers: int, step: int = 0,
                lost: Tuple[int, ...] = ()):
        """Resize the mesh to ``new_workers`` logical devices by
        rebuilding the *data* axis (tensor x stage geometry is a property
        of the model and survives).  ZeRO shards are re-cut over the new
        data axis; survivor data slots keep their EF residuals.  Over a
        process group every rank calls it (module docstring)."""
        cfg, plan = self.cfg, self.plan
        if cfg.sync != "bsp":
            raise ValueError(
                f"sync={cfg.sync!r} hybrid cells do not reshard yet "
                "(async/sma over a mesh is a fixed-geometry run)")
        ts = cfg.mesh.tensor * cfg.mesh.stage
        if new_workers < ts or new_workers % ts:
            raise ValueError(
                f"resize to {new_workers} devices does not factor over the "
                f"tensor*stage block of {ts} (mesh {cfg.mesh.spec()}); "
                "hybrid meshes resize along the data axis only")
        if self._world is not None and new_workers > self._world.size:
            raise ValueError(
                f"resize to {new_workers} devices needs {new_workers} "
                f"ranks, the process group has {self._world.size}")
        new_d = new_workers // ts
        bad = [w for w in lost if w < 0 or w >= cfg.mesh.data]
        if bad:
            raise ValueError(f"lost data slots {bad} out of range for "
                             f"data axis {cfg.mesh.data}")
        survivors = [w for w in range(cfg.mesh.data) if w not in set(lost)]
        slots = survivors[:new_d]
        grown = new_d - len(slots)

        if self._world is not None:
            st = self._reshard_ranks(st, new_d, slots)
        else:
            def recut(arrs: List[torch.Tensor]) -> List[torch.Tensor]:
                out = []
                for arr, b in zip(arrs, plan.order):
                    n_b = plan.bucket_sizes[b]
                    m_new = -(-n_b // new_d)
                    _, S, T, _ = arr.shape
                    new = arr.new_zeros((new_d, S, T, m_new))
                    flat = arr.new_zeros(new_d * m_new)
                    for si in range(S):
                        for ti in range(T):
                            flat[:n_b] = arr[:, si, ti].reshape(-1)[:n_b]
                            new[:, si, ti] = flat.reshape(new_d, m_new)
                    out.append(new)
                return out

            if cfg.zero == 3:
                st["params"] = recut(st["params"])
            if st["opt"] is not None and cfg.zero >= 1:
                st["opt"] = {"m": recut(st["opt"]["m"]),
                             "v": recut(st["opt"]["v"]),
                             "t": st["opt"]["t"]}
            if st["ef"] is not None:
                st["ef"] = [torch.cat([x[slots], x.new_zeros(
                    (grown,) + x.shape[1:])]) for x in st["ef"]]
        new_mesh = MeshSpec(new_d, cfg.mesh.tensor, cfg.mesh.stage)
        self.cfg = cfg = dataclasses.replace(cfg, mesh=new_mesh)
        self.mesh = make_hybrid_mesh(new_d, cfg.mesh.tensor, cfg.mesh.stage)
        self.slowdowns = [self.slowdowns[s] for s in slots] + [1.0] * grown
        # the bucket identity is a function of the local block structure
        # and survives; only the per-rank shard length changes
        self.plan = dataclasses.replace(
            plan, mesh=new_mesh,
            shard_sizes=[-(-n // new_d) for n in plan.bucket_sizes])
        self.periods = tuple(default_periods(new_d))
        self._act_cell = []
        self._comm, self._dev_event_bytes, self._measured_tx = None, None, \
            None
        if self._world is not None:
            import torch.distributed as dist

            from repro_torch.launch.dist import subgroup
            glob = dist.get_process_group_ranks(self._group)
            group = subgroup(glob[:new_workers])
            self.ranks = (None if group is None
                          else MeshRanks(new_mesh, group))
        return st

    # ---------------------------------------------- elastic over ranks
    def _coord(self, r: int) -> Tuple[int, int, int]:
        """(d, t, s) of group rank ``r`` in the current mesh."""
        S = self.cfg.mesh.stage
        ts = self.cfg.mesh.tensor * S
        return r // ts, (r % ts) // S, r % S

    def _block_like(self, c: int, dtype=None) -> List[torch.Tensor]:
        """Empty tensors shaped like the blocks of the device at offset
        ``c`` of a data slot (``dtype``: the parameters' by default)."""
        _, t, s = self._coord(c)
        out = []
        for i, (shape, dt) in enumerate(zip(self._full_shapes,
                                            self._dtypes)):
            x = self._cut(torch.empty(shape, device="meta"), i, s, t)
            out.append(torch.empty(x.shape, dtype=dtype or dt,
                                   device=self.device))
        return out

    def _reshard_ranks(self, st, new_d: int, slots: List[int]):
        """``reshard`` over a process group: the logical slot rule with
        data slot j on the group's ranks ``j*ts ... (j+1)*ts - 1``
        (module docstring).  Returns this rank's state in the new
        mesh."""
        W, cfg, plan, R = self._world, self.cfg, self.plan, self.ranks
        me, D = W.rank, cfg.mesh.data
        ts = cfg.mesh.tensor * cfg.mesh.stage
        c = me % ts
        was, will = me < D * ts, me < new_d * ts
        i_new = me // ts
        # rank 0's counters on every rank (a rank left out holds stale ones)
        opt = st["opt"]
        wire, opt_t = broadcast_object(
            W, (st["wire"], None if opt is None else opt["t"]))

        def to_grown(part, like):
            """Slot 0's tensors ``part(i)`` at each offset sent to grown
            slot i's rank at the same offset (ranks idle before), which
            receive into the tensors ``like()`` makes; returns what this
            rank received, or None."""
            got = None
            for i in range(D, new_d):
                dst = i * ts + me if me < ts else None
                src = c if i_new == i and not was else None
                if dst is None and src is None:
                    continue
                ys = like() if src is not None else None
                xs = part(i) if dst is not None else [None] * len(ys)
                ys = ys or [None] * len(xs)
                res = [W.sendrecv(x, dst, y, src) for x, y in zip(xs, ys)]
                if src is not None:
                    got = res
            return got

        def recut(arrs, dtype):
            """z3 / moment shards re-cut over the new data line: every old
            slot's shard gathered along the old line, each new rank
            keeping its slice (the logical ``recut``'s bits)."""
            out = []
            for j, b in enumerate(plan.order):
                n_b = plan.bucket_sizes[b]
                m_new = -(-n_b // new_d)
                mine = flat = None
                if was:
                    rows = R.data.all_gather(arrs[j][0, 0])[0]
                    flat = rows.new_zeros(new_d * m_new)
                    flat[:n_b] = rows.reshape(-1)[:n_b]
                    if will:
                        mine = flat[i_new * m_new:(i_new + 1) * m_new]
                got = to_grown(
                    lambda i: [flat[i * m_new:(i + 1) * m_new]],
                    lambda: [torch.empty(m_new, dtype=dtype,
                                         device=self.device)])
                if got is not None:
                    mine = got[0]
                out.append(None if mine is None
                           else mine.clone().reshape(1, 1, 1, m_new))
            return out

        def replicated(tree, dtype=None):
            """A block tree replicated over the data line: kept where
            held, slot 0's on a grown rank."""
            got = to_grown(lambda i: list(self.layout.leaves(tree)),
                           lambda: self._block_like(c, dtype))
            if was:
                return tree
            return None if got is None else self._tree(got)

        new_st = self._idle_state(wire)
        mdt = getattr(torch, cfg.moments)
        if cfg.zero == 3:
            new_st["params"] = recut(st["params"], torch.float32)
        else:
            new_st["params"] = replicated(st["params"])
        if cfg.optimizer == "adamw":
            if cfg.zero >= 1:
                m, v = (recut(opt[k] if was else None, mdt)
                        for k in ("m", "v"))
            else:
                m, v = (replicated(opt[k] if was else None, mdt)
                        for k in ("m", "v"))
            new_st["opt"] = {"m": m, "v": v, "t": opt_t}
        if self._ef_active:
            # survivor slot slots[i]'s EF block moves to slot i's rank at
            # the same offset; grown slots start at zero
            dst = next((i * ts + c for i, w in enumerate(slots)
                        if was and w * ts + c == me and i * ts + c != me),
                       None)
            src = (slots[i_new] * ts + c
                   if will and i_new < len(slots)
                   and slots[i_new] * ts + c != me else None)
            shapes = [(1, 1, 1) + tuple(x) for x in plan.local_shapes]
            rows = [W.sendrecv(
                st["ef"][j] if dst is not None else None, dst,
                None if src is None else torch.empty(
                    shape, device=self.device), src)
                for j, shape in enumerate(shapes)]
            if not will:
                pass
            elif src is not None:
                new_st["ef"] = rows
            elif i_new < len(slots):
                new_st["ef"] = st["ef"]                     # kept in place
            else:
                new_st["ef"] = [torch.zeros(shape, device=self.device)
                                for shape in shapes]
        return new_st if will else self._idle_state(wire)

    def _stack_rows(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Every device's ``[1, 1, 1, ...]`` row as the logical ``[D, S,
        T, ...]`` tensor on rank 0 (host memory under gloo); None on the
        other ranks."""
        rows = self.ranks.world.gather(x[0, 0, 0], 0)
        if rows is None:
            return None
        m = self.cfg.mesh
        out = rows.new_empty((m.data, m.stage, m.tensor)
                             + tuple(rows.shape[1:]))
        for r in range(rows.shape[0]):
            d, t, s = self._coord(r)
            out[d, s, t] = rows[r]
        return out

    def _whole_tree(self, tree):
        """A tree of this rank's blocks as the whole tree (every (s, t)
        block, gathered over the world; the tree itself when the mesh
        has one block)."""
        if self.cfg.mesh.is_trivial:
            return tree
        return self._tree(self._gather_full(list(self.layout.leaves(tree)),
                                            "world"))

    def _own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``[1, 1, 1, ...]`` row of a logical ``[D, S, T,
        ...]`` tensor, on the engine's device."""
        d, t, s = self.ranks.coord
        return x[d:d + 1, s:s + 1, t:t + 1].to(self.device, copy=True)

    def _own_tree(self, tree):
        """This rank's blocks of a whole tree, on the engine's device."""
        (s, t), = self._grid()
        return self._tree([self._cut(x, i, s, t).to(self.device, copy=True)
                           for i, x in enumerate(self.layout.leaves(tree))])

    def _arrays(self, st, gather: bool) -> Dict[str, Any]:
        """The snapshot's tensors: the state in the logical layout (over
        a group, gathered to rank 0 when ``gather``; else this rank's own
        state, the structure a restore loads into)."""
        cfg = self.cfg
        opt = st["opt"]
        arrays = {"params": st["params"], "ef": st["ef"],
                  "opt": None if opt is None else {"m": opt["m"],
                                                   "v": opt["v"]}}
        if self._world is None or not gather or self._idle:
            return arrays
        if cfg.zero == 3:
            arrays["params"] = [self._stack_rows(x) for x in st["params"]]
        else:
            arrays["params"] = self._whole_tree(st["params"])
        if st["ef"] is not None:
            arrays["ef"] = [self._stack_rows(x) for x in st["ef"]]
        if opt is not None:
            if cfg.zero >= 1:
                arrays["opt"] = {k: [self._stack_rows(x) for x in opt[k]]
                                 for k in ("m", "v")}
            else:
                arrays["opt"] = {k: self._whole_tree(opt[k])
                                 for k in ("m", "v")}
        return arrays

    def export_state(self, st) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tensor tree, JSON-able meta) for ``checkpoint.store``.  Over a
        group every rank calls it, and rank 0's is the whole snapshot in
        the logical layout (module docstring)."""
        cfg = self.cfg
        if cfg.sync != "bsp":
            raise ValueError(
                f"sync={cfg.sync!r} hybrid cells do not snapshot yet; "
                "use the flat DeviceEngine (trivial mesh) for elastic "
                "async runs")
        opt = st["opt"]
        meta = dict(backend="hybrid", mesh=cfg.mesh.spec(), zero=cfg.zero,
                    optimizer=cfg.optimizer, num_workers=cfg.mesh.size,
                    wire=int(st["wire"]), slowdowns=list(self.slowdowns),
                    schedule=cfg.schedule, interleave=self._v,
                    precision=cfg.precision, moments=cfg.moments,
                    opt_t=None if opt is None else int(opt["t"]))
        return self._arrays(st, gather=True), meta

    def snapshot_template(self, st):
        """The tree a restore loads into: ``export_state``'s structure
        without the gather, each leaf an empty host tensor (a rank keeps
        its rows of the whole leaves ``import_state`` is handed), None
        where this process holds nothing."""
        arrays, meta = self._arrays(st, gather=False), None
        if self._world is not None:
            arrays = tree_map(lambda x: None if x is None
                              else torch.empty(0), arrays)
        return arrays, meta

    def import_state(self, arrays: Dict[str, Any], meta: Dict[str, Any]):
        cfg = self.cfg
        if meta["num_workers"] != cfg.mesh.size:
            raise ValueError(
                f"snapshot has {meta['num_workers']} devices, engine has "
                f"{cfg.mesh.size}; reshard the engine first")
        if meta["mesh"] != cfg.mesh.spec() or meta["zero"] != cfg.zero \
                or meta["optimizer"] != cfg.optimizer:
            raise ValueError(
                f"snapshot geometry {meta['mesh']}/z{meta['zero']}/"
                f"{meta['optimizer']} does not match engine "
                f"{cfg.mesh.spec()}/z{cfg.zero}/{cfg.optimizer}")
        # schedule/precision change the on-disk layout (virtual-stage row
        # order, moment dtype)
        snap = (meta["schedule"], meta["interleave"], meta["precision"],
                meta["moments"])
        mine = (cfg.schedule, self._v, cfg.precision, cfg.moments)
        if snap != mine:
            raise ValueError(
                f"snapshot schedule/precision {snap} does not match "
                f"engine {mine}")
        self.slowdowns = [float(s) for s in meta["slowdowns"]]
        self._wire_total = int(meta["wire"])
        if self._idle:
            return self._idle_state(self._wire_total)
        params, ef, opt = arrays["params"], arrays["ef"], arrays["opt"]
        if self._world is not None:
            # this rank's rows of the whole leaves
            rows = self._own_rows
            params = ([rows(x) for x in params] if cfg.zero == 3
                      else self._own_tree(params))
            ef = None if ef is None else [rows(x) for x in ef]
            if opt is not None:
                opt = {k: ([rows(x) for x in opt[k]] if cfg.zero >= 1
                           else self._own_tree(opt[k]))
                       for k in ("m", "v")}
        if opt is not None:
            opt = dict(opt, t=int(meta["opt_t"]))
        return dict(params=params, opt=opt, ef=ef, wire=self._wire_total)

    # ------------------------------------------------------------------ run
    def run(self, params, batches: Callable[[int, int], Any], steps: int):
        st = self.init(params)
        hist: List[dict] = []
        rec = get_recorder()
        for t in range(steps):
            # the step spans train_loop emits for the flat engines, so
            # hybrid traces feed obs.analyze.step_attribution too
            if rec.enabled:
                with rec.span("step", pid="train", tid="loop", cat="train",
                              clock=("train_step", t), step=t):
                    st, ev = self.step(st, batches, t)
            else:
                st, ev = self.step(st, batches, t)
            hist.extend(ev)
        return self.finalize(st), hist, st["wire"]
