"""Multi-axis device meshes as a declarative Strategy dimension (the JAX
package's ``parallel/mesh_plan.py``).

The survey's §3.2 parallelization taxonomy (data-, model- (tensor-) and
pipeline-parallelism) becomes a *mesh suffix* on the Strategy spec
string::

    bsp/ring/onebit@8:d2.t2.s2      8 devices as data=2 x tensor=2 x stage=2
    bsp/ps/none@4:d4.z3.adamw       4-way data parallel, ZeRO-3 AdamW

Suffix grammar (order-insensitive dot-separated tokens; ``parse_suffix``
and ``suffix_spec`` are inverses)::

    token := "d" N   data-parallel replicas        (default 1)
           | "t" N   tensor-parallel shards        (default 1)
           | "s" N   pipeline stages               (default 1)
           | "z" L   ZeRO optimizer-state level    (0..3, default 0)
           | "m" K   pipeline micro-batches        (default 2*stages)
           | "sgd" | "adamw"                       (optimizer, default sgd)
           | "gpipe" | "1f1b"                      (pipeline schedule,
                                                    default gpipe)
           | "v" K   1f1b interleave (virtual      (default 2 under 1f1b)
                     stages per device)
           | "fp32" | "bf16" | "bf16r"             (compute precision,
                                                    default fp32; bf16r
                                                    also reduces in bf16)
           | "qmom"                                (bf16 optimizer moments)

``MeshSpec`` is the axis geometry; ``MeshPlan`` (built by ``plan_mesh``)
is the composition plan the hybrid engine executes: per-leaf tensor
shard dimensions from ``core.parallelism``'s role rules, the per-device
local block shapes, the data-axis fused-bucket plan (``comm.plan``'s, the
one the pure data-parallel engine executes) and the ZeRO shard sizes over
the data axis.  The devices are logical (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.comm.plan import plan_buckets
from repro_torch.core.comm_scheduler import LayerCost
from repro_torch.core.parallelism import model_axis_dim
from repro_torch.core.tree import LeafLayout

AXES = ("data", "tensor", "stage")

OPTIMIZERS = ("sgd", "adamw")

SCHEDULES = ("gpipe", "1f1b")

PRECISIONS = ("fp32", "bf16", "bf16r")

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis geometry of a hybrid mesh: ``size == data * tensor * stage``."""
    data: int = 1
    tensor: int = 1
    stage: int = 1

    def __post_init__(self):
        for name in ("data", "tensor", "stage"):
            if getattr(self, name) < 1:
                raise ValueError(f"mesh {name} axis must be >= 1")

    @property
    def size(self) -> int:
        return self.data * self.tensor * self.stage

    @property
    def is_trivial(self) -> bool:
        """True when the mesh is pure data parallelism (t == s == 1)."""
        return self.tensor == 1 and self.stage == 1

    def spec(self) -> str:
        return f"d{self.data}.t{self.tensor}.s{self.stage}"

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """Parse a pure axis spec (``d2.t2.s2``).  Non-geometry tokens
        (z/m/sgd/adamw/...) are rejected: silently dropping a ZeRO level
        from ``Strategy(mesh="d4.z3")`` would train un-sharded."""
        fields, named = parse_suffix(text)
        extras = [k for k in ("zero", "optimizer", "micro_batches",
                              "schedule", "interleave", "precision",
                              "moments") if named[k]]
        if extras:
            raise ValueError(
                f"mesh spec {text!r} carries non-axis tokens ({extras}); "
                "a mesh is dN.tN.sN only — pass zero/optimizer/"
                "micro_batches as Strategy fields, or use the full spec "
                "string suffix (Strategy.parse)")
        return fields["mesh"]


def parse_suffix(text: str) -> Tuple[Dict[str, Any], Dict[str, bool]]:
    """Parse a mesh suffix into Strategy fields.

    Returns ``(fields, named)``: ``fields`` has mesh/zero/optimizer/
    micro_batches/schedule/interleave/precision/moments with defaults
    filled in; ``named`` records which were explicitly present (so
    Strategy keyword defaults do not clobber spec-named values and vice
    versa)."""
    axes = {"d": 1, "t": 1, "s": 1}
    zero, optimizer, micro = 0, "sgd", 0
    schedule, interleave, precision, moments = "gpipe", 0, "fp32", "float32"
    named = {"mesh": False, "zero": False, "optimizer": False,
             "micro_batches": False, "schedule": False, "interleave": False,
             "precision": False, "moments": False}
    # word tokens first: "1f1b"/"bf16" start with a digit/axis letter, so
    # they must be name-matched before the head-char dispatch below
    words = {tok: "optimizer" for tok in OPTIMIZERS}
    words.update({tok: "schedule" for tok in SCHEDULES})
    words.update({tok: "precision" for tok in PRECISIONS})
    words["qmom"] = "moments"
    seen = set()
    for tok in text.split("."):
        tok = tok.strip()
        if not tok:
            raise ValueError(f"bad mesh suffix {text!r}: empty token")
        # all names of one dimension share one slot: "sgd.adamw" (or
        # "gpipe.1f1b") is a contradiction, not a last-wins override
        key = words.get(tok, tok[0])
        if key in seen:
            raise ValueError(f"bad mesh suffix {text!r}: duplicate {key!r}")
        if tok in words:
            seen.add(key)
            named[key] = True
            if key == "optimizer":
                optimizer = tok
            elif key == "schedule":
                schedule = tok
            elif key == "precision":
                precision = tok
            else:                       # qmom
                moments = "bfloat16"
            continue
        head, val = tok[0], tok[1:]
        if head not in ("d", "t", "s", "z", "m", "v") or not val.isdigit():
            raise ValueError(
                f"bad mesh suffix {text!r}: token {tok!r} (want dN/tN/sN/"
                f"zL/mK/vK/sgd/adamw/gpipe/1f1b/fp32/bf16/bf16r/qmom)")
        seen.add(head)
        if head in axes:
            axes[head], named["mesh"] = int(val), True
        elif head == "z":
            zero, named["zero"] = int(val), True
        elif head == "v":
            interleave, named["interleave"] = int(val), True
        else:
            micro, named["micro_batches"] = int(val), True
    fields = dict(mesh=MeshSpec(axes["d"], axes["t"], axes["s"]),
                  zero=zero, optimizer=optimizer, micro_batches=micro,
                  schedule=schedule, interleave=interleave,
                  precision=precision, moments=moments)
    return fields, named


def suffix_spec(mesh: MeshSpec, zero: int = 0, optimizer: str = "sgd",
                micro_batches: int = 0, schedule: str = "gpipe",
                interleave: int = 0, precision: str = "fp32",
                moments: str = "float32") -> str:
    """Canonical mesh suffix (inverse of ``parse_suffix``); empty string
    when every dimension is at its default."""
    parts: List[str] = []
    if not mesh.is_trivial:
        parts.append(mesh.spec())
    if zero:
        parts.append(f"z{zero}")
    if micro_batches:
        parts.append(f"m{micro_batches}")
    if schedule != "gpipe":
        parts.append(schedule)
    if interleave:
        parts.append(f"v{interleave}")
    if precision != "fp32":
        parts.append(precision)
    if moments != "float32":
        parts.append("qmom")
    if optimizer != "sgd":
        parts.append(optimizer)
    return ".".join(parts)


# ------------------------------------------------------------------ planning
@dataclasses.dataclass
class MeshPlan:
    """The executable composition plan for one mesh, over the model's
    leaves (``LeafLayout`` order, the reference's ``jax.tree.leaves``):

    - ``tensor_dims``: per (stacked) leaf, the dimension index sharded
      over the tensor axis (``core.parallelism`` role rules), or None.
    - ``local_shapes``: per-device block shapes (stage-sliced,
      tensor-sliced), the shapes gradients and EF state take on a device
      (the reference's ``local_example`` tree of zeros).
    - ``buckets``/``order``/``fused``: the data-axis fused-bucket plan and
      issue order (the pure data-parallel engine's planner).
    - ``bucket_sizes``/``shard_sizes``: per-bucket flat length and padded
      per-data-rank ZeRO shard length.
    - ``micro``: pipeline micro-batches per step.
    """
    mesh: MeshSpec
    staged: bool
    tensor_dims: List[Optional[int]]
    local_shapes: List[Shape]
    buckets: List[List[int]]
    order: List[int]
    fused: List[LayerCost]
    bucket_sizes: List[int]
    shard_sizes: List[int]
    micro: int

    @property
    def n_local_params(self) -> int:
        return sum(_numel(s) for s in self.local_shapes)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _local_block_shape(shape: Shape, staged: bool, mesh: MeshSpec,
                       t_dim: Optional[int], name: str) -> Shape:
    """Per-device block shape of one (stacked) leaf: the leading layer
    dim is divided over the stage axis (each stage device holds a
    contiguous chunk of layers), the tensor role dim over the tensor
    axis."""
    if staged:
        if not shape or shape[0] < mesh.stage or shape[0] % mesh.stage:
            raise ValueError(
                f"staged leaf {name!r} has {shape[0] if shape else 0} "
                f"stacked layers; the stage axis ({mesh.stage}) must "
                f"divide the layer count")
        shape = (shape[0] // mesh.stage,) + shape[1:]
    if mesh.tensor > 1:
        if t_dim is None:
            raise ValueError(
                f"leaf {name!r} has no model-parallel dimension under the "
                f"role rules of core/parallelism.py; a tensor axis of "
                f"{mesh.tensor} needs every leaf to be shardable")
        if shape[t_dim] % mesh.tensor:
            raise ValueError(
                f"leaf {name!r} dim {t_dim} ({shape[t_dim]}) not divisible "
                f"by tensor axis {mesh.tensor}")
        shape = tuple(n // mesh.tensor if i == t_dim else n
                      for i, n in enumerate(shape))
    return shape


def plan_mesh(params, mesh: MeshSpec, *, staged: bool,
              bucket_mb: float = 4.0, order: str = "tictac",
              micro_batches: int = 0, back_s_per_byte: float = 2e-12,
              seed: int = 0, layout: Optional[LeafLayout] = None
              ) -> MeshPlan:
    """Build the MeshPlan for ``params`` (stacked per-stage leaves when
    ``staged``), over ``layout``'s leaves (``LeafLayout.of_tree(params)``
    when not given).  Pure planning: no tensor is touched."""
    layout = layout or LeafLayout.of_tree(params)
    shapes = [tuple(s) for s in layout.shapes(params)]
    names = list(layout.names)

    def leaf_tensor_dim(name, shape):
        ndim = len(shape)
        if staged:       # classify without the leading stacked-stage dim
            td = model_axis_dim(name, ndim - 1)
            return None if td is None else td + 1
        return model_axis_dim(name, ndim)

    t_dims = [leaf_tensor_dim(n, s) for n, s in zip(names, shapes)]
    if staged:
        heads = {s[0] if s else 0 for s in shapes}
        if len(heads) != 1:
            raise ValueError(
                f"staged leaves disagree on the stacked layer count "
                f"({sorted(heads)}); every leaf needs the same leading "
                "layer dim")
    locals_ = [_local_block_shape(s, staged, mesh, td, n)
               for s, td, n in zip(shapes, t_dims, names)]
    buckets, order_idx, fused = plan_buckets(locals_, bucket_mb, order,
                                             back_s_per_byte, seed)
    sizes = [_numel(s) for s in locals_]
    bucket_sizes = [sum(sizes[i] for i in b) for b in buckets]
    shard_sizes = [-(-n // mesh.data) for n in bucket_sizes]
    micro = micro_batches or (2 * mesh.stage if mesh.stage > 1 else 1)
    return MeshPlan(mesh=mesh, staged=staged, tensor_dims=t_dims,
                    local_shapes=locals_, buckets=buckets, order=order_idx,
                    fused=fused, bucket_sizes=bucket_sizes,
                    shard_sizes=shard_sizes, micro=micro)
