"""The dry-run's partitioner: the collectives one step issues on a
production mesh, counted per device (what the JAX package's
``launch/dryrun.py`` gets from XLA's SPMD partitioner: its inputs'
``NamedSharding``s, the jitted step's ``out_shardings`` and the
collectives read from the partitioned HLO).

The port partitions with DTensor.  ``count_pair`` brings up a fake
process group (``torch.testing._internal.distributed.fake_pg``: no
card, no peer, every collective returns at once) with the mesh's 256 or
512 ranks, as rank 0, and lays a ``DeviceMesh`` of
``launch.mesh.make_production_mesh``'s shape and axis names over it,
with every run of consecutive axes flattened: an entry of several axes,
such as the batch's ``("pod", "data")``, shards its dimension over each,
and the flattened dimension lets DTensor move it with one collective of
the product's size, as XLA does, instead of one per mesh axis.  Every
input of the step becomes a DTensor over a ``meta`` shard (shapes only)
whose placements are the ported specs (``launch.specs``,
``core.parallelism.param_specs``).  The step then runs under
``launch.cost.CollectiveCounter``: DTensor's sharding propagation
chooses the collectives, rank 0's view of them is the per-device record,
and the outputs are moved to the reference's ``out_shardings`` (the
train step's parameters and optimizer state keep their specs, which its
in-place updates do; the prefill's and decode's logits and caches take
theirs), which is counted too.  The group is destroyed before
``count_pair`` returns, and it refuses to run where a default group
exists.

Where DTensor alone would lay a step out poorly, or not at all, the
partitioner's rules take over (``Partitioner``, a ``TorchFunctionMode``
installed by ``run_counted`` and nowhere else; the models keep one path
and know nothing of meshes):

  x @ w         Megatron's tensor parallelism with ZeRO-3 (``tp_matmul``)
  w[ids]        the embedding lookup, moving the smaller side (``embed``)
  einsum        per mesh dimension, the largest operand's sharded index
                wins; run shard by shard (``einsum``)
  softmax       as its max and sum reductions, over the shards where
                its dimension is sharded (flash-decoding's combine)
  logsumexp, gather over a sharded dimension
                as reductions of the shards (the vocab-sharded loss)
  reshape       a sharded dimension that cannot stay sharded is
                gathered first (``reshape_placements``)
  cache[rows, slot] = new
                the decode step's cache write, shard by shard
                (``write_rows``)

Two model functions are swapped while the rules are installed:
RWKV-6's token loop (32768 or 524288 steps of one shape) runs its
first, second and last token steps, the second's collectives counted
once for each of the S - 2 middle tokens (``_CountedStep``: a middle
step's state comes from a step and its gradient from the next), and the
layer groups' activation checkpoint re-enters the rules when it
recomputes a group in the backward.  The rules hold only on ``meta``
shards (some write or scale values that no count reads): a DTensor
with real storage raises.  A step that still
reaches an op DTensor cannot partition raises, and the dry-run records
the op in ``collectives_error`` (``failure``).
"""
from __future__ import annotations

import contextlib
import functools
import math
import re
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from repro_torch.launch.cost import CollectiveCounter, collective_weight

DATA_AXES = ("data", "pod")         # the mesh axes that shard the batch


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, destroyed on exit.  Refuses to run where a default group
    exists already (it is not this function's to replace or destroy)."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("launch.spmd: a default process group exists "
                           "already; the dry-run's count brings up its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh, flatten: Sequence[Tuple[str, ...]] = ()):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names (a
    ``launch.mesh.LogicalMesh``) over the default group, with the
    flattened dimensions ``flatten`` (tuples of consecutive axis names).
    Its device type is the card's: on a ``cpu`` mesh DTensor moves a
    shard from one dimension to another with an all-gather (Gloo has no
    all-to-all), on a card's with the all-to-all XLA emits."""
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda", tuple(mesh.devices.shape),
                          mesh_dim_names=tuple(mesh.axis_names))
    for names in flatten:
        dm[tuple(names)]._flatten()
    return dm


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, names: Sequence[str]):
    """A spec (one entry per dimension: None, an axis name or a tuple of
    them) as DTensor placements over mesh axes ``names``.  An entry of
    several axes must list them in mesh order (major first), the order
    DTensor shards one dimension over several mesh dimensions in."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry} lists mesh axes out of mesh order")
        for i in idx:
            out[i] = Shard(dim)
    return out


def distribute(t: torch.Tensor, spec, dm):
    """``t`` (a global-shape tensor; only its shape and dtype are read) as
    a DTensor over a ``meta`` shard: rank 0's shard of ``spec`` (the
    largest, where a dimension does not divide)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = placements(spec, dm.mesh_dim_names)
    local_shape, _ = compute_local_shape_and_global_offset(
        t.shape, dm, pl)
    local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, dm, pl, run_check=False,
                              shape=t.shape, stride=_contiguous(t.shape))


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute_tree(tree, specs, dm):
    """``distribute`` over a tree of tensors and its spec tree; leaves that
    are not tensors (an optimizer's step count) stay as they are."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs.get(k), dm)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, dm)
                          for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return distribute(tree, specs, dm)
    return tree


def redistribute_tree(tree, specs, dm):
    """Each DTensor leaf of ``tree`` moved to its spec in ``specs`` (the
    reference's ``out_shardings``); returns the moved tree."""
    if isinstance(tree, dict):
        return {k: redistribute_tree(v, specs.get(k), dm)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(redistribute_tree(v, s, dm)
                          for v, s in zip(tree, specs))
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.redistribute(dm, placements(specs, dm.mesh_dim_names))
    return tree


def run_counted(step, args, in_specs, out_specs_fn, mesh,
                unroll: bool = False) -> Dict[str, float]:
    """Run ``step(*args)`` with every tensor of ``args`` distributed by
    ``in_specs`` (a tuple of spec trees, one per argument) over ``mesh``
    (a ``launch.mesh.LogicalMesh``) on a fake group of its size, and
    count its collectives with those that move the outputs to
    ``out_specs_fn(out)`` (a spec tree like the output, or None to leave
    them).  ``unroll`` runs RWKV-6's token loop token by token.  Returns
    the counter's record (``CollectiveCounter.record``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with fake_group(int(mesh.devices.size)):
        names = tuple(mesh.axis_names)
        dm = device_mesh(mesh, [names[i:j] for i in range(len(names))
                                for j in range(i + 2, len(names) + 1)])
        dargs = tuple(distribute_tree(a, s, dm)
                      for a, s in zip(args, in_specs))
        counter = CollectiveCounter()
        with greedy_costs(), implicit_replication(), counter, \
                installed(unroll):
            try:
                out = step(*dargs)
                out_specs = out_specs_fn(out)
                if out_specs is not None:
                    out = redistribute_tree(out, out_specs, dm)
            except Exception as e:
                e.add_note(f"in DTensor op {counter.last_op}")
                raise
        del out, dargs
        return counter.record()


@contextlib.contextmanager
def greedy_costs():
    """DTensor plans a redistribution greedily, mesh dimension by mesh
    dimension, except where a placement is a ``_StridedShard`` (two
    sharded dimensions merged, as a batched matmul's reshapes make):
    there it searches the graph of placements for the cheapest path, and
    it plans so for every candidate strategy it prices.  On the
    2 x 16 x 16 mesh that took 225 s for one attention einsum and 646 s
    for DeepSeek-V2-Lite's train step.  Within the block a strategy's
    price takes the greedy plan where there is one (the one DTensor takes
    for placements without a ``_StridedShard``); the redistributions
    that run keep DTensor's own plans."""
    from torch.distributed.tensor import _redistribute as R
    from torch.distributed.tensor._collective_utils import redistribute_cost
    from torch.distributed.tensor._ops import utils as U
    plans = R._gen_transform_infos
    pricing = [False]

    def infos(src, dst, *args, **kwargs):
        if pricing[0]:
            try:
                return R.get_redistribute_planner(
                    src.mesh, src.tensor_meta
                ).generate_greedy_transform_infos(src, dst)
            except Exception:  # noqa: BLE001 — the search's cases
                pass
        return plans(src, dst, *args, **kwargs)

    def price(*args, **kwargs):
        pricing[0] = True
        try:
            return redistribute_cost(*args, **kwargs)
        finally:
            pricing[0] = False

    R._gen_transform_infos, U.redistribute_cost = infos, price
    try:
        yield
    finally:
        R._gen_transform_infos, U.redistribute_cost = plans, redistribute_cost


def count_pair(cfg, shape, multi_pod: bool, policy: str = "fsdp",
               cache_policy: str = "attn_hints_seq",
               unroll: bool = False) -> Dict[str, float]:
    """The collectives of one step of ``cfg`` at ``shape``'s global batch
    on the production mesh (``run_counted``), with the reference's
    ``build_dryrun`` specs: ``param_specs`` under ``policy``, the
    optimizer state's from them, the batch's, and the decode caches'
    under ``cache_policy``; outputs as its ``out_shardings``.
    ``unroll``: as ``run_counted``'s."""
    from repro_torch.core.parallelism import data_axes, param_specs
    from repro_torch.launch.dryrun import _state
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import (batch_shardable, batch_specs_tree,
                                          cache_specs, opt_state_specs)
    from repro_torch.models import build_model
    mesh = make_production_mesh(multi_pod=multi_pod)
    step, args = _state(cfg, shape, shape.global_batch, "meta")
    params = args[0]
    pspecs = param_specs(params, multi_pod=multi_pod, policy=policy)
    shard_b = batch_shardable(shape, mesh)
    bspecs = batch_specs_tree(cfg, shape, mesh, multi_pod)
    dp = data_axes(multi_pod)
    b = (dp[0] if len(dp) == 1 else dp) if shard_b else None
    logits_spec = (b, None, "model")
    if shape.kind == "train":
        layout = build_model(cfg).leaf_layout(params)
        ospecs = opt_state_specs(args[1], pspecs, layout)
        return run_counted(
            step, args, (pspecs, ospecs, bspecs),
            lambda out: (pspecs, ospecs, ()), mesh, unroll)
    if shape.kind == "prefill":
        bspecs.pop("labels", None)
        return run_counted(
            step, args, (pspecs, bspecs),
            lambda out: (logits_spec, cache_specs(
                out[1], mesh, multi_pod, shard_b)), mesh, unroll)
    cspecs = cache_specs(args[1], mesh, multi_pod, shard_b,
                         policy=cache_policy)
    return run_counted(
        step, args, (pspecs, cspecs, (b, None), None),
        lambda out: (logits_spec, cspecs), mesh, unroll)


_OP_RE = re.compile(r"\baten\.[A-Za-z0-9_]+(?:\.[A-Za-z0-9_]+)?")


def failure(e: BaseException) -> str:
    """What a record's ``collectives_error`` says of a count that raised:
    the aten op DTensor could not partition (from its message, else the
    DTensor op ``run_counted`` saw last) and the message's first line."""
    msg = str(e).strip()
    ops = (_OP_RE.findall(msg)
           or _OP_RE.findall(" ".join(getattr(e, "__notes__", ()))))
    first = msg.splitlines()[0][:300] if msg else ""
    op = ops[-1] if ops else type(e).__name__
    return first if first.startswith(op) else f"{op}: {first}"


# ------------------------------------------------------ the partitioner
def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _dtensors(args, kwargs):
    DTensor = _dtensor()
    flat = list(args) + list(kwargs.values())
    flat += [a for x in flat if isinstance(x, (list, tuple)) for a in x]
    return [a for a in flat if isinstance(a, DTensor)]


class Partitioner(TorchFunctionMode):
    """The dry-run's rules for partitioning a step on DTensors (module
    docstring): each torch function of ``RULES`` that gets a DTensor
    runs its rule, which may decline (``NotImplemented``) to leave it to
    DTensor; any other function is DTensor's.  A DTensor whose shard is
    not on ``meta`` raises."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dts = _dtensors(args, kwargs)
        if dts:
            for t in dts:
                if t._local_tensor.device.type != "meta":
                    raise NotImplementedError(
                        "launch.spmd partitions steps on meta shards only "
                        f"(a {t._local_tensor.device.type} shard reached "
                        f"{getattr(func, '__name__', func)})")
            rule = RULES.get(func)
            if rule is not None:
                out = rule(*args, **kwargs)
                if out is not NotImplemented:
                    return out
        return func(*args, **kwargs)


@contextlib.contextmanager
def _rules():
    """The partitioner, unless it is active already (a checkpoint's
    recompute inside the backward of a step that runs under it)."""
    from torch.overrides import _get_current_function_mode_stack
    if any(isinstance(m, Partitioner)
           for m in _get_current_function_mode_stack()):
        yield
        return
    with Partitioner():
        yield


@contextlib.contextmanager
def installed(unroll: bool = False):
    """The partitioner's rules, and the model functions it swaps: RWKV-6's
    token loop (``_CountedStep``, unless ``unroll``) and the layer
    groups' checkpoint (its recompute in the backward runs under the
    rules too; the backward itself runs outside every function mode)."""
    from repro_torch.models import rwkv6, transformer, whisper
    saved = rwkv6._wkv, transformer.checkpoint, whisper.checkpoint
    plain_loop, checkpoint = saved[0], saved[1]

    def remat(fn, *args, **kwargs):
        return checkpoint(fn, *args, context_fn=lambda: (
            contextlib.nullcontext(), _rules()), **kwargs)

    def loop_once(k, v, r, w, u, S_h):
        # the first token's step (its state comes in as the caller laid it
        # out), the second's for the S - 2 in the middle, and the last's
        # (its state's gradient comes in as the caller's use lays it out)
        B, S, H, hs = k.shape
        if S <= 3:
            return plain_loop(k, v, r, w, u, S_h)
        step = rwkv6.token_step
        t = [(k[:, i], v[:, i], r[:, i], w[:, i]) for i in (0, 1, S - 1)]
        y0, S_h = step(*t[0], u, S_h)
        y1, S_h = _CountedStep.apply(S - 2, step, *t[1], u, S_h)
        y2, S_h = step(*t[2], u, S_h)
        return torch.cat([y0[:, None], y1[:, None].expand(B, S - 2, H, hs),
                          y2[:, None]], dim=1), S_h

    rwkv6._wkv = plain_loop if unroll else loop_once
    transformer.checkpoint = whisper.checkpoint = remat
    try:
        with _rules():
            yield
    finally:
        rwkv6._wkv, transformer.checkpoint, whisper.checkpoint = saved


class _CountedStep(torch.autograd.Function):
    """``step(*inputs)``, one of ``n`` token steps of one shape, whose
    collectives count ``n`` times in its forward and its backward
    (``launch.cost.collective_weight``): its outputs stand for every
    step's, shapes only.  Its graph keeps its own saved tensors (identity
    hooks), so a checkpoint around it does not recompute its region
    inside the weighted backward."""

    @staticmethod
    def forward(ctx, n, step, *inputs):
        with torch.enable_grad(), collective_weight(n), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                         lambda t: t):
            xs = [t.detach().requires_grad_(t.requires_grad)
                  for t in inputs]
            outs = step(*xs)
        ctx.n, ctx.xs, ctx.outs = n, xs, outs
        ctx.set_materialize_grads(False)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        need = [t for t in ctx.xs if t.requires_grad]
        used = [(o, g) for o, g in zip(ctx.outs, grads) if g is not None]
        with collective_weight(ctx.n):
            got = iter(torch.autograd.grad([o for o, _ in used], need,
                                           [g for _, g in used],
                                           allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in ctx.xs)


def _sharded_on(x, dim: int) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(x, _dtensor()) and any(
        isinstance(p, Shard) and p.dim == dim % x.ndim for p in x.placements)


def gather_data_shards(w):
    """A weight with its shards over the mesh's data axes gathered (ZeRO-3:
    a spec's ``"data"`` entry shards the weight's storage, its
    ``"model"`` entry the work; the gradient's way back is a
    reduce-scatter)."""
    from torch.distributed.tensor import Replicate
    return w.redistribute(placements=[
        Replicate() if n in DATA_AXES else p
        for n, p in zip(w.device_mesh.mesh_dim_names, w.placements)])


def _gathered_numel(w) -> int:
    """Elements of ``w``'s shard once its data shards are gathered."""
    from torch.distributed.tensor import Shard
    n = w.to_local().numel()
    for name, p, k in zip(w.device_mesh.mesh_dim_names, w.placements,
                          w.device_mesh.mesh.shape):
        n *= k if name in DATA_AXES and isinstance(p, Shard) else 1
    return n


def tp_matmul(x, w):
    """``x @ w`` (a 2-D weight) as Megatron's tensor parallelism with
    ZeRO-3 lays it out.  The product keeps ``x``'s batch shards and is
    sharded on its last dimension over the model axis after a
    column-parallel ``w`` (its output dimension sharded there) or summed
    (all-reduced) over it after a row-parallel one.  To get there, ``w``'s
    data shards are gathered and ``x`` is replicated over the model axis
    before a column-parallel ``w`` or sharded on its last dimension before
    a row-parallel one; where ``x`` is smaller than that gathered weight
    (a decode step's one token per row), ``x`` moves instead, as DTensor
    chooses.  Left to itself on the larger activations, DTensor moves the
    weight and leaves partial products and residual streams sharded in
    ways that change from mesh to mesh."""
    from torch.distributed.tensor import Replicate, Shard
    if not isinstance(x, _dtensor()):
        return NotImplemented
    data = [n in DATA_AXES for n in w.device_mesh.mesh_dim_names]
    row, col = Shard(0), Shard(1)
    batch = [isinstance(p, Shard) and p.dim < x.ndim - 1
             for p in x.placements]
    out = [(xp if b else Replicate()) if d else
           (Shard(x.ndim - 1) if wp == col else Replicate())
           for d, b, xp, wp in zip(data, batch, x.placements, w.placements)]
    if x.to_local().numel() >= _gathered_numel(w):
        w = gather_data_shards(w)
        x = x.redistribute(placements=[
            (xp if b else Replicate()) if d else
            (Shard(x.ndim - 1) if wp == row else Replicate())
            for d, b, xp, wp in zip(data, batch, x.placements,
                                    w.placements)])
    return (x @ w).redistribute(placements=out)


def embed(w, ids):
    """``w[ids]``, the embedding lookup, on a table sharded over the vocab
    (model axis) and ``d`` (data axes), by the rule of ``tp_matmul``: the
    smaller side moves.  Where the rows this device looks up are at least
    its table gathered over the data axes (training, prefill), the table
    is gathered and each device looks up its batch shard's ids in its
    vocab shard (``_vocab_rows``); else (decode) the ids are gathered,
    each device looks up its ``d`` shard of every row, and the rows move
    to the ids' batch shards.  The vocab shards' rows are summed over the
    model axis either way."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = w.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    out = [p if n in DATA_AXES else Replicate()
           for n, p in zip(mesh.mesh_dim_names, ids.placements)]
    if ids.to_local().numel() * w.shape[1] >= _gathered_numel(w):
        return _summed(_vocab_rows(gather_data_shards(w), ids))
    ids = ids.redistribute(placements=[Replicate()] * mesh.ndim)
    return F.embedding(ids.long(), w).redistribute(placements=out)


def _vocab_rows(w, ids):
    """Each device's rows of ``ids`` (its batch shard) from its vocab shard
    of ``w`` (whole over the data axes), zero for ids outside it: partial
    over the model axis.  Its backward keeps the table's gradient to the
    vocab shard, partial over the batch shards (DTensor's own embedding
    backward computes it at the full vocab on every device)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    batch = [n in DATA_AXES and p == Shard(0)
             for n, p in zip(mesh.mesh_dim_names, ids.placements)]
    vocab = [p == Shard(0) for p in w.placements]
    (n_rows, _), (start, _) = compute_local_shape_and_global_offset(
        w.shape, mesh, w.placements)

    def rows(table, idx):
        hit = (idx >= start) & (idx < start + n_rows)
        got = F.embedding(torch.where(hit, idx - start, 0).long(), table)
        return torch.where(hit[..., None], got, 0)

    ids_pl = [Shard(0) if b else Replicate() for b in batch]
    return local_map(
        rows, device_mesh=mesh, redistribute_inputs=True,
        out_placements=[Shard(0) if b else Partial() if v else Replicate()
                        for b, v in zip(batch, vocab)],
        in_placements=(w.placements, ids_pl),
        in_grad_placements=([Partial() if b else p
                             for b, p in zip(batch, w.placements)], ids_pl),
    )(w, ids)


def write_rows(cache, slot, new) -> None:
    """``cache[arange(B), slot] = new`` in place (a decode step's cache
    write), shard by shard, as XLA's partitioner writes a sharded cache:
    ``new`` is laid out as the cache's shards of its other dimensions and
    replicated over its sequence shards (the collectives that takes are
    the write's), and each shard writes the rows that fall in it.  Only
    the shapes of that local write are real (meta shards)."""
    from torch.distributed.tensor import Replicate, Shard
    new = new.redistribute(placements=[
        p if p == Shard(0) else Shard(p.dim - 1)
        if isinstance(p, Shard) and p.dim > 1 else Replicate()
        for p in cache.placements])
    local, part = cache.to_local(), new.to_local()
    b = torch.arange(local.shape[0], device=local.device)
    local[b, slot.to_local()[:local.shape[0]] % local.shape[1]
          if isinstance(slot, _dtensor()) else
          slot[:local.shape[0]] % local.shape[1]] = part


def einsum(eq: str, *ops):
    """``torch.einsum`` over DTensors.  For each mesh dimension the index
    that the largest operand is sharded on there wins: every operand that
    has that index is sharded on it, the others replicated, and the
    result is sharded on it, or summed over the shards (all-reduced)
    where it is contracted.  The product then runs shard by shard, so no
    collective runs but those layouts take: over a sequence-sharded
    cache that is flash-decoding's combine, which the reference's
    ``attn_hints_seq`` asks XLA for.  (DTensor's own einsum flattens
    indices into one batched-matmul dimension, which the DTensor of
    older torch cannot shard over two mesh dimensions.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    eq = eq.replace(" ", "")
    if "..." in eq or "->" not in eq:
        return NotImplemented
    lhs, out = eq.split("->")
    ins = lhs.split(",")
    mesh = next(o for o in ops if isinstance(o, DTensor)).device_mesh
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    order = sorted(range(len(ops)), key=lambda i: -ops[i].numel())
    in_pl = [[Replicate()] * mesh.ndim for _ in ops]
    grad_pl = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = [Replicate()] * mesh.ndim
    for m in range(mesh.ndim):
        idx = next((ins[i][ops[i].placements[m].dim] for i in order
                    if isinstance(ops[i].placements[m], Shard)), None)
        if idx is None:
            continue
        for pl, gl, spec in zip(in_pl, grad_pl, ins):
            # an operand replicated beside a sharded index gets a partial
            # gradient from each shard
            pl[m] = Shard(spec.index(idx)) if idx in spec else Replicate()
            gl[m] = pl[m] if idx in spec else Partial()
        out_pl[m] = Shard(out.index(idx)) if idx in out else Partial()
    y = local_map(functools.partial(torch.einsum, eq), out_placements=out_pl,
                  in_placements=tuple(in_pl),
                  in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                  redistribute_inputs=True)(*ops)
    return _summed(y)


def _summed(y):
    """``y`` with its partial results over the mesh reduced (all-reduced):
    a reduction over a sharded dimension stays small and replicated
    (left partial, DTensor may reduce-scatter it onto the batch and then
    move the full-width operands of its backward to match)."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in y.placements):
        return y
    return y.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in y.placements])


def _reduce_args(x, dim):
    return isinstance(dim, int) and _sharded_on(x, dim)


def softmax(x, dim=None, *rest, dtype=None, **kwargs):
    """``softmax`` as its max and sum reductions: over a sharded dimension
    they reduce over the shards (DTensor's own softmax gathers the
    dimension), and on any DTensor its backward is that of ``exp``, sum
    and division (DTensor propagates ``_softmax_backward_data`` through
    fake tensors of the mesh's device type, which a host without CUDA
    cannot make)."""
    if not isinstance(dim, int) or dtype is not None:
        return NotImplemented
    e = (x - _summed(x.amax(dim, keepdim=True))).exp()
    return e / _summed(e.sum(dim, keepdim=True))


def logsumexp(x, dim, keepdim=False):
    """``logsumexp`` over a sharded dimension: ``jax.nn.logsumexp``'s max
    and sum, each a reduction of the shards."""
    if not _reduce_args(x, dim):
        return NotImplemented
    top = _summed(x.amax(dim, keepdim=True)).detach()
    y = top + _summed((x - top).exp().sum(dim, keepdim=True)).log()
    return y if keepdim else y.squeeze(dim)


def gather(x, dim, index, *, sparse_grad=False):
    """``x.gather(dim, index)`` of one element along a sharded dimension
    (the loss's label logit over a sharded vocab) as a masked sum over the
    shards (DTensor's own gathers ``x``, and its backward the gradient)."""
    if not _reduce_args(x, dim) or index.shape[dim] != 1:
        return NotImplemented
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    cols = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    return _summed(torch.where(cols == index, x, 0.0).sum(dim, keepdim=True))


def _groups(old, new):
    """The dimension groups of a reshape of ``old`` into ``new``: pairs of
    (old dims, new dims) whose sizes have one product."""
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        gi, gj, a, b = [i], [j], old[i], new[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= old[i]
                gi.append(i)
                i += 1
            else:
                b *= new[j]
                gj.append(j)
                j += 1
        groups.append((gi, gj))
    return groups


def reshape_placements(x, new):
    """``x``'s placements with those gathered that a reshape into ``new``
    cannot keep (DTensor raises, or shards the result unevenly):
    a sharded dimension merged behind another, or split into dimensions
    the first of which its mesh dimensions do not divide (4 KV heads over
    a model axis of 16, where XLA shards both parts)."""
    from torch.distributed.tensor import Replicate, Shard
    old = tuple(x.shape)
    sizes = x.device_mesh.mesh.shape
    pl = list(x.placements)
    for gi, gj in _groups(old, new):
        gi = [k for k in gi if old[k] > 1] or gi[:1]
        gj = [k for k in gj if new[k] > 1] or gj[:1]
        if len(gi) == len(gj) == 1:
            continue
        for d in gi:
            mdims = [m for m, p in enumerate(pl)
                     if isinstance(p, Shard) and p.dim == d]
            split = math.prod(sizes[m] for m in mdims)
            if mdims and (d != gi[0] or new[gj[0]] % split):
                for m in mdims:
                    pl[m] = Replicate()
    return pl


def reshape(x, *shape):
    """``reshape`` of a DTensor, its placements first made such that the
    reshape can keep them (``reshape_placements``)."""
    if not isinstance(x, _dtensor()):
        return NotImplemented
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    shape = tuple(int(n) for n in shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    pl = reshape_placements(x, shape)
    if pl != list(x.placements):
        x = x.redistribute(placements=pl)
    return x.reshape(shape)


def _matmul(x, w):
    if not isinstance(w, _dtensor()) or w.ndim != 2:
        return NotImplemented
    return tp_matmul(x, w)


def _getitem(w, idx):
    if (w.ndim != 2 or not isinstance(idx, torch.Tensor)
            or idx.is_floating_point() or idx.dtype == torch.bool):
        return NotImplemented
    return embed(w, idx)


def _setitem(cache, idx, new):
    if not (isinstance(cache, _dtensor()) and cache.ndim >= 3
            and isinstance(idx, tuple) and len(idx) == 2
            and all(isinstance(i, torch.Tensor) and i.ndim == 1
                    and i.shape[0] == cache.shape[0]
                    and not i.is_floating_point() for i in idx)):
        return NotImplemented
    write_rows(cache, idx[1], new)
    return None


RULES = {
    torch.Tensor.__matmul__: _matmul, torch.matmul: _matmul,
    torch.Tensor.matmul: _matmul,
    torch.Tensor.__getitem__: _getitem,
    torch.Tensor.__setitem__: _setitem,
    torch.einsum: einsum,
    torch.softmax: softmax, torch.Tensor.softmax: softmax,
    F.softmax: softmax,
    torch.logsumexp: logsumexp, torch.Tensor.logsumexp: logsumexp,
    torch.gather: gather, torch.Tensor.gather: gather,
    torch.reshape: reshape, torch.Tensor.reshape: reshape,
}
