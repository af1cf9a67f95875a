"""Rank functions for ``tests/test_torch_dist.py``: each runs in a process
that ``repro_torch.launch.dist.spawn`` starts in a Gloo group on the CPU.
This module imports only torch and the port, and the same functions
compute the logical axis's values in the test process, so both sides
run one piece of code.
"""
import hashlib
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.comm.codecs import make_codec
from repro_torch.comm.transport import (SCHEDULES, compressed_allreduce_ef,
                                        pad_for_schedule)
from repro_torch.configs import get_config
from repro_torch.core.allreduce import make_allreduce
from repro_torch.core.collectives import DistAxis, LogicalAxis
from repro_torch.core.compression import Compressor
from repro_torch.core.precision import FP32
from repro_torch.core.tree import tree_map
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train import (Strategy, Trainer, TrainState,
                               make_bucketed_allreduce,
                               make_sharded_train_step, make_train_step,
                               train_loop, value_and_grad)
from repro_torch.train.strategy import fit

CODEC_TOPOLOGIES = ("ring", "butterfly", "tree", "fully_connected")
CODEC_METHODS = ("onebit", "dgc", "terngrad", "qsgd")
SUBGROUPS = (2, 3, 4)            # worker counts below the world size
RECIPE = dict(lr=0.01, bucket_mb=0.25)
# the 4-rank engine cells: (spec, wire)
ENGINE_CELLS = (("bsp/allreduce/none@4", "modeled"),
                ("bsp/allreduce/onebit@4", "modeled"),
                ("bsp/ring/onebit@4", "measured"),
                ("bsp/ring/dgc@4", "measured"),
                ("bsp/ring/terngrad@4", "measured"),
                ("bsp/ps/none@4", "modeled"),
                ("bsp/ps/onebit@4", "modeled"),
                ("bsp/ps/onebit@4", "measured"),
                ("bsp/ps/dgc@4", "measured"),
                ("bsp/ps/qsgd@4", "measured"),
                ("bsp/ps/terngrad@4", "modeled"),
                ("bsp/ps/terngrad@4", "measured"),
                ("ssp:2/allreduce/onebit@4", "modeled"),
                ("ssp:2/ps/dgc@4", "modeled"),
                ("asp/allreduce/none@4", "modeled"),
                ("asp/ps/onebit@4", "modeled"),
                ("sma/allreduce/none@4", "modeled"),
                ("sma/allreduce/none@4", "measured"),
                ("bsp+backup:1/allreduce/onebit@4", "modeled"),
                ("bsp+backup:1/ring/onebit@4", "measured"),
                ("bsp+backup:1+detect/allreduce/onebit@4", "modeled"))
ENGINE_STEPS = 2
# detection warms up over two observations per worker (the first is
# discarded), so its drop set moves to the sleeping worker at step 2;
# the sleep is ten times a scheduling stall of another worker's fetch
DETECT = dict(steps=3, worker=1, sleep_s=0.5)
SHARDED = dict(workers=4, steps=3, bucket_mb=0.25, lr=0.01,
               schedule=(3e-3, 1, 3))
# the elastic cells over 4 ranks: (spec, wire, plan, steps, snapshot
# cadence); the third is the ssp:2/ring/onebit@4 acceptance plan
ELASTIC_CELLS = (
    ("bsp/allreduce/none@4", "modeled", "crash:w1@4,resize:4@5", 6, 3),
    ("bsp/allreduce/onebit@4", "modeled", "restart@3", 6, 3),
    ("ssp:2/ring/onebit@4", "modeled", "crash:w2@5,resize:4@10", 12, 3),
    ("sma/allreduce/none@4", "modeled", "resize:2@2,resize:4@4", 6, 3),
    ("bsp/ps/onebit@4", "measured", "resize:2@2,resize:4@4", 6, 3))
# the cells a process group refuses: the simulator has no ranks
REFUSALS = {
    "sim": ("bsp/allreduce/none@4", {"backend": "sim"}, "device backend"),
}
# the hybrid engine's elastic interface (test_torch_hybrid.py's
# RESTART_SPECS: (spec, plan)); the 4-device cells run over this file's
# 4-rank elastic spawn, the 8-device ones over test_torch_hybrid.py's
# 8-rank spawn
RESTART_SPECS = (("bsp/ring/onebit@8:d2.t2.s2.m4.1f1b.adamw", "restart@2"),
                 ("bsp/ps/none@8:d2.t2.s2.z1.qmom.adamw", "restart@2"),
                 ("bsp/ps/onebit@4:d4.z3", "restart@2"),
                 ("bsp/ps/none@4:d2.s2.z2.adamw", "crash:w1@3,resize:4@4"))
# and two resizes that move EF blocks across ranks: ZeRO-3 shards with
# onebit's EF, and z0 AdamW trees on a tensor axis (a grown slot takes
# slot 0's blocks)
RESHARD_SPECS = (("bsp/ps/onebit@4:d4.z3", "crash:w1@3,resize:4@4"),
                 ("bsp/ring/onebit@4:d2.t2.adamw", "crash:w2@3,resize:4@4"))
# their runs: make_tiny_transformer(4, 8, 16, seed=3), slot w's batch x_w
# (seeded 5) at every step, y = tanh(x); lr, steps, snapshot cadence
RESTART_RUN = dict(lr=0.02, steps=6, every=2)


def padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, L] zero-padded to the codec schedules' length."""
    n, L = x.shape
    out = x.new_zeros((n, pad_for_schedule(L, n)))
    out[:, :L] = x
    return out


def axis_cases(x: torch.Tensor, ax) -> dict:
    """Every exact schedule, every codec exchange (``compressed_allreduce
    _ef``, generator seeded 11), ``make_allreduce`` and ``psum_scatter``
    over ``ax``, on the rows of ``x`` [n, L] that ``ax`` holds.  A
    schedule that refuses the worker count gives its error text."""
    n = ax.size
    mine = x[ax.ids]
    out = {}
    for name, fn in SCHEDULES.items():
        try:
            out["sched/" + name] = fn(mine.clone(), ax)
        except ValueError as e:        # butterfly and tree at n = 3
            out["sched/" + name] = str(e)
    if n & (n - 1) == 0:
        flat = padded(x)[ax.ids]
        ef = 0.1 * flat.flip(1)
        for topo in CODEC_TOPOLOGIES:
            for m in CODEC_METHODS:
                gen = torch.Generator().manual_seed(11)
                out[f"codec/{topo}/{m}"] = compressed_allreduce_ef(
                    flat.clone(), ef.clone(), topo, make_codec(m), gen,
                    gain=1.5 if m == "onebit" else 1.0, axis=ax)
        tree = {"a": mine[:, :15].reshape(-1, 3, 5),
                "b": mine[:, 15:22].to(torch.float64)}
        for topo in SCHEDULES:
            out["allreduce/" + topo] = make_allreduce(topo, axis=ax)(tree)
    contrib = padded(x)[ax.ids].reshape(len(ax.ids), n, -1)
    if isinstance(ax, DistAxis):
        # what a rank receives: the all-to-all's n chunks against the
        # all-gather of every worker's whole contribution
        before = ax.recv_bytes
        out["psum_scatter"] = ax.psum_scatter(contrib)
        mid = ax.recv_bytes
        ax.all_gather(contrib)
        out["recv_bytes"] = (mid - before, ax.recv_bytes - mid)
    else:
        out["psum_scatter"] = ax.psum_scatter(contrib)
    return out


def _model():
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, batch_size=2))
    return model, grad_fn, batches


def _leaves(model, params):
    return [t.clone() for t in model.leaf_layout(params).leaves(params)]


def digest(tensors) -> list:
    """Each tensor's bytes as a hash: bit-for-bit equality, small enough
    to come back from every rank for every cell."""
    return [hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                           .tobytes()).hexdigest()[:16] for t in tensors]


class _SlowWorker:
    """A batch source whose fetch sleeps for one worker: the straggler
    that detection must find."""

    def __init__(self, batches, worker: int, seconds: float):
        self.batches, self.worker, self.seconds = batches, worker, seconds

    def __call__(self, t, w):
        if w == self.worker:
            time.sleep(self.seconds)
        return self.batches(t, w)


def engine_cell(spec: str, wire: str, params, group=None, steps=None):
    """``spec`` through ``Strategy.build`` and the fit loop of
    ``Trainer.fit`` on the CPU, one worker per rank of ``group`` or every
    worker logical: (history, digests of the parameter leaves, wire
    bytes, digests of each held worker's EF row, one list per row)."""
    model, grad_fn, batches = _model()
    if "+detect" in spec:
        batches = _SlowWorker(batches, DETECT["worker"], DETECT["sleep_s"])
        steps = steps or DETECT["steps"]
    strat = Strategy.parse(spec, wire=wire, **RECIPE)
    engine = strat.build(grad_fn, model.leaf_layout(params), device="cpu",
                         group=group)
    ef = []
    finalize = engine.finalize

    def keep_ef(st):
        ef.extend(st["ef"] or [])
        return finalize(st)

    engine.finalize = keep_ef
    out, hist, mets = fit(engine, params, batches, steps or ENGINE_STEPS)
    return (hist, digest(_leaves(model, out)), mets["wire_bytes"],
            [digest(row) for row in ef])


def sharded_run(params, axis=None):
    """``make_sharded_train_step`` (AdamW, onebit, cosine) over the
    workers ``axis`` gives this process (all of them by default):
    (history, parameter leaves, EF leaves [k, ...])."""
    model, _, batches = _model()
    K = SHARDED["workers"]
    layout = model.leaf_layout(params)
    comp, opt = Compressor("onebit"), AdamW(SHARDED["lr"])
    reduce_fn = make_bucketed_allreduce(params, topology="ring",
                                        bucket_mb=SHARDED["bucket_mb"],
                                        layout=layout)
    step = make_train_step(model.loss_fn, opt,
                           cosine_warmup(*SHARDED["schedule"]),
                           precision=FP32, compressor=comp,
                           reduce_fn=reduce_fn, layout=layout)
    state = TrainState.create(params, opt, comp, layout)
    rows = len(axis.ids) if axis is not None else K
    state["ef"] = [torch.zeros((rows,) + e.shape) for e in state["ef"]]
    sharded = make_sharded_train_step(step, K, compressed=True, axis=axis)

    def stacked(t):
        return tree_map(lambda *xs: torch.stack(xs),
                        *[batches(t, w) for w in range(K)])

    state, hist = train_loop(sharded, state, stacked, SHARDED["steps"],
                             log_every=1)
    for h in hist:
        del h["wall_s"]
    return hist, _leaves(model, state["params"]), state["ef"]


class _KeepEF:
    """A Strategy whose engines keep the EF rows they finalize with (the
    rows this process holds), for ``Trainer.fit`` runs that build the
    engine themselves."""

    def __init__(self, strat):
        self.strat, self.ef = strat, []

    def __getattr__(self, name):
        return getattr(self.strat, name)

    def build(self, *args, **kw):
        engine = self.strat.build(*args, **kw)
        finalize = engine.finalize

        def keep_ef(st):
            self.ef.extend(st["ef"] or [])
            return finalize(st)

        engine.finalize = keep_ef
        return engine


def manifests(ckpt_dir: str) -> dict:
    """Every committed snapshot's manifest in ``ckpt_dir``, by name."""
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name, "manifest.json")
        if name.startswith("step_") and os.path.isfile(path):
            with open(path) as f:
                out[name] = json.load(f)
    return out


def elastic_cell(spec: str, wire: str, plan: str, steps: int, every: int,
                 params, ckpt_dir: str, group=None):
    """``Trainer.fit(plan=)`` of ``spec`` on the CPU, over ``group`` or
    logical: (history, digests of the parameters, wire bytes, digests of
    each held worker's final EF row, the recoveries without their walls,
    the final worker count, the snapshots' manifests; these last on the
    writer only)."""
    model, grad_fn, batches = _model()
    strat = _KeepEF(Strategy.parse(spec, wire=wire, **RECIPE))
    out, hist, mets = Trainer(strat, device="cpu", group=group).fit(
        grad_fn, params, batches, steps, layout=model.leaf_layout(params),
        plan=plan, checkpoint_dir=ckpt_dir, checkpoint_every=every)
    recs = [{k: v for k, v in r.items() if k != "wall_s"}
            for r in mets["recoveries"]]
    writer = group is None or dist.get_rank(group) == 0
    return (hist, digest(_leaves(model, out)), mets["wire_bytes"],
            [digest(row) for row in strat.ef], recs, mets["final_workers"],
            manifests(ckpt_dir) if writer else None)


def elastic_rank(rank, world, dev, params, ckpt_root):
    """Spawn C: the elastic cells over the 4-rank world, each writing its
    snapshots (rank 0) under ``ckpt_root``, then the 4-device hybrid
    elastic cells."""
    group = dist.group.WORLD
    hybrid = restart_inputs()
    return {"cells": {cell[:3]: elastic_cell(
        *cell, params, os.path.join(ckpt_root, f"cell{i}"), group)
        for i, cell in enumerate(ELASTIC_CELLS)},
        "hybrid": {cell: hybrid_elastic_cell(
            *cell, hybrid, os.path.join(ckpt_root, f"hybrid{i}"), group)
            for i, cell in enumerate(restart_cells(world))},
        "refusals": {name: _refusal(name, params, group)
                     for name in REFUSALS}}


def _refusal(name: str, params, group) -> str:
    """The error a process group gets for one unported cell (its text),
    or "no error": the simulator's refusal of a group."""
    spec, kw, _ = REFUSALS[name]
    model, grad_fn, batches = _model()
    layout = model.leaf_layout(params)
    strat = Strategy.parse(spec, **kw, **RECIPE)
    try:
        strat.build(grad_fn, layout, device="cpu", group=group)
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


# ------------------------------------- the hybrid engine's elastic cells
def restart_inputs():
    """RESTART_SPECS' inputs as ``hybrid_elastic_cell`` takes them: the
    params and the per-slot batch arrays x, y [steps, slots, B, d] (one
    step: every step reads the same batches)."""
    from repro_torch.parallel import make_tiny_transformer
    params, _ = make_tiny_transformer(4, 8, 16, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(5)
    xs = torch.stack([torch.randn(8, 8, generator=gen)
                      for _ in range(4)])[None]
    return params, xs, torch.tanh(xs)


def restart_cells(n: int):
    """The RESTART_SPECS and RESHARD_SPECS cells of ``n`` devices, as
    ``hybrid_elastic_cell`` takes them: (spec, plan, steps, snapshot
    cadence, lr)."""
    run = RESTART_RUN
    return tuple((spec, plan, run["steps"], run["every"], run["lr"])
                 for spec, plan in RESTART_SPECS + RESHARD_SPECS
                 if int(spec.split("@")[1].split(":")[0]) == n)


def hybrid_elastic_cell(spec: str, plan: str, steps: int, every: int,
                        lr: float, inputs, ckpt_dir: str, group=None):
    """``Trainer.fit(plan=)`` of a hybrid ``spec`` on the CPU, over
    ``group`` (one mesh device per rank) or logical.  ``inputs`` is
    (params, x, y [steps, slots, B, d]); slot w reads the arrays at (t,
    w) modulo their counts.  Returns (history, final parameters, wire
    bytes, the recoveries without their walls, resizes, the final worker
    count, the snapshots' manifests; these last on the writer only)."""
    from repro_torch.parallel import make_tiny_transformer
    params, xs, ys = inputs
    layers = next(iter(params.values())).shape[0]
    _, model = make_tiny_transformer(layers, 8, 16, device="cpu")

    def batches(t, w):
        t, w = t % xs.shape[0], w % xs.shape[1]
        return {"x": xs[t, w], "y": ys[t, w]}

    strat = Strategy.parse(spec, lr=lr, bucket_mb=HYBRID["bucket_mb"])
    out, hist, mets = Trainer(strat, device="cpu", group=group).fit(
        model, params, batches, steps, plan=plan, checkpoint_dir=ckpt_dir,
        checkpoint_every=every)
    recs = [{k: v for k, v in r.items() if k != "wall_s"}
            for r in mets["recoveries"]]
    writer = group is None or dist.get_rank(group) == 0
    return (hist, out, mets["wire_bytes"], recs, mets["resizes"],
            mets["final_workers"], manifests(ckpt_dir) if writer else None)


# ------------------------------------------------------------ the ranks
def jax_cell(spec: str, params, group):
    """An 8-worker cell of the JAX engine's through ``Trainer.fit`` over
    ``group``: (losses, parameter leaves, wire bytes)."""
    model, grad_fn, batches = _model()
    strat = Strategy.parse(spec, **RECIPE)
    out, hist, mets = Trainer(strat, device="cpu", group=group).fit(
        grad_fn, params, batches, ENGINE_STEPS,
        layout=model.leaf_layout(params))
    return [h["loss"] for h in hist], _leaves(model, out), mets["wire_bytes"]


def axis_rank(rank, world, dev, x, params, specs):
    """Spawn A: ``axis_cases`` on the world and on sub-groups of the first
    2, 3 and 4 ranks, then ``specs`` (8-worker cells) through the engine
    over the world."""
    out = {}
    for k in (world,) + SUBGROUPS:
        group = (dist.group.WORLD if k == world
                 else dist.new_group(list(range(k))))
        if rank < k:
            out[k] = axis_cases(x[:k], DistAxis(group, "gloo"))
    out["engine"] = {spec: jax_cell(spec, params, dist.group.WORLD)
                     for spec in specs}
    return out


def engine_rank(rank, world, dev, params):
    """Spawn B: the 4-rank engine cells and the sharded step."""
    group = dist.group.WORLD
    ax = DistAxis(group, "gloo")
    return {"cells": {(spec, wire): engine_cell(spec, wire, params, group)
                      for spec, wire in ENGINE_CELLS},
            "sharded": sharded_run(params, ax)}


def logical_cases(x: torch.Tensor) -> dict:
    """The logical axis's side of ``axis_rank``'s exchanges."""
    return {k: axis_cases(x[:k], LogicalAxis(k))
            for k in (x.shape[0],) + SUBGROUPS}


# ------------------------------------------------------ the hybrid mesh
HYBRID = dict(lr=0.05, bucket_mb=1e-4, steps=3)
# (spec, wire, model): every cell of test_torch_hybrid.py's SPECS and
# EXTRA_SPECS; "tiny4" is the 4-layer model of its schedule cells (1F1B
# at v2 needs two layers per stage), with one batch for every slot
HYBRID_CELLS = (
    ("bsp/ring/onebit@8:d2.t2.s2", "modeled", "tiny2"),
    ("bsp/ps/none@4:d4.z3.adamw", "modeled", "tiny2"),
    ("bsp/allreduce/none@4:d4.t1.s1", "modeled", "tiny2"),
    ("bsp/ring/none@8:d2.t2.s2.m8.1f1b", "modeled", "tiny4"),
    ("bsp/ps/none@8:z2.qmom.adamw", "modeled", "tiny2"),
    ("ssp:2/ring/onebit@4:d2.t2", "modeled", "tiny2"),
    ("bsp/tree/dgc:0.05@8:d4.s2.bf16r", "modeled", "tiny2"),
    ("bsp/ring/onebit@8:d2.t2.s2", "measured", "tiny2"),
    ("bsp/ps/onebit@8:d2.t2.s2.z1.adamw", "measured", "tiny2"),
    ("bsp/ps/onebit@8:d2.t2.s2.z3", "measured", "tiny2"),
    ("bsp/ps/dgc:0.05@4:d2.s2.z2", "measured", "tiny2"),
    ("bsp/ps/none@8:d2.t2.s2.z1.adamw", "modeled", "tiny2"),
    ("bsp/ps/none@8:d2.t2.s2.z2.adamw", "modeled", "tiny2"),
    ("bsp/ps/none@4:d4.z2.qmom.adamw", "modeled", "tiny2"),
    ("bsp/ring/none@8:d2.t2.s2.bf16r", "modeled", "tiny2"),
    ("bsp/ring/none@8:d2.t2.s2.m4.1f1b.v1.bf16", "modeled", "tiny2"),
    ("asp/ring/none@4:d2.t2", "modeled", "tiny2"),
    ("sma/ring/none@4:d2.t2", "modeled", "tiny2"),
    ("bsp/ring/none@8:d2.t2.s2.m8.1f1b.v1", "modeled", "tiny4"))


def hybrid_cell(spec: str, wire: str, model_key: str, inputs, group=None):
    """One hybrid cell through ``Strategy.build(...).run`` on the CPU,
    over ``group`` (one mesh device per rank) or logical: (history,
    final parameters, wire bytes, the state bytes a device holds after
    ``init``).  ``inputs[model_key]`` is (params, batch arrays x, y
    [steps, slots, B, d]); slot w reads slots' arrays at w mod their
    count."""
    from repro_torch.parallel import make_tiny_transformer
    params, xs, ys = inputs[model_key]
    layers = next(iter(params.values())).shape[0]
    _, model = make_tiny_transformer(layers, 8, 16, device="cpu")

    def batches(t, w):
        t, w = t % xs.shape[0], w % xs.shape[1]
        return {"x": xs[t, w], "y": ys[t, w]}

    strat = Strategy.parse(spec, lr=HYBRID["lr"],
                           bucket_mb=HYBRID["bucket_mb"], backend="device",
                           wire=wire)
    engine = strat.build(model, device="cpu", group=group)
    state = (engine.inner.per_device_state_bytes(engine.init(params))
             if hasattr(engine.inner, "per_device_state_bytes") else None)
    p, hist, nbytes = engine.run(params, batches, HYBRID["steps"])
    return hist, p, nbytes, state


def hybrid_rank(rank, world, dev, inputs, cells, elastic=(),
                ckpt_root=None):
    """Spawn D: the hybrid cells over the world or the group of its
    first 4 ranks (ranks past a cell's mesh sit it out), then the
    ``elastic`` cells ((``hybrid_elastic_cell``'s cell, ``inputs`` key)),
    each writing its snapshots (rank 0) under ``ckpt_root``."""
    from repro_torch.launch.dist import mesh_ladder, prefix_group
    groups = {world: dist.group.WORLD, 4: prefix_group(4)}
    # every rank builds the 4-rank meshes' groups (a mesh's and those of
    # every mesh it can resize into), as the ranks that run them do, in
    # the same order
    for spec in [c[0] for c in cells] + [c[0][0] for c in elastic]:
        strat = Strategy.parse(spec)
        m = strat.mesh_spec
        if strat.is_hybrid and m.size < world:
            mesh_ladder(m.data, m.tensor, m.stage, ranks=range(m.size))
    out = {}
    for spec, wire, key in cells:
        n = int(spec.split("@")[1].split(":")[0])
        if groups[n] is not None:
            out[spec, wire, key] = hybrid_cell(spec, wire, key, inputs,
                                               groups[n])
    for i, (cell, key) in enumerate(elastic):
        n = int(cell[0].split("@")[1].split(":")[0])
        if groups[n] is not None:
            out[cell] = hybrid_elastic_cell(
                *cell, inputs[key], os.path.join(ckpt_root, f"elastic{i}"),
                groups[n])
    return out


# ------------------------------------------- tensor-parallel serving
# tests/test_torch_tp.py's engine cells: (traffic, page size, slots,
# max_len); traffic is [(prompt, max_new_tokens, arrival)]
TP_DEGREE = 2


def _tp_model():
    cfg = get_config("tinyllama-1.1b").reduced()
    return cfg, build_model(cfg)


def tp_serve(params, traffic, page_size, slots, max_len, group=None):
    """``traffic`` through ``ServeEngine`` at tp=2 in fp32 on the CPU,
    logical or one tensor rank per process of ``group``: (each request's
    tokens, every decode iteration's logits, the metrics without the
    wall, the cache bytes this process holds)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    _, model = _tp_model()
    logits = []
    step = T.decode_step

    def recording(*a, **kw):
        lg, caches = step(*a, **kw)
        logits.append(lg.clone())
        return lg, caches

    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=n, arrival=a)
            for i, (p, n, a) in enumerate(traffic)]
    eng = ServeEngine(model, params, ServeConfig(
        slots=slots, max_len=max_len, page_size=page_size, tp=TP_DEGREE),
        device="cpu", group=group)
    T.decode_step = recording
    try:
        m = eng.run(reqs)
    finally:
        T.decode_step = step
    m.pop("wall_s")
    return [r.output for r in reqs], logits, m, eng.cache_bytes()


def tp_forced(params, tokens, s0, steps, max_len, axis=None):
    """Teacher-forced tp=2 decode logits [steps, B, V] after a prefill of
    ``tokens[:, :s0]``, through ``decode_step`` with the ``TPContext``'s
    shards (logical, or this rank's over ``axis``)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.tp import TPContext
    cfg, _ = _tp_model()
    f32 = dict(compute_dtype=torch.float32)
    _, st = T.prefill(params, cfg, tokens[:, :s0], **f32)
    ctx = TPContext(cfg, TP_DEGREE, axis)
    caches = ctx.shard_cache(T.cache_from_prefill(cfg, st, max_len,
                                                  torch.float32))
    shards = ctx.shard_params(params)
    out = []
    for s in range(steps):
        lg, caches = T.decode_step(
            shards, ctx.cfg_local, caches, tokens[:, s0 + s:s0 + s + 1],
            torch.full((tokens.shape[0],), s0 + s), tp_axis=ctx.tp_axis,
            **f32)
        out.append(lg[:, 0])
    return torch.stack(out)


def tp_launcher(argv, group=None):
    """``repro_torch.launch.serve.main(argv)`` in this process (over
    ``group``, already joined): (what it printed, its metrics)."""
    import contextlib
    import io
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m = main(argv, group=group)
    return buf.getvalue(), m


def tp_refusal(params, group) -> str:
    """The error an engine at tp=4 over the 2-rank group gets."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    _, model = _tp_model()
    try:
        ServeEngine(model, params, ServeConfig(tp=4), device="cpu",
                    group=group)
    except ValueError as e:
        return str(e)
    return "no error"


def tp_rank(rank, world, dev, params, cells, forced, argv):
    """The tp spawn: ``tp_serve`` of each cell, ``tp_forced``, the
    launcher and a tp the group's size refuses, over the 2-rank world."""
    group = dist.group.WORLD
    return {"cells": {name: tp_serve(params, *cell, group=group)
                      for name, cell in cells.items()},
            "forced": tp_forced(params, *forced,
                                axis=DistAxis(group, "gloo")),
            "launcher": tp_launcher(argv + ["--dist-backend", "gloo"],
                                    group),
            "refusal": tp_refusal(params, group)}
