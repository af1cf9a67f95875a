"""Rank functions for ``tests/test_torch_dist.py``: each runs in a process
that ``repro_torch.launch.dist.spawn`` starts in a Gloo group on the CPU.
This module imports only torch and the port, and the same functions
compute the logical axis's values in the test process, so both sides
run one piece of code.
"""
import hashlib
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
# the cells and methods a process group refuses, and the ROADMAP item
# each names
REFUSALS = {
    "hybrid": ("bsp/ps/none@4:d4.z3.adamw", {}, "9e"),
    "sim": ("bsp/allreduce/none@4", {"backend": "sim"}, "device backend"),
    "plan": ("bsp/allreduce/none@4", {}, "9d"),
    "reshard": ("bsp/allreduce/none@4", {}, "9d"),
    "export_state": ("bsp/allreduce/none@4", {}, "9d"),
    "import_state": ("bsp/allreduce/none@4", {}, "9d"),
}


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
    out["psum_scatter"] = ax.psum_scatter(
        padded(x)[ax.ids].reshape(len(ax.ids), n, -1))
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


def _refusal(name: str, params, group) -> str:
    """The error a process group gets for one unported cell or method
    (its text), or "no error"."""
    spec, kw, _ = REFUSALS[name]
    model, grad_fn, batches = _model()
    layout = model.leaf_layout(params)
    strat = Strategy.parse(spec, **kw, **RECIPE)
    try:
        if name == "plan":
            Trainer(strat, device="cpu", group=group).fit(
                grad_fn, params, batches, 2, layout=layout,
                plan="crash:w1@1")
        else:
            engine = strat.build(grad_fn, layout, device="cpu", group=group)
            if name in ("reshard", "export_state", "import_state"):
                st = engine.init(params)
                if name == "reshard":
                    engine.reshard(st, 2)
                elif name == "export_state":
                    engine.export_state(st)
                else:
                    engine.import_state({"ef": None, "params": params}, {})
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


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
    """Spawn B: the 4-rank engine cells, the sharded step and the
    refusals."""
    group = dist.group.WORLD
    ax = DistAxis(group, "gloo")
    return {"cells": {(spec, wire): engine_cell(spec, wire, params, group)
                      for spec, wire in ENGINE_CELLS},
            "sharded": sharded_run(params, ax),
            "refusals": {name: _refusal(name, params, group)
                         for name in REFUSALS}}


def logical_cases(x: torch.Tensor) -> dict:
    """The logical axis's side of ``axis_rank``'s exchanges."""
    return {k: axis_cases(x[:k], LogicalAxis(k))
            for k in (x.shape[0],) + SUBGROUPS}
