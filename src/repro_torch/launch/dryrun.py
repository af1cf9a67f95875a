"""The dry-run (the JAX package's ``launch/dryrun.py``): every (architecture
x input shape x mesh) pair built at full width, its per-device bytes under
the production meshes' specs, its cost by a layer probe, and, on the card,
its step run at its production lengths.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--device meta]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --probe

Writes JSON records to results/dryrun_torch/<arch>__<shape>__<mesh>*.json.

The reference lowers and compiles each pair for the 16 x 16 and 2 x 16 x 16
meshes.  The port has no compiler: a pair is built on the ``meta`` device
(shapes, no storage), so its per-device bytes come from the same specs
(``launch.specs``), its cost from counting the step's operations there
(``launch.cost``), and its collectives from running the step on DTensors
with those specs over a fake process group of the mesh's size
(``launch.spmd``): the per-device record of the reference's
``collective_bytes``, the five kinds and ``traffic_weighted``.  A pair
whose step DTensor cannot partition yet records ``"collectives": null``
and the op in ``collectives_error``.

  build_dryrun  the step and its inputs, and the reference's ``info``:
                ``params_analytic``, ``param_bytes_per_device``,
                ``cache_bytes_per_device`` (decode), ``batch_sharded``,
                ``optimizer``, ``window_override``.
  probe_pair    the cost and collectives at 1 and 2 layer groups of the
                full-width model, extrapolated to the full depth as the
                reference does (``base + mult * body``, ``mult = groups +
                tail / pattern``).  With ``device="cuda"`` it also times
                the two depths on the card and extrapolates the times the
                same way.
  run_pair      the full-depth step's collectives, and the step on the
                card, where the weights, state, cache and activations fit
                by the byte count made on meta before the run
                (``MetaMemory``); elsewhere ``status: "exceeds_card"``
                with that count.

The card runs the pair's per-data-shard batch (``global_batch / 16``, at
least 1); where one card cannot hold it, the batch is cut and the cut is
listed in the record's ``reduced``.  A pair that fails writes a ``status:
"error"`` record, as in the reference.

Not ported: ``--moe-hints`` and the XLA hints of the ``attn_hints*``
cache policies (requests to XLA's partitioner; the policies' spec side
is ported, and the decode attention partitions as ``attn_hints_seq``
asks whatever the policy: ``launch.spmd.einsum``), and ``--unrolled``
(the port has no scan to unroll; the flag is accepted for the
reference's command line and does nothing).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import statistics
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, SKIPS, get_config, get_shape
from repro_torch.core.parallelism import param_specs
from repro_torch.core.tree import get_path, leaf_paths
from repro_torch.kernels.backend import meta_as_card
from repro_torch.launch import spmd
from repro_torch.launch.cost import (CARD_WORKSPACE_BYTES, MetaMemory,
                                     count_cost)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (VOCAB_PAD, batch_shardable,
                                      cache_specs, decode_window,
                                      mesh_axis_sizes, train_input_specs)
from repro_torch.launch.steps import (choose_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import build_model

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DATA_SHARDS = 16            # the production meshes' data axis
CARD_SHARE = 0.8            # of the card's memory a run may plan to use
H100_BYTES = 80e9           # the card's memory, when no card is asked
BF16 = torch.bfloat16
SLOW_S = 10.0               # a warm step longer than this is timed once


def _sharded_bytes(tree, specs, mesh) -> float:
    """Per-device bytes of ``tree`` under ``specs``."""
    sizes = mesh_axis_sizes(mesh)
    total = 0.0
    for path in leaf_paths(tree):
        t, sp = get_path(tree, path), get_path(specs, path)
        denom = 1
        for ax in sp:
            for a in (ax if isinstance(ax, tuple) else
                      (() if ax is None else (ax,))):
                denom *= sizes.get(a, 1)
        total += t.numel() * t.element_size() / denom
    return total


def _inputs(cfg, shape, batch: int, device, gen):
    """The step's inputs at ``batch`` on ``device``: seeded tokens and
    frame / vision stubs on a card or the CPU, empty tensors on meta."""
    specs = train_input_specs(cfg, shape, batch)
    if torch.device(device).type == "meta":
        return {k: torch.empty_like(v) for k, v in specs.items()}
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32 and k == "positions":
            S = v.shape[-1]
            out[k] = torch.arange(S, device=device, dtype=torch.int32
                                  ).expand(v.shape).contiguous()
        elif v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                   device=device, dtype=torch.int32)
        else:
            out[k] = torch.randn(v.shape, generator=gen, device=device,
                                 dtype=torch.float32).to(v.dtype)
    return out


def _state(cfg, shape, batch: int, device, seed: int = 0, mark=None):
    """(step, args) of the pair at ``batch`` on ``device``: bf16 weights
    from ``seed`` (and the optimizer state) first, then the cache and
    inputs; ``mark()`` is called between the two (``MetaMemory``'s count
    of the weights)."""
    model = build_model(cfg)
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=dev).manual_seed(seed + 1)
    params = model.init(seed, dtype=BF16, device=dev,
                        vocab_pad_multiple=VOCAB_PAD)
    if shape.kind == "train":
        opt = choose_optimizer(cfg)
        opt_state = opt.init(params, layout=model.leaf_layout(params))
        mark and mark()
        return (make_train_step(model, opt, remat=True),
                (params, opt_state, _inputs(cfg, shape, batch, dev, gen)))
    mark and mark()
    if shape.kind == "prefill":
        b = _inputs(cfg, shape, batch, dev, gen)
        b.pop("labels")
        return make_prefill_step(model), (params, b)
    window = decode_window(cfg, shape)
    if cfg.is_encoder_decoder:
        caches = model.init_cache(batch, shape.seq_len, dtype=BF16,
                                  device=dev)
    else:
        caches = model.init_cache(batch, shape.seq_len, dtype=BF16,
                                  window_override=window, device=dev)
    tok = (torch.empty((batch, 1), dtype=torch.int32, device=dev)
           if gen is None else torch.randint(
               0, cfg.vocab_size, (batch, 1), generator=gen, device=dev,
               dtype=torch.int32))
    return (make_serve_step(model, window_override=window),
            (params, caches, tok, shape.seq_len - 1))


def build_dryrun(arch: str, shape_name: str, multi_pod: bool,
                 policy: str = "fsdp", cfg=None,
                 cache_policy: str = "auto", device="meta",
                 batch: Optional[int] = None):
    """Returns (mesh, step, args, info): the step and its arguments on
    ``device`` at ``batch`` (the global batch by default), and the
    reference's ``info`` from a meta build at the global batch."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg)
    p_meta = model.init(dtype=BF16, device="meta",
                        vocab_pad_multiple=VOCAB_PAD)
    pspecs = param_specs(p_meta, multi_pod=multi_pod, policy=policy)
    shard_b = batch_shardable(shape, mesh)
    info: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "params_analytic": cfg.param_count(),
        "active_params_analytic": cfg.active_param_count(),
        "param_bytes_per_device": _sharded_bytes(p_meta, pspecs, mesh),
        "batch_sharded": shard_b,
        "policy": policy,
    }
    if shape.kind == "train":
        info["optimizer"] = type(choose_optimizer(cfg)).__name__
    if shape.kind == "decode":
        window = decode_window(cfg, shape)
        info["window_override"] = window
        B = shape.global_batch
        kw = {} if cfg.is_encoder_decoder else {"window_override": window}
        c_meta = model.init_cache(B, shape.seq_len, dtype=BF16,
                                  device="meta", **kw)
        cspecs = cache_specs(c_meta, mesh, multi_pod, shard_b,
                             policy=cache_policy)
        info["cache_bytes_per_device"] = _sharded_bytes(c_meta, cspecs, mesh)
        del c_meta
    del p_meta
    step, args = _state(cfg, shape, batch or shape.global_batch, device)
    return mesh, step, args, info


# ------------------------------------------------------------ collectives
COLLECTIVES_BASIS = ("the step's collectives on DTensors over a fake "
                     "process group of the mesh's ranks (launch.spmd): "
                     "rank 0's result bytes by kind, the reference's "
                     "hlo_analysis convention; plain attention")


RWKV_BASIS = ("; RWKV-6's token loop as its first, second and last "
              "token steps, the second's collectives counted for each of "
              "the S - 2 middle tokens (the reference's HLO holds its "
              "lax.scan body once)")


def collectives_basis(cfg) -> str:
    return COLLECTIVES_BASIS + (RWKV_BASIS if "rwkv" in cfg.layer_kinds
                                else "")


def count_collectives(cfg, shape, multi_pod: bool, policy: str,
                      cache_policy: str) -> Dict[str, Any]:
    """``{"collectives": record}`` of one step of ``cfg`` at ``shape``'s
    global batch on the production mesh (``launch.spmd.count_pair``), or
    ``{"collectives": None, "collectives_error": op}`` where DTensor
    cannot partition it (never 0, never left out)."""
    try:
        return {"collectives": spmd.count_pair(cfg, shape, multi_pod,
                                               policy, cache_policy)}
    except Exception as e:  # noqa: BLE001 — recorded, with the op
        return {"collectives": None,
                "collectives_error": spmd.failure(e)}


# ----------------------------------------------------------------- probes
def _depth_variant(cfg, n_groups: int):
    """Full-width config with first_k_dense + n_groups*pattern layers."""
    pat = len(cfg.block_pattern)
    layers = (cfg.first_k_dense if cfg.moe else 0) + n_groups * pat
    kw = dict(num_layers=layers)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = n_groups
    return dataclasses.replace(cfg, **kw)


def _extrap_mult(cfg) -> float:
    pat = len(cfg.block_pattern)
    prefix = cfg.first_k_dense if cfg.moe else 0
    full_groups = (cfg.num_layers - prefix) // pat
    tail = (cfg.num_layers - prefix) - full_groups * pat
    return full_groups + tail / pat


def _extrap(d1: Dict[str, float], d2: Dict[str, float], mult: float):
    """``base + mult * body`` per key, as the reference's probe."""
    out = {}
    for k in d2:
        body = d2[k] - d1.get(k, 0.0)
        base = d1.get(k, 0.0) - body
        out[k] = max(base + mult * body, 0.0)
    return out


def meta_cost(cfg, shape) -> Dict[str, float]:
    """FLOPs and bytes of one step of ``cfg`` at the global batch, counted
    on meta (``launch.cost``)."""
    step, args = _state(cfg, shape, shape.global_batch, "meta")
    cost, _ = count_cost(step, *args)
    return cost


def meta_memory(cfg, shape, batch: int = 1) -> Dict[str, float]:
    """Bytes a card run of ``cfg`` at ``batch`` keeps live, counted on
    meta with the kernels' allocations: ``weights`` (parameters and
    optimizer state), ``peak`` (the most alive at once during the step,
    the state, the card's op transients and its BLAS workspaces included;
    ``launch.cost``) and ``init`` (the most the build adds above what it
    leaves: one leaf's fp32 draw before its cast)."""
    mm = MetaMemory()
    seen = {}
    with mm, meta_as_card():
        step, args = _state(cfg, shape, batch, "meta",
                            mark=lambda: seen.setdefault("w", mm.live))
        init = mm.peak - mm.live
        mm.peak = mm.live
        step(*args)
        del step, args
    return {"weights": float(seen["w"]),
            "peak": float(mm.peak + CARD_WORKSPACE_BYTES),
            "init": float(init)}


# the layer groups and batch rows the memory model is fitted at: from 1
# to 2 groups a step's peak can shift once (Whisper-large-v3's prefill
# peak grows by two groups' weights there, by one group's afterwards),
# and the meta count of a train step at batch 1 can stand above the line
# that batches 2 and 3 draw (by 1.3-11.7 GiB for Llama-3.2-3B, Qwen2-VL-7B
# and RecurrentGemma-9B at train_4k), where the H100's peak lies on it
# (tools/torch_memory_probe.py)
MEMORY_GROUPS = (2, 3)
MEMORY_BATCHES = (2, 3)


def _fit(counts: Dict[int, Dict[str, float]]) -> Dict[str, float]:
    """``peak(b) = fixed + b * row`` through the counts at the two
    ``MEMORY_BATCHES``: what does not grow with the batch (the gradients,
    the optimizer's temporaries) is ``fixed``, not a part of every row."""
    lo, hi = MEMORY_BATCHES
    row = (counts[hi]["peak"] - counts[lo]["peak"]) / (hi - lo)
    return {"weights": counts[lo]["weights"],
            "fixed": counts[lo]["peak"] - lo * row, "row": row}


@functools.lru_cache(maxsize=None)
def memory_model(cfg, shape) -> Dict[str, float]:
    """Bytes model of a card run at the full depth, ``peak(b) = fixed + b
    * row``: ``meta_memory`` at ``MEMORY_BATCHES`` (``_fit``) for
    ``MEMORY_GROUPS`` layer groups, extrapolated to the full depth as the
    cost is, and the build's transient ``init`` above the ``weights``.
    Also the 2-group model (``fixed2``, ``row2``), which bounds the
    probe's runs."""
    a, c = MEMORY_GROUPS
    mult = _extrap_mult(cfg)
    counts = {n: {b: meta_memory(_depth_variant(cfg, n), shape, b)
                  for b in MEMORY_BATCHES} for n in MEMORY_GROUPS}
    fits = {n: _fit(counts[n]) for n in MEMORY_GROUPS}
    full = {k: max(fits[a][k] + (mult - a) / (c - a)
                   * (fits[c][k] - fits[a][k]), 0.0) for k in fits[a]}
    init = max(c["init"] for n in MEMORY_GROUPS for c in counts[n].values())
    return dict(full, init=init, weights2=fits[2]["weights"],
                fixed2=fits[2]["fixed"], row2=fits[2]["row"])


def card_budget(device) -> float:
    dev = torch.device(device)
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else H100_BYTES)
    return CARD_SHARE * total


def card_batch(shape, fixed: float, row: float, build: float,
               budget: float):
    """The largest batch <= the per-data-shard batch whose bytes ``fixed +
    b * row`` fit in ``budget`` (None if not even 1 fits, or the build's
    ``build`` bytes do not), and the cuts it makes."""
    want = max(shape.global_batch // DATA_SHARDS, 1)
    if max(fixed + row, build) > budget:
        return None, []
    b = min(want, int((budget - fixed) // max(row, 1.0)))
    reduced = ([f"batch {want} -> {b}: {fixed + want * row:.4g} B "
                f"counted on meta > {budget:.4g} B of the card"]
               if b < want else [])
    return b, reduced


def batch_plan(mem: Dict[str, float], shape, budget: float):
    """(batch, cuts, basis) of a pair from its ``memory_model``: the
    largest batch the full depth fits in ``budget`` (basis "full
    depth"), else the largest 2 layer groups fit ("2 groups": the
    probe's runs only), else (None, [], None)."""
    b, reduced = card_batch(shape, mem["fixed"], mem["row"],
                            mem["weights"] + mem["init"], budget)
    if b is not None:
        return b, reduced, "full depth"
    b, reduced = card_batch(shape, mem["fixed2"], mem["row2"],
                            mem["weights2"] + mem["init"], budget)
    return b, reduced, "2 groups" if b is not None else None


def time_step(cfg, shape, batch: int, device,
              reps: int = 3) -> Dict[str, Any]:
    """Run the pair's step on ``device``: one warm call, then the median
    of ``reps`` (one when the warm call took over ``SLOW_S``; CUDA events
    on a card, the host clock elsewhere), the
    peak allocation of the steps on a card (the state included, the
    build's transient not), and a check that what came out is finite and
    of the expected shape."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gc.collect()                  # a failed pair's frames may hold tensors
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
    step, args = _state(cfg, shape, batch, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = step(*args)
    _check_output(cfg, shape, batch, out)
    if time.perf_counter() - t0 > SLOW_S:
        reps = min(reps, 1)       # a step of many seconds: one timed call
    times = []
    for _ in range(reps):
        out = None                # the last call's output (prefill states)
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = step(*args)
            times.append(1e3 * (time.perf_counter() - t0))
    _check_output(cfg, shape, batch, out)
    run = {"ms": statistics.median(times) if times else None,
           "ms_all": times}
    del step, args, out
    if cuda:
        run["max_memory_allocated"] = float(
            torch.cuda.max_memory_allocated(dev) - base)
        torch.cuda.empty_cache()
    return run


def _check_output(cfg, shape, batch: int, out) -> None:
    """A finite loss, or finite last logits [batch, 1, Vpad]."""
    if shape.kind == "train":
        loss = out[2]
        if not torch.isfinite(loss).item():
            raise FloatingPointError(f"non-finite loss {loss.item()}")
        return
    logits = out[0]
    V = cfg.padded_vocab(VOCAB_PAD)
    if tuple(logits.shape) != (batch, 1, V):
        raise ValueError(f"logits {tuple(logits.shape)}, want "
                         f"{(batch, 1, V)}")
    if not torch.isfinite(logits.float()).all().item():
        raise FloatingPointError("non-finite logits")


def _record_path(out_dir, arch, shape_name, mesh_name, suffix):
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}"
                                 f"{suffix}.json")


def _write(out_path, rec):
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _error(arch, shape_name, mesh_name, e):
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def _policy_suffix(policy, cache_policy, default_cache):
    suffix = f"__{policy}" if policy != "fsdp" else ""
    if cache_policy == "auto" and default_cache != "auto":
        suffix += "__legacycache"
    elif cache_policy not in ("auto", "attn_hints_seq"):
        suffix += f"__{cache_policy}"
    return suffix


def probe_pair(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
               force: bool = False, policy: str = "fsdp",
               cache_policy: str = "auto", device="meta", cfg=None,
               shape=None) -> Dict[str, Any]:
    """Layer-probe cost: the full-width model at 1 and 2 layer groups,
    counted on meta; the difference is the per-group cost, which
    extrapolates to the full depth.  ``device="cuda"`` also times both
    depths on the card at the batch ``run_pair`` would run.  ``cfg`` and
    ``shape`` replace the pair's own (a small rehearsal on the CPU)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    suffix = "__probe" + _policy_suffix(policy, cache_policy,
                                        "attn_hints_seq")
    out_path = _record_path(out_dir, arch, shape_name, mesh_name, suffix)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    if (arch, shape_name) in SKIPS:
        return _write(out_path, {"arch": arch, "shape": shape_name,
                                 "mesh": mesh_name, "status": "skipped",
                                 "reason": SKIPS[(arch, shape_name)]})
    t0 = time.time()
    try:
        cfg = cfg or get_config(arch)
        shape = shape or get_shape(shape_name)
        mult = _extrap_mult(cfg)
        cfg1, cfg2 = _depth_variant(cfg, 1), _depth_variant(cfg, 2)
        c1, c2 = meta_cost(cfg1, shape), meta_cost(cfg2, shape)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "ok", "probe": True, "policy": policy,
               "params_analytic": cfg.param_count(),
               "active_params_analytic": cfg.active_param_count(),
               "probe_groups": [1, 2], "extrap_mult": mult,
               "cost": _extrap(c1, c2, mult), "cost_n1": c1, "cost_n2": c2,
               "cost_basis": "whole step at the global batch, counted on "
                             "meta (plain attention)"}
        l1 = count_collectives(cfg1, shape, multi_pod, policy, cache_policy)
        l2 = count_collectives(cfg2, shape, multi_pod, policy, cache_policy)
        if l1["collectives"] is None or l2["collectives"] is None:
            rec.update(collectives=None, collectives_error=l1.get(
                "collectives_error") or l2["collectives_error"])
        else:
            rec.update(collectives=_extrap(l1["collectives"],
                                           l2["collectives"], mult),
                       collectives_n1=l1["collectives"],
                       collectives_n2=l2["collectives"])
        rec["collectives_basis"] = collectives_basis(cfg)
        if torch.device(device).type != "meta":
            rec["card"] = _probe_card(cfg, shape, mult, device)
        rec["wall_s"] = round(time.time() - t0, 1)
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        rec = _error(arch, shape_name, mesh_name, e)
    return _write(out_path, rec)


def _probe_card(cfg, shape, mult: float, device) -> Dict[str, Any]:
    """Both probe depths on the card at ``run_pair``'s batch (or, where
    the full depth cannot fit, the largest batch 2 groups fit)."""
    mem = memory_model(cfg, shape)
    budget = card_budget(device)
    b, reduced, basis = batch_plan(mem, shape, budget)
    card = {"memory_model": mem, "budget": budget,
            "batch_basis": basis or "2 groups"}
    if b is None:
        card.update(status="exceeds_card",
                    bytes_2_groups=mem["fixed2"] + mem["row2"])
        return card
    t1 = time_step(_depth_variant(cfg, 1), shape, b, device)
    t2 = time_step(_depth_variant(cfg, 2), shape, b, device)
    card.update(status="ok", batch=b, reduced=reduced, n1=t1, n2=t2,
                ms=_extrap({"ms": t1["ms"]}, {"ms": t2["ms"]}, mult)["ms"],
                meta_peak_n2=mem["fixed2"] + b * mem["row2"])
    return card


def run_pair(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, policy: str = "fsdp",
             cache_policy: str = "attn_hints_seq", device="cuda", cfg=None,
             shape=None) -> Dict[str, Any]:
    """The pair's info on meta and, with ``device="cuda"``, its full-depth
    step on the card where it fits (``exceeds_card`` elsewhere).  ``cfg``
    and ``shape`` replace the pair's own for the run (a small rehearsal
    on the CPU); the info stays the pair's."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    suffix = _policy_suffix(policy, cache_policy, "attn_hints_seq")
    out_path = _record_path(out_dir, arch, shape_name, mesh_name, suffix)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    if (arch, shape_name) in SKIPS:
        return _write(out_path, {"arch": arch, "shape": shape_name,
                                 "mesh": mesh_name, "status": "skipped",
                                 "reason": SKIPS[(arch, shape_name)]})
    t0 = time.time()
    try:
        _, _, _, info = build_dryrun(arch, shape_name, multi_pod,
                                     policy=policy,
                                     cache_policy=cache_policy,
                                     device="meta", batch=1)
        cfg = cfg or get_config(arch)
        shape = shape or get_shape(shape_name)
        rec = dict(info, status="ok", **count_collectives(
            cfg, shape, multi_pod, policy, cache_policy),
            collectives_basis=collectives_basis(cfg))
        if torch.device(device).type != "meta":
            mem = memory_model(cfg, shape)
            budget = card_budget(device)
            b, reduced, basis = batch_plan(mem, shape, budget)
            rec.update(memory_model=mem, budget=budget)
            if basis != "full depth":
                rec.update(status="exceeds_card",
                           bytes_counted=mem["fixed"] + mem["row"])
            else:
                run = time_step(cfg, shape, b, device)
                rec.update(batch=b, reduced=reduced, card=run,
                           meta_peak=mem["fixed"] + b * mem["row"])
        rec["wall_s"] = round(time.time() - t0, 1)
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        rec = _error(arch, shape_name, mesh_name, e)
    return _write(out_path, rec)


def _coll_text(rec: Dict[str, Any]) -> str:
    coll = rec.get("collectives")
    if coll is None:
        return f"collectives null ({rec.get('collectives_error')})"
    return f"traffic~={coll['traffic_weighted']:.4g}"


def _line(rec: Dict[str, Any]) -> str:
    status = rec.get("status")
    extra = ""
    if status == "error":
        extra = rec["error"]
    elif rec.get("probe") and status == "ok":
        extra = (f"wall={rec['wall_s']}s flops~={rec['cost']['flops']:.4g} "
                 f"bytes~={rec['cost']['bytes_accessed']:.4g} "
                 + _coll_text(rec))
        card = rec.get("card")
        if card and card["status"] == "ok":
            extra += (f" card b={card['batch']} ms n1={card['n1']['ms']:.4g}"
                      f" n2={card['n2']['ms']:.4g} full~={card['ms']:.4g}")
        elif card:
            extra += f" card {card['status']}"
    elif status in ("ok", "exceeds_card"):
        extra = (f"param_bytes/dev={rec['param_bytes_per_device']:.4g}"
                 + (f" cache_bytes/dev={rec['cache_bytes_per_device']:.4g}"
                    if "cache_bytes_per_device" in rec else "")
                 + " " + _coll_text(rec))
        if "card" in rec:
            extra += (f" card b={rec['batch']} ms={rec['card']['ms']:.4g} "
                      f"peak={rec['card'].get('max_memory_allocated', 0) / 2**30:.3g}"
                      f" GiB counted={rec['meta_peak'] / 2**30:.3g} GiB")
    return f"[{status:12s}] {rec['arch']} x {rec['shape']} x " \
           f"{rec.get('mesh')}  {extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unrolled", action="store_true",
                    help="accepted for the reference's command line and "
                         "ignored: the port has no scan to unroll")
    ap.add_argument("--policy", default="fsdp", choices=["fsdp", "tp_only"],
                    help="parameter sharding policy")
    ap.add_argument("--cache-policy", default="attn_hints_seq",
                    choices=["auto", "seq_data", "attn_hints",
                             "attn_hints_seq"],
                    help="decode cache sharding layout")
    ap.add_argument("--probe", action="store_true",
                    help="layer-probe cost (1 and 2 full-width layer "
                         "groups, extrapolated)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: also run on the card; meta: counts only")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dryrun: --device cuda, and this host has no "
                             "CUDA device (--device meta counts without one)")
        # pairs of many sizes in one process: segments that grow in place
        # keep the allocator's free blocks from splintering
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")

    if args.all:
        pairs = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]

    errors = 0
    for a, s in pairs:
        if args.probe:
            rec = probe_pair(a, s, args.multi_pod, args.out,
                             force=args.force, policy=args.policy,
                             cache_policy=args.cache_policy,
                             device=args.device)
        else:
            rec = run_pair(a, s, args.multi_pod, args.out, force=args.force,
                           policy=args.policy,
                           cache_policy=args.cache_policy,
                           device=args.device)
        errors += rec.get("status") == "error"
        print(_line(rec), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
