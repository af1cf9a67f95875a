"""The training driver: one cell of a ``"kind": "train"`` mix.

A traced run profiles the window's last ``trace_seconds``; the metrics
taken from the harness's own clock read the steps before it.

Set-up builds one engine, ``Strategy.parse(spec).build(...)`` of the
program over the benchmark's seeded weights, and drives it through the
mix's ``check_steps`` first steps with the window's own call and feed.
Those steps are also the warm-up: every kernel and shape of a step has
run before the window opens.  After the first of them the harness reads
each weight's gradient as SGD applied it, ``(w0 - w1) / lr``, and after
the last each weight's change ``w - w0`` (the starting weights made again
one at a time).  The window then runs whole steps on the same engine until
``seconds`` have passed; the rate is all their tokens over all their
time.  After the window the program is freed and the plain reference
trains the same weights on the same batches for the same steps."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import torch

from perfbench import gen, port, weights
from perfbench.checks import leaf_gap, rel_gap
from perfbench.reference import train as ref_train
from perfbench.reference.transformer import weight_specs
from perfbench.trace import Tracer


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def _norms_against_start(params, cfg, seed, dtype, device, fn) -> Dict:
    """Per weight name, ``|fn(w, w0)|`` of the program's weights ``params``
    against the starting weights, made again one at a time."""
    index = {n: i for i, (n, _, _) in enumerate(weight_specs(cfg))}
    out = {}
    for path, w in _walk(params):
        name = port.weight_name(path)
        if name is None:
            continue
        w0 = weights.make_one(cfg, seed, index[name], dtype, device)
        out[name] = float(torch.linalg.vector_norm(fn(w.float(), w0)))
        del w0
    return out


def run(cfg: Dict, mix: Dict, limits: Dict, seed: int, seconds: float,
        trace: bool, device, started: float) -> SimpleNamespace:
    from repro_torch.models import build_model
    from repro_torch.train import Strategy, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg["dtype"])
    stages = {"imports": time.perf_counter() - started}
    mcfg = port.model_config(cfg)
    model = build_model(mcfg)
    strat = Strategy.parse(mix["strategy"], lr=mix["lr"], wire=mix["wire"])
    K, lr = strat.workers, mix["lr"]
    params = port.params(weights.make(cfg, seed, dtype, device), mcfg)
    _sync(device)
    stages["weights"] = time.perf_counter() - started
    engine = strat.build(
        value_and_grad(lambda p, b: model.loss_fn(p, b, compute_dtype=dtype)),
        layout=model.leaf_layout(params), device=device)
    st = engine.init(params)
    del params
    batches = gen.train_batches(mix, seed, cfg["vocab_size"], device)

    losses = []
    for t in range(mix["check_steps"]):
        st, ev = engine.step(st, batches, t)
        losses.append(ev[0]["loss"])
        if t == 0:
            grad = _norms_against_start(engine.finalize(st), cfg, seed, dtype,
                                        device, lambda w, w0: (w0 - w) / lr)
        _sync(device)
        stages[f"step {t}"] = time.perf_counter() - started
    change = _norms_against_start(engine.finalize(st), cfg, seed, dtype,
                                  device, lambda w, w0: w - w0)
    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.warm()
    _sync(device)
    setup_s = time.perf_counter() - started

    tr_at = max(0.0, seconds - mix["trace_seconds"])
    steps, t, tr_steps, clean = 0, mix["check_steps"], 0, None
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if tracer and not tracer.started and now >= tr_at:
            _sync(device)
            clean = (steps, time.perf_counter() - t0)
            tracer.start()
            tr_steps = steps
        if tracer and tracer.running and \
                tracer.elapsed() >= mix["trace_seconds"]:
            tracer.stop()
            tr_steps = steps - tr_steps
        if now >= seconds:
            break
        st, _ = engine.step(st, batches, t)
        t += 1
        steps += 1
    _sync(device)
    window = time.perf_counter() - t0
    if tracer and tracer.running:
        tracer.stop()
        tr_steps = steps - tr_steps
    traced = tracer.read() if tracer and tracer.started else None
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del st, engine, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    W = weights.make(cfg, seed, torch.float32, device)
    ref_losses, ref_grad = ref_train.run(
        W, cfg, batches, workers=K, steps=mix["check_steps"], lr=lr,
        method=strat.compressor.method)
    ref_change = _norms_against_start(W, cfg, seed, torch.float32, device,
                                      lambda w, w0: w - w0)
    del W
    ref_s = time.perf_counter() - t_ref

    checks = [("loss", rel_gap(losses, ref_losses), limits["loss"]),
              ("grad", leaf_gap(grad, ref_grad, ref_grad),
               limits["grad"]),
              ("change", leaf_gap(change, ref_change, ref_grad),
               limits["change"])]
    B, S = mix["batch_per_worker"], mix["seq_len"]
    return SimpleNamespace(
        setup_s=setup_s, stages=stages, window_s=window, steps=steps,
        attempted=steps, failed=0, checks=checks, memory_peak=peak,
        reference_s=ref_s, trace=traced, traced_steps=tr_steps,
        untraced=clean or (steps, window),
        reference=(ref_losses, ref_grad, ref_change),
        end_to_end={"train_tokens_per_s": steps * K * B * S / window},
        workers=K, batch=B, seq=S, cfg=cfg, mix=mix)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
