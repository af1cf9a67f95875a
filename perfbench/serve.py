"""The serving driver: one cell of a ``"kind": "serve"`` mix.

Set-up makes the seeded weights, builds the program's ``ServeEngine``
(continuous batching over a paged cache whose pool holds the mix's
``pool_tokens``: admission reserves a request's pages or waits) and
warms it with one request of the mix's longest prompt, which allocates
what the window's prefill and decode iterations use.  The window is an
open loop on the wall clock: a request is submitted once its due time has
passed, whatever the engine is doing, and every latency is counted from
the due time.  The harness calls
``step_iteration`` itself and stamps each request when it leaves the
queue (the start of the iteration that admits it), gets its first token
and finishes (the end of those iterations: a token exists on the host
when ``step_iteration`` returns).  After the window the program is freed
and the plain reference reads a sample of the finished requests.

A traced run profiles the window's last ``trace_seconds``; the metrics
taken from the harness's stamps read what came before it, which tracing
does not slow."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench import gen, port, weights
from perfbench.reference import serve as ref_serve
from perfbench.trace import Tracer


class Record:
    """One request as the client sees it (seconds from the window's
    start)."""
    __slots__ = ("offer", "req", "admitted", "first", "done")

    def __init__(self, offer, req):
        self.offer, self.req = offer, req
        self.admitted = self.first = self.done = None


def pool_tokens(mix: Dict) -> int:
    """Tokens the page pool holds: the mix's ``pool_tokens`` in whole
    pages (without it, every slot can hold the longest request)."""
    page = mix["page_size"]
    want = mix.get("pool_tokens", mix["slots"] * gen.max_len(mix))
    return page * -(-want // page)


def build_engine(cfg: Dict, mix: Dict, W, device):
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    dtype = getattr(torch, cfg["dtype"])
    mcfg = port.model_config(cfg)
    scfg = ServeConfig(slots=mix["slots"], max_len=gen.max_len(mix),
                       page_size=mix["page_size"],
                       num_pages=1 + pool_tokens(mix) // mix["page_size"],
                       policy="continuous",
                       cache_dtype=dtype, compute_dtype=dtype)
    return ServeEngine(build_model(mcfg), port.params(W, mcfg), scfg,
                       device=device)


def _request(rid, prompt, max_new, clock):
    from repro_torch.serve.request import Request, SamplingParams
    return Request(rid=rid, prompt=prompt.tolist(), max_new_tokens=max_new,
                   arrival=clock, sampling=SamplingParams(temperature=0.0))


def _busy(engine) -> bool:
    return bool(engine.batcher.queue) or engine.batcher.num_running > 0


def warm_up(engine, mix: Dict, vocab: int):
    """One request of the longest prompt, served to the end."""
    prompt = np.random.default_rng([0, 3]).integers(
        0, vocab, size=mix["prompt"]["max"])
    engine.submit(_request(-1, prompt, 4, engine.clock))
    while _busy(engine):
        engine.step_iteration()


def drive(engine, offers, seconds: float, device, trace_at: float = None,
          trace_seconds: float = 0.0):
    """The window: returns (records, iterations, window seconds, trace,
    the seconds before the trace started).  An iteration is (start, end,
    prefilled prompt lengths, decoded cache lengths, whether it
    prefilled)."""
    recs: List[Record] = []
    iters = []
    tracer = Tracer(device) if trace_at is not None else None
    traced = tr_iter = None
    clean = seconds
    live: List[Record] = []
    i = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if tracer and not tracer.started and now >= trace_at:
            _sync(device)
            tracer.start()
            tr_iter, clean = len(iters), now
        if tracer and tracer.running and tracer.elapsed() >= trace_seconds:
            tracer.stop()
            traced = (tr_iter, len(iters))
        if now >= seconds:
            break
        while i < len(offers) and offers[i].due <= now:
            o = offers[i]
            r = Record(o, _request(i, o.prompt, o.max_new, engine.clock))
            engine.submit(r.req)
            recs.append(r)
            live.append(r)
            i += 1
        if not _busy(engine):
            nxt = offers[i].due if i < len(offers) else seconds
            time.sleep(max(0.0, min(nxt, seconds) - now))
            continue
        before = {id(r): len(r.req.output) for r in live}
        queued = [r for r in live if r.admitted is None]
        pg = engine.prefill_groups
        start = time.perf_counter() - t0
        engine.step_iteration()
        end = time.perf_counter() - t0
        prefilled, decoded = [], []
        for r in queued:
            if r.req.slot >= 0 or r.req.output:
                r.admitted = start
                prefilled.append(r.req.prompt_len)
        for r in list(live):
            n = len(r.req.output)
            new = n - before[id(r)] - (1 if r.admitted == start else 0)
            if new > 0:
                decoded.append(r.req.prompt_len + n - 1)
            if n and r.first is None:
                r.first = end
            if r.req.done:
                r.done = end
                live.remove(r)
        iters.append((start, end, prefilled, decoded,
                      engine.prefill_groups > pg))
    _sync(device)
    window = time.perf_counter() - t0
    if tracer and tracer.running:
        tracer.stop()
        traced = (tr_iter, len(iters))
    if tracer and tracer.started:
        traced = (tracer.read(),) + traced
    return recs, iters, window, traced, min(clean, window)


def _sample(recs, mix: Dict, seed: int):
    """Finished requests to check: the longest, then others drawn from the
    seed until ``check_tokens`` served tokens are read."""
    done = [r for r in recs if r.req.done]
    if not done:
        return []
    done.sort(key=lambda r: -(r.req.prompt_len + len(r.req.output)))
    picked, rest = [done[0]], done[1:]
    order = np.random.default_rng([seed, 4]).permutation(len(rest))
    tokens = len(done[0].req.output)
    for j in order:
        if tokens >= mix["check_tokens"]:
            break
        picked.append(rest[j])
        tokens += len(rest[j].req.output)
    return [(np.asarray(r.offer.prompt, np.int64), list(r.req.output))
            for r in picked]


def run(cfg: Dict, mix: Dict, limits: Dict, seed: int, seconds: float,
        trace: bool, device, started: float) -> SimpleNamespace:
    # the engine's host work is Python and kernel launches: one CPU thread
    # for PyTorch's own pool keeps idle workers off the host's shared cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run(cfg, mix, limits, seed, seconds, trace, device, started)
    finally:
        torch.set_num_threads(threads)


def _run(cfg, mix, limits, seed, seconds, trace, device, started):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg["dtype"])
    stages = {"imports": time.perf_counter() - started}
    W = weights.make(cfg, seed, dtype, device)
    _sync(device)
    stages["weights"] = time.perf_counter() - started
    engine = build_engine(cfg, mix, W, device)
    _sync(device)
    stages["engine"] = time.perf_counter() - started
    warm_up(engine, mix, cfg["vocab_size"])
    offers = gen.offers(mix, seed, seconds, cfg["vocab_size"])
    if trace:
        Tracer(device).warm()
    # set-up's objects out of the collector's reach: a full collection in
    # the window would scan them all while the host dispatches nothing
    gc.collect()
    gc.freeze()
    _sync(device)
    setup_s = time.perf_counter() - started

    at = max(0.0, seconds - mix["trace_seconds"]) if trace else None
    recs, iters, window, traced, clean = drive(
        engine, offers, seconds, device, at, mix["trace_seconds"])
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    sample = _sample(recs, mix, seed)
    # no finished request is nothing served to check: not correct
    widest, n_tok = (ref_serve.gaps(W, cfg, sample, device) if sample
                     else (float("inf"), 0))
    ref_s = time.perf_counter() - t_ref
    del W
    produced = sum(len(r.req.output) for r in recs)
    checks = [("served_gap", widest, limits["served_gap"])]
    return SimpleNamespace(
        setup_s=setup_s, stages=stages, window_s=window, records=recs,
        iterations=iters, attempted=len(recs), failed=0, checks=checks,
        memory_peak=peak, reference_s=ref_s, checked_tokens=n_tok,
        sample=sample,
        trace=traced[0] if traced else None, untraced=clean,
        traced_iterations=(traced[1], traced[2]) if traced else None,
        end_to_end={"serve_tokens_per_s": produced / window},
        cfg=cfg, mix=mix)


def waits(recs, stamp: str, now: float) -> List[float]:
    """Seconds from due to ``stamp`` of every request in ``recs``; one
    without it by ``now`` counts the time it has waited until then."""
    out = []
    for r in recs:
        at = getattr(r, stamp)
        out.append((now if at is None else min(at, now)) - r.offer.due)
    return out


def ttft_p90_ms(recs, now: float) -> float:
    """The 90th percentile of the first-token waits, in ms."""
    from perfbench.stats import percentile
    return 1e3 * percentile(waits(recs, "first", now), 90)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
