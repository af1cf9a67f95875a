"""The serving cell's knee, found once by a sweep on the card (a serving
cell then offers a fixed rate; the benchmark's runs never search):

    python3 perfbench/sweep.py --workload W --seed N --seconds S \\
        --rates 1.5,2,2.5,3 [--seeds N1,N2 --repeat 2]

One engine serves a window of the cell's traffic at each rate in turn
(and, with ``--seeds`` and ``--repeat``, each of those seeds' traffic,
that many times: the spread of a rate), drained between windows.  Each rate prints one JSON line: requests due,
started, finished and still queued at the window's end, tokens offered
and produced per second, the first-token and queue tails, and the median
decode iteration.  The knee is the highest rate whose queue does not grow
through the window."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:] = [_ROOT, os.path.join(_ROOT, "src")] + [
        p for p in sys.path if p != os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

from perfbench import gen, harness, serve, weights  # noqa: E402
from perfbench.stats import median, percentile  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s] or [args.seed]
    c = harness.resolve(harness.manifest(), args.workload)
    device = torch.device("cuda", 0)
    print(harness.card_line(device), file=sys.stderr, flush=True)
    cfg = c.config
    W = weights.make(cfg, args.seed, getattr(torch, cfg["dtype"]), device)
    engine = serve.build_engine(cfg, c.mix, W, device)
    serve.warm_up(engine, c.mix, cfg["vocab_size"])
    runs = [(float(r), s) for r in args.rates.split(",")
            for _ in range(args.repeat) for s in seeds]
    for rate, seed in runs:
        mix = dict(c.mix, arrivals=dict(c.mix["arrivals"], rate_per_s=rate))
        offers = gen.offers(mix, seed, args.seconds, cfg["vocab_size"])
        recs, iters, window, _, _ = serve.drive(engine, offers, args.seconds,
                                             device)
        half = [r for r in recs if r.offer.due < window / 2]
        row = {
            "rate": rate, "seed": seed, "due": len(recs),
            "admitted": sum(r.admitted is not None for r in recs),
            "finished": sum(r.done is not None for r in recs),
            "queued_at_end": sum(r.admitted is None for r in recs),
            "offered_tokens_per_s": sum(o.max_new for o in offers
                                        if o.due < window) / window,
            "tokens_per_s": sum(len(r.req.output) for r in recs) / window,
            "ttft_p50_ms": 1e3 * percentile(serve.waits(recs, "first", window), 50),
            "kv_live_tokens_mean": sum(sum(p) + sum(d) for _, _, p, d, _
                                       in iters) / max(1, len(iters)),
            "ttft_p90_ms": 1e3 * percentile(serve.waits(recs, "first", window), 90),
            "ttft_p90_first_half_ms": 1e3 * percentile(
                serve.waits(half, "first", window), 90),
            "queue_p90_ms": 1e3 * percentile(serve.waits(recs, "admitted",
                                                         window), 90),
            "decode_iter_ms": 1e3 * median([e - s for s, e, _, _, p in iters
                                            if not p] or [0.0]),
            "iterations": len(iters),
            "prefill_ms": 1e3 * sum(e - s for s, e, _, _, p in iters if p)
            / max(1, sum(len(it[2]) for it in iters))}
        print(json.dumps(row), flush=True)
        t = time.perf_counter()
        while serve._busy(engine):
            engine.step_iteration()
        print(f"drained in {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
