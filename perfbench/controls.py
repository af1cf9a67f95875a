"""Readings the correctness limits are set from, on the card at a cell's
own size (the benchmark's runs do not run this):

    python3 perfbench/controls.py --workload W --seconds S \\
        --seeds 1,2,3 [--controls 1,2,3]

For every seed, one run of the cell (a short window at the cell's load)
gives the program's readings.  For the seeds in ``--controls`` the
reference is also put in the program's place: in the next precision
below the configuration's (TF32 for the fp32 training cells, fp8 e4m3
for the bf16 serving cell) and, for a training cell, with each fault the
program could have (half of the batch, the exchange left out).  Each
reading is compared with the fp32 reference as the run's check compares
the program, and judged against the cell's limits (``limits/<cell>.json``)
by the run's own rule: a control or a fault has to come out ``correct:
false``.  One JSON line per seed and per control."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __name__ == "__main__":
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:] = [_ROOT, os.path.join(_ROOT, "src")] + [
        p for p in sys.path if p != os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

from perfbench import gen, harness, weights  # noqa: E402
from perfbench.checks import leaf_gap, rel_gap  # noqa: E402
from perfbench.reference import serve as ref_serve  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402
from perfbench.train import _norms_against_start  # noqa: E402


def train_controls(c, res, seed, device):
    from repro_torch.train import Strategy
    mix, cfg = c.mix, c.config
    strat = Strategy.parse(mix["strategy"], lr=mix["lr"], wire=mix["wire"])
    ref_losses, ref_grad, ref_change = res.reference
    batches = gen.train_batches(mix, seed, cfg["vocab_size"], device)
    out = []
    for lowp, fault in (("tf32", None), (None, "half_batch"),
                        (None, "no_exchange")):
        W = weights.make(cfg, seed, torch.float32, device)
        losses, grad = ref_train.run(
            W, cfg, batches, workers=strat.workers, steps=mix["check_steps"],
            lr=mix["lr"], method=strat.compressor.method, lowp=lowp,
            fault=fault)
        change = _norms_against_start(W, cfg, seed, torch.float32, device,
                                      lambda w, w0: w - w0)
        del W
        gc.collect()
        torch.cuda.empty_cache()
        out.append({"control": lowp or fault, "seed": seed,
                    "loss": rel_gap(losses, ref_losses),
                    "grad": leaf_gap(grad, ref_grad, ref_grad),
                    "change": leaf_gap(change, ref_change, ref_grad)})
    return out


def serve_controls(c, res, seed, device):
    W = weights.make(c.config, seed, getattr(torch, c.config["dtype"]), device)
    gap, n = ref_serve.gaps(W, c.config, res.sample, device, control="fp8")
    return [{"control": "fp8", "seed": seed, "served_gap": gap, "tokens": n}]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)
    c = harness.resolve(harness.manifest(), args.workload)
    device = torch.device("cuda", 0)
    print(harness.card_line(device), file=sys.stderr, flush=True)
    controls = {int(s) for s in args.controls.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        res = harness.run_cell(c, seed, args.seconds, False, device, t)
        row = {"seed": seed, "correct": res.correct,
               "attempted": res.attempted, "reference_s": res.reference_s,
               "peak_gib": res.memory_peak / 2 ** 30,
               **{n: v for n, v, _ in res.checks}}
        print(json.dumps(row), flush=True)
        if seed in controls:
            more = (train_controls if c.mix["kind"] == "train"
                    else serve_controls)(c, res, seed, device)
            for r in more:
                r["correct"] = harness.verdict(r, c.limits)
                print(json.dumps(r), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
