"""Tracing's cost on the GPU, and the untraced serve and train paths.

Full-width TinyLlama-1.1B (seeded weights) on two workloads:

* serve: ``chip_smoke.py`` phase 5's, bf16, 16 requests of 512 prompt
  tokens and 64 new ones at t=0, 8 slots, pages of 16, through
  ``ServeEngine.run``: wall per engine iteration (prefill groups and
  decode iterations; ``run`` ends in a synchronize);
* train: ``chip_smoke.py`` phase 11's launcher (``launch/train.py``'s
  ``build`` and ``train``: fp32, Adam + onebit, batch 8 x 64), 5 steps:
  the median wall of the steps after the first.

Each runs once to warm up (its shapes' first kernels and allocations),
then ``--reps`` times untraced and, where the checkout has
``repro_torch.obs.trace``, as many times under ``tracing()``, in turns
(untraced, traced, traced, untraced, ...).  One JSON line holds every
wall and the medians.

    PYTHONPATH=src python tools/torch_trace_cost.py [--src DIR] [--reps 3]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
older tree, timed in the same call: run old, new, new, old).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

SLOTS, PROMPT, NEW, MAX_LEN, PAGE, REQUESTS = 8, 512, 64, 576, 16, 16
TRAIN_STEPS = 5


def _order(reps: int):
    """untraced / traced in turns: U T T U U T T U ..."""
    out = []
    for i in range(reps):
        out += [False, True] if i % 2 == 0 else [True, False]
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    try:
        from repro_torch.obs.trace import tracing
    except ImportError:              # a checkout without the obs plane
        tracing = None
    order = [t for t in _order(args.reps) if not t or tracing is not None]

    def traced(on):
        return tracing() if on else contextlib.nullcontext()

    dev = torch.device("cuda")
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device=dev)
    prompts = np.random.RandomState(1).randint(1, cfg.vocab_size,
                                               size=(REQUESTS, PROMPT))
    scfg = ServeConfig(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                       cache_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16)

    def serve(n, plen, new):
        reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i, :plen]],
                        max_new_tokens=new) for i in range(n)]
        return ServeEngine(model, params, scfg, device=dev).run(reqs)

    serve(REQUESTS, PROMPT, NEW)                         # warm-up
    serve_ms = {False: [], True: []}
    for on in order:
        with traced(on):
            m = serve(REQUESTS, PROMPT, NEW)
        iters = m["decode_iterations"] + m["prefill_groups"]
        serve_ms[on].append(1e3 * m["wall_s"] / iters)
    del params
    torch.cuda.empty_cache()

    train_args = launcher.parse_args(["--steps", str(TRAIN_STEPS),
                                      "--compress", "onebit",
                                      "--device", "cuda"])
    train_ms = {False: [], True: []}
    launcher.train(launcher.build(train_args))           # warm-up
    torch.cuda.empty_cache()
    for on in order:
        run = launcher.build(train_args)
        with traced(on):
            _, hist = launcher.train(run)
        del run
        torch.cuda.empty_cache()
        walls = [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
        train_ms[on].append(1e3 * statistics.median(walls))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    row = {"src": args.src, "card": card,
           "serve_ms_per_iteration": {"untraced": serve_ms[False],
                                      "traced": serve_ms[True]},
           "train_step_ms": {"untraced": train_ms[False],
                             "traced": train_ms[True]}}
    for key in ("serve_ms_per_iteration", "train_step_ms"):
        for mode in ("untraced", "traced"):
            xs = row[key][mode]
            row[key][mode + "_median"] = statistics.median(xs) if xs else None
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
