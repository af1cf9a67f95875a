"""Where the port's serving time goes on the GPU.

A full-width model (TinyLlama-1.1B unless ``--arch`` names another) in
bf16 (seeded weights), 8 slots, paged cache (page 16), 8 requests with
512-token prompts, decoding at ``--tp`` logical ranks: times one batched
prefill group and single decode iterations (host clock around work that
ends in a synchronize), then traces a window of decode iterations and the
prefill with ``torch.profiler`` to get the device's busy share and the
kernels that take its time.

    PYTHONPATH=src python tools/torch_serve_profile.py
    PYTHONPATH=src python tools/torch_serve_profile.py --tp 2
    PYTHONPATH=src python tools/torch_serve_profile.py --arch deepseek-v2-lite-16b
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request

SLOTS, PROMPT, MAX_LEN, WINDOW = 8, 512, 576, 10


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def report(prof, wall_s: float, what: str, top: int = 12) -> None:
    """Device time of the profiled run against the unprofiled wall time
    ``wall_s``.  Device kernels only: CPU ops carry their kernels' time
    too."""
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_s = sum(_device_us(e) for e in events) * 1e-6
    print(f"{what}: unprofiled wall {wall_s * 1e3:.3f} ms, device busy "
          f"{busy_s * 1e3:.3f} ms = {100 * busy_s / wall_s:.1f}% "
          f"(idle {100 * (1 - busy_s / wall_s):.1f}%), "
          f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) * 1e-3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--tp", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(seed=0, dtype=bf, device=dev)
    scfg = ServeConfig(slots=SLOTS, max_len=MAX_LEN, page_size=16,
                       cache_dtype=bf, compute_dtype=bf, tp=args.tp)
    print(f"{cfg.name}, bf16, tp={args.tp}")
    prompts = np.random.RandomState(1).randint(1, cfg.vocab_size,
                                               size=(SLOTS, PROMPT))

    def engine(plen, new):
        eng = ServeEngine(model, params, scfg, device=dev)
        for i in range(SLOTS):
            eng.submit(Request(rid=i, prompt=[int(t) for t in prompts[i, :plen]],
                               max_new_tokens=new))
        return eng

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return prof

    engine(PROMPT, 2).run()               # warm-up at the measured shapes
    profiled(engine(16, 2).run)           # the profiler's own start-up

    # unprofiled wall times: the profiler slows the host, not the device
    eng = engine(PROMPT, 64)
    prefill_s = timed(lambda: eng._prefill(eng.batcher.admit(eng.clock)))
    steps = [timed(eng._decode_iteration) for _ in range(WINDOW)]
    decode_s = statistics.median(steps)
    print(f"prefill group ({SLOTS} x {PROMPT} tokens): {prefill_s * 1e3:.3f}"
          f" ms wall; decode iteration ({SLOTS} slots): median "
          f"{decode_s * 1e3:.3f} ms, min {min(steps) * 1e3:.3f} ms over "
          f"{WINDOW}")

    eng = engine(PROMPT, 64)
    admitted = eng.batcher.admit(eng.clock)
    report(profiled(lambda: eng._prefill(admitted)), prefill_s,
           "prefill group")

    def decode_window():
        for _ in range(WINDOW):
            eng._decode_iteration()

    report(profiled(decode_window), WINDOW * decode_s,
           f"{WINDOW} decode iterations")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
