"""Where the port's training time goes on the GPU.

Full-width TinyLlama-1.1B (seeded weights; fp32 compute, bf16 for a
spec whose precision is ``.bf16`` or ``.bf16r``), a training step of
``chip_smoke.py`` (batch 2 x seq 256 per worker, lr 0.01, bucket_mb 4;
by default ``bsp/allreduce/onebit@4`` with ``wire="modeled"``): one
warm-up step, the wall time of ``STEPS`` unprofiled steps (host clock
around work that ends in a synchronize), then one step under
``torch.profiler`` for the device's busy share, the device time of each
phase of the step (the engine's ``record_function`` ranges), the kernels
that take it and the device time of each of the port's own CUDA kernels.  A global step of ssp or asp is as many push
events as its ticks hold (one worker's batch each); tokens/s counts them.

    PYTHONPATH=src python tools/torch_train_profile.py
    PYTHONPATH=src python tools/torch_train_profile.py bsp/ring/onebit@4 \
        --wire measured
    PYTHONPATH=src python tools/torch_train_profile.py ssp:3/ps/onebit@4
    PYTHONPATH=src python tools/torch_train_profile.py \
        bsp/ps/onebit@4:d4.z3.bf16.adamw
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.train import Strategy, value_and_grad

SPEC, BATCH, SEQ, STEPS = "bsp/allreduce/onebit@4", 2, 256, 3
PHASES = ("forward_backward", "stack_and_compress", "allreduce",
          "sgd_update")


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", nargs="?", default=SPEC)
    ap.add_argument("--wire", default="modeled",
                    choices=("modeled", "measured"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    strat = Strategy.parse(args.spec, lr=0.01, wire=args.wire)
    dtype = torch.float32 if strat.precision == "fp32" else torch.bfloat16
    engine = strat.build(
        value_and_grad(lambda p, b: model.loss_fn(p, b,
                                                  compute_dtype=dtype)),
        layout=model.leaf_layout(params), device=dev)
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=SEQ, batch_size=BATCH),
                              device=dev)
    st = engine.init(params)
    del params
    st, _ = engine.step(st, batches, 0)                  # warm-up

    def worker_batches(events):
        # a push event carries one worker's batch, a round all K
        return len(events) if "worker" in events[0] else strat.workers

    walls, batches_per_step = [], []
    for t in range(1, 1 + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, events = engine.step(st, batches, t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        batches_per_step.append(worker_batches(events))
    # ssp / asp steps hold varying numbers of events: compare per batch
    per_batch = [w / b for w, b in zip(walls, batches_per_step)]
    wall_b = min(per_batch)
    print(f"{args.spec} wire={args.wire} step: wall {[round(w * 1e3, 1) for w in walls]} ms "
          f"({batches_per_step} worker batches), {BATCH * SEQ / wall_b:.1f} "
          "tokens/s at the fastest")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, events = engine.step(st, batches, 1 + STEPS)
        torch.cuda.synchronize()
    n_b = worker_batches(events)
    # on the device's timeline a record_function range shows up as an
    # event of its own beside the kernels it covers: the phases are read
    # from those, and the busy time from the kernels alone
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    phases = {e.key: e for e in on_device if e.key in PHASES}
    kernels = [e for e in on_device if e.key not in PHASES]
    busy_s = sum(_device_us(e) for e in kernels) * 1e-6
    share = busy_s / n_b / wall_b
    print(f"profiled step ({n_b} worker batches): device busy "
          f"{busy_s * 1e3:.1f} ms = {busy_s / n_b * 1e3:.1f} ms per worker "
          f"batch against the fastest unprofiled wall "
          f"{wall_b * 1e3:.1f} ms per worker batch = {100 * share:.1f}% "
          f"(idle {100 * (1 - share):.1f}%), "
          f"{sum(e.count for e in kernels)} device ops")
    for name in PHASES:
        if name in phases:
            e = phases[name]
            print(f"  phase {name:20s} {_device_us(e) * 1e-3:9.3f} ms on "
                  f"the device's timeline ({e.count}x)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) * 1e-3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    for e in sorted(kernels, key=_device_us, reverse=True):
        if "repro::" in e.key:
            name = re.search(r"\w+_kernel(<[^>]*>)?", e.key)
            print(f"  port kernel {name.group() if name else e.key[:60]}: "
                  f"{_device_us(e) * 1e-3:.3f} ms in {e.count} launches")
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
