"""Where the port's Adam update spends its time on the GPU.

Full-width TinyLlama-1.1B in fp32 (seeded weights), seeded random
gradients and Adam state: one warm-up ``Adam.step``, the wall time of
``STEPS`` steps (host clock around work that ends in a synchronize), then
one step under ``torch.profiler`` for the device's busy share, the number
of device operations and the kernels that take the time.  The bound reads
p, g, m, v and writes p, m, v once each: 28 B per parameter over the
H100's 3.35 TB/s.

    PYTHONPATH=src python tools/torch_adam_profile.py [--src DIR]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
older design, timed in the same call).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

STEPS, HBM_BYTES_PER_S = 3, 3.35e12


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_adam_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.core.tree import get_path, leaf_paths, tree_map
    from repro_torch.models import build_model
    from repro_torch.optim import Adam

    dev = torch.device("cuda")
    params = build_model(get_config("tinyllama-1.1b")).init(seed=0,
                                                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, device=dev,
                                           generator=gen) * 1e-3, params)
    opt = Adam()
    state = opt.init(params)
    paths = leaf_paths(params)
    n = sum(get_path(params, p).numel() for p in paths)
    opt.step(params, grads, state, 3e-3)                 # warm-up
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step(params, grads, state, 3e-3)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    bound_ms = 28 * n / HBM_BYTES_PER_S * 1e3
    print(f"adam update ({args.src}): {n} parameters in "
          f"{len(paths)} tensors, wall "
          f"{[round(w * 1e3, 2) for w in walls]} ms, bound {bound_ms:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.step(params, grads, state, 3e-3)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) * 1e-3
    print(f"profiled step: device busy {busy_ms:.2f} ms = "
          f"{100 * busy_ms / (wall * 1e3):.1f}% of the fastest wall "
          f"(idle {100 * (1 - busy_ms / (wall * 1e3)):.1f}%), "
          f"{sum(e.count for e in kernels)} device ops")
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        print(f"  {_device_us(e) * 1e-3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
