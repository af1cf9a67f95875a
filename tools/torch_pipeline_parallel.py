"""Pipeline parallelism (GPipe, survey §3.2.3) on the port: a 4-stage
pipeline of tanh layers over micro-batches against the sequential stack,
showing the bubble fraction shrink as the micro-batch count grows (the
JAX package's examples/pipeline_parallel.py; the port's stages are
logical, on one device).

  PYTHONPATH=src python tools/torch_pipeline_parallel.py [--device cpu]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.pipeline import bubble_fraction, gpipe_forward  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    n_stages, d = 4, 64
    gen = torch.Generator().manual_seed(0)
    stage_w = (torch.randn(n_stages, d, d, generator=gen) / d ** 0.5).to(dev)

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    for n_micro in (1, 4, 16):
        xm = torch.randn(n_micro, 8, d, generator=gen).to(dev)
        out = gpipe_forward(stage_fn, list(stage_w), xm)
        seq = xm
        for i in range(n_stages):
            seq = torch.tanh(seq @ stage_w[i])
        err = (out - seq).abs().max().item()
        print(f"micro-batches={n_micro:3d}  bubble="
              f"{bubble_fraction(n_stages, n_micro):.2f}  max_err={err:.2e}")
        assert err == 0.0
    print("\npipeline == sequential; bubble -> 0 as micro-batches grow "
          "(GPipe Fig. 2).")


if __name__ == "__main__":
    main()
