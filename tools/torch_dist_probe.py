"""The worker axis over torch.distributed on the card, without the rest
of chip_smoke.py:

    python tools/torch_dist_probe.py [--nccl-pair] [--phase26]

1. With ``--nccl-pair``: NCCL with two ranks on one card
   (``launch.dist.spawn`` gives both ranks ``cuda:0`` on a one-card
   host): prints how NCCL answers an all-gather there, expected to be
   its refusal of two ranks of one communicator on the same device.
2. With ``--phase26``: chip_smoke.py's phase 26 (``dist_phases``) at
   full-width TinyLlama-1.1B, with each rank's peak memory, step walls
   and staged bytes.

Needs a card; exits non-zero without one.
"""
import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def nccl_pair_rank(rank, world, dev):
    """An all-gather over the NCCL group, two ranks on one card."""
    from repro_torch.core.collectives import DistAxis
    ax = DistAxis(None, "nccl")
    return ax.all_gather(torch.full((1, 4), float(rank), device=dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nccl-pair", action="store_true")
    ap.add_argument("--phase26", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 1
    import subprocess
    from repro_torch.launch.dist import spawn
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, NCCL {torch.cuda.nccl.version()}; "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.nccl_pair:
        t0 = time.perf_counter()
        try:
            got = spawn(nccl_pair_rank, 2, "nccl", timeout_s=60)
            print(f"NCCL, 2 ranks on one card: ran, rank 0 gathered "
                  f"{got[0].tolist()}")
        except RuntimeError as e:
            lines = [x for x in str(e).splitlines() if x.strip()]
            print("NCCL, 2 ranks on one card: refused after "
                  f"{time.perf_counter() - t0:.1f} s:\n  "
                  + "\n  ".join(lines[:2] + lines[-4:]))
    if args.phase26:
        import chip_smoke as C
        from repro_torch.configs import get_config
        t0 = time.perf_counter()
        launches = C.dist_phases(get_config("tinyllama-1.1b"),
                                 torch.device("cuda"), smi)
        print(f"phase 26 in {time.perf_counter() - t0:.1f} s; launches "
              f"{launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
