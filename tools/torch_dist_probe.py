"""The worker axis over torch.distributed on the card, without the rest
of chip_smoke.py:

    python tools/torch_dist_probe.py [--nccl-pair] [--segments] [--phase26]
        [--phase27] [--phase28]

1. With ``--nccl-pair``: NCCL with two ranks on one card
   (``launch.dist.spawn`` gives both ranks ``cuda:0`` on a one-card
   host): prints how NCCL answers an all-gather there, expected to be
   its refusal of two ranks of one communicator on the same device.
2. With ``--segments``: the stochastic codecs' per-worker scales at the
   ring chunk lengths of phase 26's @4 cells, taken over a [4, L] tensor
   (the logical axis's launch) and over each [1, L] row (a rank's): the
   rows whose bits differ, for one reduction over dimension 1 (the
   terngrad sigma's ``var_mean``, the qsgd norm's ``vector_norm``) and
   for ``kernels.segments.per_segment``.
3. With ``--phase26``: chip_smoke.py's phase 26 (``dist_phases``) at
   full-width TinyLlama-1.1B, with each rank's peak memory, step walls
   and staged bytes.
4. With ``--phase27`` / ``--phase28``: chip_smoke.py's phase 27 (the
   elastic interface and the hybrid engine over ranks) and / or phase 28
   (tensor-parallel serving over 2 ranks, the hybrid engine's elastic
   interface over 4) through ``elastic_hybrid_phases``, at full-width
   TinyLlama-1.1B; phase 19's serving runs first (``family_phases(...,
   only_tp=True)``), as phase 28a holds its ranks to them.

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


def segment_rows(dev) -> None:
    """``--segments``: rows of a [4, L] reduction that differ from the same
    row reduced as [1, L], per reduction and length."""
    import dataclasses
    from repro_torch.comm.plan import CommPlan
    from repro_torch.configs import get_config
    from repro_torch.kernels.segments import per_segment
    from repro_torch.kernels.terngrad.ref import std0
    from repro_torch.models import build_model

    def norm(t, dim):
        return torch.linalg.vector_norm(t, dim=dim)

    model = build_model(dataclasses.replace(get_config("tinyllama-1.1b"),
                                            num_layers=2))
    params = model.init(seed=0, dtype=torch.float32, device="meta")
    for L in CommPlan.plan(model.leaf_layout(params).shapes(params),
                           n=4).chunk_lens():
        gen = torch.Generator(device=dev).manual_seed(L)
        x = torch.randn(4, L, generator=gen, device=dev)
        for name, fn in (("std0", std0), ("l2 norm", norm)):
            whole = fn(x, dim=1)
            split = per_segment(fn, x)
            one = [fn(x[r:r + 1], dim=1)[0] for r in range(4)]
            alone = [per_segment(fn, x[r:r + 1])[0] for r in range(4)]
            print(f"  L {L}, {name}: dim-1 reduction, rows differing "
                  f"between [4, L] and [1, L]: "
                  f"{sum(not torch.equal(whole[r], one[r]) for r in range(4))}"
                  f" of 4 (largest {max(abs(whole[r] - one[r]).item() for r in range(4)):.3e}); "
                  f"per_segment: "
                  f"{sum(not torch.equal(split[r], alone[r]) for r in range(4))}"
                  f" of 4", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nccl-pair", action="store_true")
    ap.add_argument("--segments", action="store_true")
    ap.add_argument("--phase26", action="store_true")
    ap.add_argument("--phase27", action="store_true")
    ap.add_argument("--phase28", action="store_true")
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
    if args.segments:
        segment_rows(torch.device("cuda"))
    if args.phase26:
        import chip_smoke as C
        from repro_torch.configs import get_config
        t0 = time.perf_counter()
        launches = C.dist_phases(get_config("tinyllama-1.1b"),
                                 torch.device("cuda"), smi)
        print(f"phase 26 in {time.perf_counter() - t0:.1f} s; launches "
              f"{launches}")
    phases = tuple(n for n in ("27", "28") if getattr(args, "phase" + n))
    if phases:
        import chip_smoke as C
        from repro_torch.configs import get_config
        dev, cfg = torch.device("cuda"), get_config("tinyllama-1.1b")
        t0 = time.perf_counter()
        _, tp_ref = C.family_phases(dev, smi, cfg, None, None,
                                    only_tp=True)
        t1 = time.perf_counter()
        launches = C.elastic_hybrid_phases(cfg, dev, smi, tp_ref,
                                           phases=phases)
        print(f"phase 19's serving in {t1 - t0:.1f} s; phase(s) "
              f"{'-'.join(phases)} in {time.perf_counter() - t1:.1f} s; "
              f"launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
