"""Where a dry-run step's card memory parts from its meta count.

For each arch:shape pair, at a few layer groups and batch rows:

  meta   ``launch.dryrun.meta_memory``: the storages the step's aten ops
         make on ``meta`` under ``kernels.backend.meta_as_card``;
  card   the same step on the card under a dispatch mode that reads the
         caching allocator around every aten op: the step's peak of
         ``memory_allocated`` (the state built before it included, as
         ``time_step`` reads it), and each op's transient, the most it
         held above what it kept (a workspace or an internal copy that
         no meta storage stands for).

It prints both peaks and their ratio (or that the run ran out of
memory), then the largest transients by op and input shapes.
``--depth-model`` adds, without a card, the dry-run's per-row model
(``memory_model``) beside a direct meta count at full depth and each
pair's batch.  ``--batch-table`` prints, for every dry-run pair, the
batch ``launch.dryrun.batch_plan`` picks against this card's budget
(meta counts only; ``--pairs`` is then ignored; without a card
``--budget-gib`` names the budget).

    PYTHONPATH=src python tools/torch_memory_probe.py \
        [--pairs whisper-large-v3:train_4k,...] [--groups 1,2]
        [--batches 1,2] [--depth-model] [--batch-table [--budget-gib G]]

Without ``--depth-model`` or ``--budget-gib`` it needs a card and exits
non-zero without one.
"""
import argparse
import collections
import gc
import os
import subprocess
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.cost import _tensors  # noqa: E402

GIB = 2 ** 30
PAIRS = ("whisper-large-v3:train_4k,whisper-large-v3:prefill_32k,"
         "whisper-large-v3:decode_32k,tinyllama-1.1b:train_4k")
# each pair's full-depth batch on the card (its count against 0.8 of 80 GB)
RUN_BATCH = {("whisper-large-v3", "train_4k"): 8,
             ("whisper-large-v3", "prefill_32k"): 2,
             ("whisper-large-v3", "decode_32k"): 8,
             ("tinyllama-1.1b", "train_4k"): 6}


class CardOps(TorchDispatchMode):
    """The allocator's view of every aten op under it: the running peak
    and each op's transient above what it leaves allocated."""

    def __init__(self, dev, threshold: int):
        super().__init__()
        self.dev, self.threshold = dev, threshold
        self.peak = 0
        self.transients = collections.defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        out = func(*args, **(kwargs or {}))
        during = torch.cuda.max_memory_allocated(self.dev)
        after = torch.cuda.memory_allocated(self.dev)
        self.peak = max(self.peak, during)
        extra = during - max(before, after)
        if extra >= self.threshold:
            shapes = tuple(tuple(t.shape) for t in _tensors((args, kwargs)))
            slot = self.transients[(str(func), shapes)]
            slot[0] += 1
            slot[1] = max(slot[1], extra)
        return out


def card_peak(cfg, shape, batch: int, dev, threshold: int):
    gc.collect()
    torch.cuda.empty_cache()
    step, args = D._state(cfg, shape, batch, dev)
    mode = CardOps(dev, threshold)
    mode.peak = torch.cuda.memory_allocated(dev)
    with mode:
        out = step(*args)
    torch.cuda.synchronize(dev)
    del out, step, args
    return mode


def depth_model(pairs) -> None:
    """The dry-run's per-row model against a direct meta count at full
    depth and the pair's batch (no card)."""
    for arch, s in pairs:
        cfg, shape = get_config(arch), get_shape(s)
        b = RUN_BATCH.get((arch, s), 1)
        mem = D.memory_model(cfg, shape)
        model = mem["fixed"] + b * mem["row"]
        direct = D.meta_memory(cfg, shape, b)["peak"]
        print(f"{arch} x {s} at batch {b}: memory_model {model / GIB:.2f} "
              f"GiB, direct full-depth meta count {direct / GIB:.2f} GiB "
              f"(model / direct {model / direct:.3f})", flush=True)


def batch_table(budget: float) -> None:
    """Every dry-run pair's batch and basis under ``batch_plan`` against
    ``budget`` bytes, with the memory model's terms and the count at that
    batch."""
    from repro_torch.configs import ARCHS, SKIPS
    print(f"budget {budget / GIB:.2f} GiB", flush=True)
    for arch in ARCHS:
        for s in D.SHAPES:
            if (arch, s) in SKIPS:
                continue
            shape = get_shape(s)
            mem = D.memory_model(get_config(arch), shape)
            b, _, basis = D.batch_plan(mem, shape, budget)
            two = basis == "2 groups"
            fixed, row = ((mem["fixed2"], mem["row2"]) if two
                          else (mem["fixed"], mem["row"]))
            count = (f"{(fixed + b * row) / GIB:.2f} GiB" if b
                     else "exceeds")
            print(f"{arch} x {s}: batch {b} ({basis}); fixed "
                  f"{fixed / GIB:.2f} GiB, row {row / GIB:.3f} GiB; "
                  f"counted {count}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", default=PAIRS)
    ap.add_argument("--groups", default="1,2")
    ap.add_argument("--batches", default="1,2")
    ap.add_argument("--threshold-mib", type=float, default=64.0)
    ap.add_argument("--depth-model", action="store_true")
    ap.add_argument("--batch-table", action="store_true")
    ap.add_argument("--budget-gib", type=float, default=None)
    args = ap.parse_args(argv)
    pairs = [tuple(p.split(":")) for p in args.pairs.split(",")]
    if args.depth_model:
        depth_model(pairs)
        return 0
    if args.batch_table and args.budget_gib is not None:
        batch_table(args.budget_gib * GIB)
        return 0
    if not torch.cuda.is_available():
        print("torch_memory_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    from repro_torch.kernels import build
    build.build()
    dev = torch.device("cuda")
    if args.batch_table:
        batch_table(D.card_budget(dev))
        return 0
    for arch, s in pairs:
        for g in (int(x) for x in args.groups.split(",")):
            cfg = D._depth_variant(get_config(arch), g)
            shape = get_shape(s)
            for b in (int(x) for x in args.batches.split(",")):
                meta = D.meta_memory(cfg, shape, b)
                try:
                    mode = card_peak(cfg, shape, b, dev,
                                     int(args.threshold_mib * 2 ** 20))
                except torch.cuda.OutOfMemoryError:
                    print(f"{arch} x {s}, {g} group(s), batch {b}: out of "
                          f"memory; meta count {meta['peak'] / GIB:.3f} GiB;"
                          f" {smi}", flush=True)
                    continue
                print(f"{arch} x {s}, {g} group(s), batch {b}: card peak "
                      f"{mode.peak / GIB:.3f} GiB, meta count "
                      f"{meta['peak'] / GIB:.3f} GiB (card / meta "
                      f"{mode.peak / meta['peak']:.3f}); weights "
                      f"{meta['weights'] / GIB:.3f} GiB; {smi}", flush=True)
                top = sorted(mode.transients.items(),
                             key=lambda kv: -kv[1][1])[:8]
                for (op, shapes), (n, most) in top:
                    print(f"    transient {most / GIB:.3f} GiB x{n}: {op} "
                          f"{list(shapes)[:4]}")
                del mode
    return 0


if __name__ == "__main__":
    sys.exit(main())
