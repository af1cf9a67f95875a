"""Quickstart on the port: build an architecture, train it on the
synthetic pipeline, checkpoint and register it, reload it and decode from
it — the public API in one script (the JAX package's
examples/quickstart.py).

  PYTHONPATH=src python tools/torch_quickstart.py [--device cpu]
  PYTHONPATH=src python tools/torch_quickstart.py --strategy ssp:2/ps/onebit@4

The default single-worker BSP spec trains through ``make_train_step``
(Adam, with the spec's compressor); any other cell trains through the
Strategy engine (SGD).  ``--full`` keeps the architecture's full width
(the card's size; the default is its ``.reduced()`` variant).
"""
import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.checkpoint import (ModelRegistry, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import FP32  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import Adam  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.train import (Strategy, Trainer, TrainState,  # noqa: E402
                               make_train_step, train_loop, value_and_grad)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--strategy", default="bsp/allreduce/onebit@1",
                    help="sync[:staleness]/arch/comp[:density]@workers")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    strat = Strategy.parse(args.strategy, lr=0.05, workers=1)

    # 1. model
    cfg = get_config(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    layout = model.leaf_layout(params)

    # 2. data pipeline (deterministic synthetic LM stream)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=8)
    batches = make_lm_batches(data, device=dev)

    # 3. trainer, configured by the strategy spec
    comp = strat.compressor
    if strat.workers == 1 and strat.sync == "bsp" and \
            strat.arch == "allreduce":
        step = make_train_step(model.loss_fn, Adam(), precision=FP32,
                               compressor=comp, layout=layout)
        state = TrainState.create(params, Adam(), comp, layout)
        state, hist = train_loop(step, state, lambda t: batches(t, 0),
                                 args.steps,
                                 log_every=max(1, args.steps // 5))
        trained = state["params"]
        print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"({hist[-1]['wire_bytes']:.0f} wire B/step, "
              f"{comp.method} compression)")
    else:
        grad_fn = value_and_grad(
            lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
        trained, hist, mets = Trainer(strat, device=dev).fit(
            grad_fn, params, batches, args.steps, layout=layout)
        print(f"{mets['spec']} on {mets['backend']} backend: loss "
              f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"({mets['wire_bytes']} wire B total)")

    # 4. checkpoint + registry (ModelDB-style)
    root = tempfile.mkdtemp(prefix="repro-torch-quickstart-")
    ck = os.path.join(root, "ckpt")
    save_checkpoint(ck, trained, step=args.steps)
    reg = ModelRegistry(os.path.join(root, "registry"))
    mid = reg.register("quickstart", ck, arch=cfg.name,
                       metrics={"loss": hist[-1]["loss"]})
    print("registered:", mid)

    # 5. reload + decode
    restored, _ = load_checkpoint(ck, trained)
    out = generate(model, restored, [[1, 2, 3, 4]], max_new_tokens=12,
                   device=dev)
    print("decoded:", out[0].tolist())


if __name__ == "__main__":
    main()
