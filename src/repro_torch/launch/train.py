"""Training launcher of the port (the JAX package's ``launch/train.py``):
the Adam trainer (``make_train_step`` under ``cosine_warmup``) on one
worker, on the synthetic LM stream.

  # full-width TinyLlama-1.1B on the GPU (seeded random weights)
  PYTHONPATH=src python -m repro_torch.launch.train --steps 3 \\
      --compress onebit

  # reduced config on the CPU (plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \\
      --device cpu

  # Whisper's encoder-decoder (seeded frame embeddings beside the tokens),
  # reduced on the CPU or at full width and 2 + 2 layers on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --smoke --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --layers 2 --steps 1 --batch-size 2

  # traced, with the step-time attribution report (obs/)
  PYTHONPATH=src python -m repro_torch.launch.train --steps 3 \\
      --trace t.json --report

``build`` makes the run from parsed flags (and, optionally, given
parameters and the plain path's backends), ``train`` drives it and
``main`` prints one JSON line per logged step.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List

import torch

from repro_torch.configs import get_config
from repro_torch.core.compression import METHODS, Compressor
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.obs.trace import tracing
from repro_torch.optim import OPTIMIZERS
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.serve.engine import resolve_device
from repro_torch.train.train_loop import (TrainState, make_train_step,
                                          train_loop)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (default: full width)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (an "
                         "encoder-decoder's encoder too); 0 = the "
                         "config's")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adam", choices=list(OPTIMIZERS))
    ap.add_argument("--compress", default="none", choices=list(METHODS))
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome trace (Perfetto-loadable) of the "
                         "run; see docs/observability.md")
    ap.add_argument("--report", action="store_true",
                    help="print the trace analysis (step-time "
                         "attribution etc.) after the run; implies "
                         "tracing even without --trace")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    step: Callable          # make_train_step's train_step
    state: Dict[str, Any]   # TrainState.create's
    batch_fn: Callable      # t -> batch on the run's device
    steps: int
    log_every: int


FRAME_SEED = 7


def encoder_decoder_batches(cfg, batches, batch_size: int, device):
    """The reference launcher's encoder-decoder batch: the LM stream's
    tokens and labels beside ``frames [B, max_source_positions, d]``, the
    conv front end's stub output, drawn for step t from a
    ``torch.Generator`` seeded ``FRAME_SEED + t`` (the reference folds t
    into ``PRNGKey(7)``)."""
    def batch_fn(t):
        b = batches(t, 0)
        gen = torch.Generator(device=device).manual_seed(FRAME_SEED + t)
        return {"frames": torch.randn(
                    batch_size, cfg.max_source_positions, cfg.d_model,
                    generator=gen, device=device),
                "tokens": b["tokens"], "labels": b["labels"]}
    return batch_fn


def config(args: argparse.Namespace):
    """The flags' model config: ``--smoke`` reduces it, ``--layers`` cuts
    its depth."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers:
        cut = dict(num_layers=args.layers)
        if cfg.is_encoder_decoder:
            cut["encoder_layers"] = args.layers
        cfg = dataclasses.replace(cfg, **cut)
    return cfg


def build(args: argparse.Namespace, params=None, attn_backend: str = "auto",
          kernel_backend: str = "auto") -> TrainRun:
    """The run the flags describe.  ``params`` (a tree for the flags'
    config, e.g. carried over from the JAX init) replaces the seeded init;
    ``attn_backend`` and ``kernel_backend`` (``"ref"``: the plain path)
    go to the model config and the compressor."""
    device = resolve_device(args.device)
    cfg = config(args)
    model = build_model(dataclasses.replace(cfg, attn_backend=attn_backend))
    if params is None:
        params = model.init(seed=0, device=device)
    else:
        params = tree_map(lambda t: t.to(device), params)
    batches = make_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        batch_size=args.batch_size), device=device)
    opt = OPTIMIZERS[args.optimizer]()
    comp = Compressor(args.compress, backend=kernel_backend)
    layout = model.leaf_layout(params)
    step = make_train_step(model.loss_fn, opt,
                           cosine_warmup(args.lr, 5, args.steps),
                           precision=PrecisionPolicy(
                               compute_dtype=args.compute_dtype),
                           compressor=comp, layout=layout)
    if cfg.is_encoder_decoder:
        batch_fn = encoder_decoder_batches(cfg, batches, args.batch_size,
                                           device)
    else:
        batch_fn = lambda t: batches(t, 0)
    return TrainRun(step=step,
                    state=TrainState.create(params, opt, comp, layout),
                    batch_fn=batch_fn, steps=args.steps,
                    log_every=max(1, args.steps // 10))


def train(run: TrainRun):
    """Drive the run through ``train_loop``: (state, history)."""
    return train_loop(run.step, run.state, run.batch_fn, run.steps,
                      log_every=run.log_every)


def json_lines(hist: List[dict]) -> List[str]:
    """The reference's log lines: each logged step's metrics to 5
    decimals."""
    return [json.dumps({k: round(v, 5) for k, v in rec.items()})
            for rec in hist]


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    t0 = time.time()
    run = build(args)
    rec = None
    with contextlib.ExitStack() as stack:
        if args.trace or args.report:
            rec = stack.enter_context(tracing(args.trace))
        _, hist = train(run)
    if args.trace:
        print(f"trace written to {args.trace}")
    if args.report and rec is not None:
        from repro_torch.obs.report import render
        print(render(rec.to_chrome()))
    for line in json_lines(hist):
        print(line)
    print(f"done in {time.time() - t0:.1f}s; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
