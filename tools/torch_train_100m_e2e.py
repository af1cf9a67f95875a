"""End-to-end training on the port: a ~100M-parameter llama-family model
for a few hundred steps on the synthetic pipeline, with a cosine
schedule, and a final checkpoint and registry entry (the JAX package's
examples/train_100m_e2e.py).

  PYTHONPATH=src python tools/torch_train_100m_e2e.py --steps 300
  PYTHONPATH=src python tools/torch_train_100m_e2e.py --steps 4 \\
      --strategy bsp/allreduce/onebit@4 --device cpu --seq-len 16
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 tools/torch_train_100m_e2e.py \\
      --strategy bsp/allreduce/onebit@4 --dist-backend gloo

The strategy is one spec string (``Strategy.parse``).  bsp/allreduce
specs train through the full trainer path: AdamW + cosine schedule,
``make_train_step`` with the spec's compressor and, at K > 1 workers,
the TicTac-bucketed allreduce under ``make_sharded_train_step``.  The
workers are logical, on one device, unless ``--dist-backend`` is given:
then the script runs under ``torch.distributed.run`` with one process
per worker (``--nproc-per-node K``), each rank trains its worker
(``launch.dist.init_from_env``; several ranks share a card, and NCCL
needs one card per rank, so K ranks on one card take ``gloo``), and
rank 0 prints, writes the outputs and, last, one ``dist:`` JSON line of
every rank's peak device memory, step wall, bytes staged through the
host and kernel launches.  Every other cell trains through the Strategy
engine (SGD at ``--engine-lr``) via ``Trainer.fit``, over the process
group too when one is given; ``--failure-plan`` (e.g.
``crash:w1@5,resize:4@10``) runs it through the elastic trainer.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.checkpoint import ModelRegistry, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.collectives import DistAxis  # noqa: E402
from repro_torch.core.precision import FP32  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batches  # noqa: E402
from repro_torch.kernels import flash_attention, onebit, qsgd  # noqa: E402
from repro_torch.kernels import terngrad, topk  # noqa: E402
from repro_torch.launch.dist import init_from_env  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.schedule import cosine_warmup  # noqa: E402
from repro_torch.train import (Strategy, Trainer, TrainState,  # noqa: E402
                               make_bucketed_allreduce,
                               make_sharded_train_step, make_train_step,
                               train_loop, value_and_grad)


KERNEL_MODULES = (flash_attention, onebit, qsgd, terngrad, topk)


def fit_with_optimizer(strat, model, params, batches, args, dev, axis=None,
                       say=print):
    """AdamW + cosine for bsp/allreduce specs; K > 1 lifts the step over
    the workers, logical or (``axis``) one per rank."""
    opt, comp, K = AdamW(0.01), strat.compressor, strat.workers
    layout = model.leaf_layout(params)
    sched = cosine_warmup(args.lr, 20, args.steps)
    if K == 1 and axis is None:
        step = make_train_step(model.loss_fn, opt, sched, precision=FP32,
                               compressor=comp, layout=layout)
        state = TrainState.create(params, opt, comp, layout)
        state, hist = train_loop(step, state, lambda t: batches(t, 0),
                                 args.steps, log_every=10)
        return state["params"], hist
    reduce_fn = make_bucketed_allreduce(
        params, topology=strat.topology, bucket_mb=strat.bucket_mb,
        order=strat.order, layout=layout)
    step = make_train_step(model.loss_fn, opt, sched, precision=FP32,
                           compressor=comp, reduce_fn=reduce_fn,
                           layout=layout)
    state = TrainState.create(params, opt, comp, layout)
    rows = K if axis is None else len(axis.ids)
    if state["ef"] is not None:              # per-worker error feedback
        state["ef"] = [torch.zeros((rows,) + e.shape, device=dev)
                       for e in state["ef"]]
    sharded = make_sharded_train_step(step, K,
                                      compressed=state["ef"] is not None,
                                      axis=axis)
    say(f"data-parallel: {strat.spec()}, "
        f"{len(reduce_fn.fused_layers)} buckets ({strat.order} order)")

    def stacked(t):
        return tree_map(lambda *xs: torch.stack(xs),
                        *[batches(t, w) for w in range(K)])

    state, hist = train_loop(sharded, state, stacked, args.steps,
                             log_every=10)
    return state["params"], hist


def fit_with_strategy_engine(strat, model, params, batches, args, dev,
                             group=None, say=print):
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
    strat = dataclasses.replace(strat, lr=args.engine_lr)
    kw = {}
    if args.failure_plan:
        kw = dict(plan=args.failure_plan, checkpoint_every=args.
                  checkpoint_every, checkpoint_dir=os.path.join(
                      args.out, "elastic_ckpts"))
    params, hist, mets = Trainer(strat, device=dev, group=group).fit(
        grad_fn, params, batches, args.steps,
        layout=model.leaf_layout(params), **kw)
    say(f"strategy engine: {mets['spec']} on {mets['backend']} backend, "
        f"{mets['wire_bytes']} wire B total")
    return params, hist


def rank_report(dev, axis, wall: float, steps: int) -> dict:
    """This rank's diagnostics for the ``dist:`` line."""
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    launches = {}
    for mod in KERNEL_MODULES:
        launches.update(mod.LAUNCHES)
    return {"peak_bytes": int(peak), "step_s": wall / steps,
            "staged_bytes": int(axis.staged_bytes), "launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--strategy", default="bsp/allreduce/none@1")
    ap.add_argument("--engine-lr", type=float, default=0.05)
    ap.add_argument("--failure-plan", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--out", default="results/train_100m_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", choices=("gloo", "nccl"),
                    help="one process per worker under "
                    "torch.distributed.run (--nproc-per-node K)")
    args = ap.parse_args(argv)
    axis = group = None
    say = print
    if args.dist_backend:
        rank, world, dev = init_from_env(args.dist_backend, args.device)
        group = dist.group.WORLD
        axis = DistAxis(group, args.dist_backend)
        if rank:
            say = lambda *a, **k: None    # noqa: E731 (rank 0 reports)
    else:
        dev = torch.device(args.device)
    workers = int(args.strategy.rsplit("@", 1)[1].split(":", 1)[0]) \
        if "@" in args.strategy else 1
    strat = Strategy.parse(args.strategy, workers=workers)
    if axis is not None and axis.size != workers:
        raise SystemExit(f"{args.strategy} has {workers} workers; "
                         f"run {workers} processes (--nproc-per-node)")

    # ~100M-param member of the tinyllama (llama2) family
    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b"),
        name="tinyllama-100m", num_layers=10, d_model=640, d_ff=2560,
        num_heads=10, num_kv_heads=2, head_dim=64, vocab_size=32000)
    say(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batches = make_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        batch_size=args.batch_size), device=dev)

    t0 = time.time()
    if not args.failure_plan and strat.sync == "bsp" and \
            strat.arch == "allreduce" and not strat.is_hybrid and \
            strat.wire == "modeled":
        params, hist = fit_with_optimizer(strat, model, params, batches,
                                          args, dev, axis, say)
        trainer_used, lr_used = "adamw+cosine", args.lr
    else:
        params, hist = fit_with_strategy_engine(strat, model, params,
                                                batches, args, dev, group,
                                                say)
        trainer_used, lr_used = "strategy-engine-sgd", args.engine_lr
    wall = time.time() - t0
    if axis is not None:
        reports = [None] * axis.size
        dist.all_gather_object(reports, rank_report(dev, axis, wall,
                                                    args.steps))
        dist.destroy_process_group()
        if rank:
            return
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(hist, f, indent=1)
    ck = os.path.join(args.out, "ckpt_final")
    save_checkpoint(ck, params, step=args.steps)
    ModelRegistry(os.path.join(args.out, "registry")).register(
        "tinyllama-100m", ck, arch=cfg.name,
        hyperparams={"lr": lr_used, "trainer": trainer_used,
                     "steps": args.steps, "strategy": strat.spec()},
        metrics={"final_loss": hist[-1]["loss"]})
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"in {wall:.0f}s ({wall / args.steps:.2f}s/step)")
    if axis is not None:
        print("dist: " + json.dumps({"backend": args.dist_backend,
                                     "ranks": reports}))


if __name__ == "__main__":
    main()
