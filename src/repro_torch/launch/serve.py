"""Serving launcher of the port: the continuous-batching engine, driven
by an open-loop arrival trace, on one device or, at ``--tp N`` under
``torch.distributed.run``, one tensor rank per process.

  # full-width TinyLlama-1.1B in bf16 on the GPU (seeded random weights)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --requests 16 --prompt-len 512 --max-new 64 --slots 8 --pages 16

  # DeepSeek-V2-Lite-16B (MoE + MLA) at full width; TinyLlama at --tp 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --tp 2

  # --tp 2 as two processes, one tensor rank each (Gloo: both ranks may
  # share one card; NCCL needs a card per rank); rank 0 prints
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.serve --tp 2 \
      --dist-backend gloo

  # the recurrent families: RecurrentGemma-9B (RG-LRU + local attention),
  # RWKV6-7B (attention-free); Whisper is not served here
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b

  # reduced config on the CPU (plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --dtype f32 --requests 8 --rate 0.5 --pages 4

  # traced, with the trace analysis and an SLO (obs/)
  PYTHONPATH=src python -m repro_torch.launch.serve --trace t.json \
      --report --slo 'ttft_p99<8'

``serve`` runs given requests through the engine the flags configure
(with tracing, the report and SLO monitoring); ``main`` draws the
flags' open-loop traffic, serves it and prints the metrics.  Without
``--dist-backend``, ``--tp`` runs logical ranks in one process; with it
the process joins ``torchrun``'s group (``launch.dist.init_from_env``),
whose size must be ``--tp``.  Nothing falls back from one mode to the
other.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.obs.slo import SLOMonitor
from repro_torch.obs.trace import TraceRecorder, tracing
from repro_torch.serve.autoscale import poisson_trace
from repro_torch.serve.batcher import POLICIES
from repro_torch.serve.engine import ServeConfig, ServeEngine, resolve_device
from repro_torch.serve.request import Request, SamplingParams

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (default: full width)")
    ap.add_argument("--slots", type=int, default=4,
                    help="max concurrent batch slots")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (req per engine "
                         "iteration); 0 = all requests arrive at t=0")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache capacity (0 = prompt+max_new)")
    ap.add_argument("--policy", choices=POLICIES, default="continuous")
    ap.add_argument("--pages", type=int, default=0,
                    help="KV page size (0 = contiguous per-slot cache)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool cap (0 = size for all slots full)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel decode degree (logical ranks in "
                         "this process, or with --dist-backend one rank "
                         "per process)")
    ap.add_argument("--dist-backend", choices=("gloo", "nccl"),
                    help="one tensor rank per process under "
                    "torch.distributed.run (--nproc-per-node = --tp)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window override (sub-quadratic decode)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="<= 0 is greedy argmax")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="weights, activations and KV cache")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome trace (request lifecycles + KV "
                         "occupancy); see docs/observability.md")
    ap.add_argument("--report", action="store_true",
                    help="print the trace analysis (latency summary, SLO "
                         "burn) after the run; implies tracing even "
                         "without --trace")
    ap.add_argument("--slo", action="append", default=[], metavar="SPEC",
                    help="attach an SLO objective, e.g. ttft_p99<8 "
                         "(repeatable); burning SLOs emit slo_burn "
                         "instants (docs/serving.md)")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, model, params, reqs, device,
          group=None) -> Tuple[dict, ServeEngine, Optional[TraceRecorder]]:
    """Run ``reqs`` through the engine the flags configure: the
    ``--trace`` / ``--report`` recorder around ``run``, an ``SLOMonitor``
    for the ``--slo`` objectives.  Prints what the JAX package's launcher
    prints for those flags; returns (metrics, engine, recorder or
    None).  ``group``: one tensor rank per process of it (every rank
    calls ``serve``; rank 0 traces and prints)."""
    dtype = DTYPES[args.dtype]
    max_len = args.max_len or (args.prompt_len + args.max_new)
    slo = SLOMonitor(args.slo) if args.slo else None
    eng = ServeEngine(model, params, ServeConfig(
        slots=args.slots, max_len=max_len, page_size=args.pages,
        num_pages=args.num_pages or None, policy=args.policy, tp=args.tp,
        window_override=args.window, cache_dtype=dtype, compute_dtype=dtype),
        device=device, slo=slo, group=group)
    if not eng.writer:
        return eng.run(reqs), eng, None
    rec = None
    with contextlib.ExitStack() as stack:
        if args.trace or args.report:
            rec = stack.enter_context(tracing(args.trace))
        metrics = eng.run(reqs)
    if args.trace:
        print(f"trace written to {args.trace}")
    if args.report and rec is not None:
        from repro_torch.obs.report import render
        print(render(rec.to_chrome(), slos=args.slo))
    if slo is not None:
        print(f"slo alerts: {len(eng.slo_alerts)}"
              + (f" (first at t={eng.slo_alerts[0]['t']})"
                 if eng.slo_alerts else ""))
    return metrics, eng, rec


def _join(args):
    """(device, group) for the flags: ``torchrun``'s group of ``--tp``
    ranks under ``--dist-backend``, else this process alone."""
    if args.dist_backend is None:
        if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
            raise SystemExit("under torch.distributed.run pass "
                             "--dist-backend {gloo,nccl} (one tensor rank "
                             "per process)")
        return resolve_device(args.device), None
    if "RANK" not in os.environ:
        raise SystemExit("--dist-backend needs torch.distributed.run "
                         "(--nproc-per-node = --tp)")
    import torch.distributed as dist

    from repro_torch.launch.dist import init_from_env
    world = int(os.environ["WORLD_SIZE"])
    if world != args.tp:
        raise SystemExit(f"--tp {args.tp} under a world of {world} "
                         "processes (they must be equal)")
    _, _, device = init_from_env(args.dist_backend, args.device)
    return device, dist.group.WORLD


def main(argv=None, group=None):
    """The flags' traffic through the engine; prints the metrics (rank 0
    of a group) and returns them.  ``group``: a process group of ``--tp``
    ranks the caller has already joined, in place of ``torchrun``'s."""
    args = parse_args(argv)
    joins = group is None
    if joins:
        device, group = _join(args)
    else:
        device = resolve_device(args.device)
    try:
        return _main(args, device, group)
    finally:
        if joins and group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, device, group):
    dtype = DTYPES[args.dtype]
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise SystemExit("use examples/whisper_decode.py for enc-dec serving")
    model = build_model(cfg)
    params = model.init(seed=args.seed, dtype=dtype, device=device)

    horizon = max(1.0, args.requests / args.rate) if args.rate > 0 else 1.0
    arrivals = ([0.0] + poisson_trace(args.rate, horizon, seed=args.seed,
                                      max_requests=args.requests - 1)
                if args.rate > 0 else [0.0] * args.requests)
    rng = np.random.RandomState(args.seed + 1)
    prompts = rng.randint(1, cfg.vocab_size,
                          size=(len(arrivals), args.prompt_len))
    reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=args.max_new, arrival=arrivals[i],
                    sampling=SamplingParams(temperature=args.temperature,
                                            top_k=args.top_k,
                                            seed=args.seed + i))
            for i in range(len(arrivals))]
    metrics, eng, _ = serve(args, model, params, reqs, device, group)
    if not eng.writer:
        return metrics

    print(f"{cfg.name}: {cfg.param_count() / 1e9:.2f} B params, {args.dtype} "
          f"on {device}")
    for r in reqs[:4]:
        print(f"req {r.rid}: arrival={r.arrival:5.1f} "
              f"ttft={r.first_token_latency():5.1f} "
              f"output={r.output[:8]}{'...' if len(r.output) > 8 else ''}")
    if len(reqs) > 4:
        print(f"... {len(reqs) - 4} more")
    print(f"policy={metrics['policy']} paged={metrics['paged']} "
          f"tp={metrics['tp']}")
    print(f"{metrics['completed']} requests, "
          f"{metrics['generated_tokens']} tokens in "
          f"{metrics['clock']:.0f} iterations "
          f"({metrics['tokens_per_s']:.2f} tok/iter, "
          f"{metrics['wall_s']:.2f}s wall)")
    print(f"first-token p50/p99: {metrics['p50_first_token']:.1f}/"
          f"{metrics['p99_first_token']:.1f} iters   per-token p50/p99: "
          f"{metrics['p50_per_token']:.2f}/{metrics['p99_per_token']:.2f}"
          f"   stalls: {metrics['admission_stalls']}")
    if group is not None:
        import torch.distributed as dist
        print(f"tp ranks ({dist.get_backend(group)}): cache "
              f"{[round(b / 2**20, 3) for b in metrics['rank_cache_bytes']]}"
              f" MiB, weights "
              f"{[round(b / 2**20, 3) for b in metrics['rank_param_bytes']]}"
              " MiB per rank")
    return metrics


if __name__ == "__main__":
    main()
