"""Process groups for the worker axis: one process per worker, as one
device is one worker in the reference (the counterpart of the device
handling in the JAX package's ``launch/env.py`` and of ``DeviceEngine``'s
worker mesh).

Two ways in:

  ``init_from_env(backend)``   under ``torchrun`` (``python -m
                               torch.distributed.run --nproc-per-node K``):
                               reads ``RANK``, ``WORLD_SIZE`` and
                               ``LOCAL_RANK`` and joins the launcher's
                               rendezvous.
  ``spawn(fn, world, backend)``  starts ``world`` fresh processes (the
                               ``spawn`` start method), each joining a group
                               through a ``FileStore`` (``file://`` init, so
                               parallel test workers never race for a port),
                               runs ``fn(rank, world, device, *args)`` and
                               returns the ranks' results in rank order.

A rank's device is ``cuda:{LOCAL_RANK % device_count()}``, or the CPU
when the caller asks for it: K ranks share one card when the host has
one.  NCCL refuses two ranks of one communicator on the same card, so K >
1 on one card runs with ``backend="gloo"`` (``core.collectives.DistAxis``
stages the card's tensors through host memory) and NCCL at world size
``device_count()``; the caller names the backend, and nothing falls back
from one to the other.  Every group takes a timeout in seconds, so a hung
collective fails the run instead of stalling it.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.collectives import DIST_BACKENDS

DEFAULT_TIMEOUT_S = 300


def rank_device(local_rank: int, device: str = "cuda") -> torch.device:
    """The device of the rank with this local index: the CPU when
    ``device="cpu"``, else ``cuda:{local_rank % device_count()}`` (raises
    on a host without a card)."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device={device!r} (want 'cuda' or 'cpu')")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device on this host; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device("cuda", local_rank % count)


def _check_backend(backend: str, device: str) -> None:
    if backend not in DIST_BACKENDS:
        raise ValueError(f"backend={backend!r} (want {DIST_BACKENDS})")
    if backend == "nccl" and device == "cpu":
        raise ValueError("backend='nccl' needs ranks on the card")


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def init_from_env(backend: str, device: str = "cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S
                  ) -> Tuple[int, int, torch.device]:
    """Join the process group ``torchrun`` set up (env:// rendezvous).
    Returns ``(rank, world_size, device)``; the rank's card, if any, is
    made the current one."""
    import torch.distributed as dist
    _check_backend(backend, device)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=_timeout(timeout_s))
    return rank, world, dev


def _rank_main(fn, rank: int, world: int, backend: str, init_file: str,
               device: str, timeout_s: float, args, result_path: str):
    """One spawned rank: join the group, run ``fn``, save its result (or
    the traceback) for the parent."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=_timeout(timeout_s))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"result": out}, result_path)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, result_path)
        raise


def spawn(fn: Callable, world: int, backend: str,
          init_file: Optional[str] = None, args: Sequence[Any] = (),
          device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S
          ) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks, each a
    fresh process in one ``backend`` group, and return their results in
    rank order.  ``fn`` and ``args`` must pickle (a module-level function;
    tensors go to the ranks by value), and each rank's result comes back
    through ``torch.save``.

    ``init_file`` is the ``FileStore`` path (a new file in a temporary
    directory when None; it must not exist yet).  On the card the kernel
    library is built here once, before the ranks start.  A rank that fails
    stops the others and raises here with its traceback; a run that
    outlives ``timeout_s`` (plus the ranks' start) is stopped and
    raises."""
    _check_backend(backend, device)
    if device == "cuda":
        rank_device(0, device)                 # raises without a card
        from repro_torch.kernels import build
        build.build()
    tmp = tempfile.mkdtemp(prefix="repro-torch-dist-")
    init_file = init_file or os.path.join(tmp, "store")
    if os.path.exists(init_file):
        raise ValueError(f"FileStore path {init_file} already exists")
    results = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file, device,
                               timeout_s, tuple(args), results[r]))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 120
        failed = None
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        got = [torch.load(path, map_location="cpu", weights_only=False)
               if os.path.exists(path) else {} for path in results]
        # the rank that failed first, else the first without a result
        bad = failed if failed is not None else next(
            (r for r, g in enumerate(got) if "result" not in g), None)
        if bad is not None:
            why = got[bad].get("error") or (
                f"exit code {procs[bad].exitcode}" + (
                    "" if failed is not None else
                    f" (stopped after {timeout_s} s)"))
            raise RuntimeError(f"rank {bad} of {world} ({backend}) failed:"
                               f"\n{why}")
        return [g["result"] for g in got]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
