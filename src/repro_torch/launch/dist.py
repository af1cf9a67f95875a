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

Sub-groups (``subgroup``, ``prefix_group``, ``mesh_groups``,
``mesh_ladder``) are built by ``dist.new_group``, which every rank of the
world must call in the same order, members or not; each is built once per
process and then reused.  An engine builds its groups at its construction
or a resize, on the ranks of its own group: when that group is not the
whole world, the other ranks build the same groups beforehand
(``prefix_groups``, ``mesh_ladder(..., ranks=)``), so no rank waits on a
group another never asks for.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import DIST_BACKENDS
from repro_torch.launch.mesh import make_hybrid_mesh

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


# ------------------------------------------------------------ sub-groups
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def _ranks_of(parent) -> List[int]:
    """The global ranks of ``parent`` (the world when None), in its
    rank order."""
    import torch.distributed as dist
    if parent is None:
        return list(range(dist.get_world_size()))
    return list(dist.get_process_group_ranks(parent))


def subgroup(ranks: Sequence[int]):
    """The process group of the global ``ranks``, built on first use and
    cached; None on a rank outside them.  Building one is collective over
    the whole world: every rank calls it with the same ranks at the same
    point, members or not (``dist.new_group``; the world itself is
    returned as is)."""
    import torch.distributed as dist
    glob = tuple(int(r) for r in ranks)
    if glob == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if glob not in _GROUPS:
        _GROUPS[glob] = dist.new_group(list(glob))
    return _GROUPS[glob] if dist.get_rank() in glob else None


def prefix_group(m: int, parent=None):
    """The group of the first ``m`` ranks of ``parent`` (the world by
    default): the active workers after a resize to ``m`` (worker j on
    rank j, as the reference rebuilds its mesh over the first m live
    devices).  None on a rank past ``m``.  Collective as ``subgroup``:
    ranks outside ``parent`` build it beforehand (``prefix_groups``)."""
    return subgroup(_ranks_of(parent)[:m])


def prefix_groups(ranks: Sequence[int]) -> None:
    """Build the prefix groups of the global ``ranks`` (every size up to
    all of them) on this rank: what every rank of the world calls before
    an engine over those ranks resizes while other ranks sit it out."""
    for m in range(1, len(ranks) + 1):
        subgroup(list(ranks)[:m])


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """One rank's place in a data x tensor x stage mesh of ranks:
    ``coord`` (d, t, s) and the groups of its three lines (the ranks that
    differ from it in that coordinate only, in coordinate order)."""
    coord: Tuple[int, int, int]
    data: Any
    tensor: Any
    stage: Any


def mesh_groups(data: int, tensor: int, stage: int, parent=None,
                ranks: Optional[Sequence[int]] = None
                ) -> Optional[MeshGroups]:
    """Every line group of the mesh over ``parent``'s ranks (or the
    global ``ranks``), built in one fixed order (data lines, then tensor
    lines, then stage lines), and this rank's coordinate and lines; None
    on a rank outside the mesh.  Collective as ``subgroup``: when the mesh
    does not span the world, every other rank calls it first with
    ``ranks=``."""
    glob = list(ranks) if ranks is not None else _ranks_of(parent)
    if len(glob) != data * tensor * stage:
        raise ValueError(f"mesh {data}x{tensor}x{stage} over "
                         f"{len(glob)} ranks")
    # rank order is the reference's device order,
    # Mesh(np.array(devs).reshape(d, t, s)) (launch.mesh)
    grid = make_hybrid_mesh(data, tensor, stage, glob).devices
    lines = {}
    for axis, sel in (("data", lambda a, b: grid[:, a, b]),
                      ("tensor", lambda a, b: grid[a, :, b]),
                      ("stage", lambda a, b: grid[a, b, :])):
        n_a, n_b = [x for i, x in enumerate(grid.shape)
                    if i != ("data", "tensor", "stage").index(axis)]
        for a in range(n_a):
            for b in range(n_b):
                g = subgroup(sel(a, b).tolist())
                if g is not None:
                    lines[axis] = g
    import torch.distributed as dist
    where = np.argwhere(grid == dist.get_rank())
    if not len(where):
        return None
    d, t, s = (int(i) for i in where[0])
    return MeshGroups((d, t, s), lines["data"], lines["tensor"],
                      lines["stage"])


def mesh_ladder(data: int, tensor: int, stage: int, parent=None,
                ranks: Optional[Sequence[int]] = None) -> None:
    """Build every group a hybrid mesh over ``parent``'s ranks (or the
    global ``ranks``) can resize into along its data axis: for each data
    count from ``data`` down to 1, the group of its first ``d * tensor *
    stage`` ranks and that mesh's lines (``mesh_groups``), in that order.
    ``HybridEngine(group=)`` calls it at its construction, so a resize
    finds its groups built; ranks outside ``parent`` call it first with
    ``ranks=``.  Collective as ``subgroup``."""
    glob = list(ranks) if ranks is not None else _ranks_of(parent)
    ts = tensor * stage
    for d in range(data, 0, -1):
        subgroup(glob[:d * ts])
        mesh_groups(d, tensor, stage, ranks=glob[:d * ts])
