"""The port's worker-axis seam: the collectives every schedule of
``comm.transport`` is written against, behind one axis object.

The JAX package runs its collective schedules inside ``shard_map``, one
program per device, with ``lax.ppermute`` / ``axis_index`` / ``psum`` over
a named axis.  Here a schedule takes an axis and a tensor ``x`` whose row
``r`` is the value of worker ``axis.ids[r]``, one row per worker this
process holds:

  ``LogicalAxis(n)``        all n workers in one process, stacked on
                            dimension 0 (``ids`` = 0..n-1); every
                            collective is an index operation over the rows.
                            This is the default, on the CPU or one card.
  ``DistAxis(group, backend)``  one worker per ``torch.distributed`` rank
                            (``ids`` = [rank]); ``ppermute`` is one
                            ``batch_isend_irecv`` per hop, ``all_gather``
                            the backend's gather, ``psum_scatter`` one
                            all-to-all of every worker's chunks.  The
                            group may be a sub-group of the world (a
                            mesh's data, tensor or stage line, or the
                            active workers after a resize:
                            ``launch.dist.subgroup``); ``sendrecv`` hands
                            one tensor on and takes one in (a pipeline
                            tick's hop, a resize's row).

Both take the reference's hop order, ``broadcast`` hands one worker's
tensor to every worker unchanged, and ``psum`` / ``psum_scatter`` add
the workers' values in worker order (never ``dist.all_reduce``, whose
summation order is the backend's), so every worker's sums are rounded as
on the reference and equal bit for bit across the two axes.  Gloo's
point-to-point ops take only CPU tensors: with ``backend="gloo"`` and
tensors on the card, ``DistAxis`` stages each one through pinned host
memory and counts the bytes it stages (``staged_bytes``); ``recv_bytes``
counts what each rank receives from the backend, on any device.  NCCL
takes the card's tensors directly.  The module functions below are the logical
axis's, kept for the callers that stack workers themselves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

Perm = Sequence[Tuple[int, int]]
Hop = Union[torch.Tensor, Dict[str, torch.Tensor]]

DIST_BACKENDS = ("gloo", "nccl")


def axis_size(x: torch.Tensor) -> int:
    return x.shape[0]


def axis_index(x: torch.Tensor) -> torch.Tensor:
    """Each worker's index, [n] on ``x``'s device."""
    return torch.arange(x.shape[0], device=x.device)


def ppermute(x: torch.Tensor, perm: Perm) -> torch.Tensor:
    """``lax.ppermute``: worker ``dst`` receives worker ``src``'s row for
    every ``(src, dst)`` in ``perm``; a worker that receives nothing gets
    zeros."""
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    out = torch.zeros_like(x)
    out[dst] = x[src]
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather``: every worker holds every row, [n, n, ...]."""
    return x[None].expand((x.shape[0],) + tuple(x.shape))


def psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum``: every worker holds the sum over workers, taken in
    worker order."""
    acc = x[0].clone()
    for w in range(1, x.shape[0]):
        acc += x[w]
    return acc[None].expand_as(x)


def psum_scatter(x) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=0, tiled=False)``: ``x[w]``
    is worker w's ``[n, m]`` contribution (``x`` a ``[n, n, m]`` tensor or
    a sequence of n such tensors); worker r receives the worker-order sum
    of chunk r, so the result is ``[n, m]``.  A worker that contributes
    nothing may pass a zero view (``t.new_zeros(()).expand(n, m)``): the
    sum then adds exact zeros and holds no copy of them."""
    acc = x[0].clone(memory_format=torch.contiguous_format)
    for w in range(1, len(x)):
        acc += x[w]
    return acc


class LogicalAxis:
    """n workers stacked on dimension 0 of every tensor, in one process."""

    def __init__(self, n: int):
        self.size = n
        self.ids: List[int] = list(range(n))
        self.device = torch.device("cpu")     # where ``gather_values`` works

    @property
    def holds_all(self) -> bool:
        return True

    def index(self, x: torch.Tensor) -> torch.Tensor:
        return axis_index(x)

    def ppermute(self, x: Hop, perm: Perm) -> Hop:
        if isinstance(x, dict):
            return {k: ppermute(v, perm) for k, v in x.items()}
        return ppermute(x, perm)

    def all_gather(self, x: Hop) -> Hop:
        if isinstance(x, dict):
            return {k: all_gather(v) for k, v in x.items()}
        return all_gather(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x)

    def psum_scatter(self, x) -> torch.Tensor:
        return psum_scatter(x)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Worker ``src``'s tensor on every worker: one process holds
        them all, so ``x`` is already it."""
        return x


class DistAxis:
    """One worker per rank of a ``torch.distributed`` process group: this
    process holds row ``rank`` only (``ids == [rank]``), and every tensor
    a schedule hands in is ``[1, ...]``.

    ``backend`` names the group's backend ("gloo" or "nccl"); it decides
    where the bytes travel and nothing falls back from one to the other.
    Under gloo, tensors on the card are staged through pinned host
    buffers, and ``staged_bytes`` counts every byte copied to or from the
    host."""

    def __init__(self, group=None, backend: str = "gloo"):
        import torch.distributed as dist
        if backend not in DIST_BACKENDS:
            raise ValueError(f"backend={backend!r} (want {DIST_BACKENDS})")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.backend = backend
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ids = [self.rank]
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "nccl" else torch.device("cpu"))
        self.staged_bytes = 0
        self.recv_bytes = 0

    @property
    def holds_all(self) -> bool:
        return self.size == 1

    def index(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.ids, device=x.device)

    def _peer(self, group_rank: int) -> int:
        return self._dist.get_global_rank(self.group, group_rank)

    # ------------------------------------------------------------ staging
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend sends it: contiguous, bool as bytes, and
        under gloo in (pinned, when staged from the card) host memory."""
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.view(torch.uint8)
        if self.backend == "gloo" and x.device.type != "cpu":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            self.staged_bytes += host.numel() * host.element_size()
            return host
        return x

    def _buffer(self, like: torch.Tensor, shape) -> torch.Tensor:
        dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
        if self.backend == "gloo" and like.device.type != "cpu":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=like.device)

    def _back(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received buffer as a tensor like ``like`` (device, dtype)."""
        self.recv_bytes += buf.numel() * buf.element_size()
        if buf.device != like.device:
            self.staged_bytes += buf.numel() * buf.element_size()
            buf = buf.to(like.device)
        return buf.view(torch.bool) if like.dtype == torch.bool else buf

    # -------------------------------------------------------- collectives
    def ppermute(self, x: Hop, perm: Perm) -> Hop:
        """One hop: every (src, dst) pair of ``perm`` in one
        ``batch_isend_irecv``.  Every rank calls it with the same ``perm``;
        a rank that receives nothing gets zeros.  ``x`` may be a dict of
        planes, which travel in the same batch."""
        planes = x if isinstance(x, dict) else {"": x}
        me = self.rank
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        out: Dict[str, torch.Tensor] = {}
        ops, recvs = [], []
        for k, p in planes.items():
            if src and src[0] == me:               # a hop to itself
                out[k] = p.clone()
                continue
            if dst:
                ops.append(self._dist.P2POp(self._dist.isend, self._wire(p),
                                            self._peer(dst[0]), self.group))
            if src:
                buf = self._buffer(p, p.shape)
                ops.append(self._dist.P2POp(self._dist.irecv, buf,
                                            self._peer(src[0]), self.group))
                recvs.append((k, buf, p))
            else:
                out[k] = torch.zeros_like(p)
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        for k, buf, p in recvs:
            out[k] = self._back(buf, p)
        return out if isinstance(x, dict) else out[""]

    def all_gather(self, x: Hop) -> Hop:
        """``lax.all_gather``: ``x`` [1, ...] -> [1, n, ...], every worker's
        row in worker order (a dict of planes gathers plane by plane)."""
        if isinstance(x, dict):
            return {k: self.all_gather(v) for k, v in x.items()}
        src = self._wire(x[0])
        out = self._buffer(x, (self.size,) + tuple(x.shape[1:]))
        if self.backend == "nccl":
            self._dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            self._dist.all_gather(list(out.unbind(0)), src, group=self.group)
        return self._back(out, x)[None]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The worker-order sum of every worker's row, [1, ...]."""
        rows = self.all_gather(x)[0]
        acc = rows[0].clone()
        for w in range(1, self.size):
            acc += rows[w]
        return acc[None]

    def psum_scatter(self, x) -> torch.Tensor:
        """``x[0]`` is this worker's ``[n, m]`` contribution; returns the
        worker-order sum of chunk ``rank``, [1, m].  One all-to-all hands
        chunk j of every worker to worker j, so a rank receives n chunks
        (not the n x n of an all-gather), and sums them in worker order."""
        mine = x[0]
        src = self._wire(mine.reshape(self.size, -1))
        out = self._buffer(mine, tuple(src.shape))
        self._dist.all_to_all_single(out, src, group=self.group)
        rows = self._back(out, mine)             # [n workers, m]
        acc = rows[0].clone()
        for w in range(1, self.size):
            acc += rows[w]
        return acc.reshape(mine.shape[1:])[None]

    def sendrecv(self, x: Optional[torch.Tensor], dst: Optional[int],
                 like: Optional[torch.Tensor], src: Optional[int]
                 ) -> Optional[torch.Tensor]:
        """One point-to-point step in one ``batch_isend_irecv``: send
        ``x`` to worker ``dst`` and receive a tensor shaped and typed like
        ``like`` from worker ``src`` (either side may be None).  The
        pairs must match across the ranks that call it.  Returns the
        received tensor on ``like``'s device, or None."""
        ops, buf = [], None
        if dst is not None:
            ops.append(self._dist.P2POp(self._dist.isend, self._wire(x),
                                        self._peer(dst), self.group))
        if src is not None:
            buf = self._buffer(like, like.shape)
            ops.append(self._dist.P2POp(self._dist.irecv, buf,
                                        self._peer(src), self.group))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return None if buf is None else self._back(buf, like)

    def gather(self, x: torch.Tensor, dst: int = 0
               ) -> Optional[torch.Tensor]:
        """Every worker's ``x`` [...] on worker ``dst`` as [n, ...] in
        worker order (host memory under gloo), None on the others."""
        src = self._wire(x)
        out = None
        if self.rank == dst:
            out = self._buffer(x, (self.size,) + tuple(x.shape))
            self.recv_bytes += out.numel() * out.element_size()
        self._dist.gather(src, None if out is None else list(out.unbind(0)),
                          dst=self._peer(dst), group=self.group)
        if out is not None and x.dtype == torch.bool:
            out = out.view(torch.bool)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Worker ``src``'s ``x`` on every rank, bit for bit: the source
        passes its tensor, every other rank a tensor of the same shape
        and dtype to receive into (its values are not read).  One
        ``dist.broadcast``; the result is on ``x``'s device."""
        if self.rank == src:
            buf = self._wire(x)
        else:
            buf = self._buffer(x, x.shape)
        self._dist.broadcast(buf, self._peer(src), group=self.group)
        if self.rank == src:
            return x
        return self._back(buf, x)


Axis = Union[LogicalAxis, DistAxis]


def axis_of(x: torch.Tensor, axis=None) -> Axis:
    """The axis a collective over ``x`` runs on: ``axis``, or every row
    of ``x`` as a logical worker."""
    return axis if axis is not None else LogicalAxis(x.shape[0])


def gather_values(axis: Axis, values: Sequence[float]) -> List[float]:
    """Every worker's scalar, in worker order, from each process's values
    for the workers it holds (float64 on the wire: fp32 values and ints
    below 2**53 travel exactly)."""
    x = torch.tensor([[float(v)] for v in values], dtype=torch.float64,
                     device=axis.device)
    return [float(v) for v in axis.all_gather(x)[0, :, 0]]
