"""Centralized architecture (survey §3.3.1(1)) over the port's worker axis:
the JAX package's ``core/parameter_server.py``.

The parameter server keeps its defining property, *the state of each
parameter shard lives in exactly one place*, by sharding the parameters
across the workers and writing push and pull as collectives:

  push(grads)  : reduce-scatter over the worker axis -> my shard's grads
  update       : the optimizer step on my 1/n shard only (the "server")
  pull(params) : all-gather my updated shard back to every worker

Traffic per worker equals the ring allreduce's (RS + AG); update work and
state drop by n (the ZeRO observation).

Every tensor here carries the workers this process holds as dimension 0
(row ``r`` is worker ``axis.ids[r]``'s value, ``core.collectives``): a
leaf ``[k, *shape]``, a flat vector ``[k, P]``, a shard ``[k, P / n]``.
``axis`` is the worker axis of the reference's ``axis_name``: every row
a logical worker by default (k = n), or a ``DistAxis`` with one worker
per ``torch.distributed`` rank (k = 1).  A replicated tensor can be
passed as an expanded view (``p[None].expand(k, *p.shape)``).  The
server's sums add the workers' pushes in worker order on either axis.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import axis_of as _axis


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(x)


def pad_to_multiple(x: torch.Tensor, n: int):
    """Flatten ``x`` and zero-pad to a multiple of ``n``.  Returns
    (padded_flat, original_flat_length)."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.shape[0]) % n)), flat.shape[0]


def shard_of_flat(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Each held worker's 1/n shard of its own ``x`` [k, ...] (flattened,
    zero-padded): row r is chunk ``axis.ids[r]`` of row r's flat vector,
    [k, m]."""
    ax = _axis(x, axis)
    n, k = ax.size, x.shape[0]
    flat = x.reshape(k, -1)
    L = flat.shape[1]
    m = -(-L // n)
    out = flat.new_zeros((k, m))
    for r, w in enumerate(ax.ids):
        hi = min((w + 1) * m, L)
        if hi > w * m:
            out[r, :hi - w * m] = flat[r, w * m:hi]
    return out


def reduce_scatter_flat(flat: torch.Tensor, axis=None) -> torch.Tensor:
    """Sum-reduce each worker's padded flat vector [k, P] over the workers,
    delivering each its own contiguous shard [k, P / n]: the PS push."""
    ax = _axis(flat, axis)
    return ax.psum_scatter(flat.reshape(flat.shape[0], ax.size, -1))


def all_gather_flat(shard: torch.Tensor, length: int,
                    axis=None) -> torch.Tensor:
    """Concatenate the workers' shards [k, m] back into the first
    ``length`` elements of the flat vector, on every held worker: [k,
    length] (a view; every row is the same vector).  The PS pull."""
    ax = _axis(shard, axis)
    full = ax.all_gather(shard)[0].reshape(-1)[:length]
    return full[None].expand(shard.shape[0], length)


def push_reduce_scatter(g: Sequence[torch.Tensor],
                        axis=None) -> List[torch.Tensor]:
    """Gradient leaves [k, ...] -> each held worker's shard of the summed
    gradient, flat per leaf: [k, m]."""
    out = []
    for x in g:
        ax = _axis(x, axis)
        flat = x.reshape(x.shape[0], -1)
        out.append(reduce_scatter_flat(
            F.pad(flat, (0, (-flat.shape[1]) % ax.size)), ax))
    return out


def pull_all_gather(shard: Sequence[torch.Tensor],
                    like: Sequence[torch.Tensor],
                    axis=None) -> List[torch.Tensor]:
    """Updated shards [k, m] -> full leaves shaped and typed like ``like``
    [k, ...] on every held worker."""
    out = []
    for s, ref in zip(shard, like):
        full = all_gather_flat(s, ref[0].numel(), axis)
        out.append(full.reshape(ref.shape).to(ref.dtype))
    return out


def sgd_update_fn(lr: float, mean_over=1) -> Callable:
    """The plain-SGD ``update_fn`` for ``make_ps_step``: each worker
    updates its own shard, optionally dividing the pushed gradient *sum*
    by ``mean_over`` workers (bucketed BSP pushes pass the worker count,
    single-worker SSP/ASP pushes use the raw sum)."""
    def update(p_shard, g_shard, opt_shard):
        return ([p - lr * (g / mean_over) for p, g in zip(p_shard, g_shard)],
                opt_shard)
    return update


def make_ps_step(update_fn: Callable, axis=None) -> Callable:
    """update_fn(param_shards, grad_shards, opt_shards) ->
    (new_param_shards, new_opt_shards).

    Returns ``ps_step(params, grads, opt_state)`` over leaf lists [k, ...]
    of the workers ``axis`` holds: each worker plays parameter server for
    its 1/n shard."""
    def ps_step(params, grads, opt_state):
        g_shards = push_reduce_scatter(grads, axis)
        p_shards = [shard_of_flat(p, axis) for p in params]
        new_p, new_opt = update_fn(p_shards, g_shards, opt_state)
        return pull_all_gather(new_p, params, axis), new_opt
    return ps_step


def init_opt_shards(params: Sequence, n: int, init_leaf: Callable):
    """Per-worker optimizer shards: ``init_leaf(m)`` for each leaf (or leaf
    size) of ``params``, ``m`` its flat padded length // n."""
    out = []
    for x in params:
        size = _numel(x)
        out.append(init_leaf((size + (-size) % n) // n))
    return out
