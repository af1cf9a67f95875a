"""ZeRO optimizer-state sharding over the data axis (Rajbhandari et al.),
as a Strategy dimension (``z1``/``z2``/``z3`` mesh tokens; the JAX
package's ``parallel/zero.py``).

ZeRO is the reduce-scatter / shard-update / all-gather path of
``core.parameter_server`` with the *persistent* state progressively
sharded over the D data-parallel ranks:

  level  persistent per-rank state          data-axis exchange per step
  z0     params + opt                       allreduce(grads)
  z1     params + opt/D                     allreduce(grads) + allgather(params)
  z2     params + opt/D                     reduce-scatter(grads) + allgather(params)
  z3     params/D + opt/D                   allgather(params) + reduce-scatter(grads)

z1 and z2 hold the same persistent state; they differ in the gradient
exchange (z1 materializes the full reduced gradient on every rank, z2
reduce-scatters) and so in wire and transient-memory accounting.  z3
also shards the parameters: each step starts by all-gathering the
parameter shards for compute and ends by updating only the local shard.

Everything here works on *flat per-bucket vectors* over the fused-bucket
plan of a ``MeshPlan``, with the data axis as dimension 0 of each tensor
(``core.collectives``: row r is data rank r's value).  The optimizer step
works on lists of shards, so ``optim.adam.AdamW`` (and plain SGD) apply
unchanged: the Adam moments simply live sharded.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import axis_of
from repro_torch.core.parameter_server import (all_gather_flat,
                                               reduce_scatter_flat,
                                               shard_of_flat)
from repro_torch.optim.adam import AdamW
from repro_torch.parallel.mesh_plan import MeshPlan

ZERO_LEVELS = (0, 1, 2, 3)


def make_optimizer_step(optimizer: str, lr: float,
                        moment_dtype: str = "float32") -> Callable:
    """(params, grads, opt_state) -> (new_params, new_opt_state) on any
    tree: full leaves (z0) or flat shards (z1-z3) alike.
    ``moment_dtype="bfloat16"`` stores the AdamW EMA buffers quantized
    (olmax-style); the math stays fp32.  AdamW updates ``params`` and the
    state in place (``optim.adam``); SGD returns new tensors."""
    if optimizer == "sgd":
        def sgd_step(p, g, opt):
            return [a - lr * b for a, b in zip(p, g)], opt
        return sgd_step
    if optimizer == "adamw":
        adam = AdamW(moment_dtype=moment_dtype)

        def adam_step(p, g, opt):
            return adam.step(p, g, opt, lr)
        return adam_step
    raise ValueError(f"optimizer={optimizer!r} (want sgd | adamw)")


def init_opt_state(optimizer: str, params_like,
                   moment_dtype: str = "float32"):
    """Optimizer state matching ``params_like`` (full leaves or shards);
    None for stateless SGD."""
    if optimizer == "sgd":
        return None
    return AdamW(moment_dtype=moment_dtype).init(params_like)


def flatten_bucket(leaves, idxs: List[int]) -> torch.Tensor:
    """Concatenate the chosen leaves into one fp32 flat vector."""
    return torch.cat([leaves[i].float().reshape(-1) for i in idxs])


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last dim of ``x`` to a multiple of ``n`` (``x``
    itself when it is one)."""
    pad = (-x.shape[-1]) % n
    return F.pad(x, (0, pad)) if pad else x


def make_zero_bucket_update(plan: MeshPlan, zero: int, optimizer: str,
                            lr: float, moment_dtype: str = "float32",
                            axis=None) -> Callable:
    """Build the per-step ZeRO-1/2/3 update over ``plan``'s buckets.

    Returns ``update(p_buckets, g_buckets, opt, grad_reduce=None) ->
    (new_p_buckets, new_opt)``, the bucket lists in ``plan.order`` issue
    order (any iterable: the engine fuses each bucket as the update
    reaches it).  ``g_buckets[j]`` is [D, n_b]: every data rank's flat
    gradient bucket.  For z1/z2 ``p_buckets`` are the replicated flat buckets
    [n_b] in and out; for z3 the per-rank shards [D, m] in and out (the
    engine owns the gather-for-compute side).  ``opt`` is the sharded
    optimizer state ({"m", "v", "t"} with [D, m] shards per bucket for
    adamw, None for sgd).  Gradient buckets are summed over the data axis
    and divided by its size (mean semantics, as the allreduce path).

    ``grad_reduce(padded [D, P], bucket_pos) -> my_shard_sum [D, m]``
    replaces the full-precision psum / reduce-scatter with a caller's
    exchange: the hook the hybrid engine routes the gradient push through
    the compressed-payload schedules of ``comm`` with, under
    ``wire="measured"`` (parameters still travel exact).

    ``axis`` is the data axis (``core.collectives``): every data rank a
    row by default; with a ``DistAxis`` of the data line each process
    holds its rank's row of every ``[D, ...]`` tensor above (``[1,
    ...]``), the gradient reduce-scatter is the line's ``psum_scatter``
    and the parameter all-gather the line's ``all_gather``."""
    if zero not in (1, 2, 3):
        raise ValueError(f"zero={zero} (bucket update is for levels 1-3)")
    opt_step = make_optimizer_step(optimizer, lr, moment_dtype)
    n_data = plan.mesh.data

    def update(p_buckets, g_buckets, opt, grad_reduce=None):
        g_shards, sizes = [], []
        for j, g in enumerate(g_buckets):
            sizes.append(g.shape[-1])
            padded = _pad_rows(g, n_data)
            if grad_reduce is not None:
                g_shards.append(grad_reduce(padded, j))
            elif zero == 1:
                # full allreduce, then slice my shard (grads materialize
                # everywhere: ZeRO-1 only shards the optimizer state)
                ax = axis_of(padded, axis)
                g_shards.append(shard_of_flat(ax.psum(padded), ax))
            else:
                g_shards.append(reduce_scatter_flat(padded, axis))
            del padded
        for g in g_shards:
            g.div_(n_data)             # each shard is the reduce's own
        if zero == 3:
            p_shards = list(p_buckets)
        else:
            k = n_data if axis is None else len(axis.ids)
            p_shards = [shard_of_flat(
                _pad_rows(p, n_data)[None].expand(k, -1), axis)
                for p in p_buckets]
        new_shards, new_opt = opt_step(p_shards, g_shards, opt)
        del g_shards
        if zero == 3:
            return new_shards, new_opt
        return [all_gather_flat(s, n_b, axis)[0]
                for s, n_b in zip(new_shards, sizes)], new_opt

    return update


# --------------------------------------------------------- memory model
def state_bytes_per_device(plan: MeshPlan, zero: int, optimizer: str,
                           moment_dtype: str = "float32") -> Dict[str, int]:
    """Analytic persistent param+optimizer bytes per device for the mesh
    (fp32 params; moments at ``moment_dtype`` width, 2 B when quantized
    to bf16).  The engine's measured ``per_device_state_bytes`` must
    equal it."""
    n_local = plan.n_local_params
    shard = sum(plan.shard_sizes)        # padded 1/D of the local block
    params = shard if zero == 3 else n_local
    adam = AdamW(moment_dtype=moment_dtype)
    moments = adam.moments_per_param if optimizer == "adamw" else 0
    mb = adam.moment_bytes
    opt = moments * (shard if zero >= 1 else n_local)
    return {"params": 4 * params, "opt": mb * opt,
            "total": 4 * params + mb * opt}


def wire_bytes_per_device(plan: MeshPlan, zero: int,
                          grad_bytes: Optional[int] = None) -> int:
    """Modeled data-axis bytes one device moves per step under the ZeRO
    exchange schedule (ring collectives: AR = 2(D-1)/D, RS = AG =
    (D-1)/D of the payload).  ``grad_bytes`` defaults to the dense local
    gradient size; pass the compressor's accounting for compressed runs."""
    d = plan.mesh.data
    if d == 1:
        return 0
    n_local = 4 * plan.n_local_params
    g = n_local if grad_bytes is None else grad_bytes
    ar, rs = 2 * (d - 1) / d, (d - 1) / d
    if zero == 0:
        return int(ar * g)
    if zero == 1:
        return int(ar * g + rs * n_local)          # AR grads + AG params
    return int(rs * g + rs * n_local)              # RS grads + AG params
