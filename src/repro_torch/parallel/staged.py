"""Stage-decomposable models for the hybrid (tensor x pipeline) axes (the
JAX package's ``parallel/staged.py``).

The pipeline schedules (``core.pipeline``) need a model written as a
shape-preserving per-stage function; Megatron-style tensor parallelism
also needs the stage function to know the tensor axis, to place the two
collectives of the column -> row parallel pair:

  * forward of the row-parallel matmul: a sum of the partial products,
    whose backward must be the *identity* (the cotangent is replicated);
  * backward of the column-parallel matmul: the input is replicated over
    the tensor axis, so its cotangent must be summed across tensor ranks.
    ``tensor_copy`` is that identity-forward / sum-backward operator
    (Megatron's conjugate "g" to the forward "f" = ``tensor_reduce``).

On the port's logical devices the tensor axis is dimension 0 of a tensor
(row t is tensor rank t's value, as ``core.collectives``' worker axis),
and both operators are ``torch.autograd.Function``s over it.  When each
tensor rank is a process (``tensor_axis(axis)`` around the forward, with
the tensor line's ``DistAxis``), a rank's tensors carry its own row only
([1, ...]); each operator gathers the T rows over the line and sums them
in rank order, so the bits are the logical axis's.  Written as
a plain sum over the rows, ``tensor_reduce``'s backward would be another
sum and hand every rank T times its cotangent: the over-count the
reference pins with ``custom_vjp`` (its psum transposes to a psum).

``StagedModel`` is the contract the hybrid engine consumes; the tiny
transformer-FFN block model below is the reference instance (residual
``x + gelu(x @ w_up) @ w_down`` blocks, leaf names chosen so
``core.parallelism``'s role table classifies ``w_up`` column-parallel and
``w_down`` row-parallel).  ``stacked_loss`` runs the same parameters
unpipelined and unsharded: the single-device reference every mesh cell
is validated against.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.tree import get_path, leaf_paths, tree_map


_AXIS: list = [None]       # the tensor line of the forward in progress


@contextlib.contextmanager
def tensor_axis(axis):
    """Run the forward inside with ``axis`` (a ``DistAxis`` of the tensor
    line, or None for the logical axis) as the tensor axis of
    ``tensor_copy`` / ``tensor_reduce``; each call keeps it for its
    backward."""
    prev, _AXIS[0] = _AXIS[0], axis
    try:
        yield
    finally:
        _AXIS[0] = prev


def _rows(axis, x: torch.Tensor) -> torch.Tensor:
    """Every tensor rank's row of ``x``: ``x`` itself on the logical
    axis, the line's gather of each rank's ``[1, ...]`` over ranks."""
    return x if axis is None else axis.all_gather(x)[0]


class _TensorCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.axis = _AXIS[0]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _rows(ctx.axis, g).sum(0, keepdim=True).expand_as(g)


class _TensorReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        rows = _rows(_AXIS[0], x)
        acc = rows[0].clone()
        for r in range(1, rows.shape[0]):  # rank order, as core.collectives
            acc += rows[r]
        return acc[None].expand_as(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g


# Identity forward, sum-over-ranks backward: apply to the
# (tensor-replicated) input of a column-parallel matmul, ``x`` [T, ...]
# with row t tensor rank t's copy, so its cotangent sums the per-rank
# partials.
tensor_copy = _TensorCopy.apply

# Sum-over-ranks forward, *identity* backward: combine the partial products
# [T, ...] of a row-parallel matmul (every rank receives the sum; the
# replicated output's cotangent flows back to each rank unchanged).
tensor_reduce = _TensorReduce.apply


@dataclasses.dataclass(frozen=True)
class StagedModel:
    """A model the hybrid engine can pipeline and tensor-shard.

    stage_fn(stage_params, x, tensor_parallel=False) -> y
        Shape-preserving per-stage transform.  With ``tensor_parallel``,
        every leaf of ``stage_params`` and ``x`` carry a leading
        tensor-rank dimension (row t: rank t's block, sharded on its role
        dimension, and rank t's copy of the activation), and stage_fn
        must place the Megatron collectives (see the module docstring);
        without it, it computes on full weights.
    inputs(batch) -> x [B, ...]
        The activation entering stage 0.
    readout(y, batch) -> scalar
        The loss head, applied to the last stage's outputs.

    Params are not carried here: they flow through ``engine.init`` like
    every other engine's, each leaf with a leading stacked-stage dim.
    """
    stage_fn: Callable
    inputs: Callable
    readout: Callable


def is_staged_model(obj: Any) -> bool:
    return isinstance(obj, StagedModel)


def _n_layers(params) -> int:
    return get_path(params, leaf_paths(params)[0]).shape[0]


def stacked_loss(model: StagedModel, params, batch,
                 tensor_parallel: bool = False):
    """Unpipelined reference: run the stacked stages in turn on one device
    and apply the loss head: the trajectory every mesh cell must
    reproduce."""
    x = model.inputs(batch)
    for s in range(_n_layers(params)):
        sp = tree_map(lambda leaf: leaf[s], params)
        x = model.stage_fn(sp, x, tensor_parallel=tensor_parallel)
    return model.readout(x, batch)


def stacked_grad_fn(model: StagedModel) -> Callable:
    """(params, batch) -> (loss, grads) over the unpipelined stacked model:
    plugs a StagedModel into any data-parallel-only engine or the
    simulator as a reference.  The parameters are not modified."""
    def grad_fn(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = stacked_loss(model, leaves, batch)
        loss.backward()
        return loss.detach(), tree_map(lambda t: t.grad, leaves)
    return grad_fn


# ------------------------------------------------- reference tiny model
def make_tiny_transformer(stages: int, d_model: int = 8, d_ff: int = 16,
                          seed: int = 0, device="cuda"):
    """Residual transformer-FFN blocks (the tiny cross-check model of the
    hybrid acceptance tests): ``stages`` blocks of
    ``x + gelu(x @ w_up) @ w_down``, stacked on a leading stage dim, with
    GELU in its tanh form (``jax.nn.gelu``'s default).

    Returns ``(params, model)``; the weights are normal draws from a
    ``torch.Generator`` seeded with ``seed`` (not the reference's
    ``jax.random`` draws), scaled by 1/sqrt(fan-in).  Targets live in
    ``batch["y"]`` and the loss is mean squared error on the final
    activations."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "w_up": torch.randn(stages, d_model, d_ff, generator=gen)
        / math.sqrt(d_model),
        "w_down": torch.randn(stages, d_ff, d_model, generator=gen)
        / math.sqrt(d_ff),
    }
    params = tree_map(lambda x: x.to(device), params)

    def stage_fn(sp, x, tensor_parallel=False):
        xin = x
        if tensor_parallel:
            # [T, mb, d] batches of the T ranks' blocks (one on a rank):
            # bmm computes each batch entry the same whatever T is (matmul
            # treats a batch of one as a plain mm), and GELU runs row by
            # row (the CPU's vector kernels round a short tail otherwise)
            x = tensor_copy(x)
            a = torch.bmm(x, sp["w_up"])                  # column-parallel
            h = torch.stack([F.gelu(r, approximate="tanh")
                             for r in a.unbind(0)])
            y = torch.bmm(h, sp["w_down"])   # row-parallel: partial product
        else:
            h = F.gelu(x @ sp["w_up"], approximate="tanh")
            y = h @ sp["w_down"]
        if tensor_parallel:
            y = tensor_reduce(y)
        return xin + y

    def inputs(batch):
        return batch["x"]

    def readout(y, batch):
        return torch.mean((y - batch["y"]) ** 2)

    return params, StagedModel(stage_fn=stage_fn, inputs=inputs,
                               readout=readout)
