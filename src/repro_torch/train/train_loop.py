"""The single host loop every Strategy engine runs under (the JAX
package's ``train/train_loop.py::train_loop`` with ``jit=False``), and
``value_and_grad``, which makes a Strategy ``grad_fn`` from a loss.

``TrainState`` and ``make_train_step`` (the Adam trainer) are ROADMAP
queue A item 3.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.core.tree import tree_map


def value_and_grad(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` ->
    ``grad_fn(params, batch) -> (loss, grads)``, ``grads`` a tree like
    ``params`` (``jax.value_and_grad(..., has_aux=True)`` for the
    engines: a parameter the loss does not use gets a zero gradient).  The
    parameters themselves are not modified."""
    def grad_fn(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = loss_fn(leaves, batch)
        loss.backward()
        return loss.detach(), tree_map(
            lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
            leaves)
    return grad_fn


def train_loop(train_step: Callable, state, batch_fn: Callable[[int], Any],
               steps: int, log_every: int = 10):
    """Drive ``train_step(state, batch) -> (state, metrics)`` for ``steps``
    steps; ``batch_fn(t)`` gives step t's batch (``strategy.fit`` passes
    the global-step index).  Returns (state, history): every
    ``log_every``-th step's metrics as floats, with ``step`` and the
    ``wall_s`` since the start."""
    hist = []
    t0 = time.time()
    for t in range(steps):
        state, mets = train_step(state, batch_fn(t))
        if t % log_every == 0 or t == steps - 1:
            rec = {k: float(v) for k, v in mets.items()}
            rec["step"] = t
            rec["wall_s"] = time.time() - t0
            hist.append(rec)
    return state, hist
