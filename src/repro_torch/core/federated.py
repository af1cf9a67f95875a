"""Federated learning (survey §3.3.1(3)): FedAvg [McMahan et al., 114] with
client sampling, local epochs, and IID vs non-IID data (the JAX package's
``core/federated.py``; Dirichlet partitioning lives in
``repro_torch.data.partition``).

Per the survey's framing, federated rounds are the centralized
architecture with (a) partial participation, (b) multiple local steps
between synchronizations, and (c) weighted averaging by client example
counts.  Parameters are dicts (or nests) of tensors; ``grad_fn(params,
batch) -> (loss, grads)`` with ``grads`` shaped like ``params`` (e.g.
``train.value_and_grad(loss_fn)``).  The clients of a round are drawn by
a ``np.random.RandomState(seed)``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FedConfig:
    num_clients: int = 10
    clients_per_round: int = 5
    local_steps: int = 4
    local_lr: float = 0.1
    seed: int = 0


def fedavg_round(params, client_batches: Sequence[Callable[[int], Any]],
                 selected: Sequence[int], grad_fn: Callable,
                 cfg: FedConfig):
    """One synchronous federated round (Bonawitz et al. [19] system
    model): each selected client takes ``local_steps`` SGD steps from
    ``params`` on its own batches, and the mean of their deltas is added
    to ``params``.

    client_batches[c](step) -> batch for client c.
    Returns (new_params, mean_client_loss)."""
    deltas, losses, weights = [], [], []
    for c in selected:
        p = params
        step_losses = []
        for s in range(cfg.local_steps):
            loss, g = grad_fn(p, client_batches[c](s))
            p = tree_map(lambda a, b: a - cfg.local_lr * b, p, g)
            step_losses.append(loss.float())
        deltas.append(tree_map(lambda a, b: a - b, p, params))
        losses.append(float(torch.stack(step_losses).mean()))
        weights.append(1.0)

    wsum = sum(weights)
    avg_delta = tree_map(
        lambda *ds: sum(w * d for w, d in zip(weights, ds)) / wsum, *deltas)
    new_params = tree_map(lambda p, d: p + d, params, avg_delta)
    return new_params, float(np.mean(losses))


def run_fedavg(params, client_batches, grad_fn, cfg: FedConfig,
               rounds: int):
    rng = np.random.RandomState(cfg.seed)
    hist = []
    for r in range(rounds):
        selected = rng.choice(cfg.num_clients, cfg.clients_per_round,
                              replace=False)
        params, loss = fedavg_round(params, client_batches, selected,
                                    grad_fn, cfg)
        hist.append(dict(round=r, loss=loss))
    return params, hist
