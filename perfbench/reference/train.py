"""Plain synchronous data-parallel SGD: K logical workers each take the
loss and gradient of their own batch on the same weights (autograd of
``reference.transformer.loss``, one layer's activations kept at a time),
the gradients are exchanged as ``reference.exchange`` specifies, and every
weight moves by ``-lr`` times the mean.

``fault`` plants the faults the correctness check must catch, with the
reference put in the program's place: ``half_batch`` (workers K/2 ... K-1
get the batches of workers 0 ... K/2-1, so the mean is over half of the
rows), ``no_exchange`` (the update applies worker 0's own gradient)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from perfbench.reference import exchange as X
from perfbench.reference.transformer import loss as model_loss

FAULTS = ("half_batch", "no_exchange")


def worker_grad(W, cfg, batch, lowp):
    """(mean loss over the batch's rows, gradient by weight name)."""
    leaves = {n: w.detach().requires_grad_() for n, w in W.items()}
    rows = batch["tokens"].shape[0]
    total = 0.0
    for r in range(rows):
        lv = model_loss(leaves, cfg, batch["tokens"][r], batch["labels"][r],
                        lowp=lowp) / rows
        lv.backward()
        total += float(lv.detach())
    grads = {n: t.grad for n, t in leaves.items()}
    del leaves
    return total, grads


def run(W: Dict[str, torch.Tensor], cfg: Dict, batches: Callable, *,
        workers: int, steps: int, lr: float, method: str,
        lowp: Optional[str] = None, fault: Optional[str] = None):
    """Train ``W`` (fp32, updated in place) for ``steps`` steps.  Returns
    (the mean loss of each step, the first step's mean gradient by name)."""
    names = list(W)
    leaves = X.leaf_order(cfg, names)
    buckets = X.bucket_plan([len(l) * W[l[0]].numel() for l in leaves])
    ef: Dict[int, torch.Tensor] = {}
    losses: List[float] = []
    first = None
    for t in range(steps):
        grads, step_losses = [], []
        for w in range(workers):
            src = w % (workers // 2) if fault == "half_batch" else w
            lv, g = worker_grad(W, cfg, batches(t, src), lowp)
            step_losses.append(lv)
            grads.append(g)
        if fault == "no_exchange":
            mean = grads[0]
            del grads
        else:
            mean = X.exchange(grads, ef, leaves, buckets, method)
        losses.append(sum(step_losses) / workers)
        with torch.no_grad():
            for n in names:
                W[n].sub_(lr * mean[n])
        if t == 0:
            first = {n: float(torch.linalg.vector_norm(mean[n]))
                     for n in names}
        del mean
    return losses, first
