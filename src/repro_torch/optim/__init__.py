"""Optimizers of the port (the JAX package's ``optim``): plain functions
on parameter trees.

Interface: ``opt.init(params, layout=None) -> state``;
``opt.step(params, grads, state, lr, layout=None) -> (params, state)``,
``grads`` a tree like ``params``.  As in ``torch.optim``, the step
updates ``params`` and ``state`` in place (and returns them), with the
reference's arithmetic and roundings.  ``layout`` (a
``core.tree.LeafLayout``, ``LeafLayout.of_tree(params)`` when not given)
names the JAX package's leaves, which Adafactor's factoring and clip
depend on.
"""
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adam import Adam, AdamW
from repro_torch.optim.schedule import constant, cosine_warmup
from repro_torch.optim.sgd import SGD

OPTIMIZERS = {"sgd": SGD, "adam": Adam, "adamw": AdamW,
              "adafactor": Adafactor}

__all__ = ["SGD", "Adam", "AdamW", "Adafactor", "cosine_warmup", "constant",
           "OPTIMIZERS"]
