"""The trainer (the JAX package's ``train/train_loop.py``): model loss,
optimizer, LR schedule, precision policy and (optionally) a gradient
compressor composed into one step, and the single host loop every
trainer and Strategy engine runs under.

Gradients leave the model as the JAX package's leaves
(``core.tree.LeafLayout``: a model passes ``model.leaf_layout(params)``;
``LeafLayout.of_tree`` by default), so compression, its wire bytes and
the error-feedback state see the reference's leaves, not the port's
per-layer tensors.  The EF state is a list of fp32 leaves in that order.

Random draws come from ``torch.Generator``s: ``train_loop`` gives each
step one (the reference's per-step ``jax.random.split``), and a step
re-seats it on the gradients' device (``on_device``) or folds a worker
index into it (``fold_in``).  The draws are not JAX's.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core.compression import EF_METHODS, Compressor
from repro_torch.core.precision import DEFAULT, PrecisionPolicy
from repro_torch.core.tree import LeafLayout, get_path, tree_map
from repro_torch.obs.trace import get_recorder
from repro_torch.optim.schedule import constant

# ``wire_bytes`` is reported modulo this, as the reference's int32 does
WIRE_WRAP = 2**31 - 1


def _loss_and_grads(loss_fn: Callable, params, batch, remat: bool = False):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``, ``grads`` a tree like ``params`` (a parameter the loss does
    not use gets a zero gradient); the parameters are not modified.
    ``remat`` keeps only the inputs and recomputes the forward in the
    backward (``jax.checkpoint``)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    if remat:
        loss, mets = checkpoint(loss_fn, leaves, batch, use_reentrant=False)
    else:
        loss, mets = loss_fn(leaves, batch)
    loss.backward()
    grads = tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads


def value_and_grad(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` ->
    ``grad_fn(params, batch) -> (loss, grads)``, ``grads`` a tree like
    ``params`` (``jax.value_and_grad(..., has_aux=True)`` for the
    engines: a parameter the loss does not use gets a zero gradient).  The
    parameters themselves are not modified."""
    def grad_fn(params, batch):
        loss, _, grads = _loss_and_grads(loss_fn, params, batch)
        return loss, grads
    return grad_fn


# ------------------------------------------------------------- generators
def step_generator(gen: torch.Generator) -> torch.Generator:
    """A new CPU generator seeded from a draw of ``gen`` (one step's key
    split off the loop's, as ``jax.random.split``)."""
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    return torch.Generator().manual_seed(seed)


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A CPU generator derived from ``gen``'s seed and ``data``
    (``jax.random.fold_in``), e.g. a worker's from the step's."""
    seed = (gen.initial_seed() * 1_000_003 + data) % 2**62
    return torch.Generator().manual_seed(seed)


def on_device(gen: Optional[torch.Generator], device) -> Optional[
        torch.Generator]:
    """``gen``'s seed as a generator on ``device`` (the compressors draw on
    the gradients' device)."""
    if gen is None or gen.device == torch.device(device):
        return gen
    return torch.Generator(device=device).manual_seed(gen.initial_seed())


# ------------------------------------------------------------- the trainer
class TrainState:
    """Factory for the train-state dict (keys params / opt_state / step /
    ef).  The state owns a copy of ``params``: the step updates it in
    place."""
    @staticmethod
    def create(params, opt, compressor: Optional[Compressor] = None,
               layout: Optional[LeafLayout] = None) -> Dict[str, Any]:
        layout = layout or LeafLayout.of_tree(params)
        params = tree_map(torch.clone, params)
        ef = None
        if compressor is not None and compressor.method in EF_METHODS:
            dev = get_path(params, layout.parts[0][0]).device
            ef = compressor.init_state(torch.empty(s, device=dev)
                                       for s in layout.shapes(params))
        return dict(params=params, opt_state=opt.init(params, layout=layout),
                    step=0, ef=ef)


def make_train_step(loss_fn: Callable, opt, lr_schedule=None,
                    precision: PrecisionPolicy = DEFAULT,
                    compressor: Optional[Compressor] = None,
                    remat: bool = False,
                    reduce_fn: Optional[Callable] = None,
                    layout: Optional[LeafLayout] = None):
    """``loss_fn(params, batch, compute_dtype) -> (loss, metrics)``.

    ``reduce_fn(grads) -> grads`` runs after the compression roundtrip
    over the workers' leaf lists (``[leaves]`` here, one per worker under
    ``make_sharded_train_step``) and returns one leaf list: a
    data-parallel caller passes ``make_bucketed_allreduce``'s function.

    Returns ``train_step(state, batch, gen=None) -> (state, metrics)``;
    ``gen`` drives the stochastic compressors.  The step updates the state
    in place (parameters, optimizer state and EF, as ``torch.optim`` does:
    at full width a copy of each would not fit) and returns it.  Metrics:
    the loss's own, ``loss``, ``lr`` and ``wire_bytes`` (the compressor's
    bytes modulo 2**31 - 1, 0 without a compressor or with ``none``)."""
    lr_schedule = lr_schedule or constant(1e-3)
    compressing = compressor is not None and compressor.method != "none"

    def lf(p, batch):
        return loss_fn(p, batch, compute_dtype=precision.cdt)

    def worker(params, batch, ef, gen):
        """One worker's half: gradient, cast for reduce, compression, with
        the EF leaves ``ef`` renewed in place.  Returns (loss, metrics,
        leaves, wire)."""
        lay = layout or LeafLayout.of_tree(params)
        with record_function("forward_backward"):
            loss, mets, grads = _loss_and_grads(lf, params, batch, remat)
        # each raw gradient leaves memory once it is stacked and encoded
        leaves = (precision.cast_for_reduce(g)
                  for g in lay.leaves(grads, consume=True))
        del grads
        wire = 0
        with record_function("stack_and_compress"):
            if compressing:
                leaves, new_ef, wire = compressor.roundtrip(
                    leaves, ef, on_device(gen, loss.device))
                for e, x in zip(ef or (), new_ef or ()):
                    e.copy_(x)
                del new_ef
                wire %= WIRE_WRAP
            else:
                leaves = list(leaves)
        return loss, mets, leaves, wire

    def update(state, leaves, mets, loss, wire):
        """The optimizer half: one step over the (reduced) leaves.
        Returns (state, metrics)."""
        params = state["params"]
        lay = layout or LeafLayout.of_tree(params)
        grads = lay.update(params, leaves, lambda p, g: g)
        lr = lr_schedule(state["step"])
        with record_function("optimizer_update"):
            opt.step(params, grads, state["opt_state"], lr, layout=lay)
        state["step"] += 1
        return state, dict(mets, loss=loss, lr=lr, wire_bytes=wire)

    def train_step(state: Dict, batch, gen: Optional[torch.Generator] = None):
        loss, mets, leaves, wire = worker(state["params"], batch,
                                          state["ef"], gen)
        if reduce_fn is not None:
            leaves = reduce_fn([leaves])
        return update(state, leaves, mets, loss, wire)

    train_step._worker = worker
    train_step._update = update
    train_step._reduce_fn = reduce_fn
    return train_step


def train_loop(train_step: Callable, state, batch_fn: Callable[[int], Any],
               steps: int, log_every: int = 10,
               gen: Optional[torch.Generator] = None):
    """The single host loop: drives ``make_train_step`` steps and
    every Strategy engine (``strategy.fit`` passes the global-step index as
    the batch).  Step t gets ``train_step(state, batch_fn(t), sub)``, with
    ``sub`` a generator split off ``gen`` (seed 0 by default).  Returns
    (state, history): every ``log_every``-th step's metrics as floats, with
    ``step`` and the ``wall_s`` since the start.  With a recorder
    installed (``obs.trace.tracing``) each step is a ``step`` span on the
    ``train_step`` clock (engines emit their sub-spans on its track)."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    hist: List[dict] = []
    t0 = time.time()
    tracer = get_recorder()     # no-op by default: tracing off is free
    for t in range(steps):
        sub = step_generator(gen)
        if tracer.enabled:
            with tracer.span("step", pid="train", tid="loop", cat="train",
                             clock=("train_step", t), step=t):
                state, mets = train_step(state, batch_fn(t), sub)
        else:
            state, mets = train_step(state, batch_fn(t), sub)
        if t % log_every == 0 or t == steps - 1:
            rec = {k: float(v) for k, v in mets.items()}
            rec["step"] = t
            rec["wall_s"] = time.time() - t0
            hist.append(rec)
    return state, hist
