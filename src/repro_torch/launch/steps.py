"""Train / prefill / serve step builders used by the dry-run (the JAX
package's ``launch/steps.py``).

The steps run eagerly on whatever device their tensors are on: the card
(the flash kernels), the CPU (the plain versions) or ``meta`` (shapes
only: the dry-run's counts).  The reference's ``unroll`` (``lax.scan`` or
a Python loop, for XLA's cost analysis) has no counterpart: the port's
layers are always a Python loop.  The train step updates ``params`` and the
optimizer state in place and returns them, as ``torch.optim`` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import get_path, leaf_paths, set_path, tree_map
from repro_torch.models import Model
from repro_torch.optim import Adafactor, Adam

ADAFACTOR_THRESHOLD = 20e9     # params above this use factored moments


def choose_optimizer(cfg: ModelConfig):
    if cfg.param_count() > ADAFACTOR_THRESHOLD:
        return Adafactor()
    return Adam()


def make_train_step(model: Model, opt, lr: float = 1e-3,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss in bf16 compute (``remat`` recomputes each layer
    group in the backward), its gradients (zeros for a parameter the loss
    does not reach) and one optimizer step over the reference's leaves
    (``model.leaf_layout``: Adafactor factors whole stacked leaves)."""
    def train_step(params, opt_state, batch):
        paths = leaf_paths(params)
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = model.loss_fn(leaves, batch, compute_dtype=torch.bfloat16,
                                remat=remat)
        flat = [get_path(leaves, p) for p in paths]
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = tree_map(lambda t: None, params)
        for path, t, g in zip(paths, flat, got):
            set_path(grads, path, torch.zeros_like(t) if g is None else g)
        del leaves, flat, got
        opt.step(params, grads, opt_state, lr,
                 layout=model.leaf_layout(params))
        return params, opt_state, loss.detach()
    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> (last logits, states)`` in bf16
    compute; an encoder-decoder model encodes, runs the teacher-forced
    decoder and returns its cross-attention K/V as the state."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encoder_decoder:
            from repro_torch.models import whisper as W
            enc = W.encode(params, cfg, batch["frames"])
            logits = W.decode_train(params, cfg, batch["tokens"], enc)
            cross = W.build_cross_cache(params, cfg, enc)
            return logits[:, -1:], cross
        return model.prefill(params, batch["tokens"],
                             positions=batch.get("positions"),
                             vision_embeds=batch.get("vision_embeds"))
    return prefill_step


def make_serve_step(model: Model, window_override: int = 0):
    """``serve_step(params, caches, token, pos) -> (logits, caches)``:
    one decode step of every row at position ``pos`` (an int or a 0-d
    tensor, the reference's scalar; a [B] tensor gives each row its
    own), in bf16 compute.  MoE layers route the B tokens as one dispatch
    group, as the reference's step does (the serving engine routes each
    slot alone)."""
    cfg = model.cfg

    @torch.no_grad()
    def serve_step(params, caches, token, pos):
        B = token.shape[0]
        pos = torch.as_tensor(pos, device=token.device)
        if pos.dim() == 0:
            pos = pos.expand(B)
        if cfg.is_encoder_decoder:
            return model.decode_step(params, caches, token, pos)
        return model.decode_step(params, caches, token, pos,
                                 window_override=window_override,
                                 moe_per_row=False)
    return serve_step
