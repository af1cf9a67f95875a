"""Model zoo of the port: the decoder-only LM (dense GQA, MoE, MLA,
M-RoPE with a vision stub).

``build_model(cfg)`` returns the same functional API as the JAX package's
``build_model`` for decoder-only configs, with an explicit ``device``.
The recurrent and encoder-decoder families (ROADMAP queue A item 7b)
raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (seed=0, dtype=..., device=...,
                            #  vocab_pad_multiple=1) -> params
    loss_fn: Callable       # (params, batch, compute_dtype=...) -> (loss, metrics)
    leaf_layout: Callable   # params -> LeafLayout (the JAX package's leaves)
    forward: Callable       # (params, tokens, **kw) -> (logits, aux, caches | None)
    init_cache: Callable    # (batch, max_len, dtype, **kw) -> caches
    decode_step: Callable   # (params, caches, token, pos, **kw) -> (logits, caches)
                            # (tp_axis=: serve.tp's rank-stacked params and caches)
    prefill: Callable       # (params, tokens, **kw) -> (last logits, states)
    # prefill states -> init_cache decode layout (serving-plane plumbing)
    cache_from_prefill: Callable


def build_model(cfg: ModelConfig) -> Model:
    from repro_torch.models import transformer as T
    T.plan_segments(cfg)                       # rejects unported families
    return Model(
        cfg=cfg,
        init=lambda seed=0, dtype=torch.float32, device="cpu",
            vocab_pad_multiple=1:
            T.init_params(cfg, seed, dtype, device, vocab_pad_multiple),
        loss_fn=lambda params, batch, compute_dtype=torch.bfloat16:
            T.loss_fn(params, cfg, batch, compute_dtype),
        leaf_layout=lambda params: T.leaf_layout(cfg, params),
        forward=lambda params, tokens, **kw: T.forward(params, cfg, tokens, **kw),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, **kw:
            T.init_cache(cfg, batch, max_len, dtype, **kw),
        decode_step=lambda params, caches, token, pos,
            compute_dtype=torch.bfloat16, **kw:
            T.decode_step(params, cfg, caches, token, pos, compute_dtype, **kw),
        prefill=lambda params, tokens, **kw: T.prefill(params, cfg, tokens, **kw),
        cache_from_prefill=lambda fwd_caches, max_len, dtype=torch.bfloat16,
            **kw: T.cache_from_prefill(cfg, fwd_caches, max_len, dtype, **kw),
    )
