"""Model zoo of the port: the decoder-only LM (dense GQA, MoE, MLA,
M-RoPE with a vision stub, RG-LRU with local attention, RWKV-6) and the
Whisper encoder-decoder.

``build_model(cfg)`` returns the same functional API as the JAX package's
``build_model``, with an explicit ``device``.  As there, an
encoder-decoder model has no ``forward``, ``prefill`` or
``cache_from_prefill``: it is driven through ``models.whisper``'s
``encode`` / ``build_cross_cache`` and ``decode_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (seed=0, dtype=..., device=...,
                            #  vocab_pad_multiple=1) -> params
    loss_fn: Callable       # (params, batch, compute_dtype=..., remat=False)
                            # -> (loss, metrics)
    leaf_layout: Callable   # params -> LeafLayout (the JAX package's leaves)
    forward: Optional[Callable]  # (params, tokens, **kw) -> (logits, aux, caches | None)
    init_cache: Callable    # (batch, max_len, dtype, **kw) -> caches
    decode_step: Callable   # (params, caches, token, pos, **kw) -> (logits, caches)
                            # (tp_axis=: serve.tp's rank-stacked params and caches)
    prefill: Optional[Callable]  # (params, tokens, **kw) -> (last logits, states)
    # prefill states -> init_cache decode layout (serving-plane plumbing)
    cache_from_prefill: Optional[Callable] = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encoder_decoder:
        from repro_torch.models import whisper as W
        return Model(
            cfg=cfg,
            init=lambda seed=0, dtype=torch.float32, device="cpu",
                vocab_pad_multiple=1:
                W.init_params(cfg, seed, dtype, device, vocab_pad_multiple),
            loss_fn=lambda params, batch, compute_dtype=torch.bfloat16,
                remat=False:
                W.loss_fn(params, cfg, batch, compute_dtype, remat),
            leaf_layout=lambda params: W.leaf_layout(cfg, params),
            forward=None,
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, **kw:
                W.init_cache(cfg, batch, max_len, dtype, **kw),
            decode_step=lambda params, caches, token, pos,
                compute_dtype=torch.bfloat16, **kw:
                W.decode_step(params, cfg, caches, token, pos, compute_dtype,
                              **kw),
            prefill=None,
        )
    from repro_torch.models import transformer as T
    T.plan_segments(cfg)                       # rejects unknown layer kinds
    return Model(
        cfg=cfg,
        init=lambda seed=0, dtype=torch.float32, device="cpu",
            vocab_pad_multiple=1:
            T.init_params(cfg, seed, dtype, device, vocab_pad_multiple),
        loss_fn=lambda params, batch, compute_dtype=torch.bfloat16,
            remat=False:
            T.loss_fn(params, cfg, batch, compute_dtype, remat),
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
