"""Whisper large-v3 backbone: transformer encoder-decoder (arXiv:2212.04356;
the JAX package's ``models/whisper.py``).

The mel-spectrogram + conv1d feature extractor is a stub, as in the
reference: callers pass the frame embeddings [B, n_frames, d_model] the
conv front end would make.  Everything after it is here: sinusoidal
encoder positions, learned decoder positions (448 rows, positions past
447 read row 447), self- and cross-attention, and the decoder's caches.

Parameters: ``embed [Vpad, d]`` (tied to the output), ``dec_pos [448,
d]``, ``enc_layers`` and ``dec_layers`` (lists of one dict per layer; the
JAX package stacks them), ``enc_ln_post`` and ``dec_ln_post``.  The
encoder's self-attention is non-causal and the decoder's causal; both run
``flash_attention`` on the card, the decoder's one-token steps
``flash_decode``.  Cross-attention is plain PyTorch on every device, as
in the reference.

Caches keep the reference's layout, each leaf stacked over the decoder
layers: ``{"self": {"k", "v"} [L, B, max_len, KV, hd], "cross": {"k",
"v"} [L, B, frames, KV, hd]}``; ``decode_step`` writes the self-attention
rows of layer l in place through a view of row l.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import LeafLayout, leaf_paths, tree_map
from repro_torch.models import attention as attn
from repro_torch.models.common import (_generator, cross_entropy, dense,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, to_tensor)

DEC_POSITIONS = 448
STACKS = ("dec_layers", "enc_layers")


def _sinusoids(length: int, channels: int, device="cpu"):
    """The encoder's positions: numpy in float64, then fp32 (as the
    reference makes them)."""
    log_timescale = np.log(10_000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(scaled), np.cos(scaled)], 1)
    return torch.tensor(table, dtype=torch.float32, device=device)


def _enc_layer_init(gen, cfg, dtype, device):
    return {"ln1": norm_init(cfg.norm, cfg.d_model, device=device),
            "attn": attn.attn_init(gen, cfg, dtype, device),
            "ln2": norm_init(cfg.norm, cfg.d_model, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.use_bias, dtype, device)}


def _dec_layer_init(gen, cfg, dtype, device):
    return {"ln1": norm_init(cfg.norm, cfg.d_model, device=device),
            "self_attn": attn.attn_init(gen, cfg, dtype, device),
            "ln_x": norm_init(cfg.norm, cfg.d_model, device=device),
            "cross_attn": attn.attn_init(gen, cfg, dtype, device,
                                         cross=True),
            "ln2": norm_init(cfg.norm, cfg.d_model, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.use_bias, dtype, device)}


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cpu", vocab_pad_multiple: int = 1):
    """Seeded init with the JAX init's distributions (embed ``normal *
    0.02``, dec_pos ``normal * 0.01``, dense weights ``normal / sqrt(in)``,
    zero biases, fp32 norms); the draws differ from ``jax.random``'s."""
    gen = _generator(device, seed)
    V, d = cfg.padded_vocab(vocab_pad_multiple), cfg.d_model

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32)

    return {
        "embed": (normal(V, d) * 0.02).to(dtype),
        "dec_pos": (normal(DEC_POSITIONS, d) * 0.01).to(dtype),
        "enc_layers": [_enc_layer_init(gen, cfg, dtype, device)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg, dtype, device)
                       for _ in range(cfg.num_layers)],
        "enc_ln_post": norm_init(cfg.norm, d, device=device),
        "dec_ln_post": norm_init(cfg.norm, d, device=device),
    }


def from_jax_params(cfg: ModelConfig, tree):
    """The JAX package's parameter tree (numpy leaves, or tensors) -> the
    port's: the ``enc_layers`` / ``dec_layers`` stacks un-stacked into one
    dict per layer."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key in STACKS:
            n = sub["ln1"]["scale"].shape[0]
            out[key] = [tree_map(lambda a, _i=i: to_tensor(a[_i]), sub)
                        for i in range(n)]
        else:
            out[key] = tree_map(to_tensor, sub)
    return out


def leaf_layout(cfg: ModelConfig, params) -> LeafLayout:
    """The JAX package's leaves over the port's ``params``: top-level keys
    sorted, each layer parameter of a stack one leaf stacked over its
    layers."""
    names, parts, stacked = [], [], []
    for key in sorted(params):
        if key in STACKS:
            n = len(params[key])
            for path in leaf_paths(params[key][0]):
                names.append("/".join(map(str, (key,) + path)))
                parts.append(tuple((key, i) + path for i in range(n)))
                stacked.append(True)
        else:
            for path in leaf_paths(params[key]):
                names.append("/".join(map(str, (key,) + path)))
                parts.append(((key,) + path,))
                stacked.append(False)
    return LeafLayout(tuple(names), tuple(parts), tuple(stacked))


def _layers(body, layer_params, x, remat: bool):
    """``x = body(p, x)`` over the layers; ``remat`` recomputes each
    layer in the backward (the reference's ``jax.checkpoint`` of its scan
    body; non-reentrant ``torch.utils.checkpoint``)."""
    for p in layer_params:
        x = (checkpoint(body, p, x, use_reentrant=False) if remat
             else body(p, x))
    return x


def encode(params, cfg: ModelConfig, frames, compute_dtype=torch.bfloat16,
           remat: bool = False):
    """frames [B, n_frames, d_model] (the conv front end's output)."""
    B, Fr, _ = frames.shape
    x = frames.to(compute_dtype) + _sinusoids(
        Fr, cfg.d_model, frames.device)[None].to(compute_dtype)
    pos = torch.arange(Fr, device=frames.device)[None].expand(B, Fr)

    def body(p, x):
        h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
        out, _ = attn.attention_forward(p["attn"], h, pos, cfg, causal=False,
                                        use_rope=False)
        x = x + out
        h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, cfg.act)

    x = _layers(body, params["enc_layers"], x, remat)
    return norm_apply(cfg.norm, params["enc_ln_post"], x, cfg.norm_eps)


def _dec_positions(params, pos, compute_dtype):
    """Learned positions of ``pos`` [...] (clipped to the table's 448
    rows)."""
    idx = pos.clamp(0, params["dec_pos"].shape[0] - 1)
    return params["dec_pos"].to(compute_dtype)[idx]


def _logits(params, cfg: ModelConfig, x):
    x = norm_apply(cfg.norm, params["dec_ln_post"], x, cfg.norm_eps)
    return x @ params["embed"].to(x.dtype).T


def decode_train(params, cfg: ModelConfig, tokens, enc_out,
                 compute_dtype=torch.bfloat16, remat: bool = False):
    """Teacher-forced decoder forward.  tokens [B, S] -> logits."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = params["embed"].to(compute_dtype)[tokens]
    x = x + _dec_positions(params, pos[:1], compute_dtype)

    def body(p, x):
        h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
        out, _ = attn.attention_forward(p["self_attn"], h, pos, cfg,
                                        causal=True, use_rope=False)
        x = x + out
        h = norm_apply(cfg.norm, p["ln_x"], x, cfg.norm_eps)
        out, _ = attn.attention_forward(p["cross_attn"], h, pos, cfg,
                                        kv_x=enc_out)
        x = x + out
        h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, cfg.act)

    return _logits(params, cfg, _layers(body, params["dec_layers"], x, remat))


def loss_fn(params, cfg: ModelConfig, batch, compute_dtype=torch.bfloat16,
            remat: bool = False):
    """batch: {frames [B, F, d], tokens [B, S], labels [B, S][, mask]}.
    Returns (ce, {"ce", "aux": 0})."""
    enc_out = encode(params, cfg, batch["frames"], compute_dtype, remat)
    logits = decode_train(params, cfg, batch["tokens"], enc_out,
                          compute_dtype, remat)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"),
                       vocab_size=cfg.vocab_size)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_frames: int = 1500, device="cpu"):
    """Per decoder layer: the self-attention cache and the cross K/V
    (filled by ``build_cross_cache``), stacked over layers."""
    KV, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def zeros(n):
        return torch.zeros((L, batch, n, KV, hd), dtype=dtype, device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(enc_frames), "v": zeros(enc_frames)}}


def build_cross_cache(params, cfg: ModelConfig, enc_out,
                      dtype=torch.bfloat16):
    """Every decoder layer's cross-attention K/V of the encoder output,
    stacked: {"k", "v"} [L, B, frames, KV, hd]."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    shp = enc_out.shape[:2] + (KV, hd)
    ks, vs = [], []
    for p in params["dec_layers"]:
        ks.append(dense(p["cross_attn"]["wk"], enc_out).reshape(shp).to(dtype))
        vs.append(dense(p["cross_attn"]["wv"], enc_out).reshape(shp).to(dtype))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg: ModelConfig, cache, token, pos,
                compute_dtype=torch.bfloat16):
    """One decoder token.  token [B, 1]; pos [B] int (each row's
    position); cache from ``init_cache`` with its cross K/V filled.
    Writes the self-attention rows in place; returns (logits [B, 1,
    Vpad], cache)."""
    x = params["embed"].to(compute_dtype)[token]
    x = x + _dec_positions(params, pos[:, None], compute_dtype)
    for li, p in enumerate(params["dec_layers"]):
        self_c = {n: t[li] for n, t in cache["self"].items()}
        cross_c = {n: t[li] for n, t in cache["cross"].items()}
        h = norm_apply(cfg.norm, p["ln1"], x, cfg.norm_eps)
        out, _ = attn.attention_decode(p["self_attn"], h, pos, self_c, cfg,
                                       use_rope=False)
        x = x + out
        h = norm_apply(cfg.norm, p["ln_x"], x, cfg.norm_eps)
        out, _ = attn.attention_decode(p["cross_attn"], h, pos, None, cfg,
                                       cross_kv=cross_c)
        x = x + out
        h = norm_apply(cfg.norm, p["ln2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.act)
    return _logits(params, cfg, x), cache
