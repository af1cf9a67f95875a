"""The port's dense decoder against the JAX package's, on the same weights.

Reduced TinyLlama with 2 KV heads for 4 query heads (so GQA folding is
exercised), JAX-initialised weights carried over by ``from_jax_params``,
fp32 on the CPU.  Logits agree within 1e-4: the reference's own
kernel-vs-ref bar for model outputs (docs/kernels.md).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as T

torch.set_num_threads(2)

TOL = 1e-4
_CACHE = {}


def models():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced(num_kv_heads=2)
        cfg = get_config("tinyllama-1.1b").reduced(num_kv_heads=2)
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        params = T.from_jax_params(cfg, jax.tree.map(np.array, jparams))
        _CACHE.update(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)
    return _CACHE


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


def test_reduced_config_matches_jax():
    m = models()
    for f in dataclasses.fields(m["cfg"]):
        assert getattr(m["cfg"], f.name) == getattr(m["jcfg"], f.name), f.name
    assert m["cfg"].num_heads == 4 and m["cfg"].num_kv_heads == 2
    assert m["cfg"].param_count() == m["jcfg"].param_count()


def test_from_jax_params_unstacks_every_layer():
    m = models()
    cfg, params, jparams = m["cfg"], m["params"], m["jparams"]
    assert len(params["layers"]) == cfg.num_layers
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            layer["mixer"]["wq"]["w"].numpy(),
            np.asarray(jparams["segments"][0][0]["mixer"]["wq"]["w"][i]))
    assert params["lm_head"].shape == (cfg.d_model, cfg.vocab_size)


def test_init_params_distributions():
    cfg = get_config("tinyllama-1.1b").reduced()
    p = T.init_params(cfg, seed=0)
    q = T.init_params(cfg, seed=0)
    assert torch.equal(p["embed"], q["embed"])            # seeded
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["lm_head"].std().item() - cfg.d_model ** -0.5) < 0.01
    w_down = p["layers"][0]["mlp"]["w_down"]["w"]
    assert abs(w_down.std().item() - cfg.d_ff ** -0.5) < 0.01
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))


def test_forward_logits_match_jax():
    m = models()
    tokens = np.random.RandomState(0).randint(1, 512, size=(2, 12))
    ref, _, _ = JT.forward(m["jparams"], m["jcfg"], jnp.asarray(tokens),
                           compute_dtype=jnp.float32)
    out, _, _ = T.forward(m["params"], m["cfg"], torch.from_numpy(tokens),
                          compute_dtype=torch.float32)
    assert _max_err(ref, out) <= TOL


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_then_decode_matches_jax(window):
    """prefill + cache_from_prefill + 6 decode steps (teacher-forced with
    the reference's greedy tokens); ``window=8`` runs the ring buffer past
    its wrap (prompt 10, positions up to 15)."""
    m = models()
    jcfg, cfg = m["jcfg"], m["cfg"]
    B, S0, max_len = 2, 10, 16
    tokens = np.random.RandomState(1).randint(1, 512, size=(B, S0))
    f32 = dict(compute_dtype=jnp.float32, window_override=window)
    jlog, jst = JT.prefill(m["jparams"], jcfg, jnp.asarray(tokens), **f32)
    jc = JT.cache_from_prefill(jcfg, jst, max_len, jnp.float32,
                               window_override=window)
    tf32 = dict(compute_dtype=torch.float32, window_override=window)
    log, st = T.prefill(m["params"], cfg, torch.from_numpy(tokens), **tf32)
    c = T.cache_from_prefill(cfg, st, max_len, torch.float32,
                             window_override=window)
    assert _max_err(jlog, log) <= TOL
    for step in range(6):
        pos = S0 + step
        tok = np.asarray(jnp.argmax(jlog[..., :cfg.vocab_size], -1),
                         np.int64)                         # [B, 1]
        jlog, jc = JT.decode_step(m["jparams"], jcfg, jc,
                                  jnp.asarray(tok, jnp.int32), pos, **f32)
        log, c = T.decode_step(m["params"], cfg, c, torch.from_numpy(tok),
                               torch.full((B,), pos), **tf32)
        assert _max_err(jlog, log) <= TOL, step


def test_build_model_rejects_unported_families():
    """Every layer kind of the JAX package builds (RG-LRU too); a kind no
    package has is refused."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              block_pattern=("rglru",))
    assert build_model(cfg).cfg.layer_kinds == ("rglru", "rglru")
    with pytest.raises(ValueError, match="unknown layer kinds"):
        build_model(dataclasses.replace(cfg, block_pattern=("mamba",)))
