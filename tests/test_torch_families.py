"""The attention model families of the port against the JAX package's.

Configs: all ten, field by field, with ``param_count``,
``active_param_count`` and ``reduced()``.  Models: the six configs served
by the attention path besides TinyLlama (MoE + MLA DeepSeek-V2-Lite, MoE
Kimi-K2, Qwen2-VL's M-RoPE, qkv biases and vision stub, LayerNorm
StableLM and Command-R, Llama-3.2), each at ``.reduced()`` in fp32 on the
CPU with the JAX weights carried over by ``from_jax_params`` and the same
seeded inputs.

Tolerances: logits and losses (the MoE aux term included) within 1e-4
(the parity contract's model bar; measured <= 1.5e-6); every gradient
leaf within 2e-5 of its largest |g| (measured <= 2e-6); decode through
the cache against the full forward < 2e-4 (as in
tests/test_decode_equivalence.py); greedy token streams exactly equal.
Before outputs are compared, the MoE tests compare the chosen expert ids
with ``jax.lax.top_k``'s on the same router inputs and state the smallest
gap between the K-th and the (K+1)-th router probability, so a flipped
choice reads as a fault and not as noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as jax_configs
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models import moe as jax_moe
from repro.serve.cache import cache_bytes as jax_cache_bytes
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.request import Request as JaxRequest
import repro_torch.configs as configs
from repro_torch.configs import get_config, shapes
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.common import (activation, apply_mrope, mlp_apply,
                                       mlp_init)
from repro_torch.models.moe import _capacity, moe_apply
from repro_torch.serve.cache import cache_bytes
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request
from repro_torch.train.train_loop import _loss_and_grads

torch.set_num_threads(2)

TOL, GRAD_TOL, DECODE_TOL = 1e-4, 2e-5, 2e-4
FAMILIES = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "qwen2-vl-7b",
            "stablelm-1.6b", "command-r-35b", "llama3.2-3b"]
B, S = 2, 12
_CACHE = {}


def setup(arch, **overrides):
    """(jax cfg, jax model, jax params, cfg, model, port params) of the
    reduced config, the JAX init carried over."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        jcfg = jax_get_config(arch).reduced(**overrides)
        cfg = get_config(arch).reduced(**overrides)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        _CACHE[key] = (jcfg, jmodel, jparams, cfg, build_model(cfg),
                       T.from_jax_params(cfg, jax.tree.map(np.array,
                                                           jparams)))
    return _CACHE[key]


def _batch(cfg):
    """Seeded tokens and labels; for M-RoPE three distinct position rows
    (temporal, height, width) and vision embeddings over 3 slots."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.mrope_sections:
        rows = np.stack([np.arange(S), np.arange(S) // 2, np.arange(S) % 3])
        batch["positions"] = np.broadcast_to(rows, (B, 3, S)).copy()
        batch["vision_embeds"] = rng.randn(B, 3, cfg.d_model).astype(
            np.float32)
    return batch


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(jax_configs.ARCHS))
def test_config_matches_jax(arch):
    for reduce in (False, True):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert ([f.name for f in dataclasses.fields(cfg)]
                == [f.name for f in dataclasses.fields(jcfg)])
        for f in dataclasses.fields(jcfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.attention_free == jcfg.attention_free
        assert cfg.layer_kinds == jcfg.layer_kinds
        assert cfg.padded_vocab(8) == jcfg.padded_vocab(8)


def test_config_registry_and_shapes_match_jax():
    assert list(configs.ARCHS) == list(jax_configs.ARCHS)
    assert configs.SKIPS == jax_configs.SKIPS
    for inc in (False, True):
        assert (list(configs.all_pairs(inc))
                == list(jax_configs.all_pairs(inc)))
    assert ({k: dataclasses.astuple(v) for k, v in configs.INPUT_SHAPES.items()}
            == {k: dataclasses.astuple(v)
                for k, v in jax_configs.INPUT_SHAPES.items()})
    assert shapes.DECODE_32K is configs.get_shape("decode_32k")
    with pytest.raises(KeyError):
        configs.get_shape("nope")
    assert get_config("deepseek-v2-lite-16b").param_count() == 16_210_309_120
    assert get_config("qwen2-vl-7b").param_count() == 7_615_483_904


# ------------------------------------------------- forward, loss, grads
def _router_gaps(arch, params, cfg, batch):
    """Run the port's forward recording every MoE layer's router input;
    per layer, assert the port's top-k expert ids equal
    ``jax.lax.top_k``'s on the same inputs and weights, and return the
    smallest gap between the K-th and (K+1)-th probability."""
    seen = []
    real = T.moe_apply

    def record(p, x, cfg_, per_row=False):
        seen.append((p["router"]["w"], x.detach()))
        return real(p, x, cfg_, per_row)

    T.moe_apply = record
    try:
        T.forward(params, cfg, batch["tokens"], compute_dtype=torch.float32)
    finally:
        T.moe_apply = real
    gaps = []
    K = cfg.experts_per_token
    for w, x in seen:
        probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ w, -1)
        top = torch.topk(probs, K + 1, dim=-1).values
        gaps.append(float((top[:, K - 1] - top[:, K]).min()))
        jprobs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1]).numpy())
                                @ jnp.asarray(w.numpy()), -1)
        jids = np.asarray(jax.lax.top_k(jprobs, K)[1])
        ids = torch.topk(probs, K, dim=-1).indices.numpy()
        np.testing.assert_array_equal(ids, jids)
    assert len(seen) == cfg.num_layers - cfg.first_k_dense
    return min(gaps)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_and_grads_match_jax(arch):
    jcfg, jmodel, jparams, cfg, model, params = setup(arch)
    batch = _batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cfg.moe:
        gap = _router_gaps(arch, params, cfg, tb)
        assert gap > 1e-4, gap    # measured: 1.16e-2 (deepseek), 1.07e-2 (kimi)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlog, jaux, _ = jmodel.forward(
        jparams, jb["tokens"], positions=jb.get("positions"),
        vision_embeds=jb.get("vision_embeds"), compute_dtype=jnp.float32)
    log, aux, _ = model.forward(
        params, tb["tokens"], positions=tb.get("positions"),
        vision_embeds=tb.get("vision_embeds"), compute_dtype=torch.float32)
    assert _err(jlog, log) <= TOL
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, compute_dtype=jnp.float32),
        has_aux=True))(jparams)
    loss, mets, grads = _loss_and_grads(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32),
        params, tb)
    assert abs(float(jl) - float(loss)) <= TOL
    assert abs(float(jm["aux"]) - float(mets["aux"])) <= TOL
    assert (float(mets["aux"]) > 0) == cfg.moe
    layout = model.leaf_layout(params)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in jleaves]
    assert tuple(names) == layout.names
    for i, (_, jgl) in enumerate(jleaves):
        scale = max(float(np.max(np.abs(np.asarray(jgl)))), 1e-12)
        assert _err(jgl, layout.leaf(grads, i)) <= GRAD_TOL * scale, names[i]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """tests/test_decode_equivalence.py on the port (MoE at no-drop
    capacity, M-RoPE positions on all three rows), and the full forward
    against the JAX package's."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch)
    kw = {}
    if cfg.moe:
        no_drop = dict(capacity_factor=float(cfg.num_experts))
        cfg = dataclasses.replace(cfg, **no_drop)
        jcfg = dataclasses.replace(jcfg, **no_drop)
        model, jmodel = build_model(cfg), jax_build_model(jcfg)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    if cfg.mrope_sections:
        kw["positions"] = torch.arange(S)[None, None].expand(B, 3, S)
    full, _, _ = model.forward(params, torch.from_numpy(toks),
                               compute_dtype=torch.float32, **kw)
    jfull, _, _ = jmodel.forward(jparams, jnp.asarray(toks),
                                 compute_dtype=jnp.float32,
                                 **{k: jnp.asarray(v.numpy())
                                    for k, v in kw.items()})
    assert _err(jfull, full) <= TOL
    caches = model.init_cache(B, S, dtype=torch.float32)
    outs = []
    for t in range(S):
        lg, caches = model.decode_step(params, caches,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       torch.full((B,), t),
                                       compute_dtype=torch.float32)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    assert float((full - dec).abs().max()) < DECODE_TOL


def test_init_matches_jax_shapes_and_dtypes():
    """The seeded init's leaves have the JAX init's shapes (padded vocab
    included) and dtypes; the router and norms stay fp32 in bf16."""
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        p = model.init(seed=0, dtype=torch.bfloat16, vocab_pad_multiple=7)
        jp = jax.eval_shape(lambda: jax_build_model(
            jax_get_config(arch).reduced()).init(
                jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                vocab_pad_multiple=7))
        layout = model.leaf_layout(p)
        jleaves = jax.tree.leaves(jp)
        assert [tuple(x.shape) for x in jleaves] == layout.shapes(p), arch
        for i, x in enumerate(jleaves):
            assert (str(layout.leaf(p, i).dtype)[6:]
                    == str(x.dtype)), (arch, layout.names[i])
    p = build_model(get_config("deepseek-v2-lite-16b").reduced()).init(seed=0)
    w = p["layers"][1]["moe"]["w_down"]
    assert abs(w.std().item() - w.shape[1] ** -0.5) < 0.01


def test_mrope_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 3, 32).astype(np.float32)
    pos = np.stack([rng.randint(0, 50, (2, 7)) for _ in range(3)], 1)
    ref = jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 6, 6),
                                 1e6)
    out = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 6, 6),
                      1e6)
    assert _err(ref, out) <= 1e-5


def test_activations_and_gelu_mlp_match_jax():
    """``gelu`` is jax.nn.gelu's tanh form (F.gelu's default, the erf
    form, differs by up to ~5e-4 here); the GELU MLP (Whisper's) carries
    the JAX weights."""
    x = _x(6, 4, 64) * 3
    for name in ("gelu", "silu", "relu_sq"):
        ref = jax_common.activation(name, jnp.asarray(x))
        assert _err(ref, activation(name, torch.from_numpy(x))) <= 1e-6, name
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _err(jax_common.activation("gelu", jnp.asarray(x)), erf) > 1e-4
    jp = jax_common.mlp_init(jax.random.PRNGKey(1), 64, 96, "gelu", True)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert set(p) == set(mlp_init(torch.Generator().manual_seed(0), 64, 96,
                                  "gelu", True))
    assert _err(jax_common.mlp_apply(jp, jnp.asarray(x), "gelu"),
                mlp_apply(p, torch.from_numpy(x), "gelu")) <= 1e-5


# ------------------------------------------------------------------- MoE
def _moe_cfg(E=4, K=2, cap=8.0):
    """tests/test_moe.py's config (the JAX package's ``moe_*`` read the
    same fields)."""
    return dataclasses.replace(
        get_config("kimi-k2-1t-a32b").reduced(), num_experts=E,
        experts_per_token=K, capacity_factor=cap, num_shared_experts=0,
        d_model=32, moe_d_ff=16)


def _moe_params(cfg, seed):
    """JAX ``moe_init`` weights and their torch copies."""
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), cfg)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_moe_no_drop_equals_dense_computation():
    cfg = _moe_cfg()
    _, p = _moe_params(cfg, 0)
    x = torch.from_numpy(_x(1, 2, 6, cfg.d_model))
    out, aux = moe_apply(p, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    gate, ids = torch.topk(probs, cfg.experts_per_token)
    gate = gate / gate.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["w_gate"]))
    h = h * torch.einsum("td,edf->tef", xt, p["w_up"])
    all_e = torch.einsum("tef,efd->ted", h, p["w_down"])
    ref = torch.einsum("tkd,tk->td",
                       all_e.gather(1, ids[..., None].expand(-1, -1,
                                                             cfg.d_model)),
                       gate)
    assert float((out.reshape(-1, cfg.d_model) - ref).abs().max()) <= 1e-4
    assert float(aux) >= 0


@pytest.mark.parametrize("cap", [1.0, 0.5, 8.0])
def test_moe_with_drops_matches_jax(cap):
    """Capacity dispatch (dropped tokens included) and the aux loss equal
    the JAX package's, with and without a shared expert."""
    for shared in (0, 1):
        cfg = dataclasses.replace(_moe_cfg(cap=cap),
                                  num_shared_experts=shared)
        jp, p = _moe_params(cfg, 2)
        x = _x(3, 4, 8, cfg.d_model)
        jout, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), cfg)
        out, aux = moe_apply(p, torch.from_numpy(x), cfg)
        assert _err(jout, out) <= 1e-5
        assert abs(float(jaux) - float(aux)) <= 1e-6


def test_moe_per_row_is_each_row_alone():
    """``per_row``: every row dispatches alone (the JAX serving step's
    vmap over slots at batch 1), whatever the other rows routed."""
    cfg = _moe_cfg(cap=1.0)
    jp, p = _moe_params(cfg, 4)
    x = _x(5, 6, 1, cfg.d_model)
    out, _ = moe_apply(p, torch.from_numpy(x), cfg, per_row=True)
    alone = torch.cat([moe_apply(p, torch.from_numpy(x[i:i + 1]), cfg)[0]
                       for i in range(6)])
    jout = jax.vmap(lambda r: jax_moe.moe_apply(jp, r[None], cfg)[0][0])(
        jnp.asarray(x))
    assert float((out - alone).abs().max()) <= 1e-6
    assert _err(jout, out) <= 1e-5
    together, _ = moe_apply(p, torch.from_numpy(x.reshape(1, 6, -1)), cfg)
    assert float((together.reshape(out.shape) - out).abs().max()) > 1e-3


def test_moe_capacity_drops_are_bounded():
    cfg = _moe_cfg(cap=1.0)
    _, p = _moe_params(cfg, 2)
    out, _ = moe_apply(p, torch.from_numpy(_x(3, 4, 8, cfg.d_model)), cfg)
    assert bool(torch.isfinite(out).all())


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 64), st.integers(1, 4), st.integers(2, 16))
def test_moe_capacity_formula(T_, K, E):
    C = _capacity(T_, K, E, 1.0)
    assert C >= 1 and C * E >= T_ * K
    assert C == jax_moe._capacity(T_, K, E, 1.0)


def test_moe_aux_loss_penalizes_imbalance():
    cfg = _moe_cfg(E=4, K=1)
    _, p = _moe_params(cfg, 4)
    x = torch.from_numpy(_x(5, 2, 16, cfg.d_model))
    w = p["router"]["w"]
    _, aux_uniform = moe_apply(dict(p, router={"w": torch.zeros_like(w)}),
                               x, cfg)
    collapsed = torch.zeros_like(w)
    collapsed[:, 0] = 100.0
    _, aux_collapsed = moe_apply(dict(p, router={"w": collapsed}), x, cfg)
    assert float(aux_collapsed) > float(aux_uniform)


def test_moe_grads_flow_to_experts_and_router():
    cfg = _moe_cfg()
    _, p = _moe_params(cfg, 6)
    x = torch.from_numpy(_x(7, 2, 6, cfg.d_model))
    leaves = jax.tree.map(lambda t: t.requires_grad_(), p)
    out, aux = moe_apply(leaves, x, cfg)
    ((out ** 2).sum() + aux).backward()
    for name in ("w_gate", "w_down"):
        assert float(leaves[name].grad.abs().sum()) > 0
    assert float(leaves["router"]["w"].grad.abs().sum()) > 0


# --------------------------------------------------------------- serving
def _requests(cls, vocab, n=3, plen=5, new=6):
    prompts = np.random.RandomState(0).randint(1, vocab, size=(n, plen))
    return [cls(rid=i, prompt=[int(t) for t in prompts[i]],
                max_new_tokens=new) for i in range(n)]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-vl-7b"])
def test_engine_streams_match_jax(arch):
    """Greedy streams through both engines, contiguous and paged (page 4):
    all four equal (tests/test_serving.py::test_paged_matches_contiguous
    for the MLA latent pools)."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch)
    streams = []
    for page_size in (0, 4):
        kw = dict(slots=2, max_len=16, page_size=page_size)
        jreqs = _requests(JaxRequest, cfg.vocab_size)
        JaxServeEngine(jmodel, jparams, JaxServeConfig(**kw)).run(jreqs)
        reqs = _requests(Request, cfg.vocab_size)
        m = ServeEngine(model, params, ServeConfig(**kw),
                        device="cpu").run(reqs)
        assert m["completed"] == 3 and m["paged"] == bool(page_size)
        streams += [[r.output for r in jreqs], [r.output for r in reqs]]
    assert all(s == streams[0] for s in streams)


@pytest.mark.parametrize("page_size", [0, 4])
def test_mla_cache_bytes_match_jax(page_size):
    jcfg, jmodel, jparams, cfg, model, params = setup("deepseek-v2-lite-16b")
    kw = dict(slots=3, max_len=20, page_size=page_size)
    eng = ServeEngine(model, params, ServeConfig(**kw), device="cpu")
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(**kw))
    assert cache_bytes(eng.kv.store) == jax_cache_bytes(jeng.kv.store) > 0
    assert eng.kv.paged == jeng.kv.paged == bool(page_size)
    per_token = cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4
    if not page_size:
        assert cache_bytes(eng.kv.store) == 3 * 20 * per_token
