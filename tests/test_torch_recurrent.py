"""The recurrent families of the port against the JAX package's:
RecurrentGemma (RG-LRU beside ``local`` sliding-window attention, MQA)
and RWKV-6, at small sizes in fp32 on the CPU with the JAX weights
carried over by ``from_jax_params`` and the same seeded inputs.

RecurrentGemma's ``.reduced()`` has 2 layers, (rglru, rglru), and no
``local`` layer; the model cases use ``.reduced(num_layers=4)``: one
(rglru, rglru, local) scan group and a plain rglru straggler, window 8,
and prompts longer than the window, so the ring wraps in
``cache_from_prefill`` and again in decode.

Tolerances: logits within 1e-5 and losses within 1e-4 (the parity
contract's bar; the doubling scan and ``associative_scan`` round in other
orders); every gradient leaf within 2e-5 of its largest |g|; decode
through the caches against the full forward < 2e-4 (as in
tests/test_decode_equivalence.py); greedy token streams exactly equal.
The serving cases reproduce the four ``recurrentgemma-9b`` rows of
``BENCH_pr7.json`` (both policies, both cache layouts): the virtual-clock
columns exactly, and token streams equal to the JAX engine's and to each
other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv
from repro.models import transformer as jax_T
from repro.serve.autoscale import poisson_trace as jax_poisson_trace
from repro.serve.cache import cache_bytes as jax_cache_bytes
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.request import Request as JaxRequest
from repro.serve.tp import check_tp_supported as jax_check_tp_supported
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import build_model
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import transformer as T
from repro_torch.serve.autoscale import poisson_trace
from repro_torch.serve.cache import cache_bytes
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request
from repro_torch.serve.tp import TPContext, check_tp_supported
from repro_torch.train.train_loop import _loss_and_grads

torch.set_num_threads(2)

LOGIT_TOL, LOSS_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-5, 2e-4
RG, RWKV = "recurrentgemma-9b", "rwkv6-7b"
MODELS = [(RG, 4), (RWKV, 2)]        # (arch, layers) of the model cases
B, S = 2, 14                         # S > the reduced window of 8
_CACHE = {}


def setup(arch, layers):
    """(jax cfg, jax model, jax params, cfg, model, port params) of the
    reduced config at ``layers`` layers, the JAX init carried over."""
    key = (arch, layers)
    if key not in _CACHE:
        jcfg = jax_get_config(arch).reduced(num_layers=layers)
        cfg = get_config(arch).reduced(num_layers=layers)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        _CACHE[key] = (jcfg, jmodel, jparams, cfg, build_model(cfg),
                       T.from_jax_params(cfg, jax.tree.map(np.array,
                                                           jparams)))
    return _CACHE[key]


def _tokens(cfg, seed=0, n=S + 1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, n))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


# ----------------------------------------------------- configs and plans
@pytest.mark.parametrize("arch,layers", [(RG, 38), (RG, 4), (RG, 2),
                                         (RWKV, 32), (RWKV, 2)])
def test_plan_segments_match_jax(arch, layers):
    """At 38 layers: 12 groups of (rglru, rglru, local), then 2 plain
    rglru stragglers."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    jcfg = dataclasses.replace(jax_get_config(arch), num_layers=layers)
    assert T.plan_segments(cfg) == jax_T.plan_segments(jcfg)
    if (arch, layers) == (RG, 38):
        assert T.plan_segments(cfg) == (
            [("scan", (("rglru", False), ("rglru", False),
                       ("local", False)), 12)]
            + [("plain", ("rglru", False))] * 2)


def test_full_configs_build_and_count():
    """Every config builds (the families of item 7b included); the full
    widths' parameter counts of the three configs."""
    from repro_torch.configs import ARCHS
    for name, cfg in ARCHS.items():
        assert build_model(cfg).cfg is cfg, name
    assert get_config(RG).param_count() == jax_get_config(RG).param_count()
    assert get_config(RWKV).param_count() == jax_get_config(
        RWKV).param_count()


@pytest.mark.parametrize("arch,layers", MODELS)
def test_init_matches_jax_shapes_and_dtypes(arch, layers):
    """The seeded bf16 init has the JAX init's leaves, shapes and dtypes:
    ``lam`` and RWKV's ``mu``, ``w0``, ``wA``, ``wB``, ``u`` stay fp32."""
    cfg = get_config(arch).reduced(num_layers=layers)
    model = build_model(cfg)
    p = model.init(seed=0, dtype=torch.bfloat16, vocab_pad_multiple=7)
    jp = jax.eval_shape(lambda: jax_build_model(
        jax_get_config(arch).reduced(num_layers=layers)).init(
            jax.random.PRNGKey(0), dtype=jnp.bfloat16, vocab_pad_multiple=7))
    layout = model.leaf_layout(p)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in jleaves]
    assert tuple(names) == layout.names
    assert [tuple(x.shape) for _, x in jleaves] == layout.shapes(p)
    for i, (_, x) in enumerate(jleaves):
        assert str(layout.leaf(p, i).dtype)[6:] == str(x.dtype), names[i]
    fp32 = {n.split("/")[-1] for i, n in enumerate(names)
            if layout.leaf(p, i).dtype == torch.float32}
    if arch == RG:
        assert "lam" in fp32
        lam = p["layers"][0]["mixer"]["lam"]
        assert torch.equal(lam, torch.from_numpy(np.array(
            jax_rglru.rglru_init(jax.random.PRNGKey(0), cfg)["lam"])))
    else:
        assert {"r", "w0", "wA", "wB", "u"} <= fp32


# ------------------------------------------------- forward, loss, grads
@pytest.mark.parametrize("arch,layers", MODELS)
def test_forward_loss_and_grads_match_jax(arch, layers):
    jcfg, jmodel, jparams, cfg, model, params = setup(arch, layers)
    toks = _tokens(cfg)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlog, _, _ = jmodel.forward(jparams, jb["tokens"],
                                compute_dtype=jnp.float32)
    log, aux, _ = model.forward(params, tb["tokens"],
                                compute_dtype=torch.float32)
    assert _err(jlog, log) <= LOGIT_TOL
    assert float(aux) == 0.0
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, compute_dtype=jnp.float32),
        has_aux=True))(jparams)
    loss, _, grads = _loss_and_grads(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32),
        params, tb)
    assert abs(float(jl) - float(loss)) <= LOSS_TOL
    layout = model.leaf_layout(params)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    for i, (path, jgl) in enumerate(jleaves):
        scale = max(float(np.max(np.abs(np.asarray(jgl)))), 1e-12)
        assert _err(jgl, layout.leaf(grads, i)) <= GRAD_TOL * scale, \
            layout.names[i]


@pytest.mark.parametrize("arch,layers", MODELS)
def test_prefill_then_decode_matches_forward(arch, layers):
    """``prefill`` of 10 tokens -> ``cache_from_prefill`` -> 4 decode
    steps, against the full forward (and the JAX decode of the same
    steps); at step 0 the local layer's ring of 8 already wrapped."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch, layers)
    toks = _tokens(cfg, seed=1, n=S)
    P = 10
    full, _, _ = model.forward(params, torch.from_numpy(toks),
                               compute_dtype=torch.float32)
    lg, st = model.prefill(params, torch.from_numpy(toks[:, :P]),
                           compute_dtype=torch.float32)
    caches = model.cache_from_prefill(st, S, dtype=torch.float32)
    jlg, jst = jmodel.prefill(jparams, jnp.asarray(toks[:, :P]),
                              compute_dtype=jnp.float32)
    jcaches = jmodel.cache_from_prefill(jst, S, dtype=jnp.float32)
    outs = [lg[:, 0]]
    jouts = [jlg[:, 0]]
    for t in range(P, S):
        lg, caches = model.decode_step(params, caches,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       torch.full((B,), t),
                                       compute_dtype=torch.float32)
        jlg, jcaches = jmodel.decode_step(jparams, jcaches,
                                          jnp.asarray(toks[:, t:t + 1]), t,
                                          compute_dtype=jnp.float32)
        outs.append(lg[:, 0])
        jouts.append(jlg[:, 0])
    dec = torch.stack(outs, 1)
    assert float((full[:, P - 1:] - dec).abs().max()) < DECODE_TOL
    assert _err(jnp.stack(jouts, 1), dec) <= DECODE_TOL


@pytest.mark.parametrize("arch,layers", MODELS)
def test_decode_from_empty_cache_matches_forward(arch, layers):
    """tests/test_decode_equivalence.py on the port: every token through
    ``decode_step`` from ``init_cache`` (the ring wraps at step 8)."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch, layers)
    toks = _tokens(cfg, seed=2, n=S)
    full, _, _ = model.forward(params, torch.from_numpy(toks),
                               compute_dtype=torch.float32)
    caches = model.init_cache(B, S, dtype=torch.float32)
    outs = []
    for t in range(S):
        lg, caches = model.decode_step(params, caches,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       torch.full((B,), t),
                                       compute_dtype=torch.float32)
        outs.append(lg[:, 0])
    assert float((full - torch.stack(outs, 1)).abs().max()) < DECODE_TOL


@pytest.mark.parametrize("arch,layers", MODELS)
def test_cache_dtypes_under_bf16(arch, layers):
    """A bf16 cache keeps RWKV's ``S`` in fp32 and everything else in
    bf16, in ``init_cache`` and after ``cache_from_prefill``, as the JAX
    package's; leaf shapes equal the JAX caches' (per layer)."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch, layers)
    caches = model.init_cache(B, S, dtype=torch.bfloat16)
    toks = torch.from_numpy(_tokens(cfg, n=10))
    _, st = model.prefill(params, toks, compute_dtype=torch.float32)
    conv = model.cache_from_prefill(st, S, dtype=torch.bfloat16)
    jcaches = jmodel.init_cache(B, S, dtype=jnp.bfloat16)
    jlayers = []
    for seg, c in zip(jax_T.plan_segments(jcfg), jcaches):
        if seg[0] == "plain":
            jlayers.append(c)
        else:
            for g in range(seg[2]):
                jlayers += [jax.tree.map(lambda a, _g=g: a[_g], c[j])
                            for j in range(len(seg[1]))]
    for c, cc, jc in zip(caches, conv, jlayers):
        assert set(c) == set(cc) == set(jc)
        for name in c:
            want = torch.float32 if name == "S" else torch.bfloat16
            assert c[name].dtype == cc[name].dtype == want, name
            assert str(jc[name].dtype) == str(want)[6:]
            assert tuple(c[name].shape) == tuple(cc[name].shape) == \
                jc[name].shape


# --------------------------------------------------------- the blocks
@pytest.mark.parametrize("S_", [1, 2, 7, 33])
def test_linear_scan_matches_a_loop_and_associative_scan(S_):
    rng = np.random.RandomState(S_)
    a = rng.uniform(0.5, 1.0, (2, S_, 5)).astype(np.float32)
    b = rng.randn(2, S_, 5).astype(np.float32)
    h = rglru_mod.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    ref, prev = [], np.zeros((2, 5), np.float32)
    for t in range(S_):
        prev = a[:, t] * prev + b[:, t]
        ref.append(prev)
    assert np.abs(h.numpy() - np.stack(ref, 1)).max() <= 1e-5
    _, jh = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    assert _err(jh, h) <= 1e-5


def test_rglru_with_initial_state_matches_jax():
    """``rglru_forward`` continuing from (h0, conv buffer): the initial
    state folded in as a virtual step 0, as the reference folds it."""
    cfg = get_config(RG).reduced()
    jp = jax_rglru.rglru_init(jax.random.PRNGKey(3), cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    h0 = rng.randn(2, cfg.lru_width).astype(np.float32)
    buf = rng.randn(2, cfg.conv_width - 1, cfg.lru_width).astype(np.float32)
    jout, (jh, jbuf) = jax_rglru.rglru_forward(jp, jnp.asarray(x),
                                               jnp.asarray(h0),
                                               jnp.asarray(buf))
    out, (h, nbuf) = rglru_mod.rglru_forward(p, torch.from_numpy(x),
                                             torch.from_numpy(h0),
                                             torch.from_numpy(buf))
    assert _err(jout, out) <= 1e-5 and _err(jh, h) <= 1e-5
    assert _err(jbuf, nbuf) == 0.0


def test_rwkv_time_mix_with_state_matches_jax():
    cfg = get_config(RWKV).reduced()
    jp = jax_rwkv.rwkv_init(jax.random.PRNGKey(5), cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.RandomState(6)
    H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    x = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    st = {"S": rng.randn(2, H, hs, hs).astype(np.float32),
          "shift": rng.randn(2, cfg.d_model).astype(np.float32)}
    jout, jst = jax_rwkv.time_mix_forward(
        jp, jnp.asarray(x), cfg, jax.tree.map(jnp.asarray, st))
    out, nst = rwkv_mod.time_mix_forward(
        p, torch.from_numpy(x), cfg,
        {k: torch.from_numpy(v) for k, v in st.items()})
    assert _err(jout, out) <= 1e-5
    assert _err(jst["S"], nst["S"]) <= 1e-5
    assert nst["S"].dtype == torch.float32
    jcm, jsh = jax_rwkv.channel_mix_forward(jp, jnp.asarray(x), cfg,
                                            jnp.asarray(st["shift"]))
    cm, sh = rwkv_mod.channel_mix_forward(p, torch.from_numpy(x), cfg,
                                          torch.from_numpy(st["shift"]))
    assert _err(jcm, cm) <= 1e-5 and _err(jsh, sh) == 0.0


# --------------------------------------------------------------- serving
# benchmarks/serve_bench.py's traffic and engine knobs
BENCH_SLOTS, BENCH_MAX_LEN, BENCH_PROMPT = 4, 24, 5
BENCH_RATE, BENCH_HORIZON, BENCH_SEED = 0.6, 30.0, 0
# BENCH_pr7.json's recurrentgemma-9b serve rows (both layouts alike)
BENCH_PR7 = {"continuous": dict(p99_first_token=16.1775, clock=59.0,
                                generated_tokens=161, decode_iterations=43,
                                prefill_groups=16, completed=18,
                                admission_stalls=0, p50_first_token=10.4702,
                                p99_per_token=1.5556, tokens_per_s=2.7288),
             "oneshot": dict(p99_first_token=37.1775, clock=80.0,
                             generated_tokens=161, decode_iterations=74,
                             prefill_groups=6, completed=18,
                             admission_stalls=0, p50_first_token=20.0809,
                             p99_per_token=1.0, tokens_per_s=2.0125)}
_STREAMS = {}


def _bench_requests(cls, vocab):
    arrivals = [0.0] + poisson_trace(BENCH_RATE, BENCH_HORIZON,
                                     seed=BENCH_SEED)
    assert arrivals[1:] == jax_poisson_trace(BENCH_RATE, BENCH_HORIZON,
                                             seed=BENCH_SEED)
    rng = np.random.RandomState(BENCH_SEED)
    prompts = rng.randint(1, vocab, size=(len(arrivals), BENCH_PROMPT))
    budgets = rng.choice([3, 6, 10, 14], size=len(arrivals))
    return [cls(rid=i, prompt=[int(t) for t in prompts[i]],
                max_new_tokens=int(budgets[i]), arrival=arrivals[i])
            for i in range(len(arrivals))]


@pytest.mark.parametrize("page_size", [0, 4])
@pytest.mark.parametrize("policy", ["oneshot", "continuous"])
def test_bench_pr7_recurrentgemma_rows(policy, page_size):
    """serve_bench.py's recurrentgemma-9b cells (its ``.reduced()``, 2
    rglru layers) through both engines: the row's virtual-clock columns,
    and the token stream equal to the JAX engine's and to every other
    cell's."""
    jcfg, jmodel, jparams, cfg, model, params = setup(RG, 2)
    kw = dict(slots=BENCH_SLOTS, max_len=BENCH_MAX_LEN, page_size=page_size,
              policy=policy)
    jreqs = _bench_requests(JaxRequest, cfg.vocab_size)
    JaxServeEngine(jmodel, jparams, JaxServeConfig(
        cache_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)).run(jreqs)
    reqs = _bench_requests(Request, cfg.vocab_size)
    m = ServeEngine(model, params, ServeConfig(**kw), device="cpu").run(reqs)
    for k, v in BENCH_PR7[policy].items():
        got = round(m[k], 4) if isinstance(m[k], float) else m[k]
        assert got == v, k
    assert m["paged"] == bool(page_size)
    outs = [r.output for r in reqs]
    assert outs == [r.output for r in jreqs]
    _STREAMS[(policy, page_size)] = outs
    assert all(s == outs for s in _STREAMS.values())


@pytest.mark.parametrize("arch,layers", MODELS)
@pytest.mark.parametrize("page_size", [0, 4])
def test_engine_streams_match_jax_with_wrapping_ring(arch, layers,
                                                     page_size):
    """Prompts of 10 > the window of 8 through both engines (3 requests
    on 2 slots, so a released slot is reused): greedy streams equal; the
    cache trees hold as many bytes as the JAX engine's."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch, layers)
    prompts = np.random.RandomState(7).randint(1, cfg.vocab_size, (3, 10))
    kw = dict(slots=2, max_len=20, page_size=page_size)

    def reqs(cls):
        return [cls(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=6 + 2 * i) for i in range(3)]

    jr, r = reqs(JaxRequest), reqs(Request)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(**kw))
    jeng.run(jr)
    eng = ServeEngine(model, params, ServeConfig(**kw), device="cpu")
    m = eng.run(r)
    assert m["completed"] == 3 and m["paged"] == bool(page_size)
    assert [x.output for x in r] == [x.output for x in jr]
    assert cache_bytes(eng.kv.store) == jax_cache_bytes(jeng.kv.store) > 0


@pytest.mark.parametrize("arch,layers", MODELS)
def test_admission_overwrites_every_leaf_of_a_slot(arch, layers):
    """A request served in a slot another request used first gives the
    tokens it gives in a fresh engine: no recurrent state, conv buffer,
    shift or ring row of the first request leaks into it."""
    jcfg, jmodel, jparams, cfg, model, params = setup(arch, layers)
    prompts = np.random.RandomState(8).randint(1, cfg.vocab_size, (2, 11))

    def req(i, rid):
        return Request(rid=rid, prompt=[int(t) for t in prompts[i]],
                       max_new_tokens=7)

    kw = dict(slots=1, max_len=18)
    alone = req(1, 0)
    ServeEngine(model, params, ServeConfig(**kw), device="cpu").run([alone])
    first, second = req(0, 0), req(1, 1)
    eng = ServeEngine(model, params, ServeConfig(**kw), device="cpu")
    eng.run([first, second])              # one slot: the second reuses it
    assert eng.prefill_groups == 2
    assert second.output == alone.output
    assert first.output != second.output


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_check_tp_supported_refuses_recurrent_stacks(arch):
    """``check_tp_supported`` raises the reference's ValueError for rglru
    and rwkv stacks, and ``decode_step(tp_axis=...)`` refuses them."""
    for cfg_, jcfg_ in ((get_config(arch), jax_get_config(arch)),
                        (get_config(arch).reduced(), jax_get_config(
                            arch).reduced())):
        with pytest.raises(ValueError) as got:
            check_tp_supported(cfg_, 2)
        with pytest.raises(ValueError) as want:
            jax_check_tp_supported(jcfg_, 2)
        assert str(got.value) == str(want.value)
        assert "attention-only" in str(got.value)
        with pytest.raises(ValueError):
            TPContext(cfg_, 2)
    _, _, _, cfg, model, params = setup(arch, dict(MODELS)[arch])
    with pytest.raises(ValueError, match="dense GQA"):
        T.decode_step(params, cfg, model.init_cache(1, 4), torch.zeros(
            1, 1, dtype=torch.long), torch.zeros(1, dtype=torch.long),
            tp_axis="model")


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_serve_launcher_smoke(arch, capsys):
    """``launch/serve.py --arch recurrentgemma-9b|rwkv6-7b --smoke`` on
    the CPU, contiguous and paged."""
    for pages in ("0", "4"):
        m = serve_launcher.main(["--arch", arch, "--smoke", "--device",
                                 "cpu", "--dtype", "f32", "--requests", "4",
                                 "--prompt-len", "10", "--max-new", "5",
                                 "--slots", "2", "--pages", pages])
        assert m["completed"] == 4 and m["generated_tokens"] == 20
    assert f"{arch}-smoke" in capsys.readouterr().out
