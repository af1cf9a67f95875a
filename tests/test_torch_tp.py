"""Tensor-parallel decode of the port (``serve/tp.py``) against the JAX
package's.

Reduced TinyLlama (4 query heads, 4 KV heads) in fp32 on the CPU, the
JAX weights carried over by ``from_jax_params``.  One subprocess with 2
virtual JAX devices gives the reference: ``decode_step(tp_axis="model")``
under ``shard_map`` over the ``TPContext`` mesh, teacher-forced from a
prefill, and the JAX ``ServeEngine`` at ``tp=2`` on
``benchmarks/serve_bench.py``'s traffic.

Tolerances: tp=2 decode logits within 1e-5 of the JAX shard_map run and
of the port's tp=1 run (only the order of the row-parallel sums differs:
measured 3e-6 at this size, against logits up to 3.4); greedy token streams and the virtual-clock
columns exactly equal.

One ``launch.dist.spawn`` of 2 Gloo ranks runs the same decode with one
tensor rank per process (``ServeEngine(group=)``, ``TPContext(axis=)``;
the rank functions are ``tests/torch_dist_ranks.py``'s): contiguous and
paged engines and the serve_bench traffic, each rank's tokens and every
decode iteration's logits bit for bit the logical tp=2 engine's, at half
its cache bytes; the teacher-forced logits bit for bit the logical
``decode_step``'s; the launcher's metrics lines the logical ``--tp 2``
run's.
"""
import json
import re

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.request import Request as JaxRequest
from repro.serve.tp import param_specs as jax_param_specs
from repro_torch.configs import get_config
from repro_torch.core.tree import get_path
from repro_torch.launch.dist import spawn
from repro_torch.launch.serve import main as launch_serve
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.serve.autoscale import poisson_trace
from repro_torch.serve.cache import make_kv_store, shard_kv
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request
from repro_torch.serve.tp import (TPContext, check_tp_supported, param_specs,
                                  store_specs)

torch.set_num_threads(2)

TOL = 1e-5
B, S0, MAX_LEN, STEPS = 2, 6, 16, 5
# benchmarks/serve_bench.py's traffic, and BENCH_pr7.json's tp=2 row
BENCH = dict(slots=4, max_len=24, prompt=5, rate=0.6, horizon=30.0, seed=0,
             budgets=(3, 6, 10, 14))
BENCH_PR7_TP2 = dict(clock=59.0, decode_iterations=43, prefill_groups=16,
                     p99_first_token=16.1775, generated_tokens=161,
                     completed=18, page_size=4, paged=True, tp=2)
_CACHE = {}

_CHILD = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core.collectives import shard_map
from repro.models import build_model
from repro.models import transformer as T
from repro.serve.autoscale import poisson_trace
from repro.serve.engine import ServeConfig, ServeEngine
from repro.serve.request import Request
from repro.serve.tp import TPContext, param_specs, store_specs

cfg = get_config("tinyllama-1.1b").reduced()
params = build_model(cfg).init(jax.random.PRNGKey(0))
tokens = np.random.RandomState(3).randint(1, cfg.vocab_size,
                                          size=(%(B)d, %(S0)d + %(STEPS)d))
f32 = dict(compute_dtype=jnp.float32)
_, st = T.prefill(params, cfg, jnp.asarray(tokens[:, :%(S0)d]), **f32)
caches = T.cache_from_prefill(cfg, st, %(MAX_LEN)d, jnp.float32)
ctx = TPContext(cfg, 2)
ss = store_specs(caches)
step = jax.jit(shard_map(
    lambda p, c, tok, pos: T.decode_step(p, ctx.cfg_local, c, tok, pos,
                                         tp_axis="model", **f32),
    mesh=ctx.mesh, in_specs=(param_specs(params), ss, P(), P()),
    out_specs=(P(), ss), check_vma=False))
logits = []
for s in range(%(STEPS)d):
    lg, caches = step(params, caches,
                      jnp.asarray(tokens[:, %(S0)d + s:%(S0)d + s + 1]),
                      jnp.int32(%(S0)d + s))
    logits.append(np.asarray(lg[:, 0]).tolist())

b = %(BENCH)s
arrivals = [0.0] + poisson_trace(b["rate"], b["horizon"], seed=b["seed"])
rng = np.random.RandomState(b["seed"])
prompts = rng.randint(1, cfg.vocab_size, size=(len(arrivals), b["prompt"]))
budgets = rng.choice(b["budgets"], size=len(arrivals))
reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                max_new_tokens=int(budgets[i]), arrival=arrivals[i])
        for i in range(len(arrivals))]
m = ServeEngine(build_model(cfg), params, ServeConfig(
    slots=b["slots"], max_len=b["max_len"], page_size=4, tp=2,
    cache_dtype=jnp.float32, compute_dtype=jnp.float32)).run(reqs)
m.pop("wall_s")
print("TP-REF " + json.dumps({"logits": logits, "metrics": m,
                              "outputs": [r.output for r in reqs]}))
"""


def setup():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        _CACHE.update(
            jcfg=jcfg, cfg=cfg, jmodel=jax_build_model(jcfg),
            jparams=jparams, model=build_model(cfg),
            params=T.from_jax_params(cfg, jax.tree.map(np.array, jparams)))
    return _CACHE


@pytest.fixture(scope="module")
def reference():
    """``_CHILD`` on 2 virtual devices: (logits [STEPS, B, V], its
    engine's metrics and outputs)."""
    from conftest import run_multidevice
    out = run_multidevice(_CHILD % dict(B=B, S0=S0, STEPS=STEPS,
                                        MAX_LEN=MAX_LEN, BENCH=repr(BENCH)),
                          n_devices=2)
    line = next(ln for ln in out.splitlines() if ln.startswith("TP-REF "))
    ref = json.loads(line[len("TP-REF "):])
    return np.asarray(ref.pop("logits"), np.float32), ref


def _bench_requests(vocab):
    b = BENCH
    arrivals = [0.0] + poisson_trace(b["rate"], b["horizon"], seed=b["seed"])
    rng = np.random.RandomState(b["seed"])
    prompts = rng.randint(1, vocab, size=(len(arrivals), b["prompt"]))
    budgets = rng.choice(b["budgets"], size=len(arrivals))
    return [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=int(budgets[i]), arrival=arrivals[i])
            for i in range(len(arrivals))]


def _port_tp_logits(tp):
    """Teacher-forced decode logits [STEPS, B, V] through the port's
    ``decode_step`` at ``tp`` ranks (1: the ordinary step)."""
    s = setup()
    cfg, params = s["cfg"], s["params"]
    tokens = np.random.RandomState(3).randint(1, cfg.vocab_size,
                                              size=(B, S0 + STEPS))
    tokens = torch.from_numpy(tokens)
    f32 = dict(compute_dtype=torch.float32)
    _, st = T.prefill(params, cfg, tokens[:, :S0], **f32)
    caches = T.cache_from_prefill(cfg, st, MAX_LEN, torch.float32)
    kw = {}
    if tp > 1:
        ctx = TPContext(cfg, tp)
        params, cfg = ctx.shard_params(params), ctx.cfg_local
        caches, kw = ctx.shard_cache(caches), dict(tp_axis="model")
    out = []
    for step in range(STEPS):
        lg, caches = T.decode_step(params, cfg, caches,
                                   tokens[:, S0 + step:S0 + step + 1],
                                   torch.full((B,), S0 + step), **f32, **kw)
        out.append(lg[:, 0])
    return torch.stack(out).numpy()


def test_tp2_decode_logits_match_jax_shard_map(reference):
    jlogits, _ = reference
    tp2, tp1 = _port_tp_logits(2), _port_tp_logits(1)
    assert np.abs(tp2 - jlogits).max() <= TOL
    assert np.abs(tp2 - tp1).max() <= TOL


def test_tp2_engine_matches_jax_engine_and_bench_pr7(reference):
    _, jref = reference
    s = setup()
    out = {}
    for tp in (1, 2):
        reqs = _bench_requests(s["cfg"].vocab_size)
        m = ServeEngine(s["model"], s["params"], ServeConfig(
            slots=BENCH["slots"], max_len=BENCH["max_len"], page_size=4,
            tp=tp), device="cpu").run(reqs)
        out[tp] = (m, [r.output for r in reqs])
    m2, outs2 = out[2]
    assert outs2 == jref["outputs"] == out[1][1]
    for key, want in BENCH_PR7_TP2.items():
        got = round(m2[key], 4) if isinstance(m2[key], float) else m2[key]
        assert got == want, key
        assert jref["metrics"][key] == m2[key], key


@pytest.mark.parametrize("page_size", [0, 4])
def test_tp2_stream_equals_tp1_and_jax(page_size):
    """tests/test_serving.py's TP check on the port, both cache layouts,
    and the JAX single-device engine's stream."""
    s = setup()
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, s["cfg"].vocab_size, size=(3, 5))

    def reqs(cls):
        return [cls(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=6) for i in range(3)]

    jreqs = reqs(JaxRequest)
    JaxServeEngine(s["jmodel"], s["jparams"], JaxServeConfig(
        slots=2, max_len=16, page_size=page_size)).run(jreqs)
    streams = {}
    for tp in (1, 2):
        rs = reqs(Request)
        ServeEngine(s["model"], s["params"], ServeConfig(
            slots=2, max_len=16, page_size=page_size, tp=tp),
            device="cpu").run(rs)
        streams[tp] = [r.output for r in rs]
    assert streams[2] == streams[1] == [r.output for r in jreqs]


def test_tp_rejects_unsupported_archs():
    with pytest.raises(ValueError, match="MLA"):
        check_tp_supported(get_config("deepseek-v2-lite-16b").reduced(), 2)
    with pytest.raises(ValueError, match="MoE"):
        check_tp_supported(get_config("kimi-k2-1t-a32b").reduced(), 2)
    with pytest.raises(ValueError, match="use_bias"):
        check_tp_supported(get_config("qwen2-vl-7b").reduced(), 2)
    with pytest.raises(ValueError, match="attention-only"):
        check_tp_supported(get_config("rwkv6-7b").reduced(), 2)
    with pytest.raises(ValueError, match="must divide"):
        check_tp_supported(get_config("tinyllama-1.1b").reduced(), 3)
    with pytest.raises(ValueError, match="MLA"):
        ServeEngine(*_reduced("deepseek-v2-lite-16b"), ServeConfig(tp=2),
                    device="cpu")


def _reduced(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    return model, model.init(seed=0)


def test_decode_step_tp_axis_refuses_moe():
    model, params = _reduced("kimi-k2-1t-a32b")
    caches = model.init_cache(1, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="dense GQA"):
        model.decode_step(params, caches, torch.zeros(1, 1, dtype=torch.long),
                          torch.zeros(1, dtype=torch.long), tp_axis="model")


def test_param_specs_match_jax():
    """The port's per-leaf specs equal the JAX package's PartitionSpecs,
    leaf by leaf over the reference's layout (a layer's spec, with the
    scan segment's leading group axis)."""
    s = setup()
    layout = s["model"].leaf_layout(s["params"])
    specs = param_specs(s["params"])
    jspecs = jax.tree.leaves(jax_param_specs(s["jparams"]),
                             is_leaf=lambda x: isinstance(
                                 x, jax.sharding.PartitionSpec))
    assert len(jspecs) == len(layout.parts)
    for name, parts, jspec in zip(layout.names, layout.parts, jspecs):
        spec = get_path(specs, parts[0])
        if len(parts) > 1:
            spec = (None,) + spec                    # the stacked group axis
        jt = tuple(jspec) + (None,) * (len(spec) - len(tuple(jspec)))
        assert spec == jt, name


def test_shard_params_and_store_are_rank_major():
    s = setup()
    ctx = TPContext(s["cfg"], 2)
    sp = ctx.shard_params(s["params"])
    layer, slayer = s["params"]["layers"][0], sp["layers"][0]
    wq, wo = layer["mixer"]["wq"]["w"], layer["mixer"]["wo"]["w"]
    assert torch.equal(slayer["mixer"]["wq"]["w"][1], wq.chunk(2, 1)[1])
    assert torch.equal(slayer["mixer"]["wo"]["w"][0], wo.chunk(2, 0)[0])
    assert slayer["ln1"]["scale"] is layer["ln1"]["scale"]   # replicated
    assert sp["embed"] is s["params"]["embed"]
    kv = make_kv_store(s["model"], 3, 16, page_size=4, tp=2)
    pool = kv.store[0]["k"]
    cfg = s["cfg"]
    assert pool.shape == (2, kv.allocator.num_pages, 4,
                          cfg.num_kv_heads // 2, cfg.head_dim)
    assert store_specs(kv.store)[0]["k"] == (None, None, None, "model",
                                             None)
    t = torch.randn(3, 5, cfg.num_kv_heads, cfg.head_dim)
    r = shard_kv(t, 2)
    assert r[1].is_contiguous() and torch.equal(r[1], t[:, :, 2:])
    g = kv.gather(kv.store, kv.block_tables_device())[0]["k"]
    assert g.shape == (2, 3, 16, cfg.num_kv_heads // 2, cfg.head_dim)
    assert g[1].is_contiguous()


def test_launcher_tp2_on_cpu(capsys):
    m = launch_serve(["--smoke", "--device", "cpu", "--dtype", "f32",
                      "--requests", "3", "--pages", "4", "--max-new", "3",
                      "--tp", "2"])
    assert m["tp"] == 2 and m["completed"] == 3
    assert "tp=2" in capsys.readouterr().out


# ------------------------------------------- one tensor rank per process
_STREAM = dict(requests=3, prompt=5, new=6, slots=2, max_len=16)
LAUNCH_ARGV = ["--smoke", "--device", "cpu", "--dtype", "f32", "--requests",
               "3", "--pages", "4", "--max-new", "3", "--tp", "2"]


def _stream_traffic(vocab):
    """test_tp2_stream_equals_tp1_and_jax's requests, as the rank
    functions take them."""
    prompts = np.random.RandomState(0).randint(
        1, vocab, size=(_STREAM["requests"], _STREAM["prompt"]))
    return [([int(t) for t in p], _STREAM["new"], 0.0) for p in prompts]


def _tp_cells():
    vocab = setup()["cfg"].vocab_size
    st = _stream_traffic(vocab)
    bench = [(r.prompt, r.max_new_tokens, r.arrival)
             for r in _bench_requests(vocab)]
    return {"contiguous": (st, 0, _STREAM["slots"], _STREAM["max_len"]),
            "paged": (st, 4, _STREAM["slots"], _STREAM["max_len"]),
            "bench": (bench, 4, BENCH["slots"], BENCH["max_len"])}


def _forced_args():
    tokens = np.random.RandomState(3).randint(
        1, setup()["cfg"].vocab_size, size=(B, S0 + STEPS))
    return torch.from_numpy(tokens), S0, STEPS, MAX_LEN


@pytest.fixture(scope="module")
def tp_ranks():
    return spawn(R.tp_rank, R.TP_DEGREE, "gloo", device="cpu",
                 args=(setup()["params"], _tp_cells(), _forced_args(),
                       LAUNCH_ARGV), timeout_s=240)


_LOGICAL = {}


def _logical(name):
    if name not in _LOGICAL:
        _LOGICAL[name] = R.tp_serve(setup()["params"], *_tp_cells()[name])
    return _LOGICAL[name]


@pytest.mark.parametrize("name", ["contiguous", "paged", "bench"])
def test_tp_over_ranks_matches_logical_engine(tp_ranks, name):
    outs, logits, m, cache = _logical(name)
    assert len(logits) == m["decode_iterations"] > 0
    for rank, r in enumerate(tp_ranks):
        got_outs, got_logits, got_m, got_cache = r["cells"][name]
        assert got_outs == outs
        assert len(got_logits) == len(logits)
        assert all(torch.equal(a, b) for a, b in zip(got_logits, logits))
        # the logical engine's metrics, plus what each rank holds
        assert {k: v for k, v in got_m.items()
                if not k.startswith("rank_")} == m
        assert got_cache * R.TP_DEGREE == cache
        assert got_m["rank_cache_bytes"] == [cache // R.TP_DEGREE] * 2
        assert len(set(got_m["rank_param_bytes"])) == 1


def test_tp_over_ranks_streams_match_jax(reference, tp_ranks):
    """The ranks' tokens against the JAX engine: its tp=2 engine on the
    serve_bench traffic (and BENCH_pr7.json's columns), its single-device
    engine on the short stream (both cache layouts)."""
    _, jref = reference
    s = setup()
    for r in tp_ranks:
        outs, _, m, _ = r["cells"]["bench"]
        assert outs == jref["outputs"]
        for key, want in BENCH_PR7_TP2.items():
            got = round(m[key], 4) if isinstance(m[key], float) else m[key]
            assert got == want, key
    for page_size, name in ((0, "contiguous"), (4, "paged")):
        jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=n)
                 for i, (p, n, _) in enumerate(
                     _stream_traffic(s["cfg"].vocab_size))]
        JaxServeEngine(s["jmodel"], s["jparams"], JaxServeConfig(
            slots=_STREAM["slots"], max_len=_STREAM["max_len"],
            page_size=page_size)).run(jreqs)
        for r in tp_ranks:
            assert r["cells"][name][0] == [q.output for q in jreqs]


def test_tp_over_ranks_forced_logits(reference, tp_ranks):
    jlogits, _ = reference
    logical = R.tp_forced(setup()["params"], *_forced_args())
    assert torch.equal(logical, torch.from_numpy(_port_tp_logits(2)))
    for r in tp_ranks:
        assert torch.equal(r["forced"], logical)
    assert np.abs(logical.numpy() - jlogits).max() <= TOL


def _lines(text):
    """The launcher's printed lines with the wall seconds taken out."""
    return [re.sub(r"[0-9.]+s wall", "s wall", ln)
            for ln in text.splitlines()]


def test_launcher_tp2_over_ranks_prints_logical_lines(tp_ranks):
    text, m = R.tp_launcher(LAUNCH_ARGV)
    got, got_m = tp_ranks[0]["launcher"]
    lines = _lines(text)
    assert _lines(got)[:len(lines)] == lines
    assert _lines(got)[len(lines)].startswith("tp ranks (gloo): cache")
    assert {k: v for k, v in got_m.items() if k != "wall_s"
            and not k.startswith("rank_")} == \
        {k: v for k, v in m.items() if k != "wall_s"}
    # rank 1 serves the same traffic and prints nothing
    assert tp_ranks[1]["launcher"][0] == ""
    assert tp_ranks[1]["launcher"][1]["generated_tokens"] == \
        m["generated_tokens"]


def test_group_size_must_equal_tp(tp_ranks):
    for r in tp_ranks:
        assert "tp must equal the group's size" in r["refusal"]


@pytest.mark.parametrize("env,extra,match", [
    ({"RANK": "0", "WORLD_SIZE": "3"}, ["--dist-backend", "gloo"],
     "--tp 2 under a world of 3"),
    ({"RANK": "0", "WORLD_SIZE": "2"}, [], "pass --dist-backend"),
    ({}, ["--dist-backend", "gloo"], "needs torch.distributed.run")])
def test_launcher_refuses_a_mismatched_world(monkeypatch, env, extra, match):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=re.escape(match)):
        launch_serve(LAUNCH_ARGV + extra)
