"""The port's training path against the JAX package's.

Reduced TinyLlama, JAX-initialised weights carried over by
``from_jax_params``, fp32 on the CPU (both packages take their plain
attention and plain 1-bit paths here):

* the synthetic token stream bit for bit; cross-entropy, ``loss_fn`` and
  its gradients within 1e-5;
* ``leaf_layout``: the JAX package's leaves (names, shapes, order,
  values);
* the exact schedules and the engine against the JAX ones run on 8
  virtual devices in one ``run_multidevice`` subprocess: ring, butterfly
  and tree sums bit for bit (same hops, same order), psum and
  fully-connected within 1e-6; per-step losses within 1e-4, parameters
  after 2 steps within 1e-6 for ``none@8`` and 1e-4 for ``onebit@8``
  (a sign flip at |c_in| near 1e-7 moves one reconstruction);
* ``CommPlan`` buckets, issue order and timeline equal to JAX's;
* the port alone reproduces the deterministic columns of the
  ``BENCH_pr10.json`` data_parallel rows: wire bytes and ``n_buckets``
  exactly, ``loss_last`` within 1e-3 (the row is rounded to 1e-4).  Those
  rows were recorded with jax < 0.5, whose ``PRNGKey(0)`` stream was the
  non-partitionable threefry; the test draws the init that way.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_multidevice
from repro.comm.plan import CommPlan as JaxCommPlan
from repro.configs import get_config as jax_get_config
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import make_lm_batches as jax_make_lm_batches
from repro.models import build_model as jax_build_model
from repro.models.common import cross_entropy as jax_cross_entropy
from repro_torch.comm.plan import CommPlan
from repro_torch.comm.transport import SCHEDULES, pad_for_schedule
from repro_torch.configs import get_config
from repro_torch.core.compression import Compressor
from repro_torch.core.tree import LeafLayout
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.models.common import cross_entropy
from repro_torch.models.transformer import from_jax_params
from repro_torch.train import Strategy, Trainer, registered_cells
from repro_torch.train import value_and_grad

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("bsp/allreduce/none@8", "bsp/allreduce/onebit@8")
PS_SPECS = ("bsp/ps/dgc:0.05@8",)     # modeled, the PS path
BENCH_RECIPE = dict(lr=0.01, bucket_mb=0.25)      # data_parallel_bench.py
_CACHE = {}


def setup():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jmodel, model = jax_build_model(jcfg), build_model(cfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        params = from_jax_params(cfg, jax.tree.map(np.array, jparams))
        _CACHE.update(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                      jparams=jparams, params=params)
    return _CACHE


def _keystr(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _grad_fn(model):
    return value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))


def _batches():
    cfg = setup()["cfg"]
    return make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, batch_size=2))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("step,worker", [(0, 0), (3, 5), (17, 2)])
def test_data_stream_matches_jax(step, worker):
    kw = dict(vocab_size=512, seq_len=16, batch_size=3, seed=1)
    ref = jax_make_lm_batches(JaxLMDataConfig(**kw))(step, worker)
    port = make_lm_batches(LMDataConfig(**kw))(step, worker)
    for k in ("tokens", "labels"):
        assert port[k].dtype == torch.int32
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))


# ------------------------------------------------------------------ loss
def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((2, 5, 12)).astype(np.float32)
    labels = rng.randint(0, 10, size=(2, 5))
    mask = (rng.random_sample((2, 5)) > 0.4).astype(np.float32)
    for m, vocab in ((None, None), (mask, 10), (np.zeros_like(mask), 10)):
        ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m),
                                vocab_size=vocab)
        port = cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m),
                             vocab_size=vocab)
        assert abs(port.item() - float(ref)) <= 1e-6


def test_leaf_layout_is_jax_leaves():
    s = setup()
    layout = s["model"].leaf_layout(s["params"])
    flat = jax.tree_util.tree_flatten_with_path(s["jparams"])[0]
    assert list(layout.names) == [_keystr(p) for p, _ in flat]
    assert layout.shapes(s["params"]) == [tuple(x.shape) for _, x in flat]
    for leaf, (_, ref) in zip(layout.leaves(s["params"]), flat):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))


def test_loss_and_grads_match_jax():
    s = setup()
    jb = jax_make_lm_batches(JaxLMDataConfig(vocab_size=512, seq_len=16,
                                             batch_size=2))(0, 0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: s["jmodel"].loss_fn(p, jb, compute_dtype=jnp.float32),
        has_aux=True)(s["jparams"])
    loss, grads = _grad_fn(s["model"])(s["params"], _batches()(0, 0))
    assert abs(loss.item() - float(jloss)) <= 1e-5
    leaves = list(s["model"].leaf_layout(s["params"]).leaves(grads))
    for a, b in zip(leaves, jax.tree.leaves(jgrads)):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5


# ------------------------------------------------------------ comm plan
@pytest.mark.parametrize("bucket_mb,order", [(0.25, "tictac"), (4.0, "tictac"),
                                              (0.01, "random"),
                                              (0.05, "layer")])
def test_comm_plan_matches_jax(bucket_mb, order):
    s = setup()
    shapes = s["model"].leaf_layout(s["params"]).shapes(s["params"])
    kw = dict(n=8, bucket_mb=bucket_mb, order=order, seed=3)
    ref = JaxCommPlan.plan(s["jparams"], axis="workers", **kw)
    plan = CommPlan.plan(shapes, **kw)
    assert plan.buckets == ref.buckets and plan.order == ref.order
    assert plan.modeled_timeline() == ref.modeled_timeline()
    assert [plan.bucket_len(b) for b in range(len(plan.buckets))] == \
        [ref.bucket_len(b) for b in range(len(ref.buckets))]


def test_reduce_grads_is_the_workers_mean():
    rng = np.random.RandomState(0)
    shapes = [(3, 5), (7,), (2, 4, 4)]
    grads = [[torch.from_numpy(rng.standard_normal(s)) for s in shapes]
             for _ in range(4)]
    want = [sum(g[i] for g in grads) / 4 for i in range(len(shapes))]
    plan = CommPlan.plan(shapes, n=4, bucket_mb=1e-4)
    assert len(plan.buckets) > 1
    out = plan.reduce_grads([list(g) for g in grads])
    for a, b in zip(out, want):
        assert a.shape == b.shape and torch.allclose(a, b.float(), atol=1e-6)
    assert pad_for_schedule(10, 4) == 12


# ------------------------------------------------ against the JAX engine
_JAX_CHILD = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm.transport import SCHEDULES
from repro.configs import get_config
from repro.core.collectives import shard_map
from repro.data import LMDataConfig, make_lm_batches
from repro.models import build_model
from repro.train import Strategy

out = {}
x = np.load(%(x)r)
mesh = Mesh(np.array(jax.devices()[:8]), ("w",))
for name, fn in SCHEDULES.items():
    f = shard_map(lambda v, fn=fn: fn(v[0], "w")[None], mesh=mesh,
                  in_specs=P("w"), out_specs=P("w"), check_vma=False)
    out["sched_" + name] = np.asarray(jax.jit(f)(x))
cfg = get_config("tinyllama-1.1b").reduced()
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, batch_size=2))
def grad_fn(p, batch):
    (loss, _), g = jax.value_and_grad(
        lambda pp: model.loss_fn(pp, batch, compute_dtype=jnp.float32),
        has_aux=True)(p)
    return loss, g
for spec in %(specs)r:
    strat = Strategy.parse(spec, lr=0.01, bucket_mb=0.25, backend="device")
    p, hist, wire = strat.build(grad_fn).run(params, batches, 2)
    out[spec + "/losses"] = np.array([h["loss"] for h in hist])
    out[spec + "/wire"] = np.array(wire)
    for i, leaf in enumerate(jax.tree.leaves(p)):
        out[spec + "/p%%d" %% i] = np.asarray(leaf)
np.savez(%(out)r, **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_engine")
    x = np.random.RandomState(0).standard_normal((8, 1003)).astype(
        np.float32)
    np.save(d / "x.npy", x)
    run_multidevice(_JAX_CHILD % dict(x=str(d / "x.npy"),
                                      specs=SPECS + PS_SPECS,
                                      out=str(d / "out.npz")), n_devices=8)
    return x, dict(np.load(d / "out.npz"))


def test_schedules_match_jax(jax_runs):
    x, ref = jax_runs
    for name, fn in SCHEDULES.items():
        port = fn(torch.from_numpy(x)).numpy()
        if name in ("ring", "butterfly", "tree"):
            np.testing.assert_array_equal(port, ref["sched_" + name])
        else:
            np.testing.assert_allclose(port, ref["sched_" + name],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", SPECS + PS_SPECS)
def test_engine_matches_jax_engine(jax_runs, spec):
    _, ref = jax_runs
    s = setup()
    strat = Strategy.parse(spec, **BENCH_RECIPE)
    engine = strat.build(_grad_fn(s["model"]),
                         layout=s["model"].leaf_layout(s["params"]),
                         device="cpu")
    params, hist, wire = engine.run(s["params"], _batches(), 2)
    losses = np.array([h["loss"] for h in hist])
    assert np.abs(losses - ref[spec + "/losses"]).max() <= 1e-4
    assert wire == int(ref[spec + "/wire"])
    tol = 1e-6 if spec.endswith("none@8") else 1e-4
    leaves = s["model"].leaf_layout(params).leaves(params)
    for i, leaf in enumerate(leaves):
        assert np.abs(leaf.numpy() - ref[f"{spec}/p{i}"]).max() <= tol, i


# ------------------------------------------------------- BENCH_pr10 rows
def _bench_rows():
    rows = {}
    with open(os.path.join(ROOT, "BENCH_pr10.json")) as f:
        for line in f:
            row = json.loads(line)
            if row.get("bench") == "data_parallel":
                rows[row["strategy"]] = row
    return rows


def _bench_params():
    """The JAX init the BENCH_pr10 rows were recorded with: jax < 0.5
    drew ``PRNGKey(0)`` through the non-partitionable threefry stream."""
    if "bench_params" not in _CACHE:
        s = setup()
        with jax.threefry_partitionable(False):
            jparams = s["jmodel"].init(jax.random.PRNGKey(0))
        _CACHE["bench_params"] = from_jax_params(
            s["cfg"], jax.tree.map(np.array, jparams))
    return _CACHE["bench_params"]


@pytest.mark.parametrize("spec", SPECS + ("bsp/allreduce/dgc:0.05@8",))
def test_engine_reproduces_bench_pr10(spec):
    row = _bench_rows()[spec]
    model, params = setup()["model"], _bench_params()
    trainer = Trainer(Strategy.parse(spec, **BENCH_RECIPE), device="cpu")
    _, hist, mets = trainer.fit(_grad_fn(model), params, _batches(), 2,
                                layout=model.leaf_layout(params))
    engine = Strategy.parse(spec, **BENCH_RECIPE).build(
        _grad_fn(model), layout=model.leaf_layout(params), device="cpu")
    assert mets["wire_bytes"] // 2 == row["wire_bytes_per_step"]
    assert engine.inner.wire_bytes_per_step(params) == \
        row["wire_bytes_per_step"]
    tl = engine.inner.modeled_timeline(params)
    assert tl["n_buckets"] == row["n_buckets"]
    assert round(tl["no_overlap_s"] * 1e6, 2) == row["modeled_no_overlap_us"]
    assert round(tl["overlap_s"] * 1e6, 2) == row["modeled_tictac_overlap_us"]
    assert len(hist) == row["events"]
    assert abs(hist[-1]["loss"] - row["loss_last"]) <= 1e-3


def test_engine_does_not_modify_its_inputs():
    s = setup()
    before = [t.clone() for t in LeafLayout.of_tree(s["params"]).leaves(
        s["params"])]
    Strategy.parse("bsp/allreduce/onebit@2", lr=0.5).build(
        _grad_fn(s["model"]), layout=s["model"].leaf_layout(s["params"]),
        device="cpu").run(s["params"], _batches(), 1)
    after = LeafLayout.of_tree(s["params"]).leaves(s["params"])
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ------------------------------------------------------------- strategy
def test_strategy_parse_and_cells():
    strat = Strategy.parse("bsp/tree/onebit@4", lr=0.01)
    assert (strat.arch, strat.topology, strat.workers) == ("allreduce",
                                                          "tree", 4)
    assert strat.spec() == "bsp/tree/onebit@4"
    assert Strategy.parse(strat.spec(), lr=0.01) == strat
    assert strat.compressor == Compressor("onebit")
    assert Strategy.parse("bsp/ring/onebit@2",
                          kernel_backend="ref").compressor.backend == "ref"
    cells = registered_cells()
    assert {c.compression for c in cells if c[:2] == ("bsp", "allreduce")
            and c.backend == "device"} == {"none", "onebit", "terngrad",
                                           "qsgd", "dgc"}
    # the whole matrix runs (tests/test_torch_sync.py)
    assert len(cells) == 33


@pytest.mark.parametrize("spec,kw", [
    # ssp / asp / sma, arch="ps" and the simulator run
    # (tests/test_torch_sync.py), and so do backup workers and straggler
    # detection on either backend (tests/test_torch_elastic.py), and the
    # hybrid meshes build the HybridEngine (tests/test_torch_hybrid.py)
    ("bsp+backup:1/allreduce/none@4", {}), ("bsp+backup:1/ps/onebit@4", {}),
    ("bsp+detect/allreduce/none@4", {}),
    ("bsp+detect/ps/none@4", {"backend": "sim"}),
    ("bsp+backup:2/ring/dgc:0.05@4", {"wire": "measured"}),
    ("bsp+detect/allreduce/terngrad@4", {"backend": "sim"}),
    ("bsp/allreduce/qsgd@4", {"backup": 1}),
    ("bsp/allreduce/none@4", {"backup": 1, "backend": "sim"}),
    ("bsp/ps/none@4:d4.z3.adamw", {}),
    ("bsp/ring/onebit@8:d2.t2.s2", {})])
def test_unported_cells_raise(spec, kw):
    if ":d" in spec:
        from repro_torch.parallel import HybridEngine, make_tiny_transformer
        strat = Strategy.parse(spec, **kw)
        eng = strat.build(make_tiny_transformer(2, device="cpu")[1],
                          device="cpu")
        assert isinstance(eng.inner, HybridEngine)
        assert eng.inner.cfg.mesh == strat.mesh_spec
        return
    strat = Strategy.parse(spec, **kw)
    eng = strat.build(lambda p, b: None, device="cpu")
    assert eng.backend == strat.resolve_backend()
    assert eng.inner.cfg.backup == strat.backup
    assert (eng.inner.detector is not None) == strat.detect
