"""The port's strategy matrix against the JAX package's: the SSP/ASP
firing schedule, the parameter-server functions, the simulator, and the
device engine's ssp, asp, sma and ``arch="ps"`` paths.

* ``firing_schedule`` equals the reference's over drawn periods, clocks
  and bounds (hypothesis).
* ``psum_scatter`` and ``core.parameter_server`` against JAX on 4 of 8
  virtual devices: sums within 1e-6 of the largest, shards, pulls and the
  SGD step of ``make_ps_step`` likewise.
* ``SimSyncEngine`` against the JAX ``SimSyncEngine`` on reduced TinyLlama
  (JAX-initialised weights, 4 workers, 2 steps) for bsp, ssp, asp with
  ``none`` and ``onebit`` and sma with ``none``: the event sequence
  (worker, staleness) exact, losses within 1e-4 per event, wire bytes
  exact.
* The port's ``DeviceEngine`` against the JAX ``DeviceEngine`` run on 8
  virtual devices (one ``run_multidevice`` subprocess) for
  ``ssp:3/ps/onebit@8``, ``asp/ps/none@8``, ``sma/allreduce/none@8`` and
  ``bsp/ps/onebit@8``: the same, plus the parameters after 2 steps within
  1e-4.  (``bsp/ps/dgc:0.05@8`` is held against JAX in
  tests/test_torch_train.py and the measured ``bsp/ps/onebit@8`` in
  tests/test_torch_comm.py, whose subprocesses run those engines.)
* The ssp, asp and ps rows of ``BENCH_pr10.json`` on the port alone:
  ``loss_last`` within 1e-3, wire bytes and event counts exact, drawn
  with the non-partitionable threefry as tests/test_torch_train.py does.
* ``registered_cells()`` equals the reference's 33 cells, and each runs
  2 steps on a small regression with 2 workers (the port's mirror of
  ``make strategies``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from conftest import run_multidevice
from repro.configs import get_config as jax_get_config
from repro.core.compression import Compressor as JaxCompressor
from repro.core.sync import SimSyncEngine as JaxSimSyncEngine
from repro.core.sync import SyncConfig as JaxSyncConfig
from repro.core.sync import firing_schedule as jax_firing_schedule
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import make_lm_batches as jax_make_lm_batches
from repro.models import build_model as jax_build_model
from repro.train.strategy import registered_cells as jax_registered_cells
from repro_torch.configs import get_config
from repro_torch.core import parameter_server as PS
from repro_torch.core.collectives import psum_scatter
from repro_torch.core.sync import firing_schedule
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params
from repro_torch.train import Strategy, Trainer, registered_cells
from repro_torch.train import value_and_grad

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = dict(lr=0.01, bucket_mb=0.25)          # data_parallel_bench.py
ENGINE_SPECS = ("ssp:3/ps/onebit@8", "asp/ps/none@8",
                "sma/allreduce/none@8", "bsp/ps/onebit@8")
_CACHE = {}


def _reduced():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jmodel, model = jax_build_model(jcfg), build_model(cfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        params = from_jax_params(cfg, jax.tree.map(np.array, jparams))
        _CACHE.update(jmodel=jmodel, model=model, jparams=jparams,
                      params=params, cfg=cfg)
    return _CACHE


def _grad_fn(model):
    return value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))


def _batches():
    return make_lm_batches(LMDataConfig(vocab_size=_reduced()["cfg"]
                                        .vocab_size, seq_len=16,
                                        batch_size=2))


def _events(hist):
    return [(h.get("worker", -1), h["max_staleness"]) for h in hist]


# ------------------------------------------------------- firing schedule
@settings(max_examples=200, deadline=None)
@given(hst.lists(hst.integers(1, 5), min_size=1, max_size=8).flatmap(
    lambda periods: hst.tuples(
        hst.just(tuple(periods)),
        hst.lists(hst.integers(0, 12), min_size=len(periods),
                  max_size=len(periods)),
        hst.one_of(hst.none(), hst.integers(0, 4)),
        hst.integers(1, 60))))
def test_firing_schedule_matches_jax(case):
    periods, clocks, bound, tick = case
    assert firing_schedule(tick, periods, list(clocks), bound) == \
        jax_firing_schedule(tick, periods, list(clocks), bound)


# --------------------------------------------- the JAX reference process
_JAX_CHILD = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config
from repro.core import parameter_server as PS
from repro.core.collectives import shard_map
from repro.data import LMDataConfig, make_lm_batches
from repro.models import build_model
from repro.train import Strategy

out = {}
inp = np.load(%(inp)r)
mesh = Mesh(np.array(jax.devices()[:4]), ("w",))

def ps_body(p0, p1, g0, g1, x):
    g = [g0[0], g1[0]]
    shards = PS.push_reduce_scatter(g, "w")
    new, _ = PS.make_ps_step(PS.sgd_update_fn(0.1, mean_over=4), "w")(
        [p0, p1], g, None)
    mine = [PS.shard_of_flat(p0, "w"), PS.shard_of_flat(p1, "w")]
    full = PS.all_gather_flat(mine[1], "w", p1.size)
    rs = PS.reduce_scatter_flat(x[0], "w")
    return tuple(a[None] for a in (shards[0], shards[1], new[0], new[1],
                                   mine[0], mine[1], full, rs))

f = jax.jit(shard_map(ps_body, mesh=mesh,
                      in_specs=(P(), P(), P("w"), P("w"), P("w")),
                      out_specs=(P("w"),) * 8, check_vma=False))
names = ("rs0", "rs1", "new0", "new1", "mine0", "mine1", "full", "rs_flat")
for name, val in zip(names, f(inp["p0"], inp["p1"], inp["g0"], inp["g1"],
                              inp["x"])):
    out["ps/" + name] = np.asarray(val)

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
    out[spec + "/events"] = np.array([(h.get("worker", -1),
                                       h["max_staleness"]) for h in hist])
    out[spec + "/wire"] = np.array(wire)
    for i, leaf in enumerate(jax.tree.leaves(p)):
        out[spec + "/p%%d" %% i] = np.asarray(leaf)
np.savez(%(out)r, **out)
"""


def _ps_inputs():
    rng = np.random.RandomState(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(p0=f(5, 7), p1=f(13), g0=f(4, 5, 7), g1=f(4, 13),
                x=f(4, 4 * 9))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_sync")
    np.savez(d / "inp.npz", **_ps_inputs())
    run_multidevice(_JAX_CHILD % dict(inp=str(d / "inp.npz"),
                                      specs=ENGINE_SPECS,
                                      out=str(d / "out.npz")), n_devices=8)
    return dict(np.load(d / "out.npz"))


# ------------------------------------------- parameter-server functions
def _close(a, b, tol=1e-6):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    scale = max(1.0, float(np.abs(b).max()))
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * scale


def test_psum_scatter_matches_jax(jax_ref):
    x = torch.from_numpy(_ps_inputs()["x"])
    _close(psum_scatter(x.reshape(4, 4, 9)), jax_ref["ps/rs_flat"])
    _close(PS.reduce_scatter_flat(x), jax_ref["ps/rs_flat"])


def test_psum_scatter_of_one_worker_is_exact():
    """A single pusher among exact-zero views: the shards are its chunks,
    bit for bit, and no zero tensor is materialised."""
    g = torch.randn(4, 9)
    zero = g.new_zeros(()).expand(4, 9)
    for w in range(4):
        out = psum_scatter([g if v == w else zero for v in range(4)])
        assert torch.equal(out, g)
    assert zero.untyped_storage().nbytes() == 4


def test_parameter_server_matches_jax(jax_ref):
    inp = {k: torch.from_numpy(v) for k, v in _ps_inputs().items()}
    params = [inp["p0"][None].expand(4, 5, 7), inp["p1"][None].expand(4, 13)]
    grads = [inp["g0"], inp["g1"]]
    shards = PS.push_reduce_scatter(grads)
    _close(shards[0], jax_ref["ps/rs0"])
    _close(shards[1], jax_ref["ps/rs1"])
    new, opt = PS.make_ps_step(PS.sgd_update_fn(0.1, mean_over=4))(
        params, grads, None)
    assert opt is None
    _close(new[0], jax_ref["ps/new0"])
    _close(new[1], jax_ref["ps/new1"])
    mine = [PS.shard_of_flat(p) for p in params]
    _close(mine[0], jax_ref["ps/mine0"], 0)
    _close(mine[1], jax_ref["ps/mine1"], 0)
    _close(PS.all_gather_flat(mine[1], 13), jax_ref["ps/full"], 0)
    flat, n = PS.pad_to_multiple(inp["p1"], 4)
    assert (tuple(flat.shape), n) == ((16,), 13)
    assert [t.shape for t in PS.init_opt_shards(
        [inp["p0"], inp["p1"]], 4, torch.zeros)] == [(9,), (4,)]


# --------------------------------------------- simulator against JAX's
def _jax_grad_fn(jmodel):
    def grad_fn(p, batch):
        (loss, _), g = jax.value_and_grad(
            lambda pp: jmodel.loss_fn(pp, batch, compute_dtype=jnp.float32),
            has_aux=True)(p)
        return loss, g
    return grad_fn


SIM_CASES = [(s, c) for s in ("bsp", "ssp", "asp") for c in ("none",
                                                               "onebit")]
SIM_CASES.append(("sma", "none"))


@pytest.mark.parametrize("mode,method", SIM_CASES)
def test_sim_engine_matches_jax_sim(mode, method):
    s = _reduced()
    if "jax_grad" not in s:
        s["jax_grad"] = _jax_grad_fn(s["jmodel"])
    jbatches = jax_make_lm_batches(JaxLMDataConfig(
        vocab_size=s["cfg"].vocab_size, seq_len=16, batch_size=2))
    jeng = JaxSimSyncEngine(JaxSyncConfig(
        mode=mode, num_workers=4, staleness=1, lr=0.05,
        compressor=JaxCompressor(method)), s["jax_grad"])
    _, jhist, jwire = jeng.run(s["jparams"], jbatches, 2)
    strat = Strategy(sync=mode, compression=method, workers=4, staleness=1,
                     lr=0.05, backend="sim")
    eng = strat.build(_grad_fn(s["model"]),
                      layout=s["model"].leaf_layout(s["params"]),
                      device="cpu")
    assert eng.backend == "sim"
    _, hist, wire = eng.run(s["params"], _batches(), 2)
    assert _events(hist) == _events(jhist)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(hist, jhist)) \
        <= 1e-4
    assert wire == jwire


# ------------------------------------------ device engine against JAX's
@pytest.mark.parametrize("spec", ENGINE_SPECS)
def test_device_engine_matches_jax_engine(jax_ref, spec):
    s = _reduced()
    layout = s["model"].leaf_layout(s["params"])
    engine = Strategy.parse(spec, **RECIPE).build(
        _grad_fn(s["model"]), layout=layout, device="cpu")
    params, hist, wire = engine.run(s["params"], _batches(), 2)
    assert _events(hist) == [tuple(e) for e in
                             jax_ref[spec + "/events"].tolist()]
    losses = np.array([h["loss"] for h in hist])
    assert np.abs(losses - jax_ref[spec + "/losses"]).max() <= 1e-4
    assert wire == int(jax_ref[spec + "/wire"])
    for i, leaf in enumerate(layout.leaves(params)):
        assert np.abs(leaf.numpy() - jax_ref[f"{spec}/p{i}"]).max() <= \
            1e-4, i


@pytest.mark.parametrize("sync", ["ssp:2", "asp"])
def test_async_ps_push_equals_allreduce_apply(sync):
    """The one-hot PS push (reduce-scatter with exact-zero contributions,
    shard update, all-gather) is ``p - lr * g`` bit for bit, so both
    architectures and the simulator replay the same trajectory."""
    s = _reduced()
    layout = s["model"].leaf_layout(s["params"])
    runs = {}
    for arch, backend in (("ps", "device"), ("allreduce", "device"),
                          ("allreduce", "sim")):
        runs[arch, backend] = Strategy.parse(
            f"{sync}/{arch}/onebit@3", lr=0.05, backend=backend).build(
            _grad_fn(s["model"]), layout=layout, device="cpu").run(
                s["params"], _batches(), 2)
    ref = runs["ps", "device"]
    for key, (params, hist, wire) in runs.items():
        assert [h["loss"] for h in hist] == [h["loss"] for h in ref[1]]
        assert _events(hist) == _events(ref[1]) and wire == ref[2]
        assert all(torch.equal(a, b) for a, b in zip(
            layout.leaves(params), layout.leaves(ref[0]))), key


def test_device_engine_state_bytes_and_metrics():
    s = _reduced()
    layout = s["model"].leaf_layout(s["params"])
    n_params = sum(int(np.prod(x)) for x in layout.shapes(s["params"]))
    for spec, ef in (("ssp:3/ps/onebit@4", 4 * n_params),
                     ("sma/allreduce/none@4", 0)):
        engine = Strategy.parse(spec, **RECIPE).build(
            _grad_fn(s["model"]), layout=layout, device="cpu")
        st = engine.init(s["params"])
        assert engine.inner.per_device_state_bytes(st) == dict(
            params=4 * n_params, opt=0, ef=ef, total=4 * n_params)
        st, _ = engine.step(st, _batches(), 0)
        m = engine.metrics()
        assert m["backend"] == "device" and m["spec"] == spec
        assert m["dropped_updates"] == 0 and m["wire_bytes"] > 0


# ------------------------------------------------------- BENCH_pr10 rows
BENCH_SPECS = ("ssp:3/allreduce/onebit@8", "ssp:3/ps/onebit@8",
               "asp/allreduce/none@8", "asp/ps/none@8", "bsp/ps/none@8",
               "bsp/ps/onebit@8", "bsp/ps/dgc:0.05@8")


def _bench_params():
    """The JAX init the BENCH_pr10 rows were recorded with: jax < 0.5
    drew ``PRNGKey(0)`` through the non-partitionable threefry stream."""
    s = _reduced()
    if "bench_params" not in s:
        with jax.threefry_partitionable(False):
            jparams = s["jmodel"].init(jax.random.PRNGKey(0))
        s["bench_params"] = from_jax_params(
            s["cfg"], jax.tree.map(np.array, jparams))
    return s["bench_params"]


@pytest.mark.parametrize("spec", BENCH_SPECS)
def test_engine_reproduces_bench_pr10(spec):
    with open(os.path.join(ROOT, "BENCH_pr10.json")) as f:
        row = {r["strategy"]: r for r in map(json.loads, f)
               if r.get("bench") == "data_parallel"}[spec]
    model, params = _reduced()["model"], _bench_params()
    _, hist, mets = Trainer(Strategy.parse(spec, **RECIPE),
                            device="cpu").fit(
        _grad_fn(model), params, _batches(), 2,
        layout=model.leaf_layout(params))
    assert mets["backend"] == "device"
    assert mets["wire_bytes"] // 2 == row["wire_bytes_per_step"]
    assert len(hist) == row["events"]
    assert abs(hist[-1]["loss"] - row["loss_last"]) <= 1e-3


# ------------------------------------------------------------- registry
def test_registered_cells_match_jax():
    assert registered_cells() == [tuple(c) for c in jax_registered_cells()]
    assert len(registered_cells()) == 33


def _lin_batch(t, w):
    rng = np.random.RandomState(t * 100 + w)
    X = rng.standard_normal((16, 8)).astype(np.float32)
    return {"X": torch.from_numpy(X),
            "y": torch.from_numpy(X @ np.arange(1, 9, dtype=np.float32)
                                  .reshape(8, 1))}


def _lin_loss(p, b):
    return ((b["X"] @ p["W"] - b["y"]) ** 2).mean(), {}


@pytest.mark.parametrize("cell", registered_cells(), ids=str)
def test_every_registered_cell_runs(cell):
    strat = Strategy(sync=cell.sync, arch=cell.arch,
                     compression=cell.compression, workers=2, lr=0.05,
                     staleness=1, density=0.1, backend=cell.backend)
    engine = strat.build(value_and_grad(_lin_loss), device="cpu")
    assert engine.backend == cell.backend
    params = {"W": torch.zeros(8, 1), "b": torch.zeros(130)}
    out, hist, wire = engine.run(params, _lin_batch, 2)
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    assert wire > 0
    assert out["W"].abs().sum() > 0
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_resolve_backend():
    assert Strategy.parse("ssp:3/ps/onebit@8").resolve_backend() == "device"
    assert Strategy.parse("asp@4", backend="sim").resolve_backend() == "sim"
    with pytest.raises(ValueError, match="device-only"):
        Strategy.parse("bsp/ring/onebit@4", backend="sim",
                       wire="measured").resolve_backend()
    with pytest.raises(ValueError, match="sma"):
        Strategy.parse("sma/ps/none@4")
