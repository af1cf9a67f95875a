"""The port's FedAvg, data loaders, acceptance cells, engine metrics,
``make_allreduce`` and regression gate against the JAX package's.

FedAvg: 3 rounds on IID and Dirichlet(0.1) splits of the example's
classification set, the example's MLP from the reference's initial
parameters: the same clients, losses and parameters within 1e-5.
``ShardedLoader`` gives the reference's batches in order and its
``close()`` stops the reader; ``EpochCache`` materializes what the
reference's does.  ``ACCEPTANCE_CELLS`` is the reference's set;
``Engine.extra_metrics()`` the reference's keys and values after one
measured-wire run.  ``make_allreduce`` over every topology equals the
reference's under ``shard_map`` on 4 virtual devices.  ``run_gate`` and
``format_report`` over the committed ``BENCH_pr*.json`` (lineage pattern
set to the reference's) give the reference's report, text included.
"""
import importlib.util
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.federated import FedConfig as JaxFedConfig
from repro.core.federated import run_fedavg as jax_run_fedavg
from repro.data import pipeline as JPL
from repro.data.partition import (dirichlet_partition, iid_partition,
                                  make_classification_data)
from repro.obs import regress as JREG
from repro.train import strategy as JSTRAT
from repro_torch.core.allreduce import TOPOLOGIES, make_allreduce
from repro_torch.core.federated import FedConfig, run_fedavg
from repro_torch.data import EpochCache, LMDataConfig, ShardedLoader
from repro_torch.data import pipeline as PL
from repro_torch.obs import regress as REG
from repro_torch.train import Strategy
from repro_torch.train import strategy as STRAT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, CLASSES, CLIENTS = 1500, 16, 8, 10


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- fedavg
@pytest.mark.parametrize("split", ["iid", "dirichlet"])
def test_fedavg_matches_reference(split):
    fed = _tool("torch_federated_noniid")
    X, y = make_classification_data(N, DIM, CLASSES, seed=0)
    parts = (iid_partition(N, CLIENTS, seed=0) if split == "iid"
             else dirichlet_partition(y, CLIENTS, 0.1, seed=0))

    def jgrad(params, batch):
        def loss(p):
            logits = jnp.tanh(batch["X"] @ p["w1"]) @ p["w2"]
            logz = jax.nn.logsumexp(logits, -1)
            ll = jnp.take_along_axis(logits, batch["y"][:, None], 1)[:, 0]
            return jnp.mean(logz - ll)
        return jax.value_and_grad(loss)(params)

    def jclients():
        fns = []
        for idx in parts:
            def fn(step, idx=idx):
                rng = np.random.RandomState(step)
                sel = idx[rng.randint(0, len(idx), size=min(32, len(idx)))]
                return {"X": jnp.asarray(X[sel]), "y": jnp.asarray(y[sel])}
            fns.append(fn)
        return fns

    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    jp0 = {"w1": jax.random.normal(k1, (DIM, 32)) * 0.2,
           "w2": jax.random.normal(k2, (32, CLASSES)) * 0.2}
    cfg = dict(num_clients=CLIENTS, clients_per_round=5, local_steps=4,
               local_lr=0.1)
    jp, jhist = jax_run_fedavg(jp0, jclients(), jgrad, JaxFedConfig(**cfg),
                               3)
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in jp0.items()}
    p, hist = run_fedavg(p0, fed.client_batches(X, y, parts, "cpu"),
                         fed.mlp_grad_fn, FedConfig(**cfg), 3)
    # the rounds' clients: the same RandomState draws
    rng = np.random.RandomState(0)
    sel = [rng.choice(CLIENTS, 5, replace=False).tolist() for _ in range(3)]
    assert len(set(map(tuple, sel))) == 3
    assert [h["round"] for h in hist] == [h["round"] for h in jhist]
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(hist, jhist)) \
        <= 1e-5
    for k in jp:
        assert np.abs(p[k].numpy() - np.asarray(jp[k])).max() <= 1e-5


# --------------------------------------------------------------- loaders
def _with_timeout(fn, seconds=20):
    """Run ``fn`` on a thread; fail if it has not returned in time."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", fn()),
                         daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"timed out after {seconds} s"
    return out["v"]


def test_sharded_loader_matches_reference():
    cfg = LMDataConfig(vocab_size=64, seq_len=8, batch_size=2)
    jcfg = JPL.LMDataConfig(vocab_size=64, seq_len=8, batch_size=2)

    def run():
        got = [b["tokens"].numpy() for b in ShardedLoader(
            lambda s: PL.synthetic_lm_batch(cfg, s), prefetch=2,
            num_steps=6)]
        want = [np.asarray(b["tokens"]) for b in JPL.ShardedLoader(
            lambda s: JPL.synthetic_lm_batch(jcfg, s), prefetch=2,
            num_steps=6)]
        return got, want

    got, want = _with_timeout(run)
    assert len(got) == len(want) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_sharded_loader_close_stops_the_reader():
    calls = []

    def fn(step):
        calls.append(step)
        return step

    loader = ShardedLoader(fn, prefetch=2)            # endless
    it = iter(loader)
    assert _with_timeout(lambda: [next(it) for _ in range(3)]) == [0, 1, 2]
    loader.close()
    loader._thread.join(10)
    assert not loader._thread.is_alive()
    n = len(calls)
    assert n <= 3 + 2 + 2                  # read, queued, one in flight


def test_epoch_cache_matches_reference():
    calls, jcalls = [], []
    cache = EpochCache(lambda k: calls.append(k) or k * 10, 4)
    jcache = JPL.EpochCache(lambda k: jcalls.append(k) or k * 10, 4)
    steps = [0, 1, 5, 2, 9, 4, 3, 7, 11]
    assert [cache(s) for s in steps] == [jcache(s) for s in steps]
    assert calls == jcalls == [0, 1, 2, 3]
    assert cache.hit_ratio_after == jcache.hit_ratio_after == 4


# ------------------------------------------------------ strategy surface
def test_acceptance_cells_match_reference():
    assert {tuple(c) for c in STRAT.ACCEPTANCE_CELLS} == \
        {tuple(c) for c in JSTRAT.ACCEPTANCE_CELLS}
    assert STRAT.ACCEPTANCE_CELLS <= set(STRAT.registered_cells())


MULTIDEVICE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.allreduce import TOPOLOGIES, make_allreduce
from repro.core.collectives import shard_map
from repro.train import Strategy

out = {}
n = 4
mesh = Mesh(np.array(jax.devices()[:n]), ("w",))
rng = np.random.RandomState(0)
tree = {"a": rng.randn(n, 5).astype(np.float32),
        "b": rng.randn(n, 3, 2).astype(np.float32)}
for top in sorted(TOPOLOGIES):
    for mean in (True, False):
        f = shard_map(lambda t, _t=top, _m=mean: make_allreduce(_t, "w", _m)(t),
                      mesh=mesh, in_specs=P("w"), out_specs=P("w"),
                      check_vma=False)
        got = f({k: jnp.asarray(v) for k, v in tree.items()})
        out[f"{top}/{mean}"] = {k: np.asarray(v).tolist()
                                for k, v in got.items()}


def grad_fn(p, batch):
    def loss(q):
        return jnp.mean((batch["x"] @ q["w"] - batch["y"]) ** 2)
    return jax.value_and_grad(loss)(p)


def batches(step, worker):
    r = np.random.RandomState(step * 31 + worker)
    return {"x": jnp.asarray(r.randn(4, 16).astype(np.float32)),
            "y": jnp.asarray(r.randn(4, 8).astype(np.float32))}


eng = Strategy.parse("bsp/ring/onebit@2", lr=0.05, wire="measured",
                     backend="device").build(grad_fn)
p0 = {"w": jnp.asarray(np.random.RandomState(1).randn(16, 8)
                       .astype(np.float32))}
eng.run(p0, batches, 2)
out["extra_metrics"] = eng.extra_metrics()
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ref(multidevice):
    out = multidevice(MULTIDEVICE, n_devices=4)
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_make_allreduce_matches_reference(jax_ref, topology):
    rng = np.random.RandomState(0)
    tree = {"a": torch.from_numpy(rng.randn(4, 5).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(4, 3, 2).astype(np.float32))}
    for mean in (True, False):
        got = make_allreduce(topology, mean)(tree)
        want = jax_ref[f"{topology}/{mean}"]
        for k in tree:
            assert got[k].dtype == tree[k].dtype
            np.testing.assert_allclose(got[k].numpy(), np.array(want[k]),
                                       rtol=0, atol=1e-6)
    bf = make_allreduce(topology)({"c": torch.ones(4, 3,
                                                   dtype=torch.bfloat16)})
    assert bf["c"].dtype == torch.bfloat16 and torch.all(bf["c"] == 1)


def test_engine_extra_metrics_match_reference(jax_ref):
    def grad_fn(p, batch):
        w = p["w"].detach().requires_grad_()
        loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        return loss.detach(), {"w": g}

    def batches(step, worker):
        r = np.random.RandomState(step * 31 + worker)
        return {"x": torch.from_numpy(r.randn(4, 16).astype(np.float32)),
                "y": torch.from_numpy(r.randn(4, 8).astype(np.float32))}

    eng = Strategy.parse("bsp/ring/onebit@2", lr=0.05, wire="measured",
                         backend="device").build(grad_fn, device="cpu")
    p0 = {"w": torch.from_numpy(np.random.RandomState(1).randn(16, 8)
                                .astype(np.float32))}
    eng.run(p0, batches, 2)
    got = eng.extra_metrics()
    assert got == jax_ref["extra_metrics"]
    assert got == {k: v for k, v in eng.metrics().items() if k in got}


# ------------------------------------------------------ regression gate
def test_regression_gate_matches_reference(tmp_path):
    names = sorted(n for n in os.listdir(ROOT)
                   if n.startswith("BENCH_pr") and n.endswith(".json"))
    assert names
    for n in names:
        shutil.copy(os.path.join(ROOT, n), tmp_path / n)
    ref_pattern = r"BENCH_pr(\d+)\.json"
    want = JREG.run_gate(str(tmp_path))
    got = REG.run_gate(str(tmp_path), pattern=ref_pattern)
    assert got == want
    assert REG.format_report(got) == JREG.format_report(want)
    # the port's own lineage is kept apart from the reference's
    with pytest.raises(FileNotFoundError):
        REG.run_gate(str(tmp_path))
    for n in names:
        os.rename(tmp_path / n, tmp_path / n.replace("BENCH_pr",
                                                     "BENCH_torch_pr"))
    torch_report = REG.run_gate(str(tmp_path))
    assert torch_report["violations"] == want["violations"]
    assert torch_report["compared"] == want["compared"]
    fresh = tmp_path / "fresh.json"
    rows = REG.load_rows(str(tmp_path / names[-1].replace(
        "BENCH_pr", "BENCH_torch_pr")))
    rows[0] = dict(rows[0])
    for k in ("wire_bytes_per_step", "tokens_per_s", "loss_last"):
        if k in rows[0]:
            rows[0][k] = rows[0][k] * 3 + 10
    fresh.write_text("\n".join(json.dumps(r) for r in rows))
    assert REG.run_gate(str(tmp_path), current_path=str(fresh)) == \
        JREG.compare([(os.path.basename(p), JREG.load_rows(p)) for p in
                      REG.find_bench_files(str(tmp_path))],
                     ("fresh.json", rows))
