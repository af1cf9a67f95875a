"""The port's elastic plane (``repro_torch.elastic``, the engines' backup
workers, detection, ``reshard`` and snapshots, ``data/partition.py``)
against the JAX package's, on the CPU.

The problem is the reference's tiny regression (``P0 = {"W": [8, 1],
"b": [130]}``; ``b`` has no gradient and exercises the onebit channel
path), with batches drawn by JAX and carried over as numpy.

* The cases of tests/test_elastic.py (plans, the backup policy, snapshot
  and resume, resize, crash rollback, the scheduler adapter, the
  acceptance scenario ``ssp:2/ring/onebit@4`` under
  ``crash:w2@5,resize:4@10``) and tests/test_preemption.py (the
  detector, measured detection, SIGTERM snapshot and resume in a
  subprocess that imports only the port, consumed-event records,
  incremental cadence saves), on the port; most on both of its backends.
* ``make_classification_data``, the partitions, ``label_skew``,
  ``stream_assignment`` and ``plan_from_sched_trace`` equal the
  reference's.
* Parity: ``Trainer.fit(plan=...)`` of the port on backends ``device``
  and ``sim`` against ``repro``'s simulator (the reference's device
  engine needs virtual devices; it asserts itself against its simulator
  to 1e-4, tests/test_elastic.py): the history's steps, workers,
  staleness and ``dropped`` equal, each loss within 1e-4, the recovery
  records (but their wall), ``resizes``, ``executed_steps``,
  ``final_workers`` and ``dropped_updates`` equal, the final parameters
  within 1e-4.
"""
import functools
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jax_partition
from repro.elastic import plan_from_sched_trace as jax_plan_from_sched_trace
from repro.elastic import recovery as jax_recovery
from repro.sched import make_trace as jax_make_trace
from repro.sched import simulate as jax_simulate
from repro.sched import Cluster as JaxCluster
from repro.train import Strategy as JaxStrategy
from repro.train import Trainer as JaxTrainer
from repro_torch.checkpoint.store import (load_checkpoint, read_manifest,
                                          save_checkpoint)
from repro_torch.core.tree import get_path, leaf_paths, tree_map
from repro_torch.data import partition
from repro_torch.data.partition import stream_assignment
from repro_torch.elastic import (ElasticEvent, EventPlan, FailurePlan,
                                 ResizePlan, StepTimeEMA, StragglerPlan,
                                 drop_set, latest_checkpoint, merge_plans,
                                 participation_weights,
                                 plan_from_sched_trace, restore_engine_state,
                                 save_engine_state)
from repro_torch.elastic.recovery import fit_elastic
from repro_torch.sched import Cluster, TraceEvent, make_trace, simulate
from repro_torch.train import Strategy, Trainer, value_and_grad

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
BACKENDS = ("sim", "device")

KEY = jax.random.PRNGKey(0)
W_TRUE = jax.random.normal(KEY, (8, 1))


@functools.lru_cache(maxsize=None)
def _batch_np(t, w):
    k = jax.random.fold_in(KEY, t * 100 + w)
    X = jax.random.normal(k, (16, 8))
    return np.array(X), np.array(X @ W_TRUE)


def make_batch(t, w):
    X, y = _batch_np(t, w)
    return {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}


def jax_make_batch(t, w):
    X, y = _batch_np(t, w)
    return {"X": jnp.asarray(X), "y": jnp.asarray(y)}


def make_batches(slow_worker=None, delay=0.03):
    def batches(t, w):
        if slow_worker is not None and w == slow_worker:
            time.sleep(delay)
        return make_batch(t, w)
    return batches


grad_fn = value_and_grad(
    lambda p, b: (((b["X"] @ p["W"] - b["y"]) ** 2).mean(), {}))


def jax_grad_fn(params, batch):
    def loss(p):
        return jnp.mean((batch["X"] @ p["W"] - batch["y"]) ** 2)
    return jax.value_and_grad(loss)(params)


def p0():
    # second leaf exercises the channelwise onebit reconstruction path
    return {"W": torch.zeros(8, 1), "b": torch.zeros(130)}


JAX_P0 = {"W": jnp.zeros((8, 1)), "b": jnp.zeros((130,))}


def fit(strategy, steps, batches=make_batch, **kw):
    return Trainer(strategy, device="cpu").fit(grad_fn, p0(), batches,
                                               steps, **kw)


def build(**kw):
    return Strategy(**kw).build(grad_fn, device="cpu")


def leaves(tree):
    return [get_path(tree, p) for p in leaf_paths(tree)]


def assert_trees_equal(a, b):
    assert leaf_paths(a) == leaf_paths(b)
    for x, y in zip(leaves(a), leaves(b)):
        assert (x is None and y is None) or torch.equal(x, y)


# ------------------------------------------------------------ event plans
def test_plan_parse_spec_roundtrip():
    spec = "restart@3,crash:w1@5,slow:w2x3.5@7,resize:4@10"
    plan = EventPlan.parse(spec)
    assert plan.spec() == spec
    assert EventPlan.parse(plan.spec()).spec() == spec
    assert len(plan) == 4
    assert plan.needs_checkpoints


def test_plan_rejects_bad_items():
    for bad in ("crash:w1", "crash:1@5", "resize:0@5", "slow:w1@3",
                "slow:w1x0@3", "warp:w1@3", "crash:w1@-1"):
        with pytest.raises(ValueError):
            EventPlan.parse(bad)


def test_typed_plans_merge():
    plan = merge_plans(FailurePlan(crashes=((5, 1),)),
                       ResizePlan(resizes=((10, 4),)),
                       StragglerPlan(slows=((2, 0, 3.0),)))
    assert [e.kind for e in plan] == ["slow", "crash", "resize"]
    assert plan.spec() == "slow:w0x3@2,crash:w1@5,resize:4@10"


def test_plan_run_consumes_each_event_once():
    run = EventPlan.parse("slow:w0x2@3,crash:w1@5").start()
    assert run.take_one(2) is None
    ev = run.take_one(5)
    assert ev.kind == "slow"            # due events come in plan order
    ev = run.take_one(5)
    assert ev.kind == "crash"
    # after a rollback to step 0, consumed events do not re-fire
    assert run.take_one(5) is None
    assert not run.pending


def test_plan_run_consumed_record_roundtrip():
    run = EventPlan.parse("slow:w0x2@3,crash:w1@5").start()
    run.take_one(5)
    assert run.consumed_specs() == ["slow:w0x2@3"]
    fresh = EventPlan.parse("slow:w0x2@3,crash:w1@5").start()
    fresh.mark_consumed(run.consumed_specs())
    assert [e.spec() for e in fresh.pending] == ["crash:w1@5"]
    # unknown specs are ignored (a plan may change between incarnations)
    fresh.mark_consumed(["resize:9@99"])
    assert len(fresh.pending) == 1
    assert [e.spec() for e in run.take(9)] == ["crash:w1@5"]


# ---------------------------------------------------------- backup policy
def test_drop_set_deterministic_and_slowdown_aware():
    periods = (1, 2, 3, 4)
    assert drop_set(periods, 0) == frozenset()
    assert drop_set(periods, 1) == frozenset({3})
    assert drop_set(periods, 2) == frozenset({2, 3})
    # ties break toward the higher worker id
    assert drop_set((2, 2, 2), 1) == frozenset({2})
    # an active slowdown can make an otherwise-fast worker the straggler
    assert drop_set(periods, 1, slowdowns=[10.0, 1, 1, 1]) == frozenset({0})
    with pytest.raises(ValueError):
        drop_set(periods, 4)


def test_participation_weights_mean_preserving():
    w = participation_weights(4, frozenset({3}))
    np.testing.assert_allclose(w, [4 / 3, 4 / 3, 4 / 3, 0.0])
    assert participation_weights(4, frozenset()).tolist() == [1.0] * 4


def test_backup_spec_grammar():
    s = Strategy.parse("bsp+backup:1/ring/onebit@4")
    assert (s.sync, s.backup, s.arch, s.topology) == \
        ("bsp", 1, "allreduce", "ring")
    assert s.spec() == "bsp+backup:1/allreduce/onebit@4"
    assert Strategy.parse(s.spec()).backup == 1
    for bad in ("bsp+backup/ring", "ssp+backup:1", "bsp+backup:4@4"):
        with pytest.raises(ValueError):
            Strategy.parse(bad)
    with pytest.raises(ValueError):
        Strategy(sync="ssp", backup=1)


def test_detect_spec_grammar():
    s = Strategy.parse("bsp+backup:1+detect/ring/none@4")
    assert (s.backup, s.detect) == (1, True)
    assert Strategy.parse(s.spec()) == s
    assert Strategy.parse("bsp+detect").detect
    with pytest.raises(ValueError):
        Strategy(sync="ssp", detect=True)
    eng = Strategy.parse("bsp+backup:1+detect/allreduce/onebit@4").build(
        grad_fn, device="cpu")
    assert isinstance(eng.inner.detector, StepTimeEMA)


def test_topology_alias_spec_roundtrip():
    s = Strategy.parse("bsp/tree/none@4")
    assert (s.arch, s.topology) == ("allreduce", "tree")
    assert s.spec() == "bsp/tree/none@4"
    assert Strategy.parse(s.spec()).topology == "tree"
    assert Strategy.parse("bsp/ring/none@4").spec() == \
        "bsp/allreduce/none@4"


@pytest.mark.parametrize("backend", BACKENDS)
def test_backup_drops_and_accounts(backend):
    K, steps = 4, 5
    eng = build(sync="bsp", backup=1, workers=K, lr=0.05,
                compression="onebit", backend=backend)
    _, hist, wire = eng.run(p0(), make_batch, steps)
    # default periods rank worker K-1 slowest -> always dropped
    assert all(h["dropped"] == [K - 1] for h in hist)
    assert eng.metrics()["dropped_updates"] == steps
    # dropped pushes are not wire-accounted: (K-1) events/step
    comp = eng.inner.cfg.compressor
    per_event = sum(comp.wire_bytes(x.shape) for x in leaves(p0()))
    assert wire == per_event * (K - 1) * steps


@pytest.mark.parametrize("backend", BACKENDS)
def test_backup_drop_follows_straggler_event(backend):
    params, hist, mets = fit(
        Strategy(sync="bsp", backup=1, workers=4, lr=0.05, backend=backend),
        6, plan="slow:w0x10@3")
    assert [h["dropped"] for h in hist[:3]] == [[3]] * 3
    assert [h["dropped"] for h in hist[3:]] == [[0]] * 3
    assert mets["dropped_updates"] == 6


@pytest.mark.parametrize("wire", ["modeled", "measured"])
def test_dropped_worker_keeps_its_ef(wire):
    """The device engine keeps a dropped worker's residual on both wire
    modes (the measured exchange renews every worker's EF) and its
    survivors' residual tensors across a reshard, without a copy."""
    eng = build(sync="bsp", backup=1, workers=4, lr=0.05,
                compression="onebit", backend="device", wire=wire)
    st = eng.init(p0())
    st, _ = eng.step(st, make_batch, 0)
    before = [list(row) for row in st["ef"]]
    st, (ev,) = eng.step(st, make_batch, 1)
    assert ev["dropped"] == [3]
    assert all(a is b for a, b in zip(st["ef"][3], before[3]))
    assert all(not torch.equal(a, b) for a, b in zip(st["ef"][0][:1],
                                                     before[0][:1]))
    kept = [list(row) for row in st["ef"]]
    st = eng.reshard(st, 4, step=2, lost=(1,))
    assert [[a is b for a, b in zip(st["ef"][i], kept[s])]
            for i, s in enumerate((0, 2, 3))] == [[True, True]] * 3
    assert all(not x.any() for x in st["ef"][3])
    st, _ = eng.step(st, make_batch, 2)
    assert all(torch.isfinite(x).all() for x in leaves(st["params"]))


# ------------------------------------------------------- snapshot / resume
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode,comp", [("bsp", "onebit"), ("ssp", "onebit"),
                                       ("asp", "none"), ("sma", "none")])
def test_save_restore_resume_bitwise(tmp_path, backend, mode, comp):
    mk = lambda: build(sync=mode, workers=4, staleness=2, lr=0.05,  # noqa
                       compression=comp, backend=backend)
    eng = mk()
    st = eng.init(p0())
    losses_a = []
    for t in range(10):
        st, ev = eng.step(st, make_batch, t)
        losses_a.extend(e["loss"] for e in ev)
    p_a = eng.finalize(st)

    eng_b = mk()
    st_b = eng_b.init(p0())
    losses_b = []
    for t in range(5):
        st_b, ev = eng_b.step(st_b, make_batch, t)
        losses_b.extend(e["loss"] for e in ev)
    save_engine_state(str(tmp_path / "ck"), eng_b, st_b, 5)

    eng_c = mk()                        # a fresh process-equivalent engine
    st_c, meta = restore_engine_state(str(tmp_path / "ck"), eng_c, p0())
    assert meta["step"] == 5 and meta["backend"] == backend
    assert "rng" not in read_manifest(str(tmp_path / "ck"))["extra"]
    for t in range(5, 10):
        st_c, ev = eng_c.step(st_c, make_batch, t)
        losses_b.extend(e["loss"] for e in ev)
    p_c = eng_c.finalize(st_c)

    assert losses_a == losses_b
    assert eng.metrics()["wire_bytes"] == eng_c.metrics()["wire_bytes"]
    assert_trees_equal(p_a, p_c)


@pytest.mark.parametrize("backend", BACKENDS)
def test_background_save_is_taken_at_call_time(tmp_path, backend):
    """``background=True`` copies every leaf (and so every list of the
    state) to the host before it returns, so steps that run before the
    write lands cannot leak into the snapshot: neither an in-place update
    of a tensor nor a worker's list item rebound by the step (its EF, its
    pulled parameters)."""
    mk = lambda: build(sync="ssp", staleness=2, workers=3, lr=0.05,  # noqa
                       compression="onebit", backend=backend)
    eng = mk()
    st = eng.init(p0())
    st, _ = eng.step(st, make_batch, 0)
    want = tree_map(lambda x: None if x is None else x.clone(),
                    eng.export_state(st)[0])
    th = save_engine_state(str(tmp_path / "ck"), eng, st, 1,
                           background=True)
    for path in leaf_paths(st["params"]):
        get_path(st["params"], path).add_(1.0)   # in place, meanwhile
    for t in (1, 2):
        st, _ = eng.step(st, make_batch, t)      # rebinds list items
    th.join(timeout=60)
    assert not th.is_alive()
    got, meta = restore_engine_state(str(tmp_path / "ck"), mk(), p0())
    assert meta["step"] == 1
    assert_trees_equal(eng.export_state(got)[0], want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_reshards_engine_to_snapshot_size(tmp_path, backend):
    eng = build(sync="ssp", workers=3, lr=0.05, backend=backend)
    st = eng.init(p0())
    st, _ = eng.step(st, make_batch, 0)
    save_engine_state(str(tmp_path / "ck"), eng, st, 1)
    # a rebuilt engine at a different size reshards itself on restore
    eng2 = build(sync="ssp", workers=4, lr=0.05, backend=backend)
    st2, meta = restore_engine_state(str(tmp_path / "ck"), eng2, p0())
    assert meta["num_workers"] == 3
    assert eng2.inner.cfg.num_workers == 3
    st2, ev = eng2.step(st2, make_batch, 1)
    assert ev and np.isfinite(ev[-1]["loss"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_restart_is_bit_identical_to_uninterrupted(tmp_path, backend):
    strat = Strategy(sync="ssp", workers=4, staleness=2, lr=0.05,
                     compression="onebit", backend=backend)
    p_plain, h_plain, _ = fit(strat, 8)
    p_rst, h_rst, mets = fit(strat, 8, plan="restart@4",
                             checkpoint_dir=str(tmp_path))
    assert len(mets["recoveries"]) == 1
    assert mets["recoveries"][0]["lost_steps"] == 0
    assert [h["loss"] for h in h_plain] == [h["loss"] for h in h_rst]
    assert_trees_equal(p_plain, p_rst)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_rollback_preserves_earlier_slow_event(tmp_path, backend):
    """A slow event commits a checkpoint, so a later crash rollback
    (which never re-fires consumed events) cannot erase the straggler."""
    strat = Strategy(sync="bsp", backup=1, workers=4, lr=0.05,
                     backend=backend)
    p, hist, mets = fit(strat, 8, plan="slow:w0x10@2,crash:w3@5",
                        checkpoint_dir=str(tmp_path), checkpoint_every=100)
    (r,) = mets["recoveries"]
    assert r["restored_step"] == 2      # the slow event's own commit
    assert all(h["dropped"] == [0] for h in hist[2:])


@pytest.mark.parametrize("backend", BACKENDS)
def test_reshard_remaps_survivor_periods(backend):
    eng = build(sync="bsp", workers=4, lr=0.05, periods=(4, 3, 2, 1),
                backend=backend)
    st = eng.init(p0())
    st, _ = eng.step(st, make_batch, 0)
    eng.reshard(st, 3, step=1, lost=(0,))
    # survivors keep their speed identity; no reset to default_periods
    assert eng.inner.periods == (3, 2, 1)
    eng.reshard(st, 4, step=2)          # grown slot takes the default tail
    assert eng.inner.periods == (3, 2, 1, 4)
    with pytest.raises(ValueError, match="out of range"):
        eng.reshard(st, 3, step=3, lost=(7,))


# --------------------------------------------------------- resize / crash
@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_down_up_within_tolerance(tmp_path, backend):
    strat = Strategy(sync="ssp", workers=4, staleness=2, lr=0.05,
                     compression="onebit", backend=backend)
    p_u, h_u, _ = fit(strat, 12)
    p_e, h_e, mets = fit(strat, 12, plan="resize:2@4,resize:4@8",
                         checkpoint_dir=str(tmp_path))
    assert mets["resizes"] == 2 and mets["final_workers"] == 4
    init, lu, le = h_u[0]["loss"], h_u[-1]["loss"], h_e[-1]["loss"]
    assert le <= 4 * lu
    assert lu <= init / 2 and le <= init / 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_elastic_crash_rollback_bookkeeping(tmp_path, backend):
    strat = Strategy(sync="ssp", workers=4, staleness=2, lr=0.05,
                     backend=backend)
    p, hist, mets = fit(strat, 10, plan="crash:w1@6",
                        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    (r,) = mets["recoveries"]
    assert r["kind"] == "crash" and r["lost_worker"] == 1
    assert r["restored_step"] == 4      # latest cadence checkpoint < 6
    assert r["lost_steps"] == 2
    assert mets["final_workers"] == 3
    assert mets["executed_steps"] == 10 + r["lost_steps"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert latest_checkpoint(str(tmp_path)) is not None


def test_fit_elastic_requires_checkpoint_dir_for_crashes():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        fit(Strategy(sync="bsp", workers=2, backend="sim"), 4,
            plan="crash:w1@2")


def test_fit_elastic_ignores_stale_checkpoints(tmp_path):
    """A reused checkpoint_dir with leftovers from an earlier run must
    not leak foreign state: recovery restores only what THIS run wrote."""
    strat = Strategy(sync="ssp", workers=4, staleness=2, lr=0.05,
                     backend="device")
    fit(strat, 8, plan="restart@6", checkpoint_dir=str(tmp_path))
    assert latest_checkpoint(str(tmp_path)).endswith("step_000006")
    p, hist, mets = fit(strat, 5, plan="crash:w1@3",
                        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    (r,) = mets["recoveries"]
    # restored from this run's step-2 cadence save, not the stale step-6
    assert r["restored_step"] == 2 and r["lost_steps"] == 1
    assert len(hist) >= 5


def test_acceptance_scenario_ssp_ring_onebit(tmp_path):
    """``ssp:2/ring/onebit@4`` loses worker 2 before step 5, is resized
    back to 4 before step 10, recovers from its checkpoint and reshards in
    the same process, and lands within the documented loss tolerance of
    an uninterrupted run (the reference's 4-device scenario)."""
    strat = Strategy.parse("ssp:2/ring/onebit@4", lr=0.05, bucket_mb=1e-4)
    p_u, h_u, m_u = fit(strat, 15)
    p_e, h_e, m_e = fit(strat, 15, plan="crash:w2@5,resize:4@10",
                        checkpoint_dir=str(tmp_path), checkpoint_every=3)
    (r,) = m_e["recoveries"]
    assert r["kind"] == "crash" and r["lost_worker"] == 2
    assert m_e["resizes"] == 1 and m_e["final_workers"] == 4
    init, lu, le = h_u[0]["loss"], h_u[-1]["loss"], h_e[-1]["loss"]
    assert le <= 4 * lu
    assert lu <= init / 2 and le <= init / 2


# ------------------------------------------------- detector / detection
def test_step_time_ema_ranking_and_reshard():
    d = StepTimeEMA(3, alpha=0.5, warmup=2)
    assert not d.ready
    for _ in range(2):
        d.observe(0, 0.01)
        d.observe(1, 0.10)
        d.observe(2, 0.02)
    assert d.ready
    assert d.drop_set(1) == frozenset({1})
    assert np.argmax(d.factors()) == 1


def test_step_time_ema_discards_first_sample():
    d = StepTimeEMA(2, warmup=2)
    d.observe(0, 5.0)            # a one-time cost hits whoever runs first
    d.observe(1, 0.01)
    d.observe(0, 0.01)
    d.observe(1, 0.50)           # the real straggler
    assert d.ready
    assert d.drop_set(1) == frozenset({1})


def test_step_time_ema_reshard_and_state():
    d = StepTimeEMA(3, alpha=0.5, warmup=2)
    for _ in range(2):
        d.observe(0, 0.01)
        d.observe(1, 0.10)
        d.observe(2, 0.02)
    d.reshard([0, 2], 3)                 # worker 1 leaves, a new slot joins
    assert not d.ready                   # the grown slot must re-warm
    assert d.ema[2] is None
    d2 = StepTimeEMA(3)
    d2.load_state(d.state())
    assert d2.ema == d.ema and d2.count == d.count
    # the tie rule of elastic/backup.py::drop_set
    d3 = StepTimeEMA(3, warmup=1)
    for w in range(3):
        d3.observe(w, 1.0)
        d3.observe(w, 0.25)
    assert d3.drop_set(1) == drop_set([1, 1, 1], 1) == frozenset({2})


@pytest.mark.parametrize("backend", BACKENDS)
def test_detection_cross_validates_scheduled_plan(backend):
    # scheduled: slow:w1x10@0 makes worker 1 the ranked straggler
    _, h_sched, _ = fit(
        Strategy(sync="bsp", backup=1, workers=4, lr=0.05, backend=backend),
        6, plan="slow:w1x10@0")
    assert all(h["dropped"] == [1] for h in h_sched)
    # measured: worker 1's data source is slow; after the 2-step warmup
    # the EMA ranking takes over from the schedule
    eng = build(sync="bsp", backup=1, workers=4, lr=0.05, detect=True,
                backend=backend)
    _, h_det, _ = eng.run(p0(), make_batches(slow_worker=1, delay=0.05), 6)
    assert [h["dropped"] for h in h_det][:2] == [[3], [3]]   # warmup rank
    assert [h["dropped"] for h in h_det[2:]] == \
        [h["dropped"] for h in h_sched[2:]]
    assert np.argmax(eng.inner.detector.factors()) == 1
    assert eng.metrics()["dropped_updates"] == 6


# ------------------------------------------------------ SIGTERM preemption
CHILD = r"""
import sys, time
import torch
from repro_torch.train import Strategy, Trainer, value_and_grad
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "the child imports only the port"
torch.set_num_threads(1)
W_TRUE = torch.randn(8, 1, generator=torch.Generator().manual_seed(0))
def batches(t, w):
    time.sleep(0.15)
    X = torch.randn(16, 8, generator=torch.Generator().manual_seed(
        t * 100 + w))
    return {"X": X, "y": X @ W_TRUE}
grad_fn = value_and_grad(
    lambda p, b: (((b["X"] @ p["W"] - b["y"]) ** 2).mean(), {}))
p, h, m = Trainer(Strategy(sync="bsp", workers=2, lr=0.05, backend="sim"),
                  device="cpu").fit(grad_fn, {"W": torch.zeros(8, 1)},
                                    batches, 200, plan="",
                                    checkpoint_dir=sys.argv[1],
                                    checkpoint_every=1)
print("PREEMPTED" if m["preempted"] else "FINISHED",
      m["preempt_step"], flush=True)
"""


def test_sigterm_snapshot_and_resume(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path)],
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        # wait until the child has committed at least one cadence save
        deadline = time.time() + 60
        while latest_checkpoint(str(tmp_path)) is None:
            assert time.time() < deadline, "child never checkpointed"
            assert proc.poll() is None, "child died early"
            time.sleep(0.25)
        time.sleep(1.5)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "PREEMPTED" in out

    ck = latest_checkpoint(str(tmp_path))
    preempt_step = int(ck.rsplit("_", 1)[1])
    assert preempt_step > 0

    # resume picks up the preemption snapshot and runs to completion
    p, h, m = fit_elastic(
        Strategy(sync="bsp", workers=2, lr=0.05, backend="sim"), grad_fn,
        {"W": torch.zeros(8, 1)}, make_batch, preempt_step + 5, "",
        checkpoint_dir=str(tmp_path), resume=True, device="cpu")
    assert m["resumed_from"] == preempt_step
    assert not m["preempted"]
    assert len(h) == 5                   # only the remaining steps ran
    assert all(np.isfinite(x["loss"]) for x in h)


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    p, h, m = fit_elastic(
        Strategy(sync="bsp", workers=2, lr=0.05, backend="sim"), grad_fn,
        p0(), make_batch, 4, "", checkpoint_dir=str(tmp_path), resume=True,
        device="cpu")
    assert m["resumed_from"] is None and len(h) == 4


@pytest.mark.parametrize("backend", BACKENDS)
def test_resume_does_not_refire_consumed_events(tmp_path, backend):
    """The crash at step 6 rolls back to the step-4 checkpoint; the
    consumed record in the checkpoint (not the resume step) keeps a
    resumed incarnation from firing it twice."""
    strat = Strategy(sync="bsp", workers=4, lr=0.05, backend=backend)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2,
              device="cpu")
    p, h, m = fit_elastic(strat, grad_fn, p0(), make_batch, 8,
                          "crash:w1@6", **kw)
    assert len(m["recoveries"]) == 1 and m["final_workers"] == 3
    p2, h2, m2 = fit_elastic(strat, grad_fn, p0(), make_batch, 10,
                             "crash:w1@6", resume=True, **kw)
    assert m2["resumed_from"] is not None
    assert m2["recoveries"] == []
    assert m2["final_workers"] == 3


def test_resume_then_rollback_does_not_duplicate_history(tmp_path):
    strat = Strategy(sync="bsp", workers=4, lr=0.05, backend="device")
    fit_elastic(strat, grad_fn, p0(), make_batch, 7, "",
                checkpoint_dir=str(tmp_path), checkpoint_every=3,
                device="cpu")
    p, h, m = fit_elastic(strat, grad_fn, p0(), make_batch, 10,
                          "crash:w1@8", checkpoint_dir=str(tmp_path),
                          checkpoint_every=100, resume=True, device="cpu")
    assert m["resumed_from"] == 6
    (r,) = m["recoveries"]
    assert r["restored_step"] == 6
    assert [e["step"] for e in h] == list(range(6, 10))   # no duplicates


# -------------------------------------------------- incremental snapshots
def test_incremental_save_links_unchanged_shards_and_restores_bitwise(
        tmp_path):
    tree = {"a": torch.arange(64, dtype=torch.float32),
            "b": torch.ones(32), "c": torch.full((16,), 7, dtype=torch.int32)}
    base = str(tmp_path / "step_000001")
    save_checkpoint(base, tree, step=1, shard_bytes=200, hash_leaves=True)
    tree2 = dict(tree, a=tree["a"] + 1)
    nxt = str(tmp_path / "step_000002")
    m2 = save_checkpoint(nxt, tree2, step=2, shard_bytes=200,
                         incremental_from=base)
    assert m2["shards"] > 1
    assert 1 <= m2["linked_shards"] < m2["shards"]
    import shutil
    shutil.rmtree(base)
    got, step = load_checkpoint(nxt, tree2)
    assert step == 2
    assert_trees_equal(got, tree2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_elastic_cadence_saves_are_incremental_and_bitwise(tmp_path,
                                                           backend):
    """An SSP run's idle worker leaves its pulled copy unchanged between
    cadence snapshots, so that shard hash-skips, and a restore from an
    incremental snapshot is bitwise equal to the exported state."""
    strat = Strategy(sync="ssp", staleness=5, workers=4, lr=0.05,
                     periods=(1, 1, 1, 97), backend=backend)
    eng = strat.build(grad_fn, device="cpu")
    st = eng.init(p0())
    paths = []
    for t in range(3):
        st, _ = eng.step(st, make_batch, t)
        p = str(tmp_path / f"step_{t:06d}")
        save_engine_state(p, eng, st, t, 0, shard_bytes=64,
                          incremental_from=(paths[-1] if paths else None))
        paths.append(p)
    assert read_manifest(paths[-1])["linked_shards"] >= 1
    eng2 = strat.build(grad_fn, device="cpu")
    assert latest_checkpoint(str(tmp_path)) == paths[-1]
    st2, meta = restore_engine_state(paths[-1], eng2, p0())
    assert_trees_equal(eng.export_state(st)[0], eng2.export_state(st2)[0])


# ----------------------------------------------------- scheduler ↔ trainer
def test_stream_assignment_identity_shrink_grow():
    assert stream_assignment(4, 4) == [[0], [1], [2], [3]]
    shrunk = stream_assignment(4, 2)
    assert len(shrunk) == 2
    assert sorted(s for part in shrunk for s in part) == [0, 1, 2, 3]
    assert stream_assignment(2, 4) == [[0], [1], [0], [1]]


@pytest.mark.parametrize("n,m,seed", [(4, 4, 0), (4, 2, 0), (8, 3, 5),
                                      (2, 4, 0), (7, 1, 3), (6, 4, 11)])
def test_stream_assignment_matches_jax(n, m, seed):
    assert stream_assignment(n, m, seed) == \
        jax_partition.stream_assignment(n, m, seed)


def test_partitions_match_jax():
    X, y = partition.make_classification_data(400, 6, 5, seed=3)
    jX, jy = jax_partition.make_classification_data(400, 6, 5, seed=3)
    assert X.dtype == jX.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    for ours, ref in (
            (partition.iid_partition(400, 7, seed=2),
             jax_partition.iid_partition(400, 7, seed=2)),
            (partition.dirichlet_partition(y, 6, alpha=0.3, seed=1),
             jax_partition.dirichlet_partition(jy, 6, alpha=0.3, seed=1)),
            (partition.dirichlet_partition(y[:20], 9, alpha=0.05, seed=4,
                                           min_per_client=2),
             jax_partition.dirichlet_partition(jy[:20], 9, alpha=0.05,
                                               seed=4, min_per_client=2))):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert partition.label_skew(ours, y) == \
            jax_partition.label_skew(ref, jy)


def test_plan_from_sched_trace_matches_jax():
    res = simulate(make_trace(12, 8, seed=3, mean_interarrival=20.0),
                   Cluster(n_nodes=2, gpus_per_node=4), policy="fifo",
                   gandiva=True, elastic=True)
    jres = jax_simulate(jax_make_trace(12, 8, seed=3, mean_interarrival=20.0),
                        JaxCluster(n_nodes=2, gpus_per_node=4),
                        policy="fifo", gandiva=True, elastic=True)
    specs = []
    for jid in range(12):
        for kw in (dict(steps_per_sec=0.005),
                   dict(steps_per_sec=0.05, nominal_gpus=4)):
            ours = plan_from_sched_trace(res.trace, jid, **kw)
            # the port's adapter reads the reference's TraceEvents too
            assert plan_from_sched_trace(jres.trace, jid, **kw).spec() == \
                ours.spec() == jax_plan_from_sched_trace(jres.trace, jid,
                                                         **kw).spec()
            specs.append(ours.spec())
    assert any(specs)


def test_sched_trace_and_adapter_drive_training(tmp_path):
    jobs = make_trace(12, 8, seed=3, mean_interarrival=20.0)
    res = simulate(jobs, Cluster(n_nodes=2, gpus_per_node=4),
                   policy="fifo", gandiva=True, elastic=True)
    assert {"start", "suspend", "resume", "finish"} <= \
        {e.kind for e in res.trace}
    planned = [(j.jid, plan_from_sched_trace(res.trace, j.jid,
                                             steps_per_sec=0.005))
               for j in jobs]
    jid, plan = next((j, p) for j, p in planned if len(p))
    assert all(e.kind in ("restart", "resize") for e in plan)
    short = EventPlan([e for e in plan if e.step < 5][:1])
    assert len(short) == 1
    p, hist, mets = fit(Strategy(sync="ssp", workers=2, staleness=1,
                                 lr=0.05, backend="device"), 6, plan=short,
                        checkpoint_dir=str(tmp_path))
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert len(mets["recoveries"]) + mets["resizes"] == 1


def test_adapter_emits_resize_for_shrunk_start():
    trace = [TraceEvent(0.0, 7, "start", 2),
             TraceEvent(100.0, 7, "suspend", 2),
             TraceEvent(120.0, 7, "resume", 4),
             TraceEvent(400.0, 7, "finish", 4)]
    plan = plan_from_sched_trace(trace, 7, steps_per_sec=0.05,
                                 nominal_gpus=4)
    assert plan.spec() == "resize:2@0,resize:4@5"
    assert plan_from_sched_trace(trace, 7, steps_per_sec=0.05).spec() == \
        "resize:4@5"
    assert ElasticEvent(step=5, kind="resize", workers=4) in plan.events


def test_elastic_allocation_can_shrink():
    jobs = make_trace(16, 8, seed=1, mean_interarrival=5.0)
    el = simulate(jobs, Cluster(n_nodes=1, gpus_per_node=4),
                  policy="fifo", elastic=True)
    requested = {j.jid: j.num_gpus for j in jobs}
    shrunk = [e for e in el.trace if e.kind == "start"
              and e.gpus < requested[e.jid]]
    assert shrunk, "elastic allocation never shrank a job"
    assert all(e.gpus & (e.gpus - 1) == 0 for e in shrunk)
    assert {e.jid for e in el.trace if e.kind == "finish"} == set(requested)


# ------------------------------------------------- parity with the reference
PARITY = [("ssp:2/allreduce/onebit@4", "crash:w1@6"),
          ("ssp:2/allreduce/onebit@4", "resize:2@4,resize:4@8"),
          ("ssp:2/allreduce/onebit@4", "restart@3"),
          ("ssp:2/allreduce/onebit@4", "slow:w0x4@2"),
          ("bsp+backup:1/allreduce/none@4", "slow:w0x4@2,crash:w1@5"),
          ("bsp+backup:1/allreduce/onebit@4", "slow:w0x4@2,crash:w1@5")]
_JAX_RUNS = {}


def _jax_run(spec, plan, tmp, monkeypatch):
    """``repro``'s simulator run, with its snapshots written in the
    foreground: its ``export_state`` hands out the state's own lists
    (``comp_states``, ``pulled``), which the next step rebinds item by
    item while a background write may still be reading them, so under
    load a cadence snapshot can mix two steps (a fault of the reference,
    ROADMAP queue C).  The bytes of an unraced write are the same."""
    if (spec, plan) not in _JAX_RUNS:
        save = jax_recovery.save_engine_state
        monkeypatch.setattr(jax_recovery, "save_engine_state",
                            lambda *a, **k: save(*a, **dict(
                                k, background=False)))
        _JAX_RUNS[spec, plan] = JaxTrainer(JaxStrategy.parse(
            spec, lr=0.05, backend="sim")).fit(
                jax_grad_fn, JAX_P0, jax_make_batch, 10, plan=plan,
                checkpoint_dir=str(tmp), checkpoint_every=2)
    return _JAX_RUNS[spec, plan]


def _record(h):
    return (h["step"], h.get("worker"), h["max_staleness"], h.get("dropped"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("spec,plan", PARITY)
def test_fit_plan_matches_jax_sim(tmp_path, monkeypatch, spec, plan,
                                  backend):
    jp, jh, jm = _jax_run(spec, plan, tmp_path / "jax", monkeypatch)
    p, h, m = fit(Strategy.parse(spec, lr=0.05, backend=backend), 10,
                  plan=plan, checkpoint_dir=str(tmp_path / "port"),
                  checkpoint_every=2)
    assert [_record(x) for x in h] == [_record(x) for x in jh]
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(h, jh)) <= 1e-4
    strip = lambda rs: [{k: v for k, v in r.items() if k != "wall_s"}  # noqa
                        for r in rs]
    assert strip(m["recoveries"]) == strip(jm["recoveries"])
    for key in ("resizes", "executed_steps", "final_workers",
                "dropped_updates"):
        assert m[key] == jm[key], key
    for name in ("W", "b"):
        np.testing.assert_allclose(p[name].numpy(), np.asarray(jp[name]),
                                   rtol=0, atol=1e-4)
