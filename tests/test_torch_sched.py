"""The port's multi-tenant scheduler (``repro_torch.sched``) against the JAX
package's (``repro.sched``), on the CPU.

* The cases of tests/test_sched.py on the port, parametrised over the
  policies where the reference loops or picks one.
* ``make_trace`` equal to the reference's field for field.
* ``simulate``: every ``SimResult`` field and the allocation trace equal
  to the reference's exactly, for every policy with and without gandiva
  and elastic, on ``benchmarks/scheduler_bench.py``'s trace
  (``make_trace(80, 16, seed=7, mean_interarrival=8.0)`` on 2 x 8 GPUs).
* The serving autoscaler (``serve/autoscale.py``), the scheduler's other
  producer of allocation traces: the cases of tests/test_serving.py and
  tests/test_obs_analyze.py, and ``schedule``, ``to_trace``, ``plan``,
  ``replicas_at``, ``simulate_queue``, ``serve_job`` and the
  ``RateEstimator`` equal to the reference's; the ``autoscale_decision``
  instants and the sched stream ``plan`` emits equal byte for byte with
  the wall stripped.
"""
import dataclasses

import pytest

from repro.obs import trace as jax_obs_trace
from repro.sched import Cluster as JaxCluster
from repro.sched import make_trace as jax_make_trace
from repro.sched import simulate as jax_simulate
from repro.serve import autoscale as jax_autoscale
from repro_torch.obs import trace as obs_trace
from repro_torch.sched import (POLICIES, Cluster, SimResult, TraceEvent,
                               make_trace, simulate)
from repro_torch.sched.policies import GANDIVA_SLICE
from repro_torch.serve.autoscale import (AutoscalePolicy, Autoscaler,
                                         RateEstimator, ScaleDecision,
                                         poisson_trace, replicas_at,
                                         serve_job, simulate_queue)


def loaded_trace():
    # many jobs, short interarrival -> real queueing
    return make_trace(60, 16, seed=3, mean_interarrival=10.0)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_all_jobs_finish(policy):
    r = simulate(loaded_trace(), Cluster(n_nodes=2, gpus_per_node=8),
                 policy=policy)
    assert r.makespan > 0
    assert r.avg_jct < float("inf")


def test_srtf_beats_fifo_on_jct():
    jobs = loaded_trace()
    fifo = simulate(jobs, Cluster(n_nodes=2, gpus_per_node=8), policy="fifo")
    srtf = simulate(jobs, Cluster(n_nodes=2, gpus_per_node=8), policy="srtf")
    assert srtf.avg_jct <= fifo.avg_jct * 1.05


def test_gandiva_timeslicing_improves_t90():
    jobs = loaded_trace()
    base = simulate(jobs, Cluster(n_nodes=2, gpus_per_node=8), policy="fifo")
    gand = simulate(jobs, Cluster(n_nodes=2, gpus_per_node=8), policy="fifo",
                    gandiva=True)
    assert gand.mean_t90 <= base.mean_t90 * 1.10


def test_locality_penalty_applied():
    c = Cluster(n_nodes=2, gpus_per_node=4, cross_node_penalty=1.5)
    assert c.try_alloc(0, 2) == 1.0          # fits one node
    assert c.try_alloc(1, 6) == 1.5          # must spread across nodes
    assert c.try_alloc(2, 1) is None         # cluster full
    c.release(0)
    c.release(1)
    assert c.free_gpus == 8


def test_job_loss_curve_monotone():
    j = make_trace(5, 8, seed=0)[0]
    losses = [j.loss_at(e) for e in range(10)]
    assert all(a >= b for a, b in zip(losses, losses[1:]))
    # diminishing returns: first epoch improves more than the ninth
    assert (losses[0] - losses[1]) > (losses[8] - losses[9])


@pytest.mark.parametrize("args", [(5, 8, 0, 60.0), (80, 16, 7, 8.0),
                                  (12, 8, 3, 20.0), (60, 16, 3, 10.0)])
def test_make_trace_matches_jax(args):
    n, gpus, seed, gap = args
    ours = make_trace(n, gpus, seed=seed, mean_interarrival=gap)
    ref = jax_make_trace(n, gpus, seed=seed, mean_interarrival=gap)
    assert [dataclasses.astuple(j) for j in ours] == \
        [dataclasses.astuple(j) for j in ref]


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("gandiva", [False, True])
@pytest.mark.parametrize("elastic", [False, True])
def test_simulate_matches_jax(policy, gandiva, elastic):
    ours = simulate(make_trace(80, 16, seed=7, mean_interarrival=8.0),
                    Cluster(n_nodes=2, gpus_per_node=8), policy=policy,
                    gandiva=gandiva, elastic=elastic)
    ref = jax_simulate(jax_make_trace(80, 16, seed=7, mean_interarrival=8.0),
                       JaxCluster(n_nodes=2, gpus_per_node=8), policy=policy,
                       gandiva=gandiva, elastic=elastic)
    assert isinstance(ours, SimResult)
    assert all(isinstance(e, TraceEvent) for e in ours.trace)
    fields = [f.name for f in dataclasses.fields(SimResult)]
    assert fields == [f.name for f in dataclasses.fields(type(ref))]
    for name in fields:
        if name != "trace":
            assert getattr(ours, name) == getattr(ref, name), name
    assert [tuple(e) for e in ours.trace] == [tuple(e) for e in ref.trace]
    assert TraceEvent._fields == type(ref.trace[0])._fields
    kinds = {e.kind for e in ours.trace}
    assert ("suspend" in kinds) == gandiva


def test_gandiva_quantum_matches_jax():
    from repro.sched.policies import GANDIVA_SLICE as JAX_SLICE
    assert GANDIVA_SLICE == JAX_SLICE
    for quantum in (15.0, 240.0):
        ours = simulate(make_trace(30, 8, seed=5, mean_interarrival=12.0),
                        Cluster(n_nodes=1, gpus_per_node=8), "slaq",
                        gandiva=True, quantum=quantum, elastic=True)
        ref = jax_simulate(jax_make_trace(30, 8, seed=5,
                                          mean_interarrival=12.0),
                           JaxCluster(n_nodes=1, gpus_per_node=8), "slaq",
                           gandiva=True, quantum=quantum, elastic=True)
        assert dataclasses.astuple(ours)[:-1] == dataclasses.astuple(ref)[:-1]
        assert [tuple(e) for e in ours.trace] == [tuple(e) for e in ref.trace]


# ------------------------------------------------------------ autoscaler
def test_autoscaler_tracks_load_and_cuts_queueing():
    arrivals = poisson_trace(rate=2.0, horizon=60.0, seed=0)
    pol = AutoscalePolicy(replica_rate=0.5, min_replicas=1, max_replicas=8,
                          interval=5.0, scale_down_patience=2)
    plan, decisions = Autoscaler(pol, jid=3).plan(arrivals, horizon=60.0,
                                                  steps_per_sec=2.0)
    assert decisions[0].replicas == 1
    assert max(d.replicas for d in decisions) > 1       # scaled up
    assert any(e.kind == "resize" for e in plan)        # sched->elastic
    fixed = [ScaleDecision(0.0, 0.0, 1)]
    q_fixed = simulate_queue(arrivals, fixed, service_time=1.0, horizon=60.0)
    q_auto = simulate_queue(arrivals, decisions, service_time=1.0,
                            horizon=60.0)
    assert q_auto["p99_wait"] < q_fixed["p99_wait"]


def test_autoscaler_scale_down_hysteresis():
    """A burst then silence: scale-up is immediate, scale-down waits out
    ``scale_down_patience`` decision intervals."""
    arrivals = [float(t) * 0.1 for t in range(100)]     # 10 req/s for 10s
    pol = AutoscalePolicy(replica_rate=2.0, min_replicas=1, max_replicas=8,
                          interval=5.0, scale_down_patience=2)
    decisions = Autoscaler(pol, jid=0, window=10.0).schedule(arrivals, 40.0)
    ups = [d for d in decisions if d.replicas > 1]
    assert ups and ups[0].t <= 10.0
    downs = [d for d in decisions if d.replicas == 1 and d.t > 0]
    assert downs and downs[0].t >= 20.0     # not at the first quiet tick


def test_autoscaler_burn_times_force_scale_up():
    pol = AutoscalePolicy(replica_rate=100.0, min_replicas=1,
                          max_replicas=4, interval=5.0,
                          scale_down_patience=2)
    # no arrivals: the rate signal alone never scales up
    quiet = Autoscaler(pol).schedule([], horizon=20.0)
    assert [d.replicas for d in quiet] == [1]
    with obs_trace.tracing() as rec:
        burned = Autoscaler(pol).schedule([], horizon=20.0,
                                          burn_times=[7.0])
    # the burn lands in the (5, 10] decision interval -> forced +1;
    # patience then walks it back down two intervals later
    assert [(d.t, d.replicas) for d in burned] == [
        (0.0, 1), (10.0, 2), (20.0, 1)]
    ups = [ev for ev in rec.events
           if ev["name"] == "autoscale_decision"
           and ev["args"].get("reason") == "slo_burn"]
    assert len(ups) == 1 and ups[0]["args"]["to_replicas"] == 2


def test_rate_estimator_matches_jax():
    ours, ref = RateEstimator(4.0), jax_autoscale.RateEstimator(4.0)
    arrivals = poisson_trace(3.0, 20.0, seed=4)
    for t in arrivals:
        ours.observe(t)
        ref.observe(t)
    for now in (0.0, 1.5, 4.0, 9.25, 20.0, 30.0):
        assert ours.rate(now) == ref.rate(now)


AUTOSCALE_CASES = [
    # (rate, horizon, seed, policy kwargs, burn_times, steps_per_sec)
    (2.0, 60.0, 0, dict(replica_rate=0.5), None, 2.0),
    (0.6, 30.0, 0, dict(replica_rate=0.5), [7.0, 21.5], 1.0),
    (5.0, 45.0, 3, dict(replica_rate=1.5, max_replicas=4, interval=2.5,
                        scale_down_patience=3), [12.0], 0.5),
    (0.2, 40.0, 1, dict(replica_rate=100.0, max_replicas=4),
     [7.0, 8.0, 33.0], 1.0)]


def _jax_autoscale(rate, horizon, seed, kw, burns, sps):
    arrivals = jax_autoscale.poisson_trace(rate, horizon, seed=seed)
    scaler = jax_autoscale.Autoscaler(jax_autoscale.AutoscalePolicy(**kw),
                                      jid=5)
    with jax_obs_trace.tracing() as rec:
        plan, decisions = scaler.plan(arrivals, horizon, steps_per_sec=sps,
                                      burn_times=burns)
    return arrivals, scaler, plan, decisions, rec.to_chrome()


@pytest.mark.parametrize("case", range(len(AUTOSCALE_CASES)))
def test_autoscaler_matches_jax(case):
    rate, horizon, seed, kw, burns, sps = AUTOSCALE_CASES[case]
    j_arr, jscaler, jplan, jdec, jtrace = _jax_autoscale(*AUTOSCALE_CASES[case])
    arrivals = poisson_trace(rate, horizon, seed=seed)
    assert arrivals == j_arr
    scaler = Autoscaler(AutoscalePolicy(**kw), jid=5)
    with obs_trace.tracing() as rec:
        plan, decisions = scaler.plan(arrivals, horizon, steps_per_sec=sps,
                                      burn_times=burns)
    astuples = lambda ds: [dataclasses.astuple(d) for d in ds]  # noqa: E731
    assert astuples(decisions) == astuples(jdec)
    assert plan.spec() == jplan.spec()
    assert [tuple(e) for e in scaler.to_trace(decisions)] == \
        [tuple(e) for e in jscaler.to_trace(jdec)]
    assert Autoscaler(AutoscalePolicy(**kw)).schedule(
        arrivals, horizon, burn_times=burns) == decisions
    # the autoscale_decision instants and the sched allocation stream,
    # wall-stripped, byte for byte
    assert obs_trace.canonical_bytes(obs_trace.strip_wall(rec.to_chrome())) \
        == jax_obs_trace.canonical_bytes(jax_obs_trace.strip_wall(jtrace))
    assert any(ev["name"] == "autoscale_decision"
               for ev in rec.to_chrome()["traceEvents"])
    for t in (0.0, 5.0, 12.5, horizon):
        assert replicas_at(decisions, t) == jax_autoscale.replicas_at(jdec, t)
    for service in (0.5, 1.0, 3.0):
        for ds, jds in ((decisions, jdec), (decisions[:1], jdec[:1])):
            assert simulate_queue(arrivals, ds, service, horizon) == \
                jax_autoscale.simulate_queue(j_arr, jds, service, horizon)
    assert simulate_queue([], decisions, 1.0, horizon) == \
        jax_autoscale.simulate_queue([], jdec, 1.0, horizon)
    assert dataclasses.astuple(serve_job(5, horizon, 3, arrival=1.5)) == \
        dataclasses.astuple(jax_autoscale.serve_job(5, horizon, 3,
                                                    arrival=1.5))
