"""The port's observability plane against the JAX package's, on the CPU.

* The cases of ``tests/test_obs.py`` and ``tests/test_obs_analyze.py``
  that need neither ``sched/`` nor ``parallel/`` (recorder semantics, dual
  clocks, validation, metrics, the analysis layer, SLOs), on the port's
  modules; the sched bridge with stand-in allocation events.
* Exact, across packages: ``hop_model`` and the wall-stripped
  ``emit_trace`` bytes for every topology x codec, both architectures and
  both wire modes; the wall-stripped serve trace of
  ``benchmarks/serve_bench.py``'s traffic (both policies, contiguous and
  paged) on reduced TinyLlama with the JAX init's weights, with an
  ``ttft_p99<8`` monitor attached (``slo_alerts`` equal, and the
  ``BENCH_pr7.json`` virtual-clock columns); the launcher's 3-step train
  trace; ``analyze``, ``render`` and ``evaluate_trace`` of ``repro``'s
  traces; ``cache_bytes``.
* The device engine's traced BSP step: one ``compute`` span, one
  ``exchange`` span with the plan's buckets whose hop bytes sum to
  ``measured_step_tx_bytes``, the ``wire_bytes`` counter, and losses equal
  to the untraced run's.
"""
import collections
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.trace as jax_trace
from repro.comm.plan import CommPlan as JaxCommPlan
from repro.configs import get_config as jax_get_config
from repro.core.compression import Compressor as JaxCompressor
from repro.core.precision import PrecisionPolicy as JaxPrecisionPolicy
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import make_lm_batches as jax_make_lm_batches
from repro.models import build_model as jax_build_model
from repro.optim import OPTIMIZERS as JAX_OPTIMIZERS
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro.serve.autoscale import poisson_trace as jax_poisson_trace
from repro.serve.cache import cache_bytes as jax_cache_bytes
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.request import Request as JaxRequest
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro.train import train_loop as jax_train_loop
from repro_torch.comm.plan import CommPlan
from repro_torch.configs import get_config
from repro_torch.core.compression import Compressor
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params
from repro_torch.obs import (Histogram, MetricsRegistry, NullRecorder,
                             Objective, SLOMonitor, TraceRecorder, analyze,
                             emit_sched_trace, evaluate_trace, get_recorder,
                             load_trace, overlap_efficiency, percentile,
                             pipeline_accounting, request_latencies,
                             serve_summary, set_recorder, step_attribution,
                             strip_wall, tracing, validate_trace)
from repro_torch.obs.report import main as report_main
from repro_torch.obs.report import render
from repro_torch.obs.trace import canonical_bytes, find_spans
from repro_torch.serve.autoscale import poisson_trace
from repro_torch.serve.cache import cache_bytes
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request
from repro_torch.train import Strategy, value_and_grad

# repro.obs re-exports functions named like these modules
jax_analyze = importlib.import_module("repro.obs.analyze")
jax_report = importlib.import_module("repro.obs.report")
jax_slo = importlib.import_module("repro.obs.slo")

torch.set_num_threads(2)

_CACHE = {}


def setup():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        _CACHE.update(
            jcfg=jcfg, cfg=cfg, jmodel=jax_build_model(jcfg),
            jparams=jparams, model=build_model(cfg),
            params=from_jax_params(cfg, jax.tree.map(np.array, jparams)))
    return _CACHE


# ------------------------------------------------------------- recorder
def test_default_recorder_is_noop():
    rec = get_recorder()
    assert isinstance(rec, NullRecorder)
    assert rec.enabled is False
    assert rec.span("x", pid="p") is rec.span("y", tid="t")
    rec.begin("a")
    rec.end()
    rec.instant("i", foo=1)
    rec.counter("c", {"v": 1.0})


def test_tracing_installs_and_restores(tmp_path):
    before = get_recorder()
    path = tmp_path / "t.json"
    with tracing(str(path)) as rec:
        assert get_recorder() is rec
        with rec.span("outer", pid="p", tid="t", clock=("train_step", 0)):
            rec.instant("mark", pid="p", tid="t")
    assert get_recorder() is before
    stats = validate_trace(json.loads(path.read_bytes()))
    assert stats["spans"] == 1 and stats["instants"] == 1


def test_span_nesting_and_validation():
    rec = TraceRecorder()
    with rec.span("step", pid="train", tid="loop"):
        with rec.span("compute", pid="train", tid="loop"):
            pass
        with rec.span("exchange", pid="train", tid="loop"):
            rec.instant("hop", pid="train", tid="loop")
    stats = validate_trace(rec.to_chrome())
    assert stats["max_depth"] == 2 and stats["spans"] == 3
    with pytest.raises(ValueError):
        rec.end(pid="train", tid="loop")


def test_dual_clock_and_wall_strip():
    rec = TraceRecorder()
    rec.begin("step", pid="train", tid="loop", clock=("train_step", 7))
    rec.end(pid="train", tid="loop")
    tr = rec.to_chrome()
    b = find_spans(tr, "step")[0]
    assert b["args"]["clock_domain"] == "train_step"
    assert b["args"]["clock_t"] == 7
    assert "wall_s" in b["args"]
    stripped = strip_wall(tr)
    assert all("wall_s" not in ev["args"] for ev in stripped["traceEvents"])
    assert (canonical_bytes(strip_wall(json.loads(rec.to_bytes()))) ==
            rec.to_bytes(include_wall=False))


def test_trace_determinism_on_virtual_clock():
    def run():
        rec = TraceRecorder()
        for t in range(3):
            with rec.span("step", pid="train", tid="loop",
                          clock=("train_step", t), step=t):
                rec.counter("wire_bytes", {"cumulative": 10.0 * t},
                            pid="train", clock=("train_step", t))
        return rec.to_chrome()
    a, b = run(), run()
    assert canonical_bytes(strip_wall(a)) == canonical_bytes(strip_wall(b))


def test_set_recorder_restores_null():
    rec = TraceRecorder()
    prev = set_recorder(rec)
    try:
        assert get_recorder() is rec
    finally:
        set_recorder(prev)
    assert isinstance(get_recorder(), NullRecorder)


def test_validate_trace_counter_only():
    rec = TraceRecorder()
    for t in range(3):
        rec.counter("wire_bytes", {"cumulative": 10.0 * t}, pid="train",
                    clock=("train_step", t))
    stats = validate_trace(rec.to_chrome())
    assert stats["spans"] == 0 and stats["instants"] == 0
    assert stats["counters"] == 3 and stats["max_depth"] == 0
    assert stats["errors"] == [] and stats["names"] == ["wire_bytes"]


def test_validate_trace_lax_reports_not_raises():
    bad = {"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1, "args": {}},
        {"name": "a", "ph": "E", "ts": 5, "pid": 1, "tid": 1, "args": {}},
        {"name": "x", "ph": "i", "ts": 2, "pid": 1, "tid": 1, "args": {}},
        {"name": "z", "ph": "E", "ts": 6, "pid": 1, "tid": 2, "args": {}},
        {"name": "open", "ph": "B", "ts": 7, "pid": 1, "tid": 1,
         "args": {}},
    ]}
    with pytest.raises(ValueError):
        validate_trace(bad)
    stats = validate_trace(bad, strict=False)
    assert len(stats["errors"]) == 3
    assert any("backwards" in e for e in stats["errors"])
    assert any("E without B" in e for e in stats["errors"])
    assert any("unclosed" in e for e in stats["errors"])
    assert stats["spans"] == 1 and stats["instants"] == 1
    assert stats == jax_trace.validate_trace(bad, strict=False)


def test_validate_trace_not_a_trace():
    with pytest.raises(ValueError):
        validate_trace({"events": []})
    stats = validate_trace({"events": []}, strict=False)
    assert stats["errors"] and stats["events"] == 0


def test_trace_save_load_byte_roundtrip(tmp_path):
    rec = TraceRecorder()
    with rec.span("step", pid="train", tid="loop", clock=("train_step", 0)):
        rec.instant("mark", pid="train", tid="loop")
    p = tmp_path / "t.json"
    rec.save(str(p), include_wall=False)
    assert canonical_bytes(load_trace(str(p))) == \
        rec.to_bytes(include_wall=False)
    p2 = tmp_path / "t_wall.json"
    rec.save(str(p2), include_wall=True)
    assert (canonical_bytes(strip_wall(load_trace(str(p2)))) ==
            rec.to_bytes(include_wall=False))


def test_recorders_serialize_alike():
    """The same calls on each package's recorder give the same bytes."""
    def record(mod):
        rec = mod.TraceRecorder()
        with rec.span("step", pid="train", tid="loop",
                      clock=("train_step", 0), step=0):
            rec.instant("hop", pid="train", tid="loop", tx_bytes=1.5,
                        kind="rs")
            rec.counter("wire_bytes", {"cumulative": 3}, pid="train",
                        cat="comm", clock=("train_step", 0))
        return rec.to_bytes(include_wall=False)
    assert record(jax_trace) == record(__import__(
        "repro_torch.obs.trace", fromlist=["TraceRecorder"]))


# ---------------------------------------------------------- sched bridge
def test_emit_sched_trace_spans_and_truncation():
    Ev = collections.namedtuple("Ev", "t jid kind gpus")
    events = [Ev(0.0, 1, "start", 2), Ev(5.0, 1, "suspend", 2),
              Ev(6.0, 1, "resume", 4), Ev(9.0, 1, "finish", 4),
              Ev(2.0, 2, "start", 1)]                # never finishes
    rec = TraceRecorder()
    emit_sched_trace(rec, events)
    tr = rec.to_chrome()
    stats = validate_trace(tr)
    assert stats["spans"] == 3 and stats["instants"] == 5
    last = [ev for ev in tr["traceEvents"] if ev.get("ph") == "E"][-1]
    assert last["args"].get("truncated") is True
    jrec = jax_trace.TraceRecorder()
    jax_trace.emit_sched_trace(jrec, events)
    assert jrec.to_bytes(include_wall=False) == \
        rec.to_bytes(include_wall=False)
    emit_sched_trace(NullRecorder(), events)         # disabled: no-op


# -------------------------------------------------------------- metrics
def test_percentile_edges():
    assert np.isnan(percentile([], 50))
    assert percentile([3.0], 0) == percentile([3.0], 100) == 3.0
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0 and percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == 3.0
    with pytest.raises(ValueError):
        percentile(xs, 101)
    with pytest.raises(ValueError):
        percentile(xs, -1)


def test_percentile_is_shared():
    from repro_torch.serve import request as req
    assert req.percentile is percentile


def test_metrics_registry_aggregation(tmp_path):
    m = MetricsRegistry()
    m.counter("steps").inc()
    m.counter("steps").inc(4)
    m.gauge("workers").set(8)
    for v in [1.0, 2.0, 3.0, 10.0]:
        m.histogram("lat").observe(v)
    snap = m.snapshot()
    assert snap["steps"]["value"] == 5 and snap["workers"]["value"] == 8
    assert snap["lat"]["count"] == 4 and snap["lat"]["sum"] == 16.0
    assert snap["lat"]["p50"] == 3.0
    with pytest.raises(ValueError):
        m.gauge("steps")
    with pytest.raises(ValueError):
        m.counter("steps").inc(-1)
    path = tmp_path / "m.jsonl"
    m.export_jsonl(str(path), run="r0")
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert {r["metric"] for r in rows} == {"steps", "workers", "lat"}
    assert all(r["run"] == "r0" for r in rows)


def test_metrics_jsonl_equals_jax():
    from repro.obs.metrics import MetricsRegistry as JaxMetricsRegistry
    lines = []
    for reg in (MetricsRegistry(), JaxMetricsRegistry()):
        reg.counter("c").inc(3)
        reg.gauge("g").set(2.5)
        h = reg.histogram("h", max_samples=16)
        for v in range(200):
            h.observe(float(v * 13 % 97))
        lines.append(reg.to_jsonl(run="x"))
    assert lines[0] == lines[1]


def test_histogram_exact_below_cap():
    h = Histogram(max_samples=10)
    for v in [5.0, 1.0, 3.0]:
        h.observe(v)
    assert h.count == 3 and h.sum == 9.0 and h.percentile(50) == 3.0
    snap = h.snapshot()
    assert "retained" not in snap
    assert snap["min"] == 1.0 and snap["max"] == 5.0


def test_histogram_bounded_above_cap():
    h = Histogram(max_samples=8)
    for v in range(100):
        h.observe(float(v))
    assert len(h.samples) == 8 and h.count == 100
    assert h.sum == float(sum(range(100)))
    snap = h.snapshot()
    assert snap["min"] == 0.0 and snap["max"] == 99.0
    assert snap["mean"] == pytest.approx(49.5) and snap["retained"] == 8.0
    assert all(s in [float(v) for v in range(100)] for s in h.samples)


def test_histogram_reservoir_deterministic():
    def fill():
        h = Histogram(max_samples=16)
        for v in range(500):
            h.observe(float(v * 7 % 101))
        return h
    a, b = fill(), fill()
    assert a.samples == b.samples and a.snapshot() == b.snapshot()


def test_histogram_cap_validation_and_registry():
    with pytest.raises(ValueError):
        Histogram(max_samples=0)
    m = MetricsRegistry()
    h = m.histogram("lat", max_samples=4)
    assert h.max_samples == 4 and m.histogram("lat") is h


# ------------------------------------------------------------ comm plan
TOPOLOGIES = ("ring", "psum", "butterfly", "tree", "fully_connected")
CODECS = ("none", "onebit", "terngrad", "qsgd", "dgc")
SHAPES = {"a": (64, 8), "b": (130,), "c": (3, 5, 7)}


def _plans(topology, codec, n, wire):
    kw = dict(n=n, topology=topology, wire=wire, bucket_mb=1e-3)
    jplan = JaxCommPlan.plan({k: jnp.zeros(s) for k, s in SHAPES.items()},
                             axis="w", compressor=JaxCompressor(codec), **kw)
    plan = CommPlan.plan([SHAPES[k] for k in sorted(SHAPES)],
                         compressor=Compressor(codec), **kw)
    return jplan, plan


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hop_model_and_emit_trace_match_jax(topology, codec):
    for n in (2, 4, 8):
        for wire in ("modeled", "measured"):
            jplan, plan = _plans(topology, codec, n, wire)
            assert plan.buckets == jplan.buckets and \
                plan.order == jplan.order
            assert plan.word_bytes == jplan.word_bytes == 4
            for arch in ("allreduce", "ps"):
                for b in range(len(plan.buckets)):
                    assert plan.hop_model(b, arch) == \
                        jplan.hop_model(b, arch), (n, wire, arch, b)
                rec, jrec = TraceRecorder(), jax_trace.TraceRecorder()
                plan.emit_trace(rec, arch=arch, clock=("train_step", 3))
                jplan.emit_trace(jrec, arch=arch, clock=("train_step", 3))
                got = rec.to_bytes(include_wall=False)
                assert got == jrec.to_bytes(include_wall=False)
                tr = rec.to_chrome()
                validate_trace(tr)
                per_bucket = [sum(x for _, x in plan.hop_model(b, arch))
                              for b in range(len(plan.buckets))]
                assert int(sum(per_bucket)) == \
                    plan.measured_step_tx_bytes(arch)
                hops = sum(ev["args"]["tx_bytes"] for ev in tr["traceEvents"]
                           if ev.get("name") == "hop")
                assert hops == pytest.approx(sum(per_bucket), abs=0.01)


def test_commplan_ps_hop_model():
    plan = CommPlan.plan([(64, 8)], n=4, topology="ring",
                         compressor=Compressor("onebit"), wire="measured",
                         bucket_mb=1.0)
    hops = plan.hop_model(0, arch="ps")
    assert [k for k, _ in hops] == ["rs"] * 3 + ["ag"] * 3
    assert int(sum(x for _, x in hops)) == plan.measured_step_tx_bytes("ps")
    assert plan.hop_model(0) and CommPlan.plan(
        [(64, 8)], n=1).hop_model(0) == []
    plan.emit_trace(NullRecorder())                  # disabled: no-op


def test_commplan_stamps_modeled_bounds():
    plan = CommPlan.plan(list(SHAPES.values()), n=4, topology="ring",
                         compressor=Compressor("onebit"), wire="measured",
                         bucket_mb=1e-4)
    rec = TraceRecorder()
    plan.emit_trace(rec, clock=("train_step", 0))
    ov = overlap_efficiency(rec.to_chrome())
    assert ov is not None and ov["all_in_bounds"]
    ex = ov["exchanges"][0]
    assert ex["tictac_overlap_us"] <= ex["no_overlap_us"]
    assert 0.0 <= ex["efficiency"] <= 1.0


# --------------------------------------------------------- attribution
def _train_trace():
    rec = TraceRecorder()
    with rec.span("step", pid="train", tid="loop", clock=("train_step", 0)):
        with rec.span("compute", pid="train", tid="loop"):
            pass
        with rec.span("exchange", pid="train", tid="loop"):
            pass
    with rec.span("snapshot", pid="elastic", tid="events"):
        pass
    with rec.span("step", pid="train", tid="loop", clock=("train_step", 1)):
        with rec.span("compute", pid="train", tid="loop"):
            pass
        with rec.span("exchange", pid="train", tid="loop"):
            pass
    return strip_wall(rec.to_chrome())


def test_step_attribution_windows_and_residual():
    attr = step_attribution(_train_trace())
    assert attr["basis"] == "ticks"
    s0, s1 = attr["steps"]
    assert s0["total"] == 5.0 and s0["compute"] == 1.0 and s0["comm"] == 1.0
    assert s0["snapshot"] == 0.0 and s0["stall"] == 3.0
    assert s1["total"] == 8.0 and s1["snapshot"] == 1.0
    assert s1["stall"] == 5.0
    for row in (s0, s1):
        assert row["attributed_pct"] == pytest.approx(100.0)
    assert attr["totals"]["total"] == 13.0
    assert sum(attr["fractions"].values()) == pytest.approx(1.0)
    assert attr == jax_analyze.step_attribution(_train_trace())


def test_step_attribution_wall_basis_when_present():
    rec = TraceRecorder()
    with rec.span("step", pid="train", tid="loop", clock=("train_step", 0)):
        with rec.span("compute", pid="train", tid="loop"):
            pass
    attr = step_attribution(rec.to_chrome())
    assert attr["basis"] == "wall"
    assert attr["attributed_pct_min"] == pytest.approx(100.0)


def test_step_attribution_none_without_steps():
    rec = TraceRecorder()
    rec.counter("wire_bytes", {"cumulative": 1.0}, pid="train")
    assert step_attribution(rec.to_chrome()) is None


def _exchange_trace(no, tictac, issue):
    rec = TraceRecorder()
    with rec.span("exchange", pid="train", tid="loop",
                  clock=("train_step", 0), n_buckets=3,
                  modeled_no_overlap_us=no,
                  modeled_tictac_overlap_us=tictac,
                  modeled_issue_overlap_us=issue):
        pass
    return rec.to_chrome()


def test_overlap_efficiency_bounds():
    ov = overlap_efficiency(_exchange_trace(100.0, 60.0, 70.0))
    assert ov["all_in_bounds"]
    assert ov["exchanges"][0]["efficiency"] == pytest.approx(0.75)
    assert not overlap_efficiency(
        _exchange_trace(100.0, 60.0, 120.0))["all_in_bounds"]
    assert not overlap_efficiency(
        _exchange_trace(100.0, 60.0, 40.0))["all_in_bounds"]
    ov = overlap_efficiency(_exchange_trace(50.0, 50.0, 50.0))
    assert ov["all_in_bounds"] and ov["exchanges"][0]["efficiency"] == 1.0
    rec = TraceRecorder()
    with rec.span("exchange", pid="train", tid="loop"):
        pass
    assert overlap_efficiency(rec.to_chrome()) is None


def test_pipeline_accounting_none_without_pipe():
    rec = TraceRecorder()
    with rec.span("step", pid="train", tid="loop"):
        pass
    assert pipeline_accounting(rec.to_chrome()) is None


def _lifecycle_trace(n=4, stalls=(1.0, 2.0)):
    """rid i arrives at 0, first token at 2+i, finishes at 8+i having
    generated 4 tokens -> ttft = 2+i, tpot = 2.0."""
    rec = TraceRecorder()
    for i in range(n):
        tid = f"req{i}"
        rec.begin("queued", pid="serve", tid=tid,
                  clock=("serve_iter", 0.0), rid=i, arrival=0.0)
        rec.end(pid="serve", tid=tid)
        rec.begin("prefill", pid="serve", tid=tid,
                  clock=("serve_iter", 1.0 + i), rid=i)
        rec.end(pid="serve", tid=tid)
        rec.begin("decode", pid="serve", tid=tid,
                  clock=("serve_iter", 2.0 + i), rid=i)
        rec.end(pid="serve", tid=tid, generated=4)
        rec.instant("done", pid="serve", tid=tid,
                    clock=("serve_iter", 8.0 + i), rid=i, generated=4)
    for t in stalls:
        rec.instant("admission_stall", pid="serve", tid="engine",
                    clock=("serve_iter", t))
    for t in range(12):
        rec.counter("slots", {"used": 1.0, "free": 3.0}, pid="serve",
                    clock=("serve_iter", float(t)))
    return rec.to_chrome()


def test_request_latencies_and_summary():
    tr = _lifecycle_trace()
    rows = request_latencies(tr)
    assert [r["ttft"] for r in rows] == [2.0, 3.0, 4.0, 5.0]
    assert all(r["tpot"] == pytest.approx(2.0) for r in rows)
    s = serve_summary(tr)
    assert s["requests"] == 4 and s["ttft_p99"] == 5.0
    assert s["admission_stalls"] == 2 and s["slo_burn_alerts"] == 0
    out = analyze(tr)
    assert out["validation"]["errors"] == []
    assert out["attribution"] is None and out["pipeline"] is None


def test_objective_parse():
    o = Objective.parse("ttft_p99<8")
    assert (o.metric, o.threshold) == ("ttft", 8.0)
    assert o.budget == pytest.approx(0.01)
    assert o.bad(8.5) and not o.bad(8.0)
    r = Objective.parse("stall_rate<=0.1")
    assert (r.metric, r.budget, r.threshold) == ("stall", 0.1, 0.0)
    assert Objective.parse("tpot_p50 < 1.5").threshold == 1.5
    for bad in ["ttft<8", "ttft_p0<8", "ttft_p100<8", "x_rate<0",
                "x_rate<1.5", "nonsense", "ttft_p99<"]:
        with pytest.raises(ValueError):
            Objective.parse(bad)


def test_slo_monitor_multiwindow_burn():
    mon = SLOMonitor(["ttft_p99<8"], long_window=10.0, short_window=2.0,
                     factor=2.0)
    for t in range(1, 11):
        mon.observe("ttft", float(t), 20.0)
    assert mon.firing(10.0)
    assert mon.evaluate(10.0)[0]["burn_long"] == pytest.approx(100.0)
    for t in range(11, 14):
        mon.observe("ttft", float(t), 1.0)
    row = mon.evaluate(13.0)[0]
    assert row["burn_long"] >= 2.0 and row["burn_short"] == 0.0
    assert not row["firing"]
    assert mon.evaluate(1000.0)[0]["firing"] is False
    with pytest.raises(ValueError):
        SLOMonitor([])


def test_evaluate_trace_fires_on_tight_slo_only():
    tr = _lifecycle_trace()
    kw = dict(long_window=16.0, short_window=4.0, factor=1.0)
    hot = evaluate_trace(tr, ["ttft_p99<2"], **kw)
    assert hot["alerts"][0]["objectives"] == ["ttft_p99<2"]
    assert not evaluate_trace(tr, ["ttft_p99<100"], **kw)["alerts"]
    assert hot["observations"] == 2 * 4 + 12
    assert hot == jax_slo.evaluate_trace(tr, ["ttft_p99<2"], **kw)


# -------------------------------------------------- serve, across packages
# benchmarks/serve_bench.py's traffic and engine knobs
BENCH_SLOTS, BENCH_MAX_LEN, BENCH_PROMPT = 4, 24, 5
BENCH_RATE, BENCH_HORIZON, BENCH_SEED = 0.6, 30.0, 0
# BENCH_pr7.json's tinyllama-1.1b serve rows (both layouts alike)
BENCH_PR7 = {"continuous": dict(p99_first_token=16.1775, clock=59.0,
                                generated_tokens=161, decode_iterations=43,
                                prefill_groups=16),
             "oneshot": dict(p99_first_token=37.1775, clock=80.0,
                             generated_tokens=161, decode_iterations=74,
                             prefill_groups=6)}
SLO = ["ttft_p99<8"]
_SERVE = {}


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


def _serve_runs(policy, page_size):
    """(jax trace, jax metrics, jax engine, port trace, port metrics,
    port engine, port outputs) of one serve_bench cell, traced, with the
    SLO monitor attached."""
    key = (policy, page_size)
    if key not in _SERVE:
        s = setup()
        kw = dict(slots=BENCH_SLOTS, max_len=BENCH_MAX_LEN,
                  page_size=page_size, policy=policy)
        jeng = JaxServeEngine(s["jmodel"], s["jparams"], JaxServeConfig(
            cache_dtype=jnp.float32, compute_dtype=jnp.float32, **kw),
            slo=jax_slo.SLOMonitor(SLO))
        with jax_trace.tracing() as jrec:
            jm = jeng.run(_bench_requests(JaxRequest, s["cfg"].vocab_size))
        reqs = _bench_requests(Request, s["cfg"].vocab_size)
        eng = ServeEngine(s["model"], s["params"], ServeConfig(**kw),
                          device="cpu", slo=SLOMonitor(SLO))
        with tracing() as rec:
            m = eng.run(reqs)
        _SERVE[key] = (jrec.to_chrome(), jm, jeng, rec.to_chrome(), m, eng,
                       [r.output for r in reqs])
    return _SERVE[key]


@pytest.mark.parametrize("page_size", [0, 4])
@pytest.mark.parametrize("policy", ["continuous", "oneshot"])
def test_serve_trace_matches_jax(policy, page_size):
    jtr, jm, jeng, tr, m, eng, _ = _serve_runs(policy, page_size)
    validate_trace(tr, strict=True)
    assert canonical_bytes(strip_wall(tr)) == canonical_bytes(strip_wall(jtr))
    assert eng.slo_alerts == jeng.slo_alerts
    assert m["slo_alerts"] == jm["slo_alerts"] == len(eng.slo_alerts)
    for k, v in BENCH_PR7[policy].items():
        got = round(m[k], 4) if isinstance(m[k], float) else m[k]
        assert got == v, k
    assert len(find_spans(tr, "queued")) == m["completed"] == 18
    assert eng._traced_rids == set()


@pytest.mark.parametrize("policy", ["continuous", "oneshot"])
def test_analysis_of_jax_serve_trace_equal(policy):
    jtr = _serve_runs(policy, 4)[0]
    assert analyze(jtr) == jax_analyze.analyze(jtr)
    assert render(jtr, slos=SLO) == jax_report.render(jtr, slos=SLO)
    assert evaluate_trace(jtr, SLO) == jax_slo.evaluate_trace(jtr, SLO)
    assert serve_summary(jtr)["kv_samples"] > 0


def test_traced_serve_tokens_equal_untraced():
    s = setup()
    *_, outs = _serve_runs("continuous", 4)
    reqs = _bench_requests(Request, s["cfg"].vocab_size)
    eng = ServeEngine(s["model"], s["params"], ServeConfig(
        slots=BENCH_SLOTS, max_len=BENCH_MAX_LEN, page_size=4),
        device="cpu")
    assert isinstance(get_recorder(), NullRecorder)
    eng.run(reqs)
    assert [r.output for r in reqs] == outs
    assert eng._traced_rids == set()


def test_serve_trace_pool_exhaustion_stalls():
    """An undersized page pool shows up on the trace: stall instants plus
    full lifecycles once pages free up."""
    s = setup()
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, s["cfg"].vocab_size, size=(4, 5))
    reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=6) for i in range(4)]
    eng = ServeEngine(s["model"], s["params"], ServeConfig(
        slots=4, max_len=16, page_size=4, num_pages=6), device="cpu")
    with tracing() as rec:
        m = eng.run(reqs)
    tr = rec.to_chrome()
    assert m["admission_stalls"] > 0
    stats = validate_trace(tr)
    stalls = [ev for ev in tr["traceEvents"]
              if ev.get("ph") == "i" and ev["name"] == "admission_stall"]
    assert stalls and all(ev["args"]["free_pages"] >= 0 for ev in stalls)
    for name in ("queued", "prefill", "decode"):
        assert len(find_spans(tr, name)) == 4
    kv = [ev for ev in tr["traceEvents"]
          if ev.get("ph") == "C" and ev["name"] == "kv_pages"]
    assert kv and all(ev["args"]["used"] + ev["args"]["free"] == 5
                      for ev in kv)
    assert "admission_stall" in stats["names"]


@pytest.mark.parametrize("page_size", [0, 4])
def test_cache_bytes_matches_jax(page_size):
    s = setup()
    kw = dict(slots=3, max_len=20, page_size=page_size)
    eng = ServeEngine(s["model"], s["params"], ServeConfig(**kw),
                      device="cpu")
    jeng = JaxServeEngine(s["jmodel"], s["jparams"], JaxServeConfig(
        cache_dtype=jnp.float32, compute_dtype=jnp.float32, **kw))
    assert cache_bytes(eng.kv.store) == jax_cache_bytes(jeng.kv.store) > 0


def test_serve_launcher_trace_report_slo(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    m = serve_launcher.main([
        "--smoke", "--device", "cpu", "--dtype", "f32", "--requests", "4",
        "--rate", "0.5", "--pages", "4", "--max-new", "3", "--trace", path,
        "--report", "--slo", "ttft_p99<8", "--slo", "stall_rate<0.5"])
    out = capsys.readouterr().out
    assert f"trace written to {path}" in out
    assert "serve: 4 requests" in out and "SLO evaluation" in out
    assert "slo alerts: 0" in out and m["slo_alerts"] == 0
    validate_trace(load_trace(path))
    assert report_main([path, "--slo", "ttft_p99<8"]) == 0
    assert "ttft_p99<8" in capsys.readouterr().out


# -------------------------------------------------- train, across packages
def _jax_launcher_trace(argv):
    """The JAX launcher's body under tracing, on the reduced config."""
    s = setup()
    args = launcher.parse_args(argv + ["--device", "cpu"])
    opt = JAX_OPTIMIZERS[args.optimizer]()
    comp = JaxCompressor(args.compress)
    batches = jax_make_lm_batches(JaxLMDataConfig(
        vocab_size=s["jcfg"].vocab_size, seq_len=args.seq_len,
        batch_size=args.batch_size))
    step = jax_make_train_step(
        s["jmodel"].loss_fn, opt, jax_cosine_warmup(args.lr, 5, args.steps),
        precision=JaxPrecisionPolicy(compute_dtype=args.compute_dtype),
        compressor=comp)
    with jax_trace.tracing() as rec:
        jax_train_loop(step, JaxTrainState.create(s["jparams"], opt, comp),
                       lambda t: batches(t, 0), args.steps,
                       log_every=max(1, args.steps // 10))
    return rec.to_chrome()


def test_launcher_train_trace_matches_jax(tmp_path, capsys):
    argv = ["--smoke", "--steps", "3", "--compress", "onebit",
            "--batch-size", "4", "--seq-len", "32"]
    jtr = _jax_launcher_trace(argv)
    path = str(tmp_path / "t.json")
    run = launcher.build(launcher.parse_args(
        argv + ["--device", "cpu", "--trace", path]),
        params=setup()["params"])
    with tracing(path):
        _, hist = launcher.train(run)
    tr = load_trace(path)
    validate_trace(tr, strict=True)
    assert canonical_bytes(strip_wall(tr)) == canonical_bytes(strip_wall(jtr))
    assert len(find_spans(tr, "step")) == 3
    assert render(strip_wall(jtr)) == jax_report.render(strip_wall(jtr))
    assert analyze(jtr) == jax_analyze.analyze(jtr)
    # main: --trace writes the file, --report renders the attribution,
    # and the losses are the untraced run's bit for bit
    traced = launcher.main(argv + ["--device", "cpu", "--trace", path,
                                   "--report"])
    out = capsys.readouterr().out
    assert "step attribution" in out and f"trace written to {path}" in out
    untraced = launcher.main(argv + ["--device", "cpu"])
    assert [h["loss"] for h in traced] == [h["loss"] for h in untraced]


def _lin_batch(t, w):
    rng = np.random.RandomState(t * 100 + w)
    X = rng.standard_normal((16, 8)).astype(np.float32)
    return {"X": torch.from_numpy(X),
            "y": torch.from_numpy(X @ np.arange(1, 9, dtype=np.float32)
                                  .reshape(8, 1))}


def _lin_loss(p, b):
    return ((b["X"] @ p["W"] - b["y"]) ** 2).mean() + 0 * p["b"].sum(), {}


@pytest.mark.parametrize("spec,wire", [("bsp/allreduce/onebit@4", "modeled"),
                                       ("bsp/ring/onebit@4", "measured"),
                                       ("bsp/ps/dgc@4", "measured")])
def test_device_engine_bsp_trace(spec, wire):
    strat = Strategy.parse(spec, lr=0.05, wire=wire, bucket_mb=1e-4)
    params = {"W": torch.zeros(8, 1), "b": torch.zeros(130)}
    engine = strat.build(value_and_grad(_lin_loss), device="cpu")
    _, hist, wire_total = engine.run(params, _lin_batch, 3)
    with tracing() as rec:
        engine = strat.build(value_and_grad(_lin_loss), device="cpu")
        _, thist, twire = engine.run(params, _lin_batch, 3)
    assert [h["loss"] for h in thist] == [h["loss"] for h in hist]
    assert twire == wire_total
    tr = rec.to_chrome()
    validate_trace(tr, strict=True)
    plan = engine.inner._plan
    assert len(find_spans(tr, "compute")) == 3
    ex = find_spans(tr, "exchange")
    assert len(ex) == 3
    assert all(e["args"]["n_buckets"] == len(plan.buckets) > 1 for e in ex)
    arch = strat.arch
    hop_bytes = sum(ev["args"]["tx_bytes"] for ev in tr["traceEvents"]
                    if ev.get("name") == "hop")
    assert hop_bytes == pytest.approx(
        3 * plan.measured_step_tx_bytes(arch), abs=0.01)
    counters = [ev["args"]["cumulative"] for ev in tr["traceEvents"]
                if ev.get("ph") == "C" and ev["name"] == "wire_bytes"]
    assert len(counters) == 3 and counters[-1] == float(twire)
