"""Observability plane of the port (the JAX package's ``obs``;
docs/observability.md).

``trace`` — spans / instants / counters in Chrome trace-event JSON on
dual clocks: a deterministic virtual tick timeline plus wall-clock
annotations, so seeded runs give byte-identical traces once the wall
fields are stripped.  The default recorder is a no-op: instrumented hot
paths cost nothing (and read no tensor) when tracing is off.

``metrics`` — a counter / gauge / histogram registry with JSONL export,
and the nearest-rank ``percentile`` every latency aggregation shares.

``analyze`` / ``report`` — step-time attribution, comm overlap efficiency
against the modeled bounds, pipeline bubbles, serve latency, and the
``python -m repro_torch.obs.report trace.json`` CLI.

``slo`` — declarative serve objectives (``ttft_p99<8``) with multi-window
burn-rate alerting, wired into the serve engine.

Everything here is stdlib-only.  The JAX package's ``regress`` (the
``BENCH_pr<N>.json`` gate) has no counterpart here.
"""
from repro_torch.obs.analyze import (analyze, overlap_efficiency,
                                     pipeline_accounting, request_latencies,
                                     serve_summary, step_attribution)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentile)
from repro_torch.obs.slo import Objective, SLOMonitor, evaluate_trace
from repro_torch.obs.trace import (NullRecorder, TraceRecorder,
                                   emit_sched_trace, get_recorder,
                                   load_trace, set_recorder, strip_wall,
                                   tracing, validate_trace)

__all__ = [
    "TraceRecorder", "NullRecorder", "get_recorder", "set_recorder",
    "tracing", "load_trace", "strip_wall", "validate_trace",
    "emit_sched_trace",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "percentile",
    "analyze", "step_attribution", "overlap_efficiency",
    "pipeline_accounting", "request_latencies", "serve_summary",
    "Objective", "SLOMonitor", "evaluate_trace",
]
