"""Trace analytics: turning recorded Chrome traces into answers (the JAX
package's ``obs/analyze.py``; docs/observability.md, "Analysis & SLOs").

The recorder (obs/trace.py) writes events; this module reads them back
and produces the three accountings every perf conversation needs:

  * ``step_attribution``  — where each training step's time went:
    compute vs comm vs snapshot vs stall, from the ``train/loop`` step
    spans, the ``compute`` spans inside them, the CommPlan ``exchange``
    spans, and the ``elastic/events`` snapshot spans.
  * ``overlap_efficiency`` — achieved bucket-issue concurrency relative
    to the two modeled bounds CommPlan stamps on every exchange span
    (``modeled_no_overlap_us`` / ``modeled_tictac_overlap_us``).
  * ``pipeline_accounting`` — measured GPipe bubble fraction per step
    from the per-stage/per-tick spans a pipeline engine emits,
    against the analytic ``(s-1)/(m+s-1)``.

plus the serve-side extraction (``request_latencies``) the SLO monitor
(obs/slo.py) evaluates.  Everything here is stdlib-only, pure host-side,
and operates on the *serialized* trace dict — the same object
``load_trace`` returns — so analysis works equally on live recorders
(``rec.to_chrome()``) and files written months ago.

Durations use the ``wall_s`` args when the trace carries them (the
normal case) and fall back to the deterministic virtual-tick extent for
wall-stripped traces; every result records which ``basis`` it used.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

# attribution taxonomy (docs/observability.md): every step-window second
# lands in exactly one of these buckets, stall being the residual
ATTRIBUTION_CATEGORIES = ("compute", "comm", "snapshot", "stall")


# ------------------------------------------------------- event access
def resolve_events(trace: dict) -> List[dict]:
    """The trace's non-metadata events with pid/tid resolved back to the
    *names* the recorder used (``M`` metadata carries them; serialized
    pids/tids are integers).  Raw recorder dicts whose pids are already
    names pass through unchanged."""
    pmap: Dict[Any, str] = {}
    tmap: Dict[Tuple[Any, Any], str] = {}
    events = trace.get("traceEvents", [])
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            pmap[ev.get("pid")] = ev.get("args", {}).get("name")
        elif ev.get("name") == "thread_name":
            tmap[(ev.get("pid"), ev.get("tid"))] = \
                ev.get("args", {}).get("name")
    out = []
    for ev in events:
        if ev.get("ph") == "M":
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        out.append(dict(ev, pid=pmap.get(pid, pid),
                        tid=tmap.get((pid, tid), tid)))
    return out


def paired_spans(trace: dict) -> List[dict]:
    """B/E pairs as span records, sorted by begin tick.  Each record
    carries both clocks (``ts0/ts1`` ticks, ``wall0/wall1`` seconds when
    present), the begin args, the end args, and the nesting ``depth``.
    Unmatched events are skipped — ``validate_trace(strict=False)`` is
    the tool that *reports* them."""
    stacks: Dict[Tuple[Any, Any], List[dict]] = {}
    spans: List[dict] = []
    for ev in resolve_events(trace):
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                continue
            b = stack.pop()
            bargs, eargs = b.get("args", {}), ev.get("args", {})
            spans.append(dict(
                name=b.get("name"), pid=ev.get("pid"), tid=ev.get("tid"),
                depth=len(stack), ts0=b.get("ts"), ts1=ev.get("ts"),
                wall0=bargs.get("wall_s"), wall1=eargs.get("wall_s"),
                args=bargs, end_args=eargs))
    spans.sort(key=lambda s: (s["ts0"] is None, s["ts0"]))
    return spans


def find_instants(trace: dict, name: Optional[str] = None) -> List[dict]:
    return [ev for ev in resolve_events(trace) if ev.get("ph") == "i"
            and (name is None or ev.get("name") == name)]


def find_counters(trace: dict, name: str) -> List[dict]:
    return [ev for ev in resolve_events(trace)
            if ev.get("ph") == "C" and ev.get("name") == name]


def _has_wall(span: dict) -> bool:
    return span.get("wall0") is not None and span.get("wall1") is not None


def _edges(span: dict, basis: str) -> Tuple[float, float]:
    if basis == "wall":
        return float(span["wall0"]), float(span["wall1"])
    return float(span["ts0"]), float(span["ts1"])


def _clipped(spans: Sequence[dict], lo: float, hi: float,
             basis: str) -> float:
    """Total duration of ``spans`` clipped to the window [lo, hi]."""
    total = 0.0
    for s in spans:
        a, b = _edges(s, basis)
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


# --------------------------------------------------- step attribution
def step_attribution(trace: dict, basis: str = "auto") -> Optional[dict]:
    """Per-step time attribution over the ``train/loop`` step spans.

    Each step's accounting **window** runs from the previous step's end
    to this step's end (the first step starts at its own begin), so
    between-step host work — snapshot commits, batch assembly — is
    charged to the step that waited for it.  Within the window:

      compute   ``compute`` spans on the train track (fused dispatch)
      comm      ``exchange`` spans (the CommPlan bucket schedule)
      snapshot  ``snapshot`` spans from the elastic track
      stall     the unattributed residual (host glue, data, dispatch)

    ``attributed_pct`` is 100 * (compute+comm+snapshot+stall) / window —
    above 100 means double-counting (overlapping spans), the failure
    mode the >=95..105 acceptance band guards.  ``known_pct`` excludes
    the residual: how much of the window instrumented spans *explain*.
    Returns None when the trace has no step spans."""
    spans = paired_spans(trace)
    steps = [s for s in spans if s["name"] == "step"
             and s["pid"] == "train" and s["tid"] == "loop"]
    if not steps:
        return None
    if basis == "auto":
        basis = "wall" if all(_has_wall(s) for s in steps) else "ticks"
    train = [s for s in spans if s["pid"] == "train"]
    compute = [s for s in train if s["name"] == "compute"]
    comm = [s for s in train if s["name"] == "exchange"]
    snaps = [s for s in spans if s["name"] == "snapshot"]

    rows: List[dict] = []
    prev_end: Optional[float] = None
    for st in steps:
        t0, t1 = _edges(st, basis)
        w0 = prev_end if prev_end is not None else t0
        w0 = min(w0, t0)
        prev_end = t1
        total = t1 - w0
        parts = {
            "compute": _clipped(compute, w0, t1, basis),
            "comm": _clipped(comm, w0, t1, basis),
            "snapshot": _clipped(snaps, w0, t1, basis),
        }
        known = sum(parts.values())
        stall = max(0.0, total - known)
        row = dict(step=st["args"].get("clock_t", st["args"].get("step")),
                   total=total, span=t1 - t0, stall=stall, **parts)
        row["attributed_pct"] = (100.0 * (known + stall) / total
                                 if total > 0 else 100.0)
        row["known_pct"] = 100.0 * known / total if total > 0 else 0.0
        rows.append(row)

    totals = {k: sum(r[k] for r in rows)
              for k in ATTRIBUTION_CATEGORIES + ("total",)}
    grand = totals["total"] or 1.0
    return dict(
        basis=basis, steps=rows, totals=totals,
        fractions={k: totals[k] / grand for k in ATTRIBUTION_CATEGORIES},
        attributed_pct_min=min(r["attributed_pct"] for r in rows),
        attributed_pct_max=max(r["attributed_pct"] for r in rows),
        known_pct_mean=sum(r["known_pct"] for r in rows) / len(rows))


# -------------------------------------------------- overlap efficiency
def overlap_efficiency(trace: dict) -> Optional[dict]:
    """Achieved bucket-issue concurrency vs the modeled bounds CommPlan
    stamps on each ``exchange`` span: ``modeled_no_overlap_us`` (serial
    buckets) and ``modeled_tictac_overlap_us`` (TicTac-ordered overlap,
    the best this plan can do).  Efficiency 1.0 means the executed issue
    order achieves the TicTac bound; 0.0 means no overlap at all.
    Returns None when no exchange span carries the model args."""
    ex = [s for s in paired_spans(trace) if s["name"] == "exchange"
          and "modeled_no_overlap_us" in s["args"]]
    if not ex:
        return None
    rows = []
    for s in ex:
        a = s["args"]
        no = float(a["modeled_no_overlap_us"])
        tictac = float(a["modeled_tictac_overlap_us"])
        issue = float(a.get("modeled_issue_overlap_us", tictac))
        eps = 1e-6 * max(no, 1.0)
        denom = no - tictac
        rows.append(dict(
            step=a.get("clock_t"), no_overlap_us=no,
            tictac_overlap_us=tictac, issue_overlap_us=issue,
            n_buckets=a.get("n_buckets"),
            in_bounds=(tictac - eps <= issue <= no + eps),
            efficiency=((no - issue) / denom) if denom > eps else 1.0))
    return dict(
        exchanges=rows,
        all_in_bounds=all(r["in_bounds"] for r in rows),
        efficiency_mean=sum(r["efficiency"] for r in rows) / len(rows))


# ------------------------------------------------- pipeline accounting
def pipeline_accounting(trace: dict) -> Optional[dict]:
    """Measured GPipe bubble fraction from the per-stage/per-tick spans
    (``pipeline/stage<s>`` tracks, one span per tick named ``mb<k>`` or
    ``bubble``) against the analytic ``(s-1)/(m+s-1)`` each ``pipe``
    span carries.  Returns None when the trace has no pipeline spans."""
    spans = paired_spans(trace)
    pipes = [s for s in spans if s["name"] == "pipe"
             and s["pid"] == "pipeline"]
    if not pipes:
        return None
    cells = [s for s in spans if s["pid"] == "pipeline"
             and str(s["tid"]).startswith("stage")]
    rows = []
    for p in pipes:
        a = p["args"]
        inside = [c for c in cells
                  if p["ts0"] <= c["ts0"] and c["ts1"] <= p["ts1"]]
        bubble = sum(1 for c in inside if c["name"] == "bubble")
        active = sum(1 for c in inside if str(c["name"]).startswith("mb"))
        slots = bubble + active
        measured = bubble / slots if slots else 0.0
        analytic = float(a.get("analytic_bubble", 0.0))
        rows.append(dict(
            step=a.get("clock_t"), stages=a.get("stages"),
            micro=a.get("micro"), ticks=a.get("ticks"),
            bubble_ticks=bubble, active_ticks=active,
            measured_bubble=measured, analytic_bubble=analytic,
            rel_err=(abs(measured - analytic) / analytic
                     if analytic else abs(measured))))
    return dict(pipes=rows,
                rel_err_max=max(r["rel_err"] for r in rows),
                measured_bubble_mean=(sum(r["measured_bubble"]
                                          for r in rows) / len(rows)))


# ------------------------------------------------------ serve lifecycle
def request_latencies(trace: dict) -> List[dict]:
    """Per-request latency rows from the serve lifecycle tracks
    (``serve/req<rid>``): TTFT = decode-begin clock minus arrival, TPOT
    = decode clock extent per generated token after the first.  All on
    the deterministic ``serve_iter`` clock — the numbers obs/slo.py
    evaluates objectives over."""
    spans = [s for s in paired_spans(trace) if s["pid"] == "serve"
             and str(s["tid"]).startswith("req")]
    done = {ev["args"].get("rid"): ev["args"].get("clock_t")
            for ev in find_instants(trace, "done")}
    by_rid: Dict[Any, Dict[str, dict]] = {}
    for s in spans:
        rid = s["args"].get("rid")
        by_rid.setdefault(rid, {})[s["name"]] = s
    rows = []
    for rid in sorted(by_rid, key=lambda r: (r is None, r)):
        life = by_rid[rid]
        q, d = life.get("queued"), life.get("decode")
        if q is None or d is None:
            continue
        arrival = float(q["args"].get("arrival", 0.0))
        first_t = float(d["args"].get("clock_t", 0.0))
        generated = int(d["end_args"].get("generated", 1))
        finish_t = float(done.get(rid, first_t))
        rows.append(dict(
            rid=rid, arrival=arrival, first_token_t=first_t,
            finish_t=finish_t, generated=generated,
            ttft=first_t - arrival,
            tpot=((finish_t - first_t) / (generated - 1)
                  if generated > 1 else 0.0)))
    return rows


def serve_summary(trace: dict) -> Optional[dict]:
    """Latency percentiles, stall count, and KV-pool saturation from a
    traced serve episode.  Returns None when the trace has no request
    lifecycles."""
    from repro_torch.obs.metrics import percentile
    reqs = request_latencies(trace)
    if not reqs:
        return None
    kv = find_counters(trace, "kv_pages")
    saturated = sum(1 for ev in kv if ev["args"].get("free") == 0)
    return dict(
        requests=len(reqs),
        ttft_p50=percentile([r["ttft"] for r in reqs], 50),
        ttft_p99=percentile([r["ttft"] for r in reqs], 99),
        tpot_p50=percentile([r["tpot"] for r in reqs], 50),
        tpot_p99=percentile([r["tpot"] for r in reqs], 99),
        admission_stalls=len(find_instants(trace, "admission_stall")),
        slo_burn_alerts=len(find_instants(trace, "slo_burn")),
        kv_samples=len(kv),
        kv_saturated_frac=(saturated / len(kv)) if kv else 0.0)


# ------------------------------------------------------------ analysis
def analyze(trace: dict) -> dict:
    """Every section this module can extract from ``trace`` — sections
    the trace has no events for are None.  ``validation`` always runs
    (strict=False: structural problems are reported, not raised)."""
    from repro_torch.obs.trace import validate_trace
    return dict(
        validation=validate_trace(trace, strict=False),
        attribution=step_attribution(trace),
        overlap=overlap_efficiency(trace),
        pipeline=pipeline_accounting(trace),
        serve=serve_summary(trace))
