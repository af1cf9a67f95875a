"""Serve SLOs: declarative objectives + multi-window burn-rate alerts
(the JAX package's ``obs/slo.py``; docs/observability.md, "Analysis &
SLOs"; docs/serving.md).

An **objective** is a one-line spec over the serve plane's deterministic
iteration clock:

    "ttft_p99<8"        99% of requests see first token within 8 iters
    "tpot_p50<1.5"      median per-token latency under 1.5 iters
    "stall_rate<0.1"    at most 10% of engine iterations admission-stall
    "error_rate<0.01"   at most 1% of completions error

Quantile objectives get an **error budget** of ``1 - q/100`` (p99 ->
1%); rate objectives budget the rate bound directly.  An observation is
*bad* when it exceeds the threshold (for rate metrics, when it is
nonzero).

Alerting follows the SRE multi-window **burn rate** rule: with
``burn = bad_fraction / budget`` measured over a window, an objective is
*firing* when both the long window (sustained) and the short window
(still happening) burn faster than ``factor``.  Burning on one window
alone is ignored — the long window alone is old news, the short window
alone is noise.

``ServeEngine`` feeds a monitor live (``ServeEngine(..., slo=mon)``)
and emits an ``slo_burn`` instant on each transition into firing; the
recorded alert times (``ServeEngine.slo_alerts``) are the signal an
autoscaler's scale-up consumes.  ``evaluate_trace`` replays the
same objectives over an already-recorded trace.  Stdlib-only.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

_SPEC = re.compile(
    r"^(?P<metric>[a-z_]+?)_(?:p(?P<q>\d+(?:\.\d+)?)|(?P<rate>rate))"
    r"\s*<=?\s*(?P<value>[0-9.eE+-]+)$")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One parsed SLO line.  ``budget`` is the allowed bad fraction;
    ``threshold`` is the per-observation bad cutoff (0 for rates: any
    nonzero observation is bad)."""
    metric: str
    spec: str
    budget: float
    threshold: float

    @staticmethod
    def parse(spec: str) -> "Objective":
        m = _SPEC.match(spec.strip())
        if not m:
            raise ValueError(
                f"bad SLO spec {spec!r} (want e.g. 'ttft_p99<8' or "
                f"'stall_rate<0.1')")
        value = float(m.group("value"))
        if m.group("rate"):
            if not 0.0 < value <= 1.0:
                raise ValueError(f"rate bound must be in (0, 1]: {spec!r}")
            return Objective(m.group("metric"), spec.strip(),
                             budget=value, threshold=0.0)
        q = float(m.group("q"))
        if not 0.0 < q < 100.0:
            raise ValueError(f"quantile must be in (0, 100): {spec!r}")
        return Objective(m.group("metric"), spec.strip(),
                         budget=1.0 - q / 100.0, threshold=value)

    def bad(self, value: float) -> bool:
        return value > self.threshold


class SLOMonitor:
    """Accumulates per-metric observations on a monotonic clock and
    evaluates multi-window burn rates per objective."""

    def __init__(self, objectives: Sequence[Union[str, Objective]],
                 long_window: float = 64.0, short_window: float = 8.0,
                 factor: float = 2.0):
        self.objectives: List[Objective] = [
            o if isinstance(o, Objective) else Objective.parse(o)
            for o in objectives]
        if not self.objectives:
            raise ValueError("SLOMonitor needs at least one objective")
        self.long_window = float(long_window)
        self.short_window = float(short_window)
        self.factor = float(factor)
        self._obs: Dict[str, List[Tuple[float, float]]] = {}

    def observe(self, metric: str, t: float, value: float = 1.0) -> None:
        self._obs.setdefault(metric, []).append((float(t), float(value)))

    def burn_rate(self, obj: Objective, now: float,
                  window: float) -> float:
        """bad_fraction / budget over ``(now - window, now]``; 0.0 when
        the window holds no observations (no evidence, no alarm)."""
        xs = self._obs.get(obj.metric, ())
        lo = now - window
        n = bad = 0
        for t, v in xs:
            if lo < t <= now:
                n += 1
                bad += obj.bad(v)
        return (bad / n) / obj.budget if n else 0.0

    def evaluate(self, now: float) -> List[dict]:
        rows = []
        for obj in self.objectives:
            long = self.burn_rate(obj, now, self.long_window)
            short = self.burn_rate(obj, now, self.short_window)
            rows.append(dict(
                objective=obj.spec, metric=obj.metric, budget=obj.budget,
                burn_long=long, burn_short=short,
                firing=(long >= self.factor and short >= self.factor)))
        return rows

    def firing(self, now: float) -> List[dict]:
        return [r for r in self.evaluate(now) if r["firing"]]


def evaluate_trace(trace: dict,
                   objectives: Sequence[Union[str, Objective]],
                   long_window: float = 64.0, short_window: float = 8.0,
                   factor: float = 2.0) -> dict:
    """Replay ``objectives`` over a recorded serve trace: request TTFT /
    TPOT from the lifecycle spans (keyed to *finish* time — the moment
    the number became known), stall samples from ``admission_stall``
    instants and the iteration-sampled counter tracks.  Returns the
    final evaluation plus every alert transition on the trace clock."""
    from repro_torch.obs.analyze import (find_counters, find_instants,
                                   request_latencies)
    mon = SLOMonitor(objectives, long_window=long_window,
                     short_window=short_window, factor=factor)
    events: List[Tuple[float, str, float]] = []
    for r in request_latencies(trace):
        events.append((r["finish_t"], "ttft", r["ttft"]))
        events.append((r["finish_t"], "tpot", r["tpot"]))
    stall_ts = {ev["args"].get("clock_t")
                for ev in find_instants(trace, "admission_stall")}
    # one stall sample per engine iteration (counters fire once each)
    for ev in find_counters(trace, "slots"):
        t = ev["args"].get("clock_t")
        if t is not None:
            events.append((float(t), "stall",
                           1.0 if t in stall_ts else 0.0))
    events.sort(key=lambda e: e[0])
    alerts: List[dict] = []
    was_firing = False
    now = 0.0
    for t, metric, value in events:
        mon.observe(metric, t, value)
        now = t
        firing = mon.firing(now)
        if firing and not was_firing:
            alerts.append(dict(t=now,
                               objectives=[f["objective"] for f in firing]))
        was_firing = bool(firing)
    return dict(evaluation=mon.evaluate(now), alerts=alerts,
                observations=len(events))
