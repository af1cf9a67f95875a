"""Counter / gauge / histogram registry with JSONL export (the JAX
package's ``obs/metrics.py``; docs/observability.md), plus the
nearest-rank ``percentile`` helper every latency aggregation of the port
shares (``serve/request.py`` imports it).

The registry is deliberately tiny and dependency-free: metrics are
host-side Python scalars, so registering and updating them never reads a
tensor (no device sync).

    reg = MetricsRegistry()
    reg.counter("requests").inc()
    reg.gauge("kv_free_pages").set(13)
    reg.histogram("ttft").observe(2.0)
    print("\n".join(reg.to_jsonl()))      # one JSON object per metric
"""
from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Union


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over ``values`` (``q`` in [0, 100]), no
    numpy dependency in the hot accounting path.  Edge cases: an empty
    sample returns ``nan`` (there is no order statistic to report), a
    singleton sample returns its one value for every ``q``."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q!r} outside [0, 100]")
    xs = sorted(float(v) for v in values)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return xs[0]
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


class Counter:
    """Monotonically increasing count (requests served, stalls, bytes)."""
    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += n

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value}


class Gauge:
    """A value that goes up and down (pool occupancy, replica count)."""
    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value}


class Histogram:
    """Sample distribution with nearest-rank percentile summaries
    (latencies, step times), bounded memory.

    At most ``max_samples`` raw samples are retained (default
    ``DEFAULT_MAX_SAMPLES``).  Below the cap, percentiles are **exact**.
    Above it, retained samples are a uniform reservoir (Vitter's
    Algorithm R) driven by a fixed-seed PRNG, so for a given observation
    sequence the result is **deterministic** — two same-seed runs
    snapshot identically.  ``count`` / ``sum`` / ``min`` / ``max`` /
    ``mean`` stay exact regardless of the cap."""
    __slots__ = ("samples", "max_samples", "_n", "_sum", "_min", "_max",
                 "_rng")
    kind = "histogram"
    DEFAULT_MAX_SAMPLES = 4096

    def __init__(self, max_samples: Optional[int] = None):
        cap = (self.DEFAULT_MAX_SAMPLES if max_samples is None
               else int(max_samples))
        if cap < 1:
            raise ValueError(f"max_samples must be >= 1, got {cap}")
        self.samples: List[float] = []
        self.max_samples = cap
        self._n = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._rng = random.Random(0)

    def observe(self, v: float) -> None:
        v = float(v)
        self._n += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if len(self.samples) < self.max_samples:
            self.samples.append(v)
        else:
            # Algorithm R: keep each of the n samples with prob cap/n
            j = self._rng.randrange(self._n)
            if j < self.max_samples:
                self.samples[j] = v

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def snapshot(self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        out: Dict[str, float] = {"count": float(self.count)}
        if self._n:
            out.update(sum=self._sum, min=self._min, max=self._max,
                       mean=self._sum / self._n)
        if self._n > len(self.samples):
            # percentiles below are over the reservoir, not every sample
            out["retained"] = float(len(self.samples))
        for q in qs:
            out[f"p{q:g}"] = self.percentile(q)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metrics, get-or-create semantics, kind-checked: asking for
    an existing name as a different kind is a bug, not a new metric."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind: str):
        m = self._metrics.get(name)
        if m is None:
            m = _KINDS[kind]()
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(f"metric {name!r} is a {m.kind}, not a {kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str,
                  max_samples: Optional[int] = None) -> Histogram:
        """``max_samples`` bounds the retained reservoir and only takes
        effect when the histogram is first created."""
        h = self._metrics.get(name)
        if h is None and max_samples is not None:
            h = Histogram(max_samples)
            self._metrics[name] = h
            return h
        return self._get(name, "histogram")

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # ----------------------------------------------------------- export
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: self._metrics[name].snapshot()
                for name in self.names()}

    def to_jsonl(self, **common) -> List[str]:
        """One JSON object per metric (``{"metric": name, "kind": ...,
        **snapshot, **common}``) — the ``BENCH_*.json`` row convention."""
        lines = []
        for name in self.names():
            m = self._metrics[name]
            row = dict(metric=name, kind=m.kind, **m.snapshot(), **common)
            lines.append(json.dumps(row, sort_keys=True))
        return lines

    def export_jsonl(self, path: str, **common) -> None:
        with open(path, "w") as f:
            for line in self.to_jsonl(**common):
                f.write(line + "\n")
