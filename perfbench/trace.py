"""The device trace of a traced run: ``torch.profiler`` over a part of the
measured window (between two synchronized points), written as a Chrome
trace under ``TMPDIR``, read back and deleted.

What the metrics read from it: every device operation (kernels, copies,
sets) with its start and length, the program's ``record_function`` ranges
as they lie on the device's timeline, and the host operations, which name
what the host was doing in each gap of the device's timeline."""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Span(NamedTuple):
    name: str
    start: float               # microseconds on the trace's clock
    end: float


class TraceData(NamedTuple):
    device: List[Span]         # device operations, by start
    ranges: List[Span]         # record_function ranges on the device
    host: List[Span]           # host operations
    window_s: float            # the traced window, on the host clock


def union(spans: List[Span]) -> List[Tuple[float, float]]:
    """Disjoint intervals covering ``spans`` (sorted by start)."""
    out: List[List[float]] = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return [(a, b) for a, b in out]


def busy_s(trace: TraceData) -> float:
    return sum(b - a for a, b in union(trace.device)) * 1e-6


def busy_within(trace: TraceData, name: str) -> Tuple[float, int]:
    """(seconds of device operations inside the ranges called ``name``,
    number of such ranges)."""
    ranges = [r for r in trace.ranges if r.name == name]
    cover = union(ranges)
    busy = union(trace.device)
    total, i, j = 0.0, 0, 0
    while i < len(cover) and j < len(busy):
        (a, b), (x, y) = cover[i], busy[j]
        total += max(0.0, min(b, y) - max(a, x))
        if b < y:
            i += 1
        else:
            j += 1
    return total * 1e-6, len(ranges)


def busy_from_to(trace: TraceData, start: str, end: str
                 ) -> Tuple[float, int]:
    """(seconds of device operations from the start of each range called
    ``start`` to the start of the next range called ``end``, number of
    such spans): a phase whose later part the program launches outside
    its own range, as the backward pass runs on autograd's thread."""
    ends = sorted(r.start for r in trace.ranges if r.name == end)
    spans = []
    for r in sorted(trace.ranges, key=lambda r: r.start):
        if r.name != start:
            continue
        nxt = [e for e in ends if e > r.start]
        if nxt:
            spans.append(Span(start, r.start, nxt[0]))
    busy = union(trace.device)
    total = 0.0
    for a, b in union(spans):
        total += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy
                     if y > a and x < b)
    return total * 1e-6, len(spans)


def kernel_time(trace: TraceData, match) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name ``match``
    accepts."""
    spans = [s for s in trace.device if match(s.name)]
    return sum(s.end - s.start for s in spans) * 1e-6, len(spans)


def breakdown(trace: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the longest
    gaps of the device's timeline, each named by the innermost host
    operation running at its middle."""
    by_name: Dict[str, float] = {}
    for s in trace.device:
        by_name[s.name] = by_name.get(s.name, 0.0) + (s.end - s.start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(trace.device)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(trace.host, key=lambda s: s.start)
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        inner = [h for h in host if h.start <= mid <= h.end]
        name = min(inner, key=lambda h: h.end - h.start).name if inner \
            else "host idle"
        out.append([name[:120], (b - a) * 1e-6])
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": out}


class Tracer:
    """``start()`` and ``stop()`` at synchronized points of a run."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self._t0 = 0.0
        self.window_s = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop a profiler once, in set-up: the first start
        initializes the device tracer, which takes seconds."""
        import torch
        with self._profile():
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    def start(self):
        self._sync()
        self._prof = self._profile()
        self._prof.start()
        self._t0 = time.perf_counter()

    @property
    def started(self) -> bool:
        return self._prof is not None

    @property
    def running(self) -> bool:
        return self._prof is not None and self.window_s is None

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def stop(self):
        """Stop recording; the trace is read later, by ``read``, outside
        the measured window."""
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def read(self) -> TraceData:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        device, ranges, host = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            s = Span(e.get("name", "?"), float(e["ts"]),
                     float(e["ts"]) + float(e["dur"]))
            if cat in DEVICE_CATS:
                device.append(s)
            elif cat == "gpu_user_annotation":
                ranges.append(s)
            elif cat in HOST_CATS:
                host.append(s)
        device.sort(key=lambda s: s.start)
        return TraceData(device, ranges, host, self.window_s)
