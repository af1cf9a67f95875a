"""Structured tracing on dual clocks (the JAX package's
``obs/trace.py``; docs/observability.md).

The recorder collects **spans** (begin/end pairs), **instants**, and
**counter samples** and serializes them as Chrome trace-event JSON — the
format Perfetto and ``chrome://tracing`` load directly.

Dual clocks
-----------
The primary timestamp (the trace-event ``ts`` field) is a **virtual
tick**: a monotonic per-event sequence number.  It is a pure function of
the host-side event order, so two runs with the same seed produce the
same tick timeline — traces are *reproducible*.  Each event additionally
carries

  * ``args.clock_domain`` / ``args.clock_t`` — the emitting subsystem's
    own deterministic clock (``train_step`` index, ``serve_iter`` virtual
    iteration, ``sched_time``), and
  * ``args.wall_s`` — wall seconds since the recorder started, the only
    non-deterministic field.  ``strip_wall`` removes every ``wall*`` arg
    so seeded traces can be compared byte-for-byte.

Zero overhead when disabled
---------------------------
The module-level recorder defaults to ``NullRecorder`` whose methods are
no-ops and whose ``span`` returns one shared null context manager.
Instrumented hot paths guard with ``rec.enabled`` (a plain attribute
read), so tracing off costs one global lookup per step; everything that
reads a tensor (``.item()``, a synchronize) sits inside that guard.

Event arguments are plain Python ``int`` / ``float`` / ``str``: a tensor
or a numpy scalar would break the JSON and the byte equality of two
packages' traces.

Usage::

    from repro_torch.obs.trace import tracing
    with tracing("out.json") as rec:
        trainer.fit(...)                  # instrumented spine records

This module is dependency-free (stdlib only) so every subsystem can
import it without cycles.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# the reserved args prefix for non-deterministic fields (wall clocks)
_WALL_PREFIX = "wall"


class _NullSpan:
    """One shared, allocation-free context manager for disabled tracing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The default recorder: every method is a no-op.  Hot paths check
    ``enabled`` before doing any argument construction."""

    enabled = False

    def begin(self, name: str, **kw) -> None:
        pass

    def end(self, **kw) -> None:
        pass

    def instant(self, name: str, **kw) -> None:
        pass

    def counter(self, name: str, values: Dict[str, float], **kw) -> None:
        pass

    def span(self, name: str, **kw):
        return _NULL_SPAN


class _Span:
    __slots__ = ("rec", "pid", "tid")

    def __init__(self, rec: "TraceRecorder", pid: str, tid: str):
        self.rec, self.pid, self.tid = rec, pid, tid

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        self.rec.end(pid=self.pid, tid=self.tid)
        return False


class TraceRecorder:
    """Collects trace events on the virtual tick clock.

    ``pid`` / ``tid`` are *names* (subsystem / track); they are mapped to
    the integer ids Chrome wants at serialization time, with ``M``
    metadata events carrying the names.  Spans with the same (pid, tid)
    nest by begin/end order — emit sub-spans on their parent's track.
    """

    enabled = True

    def __init__(self):
        self.events: List[dict] = []
        self._tick = 0
        self._t0 = time.perf_counter()
        # per-(pid, tid) open-span stack, for early validation
        self._open: Dict[Tuple[str, str], List[str]] = {}

    # ------------------------------------------------------------- clock
    def _next(self) -> int:
        t = self._tick
        self._tick += 1
        return t

    def _args(self, clock: Optional[Tuple[str, Any]],
              args: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(args)
        if clock is not None:
            out["clock_domain"] = clock[0]
            out["clock_t"] = clock[1]
        out["wall_s"] = round(time.perf_counter() - self._t0, 6)
        return out

    # ----------------------------------------------------------- events
    def begin(self, name: str, *, pid: str = "main", tid: str = "main",
              cat: str = "", clock: Optional[Tuple[str, Any]] = None,
              **args) -> None:
        self._open.setdefault((pid, tid), []).append(name)
        self.events.append(dict(name=name, cat=cat, ph="B",
                                ts=self._next(), pid=pid, tid=tid,
                                args=self._args(clock, args)))

    def end(self, *, pid: str = "main", tid: str = "main", **args) -> None:
        stack = self._open.get((pid, tid), [])
        if not stack:
            raise ValueError(f"end() without begin() on track "
                             f"({pid!r}, {tid!r})")
        name = stack.pop()
        self.events.append(dict(name=name, cat="", ph="E",
                                ts=self._next(), pid=pid, tid=tid,
                                args=self._args(None, args)))

    def span(self, name: str, *, pid: str = "main", tid: str = "main",
             cat: str = "", clock: Optional[Tuple[str, Any]] = None,
             **args) -> _Span:
        self.begin(name, pid=pid, tid=tid, cat=cat, clock=clock, **args)
        return _Span(self, pid, tid)

    def instant(self, name: str, *, pid: str = "main", tid: str = "main",
                cat: str = "", clock: Optional[Tuple[str, Any]] = None,
                **args) -> None:
        self.events.append(dict(name=name, cat=cat, ph="i",
                                ts=self._next(), pid=pid, tid=tid, s="t",
                                args=self._args(clock, args)))

    def counter(self, name: str, values: Dict[str, float], *,
                pid: str = "main", cat: str = "",
                clock: Optional[Tuple[str, Any]] = None) -> None:
        args = self._args(clock, {k: float(v) for k, v in values.items()})
        self.events.append(dict(name=name, cat=cat, ph="C",
                                ts=self._next(), pid=pid, tid=name,
                                args=args))

    # ---------------------------------------------------- serialization
    def to_chrome(self, include_wall: bool = True) -> dict:
        """The Chrome trace-event JSON object.  pid/tid names become
        stable integer ids (first-appearance order — deterministic) with
        ``M`` metadata events naming them."""
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        out: List[dict] = []
        for ev in self.events:
            pid = pids.setdefault(ev["pid"], len(pids) + 1)
            tid = tids.setdefault((ev["pid"], ev["tid"]),
                                  len(tids) + 1)
            args = ev["args"]
            if not include_wall:
                args = {k: v for k, v in args.items()
                        if not k.startswith(_WALL_PREFIX)}
            rec = dict(ev, pid=pid, tid=tid, args=args)
            out.append(rec)
        meta: List[dict] = []
        for name, pid in pids.items():
            meta.append(dict(name="process_name", ph="M", ts=0, pid=pid,
                             tid=0, args={"name": name}))
        for (pname, tname), tid in tids.items():
            meta.append(dict(name="thread_name", ph="M", ts=0,
                             pid=pids[pname], tid=tid,
                             args={"name": tname}))
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "virtual ticks (deterministic); wall seconds in "
                         "args.wall_s",
            },
        }

    def to_bytes(self, include_wall: bool = True) -> bytes:
        return json.dumps(self.to_chrome(include_wall), sort_keys=True,
                          separators=(",", ":")).encode()

    def save(self, path: str, include_wall: bool = True) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes(include_wall))


# ----------------------------------------------------- module recorder
_NULL = NullRecorder()
_recorder: Any = _NULL


def get_recorder():
    """The process-wide recorder every instrumented call site consults.
    Defaults to the no-op ``NullRecorder``."""
    return _recorder


def set_recorder(rec) -> Any:
    """Install ``rec`` (None restores the no-op default); returns the
    previous recorder so callers can restore it."""
    global _recorder
    prev = _recorder
    _recorder = rec if rec is not None else _NULL
    return prev


@contextlib.contextmanager
def tracing(path: Optional[str] = None,
            recorder: Optional[TraceRecorder] = None):
    """Enable tracing for the block; on exit restore the previous
    recorder and (when ``path`` is given) write the Chrome trace JSON."""
    rec = recorder if recorder is not None else TraceRecorder()
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)
        if path is not None:
            rec.save(path)


# ---------------------------------------------------------- inspection
def load_trace(path: str) -> dict:
    with open(path, "rb") as f:
        return json.loads(f.read())


def strip_wall(trace: dict) -> dict:
    """Drop every non-deterministic ``wall*`` arg — what the seeded-run
    byte-identity comparison operates on."""
    events = []
    for ev in trace.get("traceEvents", []):
        args = {k: v for k, v in ev.get("args", {}).items()
                if not k.startswith(_WALL_PREFIX)}
        events.append(dict(ev, args=args))
    return dict(trace, traceEvents=events)


def canonical_bytes(trace: dict) -> bytes:
    """Deterministic serialization of a (typically wall-stripped) trace."""
    return json.dumps(trace, sort_keys=True, separators=(",", ":")).encode()


def validate_trace(trace: dict, strict: bool = True) -> Dict[str, Any]:
    """Structural validation of a Chrome trace-event object: ``ts`` is
    globally non-decreasing and every ``E`` matches the innermost open
    ``B`` on its (pid, tid) track.  With ``strict`` (the default) the
    first violation raises ``ValueError``; with ``strict=False`` every
    violation is collected into the returned ``errors`` list instead —
    analysis of a damaged trace should report, not crash.  Returns
    summary stats (span/instant/counter counts, max nesting depth, span
    names, errors)."""
    errors: List[str] = []

    def fail(msg: str) -> None:
        if strict:
            raise ValueError(msg)
        errors.append(msg)

    events = trace.get("traceEvents")
    if not isinstance(events, list):
        fail("not a Chrome trace: missing traceEvents list")
        events = []
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    last_ts = None
    spans = instants = counters = 0
    max_depth = 0
    names: set = set()
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if ts is None:
            fail(f"event missing ts: {ev}")
        elif last_ts is not None and ts < last_ts:
            fail(f"ts went backwards: {ts} < {last_ts}")
        if ts is not None:
            last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name"))
            names.add(ev.get("name"))
            max_depth = max(max_depth, len(stacks[key]))
        elif ph == "E":
            stack = stacks.get(key, [])
            if not stack:
                fail(f"E without B on track {key}: {ev}")
                continue
            if stack.pop() != ev.get("name"):
                fail(f"E name mismatch on track {key}: {ev}")
            spans += 1
        elif ph == "i":
            instants += 1
            names.add(ev.get("name"))
        elif ph == "C":
            counters += 1
            names.add(ev.get("name"))
        else:
            fail(f"unknown phase {ph!r}: {ev}")
    unclosed = {k: v for k, v in stacks.items() if v}
    if unclosed:
        fail(f"unclosed spans: {unclosed}")
    return dict(events=len(events), spans=spans, instants=instants,
                counters=counters, max_depth=max_depth,
                names=sorted(n for n in names if n is not None),
                errors=errors)


def find_spans(trace: dict, name: str) -> List[dict]:
    """All ``B`` events with ``name`` (convenience for tests/smoke)."""
    return [ev for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "B" and ev.get("name") == name]


# ------------------------------------------------------- sched bridge
def emit_sched_trace(rec, trace: Iterable, *, pid: str = "sched",
                     clock_domain: str = "sched_time") -> None:
    """Re-emit a ``sched.simulator`` allocation ``TraceEvent`` stream
    (any iterable of objects with ``t / jid / kind / gpus`` fields) onto
    the shared timeline: one track per job, a span per running interval
    (start/resume → suspend/finish), an instant per decision.  Jobs
    still running when the stream ends are closed with a ``truncated``
    end so the trace stays well-formed."""
    if not rec.enabled:
        return
    open_jobs: Dict[int, str] = {}
    for ev in trace:
        tid = f"job{ev.jid}"
        rec.instant(ev.kind, pid=pid, tid=tid, cat="sched",
                    clock=(clock_domain, ev.t), jid=ev.jid, gpus=ev.gpus)
        if ev.kind in ("start", "resume"):
            if ev.jid not in open_jobs:
                rec.begin("running", pid=pid, tid=tid, cat="sched",
                          clock=(clock_domain, ev.t), jid=ev.jid,
                          gpus=ev.gpus)
                open_jobs[ev.jid] = tid
        elif ev.kind in ("suspend", "finish"):
            if ev.jid in open_jobs:
                rec.end(pid=pid, tid=tid, t=ev.t)
                del open_jobs[ev.jid]
    for jid, tid in sorted(open_jobs.items()):
        rec.end(pid=pid, tid=tid, truncated=True)
