"""Declarative elastic event plans (survey §3.2.3 / §3.4.2; the JAX
package's ``elastic/events.py``).

A plan is a schedule of events against a training run's *global step*
clock — worker w crashes before step t, the job is resized N→M before
step t, worker w slows down ×f before step t, the job is suspended and
resumed (checkpoint-restart) before step t.  Plans are frozen data; the
elastic trainer (elastic/recovery.py) consumes them through a one-shot
cursor so a post-crash rollback cannot re-fire the crash.

Grammar (``EventPlan.parse`` / ``.spec()`` are inverses)::

    plan    := item ("," item)*
    item    := "crash:w" W "@" T        worker W crashes before step T
             | "resize:" M "@" T        resize the job to M workers
             | "slow:w" W "x" F "@" T   worker W slows down ×F (F=1 clears)
             | "restart@" T             suspend + resume from checkpoint

e.g. ``"crash:w1@5,resize:4@10"`` — lose worker 1 before step 5, grow
back to 4 workers before step 10.

``FailurePlan`` / ``ResizePlan`` / ``StragglerPlan`` are typed
conveniences over the same event stream; ``plan_from_sched_trace``
converts a ``sched/`` simulator allocation trace (Gandiva suspend/resume
+ elastic resize decisions) into a plan, closing the scheduler↔trainer
loop: the multi-tenant simulator decides *when* a job loses or regains
capacity, and the Strategy engines live through it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

KINDS = ("crash", "resize", "slow", "restart")


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    """One scheduled event; fires immediately *before* global step
    ``step`` executes."""
    step: int
    kind: str                  # crash | resize | slow | restart
    worker: int = -1           # crash/slow target
    workers: int = 0           # resize target size
    factor: float = 1.0        # slow multiplier (1.0 clears)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind={self.kind!r} not in {KINDS}")
        if self.step < 0:
            raise ValueError("event step must be >= 0")
        if self.kind in ("crash", "slow") and self.worker < 0:
            raise ValueError(f"{self.kind} event needs a worker index")
        if self.kind == "resize" and self.workers < 1:
            raise ValueError("resize event needs workers >= 1")
        if self.kind == "slow" and self.factor <= 0:
            raise ValueError("slow factor must be > 0")

    def spec(self) -> str:
        if self.kind == "crash":
            return f"crash:w{self.worker}@{self.step}"
        if self.kind == "resize":
            return f"resize:{self.workers}@{self.step}"
        if self.kind == "slow":
            return f"slow:w{self.worker}x{self.factor:g}@{self.step}"
        return f"restart@{self.step}"


def _parse_item(item: str) -> ElasticEvent:
    item = item.strip()
    if "@" not in item:
        raise ValueError(f"bad plan item {item!r}: missing '@step'")
    head, step_s = item.rsplit("@", 1)
    step = int(step_s)
    if head == "restart":
        return ElasticEvent(step=step, kind="restart")
    if ":" not in head:
        raise ValueError(f"bad plan item {item!r}: want kind:args@step")
    kind, arg = head.split(":", 1)
    if kind == "crash":
        if not arg.startswith("w"):
            raise ValueError(f"bad plan item {item!r}: want crash:wN@T")
        return ElasticEvent(step=step, kind="crash", worker=int(arg[1:]))
    if kind == "resize":
        return ElasticEvent(step=step, kind="resize", workers=int(arg))
    if kind == "slow":
        if not arg.startswith("w") or "x" not in arg:
            raise ValueError(f"bad plan item {item!r}: want slow:wNxF@T")
        w_s, f_s = arg[1:].split("x", 1)
        return ElasticEvent(step=step, kind="slow", worker=int(w_s),
                            factor=float(f_s))
    raise ValueError(f"bad plan item {item!r}: unknown kind {kind!r}")


class EventPlan:
    """An ordered, immutable schedule of elastic events."""

    def __init__(self, events: Iterable[ElasticEvent] = ()):
        self.events: Tuple[ElasticEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, KINDS.index(e.kind))))

    @classmethod
    def parse(cls, text: str) -> "EventPlan":
        text = text.strip()
        if not text:
            return cls()
        return cls(_parse_item(i) for i in text.split(","))

    def spec(self) -> str:
        return ",".join(e.spec() for e in self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def needs_checkpoints(self) -> bool:
        return any(e.kind in ("crash", "restart") for e in self.events)

    def start(self) -> "PlanRun":
        return PlanRun(self)


class PlanRun:
    """Consume-once cursor over a plan: ``take(t)`` returns the not-yet
    consumed events scheduled at or before step t.  After a crash rolls
    the run back, already-consumed events (including the crash itself)
    stay consumed — a plan fires each event exactly once.

    The cursor remembers what it consumed (``consumed_specs``) so the
    elastic trainer can persist it in checkpoints: a preempted-and-
    resumed run must not re-fire events its previous incarnation already
    lived through, and "already fired" is NOT derivable from the resume
    step alone (a crash rollback restores a checkpoint *earlier* than the
    crash event it consumed)."""

    def __init__(self, plan: EventPlan):
        self._pending: List[ElasticEvent] = list(plan.events)
        self._consumed: List[ElasticEvent] = []

    def take(self, step: int) -> List[ElasticEvent]:
        due = [e for e in self._pending if e.step <= step]
        self._pending = [e for e in self._pending if e.step > step]
        self._consumed.extend(due)
        return due

    def take_one(self, step: int) -> "ElasticEvent | None":
        """Pop and return the next due event only — a crash rollback can
        then leave the rest of the batch pending so nothing is lost."""
        for i, e in enumerate(self._pending):
            if e.step <= step:
                self._consumed.append(e)
                return self._pending.pop(i)
        return None

    def consumed_specs(self) -> List[str]:
        """Specs of every event fired so far, in firing order."""
        return [e.spec() for e in self._consumed]

    def mark_consumed(self, specs: Sequence[str]) -> None:
        """Replay a previous incarnation's consumption record (from a
        checkpoint): each spec removes one matching pending event."""
        for spec in specs:
            for i, e in enumerate(self._pending):
                if e.spec() == spec:
                    self._consumed.append(self._pending.pop(i))
                    break

    @property
    def pending(self) -> Tuple[ElasticEvent, ...]:
        return tuple(self._pending)


# ----------------------------------------------------------- typed plans
@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Worker crashes: ``crashes = ((step, worker), ...)``."""
    crashes: Tuple[Tuple[int, int], ...] = ()

    def events(self) -> List[ElasticEvent]:
        return [ElasticEvent(step=s, kind="crash", worker=w)
                for s, w in self.crashes]


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """Scheduler-driven resizes: ``resizes = ((step, new_workers), ...)``."""
    resizes: Tuple[Tuple[int, int], ...] = ()

    def events(self) -> List[ElasticEvent]:
        return [ElasticEvent(step=s, kind="resize", workers=m)
                for s, m in self.resizes]


@dataclasses.dataclass(frozen=True)
class StragglerPlan:
    """Worker slowdowns: ``slows = ((step, worker, factor), ...)``."""
    slows: Tuple[Tuple[int, int, float], ...] = ()

    def events(self) -> List[ElasticEvent]:
        return [ElasticEvent(step=s, kind="slow", worker=w, factor=f)
                for s, w, f in self.slows]


def merge_plans(*plans) -> EventPlan:
    """Combine EventPlans and/or typed plans into one schedule."""
    events: List[ElasticEvent] = []
    for p in plans:
        if isinstance(p, EventPlan):
            events.extend(p.events)
        else:
            events.extend(p.events())
    return EventPlan(events)


# -------------------------------------------------- scheduler → trainer
def plan_from_sched_trace(trace: Sequence, jid: int,
                          steps_per_sec: float = 1.0,
                          nominal_gpus: int = 0) -> EventPlan:
    """Convert one job's ``sched/`` simulator allocation trace into an
    event plan against the job's own training-step clock.

    ``trace`` rows are the simulator's ``TraceEvent``s (time, jid, kind
    in start/suspend/resume/finish, gpus).  The job's step clock advances
    at ``steps_per_sec`` only while it holds an allocation.  A resume at
    the same GPU count becomes a ``restart`` (Gandiva suspend/resume =
    checkpoint + restore); a resume at a different count becomes a
    ``resize`` (elastic re-allocation).  Pass the job's requested size as
    ``nominal_gpus`` so a *shrunk start* (``simulate(elastic=True)``
    granting fewer GPUs than requested) also emits its initial
    ``resize`` — the trainer is assumed to be configured at the nominal
    size."""
    rows = sorted((e for e in trace if e.jid == jid), key=lambda e: e.t)
    events: List[ElasticEvent] = []
    steps = 0.0
    cur_gpus = None
    run_from = None
    for e in rows:
        if e.kind == "start":
            if nominal_gpus and e.gpus != nominal_gpus:
                events.append(ElasticEvent(step=int(round(steps)),
                                           kind="resize", workers=e.gpus))
            cur_gpus, run_from = e.gpus, e.t
        elif e.kind == "suspend" and run_from is not None:
            steps += (e.t - run_from) * steps_per_sec
            run_from = None
        elif e.kind == "resume":
            at = max(1, int(round(steps)))
            if cur_gpus is not None and e.gpus != cur_gpus:
                events.append(ElasticEvent(step=at, kind="resize",
                                           workers=e.gpus))
            else:
                events.append(ElasticEvent(step=at, kind="restart"))
            cur_gpus, run_from = e.gpus, e.t
        elif e.kind == "finish" and run_from is not None:
            steps += (e.t - run_from) * steps_per_sec
            run_from = None
    return EventPlan(events)
