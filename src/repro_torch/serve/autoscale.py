"""Sched-driven autoscaling for the serving plane (the JAX package's
``serve/autoscale.py``; host code).

A serving deployment is treated as one more **tenant of the cluster
scheduler**: the autoscaler watches the open-loop arrival trace, estimates
the request rate over a sliding window, converts it into a desired replica
count, and emits the scale decisions as the *same* ``TraceEvent`` stream
the ``sched/`` simulator produces for training jobs — a suspend/resume
pair at a new GPU count.  ``elastic.events.plan_from_sched_trace``
then turns that stream into an elastic ``EventPlan`` (resumes at a new
size become ``resize`` events), closing the loop

    arrival trace -> rate estimate -> replicas -> TraceEvents -> EventPlan

so serving replicas ride exactly the scheduler->trainer plumbing of
elastic training.  ``serve_job`` exposes the deployment as a
``sched.jobs.Job`` so it can be co-scheduled against training tenants in
``sched.simulator.simulate``; ``simulate_queue`` replays the arrival trace
against a replica schedule to compare queueing delay (the p99-wait payoff
of scaling up under load).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.elastic.events import EventPlan, plan_from_sched_trace
from repro_torch.obs.trace import emit_sched_trace, get_recorder
from repro_torch.sched.jobs import Job
from repro_torch.sched.simulator import TraceEvent


def poisson_trace(rate: float, horizon: float, seed: int = 0,
                  max_requests: Optional[int] = None) -> List[float]:
    """Open-loop Poisson arrivals: exponential inter-arrival times at
    ``rate`` req/s over ``horizon`` seconds (the serving benchmark's load
    generator — arrivals do NOT wait for completions)."""
    rng = np.random.RandomState(seed)
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= horizon or (max_requests and len(out) >= max_requests):
            return out
        out.append(t)


class RateEstimator:
    """Sliding-window arrival-rate estimate (req/s over the last
    ``window`` seconds), the autoscaler's only load signal."""

    def __init__(self, window: float = 10.0):
        self.window = window
        self._arrivals: List[float] = []

    def observe(self, t: float) -> None:
        self._arrivals.append(t)

    def rate(self, now: float) -> float:
        lo = now - self.window
        n = sum(1 for t in self._arrivals if lo < t <= now)
        return n / min(self.window, now) if now > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """``replica_rate``: req/s one replica sustains (measured, e.g. from a
    serve_bench row).  ``scale_down_patience``: consecutive intervals the
    desired count must stay below current before shrinking (hysteresis —
    scaling down evicts batch slots, so it should lag the signal)."""
    replica_rate: float = 1.0
    min_replicas: int = 1
    max_replicas: int = 8
    interval: float = 5.0          # seconds between decisions
    scale_down_patience: int = 2

    def desired(self, rate: float) -> int:
        want = math.ceil(rate / self.replica_rate) if rate > 0 else 0
        return max(self.min_replicas, min(self.max_replicas, want))


@dataclasses.dataclass
class ScaleDecision:
    t: float
    rate: float
    replicas: int


class Autoscaler:
    """Replays an arrival trace through the rate estimator and policy,
    producing the replica schedule and its sched-plane TraceEvents."""

    def __init__(self, policy: AutoscalePolicy, jid: int = 0,
                 window: float = 10.0):
        self.policy = policy
        self.jid = jid
        self.estimator = RateEstimator(window)

    def schedule(self, arrivals: Sequence[float], horizon: float,
                 burn_times: Optional[Sequence[float]] = None
                 ) -> List[ScaleDecision]:
        """``burn_times`` (optional) are SLO alert instants from a
        monitored serve engine (``ServeEngine.slo_alerts``): a decision
        interval containing a burn forces at least a one-replica
        scale-up and resets the scale-down hysteresis — a burning SLO
        outranks the arrival-rate signal (obs/slo.py)."""
        pol = self.policy
        arrivals = sorted(arrivals)
        burns = sorted(burn_times) if burn_times else []
        decisions: List[ScaleDecision] = []
        cur = pol.min_replicas
        below = 0
        i = 0
        steps = int(math.ceil(horizon / pol.interval))
        decisions.append(ScaleDecision(0.0, 0.0, cur))
        for k in range(1, steps + 1):
            now = k * pol.interval
            while i < len(arrivals) and arrivals[i] <= now:
                self.estimator.observe(arrivals[i])
                i += 1
            rate = self.estimator.rate(now)
            want = pol.desired(rate)
            burning = any(now - pol.interval < b <= now for b in burns)
            if burning:
                want = max(want, min(pol.max_replicas, cur + 1))
            if want > cur:
                cur, below = want, 0          # scale up immediately
            elif want < cur and not burning:
                below += 1                    # hysteresis on the way down
                if below >= pol.scale_down_patience:
                    cur, below = want, 0
            else:
                below = 0
            if cur != decisions[-1].replicas:
                rec = get_recorder()
                if rec.enabled:
                    extra = {"reason": "slo_burn"} if burning else {}
                    rec.instant("autoscale_decision", pid="serve",
                                tid="autoscale", cat="serve",
                                clock=("sched_time", now), jid=self.jid,
                                rate=round(rate, 6),
                                from_replicas=decisions[-1].replicas,
                                to_replicas=cur, **extra)
                decisions.append(ScaleDecision(now, rate, cur))
        return decisions

    def to_trace(self, decisions: Sequence[ScaleDecision]) -> List[TraceEvent]:
        """Scale decisions as the sched simulator's allocation stream: a
        start at the initial size, then a suspend/resume pair per change
        (resume at a new GPU count == elastic resize downstream)."""
        if not decisions:
            return []
        ev = [TraceEvent(decisions[0].t, self.jid, "start",
                         decisions[0].replicas)]
        cur = decisions[0].replicas
        for d in decisions[1:]:
            ev.append(TraceEvent(d.t, self.jid, "suspend", cur))
            ev.append(TraceEvent(d.t, self.jid, "resume", d.replicas))
            cur = d.replicas
        return ev

    def plan(self, arrivals: Sequence[float], horizon: float,
             steps_per_sec: float = 1.0,
             burn_times: Optional[Sequence[float]] = None
             ) -> Tuple[EventPlan, List[ScaleDecision]]:
        """arrival trace -> elastic EventPlan (resize events on the
        deployment's own step clock), via the shared sched plumbing."""
        decisions = self.schedule(arrivals, horizon, burn_times=burn_times)
        trace = self.to_trace(decisions)
        # the deployment's allocation stream rides the shared sched
        # timeline, next to any co-scheduled training tenants
        emit_sched_trace(get_recorder(), trace, pid="sched")
        return (plan_from_sched_trace(trace, self.jid,
                                      steps_per_sec=steps_per_sec),
                decisions)


def replicas_at(decisions: Sequence[ScaleDecision], t: float) -> int:
    cur = decisions[0].replicas if decisions else 1
    for d in decisions:
        if d.t <= t:
            cur = d.replicas
        else:
            break
    return cur


def simulate_queue(arrivals: Sequence[float],
                   decisions: Sequence[ScaleDecision],
                   service_time: float,
                   horizon: float) -> dict:
    """Replay the arrival trace against a replica schedule: each replica
    serves one request per ``service_time`` seconds (single-slot fluid
    approximation).  Returns queueing-delay stats — the metric autoscaling
    is supposed to buy down versus a fixed fleet."""
    free_at: List[float] = []        # per-replica next-free times
    waits: List[float] = []
    for t in sorted(arrivals):
        n = replicas_at(decisions, t)
        while len(free_at) < n:
            free_at.append(t)
        busy = sorted(free_at[:n])
        start = max(t, busy[0])
        # assign to the earliest-free replica of the current fleet
        idx = free_at.index(busy[0])
        free_at[idx] = start + service_time
        waits.append(start - t)
    waits.sort()
    if not waits:
        return {"completed": 0, "p50_wait": 0.0, "p99_wait": 0.0,
                "max_wait": 0.0}
    q = lambda p: waits[min(len(waits) - 1,
                            int(round(p / 100 * (len(waits) - 1))))]
    return {"completed": len(waits), "p50_wait": q(50), "p99_wait": q(99),
            "max_wait": waits[-1]}


def serve_job(jid: int, horizon: float, replicas: int,
              arrival: float = 0.0) -> Job:
    """The deployment as a cluster-scheduler tenant: a long-running job
    holding ``replicas`` GPUs for ``horizon`` seconds, co-schedulable
    against training jobs in ``sched.simulator.simulate`` (its allocation
    trace feeds ``plan_from_sched_trace`` exactly like a training job's)."""
    return Job(jid=jid, arrival=arrival, num_gpus=replicas, epochs=1,
               epoch_time_1gpu=horizon * (replicas ** 0.9),
               scaling_alpha=0.9)
