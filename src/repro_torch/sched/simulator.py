"""Discrete-event multi-tenant scheduling simulator (survey §3.4.2; the JAX
package's ``sched/simulator.py``, result for result).

Events: job arrival, job finish, re-schedule quantum.  The policy reorders
the queue at every event; `gandiva=True` adds time-slicing (suspend/resume
at a fixed quantum — Gandiva's introspective primitive) so more jobs make
early progress (which is where the DL loss curves earn the most).

Outputs per policy: makespan, average JCT, mean time-to-90%-quality —
the metrics the survey's scheduling papers optimize.

Every allocation decision is also recorded as a ``TraceEvent`` stream
(start/suspend/resume/finish with the granted GPU count), and
``elastic=True`` lets a queued job start *shrunk* (largest power-of-two
share of the free GPUs) instead of waiting for its full request — so a
sliced-out job may resume at a different size.  The trace is what
``repro_torch.elastic.events.plan_from_sched_trace`` converts into an elastic
training plan, closing the scheduler↔trainer loop.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, NamedTuple, Optional

from repro_torch.sched.cluster import Cluster
from repro_torch.sched.jobs import Job
from repro_torch.sched.policies import GANDIVA_SLICE, POLICIES


class TraceEvent(NamedTuple):
    """One allocation decision: job ``jid`` started / was suspended /
    resumed / finished at time ``t`` holding ``gpus`` GPUs."""
    t: float
    jid: int
    kind: str               # start | suspend | resume | finish
    gpus: int


@dataclasses.dataclass
class SimResult:
    policy: str
    makespan: float
    avg_jct: float
    avg_queue_delay: float
    mean_t90: float          # mean time until 90% of final quality reached
    events: int
    trace: List[TraceEvent] = dataclasses.field(default_factory=list)


def simulate(jobs: List[Job], cluster: Cluster, policy: str = "fifo",
             gandiva: bool = False, quantum: float = GANDIVA_SLICE,
             elastic: bool = False) -> SimResult:
    order_fn = POLICIES[policy]
    jobs = [dataclasses.replace(j) for j in jobs]      # fresh copies
    for j in jobs:
        j.start, j.finish, j.epochs_done = None, None, 0.0

    # event heap: (time, seq, kind, jid)
    ev: List = []
    seq = 0
    for j in jobs:
        heapq.heappush(ev, (j.arrival, seq, "arrive", j.jid)); seq += 1
    by_id = {j.jid: j for j in jobs}
    queue: List[Job] = []
    running: Dict[int, dict] = {}       # jid -> {rate, last_update, gpus}
    t90: Dict[int, float] = {}
    trace: List[TraceEvent] = []
    started: set = set()
    now = 0.0
    n_events = 0

    def progress_to(t: float):
        for jid, st in running.items():
            j = by_id[jid]
            dt = t - st["last"]
            j.epochs_done = min(j.epochs,
                                j.epochs_done + dt / st["sec_per_epoch"])
            st["last"] = t
            if jid not in t90 and j.epochs_done >= 0.9 * j.epochs:
                frac = j.epochs_done / j.epochs
                t90[jid] = t if frac >= 0.9 else t
        # t90 approximation: first event time at/after crossing

    def try_start():
        nonlocal seq
        for j in order_fn(queue, now):
            n = j.num_gpus
            slowdown = cluster.try_alloc(j.jid, n)
            if slowdown is None and elastic and cluster.free_gpus > 0:
                # elastic shrink: run now on the largest power-of-two
                # share of the free GPUs instead of queueing for the full
                # request (the job resumes resized — the trainer reshards)
                n = 1
                while n * 2 <= min(cluster.free_gpus, j.num_gpus):
                    n *= 2
                slowdown = cluster.try_alloc(j.jid, n)
            if slowdown is None:
                continue
            queue.remove(j)
            if j.start is None:
                j.start = now
            spe = j.epoch_time(n) * slowdown
            running[j.jid] = {"sec_per_epoch": spe, "last": now, "gpus": n}
            trace.append(TraceEvent(
                now, j.jid,
                "start" if j.jid not in started else "resume", n))
            started.add(j.jid)
            eta = now + j.remaining_epochs * spe
            heapq.heappush(ev, (eta, seq, "finish", j.jid)); seq += 1
            if gandiva:
                heapq.heappush(ev, (now + quantum, seq, "slice", j.jid))
                seq += 1

    while ev:
        now, _, kind, jid = heapq.heappop(ev)
        n_events += 1
        j = by_id[jid]
        progress_to(now)
        if kind == "arrive":
            queue.append(j)
            try_start()
        elif kind == "finish":
            if jid not in running:
                continue                    # stale event (job was sliced out)
            if j.remaining_epochs > 1e-6:
                continue                    # stale eta from before a slice
            st = running.pop(jid)
            cluster.release(jid)
            j.finish = now
            t90.setdefault(jid, now)
            trace.append(TraceEvent(now, jid, "finish", st["gpus"]))
            try_start()
        elif kind == "slice":
            if jid not in running or j.remaining_epochs <= 1e-6:
                continue
            # suspend and requeue (Gandiva suspend-resume)
            st = running.pop(jid)
            cluster.release(jid)
            queue.append(j)
            trace.append(TraceEvent(now, jid, "suspend", st["gpus"]))
            try_start()

    done = [j for j in jobs if j.finish is not None]
    makespan = max((j.finish for j in done), default=0.0)
    avg_jct = (sum(j.finish - j.arrival for j in done) / len(done)
               if done else float("inf"))
    avg_qd = (sum((j.start or j.arrival) - j.arrival for j in done)
              / len(done) if done else 0.0)
    mean_t90 = (sum(t90[j.jid] - j.arrival for j in done if j.jid in t90)
                / max(1, len(done)))
    return SimResult(policy + ("+gandiva" if gandiva else ""), makespan,
                     avg_jct, avg_qd, mean_t90, n_events, trace)
