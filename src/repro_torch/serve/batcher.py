"""Continuous-batching admission control (the JAX package's
``serve/batcher.py``; iteration-level scheduling, arXiv 2209.01341).

The batcher owns the request queue and the batch-slot map; the engine asks
it once per iteration which QUEUED requests to admit.  Two policies:

``continuous``
    Admit whenever a batch slot *and* the cache reservation are available
    (``KVStore.try_reserve``).  Admission is FIFO without head-of-line
    bypass: if the oldest queued request cannot reserve pages, the
    iteration records a **stall** and admits nothing behind it.

``oneshot``
    The static-batching baseline: requests are only admitted when every
    slot is free, then as many as fit.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.serve.request import Request, RequestState

POLICIES = ("continuous", "oneshot")


class Batcher:
    def __init__(self, kv_store, slots: int, policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.kv = kv_store
        self.slots = slots
        self.policy = policy
        self.queue: List[Request] = []          # FIFO by submission order
        self.running: List[Optional[Request]] = [None] * slots
        self.stalls = 0          # iterations a reservable-slot head couldn't
                                 # get pages (pool pressure, not slot pressure)

    def submit(self, request: Request) -> None:
        if request.state is not RequestState.QUEUED:
            raise ValueError(f"request {request.rid} already admitted")
        self.queue.append(request)

    @property
    def num_running(self) -> int:
        return sum(1 for r in self.running if r is not None)

    @property
    def idle(self) -> bool:
        return self.num_running == 0 and not self.queue

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival for r in self.queue), default=None)

    def _free_slot(self) -> int:
        for i, r in enumerate(self.running):
            if r is None:
                return i
        return -1

    def admit(self, now: float) -> List[Request]:
        """Pick the QUEUED requests (arrived by ``now``) that join the
        batch this iteration; reserves their slot and cache pages."""
        if self.policy == "oneshot" and self.num_running > 0:
            return []
        admitted: List[Request] = []
        while self.queue and self.queue[0].arrival <= now:
            slot = self._free_slot()
            if slot < 0:
                break
            head = self.queue[0]
            if not self.kv.try_reserve(head):
                # FIFO head can't get pages: stall rather than bypass
                if head.total_len > self.kv.max_len:
                    raise ValueError(
                        f"request {head.rid} needs {head.total_len} tokens "
                        f"> max_len {self.kv.max_len}: can never be served")
                self.stalls += 1
                break
            self.queue.pop(0)
            head.state = RequestState.PREFILL
            head.slot = slot
            head.admit_time = now
            self.running[slot] = head
            if hasattr(self.kv, "set_block_table"):
                self.kv.set_block_table(slot, head.pages)
            admitted.append(head)
        return admitted

    def release(self, request: Request) -> None:
        """Return a DONE request's slot and pages to the pool."""
        if request.state is not RequestState.DONE:
            raise ValueError(f"request {request.rid} not done")
        slot = request.slot
        if slot < 0 or self.running[slot] is not request:
            raise ValueError(f"request {request.rid} does not own slot {slot}")
        self.running[slot] = None
        self.kv.release(slot, request)
        request.slot = -1
