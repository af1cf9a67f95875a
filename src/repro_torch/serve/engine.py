"""Step-synchronous serving engine: continuous batching over a paged KV
cache with prefill/decode separation (the JAX package's
``serve/engine.py``).

One ``ServeEngine`` iteration is

  1. **admission** — the batcher moves QUEUED requests into free batch
     slots once their cache pages are reserved (serve/batcher.py);
  2. **prefill** — admitted prompts run as *batched forward passes*
     grouped by prompt length; ``Model.cache_from_prefill`` converts the
     states to decode layout and they are written into the request's
     cache pages; the prompt's last-token logits yield the first token;
  3. **decode** — every slot advances one token in one batched step:
     gather pages -> decode with a position *per slot* (the JAX package
     vmaps ``decode_step`` over slots; here ``pos`` is a [B] tensor) ->
     sample -> scatter the new KV row back to its page.  Ring buffers
     (``local`` layers, at ``pos % window``) and recurrent states
     (RG-LRU, RWKV) stay per slot; admission overwrites every leaf of
     the slot, so a released request leaves nothing to the next.

Tensor-parallel decode (``ServeConfig.tp > 1``, ``serve/tp.py``) runs
the same step over ``tp`` ranks, in one of two modes:

  * **logical** (no ``group``): the ranks take turns in this process; the
    engine keeps a rank-stacked copy of the sharded weights, the cache is
    rank-major on the KV-head axis, and ``decode_step(tp_axis=...)`` sums
    the row-parallel products with ``tensor_reduce``;
  * **per rank** (``group=``, a ``torch.distributed`` process group of
    ``tp`` ranks, one engine per rank): each engine keeps its own shard of
    the sharded weights and only its own KV heads (1/tp of the cache), and
    ``tensor_reduce`` all-gathers the partials over the group and sums
    them in rank order, so every rank gets the logical mode's bits.  Every
    rank samples the same token from the same replicated logits; rank 0
    alone records spans, counters and SLO alerts.

Prefill runs on the whole weights in both, as in the JAX package.

The engine clock is **virtual iteration time** — each prefill group and
each decode iteration costs 1.0 — so latencies are deterministic and
machine-independent; ``run`` also reports wall seconds.

With a recorder installed (``obs.trace.tracing``) the engine records each
request's lifecycle (``queued`` -> ``prefill`` -> ``decode`` spans and a
``done`` instant on ``tid=req<rid>``), ``admission_stall`` instants and
the ``kv_pages`` / ``slots`` occupancy counters, all on the
``serve_iter`` clock.  The hooks read host-side Python state only, so
tracing off costs one attribute read per hook and no device sync.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a host without CUDA raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import get_path, leaf_paths
from repro_torch.models import transformer as T
from repro_torch.obs.trace import NullRecorder, get_recorder
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.cache import cache_bytes as tree_bytes
from repro_torch.serve.cache import make_kv_store
from repro_torch.serve.request import Request, RequestState, summarize
from repro_torch.serve.sampling import sample_tokens


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA must be present to ask for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but this host has no CUDA device; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.  ``page_size == 0`` keeps a contiguous per-slot cache;
    ``> 0`` switches to paged pools (``num_pages`` caps the pool — None
    sizes it so every slot can hold ``max_len``)."""
    slots: int = 4
    max_len: int = 128
    page_size: int = 0
    num_pages: Optional[int] = None
    policy: str = "continuous"           # | "oneshot"
    cache_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    window_override: int = 0
    tp: int = 1                          # tensor-parallel decode degree


class ServeEngine:
    """``slo`` optionally attaches an ``obs.slo.SLOMonitor``: the engine
    feeds it TTFT/TPOT on every completion and a stall sample every
    iteration, emits an ``slo_burn`` instant on each transition into
    firing, and records the alert times in ``slo_alerts``.  ``group``:
    one tensor rank per process of this ``torch.distributed`` group, whose
    size must be ``scfg.tp`` (module docstring); every rank builds an
    engine and runs the same requests."""

    def __init__(self, model, params, scfg: ServeConfig, device="cuda",
                 slo=None, group=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.model, self.params, self.scfg = model, params, scfg
        self.cfg = model.cfg
        self.vocab = self.cfg.vocab_size

        self._tp = None
        axis = None
        if group is not None:
            import torch.distributed as dist

            from repro_torch.core.collectives import DistAxis
            size = dist.get_world_size(group)
            if scfg.tp != size:
                raise ValueError(
                    f"ServeConfig.tp={scfg.tp} over a process group of "
                    f"{size} ranks: tp must equal the group's size (one "
                    "tensor rank per process)")
            axis = DistAxis(group, dist.get_backend(group))
        if scfg.tp > 1:
            from repro_torch.serve.tp import TPContext
            self._tp = TPContext(self.cfg, scfg.tp, axis)
            self._tp_params = self._tp.shard_params(params)
        self._axis = axis
        # one record of the run: a group's rank 0 keeps it
        self.writer = axis is None or axis.rank == 0
        self.slo = slo if self.writer else None
        self.slo_alerts: List[dict] = []
        self._slo_firing = False

        self.kv = make_kv_store(
            model, scfg.slots, scfg.max_len, scfg.page_size, scfg.num_pages,
            dtype=scfg.cache_dtype, window_override=scfg.window_override,
            device=self.device, tp=scfg.tp,
            rank=None if self._tp is None else self._tp.rank)
        self.batcher = Batcher(self.kv, scfg.slots, scfg.policy)

        self.requests: List[Request] = []
        self.clock = 0.0
        self.decode_iterations = 0
        self.prefill_groups = 0
        # rids whose lifecycle spans this engine opened: a request is only
        # ended on the trace if tracing saw it submitted
        self._traced_rids: set = set()

        B = scfg.slots
        self._last_tok = np.zeros(B, np.int64)
        self._seeds = np.zeros(B, np.int64)
        self._temp = np.zeros(B, np.float32)
        self._topk = np.zeros(B, np.int64)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _recorder(self):
        """The trace recorder (a group's other ranks record nothing)."""
        return get_recorder() if self.writer else NullRecorder()

    # --------------------------------------------------------- lifecycle
    def submit(self, request: Request) -> None:
        self.requests.append(request)
        self.batcher.submit(request)
        rec = self._recorder()
        if rec.enabled:
            # lifecycle track per request: QUEUED -> PREFILL -> DECODE
            # spans back to back on tid=req<rid>
            self._traced_rids.add(request.rid)
            rec.begin("queued", pid="serve", tid=f"req{request.rid}",
                      cat="serve", clock=("serve_iter", self.clock),
                      rid=request.rid, prompt_len=request.prompt_len,
                      max_new_tokens=request.max_new_tokens,
                      arrival=request.arrival)

    def _finish(self, r: Request) -> None:
        r.state = RequestState.DONE
        r.finish_time = self.clock
        self.batcher.release(r)
        if self.slo is not None:
            self.slo.observe("ttft", self.clock, r.first_token_latency())
            self.slo.observe("tpot", self.clock, r.per_token_latency())
        rec = self._recorder()
        if rec.enabled and r.rid in self._traced_rids:
            rec.end(pid="serve", tid=f"req{r.rid}",      # closes "decode"
                    generated=len(r.output))
            rec.instant("done", pid="serve", tid=f"req{r.rid}", cat="serve",
                        clock=("serve_iter", self.clock), rid=r.rid)
            self._traced_rids.discard(r.rid)

    def _set_slot(self, r: Request, token: int) -> None:
        i = r.slot
        self._last_tok[i] = token
        self._seeds[i] = r.sampling.seed
        self._temp[i] = r.sampling.temperature
        self._topk[i] = r.sampling.top_k

    def _prefill(self, admitted: Sequence[Request]) -> None:
        """Batched prefill, grouped by prompt length (equal lengths — no
        padding, so ring buffers stay exact)."""
        groups: Dict[int, List[Request]] = {}
        for r in admitted:
            groups.setdefault(r.prompt_len, []).append(r)
        rec = self._recorder()
        for plen in sorted(groups):
            rs = groups[plen]
            if rec.enabled:
                for r in rs:
                    if r.rid in self._traced_rids:
                        rec.end(pid="serve", tid=f"req{r.rid}")  # "queued"
                        rec.begin("prefill", pid="serve",
                                  tid=f"req{r.rid}", cat="serve",
                                  clock=("serve_iter", self.clock),
                                  rid=r.rid, slot=r.slot, group_len=plen)
            toks = self._to_device(np.array([list(r.prompt) for r in rs],
                                            np.int64))
            logits, states = self.model.prefill(
                self.params, toks, compute_dtype=self.scfg.compute_dtype,
                window_override=self.scfg.window_override)
            conv = self.model.cache_from_prefill(
                states, self.scfg.max_len, dtype=self.scfg.cache_dtype,
                window_override=self.scfg.window_override)
            for j, r in enumerate(rs):
                self.kv.write_prefill(r.slot, conv, j, plen)

            # first new token straight from the prefill logits
            t0 = sample_tokens(
                logits[:, 0], self.vocab,
                np.array([r.sampling.seed for r in rs]), np.zeros(len(rs)),
                np.array([r.sampling.temperature for r in rs]),
                np.array([r.sampling.top_k for r in rs])).cpu().numpy()

            self.clock += 1.0
            self.prefill_groups += 1
            for j, r in enumerate(rs):
                tok = int(t0[j])
                r.output.append(tok)
                r.first_token_time = self.clock
                r.state = RequestState.DECODE
                self._set_slot(r, tok)
                if rec.enabled and r.rid in self._traced_rids:
                    rec.end(pid="serve", tid=f"req{r.rid}")  # "prefill"
                    rec.begin("decode", pid="serve", tid=f"req{r.rid}",
                              cat="serve",
                              clock=("serve_iter", self.clock),
                              rid=r.rid, slot=r.slot)
                if len(r.output) >= r.max_new_tokens:
                    self._finish(r)

    def _decode_iteration(self) -> None:
        B = self.scfg.slots
        pos = np.zeros(B, np.int64)
        tok_idx = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        decoding: List[Request] = []
        for i, r in enumerate(self.batcher.running):
            if r is not None and r.state is RequestState.DECODE:
                active[i] = True
                pos[i] = r.prompt_len + len(r.output) - 1
                tok_idx[i] = len(r.output)
                decoding.append(r)
        pos_d = self._to_device(pos)
        bt = self.kv.block_tables_device()
        contig = self.kv.gather(self.kv.store, bt)
        tokens = self._to_device(self._last_tok)[:, None]
        kw = dict(compute_dtype=self.scfg.compute_dtype,
                  window_override=self.scfg.window_override)
        if self._tp is None:
            logits, new = self.model.decode_step(self.params, contig, tokens,
                                                 pos_d, **kw)
        else:
            logits, new = T.decode_step(self._tp_params, self._tp.cfg_local,
                                        contig, tokens, pos_d,
                                        tp_axis=self._tp.tp_axis, **kw)
        nxt = sample_tokens(logits[:, 0], self.vocab, self._seeds, tok_idx,
                            self._temp, self._topk)
        self.kv.store = self.kv.scatter(self.kv.store, new, bt, pos_d,
                                        self._to_device(active))
        self.clock += 1.0
        self.decode_iterations += 1
        nxt = nxt.cpu().numpy()
        for r in decoding:
            tok = int(nxt[r.slot])
            r.output.append(tok)
            self._last_tok[r.slot] = tok
            if len(r.output) >= r.max_new_tokens:
                self._finish(r)

    def _emit_occupancy(self, rec) -> None:
        """Counter tracks: paged-KV pool occupancy (or contiguous slot
        occupancy) sampled once per engine iteration."""
        alloc = getattr(self.kv, "allocator", None)
        clock = ("serve_iter", self.clock)
        if alloc is not None:
            rec.counter("kv_pages",
                        {"used": alloc.capacity - alloc.free_pages,
                         "free": alloc.free_pages},
                        pid="serve", cat="serve", clock=clock)
        busy = sum(r is not None for r in self.batcher.running)
        rec.counter("slots", {"used": busy, "free": self.scfg.slots - busy},
                    pid="serve", cat="serve", clock=clock)

    def step_iteration(self) -> bool:
        """One engine iteration: admit+prefill, then one decode step.
        Returns False when nothing could make progress at this clock
        (the caller should jump the clock to the next arrival)."""
        progressed = False
        rec = self._recorder()
        stalls0 = self.batcher.stalls
        admitted = self.batcher.admit(self.clock)
        if rec.enabled and self.batcher.stalls > stalls0:
            # the FIFO head could not reserve pages/a slot this iteration
            rec.instant("admission_stall", pid="serve", tid="engine",
                        cat="serve", clock=("serve_iter", self.clock),
                        stalls=self.batcher.stalls,
                        free_pages=(self.kv.allocator.free_pages
                                    if getattr(self.kv, "allocator", None)
                                    is not None else -1))
        if admitted:
            self._prefill(admitted)
            progressed = True
        if any(r is not None and r.state is RequestState.DECODE
               for r in self.batcher.running):
            self._decode_iteration()
            progressed = True
        if rec.enabled:
            self._emit_occupancy(rec)
        if self.slo is not None:
            self.slo.observe("stall", self.clock,
                             1.0 if self.batcher.stalls > stalls0 else 0.0)
            self._slo_tick(rec)
        return progressed

    def _slo_tick(self, rec) -> None:
        """Evaluate the attached monitor at the current clock; on a
        transition into firing, record the alert and emit an
        ``slo_burn`` instant on the serve timeline."""
        firing = self.slo.firing(self.clock)
        if firing and not self._slo_firing:
            self.slo_alerts.append(dict(
                t=self.clock,
                objectives=[f["objective"] for f in firing]))
            if rec.enabled:
                rec.instant(
                    "slo_burn", pid="serve", tid="slo", cat="serve",
                    clock=("serve_iter", self.clock),
                    objectives=",".join(f["objective"] for f in firing),
                    burn_long=round(max(f["burn_long"] for f in firing),
                                    4),
                    burn_short=round(max(f["burn_short"] for f in firing),
                                     4))
        self._slo_firing = bool(firing)

    def run(self, requests: Optional[Sequence[Request]] = None) -> dict:
        """Drive every submitted request to DONE; returns the metrics row
        (throughput + latency percentiles on the virtual clock, plus wall
        seconds and stall count)."""
        if requests:
            for r in requests:
                self.submit(r)
        t_wall = time.perf_counter()
        while not self.batcher.idle:
            if not self.step_iteration():
                na = self.batcher.next_arrival()
                if na is None or na <= self.clock:
                    raise RuntimeError(
                        "serving deadlock: queued requests can never be "
                        "admitted (pool too small for any single request?)")
                self.clock = na
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_wall
        m = summarize(self.requests, makespan=self.clock)
        m.update(
            policy=self.scfg.policy,
            paged=bool(self.scfg.page_size),
            page_size=self.scfg.page_size,
            tp=self.scfg.tp,
            clock=self.clock,
            decode_iterations=self.decode_iterations,
            prefill_groups=self.prefill_groups,
            admission_stalls=self.batcher.stalls,
            wall_s=wall,
        )
        if self.slo is not None:
            m["slo_alerts"] = len(self.slo_alerts)
        if self._axis is not None:
            # what each tensor rank holds and staged through the host
            # (Gloo on a card), in rank order
            from repro_torch.core.collectives import gather_values
            mine = (self.cache_bytes(), self.param_bytes(),
                    self._axis.staged_bytes)
            for key, x in zip(("rank_cache_bytes", "rank_param_bytes",
                               "rank_staged_bytes"), mine):
                m[key] = [int(v) for v in gather_values(self._axis, [x])]
        return m

    def cache_bytes(self) -> int:
        """Bytes of the KV store this process holds."""
        return tree_bytes(self.kv.store)

    def param_bytes(self) -> int:
        """Bytes of the weights this process holds: the whole ones
        (prefill) and, under tp, its copy of the sharded ones."""
        n = tree_bytes(self.params)
        if self._tp is not None:
            for p in leaf_paths(self._tp_params):
                t = get_path(self._tp_params, p)
                if t is not get_path(self.params, p):     # a shard copy
                    n += t.numel() * t.element_size()
        return n
