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
     sample -> scatter the new KV row back to its page.

The engine clock is **virtual iteration time** — each prefill group and
each decode iteration costs 1.0 — so latencies are deterministic and
machine-independent; ``run`` also reports wall seconds.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a host without CUDA raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.batcher import Batcher
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


class ServeEngine:
    def __init__(self, model, params, scfg: ServeConfig, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.model, self.params, self.scfg = model, params, scfg
        self.cfg = model.cfg
        self.vocab = self.cfg.vocab_size
        self.kv = make_kv_store(
            model, scfg.slots, scfg.max_len, scfg.page_size, scfg.num_pages,
            dtype=scfg.cache_dtype, window_override=scfg.window_override,
            device=self.device)
        self.batcher = Batcher(self.kv, scfg.slots, scfg.policy)

        self.requests: List[Request] = []
        self.clock = 0.0
        self.decode_iterations = 0
        self.prefill_groups = 0

        B = scfg.slots
        self._last_tok = np.zeros(B, np.int64)
        self._seeds = np.zeros(B, np.int64)
        self._temp = np.zeros(B, np.float32)
        self._topk = np.zeros(B, np.int64)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # --------------------------------------------------------- lifecycle
    def submit(self, request: Request) -> None:
        self.requests.append(request)
        self.batcher.submit(request)

    def _finish(self, r: Request) -> None:
        r.state = RequestState.DONE
        r.finish_time = self.clock
        self.batcher.release(r)

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
        for plen in sorted(groups):
            rs = groups[plen]
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
        logits, new = self.model.decode_step(
            self.params, contig, self._to_device(self._last_tok)[:, None],
            pos_d, compute_dtype=self.scfg.compute_dtype,
            window_override=self.scfg.window_override)
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

    def step_iteration(self) -> bool:
        """One engine iteration: admit+prefill, then one decode step.
        Returns False when nothing could make progress at this clock
        (the caller should jump the clock to the next arrival)."""
        progressed = False
        admitted = self.batcher.admit(self.clock)
        if admitted:
            self._prefill(admitted)
            progressed = True
        if any(r is not None and r.state is RequestState.DECODE
               for r in self.batcher.running):
            self._decode_iteration()
            progressed = True
        return progressed

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
            clock=self.clock,
            decode_iterations=self.decode_iterations,
            prefill_groups=self.prefill_groups,
            admission_stalls=self.batcher.stalls,
            wall_s=wall,
        )
        return m
