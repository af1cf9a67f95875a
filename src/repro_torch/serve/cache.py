"""Paged KV cache (the JAX package's ``serve/cache.py``, for the port's
per-layer caches; vLLM-style block management, arXiv 2111.14247).

  * full attention caches ``[B, L, KV, hd]`` and MLA latents ``[B, L,
    r]`` are re-laid-out as fixed-size **page pools** ``[num_pages, page,
    ...]`` shared by every batch slot, addressed through per-slot **block
    tables** (logical page -> physical page);
  * a **BlockAllocator** hands pages out at admission and takes them back
    on completion, so an over-subscribed pool *stalls admission* instead
    of running out of memory;
  * ring buffers (``local`` layers), recurrent states (RG-LRU's ``h`` and
    ``conv``, RWKV's ``S`` and shifts) and whole caches in contiguous
    mode stay per-slot leaves ``[slots, ...]``; admission overwrites
    every leaf of the slot, so nothing of a released request leaks into
    the next.

Physical page 0 is the null/scratch page: fresh block tables point at it
and *inactive* batch slots scatter their garbage decode rows into it, so
the decode step needs no masking branches.  As in the JAX package, decode
runs on the contiguous view ``gather`` builds and ``scatter`` writes the
new row back; a kernel that reads pages through the block table is later
work.

Tensor-parallel decode (``tp > 1``, ``serve/tp.py``) keeps every cache
leaf rank-major, ``[tp, ..., KV/tp, hd]``: rank r's rows are one
contiguous block, so the gather hands each rank's ``flash_decode`` a
contiguous cache without a copy per rank.  With ``rank`` (one process
per tensor rank) a store holds only that rank's heads, ``[1, ...,
KV/tp, hd]``: 1/tp of the cache bytes.  The JAX package shards the same
KV-head axis over devices.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import get_path, leaf_paths, tree_map
from repro_torch.models.transformer import paged_layers


def cache_bytes(caches) -> int:
    """Bytes of every tensor of a cache tree (``numel x element_size``)."""
    leaves = (get_path(caches, p) for p in leaf_paths(caches))
    return sum(t.numel() * t.element_size() for t in leaves)


# ------------------------------------------------------------- allocator
class BlockAllocator:
    """Free-list page allocator.  Page 0 is reserved (null/scratch)."""

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(f"num_pages={num_pages} <= reserved={reserved}")
        self.num_pages = num_pages
        self.reserved = reserved
        self._free: List[int] = list(range(reserved, num_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.num_pages - self.reserved

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise MemoryError(
                f"paged KV pool exhausted: want {n}, free {len(self._free)} "
                "(admission should have stalled)")
        pages, self._free = self._free[:n], self._free[n:]
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p < self.reserved or p >= self.num_pages:
                raise ValueError(f"freeing invalid page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)


# ------------------------------------------------------------- KV stores
def shard_kv(t, tp: int, rank: Optional[int] = None):
    """A cache leaf ``[..., KV, hd]`` -> rank-major ``[tp, ..., KV/tp,
    hd]`` (rank r holds KV heads r*KV/tp ... (r+1)*KV/tp - 1), or with
    ``rank`` that rank's block alone, ``[1, ..., KV/tp, hd]``; ``tp == 1``
    returns ``t``."""
    if tp == 1:
        return t
    chunks = t.chunk(tp, dim=t.dim() - 2)
    return torch.stack(chunks if rank is None else chunks[rank:rank + 1])


def _lead(tp: int):
    """Index prefix that passes the rank axis of a rank-major leaf."""
    return (slice(None),) * (tp > 1)


class ContiguousKV:
    """One ``init_cache(slots, max_len)`` per layer, every slot owning its
    full-length rows.  Same interface as ``PagedKV``."""

    paged = False

    def __init__(self, model, slots: int, max_len: int, dtype=torch.float32,
                 window_override: int = 0, device="cpu", tp: int = 1,
                 rank: Optional[int] = None):
        self.slots, self.max_len, self.tp, self.rank = (slots, max_len, tp,
                                                        rank)
        self.store = tree_map(
            lambda t: shard_kv(t, tp, rank),
            model.init_cache(slots, max_len, dtype=dtype,
                             window_override=window_override, device=device))

    def block_tables_device(self):
        return None                       # contiguous mode has no tables

    def gather(self, store, bt):
        return store

    def scatter(self, store, new_caches, bt, pos, active):
        # decode already wrote each slot's row in place (inactive slots
        # scribble at pos 0 of their own free rows)
        return new_caches

    def try_reserve(self, request) -> bool:
        return request.total_len <= self.max_len

    def write_prefill(self, slot: int, conv_cache, j: int, prompt_len: int):
        """Copy request ``j``'s rows of a converted (decode-layout) prefill
        cache into batch slot ``slot``."""
        for dst, src in zip(self.store, conv_cache):
            for name in dst:
                dst[name][_lead(self.tp) + (slot,)] = shard_kv(
                    src[name][j], self.tp, self.rank)

    def release(self, slot: int, request) -> None:
        pass                              # rows are overwritten on admit


class PagedKV:
    """Fixed-size page pools + per-slot block tables over the attention
    caches."""

    paged = True

    def __init__(self, model, slots: int, max_len: int, page_size: int,
                 num_pages: Optional[int] = None, dtype=torch.float32,
                 window_override: int = 0, device="cpu", tp: int = 1,
                 rank: Optional[int] = None):
        if page_size <= 0:
            raise ValueError("page_size must be > 0 for PagedKV")
        if window_override:
            raise ValueError("paged cache + window_override unsupported "
                             "(ring buffers are already constant-size)")
        self.pooled = paged_layers(model.cfg)
        self.slots, self.max_len, self.page = slots, max_len, page_size
        self.device, self.tp, self.rank = torch.device(device), tp, rank
        self.pages_per_seq = math.ceil(max_len / page_size)
        if num_pages is None:
            # default: every slot can hold a full-length request, +1 null
            num_pages = 1 + slots * self.pages_per_seq
        self.allocator = BlockAllocator(num_pages, reserved=1)
        self.block_tables = np.zeros((slots, self.pages_per_seq), np.int64)
        # paged layers: [slots, page, *rest] -> pool [num_pages, page,
        # *rest]; the other layers keep their per-slot leaves
        template = model.init_cache(slots, page_size, dtype=dtype,
                                    device=device)
        self.store = [
            tree_map(lambda t: shard_kv(
                t.new_zeros((num_pages,) + t.shape[1:]) if pooled else t,
                tp, rank), layer)
            for layer, pooled in zip(template, self.pooled)]

    def block_tables_device(self):
        return torch.from_numpy(self.block_tables).to(self.device)

    def gather(self, store, bt):
        """Page pools -> the contiguous ``[B, L, ...]`` view decode reads
        (a copy per paged layer; rank-major ``[tp, B, L, ...]`` under
        tp); per-slot leaves pass as they are."""
        lead = _lead(self.tp)

        def g(pool):
            v = pool[lead + (bt,)]         # [*lead, B, P, page, ...]
            n = len(lead)
            v = v.reshape(v.shape[:n + 1] + (-1,) + v.shape[n + 3:])
            return v.narrow(n + 1, 0, self.max_len).contiguous()
        return [tree_map(g, layer) if pooled else layer
                for layer, pooled in zip(store, self.pooled)]

    def scatter(self, store, new_caches, bt, pos, active):
        """Write the row each slot just produced (at ``pos`` [B]) back to
        its page in place (inactive slots are routed to null page 0); a
        per-slot layer's new leaves replace its old ones."""
        phys = torch.where(active, bt.gather(1, (pos // self.page)[:, None])[:, 0],
                           torch.zeros_like(pos))
        off = pos % self.page
        rows = torch.arange(pos.shape[0], device=pos.device)
        lead = _lead(self.tp)
        for i, (pools, new) in enumerate(zip(store, new_caches)):
            if not self.pooled[i]:
                store[i] = new
                continue
            for name, pool in pools.items():
                pool[lead + (phys, off)] = \
                    new[name][lead + (rows, pos)].to(pool.dtype)
        return store

    def try_reserve(self, request) -> bool:
        """Reservation-based admission: take every page the request can
        ever touch (prompt + max_new) up front, or refuse."""
        if request.total_len > self.max_len:
            return False
        n = math.ceil(request.total_len / self.page)
        if not self.allocator.can_alloc(n):
            return False
        request.pages = self.allocator.alloc(n)
        return True

    def write_prefill(self, slot: int, conv_cache, j: int, prompt_len: int):
        """Scatter request ``j``'s prompt rows of a converted prefill cache
        into its reserved pages; per-slot leaves take request ``j``'s
        row whole."""
        ts = np.arange(prompt_len)
        phys = torch.from_numpy(self.block_tables[slot][ts // self.page])
        off = torch.from_numpy(ts % self.page)
        phys, off = phys.to(self.device), off.to(self.device)
        lead = _lead(self.tp)
        for pooled, pools, src in zip(self.pooled, self.store, conv_cache):
            for name, pool in pools.items():
                if pooled:
                    rows = shard_kv(src[name][j, :prompt_len], self.tp,
                                    self.rank)
                    pool[lead + (phys, off)] = rows.to(pool.dtype)
                else:
                    pool[lead + (slot,)] = shard_kv(
                        src[name][j], self.tp, self.rank).to(pool.dtype)

    def set_block_table(self, slot: int, pages: Sequence[int]) -> None:
        row = np.zeros(self.pages_per_seq, np.int64)
        row[:len(pages)] = pages
        self.block_tables[slot] = row

    def release(self, slot: int, request) -> None:
        if request.pages:
            self.allocator.free(request.pages)
            request.pages = []
        self.block_tables[slot] = 0


def make_kv_store(model, slots: int, max_len: int, page_size: int = 0,
                  num_pages: Optional[int] = None, dtype=torch.float32,
                  window_override: int = 0, device="cpu", tp: int = 1,
                  rank: Optional[int] = None):
    """page_size == 0 -> contiguous; > 0 -> paged pools.  ``tp > 1`` lays
    every leaf out rank-major for tensor-parallel decode; ``rank`` keeps
    that tensor rank's heads only (one process per rank)."""
    kw = dict(dtype=dtype, window_override=window_override, device=device,
              tp=tp, rank=rank)
    if page_size:
        return PagedKV(model, slots, max_len, page_size, num_pages, **kw)
    return ContiguousKV(model, slots, max_len, **kw)
