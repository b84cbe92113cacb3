"""KV caches of the serving engine: contiguous slots and fixed-size
pages.
Counterpart: ``singa_tpu/serving/kv_cache.py`` — ``SlotKVCache`` and
``PagedKVCache`` (the fleet's shared index and cross-replica page export
arrive with the fleet slice; ``SlotKVCache.rewind`` with preemption).

:class:`SlotKVCache`: one fixed allocation for the engine's lifetime,
per layer a ``(k, v)`` pair of shape ``(n_slots, n_heads, max_len,
d_head)``; quantized (``kv_dtype="int8"``), 4-leaf layers ``(k, v,
k_scale, v_scale)`` with scales ``(n_slots, n_heads, max_len)`` in
``scale_dtype``.  A slot holds one request's whole row.

:class:`PagedKVCache`: per layer a ``(k_pages, v_pages)`` pair of shape
``(n_pages, n_heads, page_tokens, d_head)``.  A quantized pool holds
4-leaf layers ``(k_pages, v_pages, k_scale, v_scale)``, the scales
shaped ``(n_pages, n_heads, page_tokens)`` in ``scale_dtype``: a page's
rows and their scales share its physical page id, so prefix-shared
pages share their scales and a fresh (copy-on-write) page gets both
written by its own prefill.

Both are updated IN PLACE by the decode blocks (where the JAX package
donates and returns new buffers).  Host side, the allocator and prefix
index, kept as the port's own copy of the JAX package's numpy/hashlib
code:

* physical page 0 is RESERVED: unassigned table entries point at it and
  inactive decode slots park their writes at its last offset;
* every page a request could touch
  (``ceil(min(prompt+max_new, max_len)/page_tokens)``) is granted at
  admission and freed at eviction, so the table row never changes
  mid-request;
* full prompt pages are keyed by a chained sha256 of their token ids;
  an admission maps matched leading pages (refcount +1, no prefill
  compute) except the page holding the last prompt token; divergence
  allocates a fresh page (copy-on-write at page granularity); index-only
  pages are reclaimed LRU under page pressure.

Freed slots and pages are not zeroed: a position is written before the
causal mask lets attention read it, and masked columns weigh exactly
zero.
"""

from __future__ import annotations

import bisect
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..precision import resolve_dtype

__all__ = ["SlotKVCache", "PagedKVCache", "DEFAULT_PAGE_TOKENS"]

# Tokens per KV page (the JAX package's default).
DEFAULT_PAGE_TOKENS = 16


def _page_digest(prev: bytes, page_tokens: np.ndarray) -> bytes:
    """Chained content hash of one FULL prompt page: folding in the
    previous page's digest makes the key depend on the whole prefix."""
    return hashlib.sha256(
        prev + np.ascontiguousarray(page_tokens, np.int32).tobytes()
    ).digest()


class SlotKVCache:
    """Slot-layout KV cache: per layer ``(n_slots, n_heads, max_len,
    d_head)`` K and V (plus their scales when quantized) on ``device``,
    the card unless the CPU is named, and the host's slot allocator.
    ``dtype`` is the float storage; ``kv_dtype`` (int8) quantizes."""

    def __init__(self, n_layers: int, n_slots: int, n_heads: int,
                 max_len: int, d_head: int, dtype=torch.float32,
                 device=None, kv_dtype=None, scale_dtype=torch.bfloat16):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_layers = n_layers
        self.n_slots = n_slots
        self.n_heads = n_heads
        self.max_len = max_len
        self.d_head = d_head
        self.dtype = dtype
        self.kv_dtype = None if kv_dtype is None else resolve_dtype(kv_dtype)
        self.scale_dtype = resolve_dtype(scale_dtype)
        self.device = resolve_device(device)
        shape = (n_slots, n_heads, max_len, d_head)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if self.kv_dtype is None:
            self.caches = tuple((zeros(shape, dtype), zeros(shape, dtype))
                                for _ in range(n_layers))
        else:
            self.caches = tuple(
                (zeros(shape, self.kv_dtype), zeros(shape, self.kv_dtype),
                 zeros(shape[:3], self.scale_dtype),
                 zeros(shape[:3], self.scale_dtype))
                for _ in range(n_layers))
        self._free = list(range(n_slots))               # kept sorted

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.active_slots / self.n_slots

    @property
    def quantized(self) -> bool:
        return self.kv_dtype is not None

    def alloc(self) -> int | None:
        """Claim the lowest free slot, or None when every slot is
        taken."""
        if not self._free:
            return None
        return self._free.pop(0)

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        bisect.insort(self._free, slot)

    def nbytes(self) -> int:
        """Total device bytes pinned by the cache (quantized: int8 rows
        plus their per-(slot, head, position) scales)."""
        per = self.n_slots * self.n_heads * self.max_len * self.d_head
        if self.kv_dtype is None:
            return 2 * self.n_layers * per * self.dtype.itemsize
        scales = self.n_slots * self.n_heads * self.max_len
        return 2 * self.n_layers * (per * self.kv_dtype.itemsize
                                    + scales * self.scale_dtype.itemsize)

    def live_bytes(self) -> int:
        """Bytes committed to current occupants: a whole ``max_len`` row
        per occupied slot (the headroom the paged cache avoids)."""
        return self.active_slots * (self.nbytes() // self.n_slots)

    def page_utilization(self) -> float:
        """The slot layout has no pages: slot occupancy, under the same
        gauge as the paged cache's."""
        return self.occupancy


class PagedKVCache:
    """Page-pool KV cache with a per-slot block table (host mirror
    :attr:`table_host`; the engine keeps the device copy) and an
    optional prefix index."""

    NULL_PAGE = 0

    def __init__(self, n_layers: int, n_slots: int, n_heads: int,
                 page_tokens: int, d_head: int, max_len: int,
                 n_pages: int | None = None, dtype=torch.float32,
                 device=None, prefix_cache: bool = True, kv_dtype=None,
                 scale_dtype=torch.bfloat16):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, "
                             f"got {page_tokens}")
        self.n_layers = n_layers
        self.n_slots = n_slots
        self.n_heads = n_heads
        self.page_tokens = int(page_tokens)
        self.d_head = d_head
        self.max_len = max_len
        self.dtype = dtype
        # quantized page pool: int8 rows plus per-(page, head, offset)
        # scales; None keeps the float pool of ``dtype``
        self.kv_dtype = None if kv_dtype is None else resolve_dtype(kv_dtype)
        self.scale_dtype = resolve_dtype(scale_dtype)
        self.pages_per_slot = -(-max_len // self.page_tokens)
        if n_pages is None:
            # capacity-equivalent to the slot layout (+1 parking page)
            n_pages = n_slots * self.pages_per_slot + 1
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is reserved),"
                             f" got {n_pages}")
        self.n_pages = int(n_pages)
        self.device = resolve_device(device)
        shape = (self.n_pages, n_heads, self.page_tokens, d_head)
        sshape = shape[:3]

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if self.kv_dtype is None:
            self.caches = tuple((zeros(shape, dtype), zeros(shape, dtype))
                                for _ in range(n_layers))
        else:
            self.caches = tuple(
                (zeros(shape, self.kv_dtype), zeros(shape, self.kv_dtype),
                 zeros(sshape, self.scale_dtype),
                 zeros(sshape, self.scale_dtype))
                for _ in range(n_layers))
        self._free_slots = list(range(n_slots))        # kept sorted
        self._free_pages = list(range(1, self.n_pages))  # kept sorted
        self._ref = [0] * self.n_pages                 # per-page refcount
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self.table_host = np.zeros((n_slots, self.pages_per_slot),
                                   np.int32)
        # chained digest -> physical page, least recently used first;
        # the index holds one refcount on every entry
        self._prefix: OrderedDict | None = \
            OrderedDict() if prefix_cache else None
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0

    # ---- capacity / gauges --------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def active_slots(self) -> int:
        return self.n_slots - len(self._free_slots)

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1                 # page 0 reserved

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free_pages)

    @property
    def quantized(self) -> bool:
        return self.kv_dtype is not None

    def _page_bytes(self) -> int:
        """Bytes one physical page holds across every layer's K and V
        (and their scales)."""
        per = self.n_heads * self.page_tokens * self.d_head
        if self.kv_dtype is None:
            return 2 * self.n_layers * per * self.dtype.itemsize
        scales = self.n_heads * self.page_tokens
        return 2 * self.n_layers * (per * self.kv_dtype.itemsize
                                    + scales * self.scale_dtype.itemsize)

    def nbytes(self) -> int:
        """Total device bytes pinned by the page pool."""
        return self.n_pages * self._page_bytes()

    def live_bytes(self) -> int:
        """Bytes of pages currently allocated (mapped by a live slot
        and/or retained by the prefix index)."""
        return self.used_pages * self._page_bytes()

    def page_utilization(self) -> float:
        """Allocated fraction of the usable page pool."""
        return self.used_pages / self.usable_pages

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prefix_query_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_query_tokens

    # ---- admission -----------------------------------------------------
    def pages_needed(self, total_len: int) -> int:
        """Pages a request occupying ``total_len`` positions commits."""
        return -(-int(total_len) // self.page_tokens)

    def _match_prefix(self, prompt: np.ndarray, touch: bool) -> list[int]:
        """Longest chain of FULL prompt pages present in the index."""
        if self._prefix is None:
            return []
        P = self.page_tokens
        out: list[int] = []
        dig = b""
        for j in range(len(prompt) // P):
            dig = _page_digest(dig, prompt[j * P:(j + 1) * P])
            pg = self._prefix.get(dig)
            if pg is None:
                break
            if touch:
                self._prefix.move_to_end(dig)
            out.append(pg)
        return out

    def _shareable(self, prompt: np.ndarray, matched: list[int]) -> int:
        """Matched pages that may be MAPPED: the page holding the last
        prompt token is always recomputed (its activations sample the
        first token)."""
        return min(len(matched), (len(prompt) - 1) // self.page_tokens)

    def _reclaim(self, n: int, protect) -> int:
        """Evict up to ``n`` index-only pages (ref == 1, not in
        ``protect``) in LRU order, returning them to the free list."""
        if self._prefix is None or n <= 0:
            return 0
        freed = 0
        for dig in [d for d, pg in self._prefix.items()
                    if self._ref[pg] == 1 and pg not in protect]:
            if freed >= n:
                break
            pg = self._prefix.pop(dig)
            self._ref[pg] = 0
            bisect.insort(self._free_pages, pg)
            freed += 1
        return freed

    def can_admit(self, prompt, total_len: int) -> bool:
        """Could :meth:`admit` succeed right now?"""
        if not self._free_slots:
            return False
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        matched = self._match_prefix(prompt, touch=False)
        n_shared = self._shareable(prompt, matched)
        fresh = self.pages_needed(total_len) - n_shared
        if fresh <= len(self._free_pages):
            return True
        if self._prefix is None:
            return False
        shared = set(matched[:n_shared])
        reclaimable = sum(1 for pg in self._prefix.values()
                          if self._ref[pg] == 1 and pg not in shared)
        return fresh <= len(self._free_pages) + reclaimable

    def admit(self, prompt, total_len: int):
        """Claim a slot + every page the request can touch, mapping
        shared prefix pages from the index.  Returns ``(slot,
        cached_len)`` or ``None``.  Lowest-index-first placement."""
        if not self._free_slots:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if total_len < prompt.size or total_len > self.max_len:
            raise ValueError(f"total_len {total_len} outside "
                             f"[{prompt.size}, {self.max_len}]")
        matched = self._match_prefix(prompt, touch=True)
        n_shared = self._shareable(prompt, matched)
        shared = matched[:n_shared]
        fresh = self.pages_needed(total_len) - n_shared
        if fresh > len(self._free_pages):
            self._reclaim(fresh - len(self._free_pages),
                          protect=set(shared))
        if fresh > len(self._free_pages):
            return None
        slot = self._free_slots.pop(0)
        row = list(shared)
        for pg in shared:
            self._ref[pg] += 1
        for _ in range(fresh):
            pg = self._free_pages.pop(0)
            self._ref[pg] += 1
            row.append(pg)
        self._slot_pages[slot] = row
        self.table_host[slot, :] = self.NULL_PAGE
        self.table_host[slot, :len(row)] = row
        cached = n_shared * self.page_tokens
        self.prefix_hit_tokens += cached
        self.prefix_query_tokens += int(prompt.size)
        return slot, cached

    def register_prefix(self, slot: int, prompt) -> None:
        """Index the occupant's FULL prompt pages once its prefill
        completes; a digest already present keeps its page."""
        if self._prefix is None:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = self.page_tokens
        row = self._slot_pages[slot]
        dig = b""
        for j in range(len(prompt) // P):
            dig = _page_digest(dig, prompt[j * P:(j + 1) * P])
            if dig in self._prefix:
                self._prefix.move_to_end(dig)
                continue
            self._prefix[dig] = row[j]
            self._ref[row[j]] += 1              # held by the index

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's block-table row (logical -> physical page,
        NULL_PAGE-padded), as shipped to the device at admission."""
        return self.table_host[slot].copy()

    def release(self, slot: int) -> None:
        """Evict: unmap the slot's pages (freeing any that drop to
        refcount 0 — index-retained prefix pages survive)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} already free")
        for pg in self._slot_pages[slot]:
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                bisect.insort(self._free_pages, pg)
        self._slot_pages[slot] = []
        self.table_host[slot, :] = self.NULL_PAGE
        bisect.insort(self._free_slots, slot)
