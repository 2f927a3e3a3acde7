"""Host-side page allocator for the paged KV cache.

Port of ray_tpu/serve/paged_kv.py (numpy only, copied so the port imports
nothing of ray_tpu). Occupied pages report to the port's memory plane
(observability/memory.py) as a "kv" record, as the reference's do.

The device side (pools + kernel) is ops/paged_attention.py +
llama.decode_step_paged; this is the bookkeeping half: a free list of
physical pages and the per-slot page tables (ref: vLLM's BlockAllocator
/ BlockTable split, re-shaped so the device arrays stay static — the
table is a dense [slots, max_pages] int32 the engine re-uploads only
when membership changes).

Automatic prefix caching (ref: vLLM's hash-based BlockAllocatorV2):
pages are REFCOUNTED, and a full page of prompt tokens can be
registered under its chain hash (hash of the page's tokens + all
preceding pages' hash). A later prompt whose leading full pages hash
identically ADOPTS those physical pages — the prefill compute and the
page memory for the shared prefix are both skipped. Shared pages are
never written: the engine only matches FULL pages and decode always
appends past the end of the sequence. When a page's refcount drops to
zero it parks in an LRU of evictable cached pages — still matchable —
and is reclaimed to the free list only under pool pressure.

Page 0 is reserved as the TRASH page: inactive slots and padding
positions write there, so the allocator never hands it out.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

_memory_mod = None


def _memattr():
    """Lazy memory-attribution tracker (keeps this module import-light)."""
    global _memory_mod
    if _memory_mod is None:
        from ray_tpu_torch.observability import memory
        _memory_mod = memory.tracker()
    return _memory_mod


def page_chain_hashes(tokens, page_size: int) -> List[bytes]:
    """Chain hash per FULL page of `tokens`: h_i = H(h_{i-1} || page_i).
    Position-dependent by construction, so page content alone never
    collides across different prefixes."""
    n_full = len(tokens) // page_size
    out, chain = [], b""
    for i in range(n_full):
        page = np.asarray(tokens[i * page_size:(i + 1) * page_size],
                          np.int32).tobytes()
        chain = hashlib.blake2b(chain + page, digest_size=16).digest()
        out.append(chain)
    return out


class PagePool:
    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_slot: int, page_nbytes: int = 0):
        if num_pages < 2:
            raise ValueError("need at least one real page beyond trash")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        # device bytes per physical page (K+V across layers); when the
        # engine provides it, occupied pages register with the memory
        # plane as a synthetic "kv" record (see _track_mem)
        self.page_nbytes = int(page_nbytes)
        self._mem_key = f"kvpool:{id(self):x}"
        self._mem_tracked = False
        # LIFO free list; page 0 reserved as trash
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.table = np.zeros((max_slots, max_pages_per_slot), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_slots)]
        # prefix cache state
        self.ref = np.zeros((num_pages,), np.int32)
        self.hash_to_page: Dict[bytes, int] = {}
        self.page_to_hash: Dict[int, bytes] = {}
        # refcount-0 registered pages, oldest first (reclaim order)
        self.evictable: "OrderedDict[int, None]" = OrderedDict()
        # bumped on every table write (grow/adopt/release): the engine
        # re-uploads the device table when this moves — inferring it
        # from used_pages misses cache-reclaim-served growth (net 0)
        self.table_version = 0

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def available_pages(self) -> int:
        """Free now plus reclaimable-from-cache (grow() reclaims on
        demand) — capacity prechecks must use THIS, not free_pages, or
        a warm cache would make the pool look artificially full."""
        return len(self.free) + len(self.evictable)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self.free)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def can_fit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.available_pages

    def _track_mem(self) -> None:
        """Mirror occupied-page bytes (incl. evictable cached pages —
        they still hold device memory) into the memory plane."""
        if not self.page_nbytes:
            return
        held = self.used_pages   # includes parked evictable pages
        mem = _memattr()
        if held > 0:
            mem.attribute(self._mem_key, "kv", held * self.page_nbytes,
                          store=False, pages=held,
                          evictable=len(self.evictable))
            self._mem_tracked = True
        elif self._mem_tracked:
            mem.release(self._mem_key)
            self._mem_tracked = False

    def _unregister(self, page: int) -> None:
        h = self.page_to_hash.pop(page, None)
        if h is not None and self.hash_to_page.get(h) == page:
            del self.hash_to_page[h]

    def _reclaim(self, n: int) -> int:
        """Evict up to n refcount-0 cached pages (LRU) to the free list."""
        got = 0
        while got < n and self.evictable:
            page, _ = self.evictable.popitem(last=False)
            self._unregister(page)
            self.free.append(page)
            got += 1
        return got

    def grow(self, slot: int, total_tokens: int) -> bool:
        """Ensure `slot` owns enough pages for total_tokens. Returns
        False (allocating nothing) if the pool can't satisfy it."""
        need = self.pages_for(total_tokens)
        if need > self.max_pages_per_slot:
            return False
        extra = need - len(self.owned[slot])
        if extra <= 0:
            return True
        if extra > len(self.free):
            self._reclaim(extra - len(self.free))
        if extra > len(self.free):
            return False
        for _ in range(extra):
            p = self.free.pop()
            self.table[slot, len(self.owned[slot])] = p
            self.owned[slot].append(p)
            self.ref[p] = 1
        self.table_version += 1
        self._track_mem()
        return True

    def release(self, slot: int) -> None:
        for p in reversed(self.owned[slot]):
            self.ref[p] -= 1
            if self.ref[p] <= 0:
                self.ref[p] = 0
                if p in self.page_to_hash:
                    # cached: park, still matchable until reclaimed
                    self.evictable[p] = None
                else:
                    self.free.append(p)
        self.owned[slot] = []
        self.table[slot] = 0
        self.table_version += 1
        self._track_mem()

    # ---- prefix cache ------------------------------------------------------

    def match_prefix(self, hashes: List[bytes]) -> List[int]:
        """Longest run of leading hashes present in the cache; returns
        their physical pages (does NOT take references — adopt() does)."""
        pages = []
        for h in hashes:
            p = self.hash_to_page.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def adopt(self, slot: int, pages: List[int]) -> None:
        """Append shared pages to a slot's table, taking a reference on
        each. Caller guarantees the slot's table is empty (fresh admit)."""
        for p in pages:
            self.table[slot, len(self.owned[slot])] = p
            self.owned[slot].append(p)
            self.ref[p] += 1
            self.evictable.pop(p, None)     # in use again
        self.table_version += 1
        self._track_mem()
        if len(self.owned[slot]) > self.max_pages_per_slot:
            raise ValueError("adopted prefix exceeds max_pages_per_slot")

    def register(self, slot: int, hashes: List[bytes]) -> None:
        """Register the slot's first len(hashes) pages under their chain
        hashes (post-prefill). First writer wins: an existing mapping for
        a hash is kept — duplicates converge on the earlier page as later
        prompts adopt it."""
        for i, h in enumerate(hashes):
            if i >= len(self.owned[slot]):
                break
            p = self.owned[slot][i]
            if h in self.hash_to_page or p in self.page_to_hash:
                continue
            self.hash_to_page[h] = p
            self.page_to_hash[p] = h

    def import_pages(self, hashes: List[bytes]) -> List[tuple]:
        """Allocate + register physical pages for externally-imported KV
        (disagg adopt, serve/kv_transfer.py): each new page parks
        refcount-0 in the evictable LRU — matchable by the next admit's
        _try_admit_cached, reclaimable under pool pressure, exactly like
        pages a released slot leaves behind. Returns (page, is_new)
        pairs in hash order (existing registrations are reused with
        is_new=False; the caller only writes KV into new pages). Stops
        early if the pool is exhausted."""
        out = []
        for h in hashes:
            p = self.hash_to_page.get(h)
            if p is not None:
                out.append((p, False))
                continue
            if not self.free:
                self._reclaim(1)
            if not self.free:
                break
            p = self.free.pop()
            self.hash_to_page[h] = p
            self.page_to_hash[p] = h
            self.ref[p] = 0
            self.evictable[p] = None
            out.append((p, True))
        self._track_mem()
        return out

    def cache_stats(self) -> dict:
        return {"registered": len(self.hash_to_page),
                "evictable": len(self.evictable),
                "free": len(self.free)}
