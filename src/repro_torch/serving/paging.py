"""Page-pool allocator for the paged KV cache (a copy of the reference's
framework-free ``repro/serving/paging.py``).

The device side (models/common.py paged_* primitives) only understands two
things: per-layer page pools whose axis 0 is *physical page ids*, and int32
page tables mapping each request slot's logical pages to those ids. This
module owns everything else -- which ids are free, which are shared, and how
many bytes the pool pins -- entirely on the host, in plain Python, so the
engine can make admission decisions without a device sync.

Design notes:
  - ONE logical id space serves every layer: each layer has its own pool
    arrays (k_pages/v_pages or c_kv_pages/k_rope_pages), but page id ``p``
    means row ``p`` in all of them. The allocator therefore tracks ids once,
    not per layer.
  - Refcounts, not ownership: the prefix cache (prefix_cache.py) retains
    pages for future sharers and preemption retains a victim's pages across
    slot loss. A page returns to the free list only when its count hits 0.
  - Deterministic: ``alloc`` hands out the lowest free ids (a heap) so runs
    are reproducible and tests can assert exact tables.
"""
from __future__ import annotations

import heapq
from typing import Dict, List


class PagePoolExhausted(RuntimeError):
    """Raised by :meth:`PagePool.alloc` when the request cannot be satisfied;
    the engine translates this into its backpressure policy (evict prefix
    pages -> park the admission -> shed) instead of crashing."""

    def __init__(self, want: int, free: int):
        super().__init__(f"page pool exhausted: want {want} pages, "
                         f"{free} free")
        self.want = want
        self.free = free


def pages_needed(n_tokens: int, page_size: int) -> int:
    """ceil(n_tokens / page_size); 0 tokens needs 0 pages."""
    return -(-max(n_tokens, 0) // page_size)


class PagePool:
    """Host-side free-list allocator with refcounts over ``n_pages`` physical
    pages of ``page_size`` tokens each.

    ``bytes_per_page`` is the summed on-device footprint of one page id
    across every paged layer (so ``used_bytes()`` is real HBM, not a
    per-layer slice); pass 0 if accounting is not needed.
    """

    def __init__(self, n_pages: int, page_size: int, bytes_per_page: int = 0):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.bytes_per_page = bytes_per_page
        self._free: List[int] = list(range(n_pages))
        heapq.heapify(self._free)
        self._refs: Dict[int, int] = {}
        # high-water mark of pages simultaneously in use (bench reporting)
        self.peak_used = 0

    # -- queries ----------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def used_bytes(self) -> int:
        return self.used_count * self.bytes_per_page

    def total_bytes(self) -> int:
        return self.n_pages * self.bytes_per_page

    # -- lifecycle --------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Claim ``n`` pages (refcount 1 each), lowest ids first. Raises
        :class:`PagePoolExhausted` without side effects if short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PagePoolExhausted(n, len(self._free))
        out = [heapq.heappop(self._free) for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.peak_used = max(self.peak_used, self.used_count)
        return out

    def retain(self, pages) -> None:
        """Add one reference to each page (sharing / retention)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"retain of free page {p}")
            self._refs[p] += 1

    def release(self, pages) -> None:
        """Drop one reference from each page; pages reaching 0 return to the
        free list. Double-release raises (refcount bugs must be loud)."""
        for p in pages:
            c = self._refs.get(p, 0)
            if c <= 0:
                raise ValueError(f"release of free page {p}")
            if c == 1:
                del self._refs[p]
                heapq.heappush(self._free, p)
            else:
                self._refs[p] = c - 1

    def reset(self) -> None:
        """Forget everything (engine window-failure recovery: the device
        cache is re-initialized, so host bookkeeping restarts too)."""
        self._free = list(range(self.n_pages))
        heapq.heapify(self._free)
        self._refs.clear()

    def check(self) -> None:
        """Invariant sweep: free + referenced partitions [0, n_pages)."""
        free = set(self._free)
        held = set(self._refs)
        if free & held:
            raise AssertionError(f"pages both free and held: {free & held}")
        if len(free) + len(held) != self.n_pages:
            raise AssertionError(
                f"page accounting leak: {len(free)} free + {len(held)} held "
                f"!= {self.n_pages}")
        if any(c <= 0 for c in self._refs.values()):
            raise AssertionError("non-positive refcount")
