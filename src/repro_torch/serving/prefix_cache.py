"""Radix prefix cache over page-granular token chunks (a copy of the
reference's framework-free ``repro/serving/prefix_cache.py``).

Admissions whose prompts share a token prefix (system prompts, few-shot
headers) should reuse the pages already holding that prefix instead of
re-prefilling and re-storing it. The cache is a radix tree whose edges are
``page_size``-token tuples: node depth d holds the physical page storing
prompt tokens [d*ps, (d+1)*ps). Only *immutable* pages are ever inserted --
full pages strictly inside the prompt -- so sharing is copy-on-write by
construction: decode writes always land at positions >= prompt length, which
live in pages the sharer allocated privately. No page copy ever happens.

The tree holds its own reference on every inserted page (via the pool), so
a cached prefix survives its original request's retirement; ``evict`` drops
least-recently-used leaves when the pool runs dry, which only forfeits
future hits -- active slots keep their own references.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("children", "page", "stamp")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.page: Optional[int] = None     # physical page id (root: None)
        self.stamp = 0                      # LRU clock at last touch


class PrefixCache:
    """Radix tree mapping page-aligned token prefixes to physical pages.

    The cache cooperates with a :class:`repro_torch.serving.paging.PagePool`:
    ``insert`` retains inserted pages (the tree's own reference), ``match``
    retains matched pages on behalf of the caller (the new request's
    reference), and ``evict``/``clear`` release the tree's references.
    """

    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self._root = _Node()
        self._clock = 0
        # stats
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # -- internals --------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens: Sequence[int]):
        ps = self.page_size
        for i in range(0, len(tokens) - len(tokens) % ps, ps):
            yield tuple(int(t) for t in tokens[i:i + ps])

    # -- queries ----------------------------------------------------------

    def match(self, tokens: Sequence[int], limit: Optional[int] = None
              ) -> List[int]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns the physical pages holding it (possibly empty) with ONE
        reference per page retained for the caller -- the caller owns
        releasing them (normally folded into the slot's page list).
        ``limit`` caps the match length in tokens; the engine passes
        ``len(prompt) - 1`` so a hit still leaves >= 1 suffix token to
        prefill (the model needs at least one forward position to produce
        next-token logits).
        """
        cap = len(tokens) if limit is None else min(limit, len(tokens))
        stamp = self._tick()
        node, pages = self._root, []
        for chunk in self._chunks(tokens[:cap]):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            nxt.stamp = stamp
            pages.append(nxt.page)
            node = nxt
        self.hit_tokens += len(pages) * self.page_size
        self.miss_tokens += len(tokens) - len(pages) * self.page_size
        if pages:
            self.pool.retain(pages)
        return pages

    # -- lifecycle --------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish the full pages of a freshly-prefilled prompt: chunk k of
        ``tokens`` is stored in ``pages[k]``. Only complete chunks are
        walked (a trailing partial page is mutable -- never shared). New
        nodes retain their page; existing nodes are refreshed, not retained
        again. Returns the number of newly published pages."""
        stamp = self._tick()
        node, new = self._root, 0
        for k, chunk in enumerate(self._chunks(tokens)):
            if k >= len(pages):
                break
            nxt = node.children.get(chunk)
            if nxt is None:
                nxt = _Node()
                nxt.page = int(pages[k])
                node.children[chunk] = nxt
                self.pool.retain([nxt.page])
                new += 1
            nxt.stamp = stamp
            node = nxt
        self.inserted_pages += new
        return new

    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` tree references, least-recently-used
        leaves first (leaves only: an inner node's page is a prefix of a
        live cached path). Returns pages actually released -- note a
        released reference frees HBM only when no active slot still holds
        the page."""
        dropped = 0
        while dropped < n_pages:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            parent, key, node = leaf
            del parent.children[key]
            self.pool.release([node.page])
            dropped += 1
        self.evicted_pages += dropped
        return dropped

    def _lru_leaf(self):
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                if child.children:
                    stack.append(child)
                elif best is None or child.stamp < best[2].stamp:
                    best = (node, key, child)
        return best

    def clear(self) -> None:
        """Release every tree reference (engine recovery path)."""
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                self.pool.release([child.page])
                stack.append(child)
        self._root = _Node()

    @property
    def cached_pages(self) -> int:
        n, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n
