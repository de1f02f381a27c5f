"""Pattern-reuse cache: the TVM-task-scheduler analogue (paper §2.2).

TVM stores each BSR op with its indices as a *task*; identical tasks are
compiled once and reused. Here the pattern-keyed artifacts are the
precomputed execution plans (kernels/exec_plan.py): identical patterns --
e.g. the cross-layer-unioned encoder layers -- share one plan object, and
the hit/miss counters answer the paper's introspection question of how
often a task is reused. Counterpart of ``repro/core/pattern_reuse.py``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable

import numpy as np
import torch

from repro_torch.core.bsr import BSR, pattern_fingerprint


@dataclasses.dataclass
class ReuseStats:
    hits: int = 0
    misses: int = 0

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def reuse_rate(self) -> float:
        return self.hits / self.total if self.total else 0.0


class PatternRegistry:
    """Task buffer mapping a pattern key to its built artifact."""

    def __init__(self):
        self._cache: Dict[Hashable, Any] = {}
        # reentrant and held across the build: each key is built exactly once
        # and the counters stay exact under threads
        self._lock = threading.RLock()
        self.stats = ReuseStats()

    def cached(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        """Return the artifact for ``key``, building it (a *miss*) only on
        first use."""
        with self._lock:
            if key in self._cache:
                self.stats.hits += 1
                return self._cache[key]
            self.stats.misses += 1
            value = builder()
            self._cache[key] = value
            return value

    def peek(self, key: Hashable) -> bool:
        """True when ``key`` is already built (no counter update, no
        build)."""
        with self._lock:
            return key in self._cache

    def specialize(self, fn: Callable, bsr: BSR) -> Callable:
        """``lambda data, *args: fn(bsr_with(data), *args)`` with the
        pattern held fixed, cached by (fn identity, pattern): two layers of
        one structure share one callable (the reference compiles it with
        ``jax.jit``; eager PyTorch has nothing to compile)."""
        indices, indptr = bsr.indices, bsr.indptr
        shape, block_shape = bsr.shape, bsr.block_shape

        def build():
            def specialized(data, *args):
                return fn(BSR(data, indices, indptr, shape, block_shape),
                          *args)
            return specialized

        return self.cached((id(fn), pattern_fingerprint(bsr)), build)

    def n_unique_patterns(self) -> int:
        return len(self._cache)


def pattern_similarity(a: BSR, b: BSR) -> float:
    """Jaccard similarity of two block patterns (stored blocks whose values
    are not all zero)."""
    if a.shape != b.shape or a.block_shape != b.block_shape:
        return 0.0

    def occupied(m: BSR):
        rows = m.block_row_ids()
        cols = np.asarray(m.indices)
        data = m.data.detach().float().cpu().numpy()
        nz = np.any(data != 0, axis=(1, 2))
        return set(zip(rows[nz].tolist(), cols[nz].tolist()))
    sa, sb = occupied(a), occupied(b)
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


def count_unique_intrablock_patterns(w, block_shape) -> int:
    """Number of distinct intra-block zero patterns across a weight matrix
    (paper Sec. 4: small blocks keep it low, enabling reuse)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w)
    bh, bw = block_shape
    r, c = w.shape
    blocks = (w.reshape(r // bh, bh, c // bw, bw)
              .transpose(0, 2, 1, 3).reshape(-1, bh * bw))
    return len({p.tobytes() for p in (blocks != 0)})
