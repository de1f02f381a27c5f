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

    def n_unique_patterns(self) -> int:
        return len(self._cache)
