"""Deterministic, shard-aware token pipeline with background prefetch.

A copy of ``repro/data/pipeline.py`` (numpy only), so the port needs no
JAX: the same (seed, step, host) gives byte-identical batches.

Sources: synthetic (seeded zipfian tokens -- offline-safe) or a binary token
file (memory-mapped uint16/uint32). Every host pulls only its own slice of
the global batch (host-local sharding); the iterator is stateless given
(seed, step), so restart-after-failure resumes at the exact batch without
data loss or duplication -- required for fault-tolerant training.

A mesh Trainer draws one global batch (``n_hosts=1``) on every rank and
keeps its data coordinate's rows (``launch.sharding.local_rows``): the
draw is seeded by ``host_id``, so ``n_hosts`` draws are not one global
batch.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    seed: int = 0
    source: str = "synthetic"        # synthetic | file
    path: Optional[str] = None
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _synthetic_batch(cfg: DataConfig, step: int) -> dict:
    """Zipf-ish tokens, deterministic in (seed, step, host)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    z = rng.zipf(1.3, size=(cfg.host_batch, cfg.seq_len + 1))
    toks = (z % cfg.vocab_size).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class _FileSource:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.arr = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.n_windows = (len(self.arr) - 1) // cfg.seq_len

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        # one global permutation draw; hosts take disjoint strides
        starts = rng.integers(0, self.n_windows, size=cfg.global_batch)
        mine = starts[cfg.host_id::cfg.n_hosts][: cfg.host_batch]
        toks = np.stack([self.arr[s * cfg.seq_len:(s + 1) * cfg.seq_len + 1]
                         for s in mine]).astype(np.int32)
        toks %= cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataPipeline:
    """Background-prefetching iterator, resumable at any step."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self._file = _FileSource(cfg) if cfg.source == "file" else None
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def batch_at(self, step: int) -> dict:
        if self._file is not None:
            return self._file.batch(step)
        return _synthetic_batch(self.cfg, step)

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, b = self._q.get()
        self._step = step
        return b

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
