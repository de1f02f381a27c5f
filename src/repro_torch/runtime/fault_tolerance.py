"""Fault-tolerant training runtime: restore-on-failure, straggler monitoring,
elastic re-meshing.

A copy of ``repro/runtime/fault_tolerance.py`` (framework-free), so the
port needs no JAX.

The train driver wraps every step in the supervisor; on a device/runtime
failure (a CUDA runtime error, injected faults in tests) it restores the latest
checkpoint and replays from there. Because the data pipeline is stateless in
(seed, step), replay is exactly-once w.r.t. the optimizer trajectory.

Straggler mitigation: per-host step-time EWMA; hosts slower than
``threshold``x the fleet median get flagged, and the grad-accumulation
rebalancer shifts microbatches away from them (simulated timers in tests; on
real fleets the timings come from the per-host profiler).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np

log = logging.getLogger("repro.runtime")


@dataclasses.dataclass
class FaultToleranceConfig:
    max_restarts: int = 5
    checkpoint_every: int = 50
    straggler_threshold: float = 1.5
    straggler_ewma: float = 0.9


class StragglerMonitor:
    """Tracks per-host step-time EWMAs and proposes microbatch rebalancing."""

    def __init__(self, n_hosts: int, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self.ewma = np.zeros(n_hosts)
        self.seen = np.zeros(n_hosts, bool)

    def observe(self, host_times: Dict[int, float]):
        a = self.cfg.straggler_ewma
        for h, t in host_times.items():
            self.ewma[h] = t if not self.seen[h] else a * self.ewma[h] + (1 - a) * t
            self.seen[h] = True

    def stragglers(self):
        if not self.seen.any():
            return []
        med = np.median(self.ewma[self.seen])
        return [int(h) for h in np.nonzero(
            self.seen & (self.ewma > self.cfg.straggler_threshold * med))[0]]

    def rebalance(self, microbatches_per_host: np.ndarray) -> np.ndarray:
        """Shift one microbatch from each straggler to the fastest host,
        preserving the global batch (deterministic given timings)."""
        mb = microbatches_per_host.copy()
        slow = self.stragglers()
        if not slow or not self.seen.any():
            return mb
        order = np.argsort(self.ewma)
        for s in slow:
            if mb[s] > 1:
                fastest = next(int(h) for h in order if h != s)
                mb[s] -= 1
                mb[fastest] += 1
        return mb


class Supervisor:
    """run() drives step_fn with restore-on-failure semantics."""

    def __init__(self, cfg: FaultToleranceConfig, store, save_state_fn,
                 restore_state_fn):
        self.cfg = cfg
        self.store = store
        self.save_state = save_state_fn
        self.restore_state = restore_state_fn
        self.restarts = 0

    def run(self, state, start_step: int, n_steps: int,
            step_fn: Callable, on_step: Optional[Callable] = None):
        step = start_step
        while step < start_step + n_steps:
            try:
                state, metrics = step_fn(state, step)
                if on_step:
                    on_step(step, metrics)
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.save_state(self.store, step, state)
            except Exception as e:  # noqa: BLE001 -- device loss is generic
                self.restarts += 1
                log.warning("step %d failed (%s); restart %d/%d",
                            step, type(e).__name__, self.restarts,
                            self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                # drain any in-flight async save before reading the directory:
                # without this, a failure shortly after a checkpoint step races
                # the background writer's atomic rename and restore sees a
                # stale (or empty) step list -- the flake seen under full-suite
                # load, where the writer thread lags the train loop.
                wait = getattr(self.store, "wait", None)
                if wait is not None:
                    wait()
                latest = self.store.latest_step()
                if latest is None:
                    raise
                state = self.restore_state(self.store, latest, state)
                step = latest
        return state, step


# Deterministic failure injection lives in the shared chaos registry
# (runtime/chaos.py) beside the watchdog; re-exported here for the train
# driver.
from repro_torch.runtime.chaos import FaultInjector  # noqa: E402,F401
