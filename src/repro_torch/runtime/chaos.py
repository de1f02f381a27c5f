"""Shared fault-injection registry + watchdog for runtime robustness tests.

A copy of ``repro/runtime/chaos.py`` (framework-free), so the port needs no
JAX. The port's training loop uses :class:`FaultInjector` and its serving
engine (``repro_torch/serving/engine.py``) fires the ``engine.*`` hook
points listed below; the servable loader's ``servable.load_packs`` site is
not fired by the port's loader.

Production traffic brings failure modes the happy-path benches never see:
prefill blow-ups, NaN-poisoned numerics, allocation failures, stragglers,
corrupt artifacts. This module is the ONE place those faults are injected
from, so every layer (training supervisor, serving engine, servable
loader) exercises its failure path against the same deterministic
machinery:

  * :class:`ChaosInjector` -- a registry of named *sites*. Code under test
    calls ``chaos.fire(site, **ctx)`` at its hook points; tests arm faults
    with ``chaos.inject(site, at=N, exc=...)`` (raise into the caller) or
    ``action=fn`` (mutate state through the ctx -- e.g. NaN-poison an
    engine slot, sleep to fake a straggler). Unarmed sites are free:
    ``fire`` on a site with no faults is a dict lookup + counter bump.
  * serving hook points (``repro/serving/engine.py``):
      - ``engine.alloc``   -- slot allocation at admission
      - ``engine.prefill`` -- prompt prefill of an admitted request
      - ``engine.window``  -- before each batched decode window (ctx
        carries the engine: poison a slot here to test NaN quarantine)
      - ``engine.sync``    -- host-side sync after a window (sleep here to
        fake a straggler and trip the watchdog)
      - ``engine.arrival_burst`` -- inside submit(), before enqueue (an
        action may recursively submit a burst; raise sheds the submission)
      - ``engine.prefill_chunk`` -- before each chunked-prefill dispatch
        (raise fails that request; sleep fakes a straggling chunk)
    and ``servable.load_packs`` (``repro/serving/servable.py``) -- fired
    with the pack-archive path before it is read, so a fault can corrupt
    the bytes a load is about to trust.
  * :class:`Watchdog` -- wall-clock stall detector for device calls the
    host cannot interrupt: ``arm()`` before a dispatch, ``disarm()`` after;
    a background thread records a stall event (and fires an optional
    callback) when an armed section exceeds its timeout. Detection-only by
    design -- a stuck XLA call cannot be cancelled, but a serving loop
    that *knows* it is stuck can be drained, alerted on, or killed by its
    supervisor.
  * :class:`FaultInjector` -- the train-loop step injector (previously in
    ``runtime/fault_tolerance.py``; re-exported there), kept as a thin
    shim over the same registry so train and serving faults share one
    accounting surface.

Everything here is deterministic: faults fire on the Nth ``fire()`` of
their site, never on wall clocks or RNG, so chaos tests replay exactly
(tests/test_chaos.py asserts engine invariants after every fault class).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["ChaosEvent", "ChaosInjector", "FaultInjector", "Watchdog",
           "poison_slot", "straggle",
           "SITE_ALLOC", "SITE_PREFILL", "SITE_WINDOW", "SITE_SYNC",
           "SITE_PAGE_ALLOC", "SITE_LOAD_PACKS", "SITE_TRAIN_STEP",
           "SITE_ARRIVAL_BURST", "SITE_PREFILL_CHUNK"]

#: serving-engine hook points (repro/serving/engine.py)
SITE_ALLOC = "engine.alloc"
SITE_PREFILL = "engine.prefill"
SITE_WINDOW = "engine.window"
SITE_SYNC = "engine.sync"
#: open-loop ingest hook: fires inside submit() after validation, before the
#: request is enqueued (ctx: engine, request). An action may submit a burst
#: of extra requests through the same engine (re-entrant: the nested
#: submits re-fire this site); 'raise' sheds THIS submission with a
#: structured failure, never a crash
SITE_ARRIVAL_BURST = "engine.arrival_burst"
#: chunked-prefill hook: fires before each prefill chunk dispatch (ctx:
#: engine, request, start, size). 'raise' fails the request with
#: FailureReason.PREFILL_ERROR and releases its slot; straggle() here fakes
#: a slow chunk so the watchdog's prefill-chunk label trips
SITE_PREFILL_CHUNK = "engine.prefill_chunk"
#: paged-KV page allocation (fires before each admission's page reservation;
#: 'raise' simulates pool exhaustion -> backpressure, never a crash)
SITE_PAGE_ALLOC = "engine.page_alloc"
#: servable-loader hook point (repro/serving/servable.py)
SITE_LOAD_PACKS = "servable.load_packs"
#: train-loop hook point (FaultInjector shim)
SITE_TRAIN_STEP = "train.step"


@dataclasses.dataclass
class ChaosEvent:
    """One fault firing, recorded on ``ChaosInjector.log``."""

    site: str
    occurrence: int             # the site's fire() count when it fired
    kind: str                   # 'raise' | 'action'


class _Fault:
    """One armed fault: fires on hits ``at .. at+times-1`` of its site."""

    def __init__(self, site: str, at: int, times: int,
                 exc: Optional[BaseException],
                 action: Optional[Callable[[dict], None]]):
        if exc is None and action is None:
            raise ValueError("fault needs exc= or action=")
        self.site, self.at, self.times = site, int(at), int(times)
        self.exc, self.action = exc, action
        self.fired = 0

    def should_fire(self, n: int) -> bool:
        return self.at <= n < self.at + self.times


class ChaosInjector:
    """Deterministic, site-keyed fault registry (module docstring).

    ``inject(site, at=N)`` arms a fault for the Nth ``fire(site)`` (1-based;
    ``times=K`` keeps it armed for K consecutive hits). ``exc=`` raises the
    exception into the firing code path; ``action=`` calls ``fn(ctx)`` with
    the keyword context the hook point passed to ``fire`` (both together
    run the action first, then raise). Every firing is appended to ``log``
    for test assertions.
    """

    def __init__(self):
        self._counts: Dict[str, int] = collections.Counter()
        self._faults: Dict[str, List[_Fault]] = collections.defaultdict(list)
        self.log: List[ChaosEvent] = []

    def inject(self, site: str, *, at: int = 1, times: int = 1,
               exc: Optional[BaseException] = None,
               action: Optional[Callable[[dict], None]] = None) -> "_Fault":
        fault = _Fault(site, at, times, exc, action)
        self._faults[site].append(fault)
        return fault

    def fire(self, site: str, **ctx) -> None:
        """Hook point: count this hit of ``site`` and trigger any armed
        fault. Actions run (and may mutate state through ``ctx``) before an
        exception is raised into the caller."""
        self._counts[site] += 1
        n = self._counts[site]
        for fault in self._faults.get(site, ()):
            if fault.should_fire(n):
                fault.fired += 1
                self.log.append(ChaosEvent(
                    site, n, "raise" if fault.exc is not None else "action"))
                if fault.action is not None:
                    fault.action(ctx)
                if fault.exc is not None:
                    raise fault.exc

    def count(self, site: str) -> int:
        """How many times ``site`` has fired (armed or not)."""
        return self._counts.get(site, 0)

    def fired(self, site: Optional[str] = None) -> int:
        """How many faults actually triggered (optionally per site)."""
        return sum(1 for e in self.log if site is None or e.site == site)


# --------------------------------------------------------------------------
# canned actions for the serving hook points
# --------------------------------------------------------------------------

def poison_slot(slot: Optional[int] = None) -> Callable[[dict], None]:
    """Action for ``engine.window``: NaN-fill one active slot's cache
    (``slot=None`` = the lowest-numbered active slot), so that slot's next
    decode logits go non-finite and the engine's quarantine path runs."""

    def action(ctx: dict) -> None:
        eng = ctx["engine"]
        target = slot
        if target is None:
            if not eng._active:
                return
            target = min(eng._active)
        eng.corrupt_slot(target)
    return action


def straggle(seconds: float) -> Callable[[dict], None]:
    """Action for ``engine.sync``: stall the host loop -- an artificial
    straggler sync that a configured watchdog must detect."""

    def action(ctx: dict) -> None:
        time.sleep(seconds)
    return action


# --------------------------------------------------------------------------
# watchdog
# --------------------------------------------------------------------------

class Watchdog:
    """Background wall-clock monitor for host-uninterruptible sections.

    ``arm(label)`` starts a timed section, ``disarm()`` ends it (returning
    the elapsed seconds). A daemon thread polls the armed section; once it
    exceeds ``timeout_s`` a stall event ``(label, elapsed_at_detection)``
    is appended to ``stalls`` and ``on_stall(label, elapsed)`` fires --
    once per armed section, even if it stays stuck. ``close()`` stops the
    thread (idempotent; also called by ``__del__``)."""

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[str, float], None]] = None,
                 poll_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.stalls: List[tuple] = []
        self._lock = threading.Lock()
        self._armed: Optional[list] = None      # [label, t0, fired]
        self._stop = threading.Event()
        self._poll = poll_s if poll_s is not None else \
            max(min(self.timeout_s / 4.0, 0.05), 0.001)
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="repro-watchdog")
        self._thread.start()

    def arm(self, label: str = "window") -> None:
        with self._lock:
            self._armed = [label, time.monotonic(), False]

    def disarm(self) -> float:
        with self._lock:
            if self._armed is None:
                return 0.0
            elapsed = time.monotonic() - self._armed[1]
            self._armed = None
            return elapsed

    def _watch(self) -> None:
        while not self._stop.wait(self._poll):
            cb = None
            with self._lock:
                if self._armed is not None and not self._armed[2]:
                    label, t0, _ = self._armed
                    elapsed = time.monotonic() - t0
                    if elapsed > self.timeout_s:
                        self._armed[2] = True
                        self.stalls.append((label, elapsed))
                        cb = (label, elapsed)
            if cb is not None and self.on_stall is not None:
                self.on_stall(*cb)

    def close(self) -> None:
        self._stop.set()

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


# --------------------------------------------------------------------------
# the train-loop step injector (formerly runtime/fault_tolerance.py)
# --------------------------------------------------------------------------

class FaultInjector:
    """Deterministic train-step failure injection: ``maybe_fail(step)``
    raises once per step listed in ``fail_at_steps``. Historically lived in
    ``runtime/fault_tolerance.py`` (still re-exported there); now a shim
    over the shared registry so its firings land on the same ``log``."""

    def __init__(self, fail_at_steps=(), chaos: Optional[ChaosInjector] = None):
        self.fail_at = set(fail_at_steps)
        self.fired = set()
        self.chaos = chaos if chaos is not None else ChaosInjector()

    def maybe_fail(self, step: int):
        self.chaos.fire(SITE_TRAIN_STEP, step=step)
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            self.chaos.log.append(ChaosEvent(
                SITE_TRAIN_STEP, self.chaos.count(SITE_TRAIN_STEP), "raise"))
            raise RuntimeError(f"injected device failure at step {step}")
