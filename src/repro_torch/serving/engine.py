"""Continuous-batching serving engine: request slots over one batched decode.

Counterpart of ``repro/serving/engine.py``. The model layer's decode path
takes a ragged ``pos: (B,)`` vector (one absolute position per batch row,
-1 = inactive), which turns the batch dimension into *request slots*. This
module adds the request-level machinery on top:

  * an **admission queue** -- ``submit()`` enqueues requests; each ``step()``
    admits as many as there are free slots (highest ``priority`` first, FIFO
    within a priority class). The queue is optionally bounded
    (``max_queue``) with a backpressure policy (``overflow`` = ``'reject'``
    / ``'shed-oldest'`` / ``'block'``);
  * **prefill-into-cache** -- an admitted prompt runs ONE forward pass on a
    batch-1 cache (``models.api.prefill_cache``), its length padded to a
    power-of-two *bucket*, and the result is copied into the engine cache
    (``write_slot``; paged engines page-write it);
  * **fused decode windows** -- with ``sync_every = K > 1`` each ``step()``
    runs up to K decode steps (``models.api.decode_many``: greedy sampling,
    EOS, budgets and the non-finite guard on the device, no host sync
    inside); the host syncs once per window to drain emitted tokens, fire
    callbacks, recycle finished slots and admit queued requests.
    ``sync_every=1`` (or ``collect_logits=True``) keeps the
    one-decode-per-step loop;
  * **request lifecycle** -- every submitted request ends in exactly one
    terminal status (``done`` / ``failed`` / ``cancelled`` / ``shed``) with
    a structured :class:`FailureReason` off the success path: rejection at
    submission, deadlines and cancellation at window-sync points, priority
    **preemption** (the victim resumes by re-prefilling prompt + generated
    tokens, or -- paged, every layer global -- by re-attaching its retained
    pages), **non-finite quarantine** of a poisoned slot, and recovery from
    a failed decode window (its requests fail, the cache is rebuilt, the
    engine keeps serving);
  * **KV layouts** -- ``'dense'`` slot caches or ``'paged'`` page pools for
    the global layers with a host-side refcounting allocator
    (``serving/paging.py``) and radix prefix sharing
    (``serving/prefix_cache.py``);
  * **slot lifecycle** -- any retirement zeroes the slot, so a recycled
    slot cannot leak its previous request.

The engine cache is preallocated once and updated **in place** by every
prefill insert, decode window and slot op (the reference rebuilds it
functionally and donates the old buffers to each compiled call). The
batch-1 prefill cache is allocated once per engine too: a prefill rewrites
every one of its tensors, so nothing of the previous prompt survives into
the next.

Not ported here (each raises at construction, naming its ROADMAP.md item):
the SLO scheduler (``sched``), chaos injection, the watchdog, meshes, the
audio family and sampling at ``temperature > 0``.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import leaves
from repro_torch.models.common import PagedLayout
from repro_torch.models.sampling import sample_token_row
from repro_torch.serving.paging import PagePool, PagePoolExhausted, \
    pages_needed
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.spec import KV_LAYOUTS, OVERFLOW_POLICIES

__all__ = ["EngineRequest", "EngineStats", "FailureReason", "ServingEngine",
           "TERMINAL_STATES"]

log = logging.getLogger("repro_torch.serving")

#: the exactly-once terminal accounting: every submit() ends in ONE of these
TERMINAL_STATES = frozenset({"done", "failed", "cancelled", "shed"})

_ITEM_ENGINE = "ROADMAP.md Queue 1 item 11"


@dataclasses.dataclass(frozen=True)
class FailureReason:
    """Structured reason attached to every non-success terminal request."""

    code: str
    message: str = ""

    REJECTED = "rejected"                # invalid at submission
    QUEUE_FULL = "queue_full"            # shed by backpressure policy
    DEADLINE = "deadline"                # deadline_s expired (sync point)
    CANCELLED = "cancelled"              # engine.cancel(handle)
    PREFILL_ERROR = "prefill_error"      # admission/prefill raised
    NONFINITE_LOGITS = "nonfinite_logits"  # NaN/inf quarantine
    ENGINE_ERROR = "engine_error"        # decode window raised
    KV_PAGES = "kv_pages_exhausted"      # page pool dry with no way to drain

    def __str__(self):
        return f"{self.code}: {self.message}" if self.message else self.code


@dataclasses.dataclass
class EngineRequest:
    """One submitted request; doubles as the caller's result handle."""

    req_id: int
    prompt: np.ndarray                      # (L,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    on_token: Optional[Callable[[int, int], None]] = None
    on_done: Optional[Callable[[int, List[int]], None]] = None
    priority: int = 0                       # higher preempts lower
    deadline_at: Optional[float] = None     # absolute time.monotonic()

    # engine-owned state
    status: str = "queued"          # queued|active|done|failed|cancelled|shed
    failure: Optional[FailureReason] = None
    slot: int = -1
    pos: int = -1                           # next decode position
    tokens: List[int] = dataclasses.field(default_factory=list)
    step_logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    done: bool = False                      # status == 'done'
    cancel_requested: bool = False
    n_preempted: int = 0
    admit_seq: int = -1                     # monotonic admission counter
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def finished(self) -> bool:
        """True once the request reached ANY terminal state."""
        return self.status in TERMINAL_STATES


@dataclasses.dataclass
class EngineStats:
    steps: int = 0                  # decode steps (fused windows count K)
    windows: int = 0                # decode dispatches (fused or per-step)
    prefills: int = 0
    tokens_generated: int = 0
    occupancy_sum: int = 0          # sum over steps of active slots
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    shed: int = 0
    rejected: int = 0               # failed at submission (subset of failed)
    preemptions: int = 0
    deadline_misses: int = 0
    # tokens run through a prefill forward (full or suffix), prompt tokens
    # served from shared prefix pages instead, and preemption resumes that
    # re-attached retained pages with no prefill
    prefilled_tokens: int = 0
    prefix_hit_tokens: int = 0
    page_resumes: int = 0
    bucket_hits: Dict[int, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    # host-clock seconds of the serving loop: prompt prefill (compute +
    # slot insert), decode windows (launch until the outputs reach the
    # host) and host-side sync work (drain, callbacks, recycling)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    sync_s: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    def as_dict(self) -> Dict:
        return {"steps": self.steps, "windows": self.windows,
                "prefills": self.prefills,
                "tokens_generated": self.tokens_generated,
                "completed": self.completed,
                "failed": self.failed, "cancelled": self.cancelled,
                "shed": self.shed, "rejected": self.rejected,
                "preemptions": self.preemptions,
                "deadline_misses": self.deadline_misses,
                "prefilled_tokens": self.prefilled_tokens,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "page_resumes": self.page_resumes,
                "mean_occupancy": round(self.mean_occupancy, 3),
                "prefill_buckets": dict(self.bucket_hits),
                "prefill_s": round(self.prefill_s, 4),
                "decode_s": round(self.decode_s, 4),
                "sync_s": round(self.sync_s, 4)}


class ServingEngine:
    """Slot-addressable continuous-batching engine over a Servable.

    ``max_slots`` bounds request concurrency (the batch of every decode
    call); ``cache_len`` bounds prompt + generation length per slot.
    ``sync_every = K`` fuses up to K decode steps into one on-device window
    between host syncs (``collect_logits`` forces K = 1). ``max_queue`` +
    ``overflow`` bound the admission queue. ``kv_layout`` (kwarg >
    ``REPRO_KV_LAYOUT`` env > spec) picks dense slot caches or page pools
    (``kv_pool_pages`` shrinks the pool to create pressure). ``seed`` and
    ``top_k`` are the reference's sampling knobs; greedy decoding (the only
    one ported) uses neither.
    """

    def __init__(self, servable, max_slots: int = 8, cache_len: int = 256,
                 *, min_bucket: int = 8, collect_logits: bool = False,
                 sync_every: int = 8, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 max_queue: Optional[int] = None, overflow: str = "reject",
                 watchdog_timeout_s: Optional[float] = None,
                 on_stall=None, chaos=None,
                 kv_layout: Optional[str] = None,
                 kv_pool_pages: Optional[int] = None, sched=None):
        cfg = servable.cfg
        if cfg.family == "bert":
            raise ValueError("encoder-only arch has no decode step")
        blockers = [
            (cfg.family == "audio", "family 'audio'",
             "ROADMAP.md Queue 1 slice 5"),
            ((sched if sched is not None else servable.spec.sched)
             is not None, "sched (SchedSpec chunked prefill and SLO "
             "scheduling)", _ITEM_ENGINE),
            (chaos is not None, "chaos injection", _ITEM_ENGINE),
            (watchdog_timeout_s is not None or on_stall is not None,
             "the watchdog", _ITEM_ENGINE),
            (servable.spec.mesh_shape is not None, "a mesh",
             "ROADMAP.md Queue 1 slice 6"),
            (float(temperature) > 0.0, f"temperature={temperature}",
             _ITEM_ENGINE),
        ]
        for blocked, what, item in blockers:
            if blocked:
                raise NotImplementedError(f"{what} comes with {item}")
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow={overflow!r} not in {OVERFLOW_POLICIES}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        self.servable = servable
        self.cfg = cfg
        self.device = servable.device
        self.max_slots = int(max_slots)
        self.cache_len = int(cache_len)
        # floor of 2: a length-1 "prefill" would hit the single-token decode
        # path (s == 1), which expects a pos argument
        self.min_bucket = max(2, int(min_bucket))
        self.collect_logits = collect_logits
        self.sync_every = 1 if collect_logits else max(1, int(sync_every))
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.stats = EngineStats()
        self.max_queue = None if max_queue is None else int(max_queue)
        self.overflow = overflow

        # the batch-1 prefill cache, rewritten entirely by every prefill
        self._sub = servable.init_cache(1, self.cache_len)

        # -- KV layout resolution: kwarg > REPRO_KV_LAYOUT env > spec ------
        layout = kv_layout or os.environ.get("REPRO_KV_LAYOUT") \
            or servable.spec.kv_layout
        if layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout={layout!r} not in {KV_LAYOUTS}")
        prefix_k, pattern_k, n_per, suffix_k = cfg.layer_plan()
        kinds = list(prefix_k) + (list(pattern_k) if n_per > 0 else []) \
            + list(suffix_k)
        pageable = [k for k in kinds if k.mixer == "attn" and k.window == 0]
        if layout == "paged" and not pageable:
            log.info("kv_layout='paged' unavailable for this config (no "
                     "global attention layers to page); serving dense")
            layout = "dense"
        self.kv_layout = layout
        self._pool = None
        self._prefix_cache = None
        self._slot_pages: Dict[int, List[int]] = {}
        self._saved_pages: Dict[int, tuple] = {}
        self._layout = None
        self._can_share = self._can_retain = False
        if layout == "paged":
            # largest page size <= spec.kv_page_size dividing cache_len;
            # the default pool matches the dense worst case
            ps = min(int(servable.spec.kv_page_size), self.cache_len)
            while self.cache_len % ps:
                ps -= 1
            self.kv_page_size = ps
            self._table_width = self.cache_len // ps
            n_pages = int(kv_pool_pages) if kv_pool_pages is not None \
                else self.max_slots * self._table_width
            self._layout = PagedLayout(page_size=ps, n_pages=n_pages)
            self._pool = PagePool(n_pages, ps)
            self._prefix_cache = PrefixCache(self._pool, ps)
            # prefix sharing and page retention need every layer's state in
            # pages (pure global attention)
            self._can_share = self._can_retain = all(
                k.mixer == "attn" and k.window == 0 for k in kinds)

        self.cache = self._build_cache()
        self._kv_bytes_total = sum(x.numel() * x.element_size()
                                   for x in leaves(self.cache))
        if self._pool is not None:
            pool_bytes = sum(
                x.numel() * x.element_size()
                for c in self._layer_caches(self.cache)
                for name, x in c["mix"].items() if name.endswith("_pages"))
            self._pool.bytes_per_page = pool_bytes // self._pool.n_pages

        self._tokens = np.zeros((self.max_slots, 1), np.int32)
        self._pos = np.full((self.max_slots,), -1, np.int32)
        self._remaining = np.zeros((self.max_slots,), np.int32)
        self._eos = np.full((self.max_slots,), -1, np.int32)
        self._free: List[int] = list(range(self.max_slots))
        self._active: Dict[int, EngineRequest] = {}
        self._queue: "collections.deque[EngineRequest]" = collections.deque()
        # terminal since the last run() drain; callers keep their handles
        self._done: List[EngineRequest] = []
        self._next_id = 0
        self._admit_counter = 0

    @staticmethod
    def _layer_caches(cache):
        return list(cache["prefix"]) + list(cache["blocks"]) \
            + list(cache["suffix"])

    def _build_cache(self):
        """A fresh all-slots-free engine cache (constructor AND the recovery
        path after a failed decode window)."""
        return self.servable.init_cache(self.max_slots, self.cache_len,
                                        paged=self._layout)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- submission -------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_id: Optional[int] = None, priority: int = 0,
               deadline_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               on_done: Optional[Callable[[int, List[int]], None]] = None
               ) -> EngineRequest:
        """Enqueue a request; returns its handle (``.tokens`` fills as the
        engine runs, ``.status`` reaches exactly one terminal state).
        Invalid requests are rejected at submission with a structured
        reason instead of failing late; submit() never raises for
        request-level problems."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = EngineRequest(req_id=self._next_id, prompt=prompt,
                            max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                            on_token=on_token, on_done=on_done,
                            priority=int(priority))
        req.submitted_at = time.monotonic()
        self._next_id += 1
        if deadline_s is not None:
            req.deadline_at = req.submitted_at + float(deadline_s)

        reject = None
        if prompt.size == 0:
            reject = "empty prompt"
        elif max_new_tokens < 1:
            reject = ("max_new_tokens must be >= 1 (the prefill already "
                      "samples the first token)")
        elif prompt.size + max_new_tokens > self.cache_len:
            reject = (f"prompt ({prompt.size}) + max_new_tokens "
                      f"({max_new_tokens}) exceeds cache_len "
                      f"({self.cache_len})")
        elif prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            reject = (f"prompt token ids outside [0, {self.cfg.vocab_size})")
        if reject is not None:
            self.stats.rejected += 1
            self._finalize(req, "failed",
                           FailureReason(FailureReason.REJECTED, reject))
            return req
        if req.deadline_at is not None and time.monotonic() > req.deadline_at:
            self._finalize(req, "failed", FailureReason(
                FailureReason.DEADLINE, "deadline expired at submission"))
            return req

        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if self.overflow == "block":
                # drive the engine until the queue drains below the bound
                while len(self._queue) >= self.max_queue and self.step():
                    pass
            if len(self._queue) >= self.max_queue:
                if self.overflow == "shed-oldest":
                    victim = self._queue.popleft()
                    self._finalize(victim, "shed", FailureReason(
                        FailureReason.QUEUE_FULL,
                        "shed by newer submission (shed-oldest)"))
                else:                   # 'reject' (or a block that stalled)
                    self._finalize(req, "shed", FailureReason(
                        FailureReason.QUEUE_FULL,
                        f"queue full ({self.max_queue}), policy "
                        f"{self.overflow!r}"))
                    return req
        self._queue.append(req)
        return req

    def cancel(self, req: EngineRequest) -> bool:
        """Request cancellation of ``req``. Queued requests cancel
        immediately; active ones at the next window-sync point (already
        generated tokens stay on the handle). Returns False when the
        request is already terminal."""
        if req.status in TERMINAL_STATES:
            return False
        req.cancel_requested = True
        if req.status == "queued":
            self._queue.remove(req)
            self._finalize(req, "cancelled", FailureReason(
                FailureReason.CANCELLED, "cancelled while queued"))
        return True

    # -- prefill ----------------------------------------------------------
    def _bucket(self, length: int) -> int:
        b = max(self.min_bucket, 1 << (length - 1).bit_length())
        return min(b, self.cache_len)

    def _seq(self, req: EngineRequest) -> np.ndarray:
        """Prompt + already generated tokens (a preempted request resumes by
        prefilling both)."""
        if not req.tokens:
            return req.prompt
        return np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])

    def _prefill_sub(self, seq: np.ndarray):
        """Bucketed one-pass prefill of ``seq`` into the batch-1 cache.
        Returns (bucket, host logits row of the last prompt position)."""
        length = int(seq.size)
        bucket = self._bucket(length)
        toks = np.zeros((bucket,), np.int32)
        toks[:length] = seq
        self._sub, logits = self.servable.engine_prefill(
            self._sub, self._dev(toks), length)
        row = logits[length - 1].float().cpu().numpy()  # once per admission
        return bucket, row

    def _admit(self, req: EngineRequest) -> bool:
        """Admit ``req`` into a free slot. Returns True when the request was
        consumed (now active, or terminally failed) and False when paged
        backpressure parked it back at the queue front."""
        if self.kv_layout == "paged":
            return self._admit_paged(req)
        return self._admit_dense(req)

    def _activate(self, req: EngineRequest, slot: int, pos: int,
                  pages: Optional[List[int]] = None) -> None:
        req.slot, req.pos = slot, pos
        req.status = "active"
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        self._active[slot] = req
        self._eos[slot] = -1 if req.eos_id is None else int(req.eos_id)
        if pages is not None:
            self._slot_pages[slot] = pages

    def _admit_dense(self, req: EngineRequest) -> bool:
        """Prefill ``req`` into a free slot. Any failure here fails only
        this request: the slot is returned and the engine keeps serving."""
        t0 = time.perf_counter()
        slot = None
        try:
            slot = self._free.pop(0)
            seq = self._seq(req)
            length = int(seq.size)
            bucket, row = self._prefill_sub(seq)
            self.cache = self.servable.engine_write_slot(self.cache, slot,
                                                         self._sub)
        except Exception as e:  # noqa: BLE001 -- isolate to this request
            self._restore_slot(slot)
            self.stats.prefill_s += time.perf_counter() - t0
            log.warning("admission of request %d failed (%s: %s)",
                        req.req_id, type(e).__name__, e)
            self._finalize(req, "failed", FailureReason(
                FailureReason.PREFILL_ERROR, f"{type(e).__name__}: {e}"))
            return True
        self.stats.prefilled_tokens += length
        return self._after_prefill(req, slot, length, bucket, row, t0)

    def _after_prefill(self, req, slot, length, bucket, row, t0,
                       pages=None, held=None) -> bool:
        """Common tail of a successful prefill: quarantine non-finite
        logits, else activate and emit the first sampled token."""
        self.stats.prefills += 1
        self.stats.bucket_hits[bucket] += 1
        if not np.all(np.isfinite(row)):
            if held:
                self._pool.release(held)
            self.cache = self.servable.engine_free_slot(self.cache, slot)
            self._restore_slot(slot)
            self.stats.prefill_s += time.perf_counter() - t0
            self._finalize(req, "failed", FailureReason(
                FailureReason.NONFINITE_LOGITS,
                f"non-finite prefill logits at position {length - 1}"))
            return True
        self._activate(req, slot, length, pages)
        tok = sample_token_row(row, None, slot, length - 1,
                               temperature=self.temperature,
                               top_k=self.top_k)
        self.stats.prefill_s += time.perf_counter() - t0
        self._emit(req, int(tok), row)
        return True

    def _page_row(self, pages: List[int]) -> np.ndarray:
        """A slot's page-table row: ``pages`` padded with -1 (unmapped)."""
        row = np.full((self._table_width,), -1, np.int32)
        row[:len(pages)] = pages
        return row

    def _reserve_pages(self, n: int) -> List[int]:
        """Claim ``n`` fresh pages, evicting LRU prefix-cache references
        when the free list runs short. Raises PagePoolExhausted when
        eviction cannot cover the request."""
        while self._pool.free_count < n and self._prefix_cache.evict(1):
            pass
        return self._pool.alloc(n)

    def _admit_paged(self, req: EngineRequest) -> bool:
        """Paged admission: reserve ceil((len + max_new) / page_size) pages
        up front, serve the longest cached prefix from shared pages, prefill
        only the remainder, and publish the fresh prompt's full pages for
        future sharers. A preempted request whose pages were retained
        re-attaches them with no prefill at all. Pool exhaustion is
        backpressure (park at the queue front, or fail when nothing can
        drain), never a crash."""
        t0 = time.perf_counter()
        slot = None
        held: List[int] = []            # pages owned by THIS admission
        try:
            slot = self._free.pop(0)
            saved = self._saved_pages.pop(req.req_id, None)
            if saved is not None:
                pages, resume_len = saved
                held = pages
                self.cache = self.servable.engine_restore_paged(
                    self.cache, slot, self._page_row(pages), resume_len)
                self._activate(req, slot, resume_len, pages)
                self._tokens[slot, 0] = req.tokens[-1]
                self._pos[slot] = resume_len
                self._remaining[slot] = \
                    req.max_new_tokens - req.n_generated
                self.stats.page_resumes += 1
                self.stats.prefill_s += time.perf_counter() - t0
                return True

            seq = self._seq(req)
            length = int(seq.size)
            need = pages_needed(
                min(length + req.max_new_tokens, self.cache_len),
                self.kv_page_size)
            shared: List[int] = []
            if self._can_share and not req.tokens:
                # cap the match at length-1 so a fully cached prompt still
                # prefills >= 1 suffix token
                shared = self._prefix_cache.match(seq, limit=length - 1)
                held = held + shared
            start = len(shared) * self.kv_page_size
            fresh = self._reserve_pages(need - len(shared))
            held = held + fresh
            pages = shared + fresh

            if start > 0:
                # prefix hit: attach the pages, then prefill only the suffix
                # against the resident shared prefix (its write positions
                # never land in shared full pages)
                suffix = seq[start:]
                slen = int(suffix.size)
                bucket = self._bucket(slen)
                toks = np.zeros((bucket,), np.int32)
                toks[:slen] = suffix
                self.cache = self.servable.engine_restore_paged(
                    self.cache, slot, self._page_row(pages), start)
                self.cache, logits = self.servable.suffix_prefill(
                    self.cache, self._dev(toks), slot, start, slen)
                row = logits[slen - 1].float().cpu().numpy()
                self.stats.prefix_hit_tokens += start
                self.stats.prefilled_tokens += slen
            else:
                bucket, row = self._prefill_sub(seq)
                self.cache = self.servable.engine_write_paged(
                    self.cache, slot, self._sub, self._page_row(pages))
                self.stats.prefilled_tokens += length
                if self._can_share and not req.tokens:
                    # publish the prompt's FULL pages (the partial tail page
                    # is mutable)
                    self._prefix_cache.insert(
                        seq, pages[:length // self.kv_page_size])
        except PagePoolExhausted as e:
            if held:
                self._pool.release(held)
            self._restore_slot(slot)
            self.stats.prefill_s += time.perf_counter() - t0
            if self._active:
                req.status = "queued"
                self._queue.appendleft(req)
                log.info("parking request %d on page pressure (%s)",
                         req.req_id, e)
                return False
            self._finalize(req, "failed", FailureReason(
                FailureReason.KV_PAGES,
                f"{e} with no active requests to drain"))
            return True
        except Exception as e:  # noqa: BLE001 -- isolate to this request
            if held:
                self._pool.release(held)
            self._restore_slot(slot)
            self.stats.prefill_s += time.perf_counter() - t0
            log.warning("admission of request %d failed (%s: %s)",
                        req.req_id, type(e).__name__, e)
            self._finalize(req, "failed", FailureReason(
                FailureReason.PREFILL_ERROR, f"{type(e).__name__}: {e}"))
            return True
        return self._after_prefill(req, slot, length, bucket, row, t0,
                                   pages=pages, held=held)

    def _restore_slot(self, slot: Optional[int]) -> None:
        """Return a popped-but-unoccupied slot to the free list."""
        if slot is not None and slot not in self._free:
            self._free.append(slot)
            self._free.sort()

    # -- lifecycle --------------------------------------------------------
    def _emit(self, req: EngineRequest, tok: int, logits_row=None) -> None:
        """Record one sampled token and retire the request if it just
        completed."""
        req.tokens.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        if self.collect_logits and logits_row is not None:
            req.step_logits.append(np.asarray(logits_row, np.float32))
        self.stats.tokens_generated += 1
        if req.on_token is not None:
            req.on_token(req.req_id, tok)
        if (req.n_generated >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finalize(req, "done")
        else:
            self._tokens[req.slot, 0] = tok
            self._pos[req.slot] = req.pos
            self._remaining[req.slot] = req.max_new_tokens - req.n_generated

    def _release_slot(self, req: EngineRequest, *,
                      keep_pages: bool = False) -> None:
        """Free ``req``'s slot with full recycle hygiene (zeroed on the
        device, host mirrors reset, back on the free list). Paged engines
        also settle the slot's page references: released to the pool, or
        (``keep_pages``, preemption retention) parked with the resume
        position."""
        slot = req.slot
        if self.kv_layout == "paged":
            pages = self._slot_pages.pop(slot, [])
            if keep_pages and pages:
                # resume point: KV holds positions 0..req.pos-1 (the current
                # token's KV is written by its NEXT decode step)
                self._saved_pages[req.req_id] = (pages, req.pos)
            elif pages:
                self._pool.release(pages)
        self.cache = self.servable.engine_free_slot(self.cache, slot)
        self._pos[slot] = -1
        self._tokens[slot, 0] = 0
        self._remaining[slot] = 0
        self._eos[slot] = -1
        del self._active[slot]
        self._free.append(slot)
        self._free.sort()
        req.slot = -1

    def _finalize(self, req: EngineRequest, status: str,
                  reason: Optional[FailureReason] = None) -> None:
        """Move ``req`` to its single terminal state, releasing its slot
        (and any retained pages) if it holds one."""
        if req.slot >= 0:
            self._release_slot(req)
        if self.kv_layout == "paged":
            saved = self._saved_pages.pop(req.req_id, None)
            if saved is not None:
                self._pool.release(saved[0])
        req.status = status
        req.failure = reason
        req.done = status == "done"
        req.finished_at = time.monotonic()
        if status == "done":
            self.stats.completed += 1
        elif status == "failed":
            self.stats.failed += 1
        elif status == "cancelled":
            self.stats.cancelled += 1
        elif status == "shed":
            self.stats.shed += 1
        if reason is not None and reason.code == FailureReason.DEADLINE:
            self.stats.deadline_misses += 1
        self._done.append(req)
        if status == "done" and req.on_done is not None:
            req.on_done(req.req_id, list(req.tokens))

    def _preempt(self, req: EngineRequest) -> None:
        """Evict an in-flight request and requeue it at the front.
        Re-admission resumes it by page retention where the layout allows
        (paged, every layer global) and otherwise by prefilling prompt +
        generated tokens; greedy streams continue exactly."""
        keep = (self.kv_layout == "paged" and self._can_retain
                and req.n_generated > 0)
        self._release_slot(req, keep_pages=keep)
        req.status = "queued"
        req.n_preempted += 1
        self.stats.preemptions += 1
        self._queue.appendleft(req)

    def _sweep_control(self) -> None:
        """The window-sync control sweep: apply pending cancellations and
        expire deadlines of queued and active requests."""
        now = time.monotonic()

        def expired(r):
            return r.deadline_at is not None and now > r.deadline_at

        for req in [r for r in self._queue
                    if r.cancel_requested or expired(r)]:
            self._queue.remove(req)
            if req.cancel_requested:
                self._finalize(req, "cancelled", FailureReason(
                    FailureReason.CANCELLED, "cancelled while queued"))
            else:
                self._finalize(req, "failed", FailureReason(
                    FailureReason.DEADLINE,
                    "deadline expired before admission"))
        for req in [r for r in self._active.values()
                    if r.cancel_requested or expired(r)]:
            if req.cancel_requested:
                self._finalize(req, "cancelled", FailureReason(
                    FailureReason.CANCELLED,
                    f"cancelled after {req.n_generated} tokens"))
            else:
                self._finalize(req, "failed", FailureReason(
                    FailureReason.DEADLINE,
                    f"deadline expired after {req.n_generated}/"
                    f"{req.max_new_tokens} tokens"))

    def _pop_next(self) -> EngineRequest:
        """Highest-priority queued request, FIFO within a priority class."""
        best_i, best = 0, self._queue[0]
        for i, req in enumerate(self._queue):
            if req.priority > best.priority:
                best_i, best = i, req
        del self._queue[best_i]
        return best

    def _schedule(self) -> None:
        """Admissions + priority preemption (a window-sync point action).
        A False from ``_admit`` means paged backpressure parked the request
        -- stop admitting until the next sync point."""
        while self._free and self._queue:
            if not self._admit(self._pop_next()):
                return
        # under slot pressure: strictly-higher-priority queued traffic
        # evicts the lowest-priority (latest-admitted on ties) active request
        while self._queue and not self._free and self._active:
            best_p = max(r.priority for r in self._queue)
            victim = min(self._active.values(),
                         key=lambda r: (r.priority, -r.admit_seq))
            if best_p <= victim.priority:
                break
            self._preempt(victim)
            if not self._admit(self._pop_next()):
                return

    # -- stepping ---------------------------------------------------------
    def step(self) -> bool:
        """One window-sync cycle: control sweep, schedule (admit + preempt),
        then ONE batched decode window (up to ``sync_every`` fused steps).
        Returns True while there is (or may be) work left."""
        self._sweep_control()
        self._schedule()
        decoding = sorted(s for s in self._active if self._pos[s] >= 0)
        if not decoding:
            return bool(self._active or self._queue)
        try:
            k = min(self.sync_every,
                    max(int(self._remaining[s]) for s in decoding))
            if k <= 1:
                self._step_single(decoding)
            else:
                self._step_fused(k, decoding)
        except Exception as e:  # noqa: BLE001 -- keep the engine serving
            self._recover_window_failure(e)
        return bool(self._active or self._queue)

    def _recover_window_failure(self, err: Exception) -> None:
        """A decode window raised: the in-place cache may be half written,
        so fail every active request with a structured reason, rebuild a
        fresh cache and leave the engine usable."""
        log.warning("decode window failed (%s: %s); failing %d active "
                    "request(s) and rebuilding the engine cache",
                    type(err).__name__, err, len(self._active))
        reason = FailureReason(
            FailureReason.ENGINE_ERROR,
            f"decode window failed: {type(err).__name__}: {err}")
        reqs = list(self._active.values())
        self._active.clear()
        self._free = list(range(self.max_slots))
        self._pos[:] = -1
        self._tokens[:] = 0
        self._remaining[:] = 0
        self._eos[:] = -1
        if self.kv_layout == "paged":
            self._slot_pages.clear()
            self._saved_pages.clear()
            self._pool.reset()
            self._prefix_cache = PrefixCache(self._pool, self.kv_page_size)
        self.cache = self._build_cache()
        for req in reqs:
            req.slot = -1
            self._finalize(req, "failed", reason)

    def _step_single(self, decoding: List[int]) -> None:
        """The unfused loop: one decode, one host sync per token (kept for
        ``sync_every=1`` and ``collect_logits``)."""
        t0 = time.perf_counter()
        self.stats.steps += 1
        self.stats.windows += 1
        self.stats.occupancy_sum += len(decoding)
        next_tok, ok, logits, self.cache = self.servable.engine_decode(
            self.cache, self._dev(self._tokens), self._dev(self._pos),
            temperature=self.temperature, top_k=self.top_k)
        toks = next_tok.cpu().numpy()
        ok_h = ok.cpu().numpy()
        rows = logits[:, 0, :].float().cpu().numpy() \
            if self.collect_logits else None
        self.stats.decode_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        for slot in decoding:
            req = self._active[slot]
            if not ok_h[slot]:
                self._finalize(req, "failed", FailureReason(
                    FailureReason.NONFINITE_LOGITS,
                    f"non-finite decode logits at position {req.pos}"))
                continue
            req.pos += 1
            self._emit(req, int(toks[slot]),
                       rows[slot] if rows is not None else None)
        self.stats.sync_s += time.perf_counter() - t0

    def _step_fused(self, k: int, decoding: List[int]) -> None:
        """The fused hot loop: K decode steps on the device, then ONE host
        sync that drains the emitted tokens, fires callbacks in step order
        and recycles finished slots. ``k`` never exceeds the largest
        remaining budget; slots that finish mid-window ride along as no-ops
        until the sync."""
        t0 = time.perf_counter()
        self.stats.steps += k
        self.stats.windows += 1
        toks, valid, state = self.servable.decode_many(
            self.cache, self._dev(self._tokens), self._dev(self._pos), k,
            remaining=self._dev(self._remaining),
            eos_id=self._dev(self._eos), temperature=self.temperature,
            top_k=self.top_k)
        self.cache = state["cache"]
        toks_h = toks.cpu().numpy()             # (K, B) int32
        valid_h = valid.cpu().numpy()           # (K, B) bool
        failed_h = state["failed"].cpu().numpy()
        self._tokens = state["token"].cpu().numpy().astype(np.int32)
        self._pos = state["pos"].cpu().numpy().astype(np.int32)
        self._remaining = state["remaining"].cpu().numpy().astype(np.int32)
        self.stats.decode_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        self.stats.occupancy_sum += int(valid_h.sum())
        for step in range(k):
            for slot in decoding:
                if not valid_h[step, slot]:
                    continue
                req = self._active[slot]
                req.pos += 1
                tok = int(toks_h[step, slot])
                req.tokens.append(tok)
                if req.first_token_at is None:
                    req.first_token_at = time.monotonic()
                self.stats.tokens_generated += 1
                if req.on_token is not None:
                    req.on_token(req.req_id, tok)
        for slot in decoding:
            req = self._active[slot]
            if failed_h[slot]:                  # the device quarantined it
                self._finalize(req, "failed", FailureReason(
                    FailureReason.NONFINITE_LOGITS,
                    f"non-finite decode logits in fused window at "
                    f"position {req.pos}"))
            elif self._pos[slot] < 0:           # the device finished it
                self._finalize(req, "done")
        self.stats.sync_s += time.perf_counter() - t0

    def run(self, max_steps: Optional[int] = None) -> List[EngineRequest]:
        """Drain the queue and all active slots; returns every request that
        reached a terminal state since the last drain, in submission order,
        and releases them from engine tracking."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        done, self._done = self._done, []
        return sorted(done, key=lambda r: r.req_id)

    def close(self) -> None:
        """Nothing to stop (no watchdog thread in this engine)."""

    # -- test hooks -------------------------------------------------------
    def corrupt_slot(self, slot: int) -> None:
        """NaN-fill one slot's cache state so its next logits go non-finite
        (the quarantine path must contain the damage to this slot). Paged
        engines NaN-fill the slot's own private pages (refcount 1) instead:
        shared prefix pages are other requests' state too."""
        slot = int(slot)
        if self.kv_layout == "paged":
            own = [p for p in self._slot_pages.get(slot, [])
                   if self._pool.refcount(p) == 1]
            if not own:
                return
            rows = torch.tensor(own, dtype=torch.long, device=self.device)
            for c in self._layer_caches(self.cache):
                for name, x in c["mix"].items():
                    if name.endswith("_pages"):
                        if x.dim() == 5:          # period-stacked pools
                            x[:, rows] = float("nan")
                        else:
                            x[rows] = float("nan")
            return
        sections = [(c, False) for c in self.cache["prefix"]] \
            + [(c, True) for c in self.cache["blocks"]] \
            + [(c, False) for c in self.cache["suffix"]]
        for c, stacked in sections:
            for x in c["mix"].values():
                if x.is_floating_point():
                    (x[:, slot] if stacked else x[slot]).fill_(float("nan"))

    def verify_invariants(self) -> None:
        """Assert the engine's internal bookkeeping is consistent. Raises
        AssertionError on violation; cheap enough for tests."""
        slots = sorted(self._free) + sorted(self._active)
        assert sorted(slots) == list(range(self.max_slots)), (
            f"slot leak: free={sorted(self._free)} "
            f"active={sorted(self._active)} of {self.max_slots}")
        assert len(set(self._free)) == len(self._free), (
            f"duplicate free slots: {self._free}")
        for slot, req in self._active.items():
            assert req.slot == slot and req.status == "active", (
                f"slot {slot} holds request {req.req_id} with "
                f"slot={req.slot} status={req.status}")
            assert self._pos[slot] >= 0 or req.n_generated > 0, (
                f"active slot {slot} has no progress")
        for slot in self._free:
            assert self._pos[slot] == -1, (
                f"free slot {slot} has live pos {self._pos[slot]}")
        for req in self._queue:
            assert req.status == "queued" and req.slot == -1, (
                f"queued request {req.req_id} has slot={req.slot} "
                f"status={req.status}")
        for req in self._done:
            assert req.status in TERMINAL_STATES and req.slot == -1, (
                f"drained request {req.req_id} non-terminal: {req.status}")
        if self.kv_layout == "paged":
            self._pool.check()
            assert set(self._slot_pages) == set(self._active), (
                f"page ownership out of sync with active slots: "
                f"{sorted(self._slot_pages)} vs {sorted(self._active)}")
            for slot, pages in self._slot_pages.items():
                for p in pages:
                    assert self._pool.refcount(p) >= 1, (
                        f"slot {slot} holds unreferenced page {p}")
            for req_id, (pages, _len) in self._saved_pages.items():
                for p in pages:
                    assert self._pool.refcount(p) >= 1, (
                        f"retained request {req_id} holds unreferenced "
                        f"page {p}")

    # -- introspection ----------------------------------------------------
    def kv_stats(self) -> Dict:
        """KV-memory scorecard (``stats_dict()['kv']``): layout, pool
        utilization and the prefix-sharing / retention counters."""
        if self.kv_layout != "paged":
            return {"layout": "dense",
                    "kv_bytes_total": int(self._kv_bytes_total),
                    "kv_bytes_per_slot":
                        int(self._kv_bytes_total) // self.max_slots,
                    "prefilled_tokens": self.stats.prefilled_tokens,
                    "prefix_hit_tokens": 0}
        pool = self._pool
        return {"layout": "paged",
                "page_size": self.kv_page_size,
                "n_pages": pool.n_pages,
                "pages_used": pool.used_count,
                "pages_free": pool.free_count,
                "peak_pages_used": pool.peak_used,
                "bytes_per_page": pool.bytes_per_page,
                "kv_bytes_total": pool.total_bytes(),
                "kv_bytes_used": pool.used_bytes(),
                "utilization": round(pool.used_count / pool.n_pages, 4),
                "prefix_cached_pages": self._prefix_cache.cached_pages,
                "prefix_hit_tokens": self.stats.prefix_hit_tokens,
                "prefilled_tokens": self.stats.prefilled_tokens,
                "page_resumes": self.stats.page_resumes}

    def stats_dict(self) -> Dict:
        """``EngineStats.as_dict()`` plus the ``'kv'`` section and, when the
        servable carries quantized packs, the ``'quant'`` section (pack
        bytes, compression against fp32, worst quantization error)."""
        d = self.stats.as_dict()
        d["kv"] = self.kv_stats()
        qs = self.servable.quant_stats()
        if qs:
            d["quant"] = qs
        return d

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_free(self) -> int:
        return len(self._free)
