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
  * **SLO-aware scheduling** (``sched=SchedSpec(...)``) -- chunked prefill
    splits long prompts into ``max_chunk``-sized slices run through the
    suffix-prefill path between decode windows (a partially prefilled
    request holds its slot as a pos -1 no-op row), a per-window
    ``token_budget`` with a ``decode_priority`` reserve keeps a long prompt
    from head-of-line blocking the running decodes, and overload
    degradation fast-fails deadlines the measured prefill/decode rates
    already rule out and sheds the newest low-priority queued traffic once
    the estimated queue delay exceeds ``max_queue_delay_s``;
  * **request lifecycle** -- every submitted request ends in exactly one
    terminal status (``done`` / ``failed`` / ``cancelled`` / ``shed``) with
    a structured :class:`FailureReason` off the success path: rejection at
    submission, deadlines and cancellation at window-sync points, priority
    **preemption** (the victim resumes by re-prefilling prompt + generated
    tokens, or -- paged, every layer global -- by re-attaching its retained
    pages), **non-finite quarantine** of a poisoned slot, and recovery from
    a failed decode window (its requests fail, the cache is rebuilt, the
    engine keeps serving); an optional **watchdog**
    (``watchdog_timeout_s``) detects stuck windows and chunks from a
    background thread, and **chaos hooks** (``chaos=runtime.chaos.
    ChaosInjector()``) fire at alloc / prefill / chunk / page-alloc /
    window / sync / arrival so every fault path is testable;
  * **KV layouts** -- ``'dense'`` slot caches or ``'paged'`` page pools for
    the global layers with a host-side refcounting allocator
    (``serving/paging.py``) and radix prefix sharing
    (``serving/prefix_cache.py``);
  * **slot lifecycle** -- any retirement zeroes the slot, so a recycled
    slot cannot leak its previous request;
  * **the audio family** (enc-dec) -- a request carries its encoder
    ``frames``; admission encodes them into a batch-1 cache (the cross K/V)
    and prefills its decoder prompt through the decode path; paged KV and
    chunked prefill log their blockers and serve dense / one-shot, as the
    reference does. The recurrent families (ssm, hybrid) have no layer to
    page and serve dense likewise.

The engine cache is preallocated once and updated **in place** by every
prefill insert, decode window and slot op (the reference rebuilds it
functionally and donates the old buffers to each compiled call). The
batch-1 prefill cache is allocated once per engine too: a prefill rewrites
every one of its tensors, so nothing of the previous prompt survives into
the next (an audio request gets its own, encoded from its frames).

Sampling is configured per engine (``temperature`` / ``top_k`` / ``seed``):
each token's key is JAX's threefry key folded by (slot, position)
(``models/sampling.py``), so the port samples the reference's tokens, and
fused and per-step decoding sample alike.

**Meshes** (a servable prepared or loaded with ``spec.mesh_shape``): every
rank of the mesh builds the same engine and submits the same requests, and
every rank runs the same host schedule -- admission, buckets, windows and
slot recycling. The cache is this rank's shard (slots over "data"; KV
heads, latent rank, recurrent heads, conv channels or width over "model";
an audio request's batch-1 cache, built from its frames on every rank,
holds the rank's heads of its cross K/V); a rank decodes its own slots and the window's tokens are
all-gathered at the sync, prefill logits rows are agreed over "data", so
the schedulers never diverge. Clock-driven control (deadlines, SLO
fast-fail and overload shedding) would diverge across ranks and is refused
on a mesh of more than one rank; paged KV on a "data" axis logs its
blocker and serves dense (the page ids are one shared space).
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
from repro_torch.models import prng
from repro_torch.models.common import PagedLayout
from repro_torch.models.encdec import cache_leaves
from repro_torch.models.sampling import sample_token_row
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.serving.paging import PagePool, PagePoolExhausted, \
    pages_needed
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.spec import KV_LAYOUTS, OVERFLOW_POLICIES, SchedSpec

__all__ = ["EngineRequest", "EngineStats", "FailureReason", "ServingEngine",
           "TERMINAL_STATES"]

log = logging.getLogger("repro_torch.serving")

#: the exactly-once terminal accounting: every submit() ends in ONE of these
TERMINAL_STATES = frozenset({"done", "failed", "cancelled", "shed"})


@dataclasses.dataclass(frozen=True)
class FailureReason:
    """Structured reason attached to every non-success terminal request."""

    code: str
    message: str = ""

    REJECTED = "rejected"                # invalid at submission
    QUEUE_FULL = "queue_full"            # shed by backpressure policy
    OVERLOAD = "overload_shed"           # SLO shedding (SchedSpec knobs)
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
    frames: Optional[np.ndarray] = None     # audio family: encoder input
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
    # chunked prefill: prompt tokens already resident in the slot vs the
    # full prefill length; pos == target (or target == 0) = decodable
    prefill_pos: int = 0
    prefill_target: int = 0
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
    watchdog_stalls: int = 0
    # tokens run through a prefill forward (full or suffix), prompt tokens
    # served from shared prefix pages instead, and preemption resumes that
    # re-attached retained pages with no prefill
    prefilled_tokens: int = 0
    prefix_hit_tokens: int = 0
    page_resumes: int = 0
    prefill_chunks: int = 0         # chunk dispatches (SLO scheduler)
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
                "watchdog_stalls": self.watchdog_stalls,
                "prefilled_tokens": self.prefilled_tokens,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "page_resumes": self.page_resumes,
                "prefill_chunks": self.prefill_chunks,
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
    (``kv_pool_pages`` shrinks the pool to create pressure).
    ``temperature`` / ``top_k`` / ``seed`` configure sampling (0 = greedy).

    ``watchdog_timeout_s`` arms a stuck-window detector (``on_stall(label,
    elapsed)`` optional; ``stats_dict()['watchdog']`` reports it, with the
    last stall's snapshot of queue / active / chunk state); ``chaos``
    attaches a :class:`~repro_torch.runtime.chaos.ChaosInjector` whose
    engine sites this engine fires; ``sched`` (kwarg > ``spec.sched``)
    enables the SLO scheduler (module docstring).
    """

    def __init__(self, servable, max_slots: int = 8, cache_len: int = 256,
                 *, min_bucket: int = 8, collect_logits: bool = False,
                 sync_every: int = 8, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 max_queue: Optional[int] = None, overflow: str = "reject",
                 watchdog_timeout_s: Optional[float] = None,
                 on_stall: Optional[Callable[[str, float], None]] = None,
                 chaos: Optional["chaos_mod.ChaosInjector"] = None,
                 kv_layout: Optional[str] = None,
                 kv_pool_pages: Optional[int] = None,
                 sched: Optional[SchedSpec] = None):
        cfg = servable.cfg
        if cfg.family == "bert":
            raise ValueError("encoder-only arch has no decode step")
        self._mesh = servable.mesh
        if self._mesh is not None and self._mesh.size > 1:
            sched_ = sched if sched is not None else servable.spec.sched
            if sched_ is not None and (sched_.fast_fail
                                       or sched_.max_queue_delay_s > 0):
                raise ValueError(
                    "fast_fail / max_queue_delay_s read each rank's clock; "
                    "on a mesh the ranks' schedules would diverge")
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
        self._key = prng.PRNGKey(int(seed), device=self.device)
        self.stats = EngineStats()
        self.max_queue = None if max_queue is None else int(max_queue)
        self.overflow = overflow
        self._chaos = chaos
        self._watchdog = None
        self._user_on_stall = on_stall
        self._watchdog_snapshot: Optional[Dict] = None

        # the batch-1 prefill cache, rewritten entirely by every prefill
        # (audio builds one per request from its frames at admission)
        self._audio = cfg.family == "audio"
        self._sub = None if self._audio else servable.init_cache(
            1, self.cache_len)

        # -- KV layout resolution: kwarg > REPRO_KV_LAYOUT env > spec ------
        layout = kv_layout or os.environ.get("REPRO_KV_LAYOUT") \
            or servable.spec.kv_layout
        if layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout={layout!r} not in {KV_LAYOUTS}")
        prefix_k, pattern_k, n_per, suffix_k = cfg.layer_plan()
        kinds = list(prefix_k) + (list(pattern_k) if n_per > 0 else []) \
            + list(suffix_k)
        pageable = [k for k in kinds
                    if k.mixer in ("attn", "mla") and k.window == 0]
        if layout == "paged":
            blocker = None
            if self._audio:
                blocker = "family 'audio' (cross-attn caches are per-request)"
            elif cfg.kv_cache_quant:
                blocker = "kv_cache_quant (int8 page pools are future work)"
            elif not pageable:
                blocker = "no linear attention/MLA layers to page"
            elif servable.spec.data_shards > 1:
                blocker = "data-parallel mesh (page ids are a shared space)"
            if blocker is not None:
                log.info("kv_layout='paged' unavailable for this config "
                         "(%s); serving dense", blocker)
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
            # prefix sharing needs the masked suffix-prefill path (pure
            # global attention); preempt-resume page retention also admits
            # MLA (restore is layout-only, no recompute)
            self._can_share = all(k.mixer == "attn" and k.window == 0
                                  for k in kinds)
            self._can_retain = all(k.mixer in ("attn", "mla")
                                   and k.window == 0 for k in kinds)

        # -- SLO scheduling: kwarg > spec -----------------------------------
        # sched arms deadline fast-fail and overload shedding regardless;
        # chunked prefill (max_chunk > 0) needs the exact chunk path, which
        # int8 KV lacks -- such configs admit one-shot with the other knobs
        # still live
        self.sched = sched if sched is not None else servable.spec.sched
        self._chunking = False
        if self.sched is not None and self.sched.max_chunk > 0:
            blocker = None
            if self._audio:
                blocker = "family 'audio' prefills through the decode path"
            elif cfg.kv_cache_quant:
                blocker = "kv_cache_quant: int8 KV has no exact chunk path"
            elif any(k.ffn == "moe" for k in kinds):
                blocker = "MoE ffn (expert routing is batch-global)"
            if blocker is not None:
                log.info("chunked prefill unavailable for this config "
                         "(%s); scheduling runs without it", blocker)
            else:
                self._chunking = True
        # chunk lengths are quantized: every dispatched chunk is exactly
        # _chunk_len tokens or the prompt tail, never a budget-truncated
        # remainder, so max_chunk is clamped to the window budget and a
        # chunk that no longer fits waits for the next window
        self._chunk_len = 0
        if self._chunking:
            self._chunk_len = self.sched.max_chunk
            if self.sched.token_budget > 0:
                self._chunk_len = min(self._chunk_len,
                                      self.sched.token_budget)
        #: req_ids whose fresh full-prompt pages publish to the prefix
        #: cache once their (chunked) prefill completes
        self._pending_publish: set = set()

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
        if watchdog_timeout_s is not None:
            # started last, so a constructor that raises leaves no thread;
            # the engine interposes on the stall callback to snapshot its
            # queue / active / chunk state for stats_dict()['watchdog']
            self._watchdog = chaos_mod.Watchdog(watchdog_timeout_s,
                                                on_stall=self._on_stall)

    @staticmethod
    def _layer_caches(cache):
        return list(cache["prefix"]) + list(cache["blocks"]) \
            + list(cache["suffix"])

    def _build_cache(self):
        """A fresh all-slots-free engine cache (constructor AND the recovery
        path after a failed decode window). Audio: a structure-only cache
        of zero frames; each request's cross K/V arrive with its
        admission."""
        if self._audio:
            cfg = self.cfg
            return self.servable.init_cache(
                self.max_slots, self.cache_len, frames=torch.zeros(
                    (self.max_slots, cfg.n_audio_ctx, cfg.d_model),
                    dtype=cfg.tdtype, device=self.device))
        return self.servable.init_cache(self.max_slots, self.cache_len,
                                        paged=self._layout)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- submission -------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_id: Optional[int] = None, frames=None, priority: int = 0,
               deadline_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               on_done: Optional[Callable[[int, List[int]], None]] = None
               ) -> EngineRequest:
        """Enqueue a request; returns its handle (``.tokens`` fills as the
        engine runs, ``.status`` reaches exactly one terminal state).
        Invalid requests are rejected at submission with a structured
        reason instead of failing late; submit() never raises for
        request-level problems. ``deadline_s`` is a relative wall-clock
        budget enforced at window-sync points (and, with a ``SchedSpec``
        and ``fast_fail``, failed at submission when the engine's measured
        rates already rule it out). ``frames`` (T_audio, d) or
        (1, T_audio, d): an audio request's encoder input."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = EngineRequest(req_id=self._next_id, prompt=prompt,
                            max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                            frames=frames, on_token=on_token, on_done=on_done,
                            priority=int(priority))
        req.submitted_at = time.monotonic()
        self._next_id += 1
        if deadline_s is not None:
            req.deadline_at = req.submitted_at + float(deadline_s)

        reject = None
        if deadline_s is not None and self._mesh is not None \
                and self._mesh.size > 1:
            reject = ("deadline_s reads each rank's clock; on a mesh the "
                      "ranks' schedules would diverge")
        elif prompt.size == 0:
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
        elif self._audio and frames is None:
            reject = "audio requests need encoder frames"
        if reject is not None:
            self.stats.rejected += 1
            self._finalize(req, "failed",
                           FailureReason(FailureReason.REJECTED, reject))
            return req
        if req.deadline_at is not None:
            now = time.monotonic()
            if now > req.deadline_at:
                self._finalize(req, "failed", FailureReason(
                    FailureReason.DEADLINE, "deadline expired at submission"))
                return req
            if self.sched is not None and self.sched.fast_fail:
                est = self._service_estimate_s(req)
                if est is not None and now + est > req.deadline_at:
                    self._finalize(req, "failed", FailureReason(
                        FailureReason.DEADLINE,
                        f"projected completion in {est:.3f}s exceeds the "
                        f"deadline (measured prefill/decode rates)"))
                    return req

        if self._chaos is not None:
            # open-loop ingest chaos: an action may re-entrantly submit a
            # burst through this engine; an exception sheds only this
            # submission with a structured reason
            try:
                self._fire(chaos_mod.SITE_ARRIVAL_BURST, request=req)
            except Exception as e:  # noqa: BLE001 -- shed, keep serving
                self._finalize(req, "shed", FailureReason(
                    FailureReason.OVERLOAD,
                    f"shed at ingest: {type(e).__name__}: {e}"))
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
        self._shed_overload()
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

    # -- SLO estimation + overload degradation ----------------------------
    def _service_estimate_s(self, req: EngineRequest) -> Optional[float]:
        """Projected seconds to finish ``req`` from the engine's measured
        prefill / decode rates (the EngineStats host-clock buckets); None
        until both rates have samples, so a cold engine neither fast-fails
        nor sheds."""
        st = self.stats
        if (st.prefill_s <= 0 or st.prefilled_tokens <= 0
                or st.decode_s <= 0 or st.steps <= 0):
            return None
        pre_tokens = req.prompt.size + req.n_generated - req.prefill_pos
        pre = pre_tokens / (st.prefilled_tokens / st.prefill_s)
        dec = (req.max_new_tokens - req.n_generated) \
            / (st.steps / st.decode_s)
        return max(pre, 0.0) + max(dec, 0.0)

    def _shed_overload(self) -> None:
        """Overload degradation (``sched.max_queue_delay_s > 0``): while the
        estimated time to drain the queue exceeds the bound, shed queued
        requests -- lowest priority first, newest first within a class --
        with the OVERLOAD reason."""
        if (self.sched is None or self.sched.max_queue_delay_s <= 0
                or not self._queue):
            return
        ests: Dict[int, float] = {}
        for r in self._queue:
            est = self._service_estimate_s(r)
            if est is None:         # rates not measured yet: never shed
                return
            ests[r.req_id] = est
        bound = self.sched.max_queue_delay_s
        slots = max(1, self.max_slots)
        backlog = sum(ests.values()) / slots
        while backlog > bound and self._queue:
            victim = min(self._queue,
                         key=lambda r: (r.priority, -r.submitted_at))
            self._queue.remove(victim)
            backlog -= ests[victim.req_id] / slots
            self._finalize(victim, "shed", FailureReason(
                FailureReason.OVERLOAD,
                f"estimated queue delay exceeds "
                f"max_queue_delay_s={bound}"))

    def _on_stall(self, label: str, elapsed: float) -> None:
        """Watchdog callback (daemon thread): snapshot queue / active /
        chunk state for ``stats_dict()['watchdog']`` -- best-effort shallow
        reads, since the serving thread keeps mutating -- then forward to
        the user's ``on_stall``."""
        try:
            now = time.monotonic()

            def row(r):
                return {"req_id": r.req_id, "status": r.status,
                        "pos": int(r.pos),
                        "prefill_pos": int(r.prefill_pos),
                        "prefill_target": int(r.prefill_target),
                        "n_generated": r.n_generated,
                        "age_s": round(now - r.submitted_at, 4)}

            self._watchdog_snapshot = {
                "site": label, "elapsed_s": round(elapsed, 4),
                "n_queued": len(self._queue),
                "n_active": len(self._active),
                "queued": [row(r) for r in list(self._queue)[:8]],
                "active": [row(r) for r in list(self._active.values())[:8]]}
        except Exception:  # noqa: BLE001 -- racing the serving thread
            self._watchdog_snapshot = {"site": label,
                                       "elapsed_s": round(elapsed, 4)}
        if self._user_on_stall is not None:
            self._user_on_stall(label, elapsed)

    def _fire(self, site: str, **ctx) -> None:
        """Fire chaos site ``site`` when an injector is attached."""
        if self._chaos is not None:
            self._chaos.fire(site, engine=self, **ctx)

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
        self._sub, row = self.servable.prefill_row(
            self._sub, self._dev(toks), length)
        return bucket, row.float().cpu().numpy()    # once per admission

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
            self._fire(chaos_mod.SITE_ALLOC, request=req)
            slot = self._free.pop(0)
            seq = self._seq(req)
            length = int(seq.size)
            self._fire(chaos_mod.SITE_PREFILL, request=req)
            if self._audio:
                frames = torch.as_tensor(req.frames, device=self.device)
                self._sub = self.servable.init_cache(
                    1, self.cache_len,
                    frames=frames[None] if frames.dim() == 2 else frames)
            bucket, row = self._prefill_sub(seq)
            self.cache = self.servable.engine_write_slot(
                self.cache, slot, self._sub, batch=self.max_slots)
        except Exception as e:  # noqa: BLE001 -- isolate to this request
            return self._admission_failed(req, slot, [], t0, e)
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
            self.cache = self.servable.engine_free_slot(
                self.cache, slot, batch=self.max_slots)
            self._restore_slot(slot)
            self.stats.prefill_s += time.perf_counter() - t0
            self._finalize(req, "failed", FailureReason(
                FailureReason.NONFINITE_LOGITS,
                f"non-finite prefill logits at position {length - 1}"))
            return True
        self._activate(req, slot, length, pages)
        tok = sample_token_row(row, self._key, slot, length - 1,
                               temperature=self.temperature,
                               top_k=self.top_k)
        self.stats.prefill_s += time.perf_counter() - t0
        self._emit(req, int(tok), row)
        return True

    def _admission_failed(self, req: EngineRequest, slot: Optional[int],
                          held: List[int], t0: float, err: Exception) -> bool:
        """Undo an admission that raised -- release the pages it held,
        return its slot -- and settle the request (the ``_admit``
        contract): page-pool exhaustion parks it at the queue front while
        active requests can still free pages (False); any other error, or
        exhaustion with nothing to drain, fails only this request
        (True)."""
        if held:
            self._pool.release(held)
        self._restore_slot(slot)
        self.stats.prefill_s += time.perf_counter() - t0
        if isinstance(err, PagePoolExhausted):
            if self._active:
                req.status = "queued"
                self._queue.appendleft(req)
                log.info("parking request %d on page pressure (%s)",
                         req.req_id, err)
                return False
            self._finalize(req, "failed", FailureReason(
                FailureReason.KV_PAGES,
                f"{err} with no active requests to drain"))
            return True
        log.warning("admission of request %d failed (%s: %s)",
                    req.req_id, type(err).__name__, err)
        self._finalize(req, "failed", FailureReason(
            FailureReason.PREFILL_ERROR, f"{type(err).__name__}: {err}"))
        return True

    def _resume_retained(self, req: EngineRequest, slot: int, saved: tuple,
                         t0: float) -> None:
        """Preempt-resume by page retention: re-attach the victim's pages
        and positions to ``slot``; it decodes on with no prefill."""
        pages, resume_len = saved
        self.cache = self.servable.engine_restore_paged(
            self.cache, slot, self._page_row(pages), resume_len)
        self._activate(req, slot, resume_len, pages)
        req.prefill_pos = req.prefill_target = 0
        self._tokens[slot, 0] = req.tokens[-1]
        self._pos[slot] = resume_len
        self._remaining[slot] = req.max_new_tokens - req.n_generated
        self.stats.page_resumes += 1
        self.stats.prefill_s += time.perf_counter() - t0

    def _page_row(self, pages: List[int]) -> np.ndarray:
        """A slot's page-table row: ``pages`` padded with -1 (unmapped)."""
        row = np.full((self._table_width,), -1, np.int32)
        row[:len(pages)] = pages
        return row

    def _reserve_pages(self, n: int) -> List[int]:
        """Claim ``n`` fresh pages, evicting LRU prefix-cache references
        when the free list runs short. Raises PagePoolExhausted when
        eviction cannot cover the request."""
        self._fire(chaos_mod.SITE_PAGE_ALLOC, want=n)
        while self._pool.free_count < n and self._prefix_cache.evict(1):
            pass
        return self._pool.alloc(n)

    def _claim_pages(self, req: EngineRequest, seq: np.ndarray,
                     held: List[int]):
        """The page reservation of a paged admission: the longest cached
        prefix of ``seq`` as shared pages (capped at ``len(seq) - 1`` so a
        fully cached prompt still prefills >= 1 token), then fresh pages up
        to ceil((len + max_new) / page_size). Every page it takes a
        reference on is appended to ``held`` as it is taken, so a failure
        midway releases exactly those. Returns (pages, start): the page
        row and the first position to prefill."""
        need = pages_needed(min(seq.size + req.max_new_tokens,
                                self.cache_len), self.kv_page_size)
        shared: List[int] = []
        if self._can_share and not req.tokens:
            shared = self._prefix_cache.match(seq, limit=int(seq.size) - 1)
            held.extend(shared)
        fresh = self._reserve_pages(need - len(shared))
        held.extend(fresh)
        return shared + fresh, len(shared) * self.kv_page_size

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
            self._fire(chaos_mod.SITE_ALLOC, request=req)
            slot = self._free.pop(0)
            saved = self._saved_pages.pop(req.req_id, None)
            if saved is not None:
                held = saved[0]
                self._resume_retained(req, slot, saved, t0)
                return True

            seq = self._seq(req)
            length = int(seq.size)
            pages, start = self._claim_pages(req, seq, held)

            self._fire(chaos_mod.SITE_PREFILL, request=req)
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
                self.cache, row = self.servable.suffix_prefill_row(
                    self.cache, self._dev(toks), slot, start, slen,
                    self.max_slots)
                row = row.float().cpu().numpy()
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
        except Exception as e:  # noqa: BLE001 -- isolate to this request
            return self._admission_failed(req, slot, held, t0, e)
        return self._after_prefill(req, slot, length, bucket, row, t0,
                                   pages=pages, held=held)

    # -- chunked prefill (the SLO scheduler) ------------------------------
    def _begin_chunked(self, req: EngineRequest) -> bool:
        """Claim a slot (and, paged, the request's full page reservation +
        prefix match) without running prefill compute -- chunk dispatch is
        metered by the token budget (``_prefill_chunk``). The request
        becomes active with ``_pos[slot]`` still -1: it holds its slot
        across windows as a device no-op row until the final chunk samples
        its first token. Returns False when paged backpressure parked it at
        the queue front (the ``_admit`` contract)."""
        t0 = time.perf_counter()
        slot = None
        held: List[int] = []
        try:
            self._fire(chaos_mod.SITE_ALLOC, request=req)
            slot = self._free.pop(0)
            saved = self._saved_pages.pop(req.req_id, None) \
                if self.kv_layout == "paged" else None
            if saved is not None:
                held = saved[0]
                self._resume_retained(req, slot, saved, t0)
                return True

            seq = self._seq(req)
            length = int(seq.size)
            start = 0
            pages = None
            if self.kv_layout == "paged":
                pages, start = self._claim_pages(req, seq, held)
                # install the page table up front: every chunk scatters
                # through it, and the pos map starts at the shared prefix
                self.cache = self.servable.engine_restore_paged(
                    self.cache, slot, self._page_row(pages), start)
                if start > 0:
                    self.stats.prefix_hit_tokens += start
                elif self._can_share and not req.tokens:
                    self._pending_publish.add(req.req_id)
        except Exception as e:  # noqa: BLE001 -- isolate to this request
            return self._admission_failed(req, slot, held, t0, e)

        self._activate(req, slot, length, pages)
        req.prefill_pos = start
        req.prefill_target = length
        self.stats.prefill_s += time.perf_counter() - t0
        return True

    def _prefill_chunk(self, req: EngineRequest, budget: int) -> int:
        """Run prefill chunks for an admitted, partially prefilled request
        until its prompt is resident or ``budget`` tokens are spent; returns
        the tokens dispatched. Chunks are ``_chunk_len`` tokens or the
        prompt tail, bucketed like one-shot prefills. The final chunk
        samples the first token (the request decodes next window). A
        failure fails only this request. The watchdog is armed before the
        ``engine.prefill_chunk`` site fires, so a straggling chunk trips its
        'prefill-chunk' label; an injected fault still comes before the
        chunk writes the cache."""
        if budget <= 0 or req.prefill_pos >= req.prefill_target:
            return 0
        seq = self._seq(req)
        used = 0
        t0 = time.perf_counter()
        try:
            while req.prefill_pos < req.prefill_target:
                start = req.prefill_pos
                c = min(self._chunk_len, req.prefill_target - start)
                if c > budget - used:
                    break               # whole-chunk budget gating: defer
                bucket = self._bucket(c)
                toks = np.zeros((bucket,), np.int32)
                toks[:c] = seq[start:start + c]
                if self._watchdog is not None:
                    self._watchdog.arm("prefill-chunk")
                try:
                    self._fire(chaos_mod.SITE_PREFILL_CHUNK, request=req,
                               start=start, size=c)
                    self.cache, row = self.servable.suffix_prefill_row(
                        self.cache, self._dev(toks), req.slot, start, c,
                        self.max_slots)
                finally:
                    if self._watchdog is not None:
                        self._watchdog.disarm()
                        self.stats.watchdog_stalls = \
                            len(self._watchdog.stalls)
                req.prefill_pos += c
                used += c
                self.stats.prefilled_tokens += c
                self.stats.prefill_chunks += 1
                self.stats.bucket_hits[bucket] += 1
            if req.prefill_pos < req.prefill_target:
                return used                 # budget spent mid-prompt
            row = row.float().cpu().numpy()
        except Exception as e:  # noqa: BLE001 -- isolate to this request
            log.warning("chunked prefill of request %d failed (%s: %s)",
                        req.req_id, type(e).__name__, e)
            self._finalize(req, "failed", FailureReason(
                FailureReason.PREFILL_ERROR, f"{type(e).__name__}: {e}"))
            return used
        finally:
            self.stats.prefill_s += time.perf_counter() - t0

        self.stats.prefills += 1
        if not np.all(np.isfinite(row)):
            self._finalize(req, "failed", FailureReason(
                FailureReason.NONFINITE_LOGITS,
                f"non-finite prefill logits at position "
                f"{req.prefill_target - 1}"))
            return used
        if req.req_id in self._pending_publish:
            self._pending_publish.discard(req.req_id)
            pages = self._slot_pages.get(req.slot, [])
            self._prefix_cache.insert(
                seq, pages[:req.prefill_target // self.kv_page_size])
        tok = sample_token_row(row, self._key, req.slot,
                               req.prefill_target - 1,
                               temperature=self.temperature,
                               top_k=self.top_k)
        self._emit(req, int(tok), row)
        return used

    def _admit_budgeted(self, req: EngineRequest, budget: int):
        """Admission for the chunked scheduler: prompts that fit in one
        chunk take the one-shot path (a slot write, the paged prefix match,
        no full-cache chunk attention); longer ones go through
        ``_admit_chunked``. Returns ``(consumed, tokens_used)``."""
        need = req.prompt.size + req.n_generated
        if need <= self._chunk_len:
            return self._admit(req), need
        return self._admit_chunked(req, budget)

    def _admit_chunked(self, req: EngineRequest, budget: int):
        """Claim slot + pages, then spend up to ``budget`` prefill tokens.
        Returns ``(consumed, tokens_used)``; ``consumed`` False = paged
        backpressure parked the request."""
        if not self._begin_chunked(req):
            return False, 0
        if req.status != "active":          # begin failed terminally
            return True, 0
        if req.prefill_pos >= req.prefill_target:   # page-retention resume
            return True, 0
        return True, self._prefill_chunk(req, budget)

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
        self.cache = self.servable.engine_free_slot(self.cache, slot,
                                                    batch=self.max_slots)
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
        self._pending_publish.discard(req.req_id)
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
        # a half-prefilled victim restarts its prefill from scratch on
        # re-admission: its slot state is gone (and it kept no pages)
        self._pending_publish.discard(req.req_id)
        req.prefill_pos = req.prefill_target = 0
        req.status = "queued"
        req.n_preempted += 1
        self.stats.preemptions += 1
        self._queue.appendleft(req)

    def _sweep_control(self) -> None:
        """The window-sync control sweep: apply pending cancellations,
        expire deadlines of queued and active requests, fast-fail queued
        requests whose projected completion rules their deadline out
        (``sched.fast_fail``, measured rates only) and shed overload."""
        now = time.monotonic()

        def expired(r):
            return r.deadline_at is not None and now > r.deadline_at

        fast = self.sched is not None and self.sched.fast_fail

        def doomed(r):
            if not fast or r.deadline_at is None:
                return False
            est = self._service_estimate_s(r)
            return est is not None and now + est > r.deadline_at

        for req in [r for r in self._queue
                    if r.cancel_requested or expired(r) or doomed(r)]:
            self._queue.remove(req)
            if req.cancel_requested:
                self._finalize(req, "cancelled", FailureReason(
                    FailureReason.CANCELLED, "cancelled while queued"))
            elif expired(req):
                self._finalize(req, "failed", FailureReason(
                    FailureReason.DEADLINE,
                    "deadline expired before admission"))
            else:
                self._finalize(req, "failed", FailureReason(
                    FailureReason.DEADLINE,
                    "projected completion exceeds deadline while queued "
                    "(fast-fail before consuming a prefill slot)"))
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
        self._shed_overload()

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
        -- stop admitting until the next sync point. Chunk-scheduling
        engines route through ``_schedule_chunked``."""
        if self._chunking:
            self._schedule_chunked()
            return
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

    def _schedule_chunked(self) -> None:
        """The token-budget scheduler: each window-sync point spends at most
        ``sched.token_budget`` prefill tokens in ``_chunk_len`` chunks, so
        one long prompt cannot head-of-line block the running decodes.
        ``decode_priority`` reserves ``n_decoding * sync_every`` of the
        budget for the decode window that follows; with nothing decoding
        the budget is at least 1 so prefill always progresses. Order:
        priority preemption, then admissions (at most half the budget while
        a resident prefill is pending, so residents are not starved), then
        resident prefills, oldest admission first."""
        sched = self.sched
        budget = sched.token_budget if sched.token_budget > 0 else (1 << 30)
        n_dec = sum(1 for s in self._active if self._pos[s] >= 0)
        if sched.decode_priority:
            budget -= n_dec * self.sync_every
        if n_dec == 0:
            budget = max(budget, 1)

        # 1. priority preemption first: a high-priority arrival must not
        # wait out a low-priority resident's chunked prefill; it claims its
        # slot even at budget 0 (its chunks then run in later windows)
        while self._queue and not self._free and self._active:
            best_p = max(r.priority for r in self._queue)
            victim = min(self._active.values(),
                         key=lambda r: (r.priority, -r.admit_seq))
            if best_p <= victim.priority:
                break
            self._preempt(victim)
            consumed, used = self._admit_budgeted(self._pop_next(), budget)
            budget -= used
            if not consumed:
                return

        # 2. admissions before resident continuations (a short arrival
        # starts and finishes its prefill from the same budget), capped at
        # half the budget while a continuation is pending
        pending = any(r.prefill_pos < r.prefill_target
                      for r in self._active.values())
        adm_budget = budget // 2 if pending else budget
        while adm_budget > 0 and self._free and self._queue:
            consumed, used = self._admit_budgeted(self._pop_next(),
                                                  adm_budget)
            adm_budget -= used
            budget -= used
            if not consumed:
                return

        # 3. continue partially prefilled residents, oldest admission first
        for req in sorted((r for r in self._active.values()
                           if r.prefill_pos < r.prefill_target),
                          key=lambda r: r.admit_seq):
            if budget <= 0:
                break
            budget -= self._prefill_chunk(req, budget)

    # -- stepping ---------------------------------------------------------
    def step(self) -> bool:
        """One window-sync cycle: control sweep (cancel / deadline /
        overload), schedule (chunk continuation + admit + preempt), then ONE
        batched decode window (up to ``sync_every`` fused steps) over the
        decoding slots -- a mid-prefill request holds its slot as a device
        no-op row (pos -1). Returns True while there is (or may be) work
        left."""
        self._sweep_control()
        self._schedule()
        decoding = sorted(s for s in self._active if self._pos[s] >= 0)
        if not decoding:
            return bool(self._active or self._queue)
        if self._watchdog is not None:
            self._watchdog.arm("decode-window")
        try:
            self._fire(chaos_mod.SITE_WINDOW)
            k = min(self.sync_every,
                    max(int(self._remaining[s]) for s in decoding))
            if k <= 1:
                self._step_single(decoding)
            else:
                self._step_fused(k, decoding)
            self._fire(chaos_mod.SITE_SYNC)
        except Exception as e:  # noqa: BLE001 -- keep the engine serving
            self._recover_window_failure(e)
        finally:
            if self._watchdog is not None:
                self._watchdog.disarm()
                self.stats.watchdog_stalls = len(self._watchdog.stalls)
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
            key=self._key, temperature=self.temperature, top_k=self.top_k)
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
            eos_id=self._dev(self._eos), key=self._key,
            temperature=self.temperature, top_k=self.top_k)
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
        """Stop the watchdog thread (idempotent; engines without one are
        no-ops)."""
        if self._watchdog is not None:
            self._watchdog.close()

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
        if self._mesh is not None:      # this rank's shard of the slots
            slot = self.servable.local_slot(slot, self.max_slots)
            if slot is None:
                return
        if self._audio:                 # every leaf: slot at axis 1
            for _, x in cache_leaves(self.cache):
                if x.is_floating_point():
                    x[:, slot].fill_(float("nan"))
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
            assert (self._pos[slot] >= 0 or req.n_generated > 0
                    or 0 <= req.prefill_pos < req.prefill_target), (
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
        """``EngineStats.as_dict()`` plus the ``'kv'`` section; the
        ``'quant'`` section when the servable carries quantized packs (pack
        bytes, compression against fp32, worst quantization error); and,
        with a watchdog, the ``'watchdog'`` section: its timeout and stall
        count, merged with the snapshot of queue / active / chunk state the
        last stall took (the reference adds the section only after a
        stall)."""
        d = self.stats.as_dict()
        d["kv"] = self.kv_stats()
        qs = self.servable.quant_stats()
        if qs:
            d["quant"] = qs
        if self._watchdog is not None:
            d["watchdog"] = {"timeout_s": self._watchdog.timeout_s,
                             "stalls": len(self._watchdog.stalls),
                             **(self._watchdog_snapshot or {})}
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
