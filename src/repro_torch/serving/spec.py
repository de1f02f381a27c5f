"""ServingSpec: one declarative description of the prune->export->plan->serve
co-design (docs/API.md). Counterpart of ``repro/serving/spec.py``, field for
field, so a spec saved by either package reads in the other.

The paper's thesis is that sparsity wins only materialize when the algorithm
side (pruning shape/recipe) and the execution side (BSR packing, plan
specialization) are chosen together. A ``ServingSpec`` is that joint choice
as data: :func:`repro_torch.serving.prepare_servable` consumes it and owns every
layout/fusion/reuse decision, the way a production sparse-serving compiler
owns them behind a single entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.sparsity import SparsityConfig

#: default prunable projections (attention + FC, the paper's BERT targets)
DEFAULT_TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                   "ffn/wi", "ffn/wo")

PRUNE_RECIPES = ("none", "oneshot", "tied")
BACKENDS = ("plan", "plan_pallas", "bsr", "dense", "auto")
#: attention decode-step kernel: 'xla' (materialized softmax), 'flash'
#: (split-K online-softmax Pallas kernel, kernels/flash_decode.py), or
#: 'auto' (choose_decode_kernel measures/stubs per shape+device; the
#: REPRO_DECODE_KERNEL env var overrides all of these at trace time).
DECODE_KERNELS = ("auto", "xla", "flash")
PARTITIONS = ("tp", "dp", "tp+dp")
#: admission-queue backpressure policies (ServingEngine(overflow=...),
#: docs/API.md §Engine robustness). With a bounded queue (max_queue):
#:   'reject'     -- the NEW submission is shed (structured FailureReason,
#:                   never enqueued) -- the load-balancer-friendly default;
#:   'shed-oldest'-- the oldest queued request is shed to make room (fresh
#:                   traffic beats stale traffic whose client likely gave
#:                   up);
#:   'block'      -- submit() drives engine steps until the queue drains
#:                   below the bound (single-process ingest throttling).
OVERFLOW_POLICIES = ("reject", "shed-oldest", "block")
#: KV-cache layouts (docs/API.md §Paged KV + prefix cache):
#:   'dense' -- per-slot (max_slots, max_seq, ...) slot caches, the parity
#:              oracle; 'paged' -- page-pool storage for linear attention/MLA
#:              KV with per-slot page tables, a host-side refcounting
#:              allocator and a radix prefix cache (serving/paging.py,
#:              serving/prefix_cache.py).
KV_LAYOUTS = ("dense", "paged")
#: pack-sharding mesh support: the plan path shards by construction
#: (ShardedPlan), dense serves through GSPMD param sharding, and 'auto'
#: chooses between exactly those two; 'bsr' has no sharded layout.
SHARDED_BACKENDS = ("plan", "dense", "auto")
#: pack-value quantization (docs/API.md §Quantized sparse packs):
#:   'none' -- fp32/bf16 values, the parity oracle;
#:   'int8' -- symmetric int8 with one fp32 scale per BSR block (per
#:             row group for skinny tiles), dequant fused into the plan
#:             matmul accumulation;
#:   'fp8'  -- float8_e4m3fn values, same scale layout (requires a jax
#:             with float8 dtypes; raises a clear error otherwise).
#: Only plan-layout packs quantize ('plan' / 'plan_pallas' / the plan
#: verdicts of 'auto'); bsr/dense/masked packs serve full precision.
PACK_QUANTS = ("none", "int8", "fp8")
#: backends whose packs carry quantized values when pack_quant != 'none'
QUANTIZABLE_BACKENDS = ("plan", "plan_pallas", "auto")


@dataclasses.dataclass(frozen=True)
class SchedSpec:
    """SLO-aware scheduler knobs for the serving engine (docs/API.md §SLO
    scheduling). A default-constructed ``SchedSpec()`` (all knobs off) is
    behaviorally identical to an engine without one.

    Attributes:
      max_chunk: > 0 enables **chunked prefill**: prompts prefill in slices
        of at most ``max_chunk`` tokens, one slice per window-sync point,
        interleaved with running decodes -- a long prompt no longer
        head-of-line blocks the decode batch. 0 = one-shot prefill (the
        legacy path). Chunking silently falls back to one-shot for configs
        it cannot serve exactly (MoE FFN capacity routing, int8 KV
        quantization, the audio family).
      token_budget: > 0 caps the tokens each window-sync point may spend
        across prefill chunks + new admissions (decode tokens are reserved
        first under ``decode_priority``). 0 = unlimited (admit-everything,
        the legacy behavior). Only meaningful with ``max_chunk`` > 0.
      decode_priority: reserve ``n_decoding * sync_every`` tokens of the
        budget for the running decodes before spending any of it on
        prefill work, so prefill pressure cannot starve token streaming.
      fast_fail: arm the admission-time deadline estimator: a queued
        request whose deadline provably cannot be met at the engine's
        *measured* prefill/decode rates (EngineStats) fails with
        ``FailureReason.DEADLINE`` before consuming a prefill slot.
        Already-expired deadlines fast-fail regardless of this knob.
      max_queue_delay_s: > 0 arms SLO-aware overload shedding: when the
        estimated backlog drain time exceeds this bound, queued requests
        are shed lowest-priority-first (newest-first within a class) with
        ``FailureReason.OVERLOAD`` until the backlog fits. 0 = never shed
        on load (the bounded-queue ``overflow`` policies still apply).
    """

    max_chunk: int = 0
    token_budget: int = 0
    decode_priority: bool = True
    fast_fail: bool = False
    max_queue_delay_s: float = 0.0

    def __post_init__(self):
        if self.max_chunk < 0:
            raise ValueError(f"max_chunk={self.max_chunk} must be >= 0")
        if self.token_budget < 0:
            raise ValueError(
                f"token_budget={self.token_budget} must be >= 0")
        if self.max_queue_delay_s < 0:
            raise ValueError(
                f"max_queue_delay_s={self.max_queue_delay_s} must be >= 0")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SchedSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """Declarative spec for :func:`repro_torch.serving.prepare_servable`.

    Attributes:
      tile: kernel tile == pruning block shape. Small *sparsity* blocks from
        training are aggregated into this tile at export (docs/PERF.md).
      sparsity: block-sparsity target for the prune step (ignored when
        ``prune='none'``).
      prune: weight-preparation recipe --
        ``'none'``    params are already pruned (e.g. by training);
        ``'oneshot'`` independent per-layer magnitude masks
        (:func:`repro_torch.core.pruner.oneshot_prune`);
        ``'tied'``    one mask shared across layers per projection group
        (:func:`repro_torch.core.pruner.tied_prune`) -- keeps the cross-layer
        union tight, emulating small-block regularized training.
      targets: substrings selecting prunable projections.
      fuse_qkv: concatenate wq/wk/wv into one pack -> one block-sparse
        dispatch per attention layer.
      cross_layer_union: union the per-layer patterns of unrolled encoders so
        all layers share ONE specialization (scan-stacked LM groups always
        union). The paper's §2.2 task-buffer collapse.
      backend: ``'plan'`` stores weights row-grouped offline and serves
        through the precomputed-RowPackPlan path (the serving optimum);
        ``'plan_pallas'`` stores the same row-grouped layout but pins every
        pack to the plan-consuming kernel (K1, ``kernels/csrc/plan_dds.cu``
        on the card; its plain version on the CPU); ``'bsr'`` keeps packed ``(nnzt, bn, bk)`` values and
        dispatches via
        ``bsr_linear``'s runtime backends (rowpack on CPU, pallas on TPU);
        ``'dense'`` skips BSR export entirely -- the (possibly pruned)
        weights serve through plain dense matmuls, the paper's negative
        control and the benchmark baseline; ``'auto'`` micro-benchmarks
        {dense, gather, rowpack, plan, pallas, masked} per pattern
        fingerprint on the current device (``kernels/autotune.py``) and
        pins each projection group to the measured winner -- winners are
        persisted on disk and reused across processes, and ``stats()``
        reports the chosen backend per layer group.
      autotune_m: batch-rows the ``'auto'`` micro-benchmark measures at
        (part of the winner-cache key; other backends ignore it).
      dtype: optional dtype override ('float32' | 'bfloat16') applied to the
        exported packed values; None keeps the model dtype.
      include_ffn: export FFN projections too. For bert this is
        unconditional; lm-family exports pack a dense-MLP projection only
        when it is actually block-sparse at the kernel tile (packing an
        unpruned projection is pure loss), so attention-only prune recipes
        keep serving their FFN dense.
      mesh_shape: optional ``(data, model)`` device-mesh shape. When set,
        the whole serving path becomes mesh-first: export shards every
        plan pack by output block rows (column-parallel) / input block
        cols (row-parallel wo) over the "model" axis, params and packs are
        placed with NamedSharding at load, engine caches shard batch over
        "data" and heads over "model", and ``stats()`` reports per-shard
        accounting (docs/API.md §Sharded serving). The product must not
        exceed ``jax.device_count()``.
      partition: which parallelism the mesh expresses -- ``'tp'`` (model
        axis only: tensor-parallel packs + caches), ``'dp'`` (data axis
        only: request slots sharded over devices), ``'tp+dp'`` (both).
        Must be consistent with ``mesh_shape`` (a 'tp' mesh needs
        data == 1, etc.). Ignored when ``mesh_shape`` is None.
      kv_layout: ``'dense'`` (per-slot slot caches, the parity oracle) or
        ``'paged'`` (page-pool KV with per-slot page tables, refcounting
        allocator and radix prefix sharing -- docs/API.md §Paged KV).
        Requires ``data_shards == 1``.
      kv_page_size: tokens per physical KV page (paged layout only). Also
        the prefix-sharing granularity: only whole pages are shared, so
        smaller pages share more but gather/scatter more page rows.
      decode_kernel: attention decode-step kernel. ``'xla'`` is the
        materialized-softmax reference, ``'flash'`` the split-K
        online-softmax Pallas kernel (paged caches gather KV pages in
        place -- no dense-view reassembly), ``'auto'`` asks
        ``kernels.autotune.choose_decode_kernel`` per shape+device. The
        ``REPRO_DECODE_KERNEL`` env var overrides any spec value.
      pack_quant: pack-value quantization (docs/API.md §Quantized sparse
        packs). ``'int8'`` stores plan-pack block values as symmetric int8
        with one fp32 scale per BSR block -- per row group when the tile
        is too skinny for a stable block scale -- and serves them through
        the dequant-fused plan matmul (the fp32 values never land in the
        params tree); ``'fp8'`` is the same layout with float8_e4m3fn
        values. Only plan-layout packs quantize: ``backend='plan'`` /
        ``'plan_pallas'`` quantize every pack, ``'auto'`` adds the
        ``plan_q8`` / ``plan_pallas_q8`` candidates so quantization only
        lands where the tuner scores it a win; bsr/dense/masked packs are
        unaffected. ``'none'`` (default) keeps full-precision packs.
      sched: optional :class:`SchedSpec` arming SLO-aware scheduling on
        engines built over this servable (chunked prefill, per-window token
        budget, deadline fast-fail, overload shedding -- docs/API.md §SLO
        scheduling). None (or a default ``SchedSpec()``) keeps the legacy
        admit-everything one-shot-prefill scheduler. The engine's ``sched=``
        kwarg overrides the spec value, mirroring ``kv_layout``.
    """

    tile: Tuple[int, int] = (128, 128)
    sparsity: float = 0.8
    prune: str = "tied"
    targets: Sequence[str] = DEFAULT_TARGETS
    fuse_qkv: bool = True
    cross_layer_union: bool = True
    backend: str = "plan"
    dtype: Optional[str] = None
    include_ffn: bool = True
    autotune_m: int = 256
    mesh_shape: Optional[Tuple[int, int]] = None
    partition: str = "tp"
    kv_layout: str = "dense"
    kv_page_size: int = 16
    decode_kernel: str = "auto"
    pack_quant: str = "none"
    sched: Optional[SchedSpec] = None

    def __post_init__(self):
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(
                f"kv_layout={self.kv_layout!r} not in {KV_LAYOUTS}")
        if self.kv_page_size < 1:
            raise ValueError(f"kv_page_size={self.kv_page_size} must be >= 1")
        if self.kv_layout == "paged" and self.data_shards > 1:
            raise ValueError(
                "kv_layout='paged' requires data_shards == 1: the page pool "
                "is a shared id space, so its page axis cannot shard over "
                "'data' (tensor-parallel 'tp' meshes shard the head dims)")
        if self.prune not in PRUNE_RECIPES:
            raise ValueError(f"prune={self.prune!r} not in {PRUNE_RECIPES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r} not in {BACKENDS}")
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(
                f"decode_kernel={self.decode_kernel!r} not in {DECODE_KERNELS}")
        if self.dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.pack_quant not in PACK_QUANTS:
            raise ValueError(
                f"pack_quant={self.pack_quant!r} not in {PACK_QUANTS}")
        if (self.pack_quant != "none"
                and self.backend not in QUANTIZABLE_BACKENDS):
            raise ValueError(
                f"pack_quant={self.pack_quant!r} needs a plan-layout "
                f"backend (one of {QUANTIZABLE_BACKENDS}); "
                f"backend={self.backend!r} packs have no per-block scale "
                f"granularity to quantize at")
        if self.sched is not None and not isinstance(self.sched, SchedSpec):
            raise ValueError(
                f"sched must be a SchedSpec or None, got {self.sched!r}")
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"partition={self.partition!r} not in {PARTITIONS}")
        if self.mesh_shape is not None:
            d, m = (int(v) for v in self.mesh_shape)
            if d < 1 or m < 1:
                raise ValueError(f"bad mesh_shape {self.mesh_shape}")
            want = {"tp": m > 1 and d == 1, "dp": d > 1 and m == 1,
                    "tp+dp": d > 1 and m > 1}[self.partition]
            if (d * m > 1) and not want:
                raise ValueError(
                    f"partition={self.partition!r} inconsistent with "
                    f"mesh_shape={self.mesh_shape} (data={d}, model={m})")
            if m > 1 and self.backend not in SHARDED_BACKENDS:
                raise ValueError(
                    f"backend={self.backend!r} has no sharded pack layout; "
                    f"tensor-parallel serving needs one of "
                    f"{SHARDED_BACKENDS}")

    @property
    def use_plans(self) -> bool:
        return self.backend == "plan"

    @property
    def model_shards(self) -> int:
        """Size of the mesh "model" axis (1 = unsharded packs)."""
        return int(self.mesh_shape[1]) if self.mesh_shape is not None else 1

    @property
    def data_shards(self) -> int:
        return int(self.mesh_shape[0]) if self.mesh_shape is not None else 1

    def sparsity_config(self) -> SparsityConfig:
        """The prune step's config (kernel tile == pruning block here; a
        finer training-time block is aggregated at export by pack_bsr)."""
        return SparsityConfig(block_shape=tuple(self.tile),
                              sparsity=self.sparsity,
                              targets=tuple(self.targets))

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tile"] = list(self.tile)
        d["targets"] = list(self.targets)
        if self.mesh_shape is not None:
            d["mesh_shape"] = list(self.mesh_shape)
        # dataclasses.asdict already lowered the nested SchedSpec to a dict
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServingSpec":
        d = dict(d)
        d["tile"] = tuple(d["tile"])
        d["targets"] = tuple(d["targets"])
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        if d.get("sched") is not None:
            d["sched"] = SchedSpec.from_dict(d["sched"])
        return cls(**d)
