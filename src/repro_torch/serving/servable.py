"""prepare_servable / Servable / load_servable: the serving facade.

Counterpart of ``repro/serving/servable.py`` for the bert family, the LM
families (dense, vlm, moe, ssm, hybrid) and the audio family (every
backend: ``plan``, ``plan_pallas``, ``bsr``, ``dense`` and the measured
``auto``; quantized packs with ``pack_quant``; audio exports no packs and
serves dense).
One spec-driven entry point owns the pipeline the paper argues must be
co-designed:

    prune (core.pruner recipe)            -- algorithm side
    -> BSR export (serving.export)        -- layout
    -> RowPackPlan construction           -- execution schedule
    -> PatternRegistry caching            -- cross-layer reuse

``save`` / :func:`load_servable` use the reference's artifact layout, so a
servable saved by the JAX package loads here (and the other way round for
fp32, bf16, int8 and fp8 artifacts).

LM servables decode: :meth:`Servable.decode_step` / :meth:`decode_many`
and the continuous-batching :meth:`Servable.engine`. Where the reference
jits each engine function once per servable (with the cache donated), the
port runs them as plain methods (``engine_decode``, ``engine_prefill``,
...) that update the preallocated cache in place.

**Meshes** (``spec.mesh_shape = (data, model)``; every family). Where the
reference places params and caches with NamedSharding and lets GSPMD
partition the program, the port runs explicit SPMD: one process per mesh
position (``torch.distributed`` up with ``data * model`` ranks,
``launch.mesh.init_distributed``), each calling :func:`prepare_servable` or
:func:`load_servable` and then serving the same requests. A rank holds its
shard of every leaf (``serving_param_shardings``: ShardedPlan values split
on the vrow axis over "model", dense leaves by
``launch/sharding.spec_for_param`` in inference mode, the rest replicated)
and of every cache (slots over "data"; KV heads, MLA's latent rank, SSD
heads, conv channels or the RG-LRU width over "model"); every sharded
projection's output is made whole on every rank (``models.common.linear``)
unless the layer consumes only its block, an MLA layer all-reduces its
partial scores and outputs over its latent block (``models.mla``), a MoE
layer runs its own experts and all-gathers their outputs before the
combine (``models.moe``), an SSM layer runs its heads and its block of
conv channels (``models.ssm``), an RG-LRU layer its block of the width
(``models.rglru``), and the audio family's encoder, self- and
cross-attention their KV heads (``models.encdec``). Under "data" a rank
decodes its own slots and the emitted tokens are all-gathered, so every
rank's engine runs the same schedule; a MoE layer of such a decode step
gathers the step's rows over "data" and routes the whole batch, as one
device does (capacity and drops are the batch's). Prefills of the batch-1
sub-cache run replicated over "data", as the reference's replicated
sub-cache does; an audio request's frames go to every rank.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import LayerKind, ModelConfig, torch_dtype
from repro_torch.core.pattern_reuse import PatternRegistry
from repro_torch.core.pruner import oneshot_prune, tied_prune
from repro_torch.core.tree import at_path, flatten_with_path, \
    map_with_path, norm_path, path_name
from repro_torch.device import resolve_device
from repro_torch.kernels.exec_plan import QuantPlan, RowPackPlan, ShardedPlan
from repro_torch.kernels.flash_decode import decode_kernel_override
from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.launch.sharding import (local_shard, shard_index,
                                          spec_for_param)
from repro_torch.models import api as model_api
from repro_torch.models.common import (ChannelShard, DenseShard,
                                       ExpertShard, HeadShard, LatentShard,
                                       SSDHeadShard)
from repro_torch.models.sampling import sample_tokens
from repro_torch.serving.export import export_params
from repro_torch.serving.serialize import (LeafReader, ServableLoadError,
                                           build_like, config_from_dict,
                                           config_to_dict, packs_from_arrays,
                                           packs_to_arrays, pattern_key,
                                           tree_spec)
from repro_torch.serving.spec import ServingSpec

#: the single checkpoint slot a Servable occupies in its store directory
SERVABLE_STEP = 0
_PACKS_FILE = "packs.npz"


def _layer_scopes(cfg: ModelConfig):
    """[(pack scope, LayerKind)] of every layer kind's scope: bert's
    layers, the audio family's layer-stacked encoder and decoder, or an
    LM's prefix, period-stacked blocks and suffix."""
    if cfg.family == "bert":
        return [(f"layers/{i}", LayerKind("attn", "dense"))
                for i in range(cfg.n_layers)]
    if cfg.family == "audio":
        return [(s, LayerKind("attn", "dense"))
                for s in ("enc_layers", "dec_layers")]
    prefix, pattern, n_per, suffix = cfg.layer_plan()
    return ([(f"prefix/{i}", k) for i, k in enumerate(prefix)]
            + [(f"blocks/{i}", k) for i, k in enumerate(pattern)
               if n_per > 0]
            + [(f"suffix/{i}", k) for i, k in enumerate(suffix)])


# --------------------------------------------------------------------------
# mesh placement (spec.mesh_shape: the tensor/data-parallel serving path)
# --------------------------------------------------------------------------

def make_serving_mesh(spec):
    """The ``("data", "model")`` process mesh a spec asks for, over the
    initialised process group (``launch.mesh.init_process_mesh``); raises
    an actionable error unless the group is up with ``data * model``
    ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_mesh
    d, m = (int(v) for v in spec.mesh_shape)
    have = (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 0)
    if have != d * m:
        raise ValueError(
            f"spec.mesh_shape={tuple(spec.mesh_shape)} needs torch.distributed"
            f" up with {d * m} ranks (one process per mesh position) but "
            f"{'no process group is initialised' if not have else f'the process group has {have}'};"
            f" start {d * m} processes and call repro_torch.launch.mesh."
            f"init_distributed(backend, init_method, rank, world_size) in "
            f"each before prepare_servable / load_servable (or pass "
            f"place=False to prepare the sharded export on one process, "
            f"e.g. to save it)")
    return init_process_mesh((d, m), ("data", "model"))


def attach_mesh(packs, mesh):
    """Attach ``mesh`` to every ShardedPlan pack (the static metadata
    ``models.common.linear`` reads to run this rank's shard), including
    ShardedPlans wrapped in a QuantPlan. Identical patterns keep sharing
    one pack object."""
    import dataclasses
    out, seen = {}, {}
    for key, pk in packs.items():
        inner = pk.plan if isinstance(pk, QuantPlan) else pk
        if isinstance(inner, ShardedPlan) and inner.mesh is not mesh:
            if id(pk) not in seen:
                seen[id(pk)] = (dataclasses.replace(
                    pk, plan=inner.with_mesh(mesh))
                    if isinstance(pk, QuantPlan) else pk.with_mesh(mesh))
            pk = seen[id(pk)]
        out[key] = pk
    return out


def serving_param_shardings(params, packs, mesh):
    """The spec tree (``launch/sharding.py`` tuples) of a serving param
    tree: ShardedPlan-packed values ``(..., V, P, bn, bk)`` and their
    scales ``(..., V, P|1)`` shard the vrow axis over "model"; other packed
    values replicate (their pattern did not divide); every dense leaf
    follows ``spec_for_param`` in inference mode (TP only) where the
    explicit-SPMD code consumes the entry: the row or column dim of a
    linear weight (``.../w``, the embedding and head tables included),
    BERT's ``pos`` rows and the expert axis E of a routed-expert tensor.
    Every other entry replicates its dim: the period axis (of a stacked
    norm scale, or of a period-stacked dense FFN, which the rule's expert
    branch matches), biases, "data". ``params`` holds whole leaves (or
    anything with their ``shape``)."""
    packed = _packed_names(packs)
    return map_with_path(lambda path, leaf: _leaf_spec(
        norm_path(path_name(path)), tuple(leaf.shape), packed, mesh), params)


def _packed_names(packs) -> Dict[str, object]:
    """Param-leaf name -> its pack, for every packed value / scale leaf."""
    packed = {}
    for key, pk in packs.items():
        packed[key + "/w"] = pk
        if isinstance(pk, QuantPlan):
            packed[key + "/scale"] = pk
    return packed


def _routed_expert(name: str, ndim: int) -> bool:
    """A MoE layer's routed-expert tensor: a bare ``ffn/wi|wg|wo`` leaf
    (E, a, b) (period-stacked: a leading axis more). A shared expert's or
    a dense MLP's weight ends in ``/w``."""
    toks = name.split("/")
    return ndim >= 3 and len(toks) >= 2 and toks[-2] == "ffn" \
        and toks[-1] in ("wi", "wg", "wo")


def _leaf_spec(name: str, shape, packed, mesh) -> tuple:
    shape = tuple(shape)
    pk = packed.get(name)
    inner = pk.plan if isinstance(pk, QuantPlan) else pk
    if isinstance(inner, ShardedPlan):
        spec = [None] * len(shape)
        spec[len(shape) - (2 if name.endswith("/scale") else 4)] = "model"
        return tuple(spec)
    if pk is not None:
        return (None,) * len(shape)
    spec = spec_for_param(name, shape, mesh, mode="inference")
    if _routed_expert(name, len(shape)):
        keep = {len(shape) - 3}                 # E, over "model" (EP)
    elif name.endswith("/w"):
        keep = {len(shape) - 2, len(shape) - 1}     # a linear's rows / cols
    elif name == "pos":
        keep = {0}                              # BERT's position rows
    else:
        keep = set()
    return tuple(e if e == "model" and d in keep else None
                 for d, e in enumerate(spec))


def _divides(n: int, m: int) -> bool:
    """A dim of ``n`` shards over a "model" axis of ``m`` (the rule of
    ``launch/sharding.spec_for_cache``)."""
    return m > 1 and n % m == 0 and n >= m


def _mixer_shards(cfg: ModelConfig, scope: str, kind, mesh) -> dict:
    """The shard objects of a layer's mixer whose cache dims divide the
    "model" axis, as the mesh servable and the mesh Trainer
    (``launch.steps.MeshPlan``) both run them: a ``HeadShard`` for an
    attention layer's KV heads (``{scope}/attn/heads``; the audio
    decoder's cross-attention too, ``dec_layers/xattn/heads``), an
    ``SSDHeadShard`` for an SSM layer's heads (``{scope}/mixer/heads``)
    and a ``ChannelShard`` for its conv channels (``{scope}/mixer/conv``),
    a ``ChannelShard`` for an RG-LRU layer's width
    (``{scope}/mixer/width``)."""
    m = mesh.shape.get("model", 1)
    out = {}
    if kind.mixer in ("attn", "local"):
        if _divides(cfg.n_kv_heads, m):
            out[f"{scope}/attn/heads"] = HeadShard(mesh, cfg.n_kv_heads)
            if scope == "dec_layers":
                out[f"{scope}/xattn/heads"] = out[f"{scope}/attn/heads"]
    elif kind.mixer == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        n_heads = d_inner // cfg.ssm_head_dim
        if _divides(n_heads, m):
            out[f"{scope}/mixer/heads"] = SSDHeadShard(mesh, n_heads)
        if _divides(d_inner + 2 * cfg.ssm_state, m):
            out[f"{scope}/mixer/conv"] = ChannelShard(
                mesh, d_inner + 2 * cfg.ssm_state)
    elif kind.mixer == "rglru":
        width = cfg.rnn_width or cfg.d_model
        if _divides(width, m):
            out[f"{scope}/mixer/width"] = ChannelShard(mesh, width)
    return out


def _exec_packs(packs, params, specs, cfg: ModelConfig, mesh):
    """The packs a mesh servable runs with: ``packs`` (mesh attached) plus
    a ``DenseShard`` for every dense linear leaf sharded over "model"
    (under its projection's key, or 'embed' / 'lm_head' / 'pos') and, by
    each layer's kind, the shard object of each cache dim that divides the
    "model" axis: a ``HeadShard`` for an attention layer's KV heads
    (``{scope}/attn/heads``; the audio decoder's cross-attention too,
    ``dec_layers/xattn/heads``), a ``LatentShard`` for an MLA layer's
    latent rank (``{scope}/attn/latent``), an ``SSDHeadShard`` for an SSM
    layer's heads (``{scope}/mixer/heads``) and a ``ChannelShard`` for its
    conv channels (``{scope}/mixer/conv``), a ``ChannelShard`` for an
    RG-LRU layer's width (``{scope}/mixer/width``), and an
    ``ExpertShard`` for a MoE FFN (``{scope}/ffn/experts``) whose experts
    shard over "model" or whose decode rows shard over the dp axes
    ("data", and "pod" on the dry-run's multi-pod mesh)."""
    out = dict(packs)
    d, m = axis_size(mesh, dp_axes(mesh)), mesh.shape["model"]
    specs_by_name = {}
    for path, leaf in flatten_with_path(params):
        spec = at_path(specs, path)
        name = norm_path(path_name(path))
        specs_by_name[name] = spec
        if m == 1 or "model" not in spec \
                or name.rsplit("/", 1)[0] in packs \
                or _routed_expert(name, leaf.dim()):
            continue
        key = name[:-2] if name.endswith("/w") else name
        out[key] = DenseShard("out" if spec[-2] == "model" else "in", mesh)
    for scope, kind in _layer_scopes(cfg):
        out.update(_mixer_shards(cfg, scope, kind, mesh))
        if kind.mixer == "mla" and _divides(cfg.kv_lora_rank, m):
            out[f"{scope}/attn/latent"] = LatentShard(mesh, cfg.kv_lora_rank)
        if kind.ffn == "moe":
            sharded = "model" in specs_by_name[f"{scope}/ffn/wi"]
            if sharded or d > 1:
                out[f"{scope}/ffn/experts"] = ExpertShard(
                    mesh, cfg.n_experts, sharded)
    return out


def _decode_packs(packs):
    """``packs`` for a decode step whose rows shard over the dp axes: each
    ``ExpertShard`` gathers the step's rows before routing."""
    import dataclasses
    return {k: dataclasses.replace(v, gather_rows=True)
            if isinstance(v, ExpertShard) else v for k, v in packs.items()}


def _local_params(params, specs, mesh, copy: bool = True):
    """This rank's shard of every leaf of whole ``params``: a copy in
    storage of its own where the leaf is cut, or with ``copy=False`` a view
    of the whole leaf."""
    coord = {a: mesh.coord(a) for a in mesh.axis_names}

    def one(path, leaf):
        spec = at_path(specs, path)
        if all(e is None for e in spec):
            return leaf
        shard = local_shard(leaf, spec, mesh, coord)
        return shard.clone(memory_format=torch.contiguous_format) if copy \
            else shard
    return map_with_path(one, params)


def _cast_packed(params, packs, dtype):
    """Cast only the packed projection values to the spec dtype (embeddings,
    norms, heads keep the model dtype). Quantized packs are exempt: their
    int8/fp8 values and fp32 scales are the storage format -- casting
    either would dequantize silently or lose scale precision."""
    targets = {key + "/w" for key, pk in packs.items()
               if not isinstance(pk, QuantPlan)}

    def one(path, leaf):
        return leaf.to(dtype) if norm_path(path_name(path)) in targets \
            else leaf
    return map_with_path(one, params)


class PinnedChoice:
    """A backend chooser's verdict pinned, not measured: ``backend`` for
    every pack (``prepare_servable`` pins 'plan_pallas' this way)."""

    def __init__(self, backend: str):
        self.backend, self.cache_hit, self.mode = backend, False, "pinned"


def pinned_chooser(backend: str):
    """A ``backend_chooser`` for ``export_params`` that gives every pattern
    ``backend``."""
    def chooser(pack):
        return PinnedChoice(backend)
    return chooser


class Servable:
    """Handle over (packed params, static patterns, config, spec). Not
    constructed directly -- use :func:`prepare_servable` or
    :func:`load_servable`."""

    def __init__(self, params, cfg: ModelConfig, spec: ServingSpec,
                 packs: Dict[str, object], registry: PatternRegistry,
                 device, export_stats: Optional[Dict] = None,
                 stats_at_save: Optional[Dict] = None, mesh=None,
                 param_specs=None):
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.packs = packs
        self.registry = registry
        self.device = torch.device(device)
        self.export_stats = export_stats or {}
        self.stats_at_save = stats_at_save
        #: the ``launch.mesh.ProcessMesh`` this rank serves on (None: one
        #: device) and the spec of every leaf of ``params`` on it
        self.mesh = mesh
        self.param_specs = param_specs
        self._run_packs = packs if mesh is None else _exec_packs(
            packs, params, param_specs, cfg, mesh)
        #: the packs of a decode step whose rows shard over "data"
        self._row_packs = None if mesh is None else _decode_packs(
            self._run_packs)
        self._decode_kind: Optional[str] = None

    # -- serving ----------------------------------------------------------
    def _as_batch(self, batch) -> Dict[str, Any]:
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def forward(self, batch):
        """batch dict (``{'tokens': (B, S)}``; the vlm family also takes
        ``'mm_embeds'`` (B, P, d)) or raw tokens -> logits fp32 (on a mesh:
        every rank takes the whole batch and returns the whole logits,
        replicated over "data")."""
        with torch.inference_mode():
            logits, _aux = model_api.model_forward(
                self.params, self.cfg, self._as_batch(batch),
                packs=self._run_packs)
        return logits

    # -- mesh slots ---------------------------------------------------------
    def slot_range(self, batch: int) -> Tuple[int, int]:
        """The slots ``[lo, hi)`` of a ``batch``-slot cache this rank holds
        (all of them off a mesh, or when ``batch`` does not divide over
        the dp axes: the cache's batch dim then replicates)."""
        if self.mesh is None:
            return 0, batch
        dp = dp_axes(self.mesh)
        d = axis_size(self.mesh, dp)
        if d == 1 or batch % d or batch < d:
            return 0, batch
        w = batch // d
        c = self.mesh.coord(dp)
        return c * w, (c + 1) * w

    def local_slot(self, slot: int, batch: int) -> Optional[int]:
        """``slot``'s index in this rank's shard of a ``batch``-slot cache,
        None when another rank holds it."""
        lo, hi = self.slot_range(batch)
        return int(slot) - lo if lo <= int(slot) < hi else None

    def _step_packs(self, batch: int):
        """The packs of a decode step over ``batch`` slots: on a mesh whose
        "data" axis shards them, MoE layers gather the step's rows."""
        sharded = self.slot_range(batch) != (0, batch)
        return self._row_packs if sharded else self._run_packs

    def _rows(self, x, batch, lo, hi):
        x = self._tensor(x)
        return x if x.dim() == 0 or (lo, hi) == (0, batch) else x[lo:hi]

    def _gather_rows(self, x, batch, dim=0):
        lo, hi = self.slot_range(batch)
        if (lo, hi) == (0, batch):
            return x
        return self.mesh.all_gather(x, dp_axes(self.mesh), dim=dim)

    # -- decoding (LM families) -------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int, frames=None,
                   paged=None):
        """A zeroed decode cache for ``batch_size`` slots on the servable's
        device (``paged``: a ``models.common.PagedLayout``). The audio
        family encodes ``frames`` (B, T_audio, d) into the cache's cross
        K/V; its batch is the frames'. On a mesh, this rank's shard of it
        (``models.api.cache_shardings``)."""
        if frames is not None:
            frames = self._tensor(frames)
        with torch.no_grad():
            return model_api.init_cache(self.params, self.cfg, batch_size,
                                        cache_len, frames=frames,
                                        paged=paged, mesh=self.mesh,
                                        packs=self._run_packs)

    def decode_kernel_kind(self) -> str:
        """The attention decode kernel every decode call of this servable
        pins ('xla' | 'flash'), resolved once: a non-'auto'
        ``REPRO_DECODE_KERNEL`` env value wins, then a non-'auto'
        ``spec.decode_kernel``, then -- for 'auto' --
        :func:`~repro_torch.kernels.autotune.choose_decode_kernel` over this
        config's decode shape on the servable's device (measured between
        the plain composition and kernel K2 on the card, persisted like
        every autotune winner)."""
        if self._decode_kind is None:
            env = os.environ.get("REPRO_DECODE_KERNEL", "").strip()
            if env and env != "auto":
                self._decode_kind = env
            elif self.spec.decode_kernel != "auto":
                self._decode_kind = self.spec.decode_kernel
            elif not getattr(self.cfg, "n_kv_heads", 0):
                self._decode_kind = "xla"    # no decode attention to tune
            else:
                from repro_torch.kernels.autotune import choose_decode_kernel
                cfg = self.cfg
                kind = choose_decode_kernel(
                    b=8, t=512, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                    d=cfg.head_dim, device=self.device).backend
                if self.mesh is not None:
                    # one kernel on every rank: rank 0's measurement
                    kind = ("xla", "flash")[self._agree(
                        ("xla", "flash").index(kind))]
                self._decode_kind = kind
        return self._decode_kind

    def _agree(self, value: int) -> int:
        return _agree_on(self.mesh, value, self.device)

    def decode_step(self, cache, token, pos):
        """(cache, token (B,1), pos) -> (logits (B,1,V) fp32, cache); the
        new K/V rows are written into ``cache`` in place. ``pos`` is a
        scalar or a ragged int32 (B,) vector (-1 = inactive row). On a mesh
        whose "data" axis shards the slots, ``cache`` is this rank's shard,
        ``token`` / ``pos`` are every slot's, and the logits come back
        whole."""
        b = int(torch.as_tensor(token).shape[0])
        lo, hi = self.slot_range(b)
        with torch.no_grad(), decode_kernel_override(
                self.decode_kernel_kind()):
            logits, cache = model_api.decode_step(
                self.params, cache, self.cfg, self._rows(token, b, lo, hi),
                self._rows(pos, b, lo, hi), packs=self._step_packs(b))
        return self._gather_rows(logits, b), cache

    def decode_many(self, cache, token, pos, n_steps, *, remaining=None,
                    eos_id=None, key=None, temperature: float = 0.0,
                    top_k: int = 0):
        """K fused decode steps (``models.api.decode_many``): sampling
        (greedy, or ``temperature`` / ``top_k`` with the threefry ``key``,
        ``models/prng.py``) and per-slot EOS / budget masking on the device,
        one host sync when the caller reads the results. Returns ``(tokens
        (K, B), valid (K, B), state)``; the cache is updated in place. On a
        mesh whose "data" axis shards the slots, this rank decodes its own
        slots and every output but the cache is all-gathered over "data"
        once a window."""
        b = int(torch.as_tensor(token).shape[0])
        lo, hi = self.slot_range(b)

        def rows(x):
            return None if x is None else self._rows(x, b, lo, hi)
        with torch.no_grad(), decode_kernel_override(
                self.decode_kernel_kind()):
            toks, valid, state = model_api.decode_many(
                self.params, cache, self.cfg, rows(token), rows(pos),
                int(n_steps), packs=self._step_packs(b),
                remaining=rows(remaining), eos_id=rows(eos_id), key=key,
                temperature=temperature, top_k=top_k, slot_offset=lo)
        if (lo, hi) != (0, b):
            toks = self._gather_rows(toks, b, dim=1)
            valid = self._gather_rows(valid, b, dim=1)
            state = dict(state, **{k: self._gather_rows(state[k], b)
                                   for k in ("token", "pos", "remaining",
                                             "failed")})
        return toks, valid, state

    def engine(self, max_slots: int = 8, cache_len: int = 256, **kw):
        """A continuous-batching :class:`~repro_torch.serving.engine.
        ServingEngine` over this servable."""
        from repro_torch.serving.engine import ServingEngine
        return ServingEngine(self, max_slots=max_slots, cache_len=cache_len,
                             **kw)

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    # -- the engine's functions (cache updated in place) ------------------
    def engine_decode(self, cache, token, pos, *, key=None,
                      temperature: float = 0.0, top_k: int = 0):
        """One batched decode step with on-device sampling (``key``: a
        threefry key, folded by slot and position): returns ``(sampled (B,)
        int32, ok (B,) bool, logits (B,1,V), cache)``; ``ok`` False marks a
        slot whose logits row went non-finite."""
        pos = self._tensor(pos)
        logits, cache = self.decode_step(cache, token, pos)
        rows = logits[:, 0, :]
        ok = torch.isfinite(rows).all(dim=-1)
        nxt = sample_tokens(rows, key, pos, temperature=temperature,
                            top_k=top_k)
        return nxt, ok, logits, cache

    def engine_prefill(self, cache1, tokens, length):
        """Prompt prefill of a bucket-padded prompt (tokens (bucket,)) into
        the batch-1 cache ``cache1``. Returns ``(cache1, logits (bucket,
        V))``. The LM families run the one-pass forward prefill, which
        rewrites the whole cache. The audio family steps its decode path
        over the bucket (its decoder prompts are a few tokens), padding
        steps at pos -1 so they write nothing, as the reference's prefill
        scan does; ``cache1`` is then the request's fresh cache
        (``init_cache`` over its frames)."""
        toks = self._tensor(tokens)
        if self.cfg.family == "audio":
            rows = []
            for t in range(toks.shape[0]):
                p = t if t < int(length) else -1
                logits, cache1 = self.decode_step(
                    cache1, toks[t:t + 1, None],
                    torch.tensor([p], dtype=torch.int32, device=self.device))
                rows.append(logits[0, 0])
            return cache1, torch.stack(rows)
        with torch.no_grad():
            logits, cache1 = model_api.prefill_cache(
                self.params, cache1, self.cfg, toks[None], int(length),
                packs=self._run_packs)
        return cache1, logits[0]

    def suffix_prefill(self, cache, tokens, slot, start, length):
        """Prefill tokens (S,) of slot ``slot``'s prompt from position
        ``start`` against what the slot already holds: the uncached suffix
        after a shared prefix (paged), or the next chunk of a chunked
        prefill (dense or paged). Returns ``(cache, logits (S, V))``."""
        with torch.no_grad():
            logits, cache = model_api.prefill_suffix(
                self.params, cache, self.cfg, self._tensor(tokens)[None],
                int(slot), int(start), int(length), packs=self._run_packs)
        return cache, logits[0]

    def prefill_row(self, cache1, tokens, length):
        """:meth:`engine_prefill` returning only the logits row the engine
        samples from, position ``length - 1`` (V,) fp32. On a mesh the
        prefill computes that row's logits alone and every rank takes the
        row of "data" index 0 (the batch-1 sub-cache prefill runs
        replicated over "data")."""
        if self.mesh is None or self.cfg.family == "audio":
            cache1, logits = self.engine_prefill(cache1, tokens, length)
            return cache1, logits[int(length) - 1]
        with torch.no_grad():
            logits, cache1 = model_api.prefill_cache(
                self.params, cache1, self.cfg, self._tensor(tokens)[None],
                int(length), packs=self._run_packs, last_only=True)
        return cache1, self.mesh.broadcast(logits[0, 0],
                                           dp_axes(self.mesh), 0)

    def suffix_prefill_row(self, cache, tokens, slot, start, length,
                           batch: int):
        """:meth:`suffix_prefill` returning only the logits row of position
        ``length - 1`` of the chunk. ``batch`` is the engine's slot count:
        on a mesh whose "data" axis shards the slots, the rank holding
        ``slot`` prefills it and sends the row to the others."""
        local = self.local_slot(slot, batch)
        if self.mesh is None:
            cache, logits = self.suffix_prefill(cache, tokens, slot, start,
                                                length)
            return cache, logits[int(length) - 1]
        row = torch.zeros((self.cfg.vocab_size,), dtype=torch.float32,
                          device=self.device)
        if local is not None:
            with torch.no_grad():
                logits, cache = model_api.prefill_suffix(
                    self.params, cache, self.cfg,
                    self._tensor(tokens)[None], local, int(start),
                    int(length), packs=self._run_packs, last_only=True)
            row = logits[0, 0]
        dp = dp_axes(self.mesh)
        owner = (int(slot) // (batch // axis_size(self.mesh, dp))
                 if self.slot_range(batch) != (0, batch) else 0)
        return cache, self.mesh.broadcast(row, dp, owner)

    def engine_write_slot(self, cache, slot, sub, batch=None):
        """Copy the batch-1 prefill cache ``sub`` into ``slot``, in place.
        On a mesh whose "data" axis shards the slots (``batch``: the
        engine's slot count), only the rank holding ``slot`` writes."""
        local = self._engine_slot(slot, batch)
        if local is None:
            return cache
        return model_api.write_slot(cache, self.cfg, local, sub)

    def engine_free_slot(self, cache, slot, batch=None):
        """Empty ``slot`` in place (recycle hygiene; ``batch`` as in
        :meth:`engine_write_slot`)."""
        local = self._engine_slot(slot, batch)
        if local is None:
            return cache
        return model_api.free_slot(cache, self.cfg, local)

    def _engine_slot(self, slot, batch):
        if self.mesh is None or axis_size(self.mesh,
                                          dp_axes(self.mesh)) == 1:
            return int(slot)
        if batch is None:
            raise ValueError("a slot op on a data-sharded mesh needs the "
                             "engine's slot count (batch=)")
        return self.local_slot(slot, batch)

    def engine_write_paged(self, cache, slot, sub, page_row):
        """Write ``sub`` into the pages of ``page_row`` and map them to
        ``slot``, in place."""
        return model_api.write_slot_paged(cache, self.cfg, slot, sub,
                                          self._tensor(page_row))

    def engine_restore_paged(self, cache, slot, page_row, resume_len):
        """Map ``page_row`` to ``slot`` with positions 0..resume_len-1 live
        (retained pages, or a shared prefix), in place."""
        return model_api.restore_slot_paged(cache, self.cfg, slot,
                                            self._tensor(page_row),
                                            int(resume_len))

    # -- instrumentation --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The co-design scorecard: how sparse, how shared, how padded."""
        # bare and quantized plans, as the reference counts them (PlanChoice
        # packs report no padded-FLOP ratio there either)
        plans = [p.plan if isinstance(p, QuantPlan) else p
                 for p in self.packs.values()
                 if isinstance(p, (RowPackPlan, QuantPlan))]
        unique = {pattern_key(p) for p in self.packs.values()}
        union = [s["union_overhead"] for s in self.export_stats.values()
                 if isinstance(s, dict) and "union_overhead" in s]
        st = self.registry.stats
        out = {
            "family": self.cfg.family,
            "arch": self.cfg.arch,
            "backend": self.spec.backend,
            "tile": list(self.spec.tile),
            "packed_projections": len(self.packs),
            "unique_patterns": len(unique),
            "density": (float(np.mean([p.density
                                       for p in self.packs.values()]))
                        if self.packs else None),
            "union_overhead": float(np.mean(union)) if union else None,
            "padded_flop_ratio": (float(np.mean([p.padding_waste
                                                 for p in plans]))
                                  if plans else None),
            "registry": {"hits": st.hits, "misses": st.misses,
                         "reuse_rate": st.reuse_rate},
        }
        auto = {k: s["autotune"] for k, s in self.export_stats.items()
                if isinstance(s, dict) and "autotune" in s}
        if auto:
            out["autotune"] = {
                "backends": {k: a["backend"] for k, a in auto.items()},
                "cache_hits": sum(1 for a in auto.values()
                                  if a.get("cache_hit")),
                "cache_misses": sum(1 for a in auto.values()
                                    if not a.get("cache_hit")),
                "mode": next(iter(auto.values())).get("mode"),
            }
        qs = self.quant_stats()
        if qs:
            out["quant"] = qs
        if self.mesh is not None or self.spec.mesh_shape is not None:
            out["sharding"] = self._sharding_stats()
        if self.stats_at_save is not None:
            out["registry_at_save"] = self.stats_at_save.get("registry")
        return out

    def _leaves(self, names):
        """[(numel of the whole leaf, numel on this device, element size)]
        of the named leaves: a mesh servable holds its shard of each."""
        out = []
        for path, leaf in flatten_with_path(self.params):
            if norm_path(path_name(path)) not in names:
                continue
            n = leaf.numel()
            whole = n
            if self.mesh is not None:
                for entry in at_path(self.param_specs, path):
                    whole *= shard_index(entry, self.mesh, {})[1]
            out.append((whole, n, leaf.element_size()))
        return out

    def pack_bytes(self) -> Tuple[int, int]:
        """(total, per-device) bytes of the packed projection values in the
        params tree (equal off a mesh; a servable prepared with
        ``place=False`` counts fully on its one device). Quantized packs
        count their scales too."""
        targets = {key + "/w" for key in self.packs}
        targets |= {key + "/scale" for key, pk in self.packs.items()
                    if isinstance(pk, QuantPlan)}
        leaves = self._leaves(targets)
        return (sum(w * e for w, _, e in leaves),
                sum(n * e for _, n, e in leaves))

    def _sharding_stats(self) -> Dict[str, Any]:
        """Per-shard accounting of the mesh path: how the pack bytes split
        across devices, which packs sharded, and the per-shard registry
        hit / miss counts collected at export."""
        total, per_dev = self.pack_bytes()
        sharded = {k: (p.plan if isinstance(p, QuantPlan) else p)
                   for k, p in self.packs.items()
                   if isinstance(p.plan if isinstance(p, QuantPlan) else p,
                                 ShardedPlan)}
        shard_meta = self.export_stats.get("__sharding__") or {}
        out = {
            "mesh_shape": (list(self.spec.mesh_shape)
                           if self.spec.mesh_shape else None),
            "partition": self.spec.partition,
            "n_shards": self.spec.model_shards,
            "sharded_packs": len(sharded),
            "replicated_packs": len(self.packs) - len(sharded),
            "pack_bytes_total": total,
            "pack_bytes_per_device": per_dev,
            "per_shard_registry": {
                str(s): dict(v)
                for s, v in (shard_meta.get("per_shard") or {}).items()},
            "axes": {k: p.shard_axis for k, p in sharded.items()},
        }
        if sharded:
            out["unique_sharded_patterns"] = len(
                {p.fingerprint for p in sharded.values()})
        return out

    def quant_stats(self) -> Optional[Dict[str, Any]]:
        """Quantized-pack accounting: bytes stored (qvalues + scales) against
        the fp32-equivalent bytes of the same packs, and the worst
        export-time round-trip error. None when nothing is quantized."""
        qpacks = {k: p for k, p in self.packs.items()
                  if isinstance(p, QuantPlan)}
        if not qpacks:
            return None
        w = self._leaves({k + "/w" for k in qpacks})
        sc = self._leaves({k + "/scale" for k in qpacks})
        wbytes = sum(n * e for n, _, e in w)
        sbytes = sum(n * e for n, _, e in sc)
        fp32 = sum(n * 4 for n, _, _ in w)
        qbytes = wbytes + sbytes
        qdev = sum(n * e for _, n, e in w) + sum(n * e for _, n, e in sc)
        fp32_dev = sum(n * 4 for _, n, _ in w)
        errs = [s["quant"] for s in self.export_stats.values()
                if isinstance(s, dict) and "quant" in s]
        out = {
            "pack_quant": self.spec.pack_quant,
            "quantized_packs": len(qpacks),
            "total_packs": len(self.packs),
            "qdtype": next(iter(qpacks.values())).qdtype,
            "granularities": sorted({p.granularity
                                     for p in qpacks.values()}),
            "quant_bytes_total": qbytes,
            "quant_bytes_per_device": qdev,
            "scale_bytes_total": sbytes,
            "fp32_equiv_bytes_total": fp32,
            "fp32_equiv_bytes_per_device": fp32_dev,
            "compression_ratio": fp32 / qbytes if qbytes else None,
        }
        if errs:
            out["max_abs_err"] = max(e["max_abs_err"] for e in errs)
            out["max_rel_err"] = max(e["rel_err"] for e in errs)
        return out

    # -- persistence ------------------------------------------------------
    def whole_params(self):
        """The whole param tree: ``params`` itself off a mesh; on one, every
        leaf all-gathered over "model" along its sharded dims (collective:
        every rank of the mesh calls it)."""
        if self.mesh is None:
            return self.params

        def one(path, leaf):
            for d, entry in enumerate(at_path(self.param_specs, path)):
                if entry is not None:
                    leaf = self.mesh.all_gather(leaf, entry, dim=d)
            return leaf
        return map_with_path(one, self.params)

    def save(self, path: str) -> str:
        """Persist params + static patterns + spec/config under ``path``
        in the reference's artifact layout. On a mesh this is collective
        (:meth:`whole_params`) and the rank at mesh coordinate (0, 0)
        writes; the others wait until the artifact is on disk."""
        params = self.whole_params()
        writer = self.mesh is None or not any(self.mesh.coordinate)
        if writer:
            store = CheckpointStore(path, keep=1)
            arrays, pack_meta = packs_to_arrays(self.packs)
            meta = {
                "spec": self.spec.to_dict(),
                "cfg": config_to_dict(self.cfg),
                "tree": tree_spec(params),
                "packs": pack_meta,
                "export_stats": self.export_stats,
                "stats": self.stats(),
            }
            store.save(SERVABLE_STEP, params, extra={"servable": meta})
            step_dir = os.path.join(path, f"step_{SERVABLE_STEP:09d}")
            np.savez(os.path.join(step_dir, _PACKS_FILE), **arrays)
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()
        return path


def prepare_servable(params, cfg: ModelConfig, spec: ServingSpec = None, *,
                     registry: Optional[PatternRegistry] = None,
                     device=None, place: bool = True) -> Servable:
    """Run the prune -> export -> plan -> cache pipeline.

    ``params`` are dense weights (already-pruned with ``spec.prune='none'``);
    the servable's weights land on ``device`` (the CUDA card by default).
    The original tree is not modified.

    With ``spec.mesh_shape`` every rank of the mesh calls this with the
    same arguments (:func:`make_serving_mesh` says how to start them); the
    export is sharded (``export_params(n_shards=model)``), each rank keeps
    its shard of the params (:func:`serving_param_shardings`), and a
    measured ``backend='auto'`` takes rank 0's verdict on every rank.
    ``place=False`` exports the sharded form whole on this one process and
    attaches no mesh -- a valid single-device servable, e.g. to
    :meth:`Servable.save` once for the ranks to :func:`load_servable`."""
    spec = spec or ServingSpec()
    dev = resolve_device(device)
    mesh = (make_serving_mesh(spec)
            if spec.mesh_shape is not None and place else None)
    registry = registry if registry is not None else PatternRegistry()
    params = map_with_path(lambda _, leaf: leaf.to(dev), params)

    if spec.prune == "oneshot":
        pruned, _ = oneshot_prune(params, spec.sparsity_config())
    elif spec.prune == "tied":
        pruned, _ = tied_prune(params, spec.sparsity_config())
    else:
        pruned = params

    if spec.backend == "dense":     # negative control: no BSR support
        return _placed(pruned, cfg, spec, {}, registry, dev, {}, mesh)

    chooser = None
    if spec.backend == "plan_pallas":
        # pinned, not measured: every pack serves through kernel K1 (K6
        # for quantized packs)
        chooser = pinned_chooser("plan_pallas")
    elif spec.backend == "auto":
        import dataclasses
        from repro_torch.kernels.autotune import (CANDIDATES,
                                                  QUANT_CANDIDATES,
                                                  choose_backend)
        names = CANDIDATES + QUANT_CANDIDATES

        def chooser(pack, shard=None):
            # a sharded pack has two layouts with a mesh story (the sharded
            # plan and the sharded dense weight, plus the quantized plan
            # when pack_quant asks for it)
            cands = None
            if shard and shard[0] > 1:
                cands = ("dense", "plan") + (
                    ("plan_q8",) if spec.pack_quant != "none" else ())
            choice = choose_backend(pack, m=spec.autotune_m,
                                    candidates=cands, shard=shard,
                                    quant=spec.pack_quant, device=dev)
            if mesh is not None:
                agreed = names[_agree_on(mesh, names.index(choice.backend),
                                         dev)]
                choice = dataclasses.replace(choice, backend=agreed)
            return choice

    sparse_params, packs, stats = export_params(
        pruned, cfg, tile=spec.tile, fuse_qkv=spec.fuse_qkv,
        cross_layer_union=spec.cross_layer_union,
        include_ffn=spec.include_ffn, use_plans=spec.use_plans,
        registry=registry, backend_chooser=chooser,
        pack_quant=spec.pack_quant, device=dev,
        n_shards=spec.model_shards)
    if spec.dtype is not None and packs:
        sparse_params = _cast_packed(sparse_params, packs,
                                     torch_dtype(spec.dtype))
    return _placed(sparse_params, cfg, spec, packs, registry, dev, stats,
                   mesh)


def place_servable(servable: Servable) -> Servable:
    """This rank's servable of a whole one prepared with ``place=False``
    (its spec carries the ``mesh_shape``): the same packs, this rank's
    shard of every leaf, the mesh attached -- e.g. when one process
    prepares the export and hands it to the ranks (ranks on one card,
    through CUDA IPC). Collective like :func:`prepare_servable`. Each cut
    leaf stays a view of the whole one, whose holder keeps its memory: a
    copy would only add to it (a rank that must not hold the whole export
    prepares its shard, or loads it with :func:`load_servable`)."""
    if servable.mesh is not None or servable.spec.mesh_shape is None:
        raise ValueError("place_servable takes a servable prepared with a "
                         "mesh_shape and place=False")
    return _placed(servable.params, servable.cfg, servable.spec,
                   servable.packs, servable.registry, servable.device,
                   servable.export_stats, make_serving_mesh(servable.spec),
                   servable.stats_at_save, copy=False)


def _agree_on(mesh, value: int, device) -> int:
    """The integer ``value`` of the mesh's rank 0, on every rank. A dry
    mesh (``ProcessMesh.dry``) counts the broadcasts and takes the rank's
    own value: the meta result holds none."""
    dry = getattr(mesh, "is_dry", False)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device="meta" if dry else device)
    for axis in mesh.axis_names:
        t = mesh.broadcast(t, axis, 0)
    return int(value) if dry else int(t[0])


def _placed(params, cfg, spec, packs, registry, dev, stats, mesh,
            stats_at_save=None, copy: bool = True) -> Servable:
    """A Servable over whole ``params``: off a mesh as they are; on one,
    this rank's shard of every leaf with the mesh attached to the packs."""
    specs = None
    if mesh is not None:
        packs = attach_mesh(packs, mesh)
        specs = serving_param_shardings(params, packs, mesh)
        params = _local_params(params, specs, mesh, copy)
    return Servable(params, cfg, spec, packs, registry, dev,
                    export_stats=stats, stats_at_save=stats_at_save,
                    mesh=mesh, param_specs=specs)


def load_servable(path: str, *, registry: Optional[PatternRegistry] = None,
                  device=None) -> Servable:
    """Restore a saved Servable -- written by this package or by the JAX
    package's ``Servable.save`` -- onto ``device`` (the CUDA card by
    default). No pruning, packing or plan construction re-runs.

    With a ``mesh_shape`` in the saved spec every rank of the mesh calls
    this (:func:`make_serving_mesh`); each reads only its shard of every
    leaf from the archive (memory-mapped) and attaches its mesh.

    A truncated / corrupt / incomplete artifact raises
    :class:`~repro_torch.serving.serialize.ServableLoadError` naming the
    offending piece."""
    dev = resolve_device(device)
    store = CheckpointStore(path)
    try:
        meta = store.meta(SERVABLE_STEP)["servable"]
    except Exception as e:
        raise ServableLoadError(
            f"servable meta unreadable under {path} "
            f"({type(e).__name__}: {e})") from e
    cfg = config_from_dict(meta["cfg"])
    spec = ServingSpec.from_dict(meta["spec"])
    mesh = make_serving_mesh(spec) if spec.mesh_shape is not None else None
    step_dir = os.path.join(path, f"step_{SERVABLE_STEP:09d}")
    registry = registry if registry is not None else PatternRegistry()
    packs_path = os.path.join(step_dir, _PACKS_FILE)
    try:
        npz = np.load(packs_path)
    except Exception as e:
        raise ServableLoadError(
            f"pack archive {packs_path} unreadable "
            f"({type(e).__name__}: {e})") from e
    with npz:
        packs = packs_from_arrays(meta["packs"], LeafReader(npz, packs_path),
                                  registry)
    like = build_like(meta["tree"])
    if mesh is None:
        params = store.restore(like, step=SERVABLE_STEP, device=dev)
        return Servable(params, cfg, spec, packs, registry, dev,
                        export_stats=meta.get("export_stats"),
                        stats_at_save=meta.get("stats"))
    packs = attach_mesh(packs, mesh)
    packed = _packed_names(packs)
    coord = {a: mesh.coord(a) for a in mesh.axis_names}
    specs = {}

    def select(p, arr):
        spec_ = _leaf_spec(norm_path(path_name(p)), arr.shape, packed, mesh)
        specs[p] = spec_
        return local_shard(arr, spec_, mesh, coord)
    params = store.restore(like, step=SERVABLE_STEP, device=dev,
                           select=select)
    return Servable(params, cfg, spec, packs, registry, dev,
                    export_stats=meta.get("export_stats"),
                    stats_at_save=meta.get("stats"), mesh=mesh,
                    param_specs=map_with_path(lambda p, _: specs[p], params))
