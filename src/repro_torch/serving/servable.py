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
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core.pattern_reuse import PatternRegistry
from repro_torch.core.pruner import oneshot_prune, tied_prune
from repro_torch.core.tree import flatten_with_path, map_with_path, \
    norm_path, path_name
from repro_torch.device import resolve_device
from repro_torch.kernels.exec_plan import QuantPlan, RowPackPlan
from repro_torch.kernels.flash_decode import decode_kernel_override
from repro_torch.models import api as model_api
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


def _check_spec(spec: ServingSpec):
    """Raise for spec options the port does not serve yet, naming the
    ROADMAP.md item that brings each."""
    if spec.mesh_shape is not None:
        raise NotImplementedError(
            "mesh_shape comes with ROADMAP.md Queue 1 item 6 (sharding)")


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
                 stats_at_save: Optional[Dict] = None):
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.packs = packs
        self.registry = registry
        self.device = torch.device(device)
        self.export_stats = export_stats or {}
        self.stats_at_save = stats_at_save
        self._decode_kind: Optional[str] = None

    # -- serving ----------------------------------------------------------
    def _as_batch(self, batch) -> Dict[str, Any]:
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def forward(self, batch):
        """batch dict (``{'tokens': (B, S)}``) or raw tokens -> logits fp32."""
        with torch.inference_mode():
            logits, _aux = model_api.model_forward(
                self.params, self.cfg, self._as_batch(batch),
                packs=self.packs)
        return logits

    # -- decoding (LM families) -------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int, frames=None,
                   paged=None):
        """A zeroed decode cache for ``batch_size`` slots on the servable's
        device (``paged``: a ``models.common.PagedLayout``). The audio
        family encodes ``frames`` (B, T_audio, d) into the cache's cross
        K/V; its batch is the frames'."""
        if frames is not None:
            frames = self._tensor(frames)
        with torch.no_grad():
            return model_api.init_cache(self.params, self.cfg, batch_size,
                                        cache_len, frames=frames,
                                        paged=paged)

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
                self._decode_kind = choose_decode_kernel(
                    b=8, t=512, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                    d=cfg.head_dim, device=self.device).backend
        return self._decode_kind

    def decode_step(self, cache, token, pos):
        """(cache, token (B,1), pos) -> (logits (B,1,V) fp32, cache); the
        new K/V rows are written into ``cache`` in place. ``pos`` is a
        scalar or a ragged int32 (B,) vector (-1 = inactive row)."""
        with torch.no_grad(), decode_kernel_override(
                self.decode_kernel_kind()):
            return model_api.decode_step(
                self.params, cache, self.cfg, self._tensor(token),
                self._tensor(pos), packs=self.packs)

    def decode_many(self, cache, token, pos, n_steps, *, remaining=None,
                    eos_id=None, key=None, temperature: float = 0.0,
                    top_k: int = 0):
        """K fused decode steps (``models.api.decode_many``): sampling
        (greedy, or ``temperature`` / ``top_k`` with the threefry ``key``,
        ``models/prng.py``) and per-slot EOS / budget masking on the device,
        one host sync when the caller reads the results. Returns ``(tokens
        (K, B), valid (K, B), state)``; the cache is updated in place."""
        with torch.no_grad(), decode_kernel_override(
                self.decode_kernel_kind()):
            return model_api.decode_many(
                self.params, cache, self.cfg, self._tensor(token),
                self._tensor(pos), int(n_steps), packs=self.packs,
                remaining=None if remaining is None
                else self._tensor(remaining),
                eos_id=None if eos_id is None else self._tensor(eos_id),
                key=key, temperature=temperature, top_k=top_k)

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
                packs=self.packs)
        return cache1, logits[0]

    def suffix_prefill(self, cache, tokens, slot, start, length):
        """Prefill tokens (S,) of slot ``slot``'s prompt from position
        ``start`` against what the slot already holds: the uncached suffix
        after a shared prefix (paged), or the next chunk of a chunked
        prefill (dense or paged). Returns ``(cache, logits (S, V))``."""
        with torch.no_grad():
            logits, cache = model_api.prefill_suffix(
                self.params, cache, self.cfg, self._tensor(tokens)[None],
                int(slot), int(start), int(length), packs=self.packs)
        return cache, logits[0]

    def engine_write_slot(self, cache, slot, sub):
        """Copy the batch-1 prefill cache ``sub`` into ``slot``, in place."""
        return model_api.write_slot(cache, self.cfg, slot, sub)

    def engine_free_slot(self, cache, slot):
        """Empty ``slot`` in place (recycle hygiene)."""
        return model_api.free_slot(cache, self.cfg, slot)

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
        if self.stats_at_save is not None:
            out["registry_at_save"] = self.stats_at_save.get("registry")
        return out

    def _leaves(self, names):
        return [leaf for path, leaf in flatten_with_path(self.params)
                if norm_path(path_name(path)) in names]

    def pack_bytes(self) -> Tuple[int, int]:
        """(total, per-device) bytes of the packed projection values in the
        params tree (one device: the two are equal). Quantized packs count
        their scales too."""
        targets = {key + "/w" for key in self.packs}
        targets |= {key + "/scale" for key, pk in self.packs.items()
                    if isinstance(pk, QuantPlan)}
        total = sum(leaf.numel() * leaf.element_size()
                    for leaf in self._leaves(targets))
        return total, total

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
        wbytes = sum(t.numel() * t.element_size() for t in w)
        sbytes = sum(t.numel() * t.element_size() for t in sc)
        fp32 = sum(t.numel() * 4 for t in w)
        qbytes = wbytes + sbytes
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
            "quant_bytes_per_device": qbytes,
            "scale_bytes_total": sbytes,
            "fp32_equiv_bytes_total": fp32,
            "fp32_equiv_bytes_per_device": fp32,
            "compression_ratio": fp32 / qbytes if qbytes else None,
        }
        if errs:
            out["max_abs_err"] = max(e["max_abs_err"] for e in errs)
            out["max_rel_err"] = max(e["rel_err"] for e in errs)
        return out

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> str:
        """Persist params + static patterns + spec/config under ``path``
        in the reference's artifact layout."""
        store = CheckpointStore(path, keep=1)
        arrays, pack_meta = packs_to_arrays(self.packs)
        meta = {
            "spec": self.spec.to_dict(),
            "cfg": config_to_dict(self.cfg),
            "tree": tree_spec(self.params),
            "packs": pack_meta,
            "export_stats": self.export_stats,
            "stats": self.stats(),
        }
        store.save(SERVABLE_STEP, self.params, extra={"servable": meta})
        step_dir = os.path.join(path, f"step_{SERVABLE_STEP:09d}")
        np.savez(os.path.join(step_dir, _PACKS_FILE), **arrays)
        return path


def prepare_servable(params, cfg: ModelConfig, spec: ServingSpec = None, *,
                     registry: Optional[PatternRegistry] = None,
                     device=None) -> Servable:
    """Run the prune -> export -> plan -> cache pipeline.

    ``params`` are dense weights (already-pruned with ``spec.prune='none'``);
    the servable's weights land on ``device`` (the CUDA card by default).
    The original tree is not modified."""
    spec = spec or ServingSpec()
    _check_spec(spec)
    dev = resolve_device(device)
    registry = registry if registry is not None else PatternRegistry()
    params = map_with_path(lambda _, leaf: leaf.to(dev), params)

    if spec.prune == "oneshot":
        pruned, _ = oneshot_prune(params, spec.sparsity_config())
    elif spec.prune == "tied":
        pruned, _ = tied_prune(params, spec.sparsity_config())
    else:
        pruned = params

    if spec.backend == "dense":     # negative control: no BSR support
        return Servable(pruned, cfg, spec, {}, registry, dev,
                        export_stats={})

    chooser = None
    if spec.backend == "plan_pallas":
        # pinned, not measured: every pack serves through kernel K1 (K6
        # for quantized packs)
        chooser = pinned_chooser("plan_pallas")
    elif spec.backend == "auto":
        from repro_torch.kernels.autotune import choose_backend

        def chooser(pack):
            # the q8 arms join the candidate set when pack_quant is set
            return choose_backend(pack, m=spec.autotune_m,
                                  quant=spec.pack_quant, device=dev)

    sparse_params, packs, stats = export_params(
        pruned, cfg, tile=spec.tile, fuse_qkv=spec.fuse_qkv,
        cross_layer_union=spec.cross_layer_union,
        include_ffn=spec.include_ffn, use_plans=spec.use_plans,
        registry=registry, backend_chooser=chooser,
        pack_quant=spec.pack_quant, device=dev)
    if spec.dtype is not None and packs:
        sparse_params = _cast_packed(sparse_params, packs,
                                     torch_dtype(spec.dtype))
    return Servable(sparse_params, cfg, spec, packs, registry, dev,
                    export_stats=stats)


def load_servable(path: str, *, registry: Optional[PatternRegistry] = None,
                  device=None) -> Servable:
    """Restore a saved Servable -- written by this package or by the JAX
    package's ``Servable.save`` -- onto ``device`` (the CUDA card by
    default). No pruning, packing or plan construction re-runs.

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
    _check_spec(spec)
    params = store.restore(build_like(meta["tree"]), step=SERVABLE_STEP,
                           device=dev)
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
    return Servable(params, cfg, spec, packs, registry, dev,
                    export_stats=meta.get("export_stats"),
                    stats_at_save=meta.get("stats"))
