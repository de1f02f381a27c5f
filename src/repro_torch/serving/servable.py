"""prepare_servable / Servable / load_servable: the serving facade.

Counterpart of ``repro/serving/servable.py`` for this slice (the bert
family; backends ``plan``, ``plan_pallas`` and ``dense``). One spec-driven
entry point owns the pipeline the paper argues must be co-designed:

    prune (core.pruner recipe)            -- algorithm side
    -> BSR export (serving.export)        -- layout
    -> RowPackPlan construction           -- execution schedule
    -> PatternRegistry caching            -- cross-layer reuse

``save`` / :func:`load_servable` use the reference's artifact layout, so a
servable saved by the JAX package loads here (and the other way round for
fp32 artifacts).
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
from repro_torch.kernels.exec_plan import RowPackPlan
from repro_torch.models import api as model_api
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
_SLICE_BACKENDS = ("plan", "plan_pallas", "dense")


def _check_spec(spec: ServingSpec):
    """Raise for spec options outside this slice, naming the ROADMAP.md
    item that brings each."""
    if spec.mesh_shape is not None:
        raise NotImplementedError(
            "mesh_shape comes with ROADMAP.md Queue 1 slice 6 (sharding)")
    if spec.pack_quant != "none":
        raise NotImplementedError(
            "pack_quant comes with ROADMAP.md Queue 1 item 15 (quantized "
            "packs)")
    if spec.backend not in _SLICE_BACKENDS:
        raise NotImplementedError(
            f"backend {spec.backend!r} comes with ROADMAP.md Queue 1 items "
            f"4 ('bsr') and 16 ('auto')")


def _cast_packed(params, packs, dtype):
    """Cast only the packed projection values to the spec dtype (embeddings,
    norms, heads keep the model dtype)."""
    targets = {key + "/w" for key in packs}

    def one(path, leaf):
        return leaf.to(dtype) if norm_path(path_name(path)) in targets \
            else leaf
    return map_with_path(one, params)


class _PinnedChoice:
    """The backend chooser's verdict for a pinned ``plan_pallas`` spec."""
    backend, cache_hit, mode = "plan_pallas", False, "pinned"


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

    # -- instrumentation --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The co-design scorecard: how sparse, how shared, how padded."""
        # bare plans only, as the reference counts them (PlanChoice packs
        # report no padded-FLOP ratio there either)
        plans = [p for p in self.packs.values()
                 if isinstance(p, RowPackPlan)]
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
        if self.stats_at_save is not None:
            out["registry_at_save"] = self.stats_at_save.get("registry")
        return out

    def pack_bytes(self) -> Tuple[int, int]:
        """(total, per-device) bytes of the packed projection values in the
        params tree (one device: the two are equal)."""
        targets = {key + "/w" for key in self.packs}
        total = sum(leaf.numel() * leaf.element_size()
                    for path, leaf in flatten_with_path(self.params)
                    if norm_path(path_name(path)) in targets)
        return total, total

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
        # pinned, not measured: every pack serves through kernel K1
        def chooser(pack):
            return _PinnedChoice()

    sparse_params, packs, stats = export_params(
        pruned, cfg, tile=spec.tile, fuse_qkv=spec.fuse_qkv,
        cross_layer_union=spec.cross_layer_union,
        include_ffn=spec.include_ffn, use_plans=spec.use_plans,
        registry=registry, backend_chooser=chooser, device=dev)
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
