"""(De)serialization helpers for Servable artifacts.

Counterpart of ``repro/serving/serialize.py``, with the same JSON and npz
layout, so an artifact written by either package loads in the other:

  * **tree spec** -- a JSON description of a param tree's structure with
    per-leaf dtypes (insertion-ordered; leaf *numbering* on disk follows
    the reference's flatten order, see ``checkpoint/store.py``);
  * **pack codec** -- static patterns flattened into npz arrays + JSON
    meta, deduplicated by pattern fingerprint so cross-layer sharing
    survives a round-trip (kinds ``plan``, ``sharded_plan``,
    ``plan_choice``, ``quant_plan`` (codec 1, over a plain or a sharded
    plan), ``masked``, ``choice`` and ``bsr``);
  * **config codec** -- ModelConfig to plain dicts and back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.core.pattern_reuse import PatternRegistry
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels.autotune import BackendChoice, MaskedPack
from repro_torch.kernels.bsr_matmul import KernelBSR
from repro_torch.kernels.exec_plan import (PlanChoice, QuantPlan,
                                           RowPackPlan, ShardedPlan,
                                           kernel_pattern_fingerprint)

_PLAN_FIELDS = ("col_idx", "slot_mask", "row_of_vrow", "vrow", "slot")
_BSR_FIELDS = ("row_id", "col_id", "t_perm")


class ServableLoadError(RuntimeError):
    """A Servable artifact failed to load: missing, truncated or corrupt
    metadata / pack archive. The message names the offending piece."""


class LeafReader:
    """Mapping shim over an ``np.load`` NpzFile that turns per-member
    failures into :class:`ServableLoadError` naming the offending leaf."""

    def __init__(self, npz, path: str):
        self._npz = npz
        self._path = path

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            return self._npz[name]
        except KeyError:
            raise ServableLoadError(
                f"pack archive {self._path} is missing leaf {name!r} "
                f"(truncated or incompatible artifact)") from None
        except Exception as e:  # zlib.error / BadZipFile / ValueError ...
            raise ServableLoadError(
                f"pack archive {self._path}: leaf {name!r} is unreadable "
                f"({type(e).__name__}: {e})") from e

    def __contains__(self, name: str) -> bool:
        return name in self._npz


def pattern_key(pack) -> bytes:
    """Fingerprint of a static pattern, uniform across the pack kinds (plan
    / plan choice / quantized plan / autotuned choice / masked / bsr) --
    the dedupe key here and the uniqueness key of ``Servable.stats()``;
    the reference's bytes for every kind."""
    if isinstance(pack, KernelBSR):
        return kernel_pattern_fingerprint(pack)
    return pack.fingerprint


# --------------------------------------------------------------------------
# tree spec
# --------------------------------------------------------------------------

def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', 'int32', ... for a torch or numpy dtype (the
    reference writes ``str`` of the jnp dtype)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def tree_spec(tree) -> dict:
    """JSON-safe structure descriptor of a tree of tensors (dict / tuple /
    list containers, tensor or None leaves)."""
    if isinstance(tree, dict):
        return {"kind": "dict",
                "items": {str(k): tree_spec(v) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"kind": "tuple" if isinstance(tree, tuple) else "list",
                "items": [tree_spec(v) for v in tree]}
    if tree is None:
        return {"kind": "none"}
    return {"kind": "leaf", "dtype": dtype_name(tree.dtype)}


def build_like(spec: dict):
    """Rebuild a placeholder tree from :func:`tree_spec` output: the same
    structure, each leaf its recorded dtype name (all the store's restore
    consults)."""
    kind = spec["kind"]
    if kind == "dict":
        return {k: build_like(v) for k, v in spec["items"].items()}
    if kind in ("tuple", "list"):
        items = [build_like(v) for v in spec["items"]]
        return tuple(items) if kind == "tuple" else items
    if kind == "none":
        return None
    return spec["dtype"]


# --------------------------------------------------------------------------
# pack codec
# --------------------------------------------------------------------------

def _plan_meta(plan: RowPackPlan) -> dict:
    return {"shape": list(plan.shape), "tile": list(plan.tile),
            "nnzt": plan.nnzt, "real_nnzt": plan.real_nnzt}


def _shard_arrays(arrays: dict, idx: int, plan: ShardedPlan) -> dict:
    """A sharded plan's layout meta; its per-shard sub-pattern
    fingerprints go into ``arrays`` (the mesh itself is never stored:
    ``load_servable`` attaches the process's own)."""
    sfps = list(plan.shard_fingerprints)
    arrays[f"p{idx}_shard_fp_lens"] = np.array([len(f) for f in sfps],
                                               np.int64)
    arrays[f"p{idx}_shard_fps"] = np.frombuffer(b"".join(sfps), np.uint8)
    return {"n_shards": plan.n_shards, "shard_axis": plan.shard_axis}


def packs_to_arrays(packs: Dict[str, object]) -> Tuple[dict, dict]:
    """-> (npz arrays, JSON meta). Unique patterns stored once (fingerprint
    dedupe); ``meta['keys']`` fans each layer scope back out to its ref.
    KernelBSR kinds store structure only: serving reads their values from
    the params tree."""
    arrays: Dict[str, np.ndarray] = {}
    metas: List[dict] = []
    index_of: Dict[bytes, int] = {}
    keys = []
    for key, pk in packs.items():
        fp = pattern_key(pk)
        idx = index_of.get(fp)
        if idx is None:
            idx = len(metas)
            index_of[fp] = idx
            arrays[f"p{idx}_fingerprint"] = np.frombuffer(fp, np.uint8)
            plan = None
            if isinstance(pk, QuantPlan):
                # ``codec: 1`` versions the quant entry itself
                plan = pk.plan
                sharded = isinstance(plan, ShardedPlan)
                m = {"kind": "quant_plan", "codec": 1, "qdtype": pk.qdtype,
                     "granularity": pk.granularity, "backend": pk.backend,
                     **_plan_meta(plan), "sharded": sharded}
                if sharded:
                    m.update(_shard_arrays(arrays, idx, plan))
                metas.append(m)
                arrays[f"p{idx}_plan_fingerprint"] = np.frombuffer(
                    plan.fingerprint, np.uint8)
            elif isinstance(pk, ShardedPlan):
                plan = pk
                metas.append({"kind": "sharded_plan", **_plan_meta(plan),
                              **_shard_arrays(arrays, idx, plan)})
            elif isinstance(pk, RowPackPlan):
                plan = pk
                metas.append({"kind": "plan", **_plan_meta(plan)})
            elif isinstance(pk, PlanChoice):
                plan = pk.plan
                metas.append({"kind": "plan_choice", "backend": pk.backend,
                              **_plan_meta(plan)})
                arrays[f"p{idx}_plan_fingerprint"] = np.frombuffer(
                    plan.fingerprint, np.uint8)
            elif isinstance(pk, MaskedPack):
                metas.append({"kind": "masked", "shape": list(pk.shape),
                              "tile": list(pk.tile)})
                arrays[f"p{idx}_tile_mask"] = np.asarray(pk.tile_mask, bool)
            else:
                choice = isinstance(pk, BackendChoice)
                inner = pk.pack if choice else pk
                if not isinstance(inner, KernelBSR):
                    raise TypeError(f"unknown pack kind {type(pk).__name__}")
                m = {"kind": "bsr", "shape": list(inner.shape),
                     "tile": list(inner.tile),
                     "real_nnzt": inner.real_nnzt}
                if choice:
                    m = {"kind": "choice", "backend": pk.backend,
                         **{k: v for k, v in m.items() if k != "kind"}}
                metas.append(m)
                for f in _BSR_FIELDS:
                    arrays[f"p{idx}_{f}"] = np.asarray(getattr(inner, f))
            if plan is not None:
                for f in _PLAN_FIELDS:
                    arrays[f"p{idx}_{f}"] = np.asarray(getattr(plan, f))
        keys.append({"key": key, "ref": idx})
    return arrays, {"patterns": metas, "keys": keys}


def _plan_from(arrays, idx: int, m: dict, fp: bytes) -> RowPackPlan:
    fields = dict(
        col_idx=np.asarray(arrays[f"p{idx}_col_idx"], np.int32),
        slot_mask=np.asarray(arrays[f"p{idx}_slot_mask"], bool),
        row_of_vrow=np.asarray(arrays[f"p{idx}_row_of_vrow"], np.int32),
        vrow=np.asarray(arrays[f"p{idx}_vrow"], np.int32),
        slot=np.asarray(arrays[f"p{idx}_slot"], np.int32),
        shape=tuple(m["shape"]), tile=tuple(m["tile"]),
        nnzt=int(m["nnzt"]), real_nnzt=int(m["real_nnzt"]), fingerprint=fp)
    if m["kind"] != "sharded_plan" and not m.get("sharded"):
        return RowPackPlan(**fields)
    lens = np.asarray(arrays[f"p{idx}_shard_fp_lens"], np.int64)
    blob = bytes(np.asarray(arrays[f"p{idx}_shard_fps"], np.uint8))
    offs = np.concatenate([[0], np.cumsum(lens)])
    return ShardedPlan(**fields, n_shards=int(m["n_shards"]),
                       shard_axis=m["shard_axis"],
                       shard_fingerprints=tuple(
                           blob[offs[i]: offs[i + 1]]
                           for i in range(len(lens))))


def _bsr_from(arrays, idx: int, m: dict) -> KernelBSR:
    col_id = np.asarray(arrays[f"p{idx}_col_id"], np.int32)
    bn, bk = (int(t) for t in m["tile"])
    return KernelBSR(
        # a zero-stride placeholder: serve-time values come from the params
        # tree, never from the pack (models/common.linear)
        data=np.broadcast_to(np.zeros((), np.float32),
                             (len(col_id), bn, bk)),
        row_id=np.asarray(arrays[f"p{idx}_row_id"], np.int32),
        col_id=col_id,
        t_perm=np.asarray(arrays[f"p{idx}_t_perm"], np.int32),
        real_nnzt=int(m["real_nnzt"]), shape=tuple(m["shape"]),
        tile=(bn, bk))


def packs_from_arrays(meta: dict, arrays, registry: PatternRegistry = None
                      ) -> Dict[str, object]:
    """Inverse of :func:`packs_to_arrays`. Plans are rebuilt through the
    registry's fingerprint-keyed cache so the loaded servable shares one
    plan object per unique pattern. The backend string ``'plan_pallas'``
    that the reference writes maps onto kernel K1 (K6 for a quantized
    plan)."""
    built = []
    for idx, m in enumerate(meta["patterns"]):
        kind = m["kind"]
        fp = bytes(np.asarray(arrays[f"p{idx}_fingerprint"], np.uint8))
        if kind == "masked":
            built.append(MaskedPack(
                tile_mask=np.asarray(arrays[f"p{idx}_tile_mask"], bool),
                shape=tuple(m["shape"]), tile=tuple(m["tile"])))
            continue
        if kind in ("bsr", "choice"):
            bsr = _bsr_from(arrays, idx, m)
            built.append(BackendChoice(bsr, m["backend"])
                         if kind == "choice" else bsr)
            continue
        if kind in ("plan_choice", "quant_plan"):
            plan_fp = bytes(np.asarray(arrays[f"p{idx}_plan_fingerprint"],
                                       np.uint8))
        elif kind in ("plan", "sharded_plan"):
            plan_fp = fp
        else:
            raise ValueError(f"unknown pack kind {kind!r}")

        def build(idx=idx, m=m, plan_fp=plan_fp):
            return _plan_from(arrays, idx, m, plan_fp)
        sharded = kind == "sharded_plan" or m.get("sharded")
        cache_key = ("sharded_plan_codec" if sharded else "rowpack_plan",
                     plan_fp)
        plan = (registry.cached(cache_key, build)
                if registry is not None else build())
        if kind in ("plan", "sharded_plan"):
            built.append(plan)
            continue
        if m["backend"] not in (("plan", "plan_pallas") if kind ==
                                "quant_plan" else ("plan_pallas",)):
            raise ValueError(f"{kind} backend {m['backend']!r} unknown")
        if kind == "plan_choice":
            built.append(PlanChoice(plan, m["backend"]))
        else:
            built.append(QuantPlan(plan, qdtype=m["qdtype"],
                                   granularity=m["granularity"],
                                   backend=m["backend"]))
    return {e["key"]: built[e["ref"]] for e in meta["keys"]}


# --------------------------------------------------------------------------
# config codec
# --------------------------------------------------------------------------

def config_to_dict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ModelConfig:
    d = dict(d)
    d["pattern"] = tuple(LayerKind(**k) for k in d.get("pattern", ()))
    d["prefix"] = tuple(LayerKind(**k) for k in d.get("prefix", ()))
    if d.get("sparsity"):
        sp = dict(d["sparsity"])
        sp["block_shape"] = tuple(sp["block_shape"])
        sp["targets"] = tuple(sp["targets"])
        d["sparsity"] = SparsityConfig(**sp)
    return ModelConfig(**d)
