"""(De)serialization helpers for Servable artifacts.

Counterpart of ``repro/serving/serialize.py``, with the same JSON and npz
layout, so an artifact written by either package loads in the other:

  * **tree spec** -- a JSON description of a param tree's structure with
    per-leaf dtypes (insertion-ordered; leaf *numbering* on disk follows
    the reference's flatten order, see ``checkpoint/store.py``);
  * **pack codec** -- static plans flattened into npz arrays + JSON meta,
    deduplicated by pattern fingerprint so cross-layer sharing survives a
    round-trip (kinds ``plan`` and ``plan_choice`` in this slice);
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
from repro_torch.kernels.exec_plan import PlanChoice, RowPackPlan

_PLAN_FIELDS = ("col_idx", "slot_mask", "row_of_vrow", "vrow", "slot")
_ITEM_KINDS = ("ROADMAP.md Queue 1 items 4 (bsr packs), 15 (quantized "
               "packs) and slice 6 (sharded plans)")


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
    """Fingerprint of a static pattern (plan or plan choice): the dedupe key
    here and the uniqueness key of ``Servable.stats()``."""
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


def packs_to_arrays(packs: Dict[str, object]) -> Tuple[dict, dict]:
    """-> (npz arrays, JSON meta). Unique patterns stored once (fingerprint
    dedupe); ``meta['keys']`` fans each layer scope back out to its ref."""
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
            if isinstance(pk, PlanChoice):
                plan = pk.plan
                metas.append({"kind": "plan_choice", "backend": pk.backend,
                              **_plan_meta(plan)})
                arrays[f"p{idx}_plan_fingerprint"] = np.frombuffer(
                    plan.fingerprint, np.uint8)
            elif isinstance(pk, RowPackPlan):
                plan = pk
                metas.append({"kind": "plan", **_plan_meta(plan)})
            else:
                raise NotImplementedError(
                    f"pack kind {type(pk).__name__} comes with "
                    f"{_ITEM_KINDS}")
            for f in _PLAN_FIELDS:
                arrays[f"p{idx}_{f}"] = np.asarray(getattr(plan, f))
        keys.append({"key": key, "ref": idx})
    return arrays, {"patterns": metas, "keys": keys}


def _plan_from(arrays, idx: int, m: dict, fp: bytes) -> RowPackPlan:
    return RowPackPlan(
        col_idx=np.asarray(arrays[f"p{idx}_col_idx"], np.int32),
        slot_mask=np.asarray(arrays[f"p{idx}_slot_mask"], bool),
        row_of_vrow=np.asarray(arrays[f"p{idx}_row_of_vrow"], np.int32),
        vrow=np.asarray(arrays[f"p{idx}_vrow"], np.int32),
        slot=np.asarray(arrays[f"p{idx}_slot"], np.int32),
        shape=tuple(m["shape"]), tile=tuple(m["tile"]),
        nnzt=int(m["nnzt"]), real_nnzt=int(m["real_nnzt"]), fingerprint=fp)


def packs_from_arrays(meta: dict, arrays, registry: PatternRegistry = None
                      ) -> Dict[str, object]:
    """Inverse of :func:`packs_to_arrays`. Plans are rebuilt through the
    registry's fingerprint-keyed cache so the loaded servable shares one
    plan object per unique pattern. The backend string ``'plan_pallas'``
    that the reference writes maps onto kernel K1."""
    built = []
    for idx, m in enumerate(meta["patterns"]):
        fp = bytes(np.asarray(arrays[f"p{idx}_fingerprint"], np.uint8))
        if m["kind"] == "plan_choice":
            plan_fp = bytes(np.asarray(arrays[f"p{idx}_plan_fingerprint"],
                                       np.uint8))
        elif m["kind"] == "plan":
            plan_fp = fp
        else:
            raise NotImplementedError(
                f"pack kind {m['kind']!r} comes with {_ITEM_KINDS}")

        def build(idx=idx, m=m, plan_fp=plan_fp):
            return _plan_from(arrays, idx, m, plan_fp)
        plan = (registry.cached(("rowpack_plan", plan_fp), build)
                if registry is not None else build())
        if m["kind"] == "plan_choice":
            if m["backend"] != "plan_pallas":
                raise NotImplementedError(
                    f"plan backend {m['backend']!r} comes with {_ITEM_KINDS}")
            built.append(PlanChoice(plan, m["backend"]))
        else:
            built.append(plan)
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
