"""BSR export for the BERT encoder (the TVM relay-conversion analogue).

Counterpart of the bert part of ``repro/serving/export.py``. Training keeps
dense weights; serving packs the pruned projections into tile-granular BSR
on the host (numpy, byte-identical to the reference) and lowers each
pattern to a :class:`~repro_torch.kernels.exec_plan.RowPackPlan`, storing
the tile values already row-grouped on the serving device. Two
pattern-level optimizations happen here, offline:

  * **fused QKV** (``fuse_qkv=True``): wq/wk/wv concatenated along N into
    one pack -- one block-sparse matmul per attention layer;
  * **cross-layer union** (``cross_layer_union=True``): each projection
    group is union-packed across the encoder layers, so one plan serves
    every layer with per-layer values (the paper's §2.2 task-buffer
    collapse); ``union_overhead`` quantifies the waste.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pattern_reuse import PatternRegistry
from repro_torch.kernels.bsr_matmul import KernelBSR, pack_bsr
from repro_torch.kernels.exec_plan import (PlanChoice, pack_plan_data,
                                           plan_for_pack)

_QKV = ("wq", "wk", "wv")

_ITEM_BSR = "ROADMAP.md Queue 1 item 4 (bsr_linear backends)"
_ITEM_LM = "ROADMAP.md Queue 1 item 9 (the LM model path)"


def _tile_mask(w: np.ndarray, tile) -> np.ndarray:
    n, k = w.shape
    bn, bk = tile
    return np.any(w.reshape(n // bn, bn, k // bk, bk) != 0, axis=(1, 3))


def pack_stacked(w_stacked: np.ndarray, tile) -> Tuple[KernelBSR, np.ndarray,
                                                       Dict]:
    """(L, N, K) -> (union pattern pack, per-layer data (L, nnzt, bn, bk),
    union stats)."""
    l, n, k = w_stacked.shape
    bn, bk = tile
    masks = np.stack([_tile_mask(w_stacked[i], tile) for i in range(l)])
    union = masks.any(axis=0)
    proto = np.kron(union.astype(np.float32), np.ones(tile, np.float32))
    pack = pack_bsr(proto, tile)
    rows = pack.row_id[: pack.nnzt]
    cols = pack.col_id
    blocks = w_stacked.reshape(l, n // bn, bn, k // bk, bk).transpose(
        0, 1, 3, 2, 4)
    data = blocks[:, rows, cols]                      # (L, nnzt, bn, bk)
    per_layer_nnz = masks.sum(axis=(1, 2))
    stats = {
        "union_nnzt": int(union.sum()),
        "mean_layer_nnzt": float(per_layer_nnz.mean()),
        "union_overhead": float(union.sum() / max(per_layer_nnz.mean(), 1.0)),
    }
    return pack, data, stats


def pack_single(w: np.ndarray, tile) -> Tuple[KernelBSR, np.ndarray]:
    pack = pack_bsr(w, tile)
    return pack, pack.data


def _realize_backend(pack, data, backend: str,
                     registry: Optional[PatternRegistry], device):
    """(pattern, packed values (numpy), backend) -> (static pack stored in
    ``packs``, row-grouped values on ``device`` for the params tree).

      * ``plan``        -> RowPackPlan (served by the plain composition);
      * ``plan_pallas`` -> the same plan wrapped in a PlanChoice pinning
        every call to kernel K1.
    """
    if backend not in ("plan", "plan_pallas"):
        raise NotImplementedError(
            f"serving backend {backend!r} comes with {_ITEM_BSR}")
    plan = plan_for_pack(pack, registry)
    vals = pack_plan_data(plan, torch.from_numpy(
        np.ascontiguousarray(data)).to(device))
    return (PlanChoice(plan) if backend == "plan_pallas" else plan), vals


def _serving_pack(w: np.ndarray, tile, use_plans: bool,
                  registry: Optional[PatternRegistry], device, chooser=None):
    """(N, K) weight -> (static pattern, values, chooser meta)."""
    pack = pack_bsr(w, tile)
    if chooser is None:
        if not use_plans:
            raise NotImplementedError(f"backend 'bsr' comes with {_ITEM_BSR}")
        pk, vals = _realize_backend(pack, pack.data, "plan", registry,
                                    device)
        return pk, vals, None
    choice = chooser(pack)
    pk, vals = _realize_backend(pack, pack.data, choice.backend, registry,
                                device)
    meta = {"backend": choice.backend,
            "cache_hit": choice.cache_hit, "mode": choice.mode}
    return pk, vals, meta


def _param_entry(vals, dtype) -> Dict:
    """Params-tree entry for a pack's serving values, in the model dtype."""
    return {"w": vals.to(dtype)}


def _param_entry_layer(vals, i: int, dtype) -> Dict:
    """Per-layer slice of stacked serving values."""
    return {"w": vals[i].to(dtype)}


def _get_w(p) -> np.ndarray:
    return p["w"].detach().float().cpu().numpy()


def _divisible(shape, tile) -> bool:
    return shape[-2] % tile[0] == 0 and shape[-1] % tile[1] == 0


def _fused_qkv_weight(ap, tile) -> Optional[np.ndarray]:
    """Concatenate wq/wk/wv along N; None when a projection is missing or a
    segment boundary would not land on a block row."""
    if not all(proj in ap for proj in _QKV):
        return None
    ws = [_get_w(ap[proj]) for proj in _QKV]
    if not all(_divisible(w.shape, tile) for w in ws):
        return None
    return np.concatenate(ws, axis=0)


def _pack_nnzt(pk) -> int:
    return int(getattr(pk, "plan", pk).real_nnzt)   # PlanChoice wraps a plan


def export_bert_sparse(params, cfg: ModelConfig, tile=(64, 64),
                       include_ffn=True, *, fuse_qkv: bool = True,
                       cross_layer_union: bool = False,
                       use_plans: bool = True,
                       registry: Optional[PatternRegistry] = None,
                       stats_out: Optional[Dict] = None,
                       backend_chooser=None, device=None):
    """BSR export for the unrolled BERT encoder. Returns (sparse_params,
    packs); ``packs`` maps 'layers/<i>/<group>/<name>' to its static plan.
    ``stats_out`` is filled with the per-group union stats. Values land on
    ``device`` (default: where the weights are)."""
    layers = params["layers"]
    n_layers = len(layers)
    if device is None:
        device = layers[0]["attn"]["wo"]["w"].device
    packs: Dict[str, object] = {}
    attn_new = [dict(lp["attn"]) for lp in layers]
    ffn_new = [dict(lp["ffn"]) for lp in layers]

    # (group, exported name, per-layer weight extractor, source param name)
    specs = []
    fused_ws = [_fused_qkv_weight(lp["attn"], tile) for lp in layers] \
        if fuse_qkv else []
    fuse_now = fuse_qkv and all(w is not None for w in fused_ws)
    if fuse_now:
        by_id = {id(lp): w for lp, w in zip(layers, fused_ws)}
        specs.append(("attn", "wqkv", lambda lp: by_id[id(lp)], "wq"))
    else:
        specs += [("attn", proj, (lambda lp, _p=proj: _get_w(lp["attn"][_p])),
                   proj) for proj in _QKV]
    specs.append(("attn", "wo", lambda lp: _get_w(lp["attn"]["wo"]), "wo"))
    if include_ffn:
        specs += [("ffn", proj, (lambda lp, _p=proj: _get_w(lp["ffn"][_p])),
                   proj) for proj in ("wi", "wo")]

    for group, name, getw, src in specs:
        tgt = attn_new if group == "attn" else ffn_new
        dtypes = [lp[group][src]["w"].dtype for lp in layers]
        if cross_layer_union:
            stacked = np.stack([getw(lp) for lp in layers])
            pack, data, union_st = pack_stacked(stacked, tile)
            if backend_chooser is not None:
                choice = backend_chooser(pack)
                union_st = dict(union_st)
                union_st["autotune"] = {"backend": choice.backend,
                                        "cache_hit": choice.cache_hit,
                                        "mode": choice.mode}
                pk, vals = _realize_backend(pack, data, choice.backend,
                                            registry, device)
                shared = [pk] * n_layers
            elif use_plans:
                # one lookup per layer: the registry's hit counters then show
                # the (L-1)-fold reuse of the single unioned plan
                shared = [plan_for_pack(pack, registry)
                          for _ in range(n_layers)]
                vals = pack_plan_data(shared[0], torch.from_numpy(
                    np.ascontiguousarray(data)).to(device))
            else:
                raise NotImplementedError(
                    f"backend 'bsr' comes with {_ITEM_BSR}")
            if stats_out is not None:
                stats_out[f"{group}/{name}"] = union_st
            for i in range(n_layers):
                packs[f"layers/{i}/{group}/{name}"] = shared[i]
                tgt[i][name] = _param_entry_layer(vals, i, dtypes[i])
        else:
            for i, lp in enumerate(layers):
                pk, vals, meta = _serving_pack(getw(lp), tile, use_plans,
                                               registry, device,
                                               backend_chooser)
                if stats_out is not None and meta:
                    stats_out[f"layers/{i}/{group}/{name}"] = {
                        "union_nnzt": _pack_nnzt(pk), "autotune": meta}
                packs[f"layers/{i}/{group}/{name}"] = pk
                tgt[i][name] = _param_entry(vals, dtypes[i])

    if fuse_now:
        for i, ap in enumerate(attn_new):
            if f"layers/{i}/attn/wqkv" in packs:
                for proj in _QKV:
                    del ap[proj]

    new_layers = []
    for i, lp in enumerate(layers):
        nlp = dict(lp)
        nlp["attn"] = attn_new[i]
        if include_ffn:
            nlp["ffn"] = ffn_new[i]
        new_layers.append(nlp)
    new = dict(params)
    new["layers"] = tuple(new_layers)
    return new, packs


def export_params(params, cfg: ModelConfig, tile=(128, 128), *,
                  fuse_qkv: bool = True, cross_layer_union: bool = True,
                  include_ffn: bool = True, use_plans: bool = True,
                  registry: Optional[PatternRegistry] = None,
                  backend_chooser=None, device=None):
    """Export a model's param tree to serving form. Returns
    ``(sparse_params, packs, stats)``; this slice exports the bert family."""
    if cfg.family != "bert":
        raise NotImplementedError(
            f"export of family {cfg.family!r} comes with {_ITEM_LM}")
    stats: Dict[str, Dict] = {}
    sparse_params, packs = export_bert_sparse(
        params, cfg, tile=tile, include_ffn=include_ffn, fuse_qkv=fuse_qkv,
        cross_layer_union=cross_layer_union, use_plans=use_plans,
        registry=registry, stats_out=stats, backend_chooser=backend_chooser,
        device=device)
    return sparse_params, packs, stats
