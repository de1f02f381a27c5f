"""BSR export for the BERT encoder and the LMs (the TVM relay-conversion
analogue).

Counterpart of ``repro/serving/export.py`` (bert and lm passes; the lm pass
serves the dense, vlm, moe, ssm and hybrid families and packs only the
``attn`` and ``ffn`` subtrees: MoE expert weights are raw (E, d, f) arrays
and stay unpacked, an MLA layer packs ``wq`` and ``wo``, the SSM and RG-LRU
mixers' projections stay dense matmuls; the audio family exports nothing
and serves dense). Training
keeps dense weights; serving packs the pruned projections into tile-granular
BSR patterns (byte-identical to the reference) and lowers each pattern to a
:class:`~repro_torch.kernels.exec_plan.RowPackPlan`, storing the tile values
already row-grouped on the serving device. The BERT pass packs on the host
in numpy; the LM pass computes each tile mask where the weights live and
brings only the mask to the host, gathering the tile values on the device,
so a full-width model never crosses to the host. Two pattern-level
optimizations happen here, offline:

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
from repro_torch.kernels.bsr_matmul import (KernelBSR, pack_bsr,
                                            pattern_from_mask)
from repro_torch.kernels.autotune import (BackendChoice, dense_from_pack,
                                         masked_pack_from)
from repro_torch.kernels.exec_plan import (PlanChoice, QuantPlan,
                                           build_sharded_plan,
                                           dequantize_plan_values,
                                           pack_plan_data, plan_for_pack,
                                           quantize_for_plan,
                                           shard_divisible)

_QKV = ("wq", "wk", "wv")
_ATTN_PROJS = ("wq", "wk", "wv", "wo")
_FFN_PROJS = ("wi", "wg", "wo")


def shard_axis_for(proj: str) -> str:
    """Tensor-parallel axis per projection, mirroring the dense rules of
    ``launch/sharding.spec_for_param``: ``wo`` (attention out-proj and MLP
    down-proj) is row-parallel -- sharded by input block cols, partials
    summed -- everything else (wq/wk/wv/wqkv/wi/wg) is column-parallel,
    sharded by output block rows."""
    return "in" if proj == "wo" else "out"

# families whose param tree follows the lm.py prefix/blocks/suffix layout
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _tile_masks(w: torch.Tensor, tile) -> torch.Tensor:
    """(..., N, K) weight -> (..., N/bn, K/bk) bool: tiles holding a nonzero."""
    lead = tuple(w.shape[:-2])
    n, k = w.shape[-2:]
    bn, bk = tile
    return (w.reshape(lead + (n // bn, bn, k // bk, bk)) != 0).any(
        dim=-1).any(dim=-2)


def pack_stacked(w_stacked, tile) -> Tuple[KernelBSR, torch.Tensor, Dict]:
    """(N, K) or layer-stacked (L, N, K) weight (numpy or tensor) -> (union
    pattern pack, per-layer tile values (..., nnzt, bn, bk) where the
    weight lives, union stats). The pattern is the reference's: the union
    over layers of the nonzero tiles, with :func:`pattern_from_mask`'s
    empty row / column fix-ups. Only the tile mask visits the host, so a
    weight on the card stays there."""
    w = torch.as_tensor(w_stacked)
    lead = tuple(w.shape[:-2])
    n, k = w.shape[-2:]
    bn, bk = tile
    masks = _tile_masks(w, tile)
    flat = masks.reshape((-1,) + tuple(masks.shape[-2:]))
    union = flat.any(dim=0)
    pack, rows, cols = pattern_from_mask(union.cpu().numpy(), (n, k), tile)
    blocks = w.reshape(lead + (n // bn, bn, k // bk, bk)).transpose(-3, -2)
    data = blocks[..., torch.from_numpy(rows).to(w.device),
                  torch.from_numpy(cols).to(w.device), :, :]
    per_layer = flat.sum(dim=(1, 2)).double().cpu().numpy()
    n_union = int(union.sum())
    stats = {"union_nnzt": n_union,
             "mean_layer_nnzt": float(per_layer.mean()),
             "union_overhead": float(n_union / max(per_layer.mean(), 1.0))}
    return pack, data, stats


def pack_single(w: np.ndarray, tile) -> Tuple[KernelBSR, np.ndarray]:
    pack = pack_bsr(w, tile)
    return pack, pack.data


def _realize_backend(pack, data, backend: str,
                     registry: Optional[PatternRegistry], device,
                     quant: str = "none", shard=None, shard_stats=None):
    """(pattern, packed values (numpy or tensor), chosen backend) -> (static
    pack stored in ``packs``, values on ``device`` for the params tree).
    ``data`` is ``(nnzt, bn, bk)`` or layer-stacked ``(L, nnzt, bn, bk)``.

      * ``plan``        -> RowPackPlan + row-grouped values (served by the
        plain composition); with ``shard = (n_shards, axis)`` and a
        divisible pattern, a :class:`~repro_torch.kernels.exec_plan.
        ShardedPlan` whose vrow axis shards over the mesh "model" axis
        (indivisible patterns keep the replicated plan, the
        ``spec_for_param`` divisibility rule);
      * ``plan_pallas`` -> the same layout in a PlanChoice pinning every call
        to kernel K1 (no sharded form: a sharded plan serves through the
        plain composition);
      * ``bsr``         -> the bare KernelBSR pattern, its values kept on the
        device (``ops.bsr_matmul``'s default backend: K4 on the card);
      * ``gather`` / ``rowpack`` / ``pallas`` -> the pattern pinned to that
        ``bsr_linear`` backend (``autotune.BackendChoice``);
      * ``masked``      -> the densified weight + static tile mask
        (``autotune.MaskedPack``, kernel K7), per layer when stacked;
      * ``dense``       -> ``(None, None)``: the caller keeps the original
        dense weight and stores no pack.

    ``quant != 'none'`` (spec ``pack_quant``) quantizes the plan-layout
    backends into a QuantPlan with a ``{"w": qvalues, "scale": scales}``
    entry ('plan_pallas' = kernel K6); ``plan_q8`` / ``plan_pallas_q8`` are
    the autotune verdict names for the same int8 layouts."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    data = data.to(device)
    if backend in ("plan", "plan_q8", "plan_pallas", "plan_pallas_q8"):
        kernel = backend.startswith("plan_pallas")
        if not kernel and shard is not None and shard[0] > 1 \
                and shard_divisible(pack, shard[0], shard[1]):
            # built (not combined-cached) per call so identical layers
            # still count per-shard registry hits; plans stay shared
            # downstream through fingerprint hash / eq
            plan = build_sharded_plan(pack, shard[0], shard[1],
                                      registry=registry,
                                      shard_stats=shard_stats)
        else:
            plan = plan_for_pack(pack, registry)
        if backend.endswith("_q8") or quant != "none":
            return quantize_for_plan(plan, data,
                                     quant if quant != "none" else "int8",
                                     backend="plan_pallas" if kernel
                                     else "plan")
        vals = pack_plan_data(plan, data)
        return (PlanChoice(plan) if kernel else plan), vals
    if backend == "bsr":
        return pack, data
    if backend == "dense":
        return None, None
    if backend == "masked":
        return masked_pack_from(pack), dense_from_pack(pack, data)
    if backend in ("gather", "rowpack", "pallas"):
        return BackendChoice(pack, backend), data
    raise ValueError(f"unknown serving backend {backend!r}")


def _effective_shard(pack, shard):
    """The shard config this pack actually serves under: None unless a mesh
    is asked for and the pattern divides (keeps the autotune key and
    candidate set honest for replicated packs)."""
    if shard is not None and shard[0] > 1 and shard_divisible(pack, *shard):
        return shard
    return None


def _choose(chooser, pack, shard):
    """Call a backend chooser, passing ``shard=`` only when this pack
    really shards (single-argument choosers keep working unsharded)."""
    return chooser(pack) if shard is None else chooser(pack, shard=shard)


def _quant_meta(pk, vals, data) -> Optional[Dict]:
    """Export-time quantization round-trip accounting for a QuantPlan pack:
    max abs dequant error over the stored tiles, absolute and relative to
    the pack's value range (surfaced by ``Servable.stats()`` and the
    engine's ``stats_dict()``)."""
    if not isinstance(pk, QuantPlan):
        return None
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    ref = pack_plan_data(pk.plan, data.to(vals["w"].device)).float()
    deq = dequantize_plan_values(vals["w"], vals["scale"])
    err = float((deq - ref).abs().max())
    amax = float(ref.abs().max())
    return {"qdtype": pk.qdtype, "granularity": pk.granularity,
            "max_abs_err": err,
            "rel_err": err / amax if amax > 0 else 0.0}


def _serving_pack(w: np.ndarray, tile, use_plans: bool,
                  registry: Optional[PatternRegistry], device, chooser=None,
                  quant: str = "none", shard=None, shard_stats=None):
    """(N, K) weight -> (static pattern, values, chooser / quant meta)."""
    pack = pack_bsr(w, tile)
    shard = _effective_shard(pack, shard)
    if chooser is None:
        pk, vals = _realize_backend(pack, pack.data,
                                    "plan" if use_plans else "bsr", registry,
                                    device, quant, shard, shard_stats)
        qmeta = _quant_meta(pk, vals, pack.data)
        return pk, vals, {"quant": qmeta} if qmeta else None
    choice = _choose(chooser, pack, shard)
    pk, vals = _realize_backend(pack, pack.data, choice.backend, registry,
                                device, quant, shard, shard_stats)
    meta = {"backend": choice.backend,
            "cache_hit": choice.cache_hit, "mode": choice.mode}
    qmeta = _quant_meta(pk, vals, pack.data)
    if qmeta:
        meta["quant"] = qmeta
    return pk, vals, meta


def _param_entry(vals, dtype) -> Dict:
    """Params-tree entry for a pack's serving values. Quantized packs come
    as a ``{"w", "scale"}`` dict whose leaves keep their own dtypes (int8 /
    fp8 values, fp32 scales); everything else is ``{"w": values}`` in the
    model dtype."""
    if isinstance(vals, dict):
        return dict(vals)
    return {"w": vals.to(dtype)}


def _param_entry_layer(vals, i: int, dtype) -> Dict:
    """Per-layer slice of stacked serving values."""
    if isinstance(vals, dict):
        return {k: v[i] for k, v in vals.items()}
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


def _pack_nnzt(pk) -> Optional[int]:
    """Stored-tile count of any static pack kind (plan / quant / bsr /
    choice / masked), for the per-scope export stats."""
    if pk is None:
        return None
    inner = getattr(pk, "pack", pk)             # BackendChoice wraps a BSR
    inner = getattr(inner, "plan", inner)       # PlanChoice wraps a plan
    if hasattr(inner, "real_nnzt"):
        return int(inner.real_nnzt)
    return int(np.sum(inner.tile_mask))


def export_bert_sparse(params, cfg: ModelConfig, tile=(64, 64),
                       include_ffn=True, *, fuse_qkv: bool = True,
                       cross_layer_union: bool = False,
                       use_plans: bool = True,
                       registry: Optional[PatternRegistry] = None,
                       stats_out: Optional[Dict] = None,
                       backend_chooser=None, pack_quant: str = "none",
                       device=None, n_shards: int = 1):
    """BSR export for the unrolled BERT encoder. Returns (sparse_params,
    packs); ``packs`` maps 'layers/<i>/<group>/<name>' to its static pack
    (a plan by default, a bare KernelBSR with ``use_plans=False``, the
    chooser's verdict with ``backend_chooser``; quantized with
    ``pack_quant``; tensor-parallel ShardedPlans with ``n_shards > 1``).
    ``stats_out`` is filled with the per-group union, autotune and
    quantization stats (and ``'__sharding__'``). Values land on ``device``
    (default: where the weights are)."""
    layers = params["layers"]
    n_layers = len(layers)
    if device is None:
        device = layers[0]["attn"]["wo"]["w"].device
    packs: Dict[str, object] = {}
    shard_stats: Dict[int, Dict] = {}
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
        shard = (n_shards, shard_axis_for(name)) if n_shards > 1 else None
        if cross_layer_union:
            stacked = np.stack([getw(lp) for lp in layers])
            pack, data, union_st = pack_stacked(stacked, tile)
            shard_eff = _effective_shard(pack, shard)
            if backend_chooser is not None:
                choice = _choose(backend_chooser, pack, shard_eff)
                union_st = dict(union_st)
                union_st["autotune"] = {"backend": choice.backend,
                                        "cache_hit": choice.cache_hit,
                                        "mode": choice.mode}
                pk, vals = _realize_backend(pack, data, choice.backend,
                                            registry, device, pack_quant,
                                            shard_eff, shard_stats)
                qmeta = _quant_meta(pk, vals, data)
                if qmeta:
                    union_st["quant"] = qmeta
                shared = [pk] * n_layers
            elif use_plans and pack_quant != "none":
                pk, vals = _realize_backend(pack, data, "plan", registry,
                                            device, pack_quant, shard_eff,
                                            shard_stats)
                qmeta = _quant_meta(pk, vals, data)
                if qmeta:
                    union_st = dict(union_st, quant=qmeta)
                shared = [pk] * n_layers
            elif use_plans:
                # one lookup per layer: the registry's hit counters (global
                # and per shard) then show the (L-1)-fold reuse of the
                # single unioned plan
                if shard_eff is not None:
                    shared = [build_sharded_plan(pack, *shard_eff,
                                                 registry=registry,
                                                 shard_stats=shard_stats)
                              for _ in range(n_layers)]
                else:
                    shared = [plan_for_pack(pack, registry)
                              for _ in range(n_layers)]
                vals = pack_plan_data(shared[0], data.to(device))
            else:
                shared = [pack] * n_layers
                vals = data.to(device)
            if stats_out is not None:
                stats_out[f"{group}/{name}"] = union_st
            if shared[0] is None:       # measured dense: weights untouched
                continue
            for i in range(n_layers):
                packs[f"layers/{i}/{group}/{name}"] = shared[i]
                tgt[i][name] = _param_entry_layer(vals, i, dtypes[i])
        else:
            for i, lp in enumerate(layers):
                pk, vals, meta = _serving_pack(getw(lp), tile, use_plans,
                                               registry, device,
                                               backend_chooser, pack_quant,
                                               shard, shard_stats)
                if stats_out is not None and meta:
                    st = {"union_nnzt": _pack_nnzt(pk)}
                    qmeta = meta.pop("quant", None)
                    if qmeta:
                        st["quant"] = qmeta
                    if meta:
                        st["autotune"] = meta
                    stats_out[f"layers/{i}/{group}/{name}"] = st
                if pk is None:          # measured dense: weight untouched
                    continue
                packs[f"layers/{i}/{group}/{name}"] = pk
                tgt[i][name] = _param_entry(vals, dtypes[i])

    if fuse_now:
        # drop the per-projection weights only where the fused pack was
        # exported (a 'dense' verdict keeps them)
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
    if n_shards > 1 and stats_out is not None:
        stats_out["__sharding__"] = {"n_shards": n_shards,
                                     "per_shard": shard_stats}
    new = dict(params)
    new["layers"] = tuple(new_layers)
    return new, packs


# --------------------------------------------------------------------------
# LM pass
# --------------------------------------------------------------------------

def _is_sparse(w: torch.Tensor, tile) -> bool:
    """True iff the (stacked-union) tile occupancy is < 100%: packing a
    dense projection only adds padding and gather overhead."""
    masks = _tile_masks(w, tile)
    return not bool(masks.reshape((-1,) + tuple(masks.shape[-2:])).any(
        dim=0).all())


def export_lm_sparse(params, cfg: ModelConfig, tile=(128, 128), *,
                     fuse_qkv: bool = True, use_plans: bool = True,
                     include_ffn: bool = True,
                     registry: Optional[PatternRegistry] = None,
                     backend_chooser=None, pack_quant: str = "none",
                     device=None, n_shards: int = 1):
    """Replace attention (and pruned dense-MLP) projections of an LM param
    tree with packed values.

    Returns (sparse_params, packs, stats): ``packs`` maps layer scopes
    ('blocks/<i>/attn/wqkv', 'suffix/<i>/ffn/wo', ...) to static packs.
    Period-stacked layer groups are union-packed (one pattern, per-period
    values, stacked on the period axis); with ``fuse_qkv`` the q/k/v
    projections share one fused pack per group. With ``include_ffn`` the
    dense-MLP projections are exported too, but only when they are actually
    block-sparse at the kernel tile. ``backend_chooser`` overrides the
    representation per pattern (a 'dense' verdict keeps the original
    weight); ``pack_quant`` quantizes the plan layouts. ``n_shards > 1``
    (the mesh "model" axis size) exports every plan pack in tensor-parallel
    sharded form (:func:`shard_axis_for` per projection; indivisible
    patterns stay replicated) and records the per-shard registry counts
    under ``stats['__sharding__']``. The export walks the tree projection
    by projection, so at most one projection's temporaries are alive."""
    if device is None:
        device = params["embed"]["w"].device
    packs: Dict[str, object] = {}
    stats: Dict[str, Dict] = {}
    shard_stats: Dict[int, Dict] = {}

    def export_one(w, scope, stacked, dtype):
        """Pack one weight (single or period-stacked), record its stats and
        register the pack; None when the pattern serves dense."""
        pack, data, st = pack_stacked(w, tile)
        proj = scope.rsplit("/", 1)[1]
        shard = _effective_shard(
            pack, (n_shards, shard_axis_for(proj)) if n_shards > 1 else None)
        backend = "plan" if use_plans else "bsr"
        meta = None
        if backend_chooser is not None:
            choice = _choose(backend_chooser, pack, shard)
            backend = choice.backend
            meta = {"backend": choice.backend,
                    "cache_hit": choice.cache_hit, "mode": choice.mode}
        pk, vals = _realize_backend(pack, data, backend, registry, device,
                                    pack_quant, shard, shard_stats)
        if not stacked:
            st = {"union_nnzt": _pack_nnzt(pk)}
        if meta:
            st = dict(st, autotune=meta)
        qmeta = _quant_meta(pk, vals, data)
        if qmeta:
            st = dict(st, quant=qmeta)
        stats[scope] = st
        if pk is None:
            return None
        packs[scope] = pk
        return _param_entry(vals, dtype)

    def export_attn(lp, scope, stacked):
        if "attn" not in lp:
            return lp
        ap = dict(lp["attn"])
        projs = list(_ATTN_PROJS)
        if fuse_qkv and all(proj in ap for proj in _QKV) and all(
                _divisible(ap[proj]["w"].shape, tile) for proj in _QKV):
            w_qkv = torch.cat([ap[proj]["w"] for proj in _QKV],
                              dim=1 if stacked else 0)
            fused = export_one(w_qkv, f"{scope}/wqkv", stacked,
                               ap["wq"]["w"].dtype)
            del w_qkv
            if fused is not None:
                ap["wqkv"] = fused
                for proj in _QKV:
                    del ap[proj]
            projs = ["wo"]          # measured dense: wq/wk/wv stay, unfused
        for proj in projs:
            if proj in ap and _divisible(ap[proj]["w"].shape, tile):
                vals = export_one(ap[proj]["w"], f"{scope}/{proj}", stacked,
                                  ap[proj]["w"].dtype)
                if vals is not None:
                    ap[proj] = vals
        return dict(lp, attn=ap)

    def export_ffn(lp, scope, stacked):
        if "ffn" not in lp or not isinstance(lp["ffn"].get("wi"), dict):
            return lp
        fp = dict(lp["ffn"])
        for proj in _FFN_PROJS:
            if proj not in fp:
                continue
            w = fp[proj]["w"]
            if _divisible(w.shape, tile) and _is_sparse(w, tile):
                vals = export_one(w, f"{scope}/{proj}", stacked, w.dtype)
                if vals is not None:
                    fp[proj] = vals
        return dict(lp, ffn=fp)

    def export_layer(lp, scope, stacked):
        lp = export_attn(lp, f"{scope}/attn", stacked)
        if include_ffn:
            lp = export_ffn(lp, f"{scope}/ffn", stacked)
        return lp

    new = dict(params)
    new["prefix"] = tuple(export_layer(lp, f"prefix/{i}", False)
                          for i, lp in enumerate(params["prefix"]))
    new["blocks"] = tuple(export_layer(lp, f"blocks/{i}", True)
                          for i, lp in enumerate(params["blocks"]))
    new["suffix"] = tuple(export_layer(lp, f"suffix/{i}", False)
                          for i, lp in enumerate(params["suffix"]))
    if n_shards > 1:
        stats["__sharding__"] = {"n_shards": n_shards,
                                 "per_shard": shard_stats}
    return new, packs, stats


def export_params(params, cfg: ModelConfig, tile=(128, 128), *,
                  fuse_qkv: bool = True, cross_layer_union: bool = True,
                  include_ffn: bool = True, use_plans: bool = True,
                  registry: Optional[PatternRegistry] = None,
                  backend_chooser=None, pack_quant: str = "none",
                  device=None, n_shards: int = 1):
    """Export a model's param tree to serving form. Returns
    ``(sparse_params, packs, stats)``: bert through
    :func:`export_bert_sparse`, the LM families (``LM_FAMILIES``) through
    :func:`export_lm_sparse` (its stacked groups always union-pack); audio
    is returned as it is with no packs (the enc-dec forward has no packs
    route) and ``stats`` records why. ``n_shards`` (the mesh "model" axis
    size) selects tensor-parallel sharded export."""
    if cfg.family == "bert":
        stats: Dict[str, Dict] = {}
        sparse_params, packs = export_bert_sparse(
            params, cfg, tile=tile, include_ffn=include_ffn,
            fuse_qkv=fuse_qkv, cross_layer_union=cross_layer_union,
            use_plans=use_plans, registry=registry, stats_out=stats,
            backend_chooser=backend_chooser, pack_quant=pack_quant,
            device=device, n_shards=n_shards)
        return sparse_params, packs, stats
    if cfg.family in LM_FAMILIES:
        return export_lm_sparse(params, cfg, tile=tile, fuse_qkv=fuse_qkv,
                                use_plans=use_plans, include_ffn=include_ffn,
                                registry=registry,
                                backend_chooser=backend_chooser,
                                pack_quant=pack_quant, device=device,
                                n_shards=n_shards)
    if cfg.family == "audio":
        return params, {}, {"__unsupported__": {
            "family": cfg.family,
            "reason": "enc-dec forward has no packs route; serving dense"}}
    raise ValueError(f"unknown model family {cfg.family!r}")
