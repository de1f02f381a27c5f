"""Block-magnitude pruning (paper §2.1): the gradual training schedule and
the one-shot serving-side recipes.

Counterpart of ``repro/core/pruner.py``: the cubic schedule with its mask
state (``cubic_sparsity``, ``init_masks``, ``update_masks``,
``apply_masks``, ``sparsity_report``) and ``oneshot_prune`` (independent
per-leaf masks) / ``tied_prune`` (one mask per projection group across
layers). Path names and group order follow the reference's tree walk
(:mod:`repro_torch.core.tree`), and the schedule and the quantile threshold
are computed in fp32 as the reference computes them, so the same weights
give the same masks.
"""
from __future__ import annotations

from typing import Dict

import torch

import numpy as np

from repro_torch.core.sparsity import (SparsityConfig, apply_block_mask,
                                       block_norms, block_partials,
                                       expand_block_mask, local_of_grid,
                                       reduce_grids, topk_block_mask,
                                       topk_flat_mask)
from repro_torch.core.tree import (flatten_with_path, map_with_path,
                                   path_name, unflatten)


def _prunable(cfg: SparsityConfig, name: str, leaf) -> bool:
    """2-D weights and scan-stacked (L, out, in) 3-D weights are prunable."""
    if leaf.ndim not in (2, 3) or not cfg.applies_to(name):
        return False
    bh, bw = cfg.block_shape
    return leaf.shape[-2] % bh == 0 and leaf.shape[-1] % bw == 0


def cubic_sparsity(step: int, cfg: SparsityConfig) -> float:
    """Zhu & Gupta cubic ramp s(t) = s_f * (1 - (1 - t_norm)^3), clipped;
    computed in fp32 as the reference does."""
    span = max(1, cfg.end_step - cfg.start_step)
    t = np.float32(np.clip((step - cfg.start_step) / span, 0.0, 1.0))
    u = np.float32(1.0) - t
    return float(np.float32(cfg.sparsity) * (np.float32(1.0) - u * u * u))


def _per_layer(fn, leaf, *rest):
    """Apply a 2-D-weight function to a 2-D or layer-stacked 3-D leaf."""
    if leaf.ndim == 2:
        return fn(leaf, *rest)
    return torch.stack([fn(*args) for args in zip(leaf, *rest)])


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile`` (linear) of a flat tensor, in fp32 step by step."""
    a = torch.sort(x.float()).values
    n = a.numel()
    qn = torch.tensor(q, dtype=torch.float32) * np.float32(n - 1)
    low, high = torch.floor(qn), torch.ceil(qn)
    hw = qn - low
    lw = 1.0 - hw
    lo = int(min(max(low.item(), 0), n - 1))
    hi = int(min(max(high.item(), 0), n - 1))
    return a[lo] * lw.to(a.device) + a[hi] * hw.to(a.device)


def _mask_at(masks, path):
    node = masks
    for k in path:
        if node is None:
            return None
        node = node[k]
    return node


def init_masks(params, cfg: SparsityConfig):
    """All-ones block masks for every prunable leaf, None elsewhere;
    layer-stacked leaves get per-layer masks (L, nbr, nbc)."""
    bh, bw = cfg.block_shape

    def one(path, leaf):
        if not _prunable(cfg, path_name(path), leaf):
            return None
        shape = tuple(leaf.shape[:-2]) + (leaf.shape[-2] // bh,
                                          leaf.shape[-1] // bw)
        return torch.ones(shape, dtype=torch.bool, device=leaf.device)
    return map_with_path(one, params)


def whole_block_norms(items, block_shape, ord: int):
    """[(leaf, shard)] -> each leaf's whole block norms (..., R/bh, C/bw)
    in fp32. A leaf without a shard is whole (``block_norms`` layer by
    layer); a rank's shard (``launch.sharding.LeafShard``) gives partial
    sums of the norm's own kind -- squares for ``ord`` 2, |w| for 1 --
    reduced over the axes that cut it (one collective an axis for all the
    leaves), so every rank holds every whole grid."""
    grids, shards = [], []
    for leaf, sh in items:
        if sh is None:
            grids.append(_per_layer(lambda w: block_norms(
                w.float(), block_shape, ord), leaf))
        else:
            grids.append(block_partials(leaf, block_shape, ord,
                                        sh.offsets, sh.shape))
        shards.append(sh)
    grids = reduce_grids(grids, shards)
    return [g.sqrt() if sh is not None and ord == 2 else g
            for g, sh in zip(grids, shards)]


def update_masks(params, masks, step: int, cfg: SparsityConfig,
                 shards=None):
    """Recompute block masks at the scheduled sparsity for this step: a
    block is kept where its norm exceeds the target quantile of its leaf's
    block norms. ``shards`` (path -> ``LeafShard``; the mesh Trainer)
    marks leaves this rank holds a shard of: their whole block norms come
    from reduced partials, so every rank builds the same whole mask."""
    target = cubic_sparsity(step, cfg)
    shards = shards or {}
    todo = [(path, leaf) for path, leaf in flatten_with_path(params)
            if _mask_at(masks, path) is not None]
    norms = whole_block_norms([(leaf, shards.get(path))
                               for path, leaf in todo], cfg.block_shape,
                              cfg.group_norm_ord)
    new = {path: _per_layer(lambda n: n > _quantile(n.reshape(-1), target),
                            g) for (path, _), g in zip(todo, norms)}
    return map_with_path(lambda path, _: new.get(path), params)


def apply_masks(params, masks, cfg: SparsityConfig, shards=None):
    """Zero out masked blocks (keeps pruned weights dead after the optimizer
    step). A leaf with a shard in ``shards`` takes its slice of the whole
    mask: each local element reads its global block."""
    shards = shards or {}

    def app(path, leaf):
        mask = _mask_at(masks, path)
        if mask is None:
            return leaf
        sh = shards.get(path)
        if sh is not None:
            keep = local_of_grid(mask, cfg.block_shape, sh.offsets,
                                 tuple(leaf.shape))
            return leaf * keep.to(leaf.dtype)
        return _per_layer(lambda w, m: apply_block_mask(w, m, cfg.block_shape),
                          leaf, mask)
    return map_with_path(app, params)


def sparsity_report(params, cfg: SparsityConfig, shards=None
                    ) -> Dict[str, float]:
    """Per-target actual block sparsity (mean over a stack's layers), of
    the whole leaf where ``shards`` holds the rank's shard of it."""
    shards = shards or {}
    todo = [(path, leaf) for path, leaf in flatten_with_path(params)
            if _prunable(cfg, path_name(path), _whole_like(
                leaf, shards.get(path)))]
    norms = whole_block_norms([(leaf, shards.get(path))
                               for path, leaf in todo], cfg.block_shape, 1)
    return {path_name(path): float((g == 0).float().mean(dim=(-2, -1))
                                   .mean())
            for (path, _), g in zip(todo, norms)}


def _whole_like(leaf, shard):
    """``leaf`` or, for a shard, a meta tensor of the whole leaf's shape
    (what ``_prunable`` reads)."""
    if shard is None:
        return leaf
    return torch.empty(shard.shape, dtype=leaf.dtype, device="meta")


def oneshot_prune(params, cfg: SparsityConfig):
    """One-shot prune to the target ratio. Returns (params, masks); masks
    hold a block mask per prunable leaf and None elsewhere."""
    def p2(leaf):
        mask = topk_block_mask(leaf.float(), cfg.block_shape, cfg.sparsity,
                               cfg.group_norm_ord)
        return apply_block_mask(leaf, mask, cfg.block_shape), mask

    def pr(path, leaf):
        if not _prunable(cfg, path_name(path), leaf):
            return leaf, None
        if leaf.ndim == 2:
            return p2(leaf)
        outs = [p2(layer) for layer in leaf]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    pairs = [pr(path, leaf) for path, leaf in flatten_with_path(params)]
    return (unflatten(params, [p[0] for p in pairs]),
            unflatten(params, [p[1] for p in pairs]))


def tie_group(name: str) -> str:
    """Tie key of a param path: layer indices are wildcarded so all layers of
    a stack score against one shared mask ('layers/[3]/attn/wq/w' ->
    'layers/*/attn/wq/w')."""
    return "/".join("*" if tok.strip("[]").isdigit() else tok
                    for tok in name.split("/"))


def tied_prune(params, cfg: SparsityConfig):
    """One-shot prune with ONE block mask shared across all layers of each
    projection group. Block scores are the float32 mean block norm over the
    group's members in flatten order (and over the layer axis of stacked
    leaves); members whose shape differs from the rest of their group fall
    back to an independent mask. Returns (params, masks)."""
    flat = flatten_with_path(params)
    names = [path_name(path) for path, _ in flat]
    leaves = [leaf for _, leaf in flat]

    groups: Dict[str, list] = {}
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        if _prunable(cfg, name, leaf):
            groups.setdefault(tie_group(name), []).append(i)
    for key in list(groups):
        shapes = {tuple(leaves[i].shape[-2:]) for i in groups[key]}
        if len(shapes) > 1:      # heterogeneous group: untie its members
            for i in groups.pop(key):
                groups[names[i]] = [i]

    def member_norms(leaf):
        if leaf.ndim == 2:
            return block_norms(leaf.float(), cfg.block_shape,
                               cfg.group_norm_ord)
        return torch.stack([block_norms(layer.float(), cfg.block_shape,
                                        cfg.group_norm_ord)
                            for layer in leaf]).mean(dim=0)

    new_leaves = list(leaves)
    mask_leaves = [None] * len(leaves)
    for idxs in groups.values():
        norms = torch.stack([member_norms(leaves[i]) for i in idxs]).mean(
            dim=0)
        keep = max(1, int(round(norms.numel() * (1.0 - cfg.sparsity))))
        mask = topk_flat_mask(norms, keep)
        expand = expand_block_mask(mask, cfg.block_shape).float()
        for i in idxs:
            leaf = leaves[i]
            new_leaves[i] = (leaf.float() * expand).to(leaf.dtype)
            mask_leaves[i] = (mask if leaf.ndim == 2 else mask.expand(
                tuple(leaf.shape[:-2]) + tuple(mask.shape)))
    return unflatten(params, new_leaves), unflatten(params, mask_leaves)
