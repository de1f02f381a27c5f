"""One-shot block-magnitude pruning (paper §2.1), serving-side recipes.

Counterpart of the one-shot part of ``repro/core/pruner.py``: ``oneshot_prune``
(independent per-leaf masks) and ``tied_prune`` (one mask per projection
group across layers). Path names and group order follow the reference's tree
walk (:mod:`repro_torch.core.tree`), so the same weights give the same masks.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.sparsity import (SparsityConfig, apply_block_mask,
                                       block_norms, expand_block_mask,
                                       topk_block_mask, topk_flat_mask)
from repro_torch.core.tree import flatten_with_path, path_name, unflatten


def _prunable(cfg: SparsityConfig, name: str, leaf) -> bool:
    """2-D weights and scan-stacked (L, out, in) 3-D weights are prunable."""
    if leaf.ndim not in (2, 3) or not cfg.applies_to(name):
        return False
    bh, bw = cfg.block_shape
    return leaf.shape[-2] % bh == 0 and leaf.shape[-1] % bw == 0


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
