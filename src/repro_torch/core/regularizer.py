"""Group-lp regularization (paper Eq. 1-3) and its proximal operator.

Counterpart of ``repro/core/regularizer.py``:

  * ``group_penalty``  -- sum over blocks of ||w_block||_p (p in {1, 2}; p=2
    is the group lasso that drives *whole blocks* to zero, p=1 the
    elementwise lasso, the paper's "irregular sparsity" control arm);
  * ``group_prox``     -- blockwise soft-threshold (the prox of
    lambda * sum ||.||_2), applied after the gradient update (ISTA-style).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sparsity import (block_norms, block_partials,
                                       reduce_grids)
from repro_torch.core.tree import flatten_with_path, path_name


def group_penalty(w: torch.Tensor, block_shape: Tuple[int, int],
                  p: int = 2) -> torch.Tensor:
    """sum_b ||w_b||_p over the block partition of a 2-D weight."""
    if p == 1:
        return w.abs().sum()      # the block partition is irrelevant for l1
    if p == 2:
        return block_norms(w, block_shape, ord=2).sum()
    raise ValueError(f"p={p} not supported")


def tree_group_penalty(params, block_shape: Tuple[int, int], p: int,
                       applies, shards=None) -> torch.Tensor:
    """Sum ``group_penalty`` over every 2-D (or layer-stacked 3-D) leaf whose
    path satisfies ``applies``; fp32. ``shards`` (path -> ``LeafShard``,
    the mesh Trainer) marks leaves held as a rank's shard: their whole
    leaf's penalty comes from partial sums reduced over the axes that cut
    them (every rank gets the same total)."""
    if shards:
        return _sharded_penalty(params, block_shape, p, applies, shards)
    total = None
    bh, bw = block_shape
    for path, leaf in flatten_with_path(params):
        if leaf.ndim in (2, 3) and applies(path_name(path)):
            if leaf.shape[-2] % bh == 0 and leaf.shape[-1] % bw == 0:
                w2 = leaf.float()
                layers = w2 if leaf.ndim == 3 else w2[None]
                for layer in layers:
                    term = group_penalty(layer, block_shape, p)
                    total = term if total is None else total + term
    if total is None:
        dev = next((leaf.device for _, leaf in flatten_with_path(params)),
                   None)
        return torch.zeros((), dtype=torch.float32, device=dev)
    return total


def _sharded_penalty(params, block_shape, p, applies, shards):
    bh, bw = block_shape
    grids, owners = [], []
    for path, leaf in flatten_with_path(params):
        sh = shards.get(path)
        whole = sh.shape if sh is not None else tuple(leaf.shape)
        if leaf.ndim not in (2, 3) or not applies(path_name(path)) \
                or whole[-2] % bh or whole[-1] % bw:
            continue
        if p == 1:          # the block partition is irrelevant for l1
            grids.append(leaf.float().abs().sum().reshape(1))
        elif p == 2:
            grids.append(block_partials(
                leaf, block_shape, 2,
                sh.offsets if sh else (0,) * leaf.ndim, whole))
        else:
            raise ValueError(f"p={p} not supported")
        owners.append(sh)
    if not grids:
        dev = next((leaf.device for _, leaf in flatten_with_path(params)),
                   None)
        return torch.zeros((), dtype=torch.float32, device=dev)
    grids = reduce_grids(grids, owners)
    return torch.stack([(g if p == 1 else g.sqrt()).sum()
                        for g in grids]).sum()


def group_prox(w: torch.Tensor, block_shape: Tuple[int, int],
               thresh) -> torch.Tensor:
    """Blockwise soft-thresholding: w_b * max(0, 1 - t / ||w_b||_2). Exactly
    zeroes blocks whose norm falls below ``thresh``."""
    bh, bw = block_shape
    norms = block_norms(w, block_shape, ord=2)
    scale = torch.clamp_min(1.0 - thresh / torch.clamp_min(norms, 1e-30),
                            0.0)
    scale = scale.repeat_interleave(bh, dim=0).repeat_interleave(bw, dim=1)
    return w * scale.to(w.dtype)


def l1_prox(w: torch.Tensor, thresh) -> torch.Tensor:
    """Elementwise soft threshold (irregular-sparsity control arm)."""
    return torch.sign(w) * torch.clamp_min(w.abs() - thresh, 0.0)
