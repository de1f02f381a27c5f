"""Block-structured sparsity config and mask algebra (paper §2.1).

A ``SparsityConfig`` describes how a 2-D weight is partitioned into blocks
and what fraction of blocks must go to zero. Masks are computed at block
granularity from block norms (magnitude criterion).

Counterpart of ``repro/core/sparsity.py``. Block selection keeps the
reference's tie order: among equal norms the lower flat index wins (what
``lax.top_k`` does), which ``torch.topk`` does not promise -- so the kept
set comes from a stable sort on ``-norm``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Structured-sparsity settings for a family of weight matrices."""

    block_shape: Tuple[int, int] = (32, 1)   # paper's end-to-end CPU optimum
    sparsity: float = 0.8                    # fraction of blocks zeroed
    targets: Sequence[str] = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
    group_norm_ord: int = 2                  # norm used to score a block
    lambda_reg: float = 0.0                  # group-lasso strength (0 = off)
    start_step: int = 0                      # gradual pruning window
    end_step: int = 1
    enabled: bool = True

    def applies_to(self, path: str) -> bool:
        return self.enabled and any(t in path for t in self.targets)


def block_norms(w: torch.Tensor, block_shape: Tuple[int, int],
                ord: int = 2) -> torch.Tensor:
    """(n_brows, n_bcols) per-block norms of a 2-D weight."""
    bh, bw = block_shape
    r, c = w.shape
    assert r % bh == 0 and c % bw == 0, (tuple(w.shape), block_shape)
    blocks = w.reshape(r // bh, bh, c // bw, bw)
    if ord == 1:
        return blocks.abs().sum(dim=(1, 3))
    if ord == 2:
        return (blocks * blocks).sum(dim=(1, 3)).sqrt()
    raise ValueError(f"unsupported block norm ord={ord}")


def topk_flat_mask(norms: torch.Tensor, k_keep: int) -> torch.Tensor:
    """Bool mask of ``norms``' shape keeping the ``k_keep`` largest entries;
    ties go to the lower flat index (``lax.top_k``'s order)."""
    flat = norms.reshape(-1)
    order = torch.argsort(-flat, stable=True)
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    mask[order[:k_keep]] = True
    return mask.reshape(norms.shape)


def topk_block_mask(w: torch.Tensor, block_shape: Tuple[int, int],
                    sparsity: float, ord: int = 2) -> torch.Tensor:
    """Keep the top-(1-sparsity) fraction of blocks by norm. Bool block mask,
    ties broken by flat index order."""
    norms = block_norms(w, block_shape, ord)
    k_keep = max(1, int(round((1.0 - sparsity) * norms.numel())))
    return topk_flat_mask(norms, k_keep)


def expand_block_mask(mask: torch.Tensor,
                      block_shape: Tuple[int, int]) -> torch.Tensor:
    """Block mask (n_brows, n_bcols) -> elementwise mask."""
    bh, bw = block_shape
    return mask.repeat_interleave(bh, dim=0).repeat_interleave(bw, dim=1)


def apply_block_mask(w: torch.Tensor, mask: torch.Tensor,
                     block_shape: Tuple[int, int]) -> torch.Tensor:
    return w * expand_block_mask(mask, block_shape).to(w.dtype)


def actual_sparsity(w: torch.Tensor,
                    block_shape: Tuple[int, int]) -> torch.Tensor:
    """Fraction of all-zero blocks in ``w`` (fp32 0-d tensor)."""
    norms = block_norms(w, block_shape, ord=1)
    return (norms == 0).float().mean()


def prune_to_sparsity(w: torch.Tensor, block_shape: Tuple[int, int],
                      sparsity: float, ord: int = 2):
    """One-shot block-magnitude pruning. Returns (pruned_w, block_mask)."""
    mask = topk_block_mask(w, block_shape, sparsity, ord)
    return apply_block_mask(w, mask, block_shape), mask


def pad_to_blocks(w: torch.Tensor,
                  block_shape: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad both dims of a 2-D weight up to multiples of the block
    shape (odd vocab sizes etc.); the weight itself when they divide."""
    bh, bw = block_shape
    r, c = w.shape
    pr, pc = (-r) % bh, (-c) % bw
    if pr == 0 and pc == 0:
        return w
    return torch.nn.functional.pad(w, (0, pc, 0, pr))


# -- a rank's shard of a leaf (the mesh Trainer) ------------------------------
#
# On a mesh a leaf lies cut over ranks (``launch.sharding.LeafShard``: the
# shard's offsets in the whole leaf and the sum over the axes that cut it),
# and a block may straddle two shards. Block norms then come from partial
# sums over the WHOLE leaf's block grid -- zeros where the shard has no
# element -- summed over the ranks, and a whole-grid value (a mask, a prox
# scale) is read back at each local element.


def block_partials(w: torch.Tensor, block_shape: Tuple[int, int], ord: int,
                   offsets: Tuple[int, ...], whole: Tuple[int, ...]
                   ) -> torch.Tensor:
    """Partial block sums of a shard ``w`` (..., r, c) whose first element
    sits at ``offsets`` (one per dim) of a ``whole``-shaped (..., R, C)
    leaf: (..., R/bh, C/bw) fp32 sums of squares (``ord`` 2) or of |w| (1)
    over the shard's elements of each block, 0 elsewhere -- leading dims
    (a stack's layers) included, so a rank holding some layers leaves the
    others' zero. Summed over the ranks they are the whole leaf's (fp32,
    in another order of addition)."""
    bh, bw = block_shape
    *lead0, r0, c0 = (int(o) for o in offsets)
    x = w.float()
    x = x.abs() if ord == 1 else x * x
    if ord not in (1, 2):
        raise ValueError(f"unsupported block norm ord={ord}")
    r, c = x.shape[-2:]
    pr, pc = r0 % bh, c0 % bw
    x = torch.nn.functional.pad(x, (pc, (-(pc + c)) % bw,
                                    pr, (-(pr + r)) % bh))
    lead = tuple(x.shape[:-2])
    part = x.reshape(lead + (x.shape[-2] // bh, bh, x.shape[-1] // bw, bw)
                     ).sum(dim=(-3, -1))
    grid = torch.zeros(tuple(whole[:-2]) + (whole[-2] // bh,
                                            whole[-1] // bw),
                       dtype=torch.float32, device=w.device)
    at = tuple(slice(o, o + n) for o, n in zip(lead0, lead))
    grid[at + (slice(r0 // bh, r0 // bh + part.shape[-2]),
               slice(c0 // bw, c0 // bw + part.shape[-1]))] = part
    return grid


def local_of_grid(grid: torch.Tensor, block_shape: Tuple[int, int],
                  offsets: Tuple[int, ...], local: Tuple[int, ...]
                  ) -> torch.Tensor:
    """A whole-leaf block grid (..., R/bh, C/bw) read at every element of
    a ``local``-shaped (..., r, c) shard at ``offsets`` (one per dim; the
    leading dims pick the shard's layers): (..., r, c)."""
    bh, bw = block_shape
    *lead0, r0, c0 = (int(o) for o in offsets)
    grid = grid[tuple(slice(o, o + n) for o, n in zip(lead0, local[:-2]))]
    rows = (r0 + torch.arange(local[-2], device=grid.device)) // bh
    cols = (c0 + torch.arange(local[-1], device=grid.device)) // bw
    return grid.index_select(-2, rows).index_select(-1, cols)


def reduce_grids(grids, shards):
    """Each partial grid summed over the axes of its shard (None: a whole
    leaf, kept as it is), one collective an axis for all of them: the grids
    of leaves cut over the same axes travel flattened together."""
    out = list(grids)
    groups = {}
    for i, sh in enumerate(shards):
        if sh is not None and sh.axes:
            groups.setdefault(sh.axes, []).append(i)
    for axes, idx in groups.items():
        flat = torch.cat([grids[i].reshape(-1) for i in idx])
        flat = shards[idx[0]].sum(flat)
        at = 0
        for i in idx:
            n = grids[i].numel()
            out[i] = flat[at:at + n].reshape(grids[i].shape)
            at += n
    return out
