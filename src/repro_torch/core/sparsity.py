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
