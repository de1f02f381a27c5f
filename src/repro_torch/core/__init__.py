"""Core sparsity library: block masks, pruning recipes, pattern reuse."""
from repro_torch.core.pattern_reuse import PatternRegistry, ReuseStats
from repro_torch.core.pruner import oneshot_prune, tie_group, tied_prune
from repro_torch.core.sparsity import (SparsityConfig, apply_block_mask,
                                       block_norms, expand_block_mask,
                                       topk_block_mask)

__all__ = [n for n in dir() if not n.startswith("_")]
