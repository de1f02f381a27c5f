"""Block-sparse gradient compression with error feedback (DP all-reduce path).

Counterpart of ``repro/optim/compression.py``. Gradients are compressed to
the top-K *blocks* per tensor (the block-magnitude machinery of
``core.sparsity``) before the data-parallel exchange; the residual
accumulates in an error-feedback buffer (Deep-Gradient-Compression style)
so convergence is preserved.

Wire format per tensor: (values (K, bh, bw) fp32, flat block indices (K,)
int32). The collective becomes an all-gather of K*bh*bw + K elements per
peer instead of an all-reduce of the full tensor -- at 1-5 % density a
>10x byte reduction on the DP axis.

Where the port departs from the reference:

  * the collective is explicit: :func:`compressed_allreduce` and
    :func:`make_compressed_sync` take the ``launch.mesh.ProcessMesh`` the
    rank belongs to (the reference runs inside ``shard_map`` and names
    only the axes). The gathers go through ``ProcessMesh.all_gather`` and
    are counted in its ``stats`` under ``all_gather:<axis>``; over a tuple
    of axes the peers come in JAX's order, row-major with the first axis
    major;
  * the top-K choice is a stable descending sort of the fp32 block norms
    (``jax.lax.top_k``'s order: ties go to the lower index), not
    ``torch.topk``, which promises no order among ties;
  * :func:`decompress` adds the blocks in the order given, with plain adds
    (the reference's sequential scatter-add): a block named by several
    updates takes them one round at a time, first occurrence first. No
    ``index_add_``, whose CUDA atomics would round in another order from
    run to run; on the CPU the mean is bitwise XLA's;
  * nothing wires compression into the Trainer: the reference's
    ``TrainConfig`` has no such flag either, although its module docstring
    names one. A training loop calls these functions on the gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.tree import map_with_path


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block_shape: Tuple[int, int] = (8, 128)   # lane-aligned wire blocks
    density: float = 0.05                     # fraction of blocks kept
    min_size: int = 65536                     # don't compress small leaves


def _blockify(g, bs):
    bh, bw = bs
    r, c = g.shape
    return g.reshape(r // bh, bh, c // bw, bw).permute(0, 2, 1, 3).reshape(
        -1, bh, bw)


def _unblockify(blocks, shape, bs):
    bh, bw = bs
    r, c = shape
    return blocks.reshape(r // bh, c // bw, bh, bw).permute(0, 2, 1, 3
                                                            ).reshape(r, c)


def compressible(leaf, cfg: CompressionConfig) -> bool:
    bh, bw = cfg.block_shape
    return (leaf.dim() == 2 and leaf.numel() >= cfg.min_size
            and leaf.shape[0] % bh == 0 and leaf.shape[1] % bw == 0)


def compress(g, err, cfg: CompressionConfig):
    """(grad, error buffer) -> (values (K, bh, bw) fp32, indices (K,)
    int32 by descending block norm, new error fp32)."""
    acc = g.float() + err
    blocks = _blockify(acc, cfg.block_shape)              # (NB, bh, bw)
    nb = blocks.shape[0]
    k = max(1, int(nb * cfg.density))
    norms = torch.sum(blocks * blocks, dim=(1, 2))
    idx = torch.sort(norms, descending=True, stable=True).indices[:k]
    vals = blocks[idx]                                    # (K, bh, bw)
    kept = torch.zeros((nb,), dtype=torch.bool, device=acc.device)
    kept[idx] = True
    new_err = _unblockify(torch.where(kept[:, None, None], 0.0, blocks),
                          acc.shape, cfg.block_shape)
    return vals, idx.to(torch.int32), new_err


def _rounds(idx):
    """The update positions of ``idx`` split into rounds in which no block
    repeats: round r holds each block's (r+1)-th update, in the order
    given. Adding round after round adds every block's updates in order."""
    n = idx.numel()
    srt, perm = torch.sort(idx, stable=True)
    first = torch.searchsorted(srt, srt)                  # run starts
    occ = torch.empty_like(perm)
    occ[perm] = torch.arange(n, device=idx.device) - first
    order = torch.sort(occ, stable=True).indices
    return torch.split(order, torch.bincount(occ).tolist())


def decompress(vals, idx, shape, cfg: CompressionConfig):
    """The dense fp32 (R, C) sum of blocks ``vals`` (N, bh, bw) at flat
    block indices ``idx`` (N,), added in the order given."""
    bh, bw = cfg.block_shape
    nb = (shape[0] // bh) * (shape[1] // bw)
    idx = idx.reshape(-1).long()
    vals = vals.reshape(-1, bh, bw)
    blocks = torch.zeros((nb, bh, bw), dtype=torch.float32,
                         device=vals.device)
    for sel in _rounds(idx):
        at = idx[sel]
        blocks[at] = blocks[at] + vals[sel]
    return _unblockify(blocks, shape, cfg.block_shape)


def compressed_allreduce(g, err, cfg: CompressionConfig, axis_names, mesh):
    """Mean-reduce this rank's ``g`` over ``axis_names`` (one name or a
    tuple) of ``mesh`` at reduced traffic. Returns (reduced_grad in
    ``g``'s dtype, new_error fp32)."""
    vals, idx, new_err = compress(g, err, cfg)
    # (P, K, ...): every peer's blocks, in the axes' row-major order
    gv = mesh.all_gather(vals[None], axis_names, dim=0)
    gi = mesh.all_gather(idx[None], axis_names, dim=0)
    n_peers = gv.shape[0]
    summed = decompress(gv.reshape(-1, *vals.shape[1:]), gi.reshape(-1),
                        g.shape, cfg)
    return (summed / n_peers).to(g.dtype), new_err


def make_compressed_sync(mesh, axis_names, cfg: CompressionConfig):
    """A ``(grad, err) -> (mean_grad, new_err)`` sync of one 2-D tensor on
    this rank of ``mesh`` (collective: every rank of ``axis_names`` calls
    it in the same order)."""
    def sync(g, e):
        return compressed_allreduce(g, e, cfg, axis_names, mesh)
    return sync


def init_error_buffers(params, cfg: CompressionConfig, device=None):
    """fp32 zeros of each compressible leaf's shape; ``zeros((1,))``
    elsewhere. On ``device``, or each leaf's own."""
    def zeros(_, p):
        dev = p.device if device is None else device
        shape = p.shape if compressible(p, cfg) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return map_with_path(zeros, params)
