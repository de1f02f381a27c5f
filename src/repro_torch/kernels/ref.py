"""Plain tensor oracles for the block-sparse kernels.

Counterpart of ``repro/kernels/ref.py``, and the oracle kernels K4 and K5
are held to over a :class:`~repro_torch.core.bsr.BSR`:

  * ``*_ref``     -- densify-then-matmul;
  * ``*_gather``  -- the sparse composition: one gather per stored block,
                     a batched product and a segment sum into block rows
                     (or columns, for the transpose product).

Convention: ``Y(M, N) = X(M, K) @ W^T`` with ``W`` an (N, K) BSR matrix.
Products accumulate in fp32 and return the input's dtype (``sddmm_ref``:
the stored blocks' dtype). Segment sums are ordered -- each segment adds
its entries in block order, gathered through a host-built index matrix --
so a result repeats bit for bit on every device (no ``index_add_``, whose
CUDA atomics do not).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bsr import BSR, bsr_to_dense


def segment_index(ids, n_segments: int) -> np.ndarray:
    """(n_segments, L) positions of each segment's entries of ``ids``, in
    order, padded with ``len(ids)`` (an appended zero entry)."""
    ids = np.asarray(ids, np.int64)
    j = len(ids)
    if j == 0:
        return np.zeros((n_segments, 1), np.int64)
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n_segments)[:n_segments]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(max(1, int(counts.max())))[None, :]
    return np.where(pos < counts[:, None],
                    order[np.minimum(starts[:, None] + pos, j - 1)], j)


def segment_sum(vals: torch.Tensor, ids, n_segments: int) -> torch.Tensor:
    """Ordered segment sum over the leading axis: (J, ...) -> (n, ...)."""
    idx = torch.from_numpy(segment_index(ids, n_segments)).to(vals.device)
    padded = torch.cat([vals, vals.new_zeros((1,) + tuple(vals.shape[1:]))])
    return padded[idx].sum(dim=1)


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def bsr_matmul_ref(x: torch.Tensor, w: BSR) -> torch.Tensor:
    """Oracle: densify W and matmul. x: (M, K) -> (M, N)."""
    dense = bsr_to_dense(w)
    return (x.float() @ dense.float().t()).to(x.dtype)


def bsr_matmul_gather(x: torch.Tensor, w: BSR) -> torch.Tensor:
    """Sparse-compute path: gather the K-blocks of ``x`` each stored block
    reads, multiply by the block, segment-sum into block rows."""
    m, k = x.shape
    n = w.shape[0]
    bn, bk = w.block_shape
    g = x.reshape(m, k // bk, bk)[:, _dev(w.indices, x.device)]  # (M, J, bk)
    prod = torch.einsum("mjk,jnk->jmn", g.float(), w.data.float())
    y = segment_sum(prod, w.block_row_ids(), n // bn)           # (R, M, bn)
    return y.permute(1, 0, 2).reshape(m, n).to(x.dtype)


def bsr_matmul_t_ref(dy: torch.Tensor, w: BSR) -> torch.Tensor:
    """Oracle for the transpose product: dX(M, K) = dY(M, N) @ W."""
    dense = bsr_to_dense(w)
    return (dy.float() @ dense.float()).to(dy.dtype)


def bsr_matmul_t_gather(dy: torch.Tensor, w: BSR) -> torch.Tensor:
    """Sparse transpose product: segment sums into block columns."""
    m, n = dy.shape
    k = w.shape[1]
    bn, bk = w.block_shape
    rows = _dev(w.block_row_ids(), dy.device)
    g = dy.reshape(m, n // bn, bn)[:, rows]                     # (M, J, bn)
    prod = torch.einsum("mjn,jnk->jmk", g.float(), w.data.float())
    x = segment_sum(prod, w.indices, k // bk)                   # (C, M, bk)
    return x.permute(1, 0, 2).reshape(m, k).to(dy.dtype)


def sddmm_ref(dy: torch.Tensor, x: torch.Tensor, w: BSR) -> torch.Tensor:
    """Sampled dense-dense matmul: ``dW.data[j] = dY[:, row_j]^T @ X[:,
    col_j]`` for every stored block; returns (nnzb, bn, bk)."""
    m, n = dy.shape
    k = x.shape[1]
    bn, bk = w.block_shape
    gy = dy.reshape(m, n // bn, bn)[:, _dev(w.block_row_ids(), dy.device)]
    gx = x.reshape(m, k // bk, bk)[:, _dev(w.indices, x.device)]
    return torch.einsum("mjn,mjk->jnk", gy.float(),
                        gx.float()).to(w.data.dtype)
