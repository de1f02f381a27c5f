"""Block Sparse Row (BSR) matrices, SciPy layout (``data / indices /
indptr``).

Counterpart of ``repro/core/bsr.py``. ``data`` is a tensor; ``indices`` and ``indptr``
are host numpy arrays -- the pattern is static metadata, as everywhere in
the port, so the compositions build their index tensors once per pattern.

Padding blocks carry ``data == 0`` and live in the *last* block row (keeping
row-major sortedness), so no consumer is affected by them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class BSR:
    """A 2-D block-sparse matrix of logical shape ``shape``."""

    data: torch.Tensor            # (nnzb, bh, bw)
    indices: np.ndarray           # (nnzb,) int32 block column of each block
    indptr: np.ndarray            # (n_brows + 1,) int32 CSR row pointers
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nnzb(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_brows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def n_bcols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def density(self) -> float:
        return self.nnzb / max(1, self.n_brows * self.n_bcols)

    @property
    def dtype(self):
        return self.data.dtype

    def block_row_ids(self) -> np.ndarray:
        """(nnzb,) block-row id of every stored block (inverse of indptr)."""
        return row_ids_from_indptr(self.indptr, self.nnzb)

    def astype(self, dtype) -> "BSR":
        return BSR(self.data.to(dtype), self.indices, self.indptr, self.shape,
                   self.block_shape)


def row_ids_from_indptr(indptr, nnzb: int) -> np.ndarray:
    """CSR indptr -> per-entry row ids: ``#{r : indptr[r+1] <= j}``."""
    j = np.arange(nnzb)
    return np.sum(j[:, None] >= np.asarray(indptr)[None, 1:],
                  axis=1).astype(np.int32)


def _block_view(dense: np.ndarray, bh: int, bw: int) -> np.ndarray:
    r, c = dense.shape
    assert r % bh == 0 and c % bw == 0, (dense.shape, (bh, bw))
    return dense.reshape(r // bh, bh, c // bw, bw).transpose(0, 2, 1, 3)


def block_mask(dense, block_shape: Tuple[int, int]) -> np.ndarray:
    """(n_brows, n_bcols) bool mask of the blocks holding any nonzero."""
    if isinstance(dense, torch.Tensor):
        dense = dense.detach().float().cpu().numpy()
    blocks = _block_view(np.asarray(dense), *block_shape)
    return np.any(blocks != 0, axis=(2, 3))


def dense_to_bsr(dense, block_shape: Tuple[int, int], nnzb: int | None = None,
                 dtype=None, device=None) -> BSR:
    """Convert a dense (numpy or tensor) matrix to BSR on the host, padding
    the block list to ``nnzb`` with zero blocks in the last row, column 0.
    float64 input becomes float32, as in the reference."""
    if isinstance(dense, torch.Tensor):
        device = dense.device if device is None else device
        dense = dense.detach().float().cpu().numpy()
    dense = np.asarray(dense)
    bh, bw = block_shape
    blocks = _block_view(dense, bh, bw)
    rows, cols = np.nonzero(block_mask(dense, block_shape))
    real = len(rows)
    if nnzb is None:
        nnzb = max(real, 1)
    if real > nnzb:
        raise ValueError(f"nnzb={nnzb} < actual nonzero blocks {real}")
    n_brows = dense.shape[0] // bh
    data = np.zeros((nnzb, bh, bw), dtype=dense.dtype)
    data[:real] = blocks[rows, cols]
    indices = np.zeros((nnzb,), dtype=np.int32)
    indices[:real] = cols
    counts = np.bincount(rows, minlength=n_brows)
    counts[-1] += nnzb - real
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    out = torch.from_numpy(np.ascontiguousarray(
        data.astype(np.float32) if data.dtype == np.float64 else data))
    if dtype is not None:
        out = out.to(dtype)
    return BSR(out.to(device), indices, indptr, tuple(dense.shape), (bh, bw))


def bsr_to_dense(m: BSR) -> torch.Tensor:
    """Densify (the oracle's view). Padding blocks are zero-valued, so they
    may collide with a real block's slot without effect."""
    bh, bw = m.block_shape
    flat_idx = (m.block_row_ids().astype(np.int64) * m.n_bcols
                + np.asarray(m.indices, np.int64))
    blocks = m.data.new_zeros((m.n_brows * m.n_bcols, bh, bw))
    blocks.index_put_((torch.from_numpy(flat_idx).to(m.data.device),),
                      m.data, accumulate=True)
    return (blocks.reshape(m.n_brows, m.n_bcols, bh, bw)
            .permute(0, 2, 1, 3).reshape(m.shape))


def bsr_from_mask(dense, mask: np.ndarray, block_shape: Tuple[int, int],
                  nnzb: int | None = None, device=None) -> BSR:
    """BSR of ``dense`` keeping only the blocks where ``mask``
    (n_brows, n_bcols) is set."""
    if isinstance(dense, torch.Tensor):
        device = dense.device if device is None else device
        dense = dense.detach().float().cpu().numpy()
    dense = np.asarray(dense)
    keep = np.kron(np.asarray(mask), np.ones(block_shape, dtype=bool))
    return dense_to_bsr(np.where(keep, dense, 0), block_shape, nnzb=nnzb,
                        device=device)


def pattern_fingerprint(m: BSR) -> bytes:
    """Hashable fingerprint of the sparsity *structure* (not the values):
    shape, block shape and block count, then indptr and indices -- the
    reference's bytes, so a pattern keys the same task in either package."""
    header = np.array([*m.shape, *m.block_shape, m.nnzb], dtype=np.int64)
    return (header.tobytes() + np.asarray(m.indptr, np.int32).tobytes()
            + np.asarray(m.indices, np.int32).tobytes())
