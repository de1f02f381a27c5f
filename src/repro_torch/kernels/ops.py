"""Public ops for block-sparse linears: differentiable and backend-dispatched.

Counterpart of ``repro/kernels/ops.py``.

``bsr_linear(x, data, pack, backend)`` is the layer-facing op over a flat
:class:`~repro_torch.kernels.bsr_matmul.KernelBSR` pack: an
``autograd.Function`` over both the activations and the stored tile values
so sparse training works (the gradient of padding tiles is exactly zero --
they stay dead). Backends:

  * ``pallas``  -- kernel K4 forward (``dds``), K4 (``dds_t``) and K5
                   (``sddmm``) backward; the reference's name for its TPU
                   kernels, kept so specs map onto the card's kernels. A CPU
                   tensor runs their plain versions;
  * ``rowpack`` -- row-grouped batched matmul with the fixed layout
                   P = max tiles per row, re-laid out per call (the CPU
                   default, as in the reference);
  * ``gather``  -- ``ref.bsr_matmul_gather``: one gather per stored tile;
  * ``ref``     -- the densify oracle.

The non-``pallas`` backward is the gather composition with padding tiles
masked (``ops.py:147`` of the reference).

The plan layout has its own dispatch: ``'plan'`` is the plain tensor
composition (:func:`exec_plan.plan_matmul`), ``'plan_pallas'`` the plan's
schedule driving kernel K1 (:func:`exec_plan.plan_matmul_pallas`), both
differentiable; :func:`plan_q_dispatch` is the same switch over quantized
packs (``'plan_pallas'`` = kernel K6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bsr_matmul as bk
from repro_torch.kernels import exec_plan as xp
from repro_torch.kernels import ref as kref
from repro_torch.kernels.bsr_matmul import KernelBSR

BACKENDS = ("pallas", "rowpack", "gather", "ref")


def default_backend(x: torch.Tensor) -> str:
    """Kernel K4 for CUDA tensors, the row-grouped composition for CPU
    tensors (as the reference picks its kernel on a TPU and rowpack
    elsewhere)."""
    return "pallas" if x.device.type == "cuda" else "rowpack"


def _rowpack_layout(pack: KernelBSR):
    """Static row-grouped layout (col_idx (R, P), slot (nnzt,), P) with
    P = max tiles per row, padding tiles included; cached per pattern
    through the plan registry."""
    def build():
        rows = np.asarray(pack.row_id[: pack.nnzt], dtype=np.int64)
        r = pack.n_brows
        counts = np.bincount(rows, minlength=r)
        p = max(1, int(counts.max()))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        order = np.argsort(rows, kind="stable")
        slot = np.empty(rows.shape[0], np.int64)
        slot[order] = np.arange(rows.shape[0]) - starts[rows[order]]
        col_idx = np.zeros((r, p), np.int64)
        col_idx[rows, slot] = pack.col_id
        return col_idx, slot, p

    reg = xp.default_plan_registry()
    key = ("rowpack_layout", xp.kernel_pattern_fingerprint(pack))
    return reg.cached(key, build)


def _rowpack_matmul(x: torch.Tensor, data: torch.Tensor, pack: KernelBSR):
    """One batched (R, M, P*bk) x (R, P*bk, bn) product over the row-grouped
    layout; the values are scattered into it on every call (this backend's
    ABI takes the packed (nnzt, bn, bk) layout)."""
    m = x.shape[0]
    n, k = pack.shape
    bn, bk_ = pack.tile
    col_idx, slot, p = _rowpack_layout(pack)
    dev = x.device
    rows = torch.from_numpy(pack.row_id[: pack.nnzt].astype(np.int64)).to(dev)
    data_rp = data.new_zeros((pack.n_brows, p, bn, bk_))
    data_rp[rows, torch.from_numpy(slot).to(dev)] = data
    xg = x.reshape(m, k // bk_, bk_)[:, torch.from_numpy(col_idx).to(dev)]
    y = torch.einsum("mrpk,rpnk->rmn", xg.float(), data_rp.float())
    return y.permute(1, 0, 2).reshape(m, n).to(x.dtype)


def _fwd_impl(x, data, pack: KernelBSR, backend: str):
    if backend == "pallas":
        return bk.dds(x, pack, data)
    if backend == "rowpack":
        return _rowpack_matmul(x, data, pack)
    m = bk.core_bsr(pack, data)
    if backend == "gather":
        return kref.bsr_matmul_gather(x, m)
    if backend == "ref":
        return kref.bsr_matmul_ref(x, m)
    raise ValueError(f"unknown backend {backend}")


class _BsrLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data, pack, backend):
        ctx.pack, ctx.backend = pack, backend
        ctx.save_for_backward(x, data)
        return _fwd_impl(x, data, pack, backend)

    @staticmethod
    def backward(ctx, dy):
        x, data = ctx.saved_tensors
        pack = ctx.pack
        dy = dy.contiguous()
        dx = ddata = None
        if ctx.backend == "pallas":
            if ctx.needs_input_grad[0]:
                dx = bk.dds_t(dy, pack, data)
            if ctx.needs_input_grad[1]:
                ddata = bk.sddmm(dy, x.contiguous(), pack, data)
        else:
            m = bk.core_bsr(pack, data)
            if ctx.needs_input_grad[0]:
                dx = kref.bsr_matmul_t_gather(dy, m)
            if ctx.needs_input_grad[1]:
                ddata = kref.sddmm_ref(dy, x, m)
                mask = torch.from_numpy(pack.pad_mask()).to(ddata.device)
                ddata = ddata * mask[:, None, None].to(ddata.dtype)
        return (None if dx is None else dx.to(x.dtype),
                None if ddata is None else ddata.to(data.dtype), None, None)


def bsr_linear(x: torch.Tensor, data: torch.Tensor, pack: KernelBSR,
               backend: str = "gather") -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T with W = (pack pattern, ``data`` values)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend}")
    return _BsrLinear.apply(x, data, pack, backend)


def bsr_matmul(x: torch.Tensor, w: KernelBSR, backend: str | None = None):
    """Batched-x entry point: x (..., K) -> (..., N); ``w.data`` holds the
    tile values (a tensor, or numpy moved to ``x``'s device)."""
    backend = backend or default_backend(x)
    lead = tuple(x.shape[:-1])
    y = bsr_linear(x.reshape(-1, x.shape[-1]), bk.tile_values(w, x), w,
                   backend)
    return y.reshape(lead + (w.shape[0],))


def default_plan_backend(x: torch.Tensor) -> str:
    """Kernel K1 for CUDA tensors, the plain composition for CPU tensors
    (as the reference picks its kernel on a TPU and XLA elsewhere)."""
    return "plan_pallas" if x.device.type == "cuda" else "plan"


def plan_dispatch(x, data_rp, plan, backend: str | None = None):
    """Plan-layout matmul behind a backend switch; both backends take the
    same row-grouped (V, P, bn, bk) values and both differentiate."""
    backend = backend or default_plan_backend(x)
    if backend == "plan_pallas":
        return xp.plan_matmul_pallas(x, data_rp, plan)
    if backend == "plan":
        return xp.plan_matmul(x, data_rp, plan)
    raise ValueError(f"unknown plan backend {backend}")


def plan_q_dispatch(x, qvalues, scales, plan, backend: str | None = None):
    """Quantized-pack matmul behind the same backend switch: 'plan' = the
    dequant-fused plain composition (:func:`exec_plan.plan_q_matmul`),
    'plan_pallas' = kernel K6 with the scale multiply in the accumulation
    (:func:`exec_plan.plan_q_matmul_pallas`)."""
    backend = backend or default_plan_backend(x)
    if backend == "plan_pallas":
        return xp.plan_q_matmul_pallas(x, qvalues, scales, plan)
    if backend == "plan":
        return xp.plan_q_matmul(x, qvalues, scales, plan)
    raise ValueError(f"unknown plan backend {backend}")


def sparsify_weight(w_dense, tile=(128, 128), nnzt: int | None = None
                    ) -> KernelBSR:
    """Host-side packing step (offline, like TVM's relay BSR conversion):
    a dense weight (tensor or numpy) into a tile-granular KernelBSR."""
    return bk.pack_bsr(w_dense, tile, nnzt)
