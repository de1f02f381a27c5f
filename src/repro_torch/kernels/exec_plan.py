"""Precomputed execution plans for block-sparse serving.

Counterpart of the single-device plan path of ``repro/kernels/exec_plan.py``.
A :class:`RowPackPlan` moves all pattern-dependent work offline: it is frozen
host metadata (numpy, hashable by pattern fingerprint) computed once at pack
time, and weight values are stored *already row-grouped* ``(V, P, bn, bk)``.
The plan picks a row capacity P and spills the overflow tiles of heavy block
rows into extra virtual rows (vrows).

Two executions of the same layout:

  * ``plan`` -- :func:`plan_linear`, plain tensor code: one gather of ``x``,
    one batched product, and an ordered segment sum when rows spilled;
  * ``plan_pallas`` -- :func:`plan_linear_pallas`, the plan's row-sorted
    tile schedule driving kernel K1 (``bsr_matmul.plan_dds``; the backend
    keeps the reference's name so saved artifacts map onto the kernel). Its
    plain version, which CPU tensors run, is :func:`plan_fused_linear_plain`:
    :func:`plan_linear` plus the bias/act epilogue.

The host-side functions (fingerprints, capacity choice, plan and schedule
construction) are numpy and byte-identical to the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pattern_reuse import PatternRegistry
from repro_torch.kernels.bsr_matmul import (KernelBSR, PlanSchedule,
                                            act_epilogue, plan_dds)

# GEMM-efficiency floor for the batched matmul's inner dimension P*bk
_MIN_INNER = 128


def kernel_pattern_fingerprint(pack: KernelBSR) -> bytes:
    """Hashable fingerprint of a KernelBSR *structure* (not values)."""
    header = np.array([*pack.shape, *pack.tile, pack.nnzt, pack.real_nnzt],
                      dtype=np.int64)
    return (header.tobytes()
            + np.asarray(pack.row_id, np.int32).tobytes()
            + np.asarray(pack.col_id, np.int32).tobytes())


@dataclasses.dataclass(frozen=True, eq=False)
class RowPackPlan:
    """Frozen row-grouped execution plan for one sparsity pattern; hash and
    equality go through ``fingerprint``."""

    col_idx: np.ndarray       # (V, P) int32 block-col per slot
    slot_mask: np.ndarray     # (V, P) bool, True where a real tile lives
    row_of_vrow: np.ndarray   # (V,) int32 owning block row of each vrow
    vrow: np.ndarray          # (real_nnzt,) int32 virtual row of each tile
    slot: np.ndarray          # (real_nnzt,) int32 slot of each tile
    shape: Tuple[int, int]    # (N, K)
    tile: Tuple[int, int]     # (bn, bk)
    nnzt: int                 # packed tile count incl. padding tiles
    real_nnzt: int            # stored tiles that are not padding
    fingerprint: bytes        # kernel_pattern_fingerprint of the source pack

    @property
    def n_brows(self) -> int:
        return self.shape[0] // self.tile[0]

    @property
    def n_bcols(self) -> int:
        return self.shape[1] // self.tile[1]

    @property
    def n_vrows(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def p_max(self) -> int:
        return int(self.col_idx.shape[1])

    @property
    def spilled(self) -> bool:
        return self.n_vrows != self.n_brows

    @property
    def density(self) -> float:
        return self.real_nnzt / max(1, self.n_brows * self.n_bcols)

    @property
    def padding_waste(self) -> float:
        """Total slots / real tiles (1.0 = zero padding)."""
        return self.n_vrows * self.p_max / max(1, self.real_nnzt)

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, RowPackPlan)
                and self.fingerprint == other.fingerprint)


# a spill schedule must save at least this share of the no-spill slots
_SPILL_MIN_SAVING = 0.25


def _choose_capacity(counts: np.ndarray, bk: int) -> int:
    """Per-vrow slot capacity P minimizing ``(R + spill_rows(P)) * P`` under
    the inner-dimension floor P*bk >= _MIN_INNER (ties -> larger P), kept
    only when it saves ``_SPILL_MIN_SAVING`` of the no-spill slots."""
    cmax = max(1, int(counts.max()))
    p_lo = min(cmax, max(1, -(-_MIN_INNER // bk)))
    cand = np.arange(p_lo, cmax + 1, dtype=np.int64)
    extra = np.ceil(np.maximum(counts[None, :] - cand[:, None], 0)
                    / cand[:, None]).sum(axis=1)
    slots = (len(counts) + extra) * cand
    best = slots.min()
    if best > (1.0 - _SPILL_MIN_SAVING) * len(counts) * cmax:
        return cmax
    return int(cand[np.nonzero(slots <= best * 1.02)[0][-1]])


def build_plan(pack: KernelBSR) -> RowPackPlan:
    """Derive the spill-scheduled row-grouped layout on the host, once.
    Padding tiles are dropped (their data is zero by the pack contract)."""
    rows = np.asarray(pack.row_id[: pack.real_nnzt], dtype=np.int64)
    cols = np.asarray(pack.col_id[: pack.real_nnzt], dtype=np.int64)
    r = pack.n_brows
    counts = np.bincount(rows, minlength=r)
    p = _choose_capacity(counts, pack.tile[1])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(rows, kind="stable")
    rank = np.empty(rows.shape[0], np.int64)
    rank[order] = np.arange(rows.shape[0]) - starts[rows[order]]
    n_spill = np.ceil(np.maximum(counts - p, 0) / p).astype(np.int64)
    spill_base = r + np.concatenate([[0], np.cumsum(n_spill)[:-1]])
    v = int(r + n_spill.sum())
    chunk = rank // p                      # 0 = home vrow, >=1 = spill chunk
    vrow = np.where(chunk == 0, rows, spill_base[rows] + chunk - 1)
    slot = rank % p
    col_idx = np.zeros((v, p), np.int32)
    col_idx[vrow, slot] = cols
    slot_mask = np.zeros((v, p), bool)
    slot_mask[vrow, slot] = True
    row_of_vrow = np.empty((v,), np.int64)
    row_of_vrow[:r] = np.arange(r)
    for rr in np.nonzero(n_spill)[0]:
        row_of_vrow[spill_base[rr]: spill_base[rr] + n_spill[rr]] = rr
    return RowPackPlan(col_idx=col_idx, slot_mask=slot_mask,
                       row_of_vrow=row_of_vrow.astype(np.int32),
                       vrow=vrow.astype(np.int32), slot=slot.astype(np.int32),
                       shape=pack.shape, tile=pack.tile, nnzt=pack.nnzt,
                       real_nnzt=pack.real_nnzt,
                       fingerprint=kernel_pattern_fingerprint(pack))


_PLAN_REGISTRY = PatternRegistry()


def default_plan_registry() -> PatternRegistry:
    """Process-wide plan task buffer (hit/miss stats included)."""
    return _PLAN_REGISTRY


def plan_for_pack(pack: KernelBSR,
                  registry: Optional[PatternRegistry] = None) -> RowPackPlan:
    """Cached plan lookup: identical patterns share one RowPackPlan."""
    reg = registry if registry is not None else _PLAN_REGISTRY
    fp = kernel_pattern_fingerprint(pack)
    return reg.cached(("rowpack_plan", fp), lambda: build_plan(pack))


# --------------------------------------------------------------------------
# device copies of plan index arrays (built once per plan and device)
# --------------------------------------------------------------------------

_DEV_CACHE: Dict[tuple, torch.Tensor] = {}


def _dev_index(plan: RowPackPlan, name: str, arr, device) -> torch.Tensor:
    key = (plan.fingerprint, name, str(device))
    t = _DEV_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(device)
        _DEV_CACHE[key] = t
    return t


# --------------------------------------------------------------------------
# offline data re-layout (pack time, not call time)
# --------------------------------------------------------------------------

def pack_plan_data(plan: RowPackPlan, data) -> torch.Tensor:
    """(..., nnzt, bn, bk) packed tile values -> (..., V, P, bn, bk)
    row-grouped values (padding slots zero)."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    lead = tuple(data.shape[:-3])
    bn, bk = plan.tile
    d = data.reshape((-1,) + tuple(data.shape[-3:]))[:, : plan.real_nnzt]
    out = d.new_zeros((d.shape[0], plan.n_vrows, plan.p_max, bn, bk))
    vr = _dev_index(plan, "vrow", plan.vrow, d.device)
    sl = _dev_index(plan, "slot", plan.slot, d.device)
    out[:, vr, sl] = d
    return out.reshape(lead + (plan.n_vrows, plan.p_max, bn, bk))


def unpack_plan_data(plan: RowPackPlan, data_rp) -> torch.Tensor:
    """Inverse re-layout: (..., V, P, bn, bk) -> (..., real_nnzt, bn, bk)."""
    vr = _dev_index(plan, "vrow", plan.vrow, data_rp.device)
    sl = _dev_index(plan, "slot", plan.slot, data_rp.device)
    return data_rp[..., vr, sl, :, :]


# --------------------------------------------------------------------------
# the 'plan' backend: plain gather / batched product / ordered segment sum
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _vrow_segments(plan: RowPackPlan) -> np.ndarray:
    """(R, 1 + max spill) vrow indices per block row -- the home vrow, then
    its spill vrows in order -- padded with V (a zero row)."""
    rov = np.asarray(plan.row_of_vrow, np.int64)
    order = np.argsort(rov, kind="stable")
    counts = np.bincount(rov, minlength=plan.n_brows)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(max(1, int(counts.max())))[None, :]
    return np.where(pos < counts[:, None],
                    order[np.minimum(starts[:, None] + pos, len(order) - 1)],
                    plan.n_vrows)


def _gather_x(x: torch.Tensor, plan: RowPackPlan) -> torch.Tensor:
    m = x.shape[0]
    bk = plan.tile[1]
    ci = _dev_index(plan, "col_idx", plan.col_idx, x.device)
    return x.reshape(m, plan.shape[1] // bk, bk)[:, ci]     # (M, V, P, bk)


def _plan_fwd_f32(x: torch.Tensor, data_rp: torch.Tensor,
                  plan: RowPackPlan) -> torch.Tensor:
    m = x.shape[0]
    xg = _gather_x(x, plan).float()
    y = torch.einsum("mvpk,vpnk->vmn", xg, data_rp.float())  # (V, M, bn)
    if plan.spilled:
        # ordered segment sum (no atomics): row r = home + its spill vrows
        y = torch.cat([y, y.new_zeros((1,) + tuple(y.shape[1:]))])
        y = y[_dev_index(plan, "vrow_segments", _vrow_segments(plan),
                         x.device)].sum(dim=1)                # (R, M, bn)
    return y.permute(1, 0, 2).reshape(m, plan.shape[0])


def plan_linear(x: torch.Tensor, data_rp: torch.Tensor,
                plan: RowPackPlan) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T with W given as a plan + row-grouped values,
    accumulated in fp32 and returned in ``x``'s dtype."""
    return _plan_fwd_f32(x, data_rp, plan).to(x.dtype)


def plan_matmul(x: torch.Tensor, data_rp: torch.Tensor, plan: RowPackPlan):
    """Batched-x entry point: x (..., K) -> (..., N)."""
    lead = tuple(x.shape[:-1])
    y = plan_linear(x.reshape(-1, x.shape[-1]), data_rp, plan)
    return y.reshape(lead + (plan.shape[0],))


# --------------------------------------------------------------------------
# the 'plan_pallas' backend: the plan's schedule drives kernel K1
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def plan_kernel_sequence(plan: RowPackPlan):
    """Forward tile visitation schedule: real tiles stably sorted by owning
    output block row. Returns ``(row_seq, col_seq, vrow_seq, slot_seq)``
    int32 numpy arrays; ``row_seq`` carries the row-change sentinel."""
    vrow = np.asarray(plan.vrow, np.int64)
    slot = np.asarray(plan.slot, np.int64)
    t_row = np.asarray(plan.row_of_vrow, np.int64)[vrow]
    assert np.array_equal(np.unique(t_row), np.arange(plan.n_brows)), \
        "plan does not cover every output block row"
    order = np.argsort(t_row, kind="stable")
    row_seq = np.concatenate([t_row[order], [plan.n_brows]]).astype(np.int32)
    col_seq = np.asarray(plan.col_idx, np.int64)[vrow, slot][order]
    return (row_seq, col_seq.astype(np.int32),
            vrow[order].astype(np.int32), slot[order].astype(np.int32))


@functools.lru_cache(maxsize=None)
def plan_schedule(plan: RowPackPlan) -> PlanSchedule:
    """The plan's kernel schedule with its per-row segment offsets."""
    return PlanSchedule(*plan_kernel_sequence(plan), n_brows=plan.n_brows,
                        n_bcols=plan.n_bcols, p_max=plan.p_max)


def plan_linear_pallas(x: torch.Tensor, data_rp: torch.Tensor,
                       plan: RowPackPlan) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T through kernel K1 (forward only). Same layout
    contract as :func:`plan_linear`."""
    return plan_fused_linear(x, data_rp, plan)


def plan_fused_linear_plain(x: torch.Tensor, data_rp: torch.Tensor,
                            plan: RowPackPlan, *, bias=None,
                            act: str | None = None) -> torch.Tensor:
    """Plain version of kernel K1: :func:`plan_linear`'s fp32 product, then
    the bias add and activation in fp32, cast to ``x``'s dtype."""
    y = _plan_fwd_f32(x, data_rp, plan)
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return act_epilogue(y, act).to(x.dtype)


def plan_fused_linear(x: torch.Tensor, data_rp: torch.Tensor,
                      plan: RowPackPlan, *, bias=None,
                      act: str | None = None) -> torch.Tensor:
    """Forward entry with the fused epilogue: bias add + activation ('relu'
    / 'gelu' / 'silu') folded into the kernel's single output write. A CPU
    ``x`` runs :func:`plan_fused_linear_plain`; a tensor on any other device
    goes to kernel K1, which launches or raises."""
    if x.dim() != 2 or x.shape[1] != plan.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not fit a plan of shape "
                         f"{plan.shape}")
    if x.device.type == "cpu":
        return plan_fused_linear_plain(x, data_rp, plan, bias=bias, act=act)
    return plan_dds(x.contiguous(), data_rp, plan_schedule(plan),
                    n=plan.shape[0], tile=plan.tile, bias=bias, act=act)


def plan_matmul_pallas(x: torch.Tensor, data_rp: torch.Tensor,
                       plan: RowPackPlan):
    """Batched-x entry point for the kernel plan backend."""
    lead = tuple(x.shape[:-1])
    y = plan_linear_pallas(x.reshape(-1, x.shape[-1]), data_rp, plan)
    return y.reshape(lead + (plan.shape[0],))


@dataclasses.dataclass(frozen=True, eq=False)
class PlanChoice:
    """A RowPackPlan pinned to a plan-consuming execution backend
    (``'plan_pallas'`` = kernel K1)."""

    plan: RowPackPlan
    backend: str = "plan_pallas"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.plan.shape

    @property
    def tile(self) -> Tuple[int, int]:
        return self.plan.tile

    @property
    def density(self) -> float:
        return self.plan.density

    @property
    def fingerprint(self) -> bytes:
        return (b"plan_choice:" + self.backend.encode() + b":"
                + self.plan.fingerprint)

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, PlanChoice)
                and self.fingerprint == other.fingerprint)
