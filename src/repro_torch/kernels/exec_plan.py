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

Quantized packs (:class:`QuantPlan`) store the same layout as int8 or fp8
values with fp32 scales and run the same two ways: :func:`plan_q_linear`
(plain, the scale folded into the gathered activations) and
:func:`plan_q_linear_pallas` (kernel K6, ``bsr_matmul.plan_dds_q``).

Tensor-parallel serving partitions a plan's vrows into equal shards
(:class:`ShardedPlan`, :func:`build_sharded_plan`); a rank runs its shard
as a plan of its own (:func:`local_plan`) through the plain composition.

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
                                            TileSequence, act_epilogue,
                                            plan_dds, plan_dds_q, plan_dds_t,
                                            plan_sddmm)
from repro_torch.kernels.ref import segment_index

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
# sharded plans (tensor-parallel serving: launch/sharding.py conventions)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPlan(RowPackPlan):
    """A RowPackPlan whose virtual-row axis is partitioned into ``n_shards``
    contiguous, equal-size groups -- one per rank of a tensor-parallel
    "model" mesh axis.

    ``shard_axis`` selects the layout:

      * ``'out'`` (column-parallel: wq/wk/wv/wqkv/wi/wg): shard ``s`` owns
        output block rows ``[s*R/S, (s+1)*R/S)`` and its vrows reference
        only those rows;
      * ``'in'`` (row-parallel: wo): shard ``s`` owns input block columns
        ``[s*C/S, (s+1)*C/S)`` and its vrows map to *global* output rows,
        so summing the shards' segment sums is the per-layer reduction.

    The whole plan is also a valid single-device plan (``spilled`` is
    forced True: the segment sum reassembles the shards). ``shard_
    fingerprints`` key each shard's sub-pattern (registry, autotune).
    ``mesh`` (a ``launch.mesh.ProcessMesh``, never serialized, not part of
    the fingerprint) is attached by ``prepare_servable`` / ``load_servable``:
    with it, ``models.common.linear`` runs this rank's shard
    (:func:`local_plan`) and the collective that makes the output whole.
    """

    n_shards: int = 1
    shard_axis: str = "out"            # 'out' = column-parallel, 'in' = row
    shard_fingerprints: Tuple[bytes, ...] = ()
    mesh: Optional[object] = None

    @property
    def spilled(self) -> bool:
        return True

    @property
    def vrows_per_shard(self) -> int:
        return self.n_vrows // max(1, self.n_shards)

    def with_mesh(self, mesh) -> "ShardedPlan":
        return dataclasses.replace(self, mesh=mesh)

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, ShardedPlan)
                and self.fingerprint == other.fingerprint)


def shard_divisible(pack: KernelBSR, n_shards: int, shard_axis: str) -> bool:
    """True when this pack partitions into ``n_shards`` equal groups along
    ``shard_axis`` ('out' = output block rows, 'in' = input block cols) --
    the divisibility rule ``launch/sharding.spec_for_param`` applies to
    dense weights (indivisible dims replicate)."""
    dim = pack.n_brows if shard_axis == "out" else pack.n_bcols
    return n_shards >= 1 and dim % n_shards == 0 and dim >= n_shards


def _shard_layout(rows: np.ndarray, cols: np.ndarray, p: int):
    """Compressed row-grouped layout for ONE shard's tiles (pack order):
    only rows present get vrows. Returns ``(col_idx (v, p), slot_mask,
    row_of_vrow (v,), vrow, slot)``."""
    if rows.size == 0:
        return (np.zeros((0, p), np.int32), np.zeros((0, p), bool),
                np.zeros((0,), np.int64), np.zeros((0,), np.int64),
                np.zeros((0,), np.int64))
    uniq, inv = np.unique(rows, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(inv, kind="stable")
    rank = np.empty(rows.shape[0], np.int64)
    rank[order] = np.arange(rows.shape[0]) - starts[inv[order]]
    n_spill = np.ceil(np.maximum(counts - p, 0) / p).astype(np.int64)
    spill_base = len(uniq) + np.concatenate([[0], np.cumsum(n_spill)[:-1]])
    v = int(len(uniq) + n_spill.sum())
    chunk = rank // p
    vrow = np.where(chunk == 0, inv, spill_base[inv] + chunk - 1)
    slot = rank % p
    col_idx = np.zeros((v, p), np.int32)
    col_idx[vrow, slot] = cols
    slot_mask = np.zeros((v, p), bool)
    slot_mask[vrow, slot] = True
    row_of_vrow = np.empty((v,), np.int64)
    row_of_vrow[: len(uniq)] = uniq
    for rr in np.nonzero(n_spill)[0]:
        row_of_vrow[spill_base[rr]: spill_base[rr] + n_spill[rr]] = uniq[rr]
    return col_idx, slot_mask, row_of_vrow, vrow, slot


def shard_pattern_fingerprint(pack: KernelBSR, n_shards: int,
                              shard_axis: str, shard: int) -> bytes:
    """Fingerprint of ONE shard's sub-pattern (local coordinates) -- the
    per-shard registry and autotune key."""
    rows = np.asarray(pack.row_id[: pack.real_nnzt], np.int64)
    cols = np.asarray(pack.col_id[: pack.real_nnzt], np.int64)
    if shard_axis == "out":
        per = pack.n_brows // n_shards
        sel = (rows // per) == shard
        lrows, lcols = rows[sel] % per, cols[sel]
        shape = (pack.shape[0] // n_shards, pack.shape[1])
    else:
        per = pack.n_bcols // n_shards
        sel = (cols // per) == shard
        lrows, lcols = rows[sel], cols[sel] % per
        shape = (pack.shape[0], pack.shape[1] // n_shards)
    header = np.array([*shape, *pack.tile, int(shard_axis == "in")], np.int64)
    return (b"shard:" + header.tobytes()
            + lrows.astype(np.int32).tobytes()
            + lcols.astype(np.int32).tobytes())


def build_sharded_plan(pack: KernelBSR, n_shards: int,
                       shard_axis: str = "out", *,
                       registry: Optional[PatternRegistry] = None,
                       shard_stats: Optional[dict] = None) -> ShardedPlan:
    """Partition ``pack`` into ``n_shards`` equal vrow groups (see
    :class:`ShardedPlan`). Every shard shares one slot capacity P and is
    padded to the largest shard's vrow count, so the vrow axis divides
    exactly by ``n_shards``. ``registry`` caches each shard's layout under
    its sub-pattern fingerprint (in shard-local coordinates, re-offset at
    assembly); ``shard_stats`` collects per-shard hit / miss counts."""
    if not shard_divisible(pack, n_shards, shard_axis):
        raise ValueError(
            f"pattern {pack.shape} @ tile {pack.tile} not divisible into "
            f"{n_shards} shards along {shard_axis!r}")
    rows = np.asarray(pack.row_id[: pack.real_nnzt], np.int64)
    cols = np.asarray(pack.col_id[: pack.real_nnzt], np.int64)
    bn, bk = pack.tile
    if shard_axis == "out":
        per = pack.n_brows // n_shards
        shard_of = rows // per
    else:
        per = pack.n_bcols // n_shards
        shard_of = cols // per
    p = 1
    for s in range(n_shards):
        srows = rows[shard_of == s]
        if srows.size:
            counts = np.bincount(np.unique(srows, return_inverse=True)[1])
            p = max(p, _choose_capacity(counts, bk))

    layouts, fps = [], []
    for s in range(n_shards):
        idx = np.nonzero(shard_of == s)[0]
        fp = shard_pattern_fingerprint(pack, n_shards, shard_axis, s)
        fps.append(fp)
        lrows = rows[idx] - s * per if shard_axis == "out" else rows[idx]
        lcols = cols[idx] - s * per if shard_axis == "in" else cols[idx]

        def build(lrows=lrows, lcols=lcols):
            return _shard_layout(lrows, lcols, p)
        if registry is not None:
            key = ("plan_shard", shard_axis, p, fp)
            if shard_stats is not None:
                st = shard_stats.setdefault(s, {"hits": 0, "misses": 0})
                st["hits" if registry.peek(key) else "misses"] += 1
            layouts.append((idx, registry.cached(key, build)))
        else:
            layouts.append((idx, build()))

    v_max = max(1, max(lay[1][0].shape[0] for lay in layouts))
    col_idx = np.zeros((n_shards * v_max, p), np.int32)
    slot_mask = np.zeros((n_shards * v_max, p), bool)
    row_of_vrow = np.zeros((n_shards * v_max,), np.int64)
    vrow = np.zeros((pack.real_nnzt,), np.int64)
    slot = np.zeros((pack.real_nnzt,), np.int64)
    for s, (idx, (ci, sm, rov, vr, sl)) in enumerate(layouts):
        v = ci.shape[0]
        lo = s * v_max
        # globalize; padding vrows (>= v) keep the shard's base row / col
        # and multiply zero values
        if shard_axis == "out":
            col_idx[lo: lo + v] = ci
            row_of_vrow[lo: lo + v_max] = s * per
            row_of_vrow[lo: lo + v] = rov + s * per
        else:
            col_idx[lo: lo + v_max] = s * per
            col_idx[lo: lo + v] = ci + s * per
            row_of_vrow[lo: lo + v] = rov
        slot_mask[lo: lo + v] = sm
        vrow[idx] = lo + vr
        slot[idx] = sl
    header = np.array([n_shards, int(shard_axis == "in")], np.int64)
    fingerprint = (b"sharded:" + header.tobytes()
                   + kernel_pattern_fingerprint(pack))
    return ShardedPlan(
        col_idx=col_idx, slot_mask=slot_mask,
        row_of_vrow=row_of_vrow.astype(np.int32),
        vrow=vrow.astype(np.int32), slot=slot.astype(np.int32),
        shape=pack.shape, tile=pack.tile, nnzt=pack.nnzt,
        real_nnzt=pack.real_nnzt, fingerprint=fingerprint,
        n_shards=n_shards, shard_axis=shard_axis,
        shard_fingerprints=tuple(fps))


@dataclasses.dataclass(frozen=True, eq=False)
class LocalPlan(RowPackPlan):
    """Shard ``shard`` of a :class:`ShardedPlan` as a plan of its own over
    the rank's values: the vrows ``[s*V/S, (s+1)*V/S)`` with 'out' rows
    made local (shape ``(N/S, K)``) or 'in' columns made local (shape
    ``(N, K/S)``). A shard holds vrows only for the rows it has tiles in,
    so block rows can be missing: the ordered segment sum gives them exact
    zeros (``spilled`` is always True). It runs through the plain 'plan'
    composition only -- kernel K1's schedule needs every output block row
    covered, and :func:`plan_kernel_sequence` refuses a plan that is not."""

    shard: int = 0

    @property
    def spilled(self) -> bool:
        return True

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, LocalPlan)
                and self.fingerprint == other.fingerprint)


@functools.lru_cache(maxsize=None)
def local_plan(plan: ShardedPlan, shard: int) -> LocalPlan:
    """The rank-local view of shard ``shard`` of ``plan`` (cached)."""
    s, n = int(shard), plan.n_shards
    v = plan.vrows_per_shard
    lo, hi = s * v, (s + 1) * v
    bn, bk = plan.tile
    vrow = np.asarray(plan.vrow, np.int64)
    mine = (vrow >= lo) & (vrow < hi)
    col_idx = np.asarray(plan.col_idx[lo:hi], np.int64)
    row_of_vrow = np.asarray(plan.row_of_vrow[lo:hi], np.int64)
    if plan.shard_axis == "out":
        per = plan.n_brows // n
        row_of_vrow = row_of_vrow - s * per
        shape = (plan.shape[0] // n, plan.shape[1])
    else:
        per = plan.n_bcols // n
        col_idx = col_idx - s * per
        shape = (plan.shape[0], plan.shape[1] // n)
    header = np.array([s], np.int64)
    return LocalPlan(
        col_idx=col_idx.astype(np.int32),
        slot_mask=np.asarray(plan.slot_mask[lo:hi], bool),
        row_of_vrow=row_of_vrow.astype(np.int32),
        vrow=(vrow[mine] - lo).astype(np.int32),
        slot=np.asarray(plan.slot, np.int32)[mine],
        shape=shape, tile=(bn, bk), nnzt=int(mine.sum()),
        real_nnzt=int(mine.sum()),
        fingerprint=b"local:" + header.tobytes() + plan.fingerprint,
        shard=s)


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
    return segment_index(plan.row_of_vrow, plan.n_brows)


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


def _dx_segments(plan: RowPackPlan) -> np.ndarray:
    """(C, L) flat slot indices ``v * P + p`` feeding each input block
    column, in slot order, padded with ``V * P`` (a zero entry): the
    ordered form of the reference's ``dx.at[:, col_idx].add``."""
    return segment_index(np.asarray(plan.col_idx).reshape(-1), plan.n_bcols)


def _plan_bwd(plan: RowPackPlan, x: torch.Tensor, data_rp: torch.Tensor,
              dy: torch.Tensor, need_dx: bool = True, need_ddata: bool = True):
    """The reference's ``_plan_bwd``: dY gathered per vrow, the values'
    gradient masked by ``slot_mask`` (padding slots exactly zero), dX
    summed back over ``col_idx`` in a fixed order (no atomics)."""
    m = x.shape[0]
    bn, bk = plan.tile
    dy_v = dy.reshape(m, plan.n_brows, bn).float()
    if plan.spilled:
        dy_v = dy_v[:, _dev_index(plan, "row_of_vrow", plan.row_of_vrow,
                                  dy.device)]                 # (M, V, bn)
    dx = ddata = None
    if need_ddata:
        xg = _gather_x(x, plan).float()
        ddata = torch.einsum("mvn,mvpk->vpnk", dy_v, xg)
        mask = torch.from_numpy(np.asarray(plan.slot_mask)).to(ddata.device)
        ddata = (ddata * mask[:, :, None, None].to(ddata.dtype)).to(
            data_rp.dtype)
    if need_dx:
        dxg = torch.einsum("mvn,vpnk->mvpk", dy_v, data_rp.float())
        flat = dxg.reshape(m, plan.n_vrows * plan.p_max, bk)
        flat = torch.cat([flat, flat.new_zeros((m, 1, bk))], dim=1)
        idx = _dev_index(plan, "dx_segments", _dx_segments(plan), dy.device)
        dx = flat[:, idx].sum(dim=2).reshape(m, plan.shape[1]).to(x.dtype)
    return dx, ddata


class _PlanLinear(torch.autograd.Function):
    """``plan_linear`` with the reference's custom backward."""

    @staticmethod
    def forward(ctx, x, data_rp, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, data_rp)
        return _plan_fwd_f32(x, data_rp, plan).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, data_rp = ctx.saved_tensors
        dx, ddata = _plan_bwd(ctx.plan, x, data_rp, dy,
                              ctx.needs_input_grad[0],
                              ctx.needs_input_grad[1])
        return dx, ddata, None


def plan_linear(x: torch.Tensor, data_rp: torch.Tensor,
                plan: RowPackPlan) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T with W given as a plan + row-grouped values,
    accumulated in fp32 and returned in ``x``'s dtype. Differentiable in
    ``x`` and ``data_rp``; padding-slot gradients are exactly zero."""
    return _PlanLinear.apply(x, data_rp, plan)


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


@functools.lru_cache(maxsize=None)
def plan_t_sequence(plan: RowPackPlan):
    """Transposed schedule (tiles sorted by block column, then row) for
    dX = dY @ W. Returns ``(t_row_seq, t_col_seq, t_flat)``: the block
    column of each tile (sentinel-terminated), its block row, and its index
    in the flattened (V * P, bn, bk) values."""
    vrow = np.asarray(plan.vrow, np.int64)
    slot = np.asarray(plan.slot, np.int64)
    t_row = np.asarray(plan.row_of_vrow, np.int64)[vrow]
    t_col = np.asarray(plan.col_idx, np.int64)[vrow, slot]
    assert np.array_equal(np.unique(t_col), np.arange(plan.n_bcols)), \
        "plan does not cover every input block column"
    order = np.lexsort((t_row, t_col))
    t_row_seq = np.concatenate(
        [t_col[order], [plan.n_bcols]]).astype(np.int32)
    t_col_seq = t_row[order].astype(np.int32)
    t_flat = (vrow[order] * plan.p_max + slot[order]).astype(np.int32)
    return t_row_seq, t_col_seq, t_flat


@functools.lru_cache(maxsize=None)
def plan_t_schedule(plan: RowPackPlan) -> TileSequence:
    """:func:`plan_t_sequence` in the form kernel K4 reads: output blocks
    are the plan's block columns, inputs its block rows."""
    t_row_seq, t_col_seq, t_flat = plan_t_sequence(plan)
    return TileSequence(t_row_seq[:-1], t_col_seq, t_flat,
                        n_out=plan.n_bcols, n_in=plan.n_brows)


def _k1(x: torch.Tensor, data_rp: torch.Tensor, plan: RowPackPlan, *,
        bias=None, act: str | None = None) -> torch.Tensor:
    """Kernel K1 on a CUDA ``x``, its plain version on a CPU ``x``."""
    if x.dim() != 2 or x.shape[1] != plan.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not fit a plan of shape "
                         f"{plan.shape}")
    if x.device.type == "cpu":
        return plan_fused_linear_plain(x, data_rp, plan, bias=bias, act=act)
    return plan_dds(x.contiguous(), data_rp, plan_schedule(plan),
                    n=plan.shape[0], tile=plan.tile, bias=bias, act=act)


class _PlanLinearPallas(torch.autograd.Function):
    """K1 forward; K4 (``plan_dds_t``) for dX and K5 (``plan_sddmm``) for
    the values' gradient -- the reference's ``_plan_pallas_bwd``."""

    @staticmethod
    def forward(ctx, x, data_rp, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, data_rp)
        return _k1(x, data_rp, plan)

    @staticmethod
    def backward(ctx, dy):
        x, data_rp = ctx.saved_tensors
        plan = ctx.plan
        dy = dy.contiguous()
        dx = ddata = None
        if ctx.needs_input_grad[0]:
            dx = plan_dds_t(dy, data_rp, plan_t_schedule(plan),
                            k=plan.shape[1], tile=plan.tile).to(x.dtype)
        if ctx.needs_input_grad[1]:
            sched = plan_schedule(plan)
            g = plan_sddmm(dy, x.contiguous().to(dy.dtype), sched,
                           tile=plan.tile, out_dtype=torch.float32)
            # schedule-ordered tile grads into the row-grouped layout by
            # index assignment; untouched (padding) slots stay exactly zero
            ddata = torch.zeros(data_rp.shape, dtype=torch.float32,
                                device=data_rp.device)
            ddata[_dev_index(plan, "vrow_seq", sched.vrow_seq, g.device),
                  _dev_index(plan, "slot_seq", sched.slot_seq, g.device)] = g
            ddata = ddata.to(data_rp.dtype)
        return dx, ddata, None


def plan_linear_pallas(x: torch.Tensor, data_rp: torch.Tensor,
                       plan: RowPackPlan) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T through kernel K1, differentiable through
    kernels K4 (dX) and K5 (the values' gradient; padding slots exactly
    zero). Same layout contract as :func:`plan_linear`; a CPU ``x`` runs
    the plain versions of all three."""
    return _PlanLinearPallas.apply(x, data_rp, plan)


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
    """Forward-only entry with the fused epilogue: bias add + activation
    ('relu' / 'gelu' / 'silu') folded into the kernel's single output
    write. A CPU ``x`` runs :func:`plan_fused_linear_plain`; a tensor on any
    other device goes to kernel K1, which launches or raises. It has no
    backward (as in the reference), so inputs that require grad raise
    rather than silently cut the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, data_rp, bias)):
        raise RuntimeError("plan_fused_linear is forward-only; use "
                           "plan_linear_pallas for a differentiable product")
    return _k1(x, data_rp, plan, bias=bias, act=act)


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


# --------------------------------------------------------------------------
# quantized packs: int8/fp8 block values, one fp32 scale per block
# --------------------------------------------------------------------------
#
# One scale per (bn, bk) tile keeps the dequant inside the block matmul: the
# plain path folds it into the gathered activations (xg * scale before the
# product -- exactly equivalent), kernel K6 multiplies each tile's partial
# product by it. Skinny tiles (bn*bk below _QUANT_BLOCK_MIN_ELEMS, e.g. the
# paper's 32x1 column blocks) fall back to one scale per virtual row.

QUANT_DTYPES = ("int8", "fp8")
#: per-block scales need bn*bk elements to amortize their 4 bytes; below
#: this the scale granularity falls back to one per row group (vrow)
_QUANT_BLOCK_MIN_ELEMS = 128
_FP8_MAX = 448.0                       # float8_e4m3fn finite max


def quant_granularity(tile: Tuple[int, int]) -> str:
    """'block' (one scale per (bn, bk) tile) for tiles that amortize the
    fp32 scale; 'row' (one per virtual row group) for skinny tiles."""
    return "block" if tile[0] * tile[1] >= _QUANT_BLOCK_MIN_ELEMS else "row"


def _qparams(qdtype: str):
    if qdtype == "int8":
        return 127.0, torch.int8
    if qdtype == "fp8":
        return _FP8_MAX, torch.float8_e4m3fn
    raise ValueError(f"qdtype={qdtype!r} not in {QUANT_DTYPES}")


def quantize_plan_values(data_rp, qdtype: str, granularity: str):
    """Row-grouped values (..., V, P, bn, bk) -> (qvalues, scales), on the
    values' device.

    Symmetric absmax quantization: ``scales`` is (..., V, P) fp32 for
    'block' granularity, (..., V, 1) for 'row'. All-zero groups (pruned
    padding slots) get scale 1.0 so dequant stays exact zero. Every step is
    an IEEE fp32 operation (division, round half to even, saturating
    clip), so the bytes equal the reference's."""
    if not isinstance(data_rp, torch.Tensor):
        data_rp = torch.from_numpy(np.ascontiguousarray(data_rp))
    d = data_rp.float()
    if granularity == "block":
        amax = d.abs().amax(dim=(-2, -1))                    # (..., V, P)
    elif granularity == "row":
        amax = d.abs().amax(dim=(-3, -2, -1))[..., None]
    else:
        raise ValueError(f"granularity={granularity!r}")
    qmax, qt = _qparams(qdtype)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its rounded reciprocal, which is not the reference's IEEE quotient
    q_max = torch.tensor(qmax, dtype=torch.float32, device=d.device)
    scales = torch.where(amax > 0, amax / q_max,
                         torch.ones_like(amax)).float()
    s = scales[..., None, None]                # broadcast over (bn, bk)
    if qdtype == "int8":
        q = torch.clamp(torch.round(d / s), -qmax, qmax).to(qt)
    else:
        q = (d / s).to(qt)
    return q, scales


def dequantize_plan_values(qvalues, scales) -> torch.Tensor:
    """(qvalues, scales) -> fp32 row-grouped values (the export-time
    round-trip check; serving never calls this -- the dequant stays fused
    in the matmul)."""
    return qvalues.float() * scales.float()[..., None, None]


def _scale_xg(xg: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    # xg (M, V, P, bk); scales (V, P) or (V, 1) -> broadcast over bk (and
    # over slots for row granularity)
    return xg.float() * scales.float()[..., None]


def _plan_q_fwd_f32(x, qvalues, scales, plan: RowPackPlan) -> torch.Tensor:
    m = x.shape[0]
    xs = _scale_xg(_gather_x(x, plan), scales)              # (M, V, P, bk)
    y = torch.einsum("mvpk,vpnk->vmn", xs, qvalues.float())  # (V, M, bn)
    if plan.spilled:
        y = torch.cat([y, y.new_zeros((1,) + tuple(y.shape[1:]))])
        y = y[_dev_index(plan, "vrow_segments", _vrow_segments(plan),
                         x.device)].sum(dim=1)                # (R, M, bn)
    return y.permute(1, 0, 2).reshape(m, plan.shape[0])


def _plan_q_fwd(x, qvalues, scales, plan: RowPackPlan) -> torch.Tensor:
    return _plan_q_fwd_f32(x, qvalues, scales, plan).to(x.dtype)


class _PlanQLinear(torch.autograd.Function):
    """``plan_q_linear`` with the reference's ``_plan_q_bwd``: dX with the
    dequant re-associated onto it, summed over ``col_idx`` in a fixed order;
    exactly zero gradient for the quantized values and the scales."""

    @staticmethod
    def forward(ctx, x, qvalues, scales, plan):
        ctx.plan = plan
        ctx.save_for_backward(qvalues, scales)
        ctx.x_meta = (x.shape[0], x.dtype)
        return _plan_q_fwd(x, qvalues, scales, plan)

    @staticmethod
    def backward(ctx, dy):
        qvalues, scales = ctx.saved_tensors
        plan = ctx.plan
        m, x_dtype = ctx.x_meta
        bn, bk = plan.tile
        dx = None
        if ctx.needs_input_grad[0]:
            dy_v = dy.reshape(m, plan.n_brows, bn).float()
            if plan.spilled:
                dy_v = dy_v[:, _dev_index(plan, "row_of_vrow",
                                          plan.row_of_vrow, dy.device)]
            dxg = torch.einsum("mvn,vpnk->mvpk", dy_v, qvalues.float())
            dxg = _scale_xg(dxg, scales)
            flat = dxg.reshape(m, plan.n_vrows * plan.p_max, bk)
            flat = torch.cat([flat, flat.new_zeros((m, 1, bk))], dim=1)
            idx = _dev_index(plan, "dx_segments", _dx_segments(plan),
                             dy.device)
            dx = flat[:, idx].sum(dim=2).reshape(m, plan.shape[1]).to(
                x_dtype)
        return (dx,
                torch.zeros_like(qvalues) if ctx.needs_input_grad[1]
                else None,
                torch.zeros_like(scales) if ctx.needs_input_grad[2]
                else None, None)


def plan_q_linear(x: torch.Tensor, qvalues: torch.Tensor,
                  scales: torch.Tensor, plan: RowPackPlan) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ dequant(Q)^T with the dequant fused: the scale
    multiplies the gathered activations (``xg[m, v, p, :] * scales[v, p]``,
    the per-block weight dequant re-associated onto the small operand), so
    fp32 weight values never exist. Differentiable in ``x``; the quantized
    values and scales are constants (their gradient is exactly zero)."""
    return _PlanQLinear.apply(x, qvalues, scales, plan)


def plan_q_matmul(x: torch.Tensor, qvalues, scales, plan: RowPackPlan):
    """Batched-x entry point for the dequant-fused plain plan backend."""
    lead = tuple(x.shape[:-1])
    y = plan_q_linear(x.reshape(-1, x.shape[-1]), qvalues, scales, plan)
    return y.reshape(lead + (plan.shape[0],))


def plan_q_linear_pallas(x: torch.Tensor, qvalues: torch.Tensor,
                         scales: torch.Tensor, plan: RowPackPlan, *,
                         bias=None, act: str | None = None) -> torch.Tensor:
    """Dequant-fused plan matmul through kernel K6 (``bsr_matmul.plan_dds_q``)
    with the same fused bias/act epilogue as :func:`plan_fused_linear`; a CPU
    ``x`` runs its plain version. Forward-only (the serving path): inputs
    that require grad raise rather than silently cut the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, qvalues, scales, bias)):
        raise RuntimeError("plan_q_linear_pallas is forward-only; use "
                           "plan_q_linear for a differentiable product")
    if x.dim() != 2 or x.shape[1] != plan.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not fit a plan of shape "
                         f"{plan.shape}")
    granularity = "row" if scales.shape[-1] == 1 else "block"
    return plan_dds_q(x.contiguous(), qvalues, scales, plan_schedule(plan),
                      n=plan.shape[0], tile=plan.tile,
                      granularity=granularity, bias=bias, act=act)


def plan_q_matmul_pallas(x: torch.Tensor, qvalues, scales,
                         plan: RowPackPlan):
    """Batched-x entry point for the dequant-fused kernel backend."""
    lead = tuple(x.shape[:-1])
    y = plan_q_linear_pallas(x.reshape(-1, x.shape[-1]), qvalues, scales,
                             plan)
    return y.reshape(lead + (plan.shape[0],))


@dataclasses.dataclass(frozen=True, eq=False)
class QuantPlan:
    """A RowPackPlan whose values are stored quantized (int8/fp8 + fp32
    scales) and served through the dequant-fused plan matmul.

    The params-tree entry for a QuantPlan pack is ``{"w": qvalues,
    "scale": scales}`` (the spec dtype cast and the byte accounting treat it
    specially; serving/servable.py). ``backend`` pins the execution path:
    'plan' = the plain composition (:func:`plan_q_matmul`), 'plan_pallas' =
    kernel K6 (:func:`plan_q_matmul_pallas`)."""

    plan: RowPackPlan
    qdtype: str = "int8"               # 'int8' | 'fp8'
    granularity: str = "block"         # 'block' (V, P) | 'row' (V, 1)
    backend: str = "plan"              # 'plan' | 'plan_pallas'

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
    def real_nnzt(self) -> int:
        return self.plan.real_nnzt

    @property
    def fingerprint(self) -> bytes:
        return (b"quant:" + self.qdtype.encode() + b":"
                + self.granularity.encode() + b":" + self.backend.encode()
                + b":" + self.plan.fingerprint)

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, QuantPlan)
                and self.fingerprint == other.fingerprint)


def quantize_for_plan(plan: RowPackPlan, data, qdtype: str, *,
                      backend: str = "plan"):
    """Packed tile values (..., nnzt, bn, bk) -> (QuantPlan, params dict):
    row-group the values (:func:`pack_plan_data`), pick the scale
    granularity from the tile, quantize where the values live."""
    data_rp = pack_plan_data(plan, data)
    granularity = quant_granularity(plan.tile)
    q, s = quantize_plan_values(data_rp, qdtype, granularity)
    qp = QuantPlan(plan, qdtype=qdtype, granularity=granularity,
                   backend=backend)
    return qp, {"w": q, "scale": s}
