"""Block-sparse linear layers: the host-side tile pack and kernels K1, K4,
K5, K6 and K7.

Counterpart of ``repro/kernels/bsr_matmul.py``:

  * :class:`KernelBSR` / :func:`pack_bsr` -- the offline tile-granular BSR
    pack, plain numpy, byte-identical to the reference;
  * :func:`plan_dds` (K1) -- ``Y = act(X @ W^T + bias)`` from the
    RowPackPlan's row-grouped ``(V, P, bn, bk)`` pack, walking the
    row-sorted tile schedule of ``exec_plan.plan_kernel_sequence``, by
    launching ``csrc/plan_dds.cu`` (which replaces the Pallas
    ``_plan_dds_kernel``; its body, shared with K6, is
    ``csrc/plan_dds_common.cuh``, in the instance :func:`plan_instance`
    picks). Its plain version, which CPU tensors run, is
    ``exec_plan.plan_fused_linear_plain``;
  * :func:`dds`, :func:`dds_t` and :func:`plan_dds_t` (K4) -- ``X @ W^T``
    over a flat KernelBSR and ``dY @ W`` over a KernelBSR or the plan
    layout, one kernel ``csrc/dds.cu`` (replacing ``_dds_kernel``) walking
    a row-sorted :class:`TileSequence`, the transposed products reading
    each tile through strides;
  * :func:`sddmm` and :func:`plan_sddmm` (K5) -- the stored tiles' gradient
    ``dW[j] = dY[:, row_j]^T @ X[:, col_j]``, kernel ``csrc/sddmm.cu``
    (replacing ``_sddmm_kernel``) in the instance :func:`sddmm_instance`
    picks;
  * :func:`plan_dds_q` (K6) -- K1 over int8 / fp8 tile values with fp32
    scales, each tile's partial product scaled before it joins the
    accumulator, kernel ``csrc/plan_dds_q.cu`` (replacing
    ``_plan_dds_q_kernel``);
  * :func:`masked_matmul` (K7) -- ``X @ W^T`` over a dense weight, skipping
    the tiles whose mask is 0 (the paper's negative control), kernel
    ``csrc/masked.cu`` (replacing ``_masked_kernel``) in the instance
    :func:`masked_instance` picks.

Every kernel wrapper runs its plain version (the reference's arithmetic in
torch ops, beside it here) on a CPU tensor, launches its kernel on a CUDA
tensor and counts the launch in ``<wrapper>.launches``, and raises on
anything else: nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Host-side packing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelBSR:
    """Tile-granular BSR pack (host numpy; the pattern is static metadata).

    row_id has one sentinel entry appended (== n_brows) so a kernel can
    detect the last tile of each block row without branching on bounds.
    """

    data: np.ndarray         # (nnzt, bn, bk) tile values (numpy or tensor)
    row_id: np.ndarray       # (nnzt + 1,) int32, sorted, sentinel-terminated
    col_id: np.ndarray       # (nnzt,) int32
    t_perm: np.ndarray       # (nnzt,) permutation sorting tiles by (col, row)
    real_nnzt: int           # stored tiles that are not padding
    shape: Tuple[int, int]   # (N, K)
    tile: Tuple[int, int]    # (bn, bk)

    @property
    def nnzt(self) -> int:
        return int(self.col_id.shape[0])

    @property
    def n_brows(self) -> int:
        return self.shape[0] // self.tile[0]

    @property
    def n_bcols(self) -> int:
        return self.shape[1] // self.tile[1]

    @property
    def density(self) -> float:
        return self.real_nnzt / max(1, self.n_brows * self.n_bcols)

    def pad_mask(self) -> np.ndarray:
        m = np.zeros((self.nnzt,), bool)
        m[: self.real_nnzt] = True
        return m

    # transpose-pattern views (for dX = dY @ W)
    def t_row_id(self) -> np.ndarray:
        t = self.col_id[self.t_perm]
        return np.concatenate([t, [self.n_bcols]]).astype(np.int32)

    def t_col_id(self) -> np.ndarray:
        return self.row_id[:-1][self.t_perm].astype(np.int32)


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.numpy()
    return np.asarray(w)


def pattern_from_mask(mask: np.ndarray, shape: Tuple[int, int],
                      tile: Tuple[int, int], nnzt: int | None = None,
                      dtype=np.float32) -> Tuple[KernelBSR, np.ndarray,
                                                 np.ndarray]:
    """The KernelBSR pattern of a (n_brows, n_bcols) tile mask, with every
    block row AND every block column given >= 1 stored tile (a zero tile
    where empty), so the write-on-row-change protocol covers all outputs in
    the forward and the transposed orientation. Returns (pack with zero
    ``data``, stored-tile rows, stored-tile cols) -- the caller fills
    ``data`` from the weight."""
    n, k = shape
    bn, bk = tile
    if n % bn or k % bk:
        raise ValueError(f"shape {shape} is not a multiple of tile {tile}")
    nbr = n // bn
    mask = np.array(mask, dtype=bool)
    for r in np.nonzero(~mask.any(axis=1))[0]:
        mask[r, 0] = True
    for c in np.nonzero(~mask.any(axis=0))[0]:
        mask[0, c] = True
    rows, cols = np.nonzero(mask)
    real = len(rows)
    if nnzt is None:
        nnzt = real
    if real > nnzt:
        raise ValueError(f"nnzt={nnzt} < required tiles {real}")
    row_id = np.full((nnzt + 1,), nbr, dtype=np.int32)
    row_id[:real] = rows
    row_id[real:nnzt] = nbr - 1        # padding tiles live in the last row
    col_id = np.zeros((nnzt,), dtype=np.int32)
    col_id[:real] = cols
    t_perm = np.lexsort((row_id[:nnzt], col_id)).astype(np.int32)
    data = np.zeros((nnzt, bn, bk), dtype=dtype)
    return (KernelBSR(data, row_id, col_id, t_perm, real, (n, k), tile),
            rows, cols)


def pack_bsr(w, tile: Tuple[int, int], nnzt: int | None = None) -> KernelBSR:
    """Pack a dense (N, K) weight (numpy or tensor) into a KernelBSR
    (pattern from :func:`pattern_from_mask` over the nonzero tiles)."""
    w = _host(w)
    n, k = w.shape
    bn, bk = tile
    assert n % bn == 0 and k % bk == 0, (w.shape, tile)
    blocks = w.reshape(n // bn, bn, k // bk, bk).transpose(0, 2, 1, 3)
    pack, rows, cols = pattern_from_mask(
        np.any(blocks != 0, axis=(2, 3)), (n, k), tile, nnzt, w.dtype)
    pack.data[:len(rows)] = blocks[rows, cols]
    return pack


# --------------------------------------------------------------------------
# K1: plan-consuming DDS over the row-grouped (V, P, bn, bk) pack
# --------------------------------------------------------------------------

ACTS = {None: 0, "relu": 1, "gelu": 2, "silu": 3}


def act_epilogue(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The fused activation, in the dtype of ``y`` (fp32 in the kernel)."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act == "silu":
        return y * torch.sigmoid(y)
    return y


class TileSequence:
    """A row-sorted tile sequence in the form kernels K1 and K4 read.

    ``row_ids`` (sorted, no sentinel) is each tile's output block,
    ``in_blocks`` the block of the input it reads and ``tiles`` its index in
    the flat tile values. The host derives, once, each output block's run
    ``seg[r]:seg[r + 1]``; :meth:`on` keeps one device copy per device.
    """

    def __init__(self, row_ids, in_blocks, tiles, *, n_out: int, n_in: int):
        row_ids = np.asarray(row_ids, np.int64)
        if np.any(np.diff(row_ids) < 0):
            raise ValueError("a tile sequence must be sorted by output block")
        self.n_out, self.n_in = n_out, n_in
        self.row_ids = row_ids.astype(np.int32)
        self.col_seq = np.asarray(in_blocks, np.int32)
        self.tile_seq = np.asarray(tiles, np.int32)
        self.seg = np.searchsorted(row_ids, np.arange(n_out + 1)).astype(
            np.int32)
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    @property
    def n_tiles(self) -> int:
        return int(self.tile_seq.shape[0])

    def on(self, device) -> Dict[str, torch.Tensor]:
        """The kernels' int32 ``seg``, ``row``, ``col`` and ``tile`` on
        ``device``, and ``head_tile`` / ``head_col`` (n_out, 32): the first
        32 tiles of each output block's run, 0 past its end, which K1 / K6's
        stream instance reads without waiting for ``seg``."""
        key = str(device)
        if key not in self._dev:
            head = self.seg[:-1, None] + np.arange(32)[None]
            ok = head < self.seg[1:, None]
            head = np.where(ok, head, 0)
            pick = (lambda a: np.where(ok, a[head], 0).astype(np.int32)
                    if self.n_tiles else np.zeros(head.shape, np.int32))
            arrs = {"seg": self.seg, "row": self.row_ids,
                    "col": self.col_seq, "tile": self.tile_seq,
                    "head_tile": pick(self.tile_seq),
                    "head_col": pick(self.col_seq)}
            self._dev[key] = {
                k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for k, a in arrs.items()}
        return self._dev[key]


class PlanSchedule(TileSequence):
    """The forward tile schedule of one plan: ``row_seq`` (sentinel-
    terminated), ``col_seq``, ``vrow_seq`` and ``slot_seq`` are
    ``exec_plan.plan_kernel_sequence``'s arrays; each tile's index in the
    flattened pack is ``vrow * P + slot``."""

    def __init__(self, row_seq, col_seq, vrow_seq, slot_seq, *,
                 n_brows: int, n_bcols: int, p_max: int):
        tiles = (np.asarray(vrow_seq, np.int64) * p_max
                 + np.asarray(slot_seq, np.int64))
        super().__init__(np.asarray(row_seq)[:-1], col_seq, tiles,
                         n_out=n_brows, n_in=n_bcols)
        self.n_brows, self.n_bcols, self.p_max = n_brows, n_bcols, p_max
        self.vrow_seq = np.asarray(vrow_seq, np.int64)
        self.slot_seq = np.asarray(slot_seq, np.int64)


# K1 plan_dds_launch(x, w, bias, y, seg, col, tile, head_tile, head_col, M,
# K, N, n_brows, bn, bk, x_bf16, w_bf16, act, instance, smem, stream)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_library
        lib = load_library("plan_dds")
        lib.plan_dds_launch.argtypes = _ARGTYPES
        lib.plan_dds_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# --------------------------------------------------------------------------
# The instances of K1 and K6 (csrc/plan_dds_common.cuh), in the order the
# wrapper prefers them: the first that takes a call runs it.
#   stream  -- M <= 16 (decode): warps stream tile rows, 4 values a lane,
#              the lanes added by a fixed shuffle tree;
#   tc      -- bf16 x with bf16 / int8 / fp8 values: bf16 tensor cores
#              (mma.sync m16n8k16), fp32 accumulation, a cp.async ring;
#   fp32    -- fp32 FMA through the same ring (fp32 x, or fp32 values);
#   general -- the scalar kernel: any tile, any alignment.
# --------------------------------------------------------------------------

PLAN_INSTANCES = ("stream", "tc", "fp32", "general")
_INSTANCE_CODE = {"general": 0, "stream": 1, "fp32": 2, "tc": 3}
#: the most rows of X the stream instance takes
STREAM_MAX_M = 16
# ring geometry of the fp32 and tc instances: (slab depth, stages, rows of
# x a stage holds); a stage holds 64 rows of values
_RING = {"fp32": (16, 4, 64), "tc": (32, 6, 64)}


def instance_takes(instance: str, m: int, tile: Tuple[int, int], x_dtype,
                   v_dtype, aligned: bool = True) -> bool:
    """Whether K1 / K6 instance ``instance`` takes M=``m`` rows of ``x_dtype``
    against ``tile``-shaped values of ``v_dtype``. Every instance but
    'general' reads 16-deep chunks (bk % 16 == 0) in 8-row fragments
    (bn % 8 == 0) from 16-byte aligned x and values; 'stream' gives each
    of up to 32 lanes 4 values of a tile row (bk <= 128)."""
    if instance == "general":
        return True
    if instance not in _INSTANCE_CODE:
        raise ValueError(f"unknown instance {instance!r}")
    bn, bk = tile
    if not aligned or bk % 16 or bn % 8:
        return False
    vsize = torch.empty((), dtype=v_dtype).element_size()
    if instance == "stream":
        return m <= STREAM_MAX_M and bk <= 128
    if instance == "tc":
        return x_dtype == torch.bfloat16 and vsize <= 2
    return True


def plan_instance(m: int, tile: Tuple[int, int], x_dtype, v_dtype,
                  aligned: bool = True) -> str:
    """The K1 / K6 instance for a call: the first of
    :data:`PLAN_INSTANCES` that takes it (:func:`instance_takes`). Chosen
    before the launch, from the shapes, dtypes and alignment alone."""
    return _choose("plan_dds", None, PLAN_INSTANCES, instance_takes,
                   (m, tile, x_dtype, v_dtype, aligned),
                   f"M={m}, tile {tuple(tile)}, x {x_dtype}, values "
                   f"{v_dtype} (16-byte aligned: {aligned})")


def plan_smem_bytes(instance: str, x_dtype, v_dtype) -> int:
    """Dynamic shared memory of an instance: the fp32 / tc ring's stages of
    ``rows`` rows of x and 64 rows of values, each row padded to a 16-byte
    multiple (``ring_pitch`` in plan_dds_common.cuh); 0 for the others."""
    if instance not in _RING:
        return 0
    depth, stages, rows = _RING[instance]

    def pitch(dtype):
        row = depth * torch.empty((), dtype=dtype).element_size()
        return max(row + 16, 48)
    return stages * (rows * pitch(x_dtype) + 64 * pitch(v_dtype))


def _choose(what: str, instance: Optional[str], instances, takes, args,
            desc: str) -> str:
    """The instance that runs a call: by default the first of ``instances``
    that takes it (``takes(i, *args)``); a pinned ``instance`` that does
    not take it raises, and so does a call no instance takes (nothing is
    padded to fit one)."""
    if instance is None:
        inst = next((i for i in instances if takes(i, *args)), None)
        if inst is None:
            raise ValueError(f"{what}: no instance of {tuple(instances)} "
                             f"takes {desc}")
        return inst
    if not takes(instance, *args):
        raise ValueError(f"{what}: instance {instance!r} does not take "
                         f"{desc}")
    return instance


def _pick_instance(what: str, instance: Optional[str], m: int, tile, x,
                   values) -> str:
    aligned = x.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    return _choose(what, instance, PLAN_INSTANCES, instance_takes,
                   (m, tile, x.dtype, values.dtype, aligned),
                   f"M={m}, tile {tuple(tile)}, x {x.dtype}, values "
                   f"{values.dtype} (16-byte aligned: {aligned})")


def plan_dds(x: torch.Tensor, data_rp: torch.Tensor, schedule: PlanSchedule,
             *, n: int, tile: Tuple[int, int],
             bias: Optional[torch.Tensor] = None,
             act: Optional[str] = None,
             instance: Optional[str] = None) -> torch.Tensor:
    """Y(M, N) = act(X(M, K) @ W^T + bias) from the (V, P, bn, bk) pack,
    through kernel K1 (built on first use); each launch counts in
    ``plan_dds.launches``.

    ``schedule`` is the plan's :class:`PlanSchedule`. The kernel takes CUDA
    ``x`` and ``data_rp`` in fp32 or bf16, accumulates in fp32 and writes
    ``x``'s dtype; anything it does not take raises -- nothing falls back.
    ``instance`` pins one of :data:`PLAN_INSTANCES` (it must take the call);
    by default :func:`plan_instance` picks it.
    """
    m, k = x.shape
    bn, bk = tile
    r = schedule.n_brows
    if (data_rp.dim() != 4 or tuple(data_rp.shape[2:]) != (bn, bk)
            or data_rp.shape[1] != schedule.p_max or n != r * bn
            or k != schedule.n_bcols * bk):
        raise ValueError(f"plan_dds: x {tuple(x.shape)}, data_rp "
                         f"{tuple(data_rp.shape)}, n={n}, tile={tile}, "
                         f"plan of {r}x{schedule.n_bcols} blocks")
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"plan_dds has no kernel for {x.device}; the plain version is "
            f"exec_plan.plan_fused_linear_plain")
    if data_rp.device != x.device:
        raise ValueError(f"data_rp on {data_rp.device}, x on {x.device}")
    if x.dtype not in _KERNEL_DTYPES or data_rp.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"plan_dds kernel takes fp32/bf16, got x {x.dtype}, "
                        f"data_rp {data_rp.dtype}")
    if not (x.is_contiguous() and data_rp.is_contiguous()):
        raise ValueError("plan_dds kernel needs contiguous x and data_rp")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    inst = _pick_instance("plan_dds", instance, m, tile, x, data_rp)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    b = None
    if bias is not None:
        b = bias.reshape(n).to(device=x.device, dtype=torch.float32)
        b = b.contiguous()
    ix = schedule.on(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_lib().plan_dds_launch(
        x.data_ptr(), data_rp.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), ix["seg"].data_ptr(), ix["col"].data_ptr(),
        ix["tile"].data_ptr(), ix["head_tile"].data_ptr(),
        ix["head_col"].data_ptr(),
        m, k, n, r, bn, bk, int(x.dtype == torch.bfloat16),
        int(data_rp.dtype == torch.bfloat16), ACTS[act],
        _INSTANCE_CODE[inst], plan_smem_bytes(inst, x.dtype, data_rp.dtype),
        stream)
    _check_launch("plan_dds", err)
    plan_dds.launches += 1
    return y


plan_dds.launches = 0


# --------------------------------------------------------------------------
# the shared host side of K4 and K5
# --------------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}
# K4 dds_launch(x, w, y, seg, in_blk, tile_seq, M, K_in, N_out, n_out, ow,
# iw, transposed, x_bf16, w_bf16, instance, block_rows, stream); K5
# sddmm_launch(dy, x, out, part, row_blk, col_blk, M, N, K, bn, bk, n_tiles,
# n_real, a_bf16, out_bf16, instance, splits, chunk, stream)
# K6 plan_dds_q_launch(x, q, scales, bias, y, seg, col, tile, head_tile,
# head_col, M, K, N, n_brows, bn, bk, p_max, row_gran, x_bf16, w_fp8, act,
# instance, smem, stream); K7 masked_launch(x, w, mask, y, M, K, N, bn, bk,
# x_bf16, w_bf16, instance, block_rows, stream)
_ENTRY = {
    "dds": ("dds_launch",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "sddmm": ("sddmm_launch",
              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
              + [ctypes.c_void_p]),
    "plan_dds_q": ("plan_dds_q_launch",
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p]),
    "masked": ("masked_launch",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
               + [ctypes.c_void_p]),
}


def _entry(name: str):
    """The C entry point of library ``name`` (built on first use)."""
    if name not in _LIBS:
        from repro_torch.kernels.build import load_library
        lib = load_library(name)
        fn_name, argtypes = _ENTRY[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(_LIBS[name], _ENTRY[name][0])


def _device_route(what: str, *tensors) -> bool:
    """True to launch the kernel (CUDA tensors), False for the plain
    version (CPU tensors); raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise NotImplementedError(f"{what} has no kernel for {dev}")
    for t in tensors:
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{what} kernel takes fp32/bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous inputs")
    return True


def _check_launch(what: str, err: int):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def tile_values(w: KernelBSR, like: torch.Tensor) -> torch.Tensor:
    """The pack's tile values as a tensor on ``like``'s device."""
    d = w.data
    if not isinstance(d, torch.Tensor):
        d = torch.from_numpy(np.ascontiguousarray(d))
    return d.to(like.device)


def core_bsr(w: KernelBSR, data: torch.Tensor):
    """View a KernelBSR pattern with values ``data`` as a core BSR (the
    plain compositions' operand)."""
    from repro_torch.core.bsr import BSR
    counts = np.bincount(w.row_id[:-1], minlength=w.n_brows)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BSR(data, np.asarray(w.col_id, np.int32), indptr, w.shape,
               w.tile)


def _pattern_key(w: KernelBSR, kind: str) -> tuple:
    return (kind, w.shape, w.tile, w.real_nnzt, w.row_id.tobytes(),
            w.col_id.tobytes())


_SEQ_CACHE: Dict[tuple, TileSequence] = {}


def bsr_sequence(w: KernelBSR) -> TileSequence:
    """K4's sequence for ``dds``: every stored tile (padding included, as
    the reference's grid visits it) in the pack's row-sorted order."""
    key = _pattern_key(w, "fwd")
    if key not in _SEQ_CACHE:
        _SEQ_CACHE[key] = TileSequence(
            w.row_id[:-1], w.col_id, np.arange(w.nnzt), n_out=w.n_brows,
            n_in=w.n_bcols)
    return _SEQ_CACHE[key]


def bsr_t_sequence(w: KernelBSR) -> TileSequence:
    """K4's sequence for ``dds_t``: the tiles sorted by (block column,
    block row) through ``t_perm``; output blocks are W's block columns."""
    key = _pattern_key(w, "t")
    if key not in _SEQ_CACHE:
        _SEQ_CACHE[key] = TileSequence(
            w.t_row_id()[:-1], w.t_col_id(), w.t_perm, n_out=w.n_bcols,
            n_in=w.n_brows)
    return _SEQ_CACHE[key]


# --------------------------------------------------------------------------
# K4: DDS over a row-sorted tile sequence (dds, dds_t, plan_dds_t)
# --------------------------------------------------------------------------

# The instances of K4 (csrc/dds.cu), in the order the wrapper prefers them:
#   ring    -- fp32 X and tile values, 16-byte aligned, a depth iw that is a
#              multiple of 16 and an output width ow of 4: a cp.async ring
#              over the run's flattened (tile, slab) sequence; blocks of
#              dds_block_rows rows of X;
#   general -- the scalar kernel: any tile down to (32, 1), bf16, any
#              alignment.
# Both sum each output in one fmaf chain over the run's tiles in order, k
# ascending inside each tile, so they agree bit for bit.
DDS_INSTANCES = ("ring", "general")
_DDS_CODE = {"general": 0, "ring": 1}
#: the ring's blocks take 32 rows of X where 64-row blocks would give the
#: H100's 132 SMs fewer blocks than this (K7's rule)
DDS_SMALL_GRID = 4 * 132


def dds_takes(instance: str, m: int, tile: Tuple[int, int], dtype,
              transposed: bool, aligned: bool = True) -> bool:
    """Whether K4 instance ``instance`` takes M=``m`` rows against stored
    ``tile`` (bn, bk) values, read as they are (``dds``: depth iw = bk,
    output width ow = bn) or ``transposed`` (``dds_t`` / ``plan_dds_t``:
    iw = bn, ow = bk), with X and the values in ``dtype`` (bf16 where either
    is): 'ring' copies 16-deep fp32 slabs 16 bytes at a time (iw % 16 == 0,
    ow % 4 == 0, 16-byte aligned operands)."""
    if instance == "general":
        return True
    if instance not in _DDS_CODE:
        raise ValueError(f"unknown instance {instance!r}")
    ow, iw = (tile[1], tile[0]) if transposed else tuple(tile)
    return (aligned and dtype == torch.float32 and iw % 16 == 0
            and ow % 4 == 0)


def dds_instance(m: int, tile: Tuple[int, int], dtype, transposed: bool,
                 aligned: bool = True) -> str:
    """The K4 instance for a call: the first of :data:`DDS_INSTANCES` that
    takes it (:func:`dds_takes`), chosen before the launch."""
    return next(i for i in DDS_INSTANCES
                if dds_takes(i, m, tile, dtype, transposed, aligned))


def dds_block_rows(m: int, n_out: int, ow: int) -> int:
    """Rows of X a ring block takes (K4 over ``n_out`` output blocks of
    ``ow`` columns, K7 over N tiles of bn rows), from M and the grid alone:
    64, or 32 where 64-row blocks would number fewer than
    :data:`DDS_SMALL_GRID`."""
    blocks = -(-m // 64) * n_out * (-(-ow // 64))
    return 32 if blocks < DDS_SMALL_GRID else 64


def _dds_launch(what: str, x: torch.Tensor, values: torch.Tensor,
                seq: TileSequence, *, tile: Tuple[int, int],
                transposed: bool, instance: Optional[str]) -> torch.Tensor:
    """Y(M, n_out * ow) with output block r = sum over its run of tiles j of
    X[:, in_j * iw : (in_j + 1) * iw] @ T_j^T, T_j the tile (ow, iw) --
    the stored (bn, bk) ``tile`` as it is (ow=bn, iw=bk) or, ``transposed``,
    its transpose (ow=bk, iw=bn). Checked by the caller; the instance is
    chosen (or the pinned one checked) before the launch."""
    m = x.shape[0]
    ow, iw = (tile[1], tile[0]) if transposed else tuple(tile)
    aligned = x.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    # operands of two dtypes: one of them is bf16
    dtype = x.dtype if values.dtype == x.dtype else torch.bfloat16
    inst = _choose(what, instance, DDS_INSTANCES, dds_takes,
                   (m, tile, dtype, transposed, aligned),
                   f"tile {tuple(tile)} (transposed: {transposed}), x "
                   f"{x.dtype}, values {values.dtype} (16-byte aligned: "
                   f"{aligned})")
    n_out = seq.n_out * ow
    y = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    ix = seq.on(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry("dds")(
        x.data_ptr(), values.data_ptr(), y.data_ptr(), ix["seg"].data_ptr(),
        ix["col"].data_ptr(), ix["tile"].data_ptr(), m, x.shape[1], n_out,
        seq.n_out, ow, iw, int(transposed), int(x.dtype == torch.bfloat16),
        int(values.dtype == torch.bfloat16), _DDS_CODE[inst],
        dds_block_rows(m, seq.n_out, ow), stream)
    _check_launch(what, err)
    return y


def _check_seq_values(what, values, seq: TileSequence, tile):
    if (values.dim() != 3 or tuple(values.shape[1:]) != tuple(tile)
            or (seq.n_tiles and int(seq.tile_seq.max()) >= values.shape[0])):
        raise ValueError(f"{what}: tile values {tuple(values.shape)} do not "
                         f"fit tile {tile} and the sequence's "
                         f"{seq.n_tiles} tiles")


def dds_plain(x: torch.Tensor, w: KernelBSR,
              data: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`dds`: the reference's gather composition."""
    from repro_torch.kernels.ref import bsr_matmul_gather
    data = tile_values(w, x) if data is None else data
    return bsr_matmul_gather(x, core_bsr(w, data))


def dds(x: torch.Tensor, w: KernelBSR,
        data: Optional[torch.Tensor] = None, *,
        instance: Optional[str] = None) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T with tile skipping (kernel K4 over the pack's
    row-sorted tiles). ``data`` overrides the pack's tile values;
    ``instance`` pins one of :data:`DDS_INSTANCES` on the card (it must take
    the call), by default :func:`dds_instance` picks it."""
    data = tile_values(w, x) if data is None else data
    if x.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"dds: x {tuple(x.shape)} against W {w.shape}")
    seq = bsr_sequence(w)
    _check_seq_values("dds", data, seq, w.tile)
    if not _device_route("dds", x, data):
        return dds_plain(x, w, data)
    y = _dds_launch("dds", x, data, seq, tile=w.tile, transposed=False,
                    instance=instance)
    dds.launches += 1
    return y


def dds_t_plain(dy: torch.Tensor, w: KernelBSR,
                data: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`dds_t`: the reference's transpose gather."""
    from repro_torch.kernels.ref import bsr_matmul_t_gather
    data = tile_values(w, dy) if data is None else data
    return bsr_matmul_t_gather(dy, core_bsr(w, data))


def dds_t(dy: torch.Tensor, w: KernelBSR,
          data: Optional[torch.Tensor] = None, *,
          instance: Optional[str] = None) -> torch.Tensor:
    """dX(M, K) = dY(M, N) @ W: kernel K4 on the column-sorted transposed
    pattern, each tile read as its transpose in place; ``instance`` as for
    :func:`dds`."""
    data = tile_values(w, dy) if data is None else data
    if dy.dim() != 2 or dy.shape[1] != w.shape[0]:
        raise ValueError(f"dds_t: dy {tuple(dy.shape)} against W {w.shape}")
    seq = bsr_t_sequence(w)
    _check_seq_values("dds_t", data, seq, w.tile)
    if not _device_route("dds_t", dy, data):
        return dds_t_plain(dy, w, data)
    dx = _dds_launch("dds_t", dy, data, seq, tile=w.tile, transposed=True,
                     instance=instance)
    dds_t.launches += 1
    return dx


def plan_dds_t_plain(dy: torch.Tensor, data_rp: torch.Tensor,
                     t_schedule: TileSequence, *, k: int,
                     tile: Tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`plan_dds_t`: per tile of the transposed
    schedule ``dY[:, row] @ T``, ordered segment sum into block columns."""
    from repro_torch.kernels.ref import segment_sum
    bn, bk = tile
    m, n = dy.shape
    dev = dy.device
    flat = data_rp.reshape(-1, bn, bk)[torch.from_numpy(
        t_schedule.tile_seq.astype(np.int64)).to(dev)]
    g = dy.reshape(m, n // bn, bn)[:, torch.from_numpy(
        t_schedule.col_seq.astype(np.int64)).to(dev)]        # (M, J, bn)
    prod = torch.einsum("mjn,jnk->jmk", g.float(), flat.float())
    dx = segment_sum(prod, t_schedule.row_ids, k // bk)     # (C, M, bk)
    return dx.permute(1, 0, 2).reshape(m, k).to(dy.dtype)


def plan_dds_t(dy: torch.Tensor, data_rp: torch.Tensor,
               t_schedule: TileSequence, *, k: int,
               tile: Tuple[int, int],
               instance: Optional[str] = None) -> torch.Tensor:
    """dX(M, K) = dY(M, N) @ W from the row-grouped (V, P, bn, bk) pack, on
    the transposed schedule (``exec_plan.plan_t_schedule``): kernel K4
    reads the pack in place, each tile as its transpose; ``instance`` as
    for :func:`dds`."""
    bn, bk = tile
    if (dy.dim() != 2 or dy.shape[1] != t_schedule.n_in * bn
            or k != t_schedule.n_out * bk or data_rp.dim() != 4):
        raise ValueError(f"plan_dds_t: dy {tuple(dy.shape)}, data_rp "
                         f"{tuple(data_rp.shape)}, k={k}, tile={tile}")
    values = data_rp.reshape(-1, bn, bk)
    _check_seq_values("plan_dds_t", values, t_schedule, tile)
    if not _device_route("plan_dds_t", dy, data_rp):
        return plan_dds_t_plain(dy, data_rp, t_schedule, k=k, tile=tile)
    dx = _dds_launch("plan_dds_t", dy, values, t_schedule, tile=tile,
                     transposed=True, instance=instance)
    plan_dds_t.launches += 1
    return dx


dds.launches = 0
dds_t.launches = 0
plan_dds_t.launches = 0


# --------------------------------------------------------------------------
# K5: SDDMM, the stored tiles' gradient (sddmm, plan_sddmm)
# --------------------------------------------------------------------------

# The instances of K5 (csrc/sddmm.cu), in the order the wrapper prefers them:
#   ring    -- fp32 dY and X, bn and bk multiples of 4, 16-byte aligned: M cut
#              into sddmm_splits chunks, each streamed through a cp.async
#              ring, the chunks' fp32 partials added in split order;
#   general -- the scalar kernel over all of M: any tile, bf16, any alignment.
SDDMM_INSTANCES = ("ring", "general")
_SDDMM_CODE = {"general": 0, "ring": 1}
#: the (tile, 64x64 sub-tile, split) blocks the ring's grid aims at: two
#: waves of the 7 ring blocks each of the H100's 132 SMs holds at once
SDDMM_TARGET_BLOCKS = 16 * 132
#: the most chunks M is cut into
SDDMM_MAX_SPLITS = 8
#: chunk edges are multiples of the reference's bm where M allows
SDDMM_SPLIT_ROWS = 128


def sddmm_takes(instance: str, m: int, tile: Tuple[int, int], dtype,
                aligned: bool = True) -> bool:
    """Whether K5 instance ``instance`` takes M=``m`` rows of dY and X in
    ``dtype`` against ``tile``: 'ring' copies 16 bytes of fp32 at a time
    (bn and bk multiples of 4, 16-byte aligned operands)."""
    if instance == "general":
        return True
    if instance not in _SDDMM_CODE:
        raise ValueError(f"unknown instance {instance!r}")
    bn, bk = tile
    return aligned and dtype == torch.float32 and bn % 4 == 0 and bk % 4 == 0


def sddmm_instance(m: int, tile: Tuple[int, int], dtype,
                   aligned: bool = True) -> str:
    """The K5 instance for a call: the first of :data:`SDDMM_INSTANCES` that
    takes it (:func:`sddmm_takes`), chosen before the launch."""
    return next(i for i in SDDMM_INSTANCES
                if sddmm_takes(i, m, tile, dtype, aligned))


def sddmm_splits(m: int, n_tiles: int, tile: Tuple[int, int],
                 splits: Optional[int] = None) -> Tuple[int, int]:
    """(S, chunk) of the ring instance: M cut into S chunks of ``chunk``
    rows (the last may be shorter, none is empty), summed apart and added in
    split order. S is chosen from the number of 64x64 sub-tile blocks and M
    alone: enough chunks that the grid reaches :data:`SDDMM_TARGET_BLOCKS`,
    at most :data:`SDDMM_MAX_SPLITS` and none shorter than
    :data:`SDDMM_SPLIT_ROWS` rows. ``splits`` asks for S instead; chunk
    edges are multiples of SDDMM_SPLIT_ROWS where M allows."""
    bn, bk = tile
    if splits is None:
        blocks = n_tiles * (-(-bn // 64)) * (-(-bk // 64))
        splits = min(SDDMM_MAX_SPLITS, m // SDDMM_SPLIT_ROWS,
                     -(-SDDMM_TARGET_BLOCKS // max(1, blocks)))
    if splits < 1:
        splits = 1
    if splits == 1 or n_tiles == 0:
        return 1, m
    chunk = -(-m // splits)
    if m >= SDDMM_SPLIT_ROWS * splits:
        chunk = -(-chunk // SDDMM_SPLIT_ROWS) * SDDMM_SPLIT_ROWS
    return -(-m // chunk), chunk


def _sddmm_launch(what: str, dy: torch.Tensor, x: torch.Tensor, row_blk,
                  col_blk, *, tile: Tuple[int, int], n_real: int,
                  out_dtype: torch.dtype, instance: Optional[str],
                  splits: Optional[int]) -> torch.Tensor:
    """(J, bn, bk) tile gradients for tiles at block (row_blk[j],
    col_blk[j]); tiles j >= n_real are written as zeros."""
    bn, bk = tile
    if dy.dtype != x.dtype:
        raise TypeError(f"sddmm kernel takes dy and x of one dtype, got "
                        f"{dy.dtype} and {x.dtype}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"sddmm kernel writes fp32/bf16, not {out_dtype}")
    m = dy.shape[0]
    aligned = dy.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    inst = _choose(what, instance, SDDMM_INSTANCES, sddmm_takes,
                   (m, tile, dy.dtype, aligned),
                   f"tile {tuple(tile)}, {dy.dtype} (16-byte aligned: "
                   f"{aligned})")
    if inst == "general" and splits not in (None, 1):
        raise ValueError(f"{what}: the general instance sums M in one chunk, "
                         f"not {splits}")
    j = int(row_blk.shape[0])
    out = torch.empty((j, bn, bk), dtype=out_dtype, device=dy.device)
    if j == 0:
        return out
    if m == 0:
        return out.zero_()
    s, chunk = ((1, m) if inst == "general"
                else sddmm_splits(m, n_real, tile, splits))
    part = (torch.empty((s, n_real, bn, bk), dtype=torch.float32,
                        device=dy.device) if s > 1 else None)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    err = _entry("sddmm")(
        dy.data_ptr(), x.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), row_blk.data_ptr(),
        col_blk.data_ptr(), m, dy.shape[1], x.shape[1], bn, bk, j, n_real,
        int(dy.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _SDDMM_CODE[inst], s, chunk, stream)
    _check_launch(what, err)
    return out


def _check_sddmm(what, dy, x, n, k):
    if (dy.dim() != 2 or x.dim() != 2 or dy.shape[0] != x.shape[0]
            or dy.shape[1] != n or x.shape[1] != k):
        raise ValueError(f"{what}: dy {tuple(dy.shape)}, x {tuple(x.shape)} "
                         f"against W ({n}, {k})")


def sddmm_plain(dy: torch.Tensor, x: torch.Tensor, w: KernelBSR,
                data: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`sddmm`: ``ref.sddmm_ref``, padding tiles
    zeroed."""
    from repro_torch.kernels.ref import sddmm_ref
    data = tile_values(w, dy) if data is None else data
    g = sddmm_ref(dy, x, core_bsr(w, data))
    return g * torch.from_numpy(w.pad_mask()).to(g.device)[:, None, None]


def sddmm(dy: torch.Tensor, x: torch.Tensor, w: KernelBSR,
          data: Optional[torch.Tensor] = None, *,
          instance: Optional[str] = None,
          splits: Optional[int] = None) -> torch.Tensor:
    """Gradient w.r.t. the stored tiles: (nnzt, bn, bk) in the values'
    dtype, padding tiles exactly zero (they must stay dead). Kernel K5;
    ``instance`` pins one of :data:`SDDMM_INSTANCES` (it must take the
    call) and ``splits`` the ring's S (:func:`sddmm_splits`)."""
    data = tile_values(w, dy) if data is None else data
    _check_sddmm("sddmm", dy, x, *w.shape)
    if not _device_route("sddmm", dy, x):
        return sddmm_plain(dy, x, w, data)
    ix = bsr_sequence(w).on(dy.device)
    g = _sddmm_launch("sddmm", dy, x, ix["row"], ix["col"], tile=w.tile,
                      n_real=w.real_nnzt, out_dtype=data.dtype,
                      instance=instance, splits=splits)
    sddmm.launches += 1
    return g


def plan_sddmm_plain(dy: torch.Tensor, x: torch.Tensor,
                     schedule: TileSequence, *, tile: Tuple[int, int],
                     out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`plan_sddmm`: gathered blocks, one einsum."""
    bn, bk = tile
    m = dy.shape[0]
    dev = dy.device
    gy = dy.reshape(m, -1, bn)[:, torch.from_numpy(
        schedule.row_ids.astype(np.int64)).to(dev)]
    gx = x.reshape(m, -1, bk)[:, torch.from_numpy(
        schedule.col_seq.astype(np.int64)).to(dev)]
    return torch.einsum("mjn,mjk->jnk", gy.float(), gx.float()).to(out_dtype)


def plan_sddmm(dy: torch.Tensor, x: torch.Tensor, schedule: TileSequence, *,
               tile: Tuple[int, int], out_dtype=torch.float32,
               instance: Optional[str] = None,
               splits: Optional[int] = None) -> torch.Tensor:
    """Per-tile gradient ``dW[j] = dY[:, row_j]^T @ X[:, col_j]`` over the
    schedule order (``exec_plan.plan_schedule``); (J, bn, bk) in
    ``out_dtype``. Every schedule tile is real. Kernel K5, with
    ``instance`` and ``splits`` as for :func:`sddmm`."""
    bn, bk = tile
    _check_sddmm("plan_sddmm", dy, x, schedule.n_out * bn,
                 schedule.n_in * bk)
    if not _device_route("plan_sddmm", dy, x):
        return plan_sddmm_plain(dy, x, schedule, tile=tile,
                                out_dtype=out_dtype)
    ix = schedule.on(dy.device)
    g = _sddmm_launch("plan_sddmm", dy, x, ix["row"], ix["col"], tile=tile,
                      n_real=schedule.n_tiles, out_dtype=out_dtype,
                      instance=instance, splits=splits)
    plan_sddmm.launches += 1
    return g


sddmm.launches = 0
plan_sddmm.launches = 0


# --------------------------------------------------------------------------
# K6: plan-consuming DDS over quantized (int8 / fp8) tile values
# --------------------------------------------------------------------------

QUANT_VALUE_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _check_plan_dds_q(x, qvalues, scales, schedule: PlanSchedule, n, tile,
                      granularity, act):
    m, k = x.shape
    bn, bk = tile
    v = qvalues.shape[0] if qvalues.dim() == 4 else -1
    want_s = (v, schedule.p_max if granularity == "block" else 1)
    if (qvalues.dim() != 4 or tuple(qvalues.shape[2:]) != (bn, bk)
            or qvalues.shape[1] != schedule.p_max
            or n != schedule.n_brows * bn or k != schedule.n_bcols * bk
            or granularity not in ("block", "row")
            or tuple(scales.shape) != want_s
            or (schedule.n_tiles
                and int(schedule.tile_seq.max()) >= v * schedule.p_max)):
        raise ValueError(
            f"plan_dds_q: x {tuple(x.shape)}, qvalues "
            f"{tuple(qvalues.shape)}, scales {tuple(scales.shape)}, n={n}, "
            f"tile={tile}, granularity={granularity!r}, plan of "
            f"{schedule.n_brows}x{schedule.n_bcols} blocks, P="
            f"{schedule.p_max}")
    if qvalues.dtype not in QUANT_VALUE_DTYPES:
        raise TypeError(f"plan_dds_q takes int8 / float8_e4m3fn values, "
                        f"got {qvalues.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"plan_dds_q takes fp32 scales, got {scales.dtype}")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")


def plan_dds_q_plain(x: torch.Tensor, qvalues: torch.Tensor,
                     scales: torch.Tensor, schedule: PlanSchedule, *, n: int,
                     tile: Tuple[int, int], granularity: str = "block",
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`plan_dds_q`: the schedule walked tile by tile
    -- tile j's fp32 partial product ``X[:, col_j] @ Q_j^T`` times its scale
    -- summed in schedule order into its output block row, then the bias
    and activation in fp32, cast to ``x``'s dtype."""
    from repro_torch.kernels.ref import segment_sum
    bn, bk = tile
    m = x.shape[0]
    dev = x.device
    tiles = torch.from_numpy(schedule.tile_seq.astype(np.int64)).to(dev)
    cols = torch.from_numpy(schedule.col_seq.astype(np.int64)).to(dev)
    q = qvalues.reshape(-1, bn, bk)[tiles].float()            # (J, bn, bk)
    s_idx = tiles if granularity == "block" else tiles // schedule.p_max
    s = scales.reshape(-1)[s_idx].float()                      # (J,)
    xg = x.reshape(m, -1, bk)[:, cols].float()                 # (M, J, bk)
    part = torch.einsum("mjk,jnk->jmn", xg, q)                 # (J, M, bn)
    y = segment_sum(s[:, None, None] * part, schedule.row_ids,
                    schedule.n_brows)                          # (R, M, bn)
    y = y.permute(1, 0, 2).reshape(m, n)
    if bias is not None:
        y = y + bias.reshape(1, n).float()
    return act_epilogue(y, act).to(x.dtype)


def plan_dds_q(x: torch.Tensor, qvalues: torch.Tensor, scales: torch.Tensor,
               schedule: PlanSchedule, *, n: int, tile: Tuple[int, int],
               granularity: str = "block",
               bias: Optional[torch.Tensor] = None,
               act: Optional[str] = None,
               instance: Optional[str] = None) -> torch.Tensor:
    """Y(M, N) = act(X(M, K) @ dequant(Q)^T + bias) from the quantized
    (V, P, bn, bk) pack: int8 or float8_e4m3fn ``qvalues`` with fp32
    ``scales`` (V, P) ('block' granularity) or (V, 1) ('row'), over the
    plan's :class:`PlanSchedule`. Kernel K6 on CUDA tensors (each launch
    counts in ``plan_dds_q.launches``), :func:`plan_dds_q_plain` on CPU
    tensors; x in fp32 or bf16, fp32 accumulation, output in x's dtype.
    Anything else raises -- nothing falls back. ``instance`` pins one of
    :data:`PLAN_INSTANCES` on the card, as for :func:`plan_dds`."""
    _check_plan_dds_q(x, qvalues, scales, schedule, n, tile, granularity,
                      act)
    dev = x.device
    for t in (qvalues, scales) + (() if bias is None else (bias,)):
        if t.device != dev:
            raise ValueError(f"plan_dds_q: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return plan_dds_q_plain(x, qvalues, scales, schedule, n=n, tile=tile,
                                granularity=granularity, bias=bias, act=act)
    if dev.type != "cuda":
        raise NotImplementedError(f"plan_dds_q has no kernel for {dev}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"plan_dds_q kernel takes fp32/bf16 x, got {x.dtype}")
    if not (x.is_contiguous() and qvalues.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("plan_dds_q kernel needs contiguous inputs")
    m, k = x.shape
    bn, bk = tile
    inst = _pick_instance("plan_dds_q", instance, m, tile, x, qvalues)
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    b = None
    if bias is not None:
        b = bias.reshape(n).to(dtype=torch.float32).contiguous()
    ix = schedule.on(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry("plan_dds_q")(
        x.data_ptr(), qvalues.data_ptr(), scales.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(),
        ix["seg"].data_ptr(), ix["col"].data_ptr(), ix["tile"].data_ptr(),
        ix["head_tile"].data_ptr(), ix["head_col"].data_ptr(),
        m, k, n, schedule.n_brows, bn, bk, schedule.p_max,
        int(granularity == "row"), int(x.dtype == torch.bfloat16),
        int(qvalues.dtype == torch.float8_e4m3fn), ACTS[act],
        _INSTANCE_CODE[inst], plan_smem_bytes(inst, x.dtype, qvalues.dtype),
        stream)
    _check_launch("plan_dds_q", err)
    plan_dds_q.launches += 1
    return y


plan_dds_q.launches = 0


# --------------------------------------------------------------------------
# K7: the masked dense-layout matmul (negative control)
# --------------------------------------------------------------------------

def _expand_mask(tile_mask: torch.Tensor, tile: Tuple[int, int]):
    bn, bk = tile
    return tile_mask.bool().repeat_interleave(bn, 0).repeat_interleave(bk, 1)


def masked_matmul_plain(x: torch.Tensor, w_dense: torch.Tensor, tile_mask,
                        *, tile: Tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`masked_matmul`: masked tiles are selected
    away (they contribute nothing, whatever W holds there), then one fp32
    product, cast to ``x``'s dtype."""
    mask = torch.as_tensor(tile_mask, device=w_dense.device)
    w = torch.where(_expand_mask(mask, tile), w_dense.float(),
                    w_dense.new_zeros((), dtype=torch.float32))
    return (x.float() @ w.t()).to(x.dtype)


# The instances of K7 (csrc/masked.cu), in the order the wrapper prefers them:
#   ring    -- fp32 X and W, bk a multiple of 16, 16-byte aligned: the mask
#              row compacted into a list of unmasked K tiles, then a cp.async
#              ring over it; blocks of masked_block_rows rows of X;
#   general -- the scalar kernel: any tile down to (32, 1), bf16, any
#              alignment.
# Both sum each output in one fmaf chain over the unmasked k in order.
MASKED_INSTANCES = ("ring", "general")
_MASKED_CODE = {"general": 0, "ring": 1}


def masked_takes(instance: str, m: int, tile: Tuple[int, int], x_dtype,
                 w_dtype, aligned: bool = True) -> bool:
    """Whether K7 instance ``instance`` takes the call: 'ring' copies
    16-deep slabs of fp32 rows, 16 bytes at a time (bk % 16 == 0, 16-byte
    aligned X and W)."""
    if instance == "general":
        return True
    if instance not in _MASKED_CODE:
        raise ValueError(f"unknown instance {instance!r}")
    return (aligned and x_dtype == torch.float32
            and w_dtype == torch.float32 and tile[1] % 16 == 0)


def masked_instance(m: int, tile: Tuple[int, int], x_dtype, w_dtype,
                    aligned: bool = True) -> str:
    """The K7 instance for a call: the first of :data:`MASKED_INSTANCES`
    that takes it (:func:`masked_takes`), chosen before the launch."""
    return next(i for i in MASKED_INSTANCES
                if masked_takes(i, m, tile, x_dtype, w_dtype, aligned))


def masked_block_rows(m: int, n: int, tile: Tuple[int, int]) -> int:
    """Rows of X a ring block takes, from M and the N tiles alone: K4's
    rule (:func:`dds_block_rows`) over the N/bn output tiles."""
    return dds_block_rows(m, n // tile[0], tile[0])


def masked_matmul(x: torch.Tensor, w_dense: torch.Tensor, tile_mask, *,
                  tile: Tuple[int, int] = (128, 128),
                  instance: Optional[str] = None) -> torch.Tensor:
    """Y(M, N) = X(M, K) @ W^T over the dense (N, K) weight, skipping every
    tile whose entry in ``tile_mask`` (N/bn, K/bk) is 0: the product is
    skipped there and nothing is read from the tile. Kernel K7 on CUDA
    tensors (each launch counts in ``masked_matmul.launches``; the mask may
    be a host array or an int32 / bool tensor on the card),
    :func:`masked_matmul_plain` on CPU tensors. x and W in fp32 or bf16,
    fp32 accumulation, output in x's dtype. ``instance`` pins one of
    :data:`MASKED_INSTANCES` on the card (it must take the call)."""
    bn, bk = tile
    mshape = tuple(tile_mask.shape)
    if (x.dim() != 2 or w_dense.dim() != 2 or x.shape[1] != w_dense.shape[1]
            or w_dense.shape[0] % bn or w_dense.shape[1] % bk
            or mshape != (w_dense.shape[0] // bn, w_dense.shape[1] // bk)):
        raise ValueError(f"masked_matmul: x {tuple(x.shape)}, W "
                         f"{tuple(w_dense.shape)}, tile {tile}, mask "
                         f"{mshape}")
    if not _device_route("masked_matmul", x, w_dense):
        return masked_matmul_plain(x, w_dense, tile_mask, tile=tile)
    if isinstance(tile_mask, torch.Tensor):
        if tile_mask.device != x.device:
            raise ValueError(f"masked_matmul: mask on {tile_mask.device}, x "
                             f"on {x.device}")
        mask = tile_mask.to(torch.int32).contiguous()
    else:
        mask = torch.from_numpy(np.ascontiguousarray(
            tile_mask, np.int32)).to(x.device)
    m, k = x.shape
    n = w_dense.shape[0]
    aligned = x.data_ptr() % 16 == 0 and w_dense.data_ptr() % 16 == 0
    inst = _choose("masked_matmul", instance, MASKED_INSTANCES, masked_takes,
                   (m, tile, x.dtype, w_dense.dtype, aligned),
                   f"tile {tuple(tile)}, x {x.dtype}, W {w_dense.dtype} "
                   f"(16-byte aligned: {aligned})")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry("masked")(
        x.data_ptr(), w_dense.data_ptr(), mask.data_ptr(), y.data_ptr(), m, k,
        n, bn, bk, int(x.dtype == torch.bfloat16),
        int(w_dense.dtype == torch.bfloat16), _MASKED_CODE[inst],
        masked_block_rows(m, n, tile), stream)
    _check_launch("masked_matmul", err)
    masked_matmul.launches += 1
    return y


masked_matmul.launches = 0
