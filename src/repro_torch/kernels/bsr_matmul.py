"""Block-sparse linear layers: the host-side tile pack and kernel K1.

Counterpart of ``repro/kernels/bsr_matmul.py``:

  * :class:`KernelBSR` / :func:`pack_bsr` -- the offline tile-granular BSR
    pack, plain numpy, byte-identical to the reference;
  * :func:`plan_dds` -- ``Y = act(X @ W^T + bias)`` from the RowPackPlan's
    row-grouped ``(V, P, bn, bk)`` pack, walking the row-sorted tile
    schedule of ``exec_plan.plan_kernel_sequence``, by launching the
    hand-written Hopper kernel ``csrc/plan_dds.cu`` (which replaces the
    Pallas ``_plan_dds_kernel``). Its plain version, which CPU tensors run,
    is ``exec_plan.plan_fused_linear_plain``.
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

    data: np.ndarray         # (nnzt, bn, bk) stored tile values
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


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.numpy()
    return np.asarray(w)


def pack_bsr(w, tile: Tuple[int, int], nnzt: int | None = None) -> KernelBSR:
    """Pack a dense (N, K) weight (numpy or tensor) into a KernelBSR.

    Guarantees every block row AND every block column stores >= 1 tile
    (zero-valued if empty), so the write-on-row-change protocol covers all
    outputs in the forward and the transposed orientation.
    """
    w = _host(w)
    n, k = w.shape
    bn, bk = tile
    assert n % bn == 0 and k % bk == 0, (w.shape, tile)
    nbr, nbc = n // bn, k // bk

    blocks = w.reshape(nbr, bn, nbc, bk).transpose(0, 2, 1, 3)
    mask = np.any(blocks != 0, axis=(2, 3))
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

    data = np.zeros((nnzt, bn, bk), dtype=w.dtype)
    data[:real] = blocks[rows, cols]
    row_id = np.full((nnzt + 1,), nbr, dtype=np.int32)
    row_id[:real] = rows
    row_id[real:nnzt] = nbr - 1        # padding tiles live in the last row
    col_id = np.zeros((nnzt,), dtype=np.int32)
    col_id[:real] = cols

    t_perm = np.lexsort((row_id[:nnzt], col_id)).astype(np.int32)
    return KernelBSR(data, row_id, col_id, t_perm, real, (n, k), tile)


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


class PlanSchedule:
    """The forward tile schedule of one plan, in the form the kernel reads.

    ``row_seq`` (sentinel-terminated), ``col_seq``, ``vrow_seq`` and
    ``slot_seq`` are ``exec_plan.plan_kernel_sequence``'s arrays. The host
    derives, once, each block row's run ``seg[r]:seg[r + 1]`` of the
    row-sorted schedule and each tile's index ``vrow * P + slot`` in the
    flattened pack; :meth:`on` keeps one device copy per device.
    """

    def __init__(self, row_seq, col_seq, vrow_seq, slot_seq, *,
                 n_brows: int, n_bcols: int, p_max: int):
        self.n_brows, self.n_bcols, self.p_max = n_brows, n_bcols, p_max
        self.col_seq = np.asarray(col_seq, np.int32)
        self.seg = np.searchsorted(np.asarray(row_seq[:-1], np.int64),
                                   np.arange(n_brows + 1)).astype(np.int32)
        self.tile_seq = (np.asarray(vrow_seq, np.int64) * p_max
                         + np.asarray(slot_seq, np.int64)).astype(np.int32)
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        """The kernel's int32 ``seg``, ``col`` and ``tile`` on ``device``."""
        key = str(device)
        if key not in self._dev:
            arrs = {"seg": self.seg, "col": self.col_seq,
                    "tile": self.tile_seq}
            self._dev[key] = {
                k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for k, a in arrs.items()}
        return self._dev[key]


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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


def plan_dds(x: torch.Tensor, data_rp: torch.Tensor, schedule: PlanSchedule,
             *, n: int, tile: Tuple[int, int],
             bias: Optional[torch.Tensor] = None,
             act: Optional[str] = None) -> torch.Tensor:
    """Y(M, N) = act(X(M, K) @ W^T + bias) from the (V, P, bn, bk) pack,
    through kernel K1 (built on first use); each launch counts in
    ``plan_dds.launches``.

    ``schedule`` is the plan's :class:`PlanSchedule`. The kernel takes CUDA
    ``x`` and ``data_rp`` in fp32 or bf16, accumulates in fp32 and writes
    ``x``'s dtype; anything it does not take raises -- nothing falls back.
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
        ix["tile"].data_ptr(),
        m, k, n, r, bn, bk, int(x.dtype == torch.bfloat16),
        int(data_rp.dtype == torch.bfloat16), ACTS[act], stream)
    if err != 0:
        raise RuntimeError(f"plan_dds kernel launch failed: CUDA error {err}")
    plan_dds.launches += 1
    return y


plan_dds.launches = 0
