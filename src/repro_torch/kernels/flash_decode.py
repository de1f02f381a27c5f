"""Split-K flash-decode attention: kernels K2 and K3.

Counterpart of ``repro/kernels/flash_decode.py``. One decode step attends a
single query token per request slot against that slot's KV cache with the
flash-style online softmax, split by split, instead of materializing the
(B, Hkv, G, 1, T) score tensor:

  * :func:`flash_decode` (K2) -- dense (B, T, Hkv, D) slot caches, the KV
    axis cut into ``num_split`` chunks (T padded with masked slots to a
    multiple); on a CUDA tensor it launches ``csrc/flash_decode.cu``, which
    replaces the Pallas ``_flash_decode_kernel`` grid of
    ``_flash_decode_call``;
  * :func:`paged_flash_decode` (K3) -- page-pool caches
    (``serving/paging.py``), one split per page, the page table read in the
    kernel, so no dense view is ever gathered; on a CUDA tensor it launches
    the same source's paged kernel, which replaces ``_paged_flash_call``.

Each call is two launches: a split kernel, one block per (split, KV head,
slot), writes each split's fp32 partial (its own max, sum and p.V) into a
workspace the wrapper allocates, and a combine kernel folds the partials in
split order. Both kernels run one device routine per split and one combine
routine, so K3 is bit-exact against K2 over the gathered dense view when the
split boundaries match. The plain versions beside them
(:func:`flash_decode_plain`, :func:`paged_flash_decode_plain`) fold the same
splits in the same order; the kernel takes each split against its own max
and rescales it in the combine, one more fp32 rounding a split. The plain
versions are what CPU tensors run; on a CUDA tensor a wrapper launches its
kernels or raises.

Masking follows ``decode_attention`` exactly: ``kv_positions`` / ``pos_map``
hold the absolute position stored in each cache slot (-1 = empty) and a
query at ``pos`` sees ``0 <= kvp <= pos`` (and ``kvp > pos - window`` for
ring caches). Masked lanes are zeroed before their exp is used, so a fully
masked split (an unmapped page, an empty ring, an inactive slot with
``pos = -1``) adds nothing and its output is zeros, never NaN. Unlike the
plain ``decode_attention``, the probabilities stay fp32 for the value
product (no cast to the cache dtype).

Kernel selection: :func:`resolved_decode_kernel` reads the innermost
:func:`decode_kernel_override` context, else the ``REPRO_DECODE_KERNEL``
env (auto|xla|flash), else the platform: ``'auto'`` means these kernels on a
CUDA tensor and the plain ``decode_attention`` composition on a CPU tensor.
"""
from __future__ import annotations

import contextlib
import ctypes
import os

import torch

NEG_INF = -1e30

_ENV = "REPRO_DECODE_KERNEL"
DECODE_KERNELS = ("auto", "xla", "flash")
_OVERRIDE: list = []

#: the kernels take head dims up to this and GQA groups up to this
MAX_HEAD_DIM = 256
MAX_GROUP = 16
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def resolved_decode_kernel(device=None) -> str:
    """'xla' or 'flash': innermost override context > env > platform. On the
    platform step ('auto'), a CUDA ``device`` takes the flash kernels and
    any other device the plain ``decode_attention`` composition."""
    if _OVERRIDE:
        return _OVERRIDE[-1]
    kind = os.environ.get(_ENV, "").strip() or "auto"
    if kind not in DECODE_KERNELS:
        raise ValueError(f"{_ENV}={kind!r}; expected one of {DECODE_KERNELS}")
    if kind == "auto":
        dev = torch.device(device) if device is not None else None
        return "flash" if dev is not None and dev.type == "cuda" else "xla"
    return kind


@contextlib.contextmanager
def decode_kernel_override(kind):
    """Pin the decode kernel inside this context ('xla'/'flash'). The
    attention decode branch consults it at call time. None/'auto' is a
    no-op (fall through to env/platform)."""
    if kind in (None, "auto"):
        yield
        return
    if kind not in ("xla", "flash"):
        raise ValueError(f"decode kernel {kind!r} not in ('xla', 'flash')")
    _OVERRIDE.append(kind)
    try:
        yield
    finally:
        _OVERRIDE.pop()


def default_kv_split(t: int) -> int:
    """Split count keeping ~128-position chunks, capped at 8."""
    return max(1, min(8, t // 128))


# --------------------------------------------------------------------------
# shared shape handling
# --------------------------------------------------------------------------

def _slot_pos(pos, b: int, device) -> torch.Tensor:
    """Scalar or (B,) ``pos`` -> contiguous int32 (B,) on ``device``."""
    pos = torch.as_tensor(pos, device=device)
    return pos.to(torch.int32).expand(b).contiguous()


def _kv_map(kv_positions, b: int, t: int, device) -> torch.Tensor:
    """(T,) or (B, T) slot positions -> int32 (B, T) (a broadcast view for
    a shared map: the kernel reads it through a zero row stride)."""
    kvp = torch.as_tensor(kv_positions, device=device).to(torch.int32)
    if kvp.dim() == 1:
        kvp = kvp[None, :]
    return kvp.expand(b, t)


# --------------------------------------------------------------------------
# plain versions: the same splits in the same order as the kernels, each
# folded into the running state (the kernels take each split against its
# own max and rescale it in the combine)
# --------------------------------------------------------------------------

def _split_step(state, q32, k, v, kvp, pos, window, scale):
    """Fold one split into (m, l, acc). q32 (B,H,G,D) fp32; k/v (B,H,C,D);
    kvp (B,C) int; pos (B,) int. Masked lanes get NEG_INF scores and zero
    probabilities, and their values are never read (zeroed first)."""
    m, l, acc = state
    ok = (kvp >= 0) & (kvp <= pos[:, None])
    if window > 0:
        ok = ok & (kvp > pos[:, None] - window)
    okb = ok[:, None, None, :]                                # (B,1,1,C)
    s = torch.einsum("bhgd,bhcd->bhgc", q32, k.float()) * scale
    s = torch.where(okb, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(okb, torch.exp(s - m_new[..., None]),
                    torch.zeros_like(s))
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    vz = torch.where(ok[:, None, :, None], v.float(), torch.zeros((), device=v.device))
    acc = acc * corr[..., None] + torch.einsum("bhgc,bhcd->bhgd", p, vz)
    return m_new, l, acc


def _init_state(b, hkv, g, d, device):
    return (torch.full((b, hkv, g), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, hkv, g), dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, d), dtype=torch.float32, device=device))


def _finish(state, q):
    _, l, acc = state
    b, hkv, g, d = acc.shape
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).reshape(b, 1, hkv * g, d)


def flash_decode_plain(q, k_cache, v_cache, kv_positions, pos, *, window=0,
                       kv_split=None):
    """Plain version of K2: the same splits in the same order, each folded
    by the kernel's online-softmax step."""
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    num_split = min(kv_split or default_kv_split(t), t)
    ck = -(-t // num_split)
    posv = _slot_pos(pos, b, q.device)
    kvp = _kv_map(kv_positions, b, t, q.device)
    q32 = q[:, 0].reshape(b, hkv, g, d).float()
    state = _init_state(b, hkv, g, d, q.device)
    for s in range(num_split):
        lo, hi = s * ck, min((s + 1) * ck, t)
        if lo >= hi:            # a split made only of padding adds nothing
            continue
        state = _split_step(state, q32,
                            k_cache[:, lo:hi].transpose(1, 2),
                            v_cache[:, lo:hi].transpose(1, 2),
                            kvp[:, lo:hi], posv, window, d ** -0.5)
    return _finish(state, q)


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, pos_map, pos,
                             *, window=0):
    """Plain version of K3: one split per page, each page read through the
    table (-1 clipped to page 0; its lanes are masked by ``pos_map``)."""
    b, _, hq, d = q.shape
    n_pages, ps, hkv, _ = k_pages.shape
    npg = page_table.shape[1]
    g = hq // hkv
    if tuple(pos_map.shape) != (b, npg * ps):
        raise ValueError(f"pos_map {tuple(pos_map.shape)} is not "
                         f"(B, NP * page_size) = ({b}, {npg * ps})")
    posv = _slot_pos(pos, b, q.device)
    pt = page_table.long().clamp(0, n_pages - 1)
    q32 = q[:, 0].reshape(b, hkv, g, d).float()
    state = _init_state(b, hkv, g, d, q.device)
    for s in range(npg):
        page = pt[:, s]
        state = _split_step(state, q32,
                            k_pages[page].transpose(1, 2),
                            v_pages[page].transpose(1, 2),
                            pos_map[:, s * ps:(s + 1) * ps], posv, window,
                            d ** -0.5)
    return _finish(state, q)


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------

_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_library
        lib = load_library("flash_decode")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # tensors (and the workspace's M, l, acc), then ints, then the stream
        lib.flash_decode_launch.argtypes = (
            [ptr] * 9 + [i] * 10 + [ptr])
        lib.flash_decode_launch.restype = i
        lib.paged_flash_decode_launch.argtypes = (
            [ptr] * 10 + [i] * 9 + [ptr])
        lib.paged_flash_decode_launch.restype = i
        _LIB = lib
    return _LIB


def _check_kernel_inputs(name, q, k, v, hkv, d):
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"{name} has no kernel for {q.device}; its plain version is "
            f"{name}_plain")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, caches on {k.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes fp32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    hq = q.shape[2]
    if hq % hkv:
        raise ValueError(f"{name}: {hq} query heads over {hkv} KV heads")
    g = hq // hkv
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= g <= MAX_GROUP):
        raise ValueError(f"{name} kernel takes head_dim <= {MAX_HEAD_DIM} "
                         f"and G <= {MAX_GROUP}, got D={d}, G={g}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous caches")
    return g


def _workspace(b, hkv, num_split, g, d, device):
    """The split kernel's fp32 partials, read back by the combine: M and l
    (B, Hkv, S, G) and acc (B, Hkv, S, G, D), views of one allocation."""
    n = b * hkv * num_split * g
    ws = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    return (ws[n * d:n * (d + 1)].view(b, hkv, num_split, g),
            ws[n * (d + 1):].view(b, hkv, num_split, g),
            ws[:n * d].view(b, hkv, num_split, g, d))


def flash_decode(q, k_cache, v_cache, kv_positions, pos, *, window=0,
                 kv_split=None):
    """Split-K one-step decode (K2): q (B,1,Hq,D) vs dense caches
    (B,T,Hkv,D) -> (B,1,Hq,D) in q's dtype.

    ``pos`` is a scalar or ragged (B,) (-1 = inactive slot), ``kv_positions``
    (T,) shared or (B,T) per slot, ``window`` > 0 masks a ring cache.
    ``kv_split`` chunks the KV axis (default :func:`default_kv_split`); the
    kernel masks the padding of the last chunk itself, so the caches are not
    copied. A CPU tensor runs :func:`flash_decode_plain`; a CUDA tensor
    launches the kernel (counted in ``flash_decode.launches``) or raises."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, kv_positions, pos,
                                  window=window, kv_split=kv_split)
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = _check_kernel_inputs("flash_decode", q, k_cache, v_cache, hkv, d)
    num_split = min(kv_split or default_kv_split(t), t)
    ck = -(-t // num_split)
    posv = _slot_pos(pos, b, q.device)
    kvp = _kv_map(kv_positions, b, t, q.device)
    kvp_row_stride = kvp.stride(0)
    if kvp.stride(1) != 1:
        kvp = kvp.contiguous()
        kvp_row_stride = t
    qc = q.contiguous()
    out = torch.empty_like(qc)
    ws_m, ws_l, ws_acc = _workspace(b, hkv, num_split, g, d, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_lib().flash_decode_launch(
        qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kvp.data_ptr(), posv.data_ptr(), out.data_ptr(), ws_m.data_ptr(),
        ws_l.data_ptr(), ws_acc.data_ptr(),
        b, t, hkv, g, d, kvp_row_stride, ck, num_split, int(window),
        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def paged_flash_decode(q, k_pages, v_pages, page_table, pos_map, pos, *,
                       window=0):
    """One-step decode straight off the page pools (K3).

    q (B,1,Hq,D); pools (n_pages, page_size, Hkv, D); ``page_table``
    (B, NP) physical page per logical page (-1 = unmapped, clipped to page
    0 and masked); ``pos_map`` (B, NP*page_size) per-slot occupancy. One
    split per page. A CPU tensor runs :func:`paged_flash_decode_plain`; a
    CUDA tensor launches the kernel (counted in
    ``paged_flash_decode.launches``) or raises."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, page_table,
                                        pos_map, pos, window=window)
    b, _, hq, d = q.shape
    n_pages, ps, hkv, _ = k_pages.shape
    npg = page_table.shape[1]
    g = _check_kernel_inputs("paged_flash_decode", q, k_pages, v_pages, hkv,
                             d)
    if tuple(pos_map.shape) != (b, npg * ps) or page_table.shape[0] != b:
        raise ValueError(f"paged_flash_decode: page_table "
                         f"{tuple(page_table.shape)}, pos_map "
                         f"{tuple(pos_map.shape)} for B={b}, page_size={ps}")
    posv = _slot_pos(pos, b, q.device)
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    pm = pos_map.to(device=q.device, dtype=torch.int32).contiguous()
    qc = q.contiguous()
    out = torch.empty_like(qc)
    ws_m, ws_l, ws_acc = _workspace(b, hkv, npg, g, d, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_lib().paged_flash_decode_launch(
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), pt.data_ptr(),
        pm.data_ptr(), posv.data_ptr(), out.data_ptr(), ws_m.data_ptr(),
        ws_l.data_ptr(), ws_acc.data_ptr(),
        b, n_pages, ps, npg, hkv, g, d, int(window),
        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {err}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
