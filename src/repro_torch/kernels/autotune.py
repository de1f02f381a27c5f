"""Measured backend selection for block-sparse serving (``backend='auto'``).

Counterpart of ``repro/kernels/autotune.py``. The profitable (backend,
tile, density) region must be measured on the device that serves, not
assumed, so this module times the candidate execution paths

    dense          -- ``x @ w.T`` on the densified weight (cuBLAS on the card)
    gather         -- one gather per stored tile (``bsr_linear`` backend)
    rowpack        -- row-grouped batched product, per-call scatter
    plan           -- precomputed RowPackPlan, values row-grouped offline
    pallas         -- kernel K4 (``bsr_matmul.dds``) over the flat pack
    masked         -- kernel K7 (``bsr_matmul.masked_matmul``): the dense
                      layout with tile skipping, the negative control
    plan_pallas    -- kernel K1 (``bsr_matmul.plan_dds``) on the plan
    plan_q8        -- int8 plan values, the dequant-fused plain composition
    plan_pallas_q8 -- int8 plan values through kernel K6 (``plan_dds_q``)

(the last two only when the caller serves quantized packs) per *pattern
fingerprint* on the current device, picks the fastest, and persists the
winner so the cost is paid once per (pattern, device), across processes.
:func:`choose_decode_kernel` runs the same machinery over the attention
decode step: the plain ``'xla'`` composition against kernel K2
(``'flash'``).

The reference's interpret-only arms become the **arms without a kernel on
this device**: on a CUDA device every arm has one (K4, K7, K1, K6; K2 for
decode); on the CPU those arms run their plain versions, so wall-clock mode
drops them there and the stub proxy charges them the reference's interpret
penalty -- exactly as the reference does off-TPU.

Cache location and invalidation
-------------------------------
Winners live in ONE json file: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro/autotune.json`` -- the reference's file and key layout
``sha1(pattern fingerprint) : m<batch rows> : <device kind> : d<device
count> : <mode> : q<quant> : w<value dtype> : c<candidate-set digest>``, so
a winner is only ever reused for the same pattern, batch, device, mode,
quantization, value dtype and candidate set. The device kind here is
``gpu:<CUDA device name>`` (spaces as ``_``) or ``cpu:cpu``. The file
carries ``version`` :data:`CACHE_VERSION`; older or unreadable files read
as empty and are rewritten by the next ``put``.

Stub mode (CI determinism)
--------------------------
With ``REPRO_AUTOTUNE_STUB=1`` (or ``stub=True``) no clock runs: backends
are ranked by the reference's deterministic FLOP/traffic proxy
(:func:`stub_costs`, the same numbers). Tests can also inject a frozen
``timer``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import exec_plan as xp
from repro_torch.kernels.bsr_matmul import KernelBSR, masked_matmul
from repro_torch.kernels.flash_decode import default_kv_split

CANDIDATES = ("dense", "gather", "rowpack", "plan", "pallas", "masked",
              "plan_pallas")
#: quantized-pack arms, appended to the default candidate set only when the
#: caller serves quantized packs (choose_backend(quant=...))
QUANT_CANDIDATES = ("plan_q8", "plan_pallas_q8")
#: arms that run a kernel on a CUDA device (K4, K7, K1, K6) and their plain
#: versions elsewhere: dropped from wall-clock sets off the card, charged
#: the interpret penalty by the stub proxy there
INTERPRET_ONLY = ("pallas", "masked", "plan_pallas", "plan_pallas_q8")

#: attention decode-step kernels ranked by choose_decode_kernel
DECODE_CANDIDATES = ("xla", "flash")
#: decode arms that run a kernel (K2) only on a CUDA device
DECODE_INTERPRET_ONLY = ("flash",)

_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
_ENV_STUB = "REPRO_AUTOTUNE_STUB"

#: on-disk winner-cache format; v1 files (keys without the device-count and
#: shard fields) read as empty and are rewritten at this version
CACHE_VERSION = 2


def stub_mode() -> bool:
    return os.environ.get(_ENV_STUB, "").strip() not in ("", "0", "false")


def device_kind(device=None) -> str:
    """``gpu:<CUDA device name>`` (spaces as ``_``) on a CUDA device,
    ``cpu:cpu`` on the CPU -- the reference's ``platform:device_kind``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}".replace(" ", "_")
    return f"{dev.type}:{dev.type}"


def device_count(device=None) -> int:
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _has_kernels(device) -> bool:
    return resolve_device(device).type == "cuda"


def pattern_digest(pack: KernelBSR) -> str:
    return hashlib.sha1(xp.kernel_pattern_fingerprint(pack)).hexdigest()[:16]


def _dtype_name(data) -> str:
    if isinstance(data, torch.Tensor):
        return str(data.dtype).replace("torch.", "")
    return np.dtype(data.dtype).name


# --------------------------------------------------------------------------
# pack wrappers consumed by models/common.linear
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class BackendChoice:
    """A KernelBSR pattern pinned to a measured ``bsr_linear`` backend
    (gather / rowpack / pallas); the params tree keeps the packed
    ``(nnzt, bn, bk)`` values."""

    pack: KernelBSR
    backend: str

    @property
    def shape(self):
        return self.pack.shape

    @property
    def tile(self):
        return self.pack.tile

    @property
    def density(self) -> float:
        return self.pack.density

    @property
    def fingerprint(self) -> bytes:
        return (b"choice:" + self.backend.encode()
                + xp.kernel_pattern_fingerprint(self.pack))

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, BackendChoice)
                and self.fingerprint == other.fingerprint)


@dataclasses.dataclass(frozen=True, eq=False)
class MaskedPack:
    """Dense-layout serving through kernel K7: the params tree keeps the
    DENSE ``(N, K)`` weight and only this static tile occupancy mask rides
    in ``packs`` (compute skipped, the dense layout kept -- the paper's
    format-support negative control)."""

    tile_mask: np.ndarray     # (R, C) bool, True = stored tile
    shape: Tuple[int, int]
    tile: Tuple[int, int]

    @property
    def density(self) -> float:
        return float(np.mean(self.tile_mask))

    @property
    def fingerprint(self) -> bytes:
        header = np.array([*self.shape, *self.tile], np.int64)
        return (b"masked:" + header.tobytes()
                + np.packbits(np.asarray(self.tile_mask, bool)).tobytes())

    def mask_on(self, device) -> torch.Tensor:
        """The mask as int32 on ``device`` (one copy per device)."""
        cache = self.__dict__.setdefault("_dev", {})
        key = str(device)
        if key not in cache:
            cache[key] = torch.from_numpy(np.ascontiguousarray(
                self.tile_mask, np.int32)).to(device)
        return cache[key]

    def __hash__(self):
        return hash(self.fingerprint)

    def __eq__(self, other):
        return (isinstance(other, MaskedPack)
                and self.fingerprint == other.fingerprint)


def masked_pack_from(pack: KernelBSR) -> MaskedPack:
    mask = np.zeros((pack.n_brows, pack.n_bcols), bool)
    rows = np.asarray(pack.row_id[: pack.real_nnzt])
    cols = np.asarray(pack.col_id[: pack.real_nnzt])
    mask[rows, cols] = True
    return MaskedPack(tile_mask=mask, shape=pack.shape, tile=pack.tile)


def dense_from_pack(pack: KernelBSR, data=None):
    """Densify a KernelBSR back to (N, K) -- the dense / masked candidate's
    weight. ``data`` (default: the pack's values) is numpy or a tensor, with
    optional leading layer dims; the result is of the same kind, dtype and
    device."""
    data = pack.data if data is None else data
    n, k = pack.shape
    bn, bk = pack.tile
    rows = np.asarray(pack.row_id[: pack.real_nnzt], np.int64)
    cols = np.asarray(pack.col_id[: pack.real_nnzt], np.int64)
    if isinstance(data, torch.Tensor):
        lead = tuple(data.shape[:-3])
        w = data.new_zeros(lead + (n // bn, k // bk, bn, bk))
        w[..., torch.from_numpy(rows).to(data.device),
          torch.from_numpy(cols).to(data.device), :, :] = \
            data[..., : pack.real_nnzt, :, :]
        return w.transpose(-3, -2).reshape(lead + (n, k))
    data = np.asarray(data)
    w = np.zeros((n // bn, bn, k // bk, bk), data.dtype)
    w[rows, :, cols, :] = data[: pack.real_nnzt]
    return w.reshape(n, k)


def shard_subpack(pack: KernelBSR, n_shards: int, axis: str) -> KernelBSR:
    """The measurement proxy for a tensor-parallel shard: the sub-pattern
    of the MOST occupied shard (the per-rank straggler that sets the
    layer's critical path), as its own KernelBSR over the per-rank
    sub-shape. ``axis='out'`` slices output block rows, ``'in'`` input
    block cols (``serving/export.shard_axis_for``)."""
    from repro_torch.kernels.bsr_matmul import pack_bsr
    rows = np.asarray(pack.row_id[: pack.real_nnzt], np.int64)
    cols = np.asarray(pack.col_id[: pack.real_nnzt], np.int64)
    per = (pack.n_brows if axis == "out" else pack.n_bcols) // n_shards
    shard_of = (rows if axis == "out" else cols) // per
    s = int(np.bincount(shard_of, minlength=n_shards).argmax())
    data = pack.data
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().float().numpy()
    w = dense_from_pack(pack, np.asarray(data))
    bn, bk = pack.tile
    if axis == "out":
        sub = w[s * per * bn: (s + 1) * per * bn, :]
    else:
        sub = w[:, s * per * bk: (s + 1) * per * bk]
    return pack_bsr(sub, pack.tile)


# --------------------------------------------------------------------------
# the on-disk winner cache
# --------------------------------------------------------------------------

def default_cache_path() -> str:
    env = os.environ.get(_ENV_CACHE)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                        "autotune.json")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0


def _valid_entries(entries) -> Dict[str, dict]:
    """Keep only well-formed (str key -> dict record) winner entries."""
    if not isinstance(entries, dict):
        return {}
    return {k: v for k, v in entries.items()
            if isinstance(k, str) and isinstance(v, dict)}


def _read_entries(path: str) -> Dict[str, dict]:
    """The current-version entries of the file at ``path``; any unreadable
    file (missing, truncated, binary, wrong shape or version) reads as
    empty."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if isinstance(doc, dict) and doc.get("version") == CACHE_VERSION:
        return _valid_entries(doc.get("entries"))
    return {}


class AutotuneCache:
    """Winner cache persisted as one JSON file. Writes merge with what other
    processes wrote meanwhile; a corrupt file reads as empty and is
    rewritten by the next ``put`` -- never a crash."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self.stats = CacheStats()
        self._entries: Optional[Dict[str, dict]] = None

    def _load(self) -> Dict[str, dict]:
        if self._entries is None:
            self._entries = _read_entries(self.path)
        return self._entries

    def get(self, key: str) -> Optional[dict]:
        rec = self._load().get(key)
        if rec is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        return rec

    def put(self, key: str, record: dict) -> None:
        entries = self._load()
        entries[key] = record
        on_disk = _read_entries(self.path)
        on_disk.update(entries)
        self._entries = on_disk
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": on_disk}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, self.path)


_DEFAULT_CACHE: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    """Process-wide cache over :func:`default_cache_path` (re-resolved if
    the env var changed, so tests can repoint it)."""
    global _DEFAULT_CACHE
    path = default_cache_path()
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != path:
        _DEFAULT_CACHE = AutotuneCache(path)
    return _DEFAULT_CACHE


# --------------------------------------------------------------------------
# candidate executors + measurement
# --------------------------------------------------------------------------

def _candidate_fn(pack: KernelBSR, name: str, device):
    """-> (fn(x, data), data on ``device``) executing this backend for
    ``pack``."""
    from repro_torch.kernels.ops import bsr_linear
    dev = torch.device(device)

    def tensor(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dev)
    if name == "dense":
        return (lambda x, w_: torch.matmul(x, w_.t())), tensor(
            dense_from_pack(pack))
    if name in ("plan", "plan_pallas"):
        plan = xp.plan_for_pack(pack)
        data = xp.pack_plan_data(plan, tensor(pack.data))
        fn = xp.plan_linear if name == "plan" else xp.plan_linear_pallas
        return (lambda x, d, _p=plan: fn(x, d, _p)), data
    if name == "masked":
        mask = masked_pack_from(pack).mask_on(dev)
        tile = pack.tile
        return ((lambda x, w_: masked_matmul(x, w_, mask, tile=tile)),
                tensor(dense_from_pack(pack)))
    if name in ("plan_q8", "plan_pallas_q8"):
        # quantize the measurement data exactly as the export would: the
        # timed op consumes int8 values + fp32 scales, dequant fused
        plan = xp.plan_for_pack(pack)
        data_rp = xp.pack_plan_data(plan, tensor(pack.data))
        q, s = xp.quantize_plan_values(data_rp, "int8",
                                       xp.quant_granularity(pack.tile))
        fn = (xp.plan_q_linear if name == "plan_q8"
              else xp.plan_q_linear_pallas)
        return (lambda x, d, _s=s, _p=plan: fn(x, d, _s, _p)), q
    if name in ("gather", "rowpack", "pallas"):
        return ((lambda x, d, _pk=pack, _b=name: bsr_linear(x, d, _pk, _b)),
                tensor(pack.data))
    raise ValueError(f"unknown autotune candidate {name!r}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _paired(arms, reps: int, device, timer):
    """The reference's paired round-robin timing over ``arms`` [(name, fn,
    args)]: one warm-up call each (kernels built and loaded before any
    clock runs), then ``reps`` rounds. Returns (min-of-reps seconds,
    median per-round ratio to the first arm)."""
    if timer is not None:
        times = {name: float(timer(name, fn, args))
                 for name, fn, args in arms}
        return times, dict(times)
    with torch.inference_mode():
        for _, fn, args in arms:
            fn(*args)
        _sync(device)
        ts: Dict[str, list] = {name: [] for name, _, _ in arms}
        for _ in range(reps):
            for name, fn, args in arms:
                t0 = time.perf_counter()
                fn(*args)
                _sync(device)
                ts[name].append(time.perf_counter() - t0)
    anchor = np.asarray(ts[arms[0][0]], np.float64)
    scores = {name: float(np.median(np.asarray(t, np.float64) / anchor))
              for name, t in ts.items()}
    return {name: float(np.min(t)) for name, t in ts.items()}, scores


def measure(pack: KernelBSR, m: int, candidates: Sequence[str], *,
            reps: int = 5, timer: Optional[Callable] = None, device=None
            ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Paired wall-clock micro-benchmark on ``device``: the reps of all
    candidates interleaved round-robin, each call ended by a
    ``torch.cuda.synchronize()`` on the card. Returns ``(times, scores)``:
    min-of-reps seconds per candidate, and the ranking statistic -- the
    median over rounds of each arm's time over the first arm's in the same
    round. ``timer(name, fn, args)`` substitutes the measurement (tests)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(m, pack.shape[1]).astype(np.float32)).to(
        dev)
    arms = []
    for name in candidates:
        fn, data = _candidate_fn(pack, name, dev)
        arms.append((name, fn, (x, data)))
    return _paired(arms, reps, dev, timer)


def stub_costs(pack: KernelBSR, m: int, candidates: Sequence[str], *,
               device=None) -> Dict[str, float]:
    """The reference's deterministic FLOP/traffic proxy (pseudo-seconds),
    number for number; arms without a kernel on ``device`` pay the
    interpret penalty."""
    n, k = pack.shape
    bn, bk = pack.tile
    nnzt = pack.real_nnzt
    rows = np.asarray(pack.row_id[: nnzt], np.int64)
    counts = np.bincount(rows, minlength=pack.n_brows)
    p_max = max(1, int(counts.max()))
    plan = xp.plan_for_pack(pack)
    interp = 0.0 if _has_kernels(device) else 1e6 * nnzt
    traffic = 8.0                                   # weight-stream weight
    out = {}
    for name in candidates:
        if name == "dense":
            c = m * n * k + traffic * n * k
        elif name == "gather":
            c = 2.5 * m * nnzt * bn * bk + traffic * nnzt * bn * bk
        elif name == "rowpack":
            c = (4 * traffic * nnzt * bn * bk
                 + m * pack.n_brows * p_max * bn * bk)
        elif name == "plan":
            c = (m * plan.n_vrows * plan.p_max * bn * bk
                 + traffic * nnzt * bn * bk)
            if plan.spilled:
                c += m * plan.n_vrows * bn
        elif name == "pallas":
            c = m * nnzt * bn * bk + traffic * nnzt * bn * bk + interp
        elif name == "plan_pallas":
            c = (0.97 * m * nnzt * bn * bk + traffic * nnzt * bn * bk
                 + interp)
        elif name in ("plan_q8", "plan_pallas_q8"):
            gran = xp.quant_granularity(pack.tile)
            scale_elems = plan.n_vrows * (plan.p_max if gran == "block"
                                          else 1)
            qtraffic = traffic * nnzt * bn * bk / 4.0 + traffic * scale_elems
            if name == "plan_q8":
                c = m * plan.n_vrows * plan.p_max * bn * bk + qtraffic
                if plan.spilled:
                    c += m * plan.n_vrows * bn
            else:
                c = 0.97 * m * nnzt * bn * bk + qtraffic + interp
        elif name == "masked":
            c = m * nnzt * bn * bk + traffic * n * k + interp
        else:
            raise ValueError(f"unknown autotune candidate {name!r}")
        out[name] = float(c)
    return out


# --------------------------------------------------------------------------
# the chooser
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Choice:
    backend: str
    costs: Dict[str, float]     # seconds (wallclock) or proxy (stub)
    cache_hit: bool
    mode: str                   # 'wallclock' | 'stub'
    key: str


def _cand_tag(candidates) -> str:
    return hashlib.sha1(",".join(sorted(candidates)).encode()).hexdigest()[:8]


def choose_backend(pack: KernelBSR, m: int = 256, *,
                   candidates: Optional[Sequence[str]] = None,
                   cache: Optional[AutotuneCache] = None,
                   stub: Optional[bool] = None, reps: int = 5,
                   timer: Optional[Callable] = None,
                   shard: Optional[Tuple[int, str]] = None,
                   quant: str = "none", device=None) -> Choice:
    """Pick the fastest execution path for ``pack`` on ``device`` (the card
    by default). Consults the on-disk winner cache first; on a miss it
    measures (or, in stub mode, ranks by the proxy) and persists the
    winner. ``quant`` ('none' | 'int8' | 'fp8') adds the q8 arms to the
    default set and is always part of the key, with the value dtype.

    ``shard = (n_shards, axis)`` tags the key with the tensor-parallel
    partitioning and the per-shard sub-problem shape, and the measurement
    runs on the per-shard sub-problem (:func:`shard_subpack`, the most
    occupied shard); an indivisible pattern serves replicated, so it is
    keyed and measured unsharded."""
    dev = resolve_device(device)
    stub = stub_mode() if stub is None else bool(stub)
    cache = cache if cache is not None else default_cache()
    if candidates is None:
        candidates = list(CANDIDATES)
        if quant != "none":
            candidates += list(QUANT_CANDIDATES)
        if not stub and timer is None and not _has_kernels(dev):
            candidates = [c for c in candidates if c not in INTERPRET_ONLY]
    mode = "stub" if stub else "wallclock"
    shard_tag = ""
    measure_pack = pack
    if shard is not None and int(shard[0]) > 1:
        n_shards, axis = int(shard[0]), shard[1]
        if xp.shard_divisible(pack, n_shards, axis):
            n, k = pack.shape
            sn = n // n_shards if axis == "out" else n
            sk = k // n_shards if axis == "in" else k
            shard_tag = f":s{axis}{n_shards}x{sn}x{sk}"
            measure_pack = shard_subpack(pack, n_shards, axis)
    key = (f"{pattern_digest(pack)}:m{int(m)}:{device_kind(dev)}"
           f":d{device_count(dev)}{shard_tag}:{mode}"
           f":q{quant}:w{_dtype_name(pack.data)}:c{_cand_tag(candidates)}")
    rec = cache.get(key)
    if rec is not None and rec.get("backend") in candidates:
        return Choice(rec["backend"], dict(rec.get("costs", {})), True,
                      mode, key)
    if stub:
        costs = stub_costs(measure_pack, m, candidates, device=dev)
        scores = costs
    else:
        costs, scores = measure(measure_pack, m, candidates, reps=reps,
                                timer=timer, device=dev)
    backend = min(scores, key=scores.get)
    cache.put(key, {"backend": backend, "costs": costs, "mode": mode,
                    "m": int(m), "device": device_kind(dev),
                    "devices": device_count(dev),
                    "shard": shard_tag.lstrip(":") or None,
                    "quant": quant,
                    "created": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return Choice(backend, costs, False, mode, key)


# --------------------------------------------------------------------------
# decode-kernel selection (attention decode step: 'xla' vs K2 'flash')
# --------------------------------------------------------------------------

def decode_stub_costs(*, b: int, t: int, hq: int, hkv: int, d: int,
                      kv_split: int, device=None) -> Dict[str, float]:
    """The reference's deterministic proxy for the one-token decode step:
    both arms stream the KV cache once; 'xla' pays the materialized scores
    and probabilities, 'flash' the split-K reduce state (and, without its
    kernel on ``device``, the interpret penalty)."""
    g = max(1, hq // hkv)
    interp = 0.0 if _has_kernels(device) else 1e6 * t
    traffic = 8.0
    flops = 2.0 * b * hq * t * d
    kv_read = traffic * b * hkv * t * d
    return {
        "xla": flops + kv_read + traffic * 2.0 * b * hq * t,
        "flash": (flops + kv_read
                  + traffic * b * hkv * g * (d + 2) * kv_split + interp),
    }


def _measure_decode(b, t, hq, hkv, d, window, kv_split, candidates, *,
                    reps=3, timer=None, device=None):
    """Paired wall-clock micro-benchmark of the decode arms (the same
    round-robin discipline as :func:`measure`)."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.attention import decode_attention
    dev = resolve_device(device)
    rng = np.random.RandomState(0)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    q, k, v = rnd(b, 1, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d)
    pm = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
    fns = {
        "xla": lambda q, k, v, pm, pos: decode_attention(
            q, k, v, pm, pos, window=window),
        "flash": lambda q, k, v, pm, pos: flash_decode(
            q, k, v, pm, pos, window=window, kv_split=kv_split),
    }
    arms = [(name, fns[name], (q, k, v, pm, pos)) for name in candidates]
    return _paired(arms, reps, dev, timer)


def choose_decode_kernel(b: int = 8, t: int = 512, hq: int = 8,
                         hkv: int = 8, d: int = 64, *, window: int = 0,
                         kv_split: Optional[int] = None,
                         cache: Optional[AutotuneCache] = None,
                         stub: Optional[bool] = None, reps: int = 3,
                         timer: Optional[Callable] = None,
                         device=None) -> Choice:
    """Pick the attention decode kernel ('xla' | 'flash') for this shape on
    ``device``, with the same cache / stub / frozen-timer contract as
    :func:`choose_backend`; on a CUDA device it measures the plain
    composition against kernel K2. ``Servable`` consults this when
    ``spec.decode_kernel='auto'`` and no env override pins the choice."""
    if hq < 1 or hkv < 1 or d < 1:
        raise ValueError(f"attention-free decode shape (hq={hq}, hkv={hkv}, "
                         f"d={d}); pin decode kernel instead of tuning")
    dev = resolve_device(device)
    stub = stub_mode() if stub is None else bool(stub)
    cache = cache if cache is not None else default_cache()
    split = int(kv_split) if kv_split else default_kv_split(t)
    candidates = list(DECODE_CANDIDATES)
    if not stub and timer is None and not _has_kernels(dev):
        candidates = [c for c in candidates
                      if c not in DECODE_INTERPRET_ONLY]
    mode = "stub" if stub else "wallclock"
    key = (f"decode:b{int(b)}t{int(t)}h{int(hq)}g{int(hkv)}d{int(d)}"
           f"w{int(window)}s{split}:{device_kind(dev)}"
           f":d{device_count(dev)}:{mode}:c{_cand_tag(candidates)}")
    rec = cache.get(key)
    if rec is not None and rec.get("backend") in candidates:
        return Choice(rec["backend"], dict(rec.get("costs", {})), True,
                      mode, key)
    if stub:
        all_costs = decode_stub_costs(b=b, t=t, hq=hq, hkv=hkv, d=d,
                                      kv_split=split, device=dev)
        costs = {name: all_costs[name] for name in candidates}
        scores = costs
    else:
        costs, scores = _measure_decode(b, t, hq, hkv, d, window, split,
                                        candidates, reps=reps, timer=timer,
                                        device=dev)
    backend = min(scores, key=scores.get)
    cache.put(key, {"backend": backend, "costs": costs, "mode": mode,
                    "device": device_kind(dev),
                    "devices": device_count(dev),
                    "created": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return Choice(backend, costs, False, mode, key)
