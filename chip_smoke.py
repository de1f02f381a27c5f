#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--phases kernels,serving] [--requests 8]

Phases, in order; any failure ends the run with a non-zero exit:

  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel from src/repro_torch/kernels/csrc (one nvcc a source, all
     started together) and its time;
  2. kernels: kernel K1 (plan_dds) against its plain PyTorch version on the
     card -- small layout cases (random, padded, spilling, fused QKV, 32x1
     tiles, every epilogue with bias, bf16) and the four projection shapes
     of BERT-base at M=384 with 128x128 tiles, with kernel, plain and
     library (torch.matmul on the densified weight) times;
  3. serving: BERT-base at full width (12 layers, d=768, d_ff=3072, vocab
     30522, seeded random weights) pruned 80% at 128x128 with tied masks,
     fused QKV and cross-layer union, served through backend 'plan_pallas'
     (every projection through K1): a few (1, 384) requests and one
     (8, 384) batch, logits checked against the dense path on the same
     pruned weights, 12 x 4 K1 launches per forward, then save / reload
     with bit-equal logits.

The line before the last is the kernels JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/plan_dds.cu"
REPLACES = "src/repro/kernels/bsr_matmul.py:368"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the fp32
# rate outside the tensor cores -- K1 runs fp32 FMA.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Tolerances of K1 against its plain version on the same inputs. Both
# accumulate in fp32 but sum in another order, so the gap scales with the
# output's magnitude: fp32 outputs within 1e-5 of max|ref| (a few hundred
# fp32 roundings of a K <= 3072 dot product), bf16 outputs within 2e-2 of
# max|ref| (one bf16 rounding step of the output, 2^-7, with margin).
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
# Served logits against the dense path on the same pruned weights (the
# repository example's parity bar).
TOL_LOGITS = 1e-3

MAIN_SHAPES = (("qkv", 2304, 768), ("attn_out", 768, 768),
               ("ffn_in", 3072, 768), ("ffn_out", 768, 3072))


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _sparse_weight(rng, n, k, tile, density):
    import numpy as np
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    return w * np.kron(mask, np.ones(tile, np.float32))


def _plan_case(w, tile, pad_tiles=0):
    from repro_torch.kernels import build_plan, pack_bsr, pack_plan_data
    pk = pack_bsr(w, tile)
    if pad_tiles:
        pk = pack_bsr(w, tile, nnzt=pk.real_nnzt + pad_tiles)
    plan = build_plan(pk)
    return plan, pack_plan_data(plan, pk.data)


def _time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(label, fn, top: int = 8):
    """One call of ``fn`` under torch.profiler: device time by kernel (the
    trace's device-side events only), their total, and the device's idle
    share of the wall time (the profiler's own overhead counts in the wall
    time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] {label}: no device time in the trace "
              f"(wall {wall:.3f} ms); device busy share not measured")
        return
    print(f"[profile] {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms in {sum(r[1] for r in rows)} device events, "
          f"idle share {max(0.0, 1 - busy / wall):.3f}")
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.4f} ms {count:5d}x  {key[:90]}")


def _compare(name, got, ref, tol_rel):
    import torch
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    ok = err <= tol_rel * scale and bool(torch.isfinite(got).all())
    print(f"  {name:34s} max|d|={err:.3e}  tol={tol_rel * scale:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"K1 disagrees with its plain version on {name}")
    return err


# --------------------------------------------------------------------------
# phase 1: card + build
# --------------------------------------------------------------------------

def phase_build():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    print(card)
    from repro_torch.kernels.build import build_all
    t0 = time.perf_counter()
    logs = build_all(force=True)
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, info in logs.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return card


# --------------------------------------------------------------------------
# phase 2: K1 against its plain version
# --------------------------------------------------------------------------

def phase_kernels(seed: int):
    import numpy as np
    import torch
    from repro_torch.kernels import (plan_dds, plan_fused_linear,
                                     plan_fused_linear_plain, plan_linear,
                                     plan_matmul_pallas, plan_schedule)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed)

    def run(plan, data, x, bias=None, act=None):
        return (plan_dds(x, data, plan_schedule(plan), n=plan.shape[0],
                         tile=plan.tile, bias=bias, act=act),
                plan_fused_linear_plain(x, data, plan, bias=bias, act=act))

    print("[kernels] K1 plan_dds vs plain, small cases")
    cases = [("random d=0.4 (16,32)", 96, 128, (16, 32), 0.4, 0, 24),
             ("random d=0.15 (16,32)", 96, 128, (16, 32), 0.15, 0, 24),
             ("padded nnzt +5 (16,32)", 96, 128, (16, 32), 0.4, 5, 24),
             ("(32,1) tiles", 64, 64, (32, 1), 0.3, 0, 40),
             ("(16,16) M=130", 64, 96, (16, 16), 0.5, 0, 130)]
    for name, n, k, tile, dens, pad, m in cases:
        plan, data = _plan_case(_sparse_weight(rng, n, k, tile, dens), tile,
                                pad)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        _compare(name, *run(plan, data.to(dev), x), TOL_F32)

    # the spilling pattern of test_plan_pallas_spill_schedule_edge_rows
    n, k, tile = 128, 1024, (16, 64)
    w = np.zeros((n, k), np.float32)
    w[:16, :] = rng.randn(16, k)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    plan, data = _plan_case(w, tile)
    check(plan.spilled, "spill case did not spill")
    x = torch.from_numpy(rng.randn(20, k).astype(np.float32)).to(dev)
    _compare("spill edge rows (16,64)", *run(plan, data.to(dev), x), TOL_F32)

    # fused-QKV pack through the batched entry, leading dims preserved
    k, tile = 64, (16, 16)
    w = np.concatenate([_sparse_weight(rng, 48, k, tile, 0.5)
                        for _ in range(3)])
    plan, data = _plan_case(w, tile)
    data = data.to(dev)
    x = torch.from_numpy(rng.randn(2, 5, k).astype(np.float32)).to(dev)
    y = plan_matmul_pallas(x, data, plan)
    check(tuple(y.shape) == (2, 5, 144), f"fused QKV shape {tuple(y.shape)}")
    ref = plan_linear(x.reshape(10, k), data, plan).reshape(2, 5, 144)
    _compare("fused QKV (16,16) batched", y, ref, TOL_F32)

    # every epilogue, with bias
    n, k, tile = 64, 96, (16, 16)
    plan, data = _plan_case(_sparse_weight(rng, n, k, tile, 0.5), tile)
    data = data.to(dev)
    x = torch.from_numpy(rng.randn(16, k).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    for act in (None, "relu", "gelu", "silu"):
        y = plan_fused_linear(x, data, plan, bias=b, act=act)
        ref = plan_fused_linear_plain(x, data, plan, bias=b, act=act)
        _compare(f"epilogue bias+{act}", y, ref, TOL_F32)

    # bf16 values (ServingSpec.dtype='bfloat16' casts only the packs), and
    # bf16 activations too
    n, k, tile = 256, 256, (128, 128)
    plan, data = _plan_case(_sparse_weight(rng, n, k, tile, 0.5), tile)
    x = torch.from_numpy(rng.randn(48, k).astype(np.float32)).to(dev)
    d16 = data.to(dev, torch.bfloat16)
    _compare("x fp32, values bf16", *run(plan, d16, x), TOL_F32)
    _compare("x bf16, values bf16", *run(plan, d16, x.bfloat16()), TOL_BF16)
    _compare("x bf16, values fp32 +gelu", *run(
        plan, data.to(dev), x.bfloat16(), act="gelu"), TOL_BF16)

    print("[kernels] K1 at the BERT-base projection shapes, M=384, "
          "128x128 tiles, density 0.2")
    per_shape = []
    m, tile = 384, (128, 128)
    for name, n, k in MAIN_SHAPES:
        w = _sparse_weight(rng, n, k, tile, 0.2)
        plan, data = _plan_case(w, tile)
        data = data.to(dev)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        w_dense = torch.from_numpy(w).to(dev)
        sched = plan_schedule(plan)
        kw = dict(n=n, tile=tile)
        y, ref = plan_dds(x, data, sched, **kw), plan_linear(x, data, plan)
        err = _compare(f"{name} ({n},{k})", y, ref, TOL_F32)
        lib = torch.matmul(x, w_dense.t())
        _compare(f"{name} vs torch.matmul", y, lib, TOL_F32)
        nnz = plan.real_nnzt * tile[0] * tile[1]
        n_bytes = 4 * (m * k + nnz + m * n)
        flops = 2 * m * nnz
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        rec = {
            "shape": name, "m": m, "n": n, "k": k,
            "tiles": plan.real_nnzt, "max_abs_err": err,
            "ms": _time_ms(lambda: plan_dds(x, data, sched, **kw)),
            "plain_ms": _time_ms(lambda: plan_linear(x, data, plan)),
            "library_ms": _time_ms(lambda: torch.matmul(x, w_dense.t())),
            "bytes_ms": t_bytes * 1e3, "operations_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        per_shape.append(rec)
        print(f"  {name:9s} kernel_ms={rec['ms']:.4f} plain_ms="
              f"{rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}) "
              f"tiles={plan.real_nnzt}")
    return per_shape


# --------------------------------------------------------------------------
# phase 3: BERT-base block-sparse serving through K1
# --------------------------------------------------------------------------

def phase_serving(seed: int, n_requests: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import tied_prune
    from repro_torch.kernels import plan_dds
    from repro_torch.models.api import init_model, model_forward
    from repro_torch.serving import (ServingSpec, load_servable,
                                     prepare_servable)
    dev = torch.device("cuda")
    cfg = get_config("bert_base")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
          == (12, 768, 3072, 30522), "not BERT-base at full width")
    spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                       fuse_qkv=True, cross_layer_union=True,
                       backend="plan_pallas")
    t0 = time.perf_counter()
    params = init_model(seed, cfg, device=dev)
    servable = prepare_servable(params, cfg, spec, device=dev)
    pruned, _ = tied_prune(params, spec.sparsity_config())
    torch.cuda.synchronize()
    st = servable.stats()
    print(f"[serving] {cfg.arch}: prune + export {time.perf_counter() - t0:.1f}"
          f" s; {st['packed_projections']} packed projections, "
          f"{st['unique_patterns']} unique patterns, density "
          f"{st['density']:.3f}, registry {st['registry']}")
    total, _ = servable.pack_bytes()
    print(f"[serving] pack bytes {total}")

    rng = np.random.RandomState(seed)
    seq = 384
    reqs = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
            for _ in range(n_requests)]
    batch8 = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, seq))).to(dev)

    def dense(tokens):
        return model_forward(pruned, cfg, {"tokens": tokens})[0]

    # warm up both paths (first K1 launch loads the library)
    servable.forward(reqs[0])
    dense(reqs[0])
    torch.cuda.synchronize()

    # --- the counted main-path run: every count set to 0 just before
    per_forward = cfg.n_layers * 4
    plan_dds.launches = 0
    outs = []
    for toks in reqs + [batch8]:
        before = plan_dds.launches
        outs.append(servable.forward(toks))
        check(plan_dds.launches - before == per_forward,
              f"K1 launched {plan_dds.launches - before} times in one "
              f"forward, expected {per_forward}")
    torch.cuda.synchronize()
    launches = plan_dds.launches
    print(f"[serving] K1 launches over {len(outs)} forwards: {launches} "
          f"({per_forward} per forward)")

    worst = 0.0
    for toks, y in zip(reqs + [batch8], outs):
        check(tuple(y.shape) == (toks.shape[0], seq, cfg.vocab_size),
              f"logits shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "non-finite logits")
        worst = max(worst, float((y - dense(toks)).abs().max()))
    print(f"[serving] parity vs dense on the same pruned weights: "
          f"max |d logits| = {worst:.3e} (tol {TOL_LOGITS})")
    check(worst <= TOL_LOGITS, "served logits disagree with the dense path")

    for name, fn in (("dense", dense), ("BSR", servable.forward)):
        ms = []
        for toks in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(toks)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[serving] {name:5s} ms/request (1, {seq}) over {len(ms)}: "
              f"median {np.median(ms):.3f}, min {min(ms):.3f}, "
              f"max {max(ms):.3f}")
    for name, fn in (("dense", dense), ("BSR", servable.forward)):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(batch8)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[serving] {name:5s} ms for the (8, {seq}) batch over 3: "
              f"median {np.median(ms):.3f}, min {min(ms):.3f}")
    _profile(f"BSR forward (1, {seq})", lambda: servable.forward(reqs[0]))
    _profile(f"dense forward (1, {seq})", lambda: dense(reqs[0]))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_sparse")
        servable.save(path)
        again = load_servable(path, device=dev)
        check(again.spec == spec, "reloaded spec differs")
        y2 = again.forward(reqs[0])
        check(torch.equal(y2, outs[0]), "reloaded logits are not bit-equal")
    print("[serving] save -> load_servable: logits bit-equal")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,serving")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    try:
        card = phase_build()
        per_shape, launches = [], None
        if "kernels" in phases:
            per_shape = phase_kernels(args.seed)
        if "serving" in phases:
            launches = phase_serving(args.seed, args.requests)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    record = {
        "name": "plan_dds", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        # one encoder layer's four projections at M=384 (times summed)
        "max_abs_err": max((r["max_abs_err"] for r in per_shape),
                           default=None),
        "ms": sum(r["ms"] for r in per_shape) if per_shape else None,
        "plain_ms": (sum(r["plain_ms"] for r in per_shape)
                     if per_shape else None),
        "bound_ms": (sum(r["bound_ms"] for r in per_shape)
                     if per_shape else None),
        "bound_by": (("bytes" if sum(r["bytes_ms"] for r in per_shape)
                      >= sum(r["operations_ms"] for r in per_shape)
                      else "operations") if per_shape else None),
        "library_ms": (sum(r["library_ms"] for r in per_shape)
                       if per_shape else None),
        "per_shape": per_shape,
    }
    print(f"card: {card}")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
