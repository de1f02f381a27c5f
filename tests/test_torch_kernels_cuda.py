"""Kernels K1 (``csrc/plan_dds.cu``), K2 and K3 (``csrc/flash_decode.cu``),
K4 (``csrc/dds.cu``), K5 (``csrc/sddmm.cu``), K6 (``csrc/plan_dds_q.cu``)
and K7 (``csrc/masked.cu``) on the card against their plain versions, and
the gradients of the two kernel-backed ops against the plain backends. K1
and K6 run through each of their instances (``bsr_matmul.PLAN_INSTANCES``),
K4, K5 and K7 through theirs (``DDS_INSTANCES``, ``SDDMM_INSTANCES``,
``MASKED_INSTANCES``: the ring instances bitwise equal to general, K5's
with one split). Also what the engine needs to hold on the card: threefry
keys and bits and the int8 KV quantizer equal to the CPU's, K1 at the M of
chunked prefill; and the vlm / MoE / MLA families' shapes: K1 at pixtral_12b's,
qwen3_moe's and deepseek_v2_lite's packed attention projections at M = 4
and 1024, K2 / K3 at head_dim 128 with G = 4 and 16; the hybrid and audio
families' shapes: K1 at recurrentgemma_9b's packed FFN and local-attention
projections at M = 4 and 1024, K2 at its MQA ring (Hkv 1, G 16, D 256)
and at whisper_base's decoder cache (Hkv 8, G 1, D 64).

Imports only the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Without a CUDA card the test skips: the kernel has no CPU mode.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels.bsr_matmul import pack_bsr, plan_dds  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("tile,n,k,m", [((16, 32), 96, 128, 24),
                                        ((32, 1), 64, 64, 40),
                                        ((128, 128), 768, 768, 384)])
def test_plan_dds_kernel_matches_plain_on_card(tile, n, k, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(8)
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // tile[0], k // tile[1]) < 0.3,
                 np.ones(tile, np.float32))
    pk = pack_bsr(w, tile)
    plan = txp.build_plan(pk)
    data = txp.pack_plan_data(plan, pk.data).cuda()
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    sched = txp.plan_schedule(plan)
    before = plan_dds.launches
    y = plan_dds(x, data, sched, n=n, tile=tile, bias=b, act="gelu")
    assert plan_dds.launches == before + 1
    ref = txp.plan_fused_linear_plain(x, data, plan, bias=b, act="gelu")
    # fp32 sums in another order than the plain version's
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-5)


# --------------------------------------------------------------------------
# K2 / K3 (csrc/flash_decode.cu) against their plain versions
# --------------------------------------------------------------------------

def _decode_inputs(rng, dtype, b, t, hq, hkv, d):
    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            "cuda", dtype)
    return rnd(b, 1, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d)


# fp32: same splits, fp32 math, another summation order; bf16: one bf16
# rounding step of the output (2^-7) with margin, relative to max|ref|
_DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,window,kv_split", [
    (8, 4, 16, 0, 3), (8, 4, 16, 8, 4), (4, 4, 8, 0, None),
    (32, 2, 128, 0, None), (8, 4, 256, 1024, None)])
def test_flash_decode_kernel_matches_plain_on_card(dtype, hq, hkv, d, window,
                                                   kv_split):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    rng = np.random.RandomState(3)
    b, t = 4, 1030 if d == 256 else 30
    q, k, v = _decode_inputs(rng, dtype, b, t, hq, hkv, d)
    kvp = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(
        b, 1)
    pos = torch.tensor([t - 1, -1, 11, t // 2], dtype=torch.int32,
                       device="cuda")
    before = flash_decode.launches
    out = flash_decode(q, k, v, kvp, pos, window=window, kv_split=kv_split)
    assert flash_decode.launches == before + 1
    ref = flash_decode_plain(q, k, v, kvp, pos, window=window,
                             kv_split=kv_split)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= \
        _DECODE_TOL[dtype] * scale
    assert float(out[1].float().abs().max()) == 0.0      # inactive slot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_kernel_bit_exact_vs_dense_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode,
                                                  paged_flash_decode_plain)
    from repro_torch.models.common import paged_view
    rng = np.random.RandomState(4)
    b, npg, ps, hkv, hq, d = 2, 4, 8, 2, 4, 16
    kp = torch.from_numpy(rng.randn(b * npg + 3, ps, hkv, d).astype(
        np.float32)).to("cuda", dtype)
    vp = torch.from_numpy(rng.randn(b * npg + 3, ps, hkv, d).astype(
        np.float32)).to("cuda", dtype)
    table = torch.tensor([[2, 5, 7, -1], [1, 9, -1, -1]], dtype=torch.int32,
                         device="cuda")
    pm = torch.full((b, npg * ps), -1, dtype=torch.int32, device="cuda")
    pm[0, :3 * ps] = torch.arange(3 * ps, dtype=torch.int32, device="cuda")
    pm[1, :2 * ps] = torch.arange(2 * ps, dtype=torch.int32, device="cuda")
    pos = torch.tensor([3 * ps - 1, ps + 3], dtype=torch.int32,
                       device="cuda")
    q = torch.from_numpy(rng.randn(b, 1, hq, d).astype(np.float32)).to(
        "cuda", dtype)
    before = paged_flash_decode.launches
    out = paged_flash_decode(q, kp, vp, table, pm, pos)
    assert paged_flash_decode.launches == before + 1
    dense = flash_decode(q, paged_view(kp, table, pm),
                         paged_view(vp, table, pm), pm, pos, kv_split=npg)
    ref = paged_flash_decode_plain(q, kp, vp, table, pm, pos)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= \
        _DECODE_TOL[dtype] * scale


def _split_edge_case(rng, case, dtype):
    """(q, k, v, kvp, pos, kv_split) for the split-parallel edge cases."""
    if case == "rising_max":       # scores grow with t: every combine rescales
        b, t, hq, hkv, d = 2, 256, 8, 4, 64
        q = torch.from_numpy(np.abs(rng.randn(b, 1, hq, d)).astype(
            np.float32)).to("cuda", dtype)
        ramp = 0.005 * np.arange(t, dtype=np.float32)[None, :, None, None]
        k = torch.from_numpy(0.1 * rng.randn(b, t, hkv, d).astype(np.float32)
                             + ramp).to("cuda", dtype)
        v = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32)).to(
            "cuda", dtype)
        kvp = torch.arange(t, dtype=torch.int32, device="cuda")
        return q, k, v, kvp, [t - 1, 200], 8
    if case == "long_single_split":    # G * T scores exceed shared memory
        b, t, hq, hkv, d = 2, 4096, 32, 2, 128
        q, k, v = _decode_inputs(rng, dtype, b, t, hq, hkv, d)
        kvp = torch.arange(t, dtype=torch.int32, device="cuda")
        return q, k, v, kvp, [t - 1, 2000], 1
    # T = 10 over 8 splits of 2: splits 5-7 empty, slot 1's split 2 masked,
    # slot 2 inactive
    b, t, hq, hkv, d = 3, 10, 4, 2, 32
    q, k, v = _decode_inputs(rng, dtype, b, t, hq, hkv, d)
    kvp = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
    kvp[1, 4:6] = -1
    return q, k, v, kvp, [9, 9, -1], 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["rising_max", "long_single_split",
                                  "empty_splits"])
def test_split_parallel_decode_edge_cases_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    rng = np.random.RandomState(6)
    q, k, v, kvp, posl, kv_split = _split_edge_case(rng, case, dtype)
    pos = torch.tensor(posl, dtype=torch.int32, device="cuda")
    out = flash_decode(q, k, v, kvp, pos, kv_split=kv_split)
    ref = flash_decode_plain(q, k, v, kvp, pos, kv_split=kv_split)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= \
        _DECODE_TOL[dtype] * scale
    for row in [i for i, p in enumerate(posl) if p < 0]:
        assert float(out[row].float().abs().max()) == 0.0


def _main_path_paged_case(rng):
    """gemma3_4b's global decode shape: B=4, Hkv=4, G=2, D=256, bf16, 1280
    positions in 80 shuffled pages of 16, ragged pos."""
    b, hkv, g, d, t, ps = 4, 4, 2, 256, 1280, 16
    npg = t // ps
    q, k, v = _decode_inputs(rng, torch.bfloat16, b, t, hkv * g, hkv, d)
    posl = [1279, 1105, 700, 333]
    kvp = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
    kvp = torch.where(kvp <= torch.tensor(posl, device="cuda")[:, None], kvp,
                      torch.full_like(kvp, -1))
    table = torch.from_numpy(rng.permutation(b * npg).astype(
        np.int32)).cuda().reshape(b, npg)
    kp = torch.empty((b * npg, ps, hkv, d), dtype=torch.bfloat16,
                     device="cuda")
    vp = torch.empty_like(kp)
    kp[table.long()] = k.reshape(b, npg, ps, hkv, d)
    vp[table.long()] = v.reshape(b, npg, ps, hkv, d)
    pos = torch.tensor(posl, dtype=torch.int32, device="cuda")
    return q, k, v, kp, vp, table, kvp, pos


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_decode_kernels_are_bitwise_repeatable_on_card(paged):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    q, k, v, kp, vp, table, kvp, pos = _main_path_paged_case(
        np.random.RandomState(7))
    if paged:
        def run():
            return paged_flash_decode(q, kp, vp, table, kvp, pos)
    else:
        def run():
            return flash_decode(q, k, v, kvp, pos)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)       # no atomics, a fixed order


@pytest.mark.cuda
def test_paged_kernel_bit_exact_vs_dense_at_the_main_path_shape_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    from repro_torch.models.common import paged_view
    q, _, _, kp, vp, table, kvp, pos = _main_path_paged_case(
        np.random.RandomState(8))
    out = paged_flash_decode(q, kp, vp, table, kvp, pos)
    dense = flash_decode(q, paged_view(kp, table, kvp),
                         paged_view(vp, table, kvp), kvp, pos,
                         kv_split=table.shape[1])
    torch.cuda.synchronize()
    assert torch.equal(out, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d,dtype,err", [
    (4, 2, 320, torch.float32, ValueError),       # head dim over 256
    (34, 2, 64, torch.float32, ValueError),       # G = 17
    (4, 2, 64, torch.float16, TypeError),         # fp16
])
def test_decode_kernels_raise_on_what_they_do_not_take(hq, hkv, d, dtype,
                                                       err):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    q = torch.zeros((1, 1, hq, d), dtype=dtype, device="cuda")
    k = torch.zeros((1, 8, hkv, d), dtype=dtype, device="cuda")
    before = (flash_decode.launches, paged_flash_decode.launches)
    with pytest.raises(err):
        flash_decode(q, k, k, torch.arange(8, device="cuda"), 7)
    pages = torch.zeros((2, 4, hkv, d), dtype=dtype, device="cuda")
    table = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
    with pytest.raises(err):
        paged_flash_decode(q, pages, pages, table,
                           torch.arange(8, device="cuda")[None], 7)
    assert (flash_decode.launches, paged_flash_decode.launches) == before


# --------------------------------------------------------------------------
# K4 / K5 (csrc/dds.cu, csrc/sddmm.cu) against their plain versions
# --------------------------------------------------------------------------

# fp32: fp32 sums in another order, within 1e-5 of max|ref|; bf16 outputs:
# one bf16 rounding step (2^-7) with margin
_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _close(got, ref, tol):
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= tol * scale


def _bsr_case(rng, n, k, tile, density, pad, dtype):
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // tile[0], k // tile[1]) < density,
                 np.ones(tile, np.float32))
    pk = pack_bsr(w, tile)
    if pad:
        pk = pack_bsr(w, tile, nnzt=pk.real_nnzt + pad)
    return pk, torch.from_numpy(pk.data).to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,tile,pad", [(100, 128, 384, (32, 128), 3),
                                            (40, 64, 96, (32, 1), 0),
                                            (384, 768, 768, (128, 128), 2)])
def test_dds_and_sddmm_kernels_match_plain_on_card(m, n, k, tile, pad,
                                                   dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(9)
    pk, data = _bsr_case(rng, n, k, tile, 0.3, pad, dtype)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to("cuda",
                                                                 dtype)
    dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to("cuda",
                                                                  dtype)
    before = (bm.dds.launches, bm.dds_t.launches, bm.sddmm.launches)
    y, dx, g = bm.dds(x, pk, data), bm.dds_t(dy, pk, data), \
        bm.sddmm(dy, x, pk, data)
    assert (bm.dds.launches, bm.dds_t.launches, bm.sddmm.launches) == \
        tuple(c + 1 for c in before)
    _close(y, bm.dds_plain(x, pk, data), _BWD_TOL[dtype])
    _close(dx, bm.dds_t_plain(dy, pk, data), _BWD_TOL[dtype])
    _close(g, bm.sddmm_plain(dy, x, pk, data), _BWD_TOL[dtype])
    assert g.dtype == dtype
    assert float(g[pk.real_nnzt:].float().abs().sum()) == 0.0
    # bit for bit on a second run: no atomics
    assert torch.equal(g, bm.sddmm(dy, x, pk, data))


@pytest.mark.cuda
@pytest.mark.parametrize("tile,n,k,m", [((16, 64), 128, 1024, 20),
                                        ((128, 128), 2304, 768, 3072)])
def test_plan_backward_kernels_match_plain_on_card(tile, n, k, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(10)
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // tile[0], k // tile[1]) < 0.3,
                 np.ones(tile, np.float32))
    if tile == (16, 64):     # one hot block row: the plan spills
        w[:16, :] = rng.randn(16, k)
    pk = pack_bsr(w, tile)
    plan = txp.build_plan(pk)
    data = txp.pack_plan_data(plan, pk.data).cuda()
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda()
    dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).cuda()
    ts, s = txp.plan_t_schedule(plan), txp.plan_schedule(plan)
    _close(bm.plan_dds_t(dy, data, ts, k=k, tile=tile),
           bm.plan_dds_t_plain(dy, data, ts, k=k, tile=tile), 1e-5)
    _close(bm.plan_sddmm(dy, x, s, tile=tile),
           bm.plan_sddmm_plain(dy, x, s, tile=tile), 1e-5)


@pytest.mark.cuda
def test_kernel_op_gradients_match_the_plain_backends_on_card():
    """plan_linear_pallas (K1 / K4 / K5) against plan_linear, and
    bsr_linear('pallas') (K4 / K4 / K5) against bsr_linear('gather'), on
    the card: outputs and both gradients, padding exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels.ops import bsr_linear
    rng = np.random.RandomState(11)
    w = rng.randn(256, 384).astype(np.float32)
    w *= np.kron(rng.rand(8, 6) < 0.4, np.ones((32, 64), np.float32))
    pk = pack_bsr(w, (32, 64), nnzt=None)
    pk = pack_bsr(w, (32, 64), nnzt=pk.real_nnzt + 3)
    plan = txp.build_plan(pk)
    x0 = torch.from_numpy(rng.randn(48, 384).astype(np.float32)).cuda()

    def grads(fn, data):
        x = x0.clone().requires_grad_(True)
        d = data.clone().requires_grad_(True)
        y = fn(x, d)
        (y ** 2).sum().backward()
        return y.detach(), x.grad, d.grad

    rp = txp.pack_plan_data(plan, pk.data).cuda()
    before = (plan_dds.launches, bm.plan_dds_t.launches,
              bm.plan_sddmm.launches)
    got = grads(lambda x, d: txp.plan_linear_pallas(x, d, plan), rp)
    assert (plan_dds.launches, bm.plan_dds_t.launches,
            bm.plan_sddmm.launches) == tuple(c + 1 for c in before)
    want = grads(lambda x, d: txp.plan_linear(x, d, plan), rp)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)
    assert float(got[2][torch.from_numpy(~plan.slot_mask)].abs().sum()) == 0

    flat = torch.from_numpy(pk.data).cuda()
    got = grads(lambda x, d: bsr_linear(x, d, pk, "pallas"), flat)
    want = grads(lambda x, d: bsr_linear(x, d, pk, "gather"), flat)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)
    assert float(got[2][pk.real_nnzt:].abs().sum()) == 0.0


@pytest.mark.cuda
def test_backward_kernels_raise_on_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(12)
    pk, data = _bsr_case(rng, 64, 128, (32, 64), 0.5, 0, torch.float32)
    x = torch.zeros((8, 128), device="cuda")
    dy = torch.zeros((8, 64), device="cuda")
    before = (bm.dds.launches, bm.dds_t.launches, bm.sddmm.launches)
    with pytest.raises(ValueError):          # a wrong K
        bm.dds(torch.zeros((8, 96), device="cuda"), pk, data)
    with pytest.raises(TypeError):           # fp16
        bm.dds(x.half(), pk, data)
    with pytest.raises(ValueError):          # not contiguous
        bm.dds_t(torch.zeros((64, 8), device="cuda").t(), pk, data)
    with pytest.raises(TypeError):           # dy and x of two dtypes
        bm.sddmm(dy.bfloat16(), x, pk, data)
    with pytest.raises(ValueError):          # tensors on two devices
        bm.sddmm(dy, x.cpu(), pk, data)
    assert (bm.dds.launches, bm.dds_t.launches, bm.sddmm.launches) == before


# --------------------------------------------------------------------------
# K6 (csrc/plan_dds_q.cu) and K7 (csrc/masked.cu) against their plain
# versions
# --------------------------------------------------------------------------

def _quant_case(rng, n, k, tile, density, qdtype):
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // tile[0], k // tile[1]) < density,
                 np.ones(tile, np.float32))
    plan = txp.build_plan(pack_bsr(w, tile))
    data = txp.pack_plan_data(plan, pack_bsr(w, tile).data)
    gran = txp.quant_granularity(tile)
    q, s = txp.quantize_plan_values(data, qdtype, gran)
    return plan, q.cuda(), s.cuda(), gran


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("tile,n,k,m,x_dtype", [
    ((16, 32), 96, 128, 24, torch.float32),
    ((32, 1), 64, 64, 40, torch.float32),          # 'row' scales
    ((128, 128), 768, 768, 130, torch.bfloat16)])
def test_plan_dds_q_kernel_matches_plain_on_card(qdtype, tile, n, k, m,
                                                 x_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.bsr_matmul import plan_dds_q, plan_dds_q_plain
    rng = np.random.RandomState(13)
    plan, q, s, gran = _quant_case(rng, n, k, tile, 0.3, qdtype)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().to(
        x_dtype)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    kw = dict(n=n, tile=tile, granularity=gran, bias=b, act="silu")
    sched = txp.plan_schedule(plan)
    before = plan_dds_q.launches
    y = plan_dds_q(x, q, s, sched, **kw)
    assert plan_dds_q.launches == before + 1 and y.dtype == x_dtype
    ref = plan_dds_q_plain(x, q, s, sched, **kw)
    # fp32: sums in another order; bf16: one output rounding step
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((y.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,tile", [(100, 128, 384, (32, 128)),
                                        (40, 64, 64, (32, 1)),
                                        (130, 256, 256, (128, 128))])
def test_masked_matmul_kernel_skips_masked_tiles_on_card(m, n, k, tile,
                                                         dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.bsr_matmul import (masked_matmul,
                                                masked_matmul_plain)
    rng = np.random.RandomState(14)
    # values in every tile, masked ones too: skipping is what is tested
    w = torch.from_numpy(rng.randn(n, k).astype(np.float32)).cuda().to(dtype)
    mask = rng.rand(n // tile[0], k // tile[1]) < 0.4
    mask[0, 0] = False
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().to(dtype)
    before = masked_matmul.launches
    y = masked_matmul(x, w, mask, tile=tile)
    assert masked_matmul.launches == before + 1 and y.dtype == dtype
    ref = masked_matmul_plain(x, w, mask, tile=tile)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((y.float() - ref.float()).abs().max()) <= tol * scale
    # a device mask gives the same product
    dev_mask = torch.from_numpy(mask.astype(np.int32)).cuda()
    assert torch.equal(masked_matmul(x, w, dev_mask, tile=tile), y)


@pytest.mark.cuda
def test_quant_and_masked_kernels_raise_on_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(15)
    plan, q, s, gran = _quant_case(rng, 64, 128, (16, 32), 0.5, "int8")
    sched = txp.plan_schedule(plan)
    kw = dict(n=64, tile=(16, 32), granularity=gran)
    x = torch.zeros((8, 128), device="cuda")
    w = torch.zeros((64, 128), device="cuda")
    mask = np.ones((4, 4), bool)
    before = (bm.plan_dds_q.launches, bm.masked_matmul.launches)
    with pytest.raises(ValueError):          # a wrong K
        bm.plan_dds_q(torch.zeros((8, 96), device="cuda"), q, s, sched, **kw)
    with pytest.raises(ValueError):          # x on the card, values not
        bm.plan_dds_q(x, q.cpu(), s.cpu(), sched, **kw)
    with pytest.raises(TypeError):           # fp32 values are K1's
        bm.plan_dds_q(x, q.float(), s, sched, **kw)
    with pytest.raises(ValueError):          # 'row' scales for a block pack
        bm.plan_dds_q(x, q, s, sched, **dict(kw, granularity="row"))
    with pytest.raises(RuntimeError):        # K6 is forward-only
        txp.plan_q_linear_pallas(x.requires_grad_(True), q, s, plan)
    with pytest.raises(ValueError):          # a wrong K
        bm.masked_matmul(torch.zeros((8, 96), device="cuda"), w, mask,
                         tile=(16, 32))
    with pytest.raises(ValueError):          # x on the card, W not
        bm.masked_matmul(x.detach(), w.cpu(), mask, tile=(16, 32))
    with pytest.raises(ValueError):          # a mask of another shape
        bm.masked_matmul(x.detach(), w, np.ones((2, 4), bool), tile=(16, 32))
    assert (bm.plan_dds_q.launches, bm.masked_matmul.launches) == before


# --------------------------------------------------------------------------
# K1 and K6 through each instance (csrc/plan_dds_common.cuh)
# --------------------------------------------------------------------------

_K1_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
_K6_PAIRS = [(torch.float32, "int8"), (torch.float32, "fp8"),
             (torch.bfloat16, "int8"), (torch.bfloat16, "fp8")]
_QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_INSTANCE_MS = (1, 4, 16, 17, 64, 384)


def _instance_layouts(rng):
    """(name, dense weight, tile) of every tile class: 128x128 and 16x32
    (the vector instances), the spilling plan (16, 64), a fused QKV pack
    (16, 16), 8x48 (a depth the tc ring takes in one 32 and one 16 slab),
    runs of 70 tiles (8x16; the stream instance reads 32 at a time) and
    32x1 (general only)."""
    def sparse(n, k, tile, density):
        w = rng.randn(n, k).astype(np.float32)
        return w * np.kron(rng.rand(n // tile[0], k // tile[1]) < density,
                           np.ones(tile, np.float32))
    spill = np.zeros((128, 1024), np.float32)
    spill[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        spill[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    qkv = np.concatenate([sparse(48, 64, (16, 16), 0.5) for _ in range(3)])
    return [("128x128", sparse(256, 512, (128, 128), 0.4), (128, 128)),
            ("16x32", sparse(96, 128, (16, 32), 0.4), (16, 32)),
            ("spill", spill, (16, 64)), ("fused qkv", qkv, (16, 16)),
            ("8x48", sparse(64, 96, (8, 48), 0.5), (8, 48)),
            ("long runs", rng.randn(16, 1120).astype(np.float32), (8, 16)),
            ("32x1", sparse(64, 64, (32, 1), 0.3), (32, 1))]


def _instance_cases(kernel):
    from repro_torch.kernels import bsr_matmul as bm
    pairs = _K1_PAIRS if kernel == "K1" else _K6_PAIRS
    out = []
    for inst in bm.PLAN_INSTANCES:
        for m in _INSTANCE_MS:
            for xd, vd in pairs:
                v = vd if kernel == "K1" else _QDTYPE[vd]
                if any(bm.instance_takes(inst, m, t, xd, v)
                       for t in ((128, 128), (16, 32), (32, 1))):
                    out.append((inst, m, xd, vd))
    return out


def _rel_err(y, ref):
    scale = max(1.0, float(ref.float().abs().max()))
    return float((y.float() - ref.float()).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("instance,m,x_dtype,v_dtype", _instance_cases("K1"))
def test_plan_dds_instances_match_plain_on_card(instance, m, x_dtype,
                                                v_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(16)
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    ran = 0
    for name, w, tile in _instance_layouts(rng):
        if not bm.instance_takes(instance, m, tile, x_dtype, v_dtype):
            continue
        n, k = w.shape
        plan = txp.build_plan(pack_bsr(w, tile))
        data = txp.pack_plan_data(plan, pack_bsr(w, tile).data).cuda().to(
            v_dtype)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().to(
            x_dtype)
        b = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        before = bm.plan_dds.launches
        y = bm.plan_dds(x, data, txp.plan_schedule(plan), n=n, tile=tile,
                        bias=b, act="gelu", instance=instance)
        assert bm.plan_dds.launches == before + 1 and y.dtype == x_dtype
        ref = txp.plan_fused_linear_plain(x, data, plan, bias=b, act="gelu")
        assert _rel_err(y, ref) <= tol, (name, _rel_err(y, ref))
        ran += 1
    assert ran


@pytest.mark.cuda
@pytest.mark.parametrize("instance,m,x_dtype,qdtype", _instance_cases("K6"))
def test_plan_dds_q_instances_match_plain_on_card(instance, m, x_dtype,
                                                  qdtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(17)
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    ran = 0
    for name, w, tile in _instance_layouts(rng):
        if not bm.instance_takes(instance, m, tile, x_dtype,
                                 _QDTYPE[qdtype]):
            continue
        n, k = w.shape
        plan = txp.build_plan(pack_bsr(w, tile))
        data = txp.pack_plan_data(plan, pack_bsr(w, tile).data)
        data[0] = 0.0             # the first virtual row: all-zero tiles
        sched = txp.plan_schedule(plan)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().to(
            x_dtype)
        b = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        for gran in ("block", "row"):
            q, s = txp.quantize_plan_values(data, qdtype, gran)
            q, s = q.cuda(), s.cuda()
            kw = dict(n=n, tile=tile, granularity=gran, bias=b, act="silu")
            before = bm.plan_dds_q.launches
            y = bm.plan_dds_q(x, q, s, sched, instance=instance, **kw)
            assert bm.plan_dds_q.launches == before + 1
            assert y.dtype == x_dtype
            ref = bm.plan_dds_q_plain(x, q, s, sched, **kw)
            assert _rel_err(y, ref) <= tol, (name, gran, _rel_err(y, ref))
            ran += 1
    assert ran


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["stream", "tc", "fp32", "general"])
def test_plan_instances_are_bitwise_repeatable_on_card(instance):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(18)
    name, w, tile = _instance_layouts(rng)[2]          # the spilling plan
    n, k = w.shape
    plan = txp.build_plan(pack_bsr(w, tile))
    values = txp.pack_plan_data(plan, pack_bsr(w, tile).data)
    sched = txp.plan_schedule(plan)
    m = 4 if instance == "stream" else 70
    xd = torch.bfloat16 if instance == "tc" else torch.float32
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().to(xd)
    data = values.cuda().to(xd)
    ys = [bm.plan_dds(x, data, sched, n=n, tile=tile, instance=instance)
          for _ in range(2)]
    assert torch.equal(ys[0], ys[1])
    q, s = txp.quantize_plan_values(values, "int8", "block")
    q, s = q.cuda(), s.cuda()
    ys = [bm.plan_dds_q(x, q, s, sched, n=n, tile=tile, instance=instance)
          for _ in range(2)]
    assert torch.equal(ys[0], ys[1])


@pytest.mark.cuda
def test_fp32_instance_sums_in_the_general_order_on_card():
    """Both instances sum each output in schedule order, k ascending, with
    the per-tile scale fold: their results are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(19)
    for name, w, tile in _instance_layouts(rng)[:3]:
        n, k = w.shape
        plan = txp.build_plan(pack_bsr(w, tile))
        data = txp.pack_plan_data(plan, pack_bsr(w, tile).data)
        sched = txp.plan_schedule(plan)
        x = torch.from_numpy(rng.randn(96, k).astype(np.float32)).cuda()
        d = data.cuda()
        assert torch.equal(
            bm.plan_dds(x, d, sched, n=n, tile=tile, instance="fp32"),
            bm.plan_dds(x, d, sched, n=n, tile=tile, instance="general"))
        q, s = txp.quantize_plan_values(data, "fp8", "block")
        q, s = q.cuda(), s.cuda()
        assert torch.equal(
            bm.plan_dds_q(x, q, s, sched, n=n, tile=tile, instance="fp32"),
            bm.plan_dds_q(x, q, s, sched, n=n, tile=tile,
                          instance="general"))


@pytest.mark.cuda
def test_plan_launch_refused_for_shared_memory_raises_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(20)
    name, w, tile = _instance_layouts(rng)[0]
    n, k = w.shape
    plan = txp.build_plan(pack_bsr(w, tile))
    data = txp.pack_plan_data(plan, pack_bsr(w, tile).data)
    sched = txp.plan_schedule(plan)
    x = torch.from_numpy(rng.randn(64, k).astype(np.float32)).cuda()
    xb, db = x.bfloat16(), data.cuda().bfloat16()
    q, s = txp.quantize_plan_values(data, "int8", "block")
    q, s = q.cuda(), s.cuda()
    # the tc ring of bf16 values asks for 60 KB: above the 48 KB default,
    # so the kernel's limit is raised first; this call must work
    assert bm.plan_smem_bytes("tc", torch.bfloat16, torch.bfloat16) > 49152
    ok = bm.plan_dds(xb, db, sched, n=n, tile=tile, instance="tc")
    before = (bm.plan_dds.launches, bm.plan_dds_q.launches)
    real = bm.plan_smem_bytes
    # more than the card's 227 KB a block: cudaFuncSetAttribute refuses
    monkeypatch.setattr(bm, "plan_smem_bytes", lambda *a: 300 * 1024)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.plan_dds(xb, db, sched, n=n, tile=tile, instance="tc")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.plan_dds_q(x, q, s, sched, n=n, tile=tile, instance="fp32")
    # less than the ring needs: the entry point refuses before launching
    monkeypatch.setattr(bm, "plan_smem_bytes", lambda *a: 1024)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.plan_dds(x, data.cuda(), sched, n=n, tile=tile, instance="fp32")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.plan_dds_q(xb, q, s, sched, n=n, tile=tile, instance="tc")
    assert (bm.plan_dds.launches, bm.plan_dds_q.launches) == before
    monkeypatch.setattr(bm, "plan_smem_bytes", real)
    # an instance that cannot take the call is refused in Python
    with pytest.raises(ValueError, match="instance"):
        bm.plan_dds(x[:17].contiguous(), data.cuda(), sched, n=n, tile=tile,
                    instance="stream")
    with pytest.raises(ValueError, match="instance"):
        bm.plan_dds(x, data.cuda(), sched, n=n, tile=tile, instance="tc")
    # and the card is still sound: the same call gives the same bits
    assert torch.equal(bm.plan_dds(xb, db, sched, n=n, tile=tile,
                                   instance="tc"), ok)


# --------------------------------------------------------------------------
# K5 (csrc/sddmm.cu) and K7 (csrc/masked.cu) through each instance
# --------------------------------------------------------------------------

_K57_MS = (1, 17, 384, 3072)
_K57_TILES = ((128, 128), (64, 128), (32, 64), (32, 1))
_K57_DTYPES = (torch.float32, torch.bfloat16)


def _k57_cases(kernel):
    from repro_torch.kernels import bsr_matmul as bm
    out = []
    for inst in (bm.SDDMM_INSTANCES if kernel == "K5"
                 else bm.MASKED_INSTANCES):
        for m in _K57_MS:
            for dtype in _K57_DTYPES:
                for tile in _K57_TILES:
                    takes = (bm.sddmm_takes(inst, m, tile, dtype)
                             if kernel == "K5" else
                             bm.masked_takes(inst, m, tile, dtype, dtype))
                    if takes:
                        out.append((inst, m, dtype, tile))
    return out


def _k57_weight(rng, tile, density=0.3):
    """(dense weight, tile mask) of a few tiles in each direction."""
    bn, bk = tile
    n, k = bn * max(2, 256 // bn), bk * max(3, 384 // bk)
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // bn, k // bk) < density
    mask[0, :] = False            # an all-masked (all-zero) block row
    return w * np.kron(mask, np.ones(tile, np.float32)), w, mask


@pytest.mark.cuda
@pytest.mark.parametrize("instance,m,dtype,tile", _k57_cases("K5"))
def test_sddmm_instances_match_plain_on_card(instance, m, dtype, tile):
    """sddmm over a padded KernelBSR and plan_sddmm over the plan's
    schedule, through ``instance`` (the ring with its own split count and
    with 1 and 3 splits asked for): padding tiles exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(21)
    wz, _, _ = _k57_weight(rng, tile)
    pk = pack_bsr(wz, tile)
    pk = pack_bsr(wz, tile, nnzt=pk.real_nnzt + 2)
    n, k = wz.shape
    data = torch.from_numpy(pk.data).to("cuda", dtype)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to("cuda", dtype)
    dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to("cuda",
                                                                  dtype)
    plan = txp.build_plan(pack_bsr(wz, tile))
    sched = txp.plan_schedule(plan)
    ref = bm.sddmm_plain(dy, x, pk, data)
    ref_plan = bm.plan_sddmm_plain(dy, x, sched, tile=tile)
    for splits in ((None, 1, 3) if instance == "ring" else (None,)):
        before = (bm.sddmm.launches, bm.plan_sddmm.launches)
        g = bm.sddmm(dy, x, pk, data, instance=instance, splits=splits)
        gp = bm.plan_sddmm(dy, x, sched, tile=tile, instance=instance,
                           splits=splits)
        assert (bm.sddmm.launches, bm.plan_sddmm.launches) == \
            (before[0] + 1, before[1] + 1)
        assert g.dtype == dtype and gp.dtype == torch.float32
        assert _rel_err(g, ref) <= _BWD_TOL[dtype], (splits, _rel_err(g, ref))
        assert float(g[pk.real_nnzt:].float().abs().sum()) == 0.0
        # the plan's products are exact in fp32 for bf16 inputs
        assert _rel_err(gp, ref_plan) <= 1e-5, (splits, _rel_err(gp, ref_plan))


@pytest.mark.cuda
@pytest.mark.parametrize("instance,m,dtype,tile", _k57_cases("K7"))
def test_masked_instances_match_plain_on_card(instance, m, dtype, tile):
    """Values left in the masked tiles; an all-masked tile row gives
    exact zeros; the ring in both block heights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(22)
    _, w_np, mask = _k57_weight(rng, tile, 0.4)
    w = torch.from_numpy(w_np).to("cuda", dtype)
    x = torch.from_numpy(rng.randn(m, w_np.shape[1]).astype(np.float32)).to(
        "cuda", dtype)
    ref = bm.masked_matmul_plain(x, w, mask, tile=tile)
    for rows in ((64, 32) if instance == "ring" else (None,)):
        real = bm.masked_block_rows
        if rows is not None:
            bm.masked_block_rows = lambda *a, r=rows: r
        try:
            before = bm.masked_matmul.launches
            y = bm.masked_matmul(x, w, mask, tile=tile, instance=instance)
        finally:
            bm.masked_block_rows = real
        assert bm.masked_matmul.launches == before + 1 and y.dtype == dtype
        assert _rel_err(y, ref) <= _BWD_TOL[dtype], (rows, _rel_err(y, ref))
        assert float(y[:, :tile[0]].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["ring", "general"])
def test_sddmm_and_masked_instances_are_bitwise_repeatable_on_card(instance):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(23)
    wz, w_np, mask = _k57_weight(rng, (128, 128))
    plan = txp.build_plan(pack_bsr(wz, (128, 128)))
    sched = txp.plan_schedule(plan)
    x = torch.from_numpy(rng.randn(3072, wz.shape[1]).astype(
        np.float32)).cuda()
    dy = torch.from_numpy(rng.randn(3072, wz.shape[0]).astype(
        np.float32)).cuda()
    if instance == "ring":     # few tiles at M=3072: M is split
        assert bm.sddmm_splits(3072, sched.n_tiles, (128, 128))[0] > 1
    gs = [bm.plan_sddmm(dy, x, sched, tile=(128, 128), instance=instance)
          for _ in range(2)]
    assert torch.equal(gs[0], gs[1])
    w = torch.from_numpy(w_np).cuda()
    ys = [bm.masked_matmul(x[:384], w, mask, tile=(128, 128),
                           instance=instance) for _ in range(2)]
    assert torch.equal(ys[0], ys[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [17, 3072])
def test_ring_instances_sum_in_the_general_order_on_card(m):
    """K5's ring with one split and K7's ring (64- and 32-row blocks) sum
    each output in the general instance's order: bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(24)
    for tile in ((128, 128), (32, 64)):
        wz, w_np, mask = _k57_weight(rng, tile)
        pk = pack_bsr(wz, tile)
        pk = pack_bsr(wz, tile, nnzt=pk.real_nnzt + 2)
        data = torch.from_numpy(pk.data).cuda()
        x = torch.from_numpy(rng.randn(m, wz.shape[1]).astype(
            np.float32)).cuda()
        dy = torch.from_numpy(rng.randn(m, wz.shape[0]).astype(
            np.float32)).cuda()
        assert torch.equal(
            bm.sddmm(dy, x, pk, data, instance="ring", splits=1),
            bm.sddmm(dy, x, pk, data, instance="general"))
        w = torch.from_numpy(w_np).cuda()
        general = bm.masked_matmul(x, w, mask, tile=tile, instance="general")
        real = bm.masked_block_rows
        try:
            for rows in (64, 32):
                bm.masked_block_rows = lambda *a, r=rows: r
                assert torch.equal(bm.masked_matmul(
                    x, w, mask, tile=tile, instance="ring"), general)
        finally:
            bm.masked_block_rows = real


@pytest.mark.cuda
def test_sddmm_and_masked_instance_that_cannot_run_raises_on_card(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(25)
    wz, w_np, mask = _k57_weight(rng, (32, 64))
    pk = pack_bsr(wz, (32, 64))
    data = torch.from_numpy(pk.data).cuda()
    m, (n, k) = 40, wz.shape
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda()
    dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).cuda()
    w = torch.from_numpy(w_np).cuda()
    # an operand 4 bytes off a 16-byte boundary: the wrapper picks general
    # and refuses a pinned ring
    buf = torch.empty(m * k + 1, device="cuda")
    xu = buf[1:].view(m, k)
    xu.copy_(x)
    assert bm.sddmm_instance(m, (32, 64), xu.dtype, xu.data_ptr() % 16 == 0) \
        == "general"
    _close(bm.sddmm(dy, xu, pk, data), bm.sddmm_plain(dy, x, pk, data), 1e-5)
    _close(bm.masked_matmul(xu, w, mask, tile=(32, 64)),
           bm.masked_matmul_plain(x, w, mask, tile=(32, 64)), 1e-5)
    before = (bm.sddmm.launches, bm.masked_matmul.launches)
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.sddmm(dy, xu, pk, data, instance="ring")
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.sddmm(dy.bfloat16(), x.bfloat16(), pk, data, instance="ring")
    with pytest.raises(ValueError, match="general"):
        bm.sddmm(dy, x, pk, data, instance="general", splits=2)
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.masked_matmul(xu, w, mask, tile=(32, 64), instance="ring")
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.masked_matmul(x.bfloat16(), w.bfloat16(), mask, tile=(32, 64),
                         instance="ring")
    # past the Python check, the C entry refuses before launching
    monkeypatch.setattr(bm, "sddmm_takes", lambda *a, **kw: True)
    monkeypatch.setattr(bm, "masked_takes", lambda *a, **kw: True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.sddmm(dy.bfloat16(), x.bfloat16(), pk, data, instance="ring")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.sddmm(dy, xu, pk, data, instance="ring")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.masked_matmul(x.bfloat16(), w.bfloat16(), mask, tile=(32, 64),
                         instance="ring")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.masked_matmul(xu, w, mask, tile=(32, 64), instance="ring")
    assert (bm.sddmm.launches, bm.masked_matmul.launches) == before


# --------------------------------------------------------------------------
# K4 (csrc/dds.cu) through each instance
# --------------------------------------------------------------------------

_K4_TILES = ((128, 128), (64, 64), (16, 64), (32, 1), (1, 32))


def _k4_cases():
    """(instance, M, dtype, tile) where the instance takes dds or dds_t."""
    from repro_torch.kernels import bsr_matmul as bm
    return [(inst, m, dtype, tile)
            for inst in bm.DDS_INSTANCES for m in _K57_MS
            for dtype in _K57_DTYPES for tile in _K4_TILES
            if any(bm.dds_takes(inst, m, tile, dtype, t)
                   for t in (False, True))]


def _k4_case(rng, tile, m, dtype):
    """A padded KernelBSR with an all-zero block row, its plan, and X, dY
    (the plan's pack holds the same tiles as the KernelBSR)."""
    wz, _, _ = _k57_weight(rng, tile)
    pk = pack_bsr(wz, tile)
    pk = pack_bsr(wz, tile, nnzt=pk.real_nnzt + 2)
    plan = txp.build_plan(pack_bsr(wz, tile))
    n, k = wz.shape
    data = torch.from_numpy(pk.data).to("cuda", dtype)
    rp = txp.pack_plan_data(plan, pack_bsr(wz, tile).data).to("cuda", dtype)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to("cuda", dtype)
    dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to("cuda",
                                                                  dtype)
    return pk, data, plan, rp, x, dy


def _k4_calls(pk, data, plan, rp, x, dy):
    """(name, transposed, fn(instance), plain) of K4's three entry points."""
    from repro_torch.kernels import bsr_matmul as bm
    ts = txp.plan_t_schedule(plan)
    k, tile = plan.shape[1], plan.tile
    return [
        ("dds", False, lambda i: bm.dds(x, pk, data, instance=i),
         lambda: bm.dds_plain(x, pk, data)),
        ("dds_t", True, lambda i: bm.dds_t(dy, pk, data, instance=i),
         lambda: bm.dds_t_plain(dy, pk, data)),
        ("plan_dds_t", True,
         lambda i: bm.plan_dds_t(dy, rp, ts, k=k, tile=tile, instance=i),
         lambda: bm.plan_dds_t_plain(dy, rp, ts, k=k, tile=tile))]


@pytest.mark.cuda
@pytest.mark.parametrize("instance,m,dtype,tile", _k4_cases())
def test_dds_instances_match_plain_on_card(instance, m, dtype, tile):
    """dds, dds_t and plan_dds_t through ``instance`` wherever it takes the
    call (the ring at 64 and 32 rows a block): within the tolerance of the
    plain version, one launch each, the all-zero block row exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(26)
    case = _k4_case(rng, tile, m, dtype)
    ran = 0
    for name, transposed, fn, plain in _k4_calls(*case):
        if not bm.dds_takes(instance, m, tile, dtype, transposed):
            continue
        ref = plain()
        for rows in ((64, 32) if instance == "ring" else (None,)):
            real = bm.dds_block_rows
            if rows is not None:
                bm.dds_block_rows = lambda *a, r=rows: r
            try:
                counter = getattr(bm, name)
                before = counter.launches
                y = fn(instance)
            finally:
                bm.dds_block_rows = real
            assert counter.launches == before + 1 and y.dtype == dtype
            assert _rel_err(y, ref) <= _BWD_TOL[dtype], (name, rows)
            if not transposed:
                assert float(y[:, :tile[0]].float().abs().max()) == 0.0
        ran += 1
    assert ran


@pytest.mark.cuda
@pytest.mark.parametrize("m", [17, 3072])
def test_dds_ring_sums_in_the_general_order_on_card(m):
    """The ring (64- and 32-row blocks) is bitwise equal to general on all
    three entry points, and each instance is bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(27)
    for tile in ((128, 128), (64, 64), (16, 64)):
        case = _k4_case(rng, tile, m, torch.float32)
        for name, transposed, fn, _ in _k4_calls(*case):
            assert bm.dds_instance(m, tile, torch.float32,
                                   transposed) == "ring"
            general = fn("general")
            assert torch.equal(general, fn("general")), name
            real = bm.dds_block_rows
            try:
                for rows in (64, 32):
                    bm.dds_block_rows = lambda *a, r=rows: r
                    ring = fn("ring")
                    assert torch.equal(ring, fn("ring")), (name, rows)
                    assert torch.equal(ring, general), (name, tile, rows)
            finally:
                bm.dds_block_rows = real
            assert torch.equal(fn(None), general)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["ring", "general"])
def test_dds_empty_run_gives_exact_zeros_on_card(instance):
    """A transposed schedule with block column 1's tiles taken out: that
    output block's run is empty and is written as exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(28)
    tile = (128, 128)
    w = rng.randn(768, 768).astype(np.float32)
    w *= np.kron(rng.rand(6, 6) < 0.5, np.ones(tile, np.float32))
    w[:, 128:256] = rng.randn(768, 128)
    plan = txp.build_plan(pack_bsr(w, tile))
    ts = txp.plan_t_schedule(plan)
    keep = ts.row_ids != 1
    cut = bm.TileSequence(ts.row_ids[keep], ts.col_seq[keep],
                          ts.tile_seq[keep], n_out=ts.n_out, n_in=ts.n_in)
    assert cut.seg[1] == cut.seg[2]
    rp = txp.pack_plan_data(plan, pack_bsr(w, tile).data).cuda()
    dy = torch.from_numpy(rng.randn(3072, 768).astype(np.float32)).cuda()
    dx = bm.plan_dds_t(dy, rp, cut, k=768, tile=tile, instance=instance)
    torch.cuda.synchronize()
    assert float(dx[:, 128:256].abs().max()) == 0.0
    assert float(dx.abs().max()) > 0.0
    _close(dx, bm.plan_dds_t_plain(dy, rp, cut, k=768, tile=tile), 1e-5)


@pytest.mark.cuda
def test_dds_ring_that_cannot_run_raises_on_card(monkeypatch):
    """A pinned ring on a call it cannot take raises in the wrapper (bf16,
    a (32, 1) tile, an operand off 16 bytes) and, past that check, at the C
    entry; the default picks general for those and runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(29)
    pk, data, plan, rp, x, dy = _k4_case(rng, (32, 64), 40, torch.float32)
    m, k = x.shape
    buf = torch.empty(m * k + 1, device="cuda")
    xu = buf[1:].view(m, k)
    xu.copy_(x)
    pk1, data1, _, _, x1, dy1 = _k4_case(rng, (32, 1), 40, torch.float32)
    _close(bm.dds(xu, pk, data), bm.dds_plain(x, pk, data), 1e-5)
    _close(bm.dds_t(dy1, pk1, data1), bm.dds_t_plain(dy1, pk1, data1), 1e-5)
    before = (bm.dds.launches, bm.dds_t.launches, bm.plan_dds_t.launches)
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.dds(xu, pk, data, instance="ring")
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.dds(x.bfloat16(), pk, data.bfloat16(), instance="ring")
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.dds_t(dy1, pk1, data1, instance="ring")
    with pytest.raises(ValueError, match="instance 'ring'"):
        bm.plan_dds_t(dy.bfloat16(), rp.bfloat16(), txp.plan_t_schedule(plan),
                      k=k, tile=(32, 64), instance="ring")
    # past the Python check, the C entry refuses before launching
    monkeypatch.setattr(bm, "dds_takes", lambda *a, **kw: True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.dds(xu, pk, data, instance="ring")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.dds(x.bfloat16(), pk, data.bfloat16(), instance="ring")
    with pytest.raises(RuntimeError, match="CUDA error"):
        bm.dds_t(dy1, pk1, data1, instance="ring")
    assert (bm.dds.launches, bm.dds_t.launches,
            bm.plan_dds_t.launches) == before


# --------------------------------------------------------------------------
# the rest of the engine: threefry keys, the int8 KV quantizer and K1 at the
# chunk prefill's M on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_threefry_keys_and_uniform_bits_on_card_equal_the_cpu():
    """Keys for 4 slots x 64 positions and the random bits and uniform
    draws of gemma3_4b's vocabulary: the integer hash is bitwise the same
    on the card as on the CPU (the CPU's equal JAX's:
    tests/test_torch_sampling.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.models import prng
    from repro_torch.models.sampling import slot_keys
    pos = torch.arange(-1, 255, dtype=torch.int64).reshape(4, 64)
    dev_key, host_key = prng.PRNGKey(1234, device="cuda"), prng.PRNGKey(1234)
    for col in range(64):
        assert torch.equal(slot_keys(dev_key, pos[:, col].cuda()).cpu(),
                           slot_keys(host_key, pos[:, col]))
    keys = slot_keys(dev_key, pos[:, 5].cuda())
    bits = prng.random_bits(keys, (262144,))
    assert torch.equal(bits.cpu(), prng.random_bits(keys.cpu(), (262144,)))
    tiny = float(np.finfo(np.float32).tiny)
    u = prng.uniform(keys, (262144,), tiny)
    uc = prng.uniform(keys.cpu(), (262144,), tiny)
    assert torch.equal(u.cpu().view(torch.int32), uc.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_card_equals_the_cpu(dtype):
    """int8 values and bf16 scales bitwise equal to the CPU's (which equal
    the reference's: tests/test_torch_kv_quant.py): the quantizer divides
    by a tensor, never by a Python scalar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.models.attention import _quantize_kv
    rng = np.random.RandomState(31)
    x = rng.randn(4, 300, 4, 256) * np.exp(rng.uniform(-6, 6, (4, 300, 4, 1)))
    x[0, 7] = 0.0
    xc = torch.from_numpy(x.astype(np.float32)).to(dtype)
    qg, sg = _quantize_kv(xc.cuda())
    qc, sc = _quantize_kv(xc)
    assert torch.equal(qg.cpu(), qc)
    assert torch.equal(sg.cpu().view(torch.int16), sc.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 17, 37, 256])
def test_plan_dds_at_chunk_prefill_m_matches_plain_on_card(m):
    """K1 at the row counts chunked prefill gives it (a tail of any length,
    a bucket of 256), bf16 x and values on a 128x128 pack at density 0.2,
    through the instance ``plan_instance`` picks (printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(37)
    n, k, tile = 1024, 2560, (128, 128)
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // 128, k // 128) < 0.2, np.ones(tile, np.float32))
    pk = pack_bsr(w, tile)
    plan = txp.build_plan(pk)
    data = txp.pack_plan_data(plan, pk.data).cuda().bfloat16()
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().bfloat16()
    inst = bm.plan_instance(m, tile, x.dtype, data.dtype)
    print(f"K1 at M={m}: instance {inst}")
    before = bm.plan_dds.launches
    y = bm.plan_dds(x, data, txp.plan_schedule(plan), n=n, tile=tile)
    assert bm.plan_dds.launches == before + 1 and y.shape == (m, n)
    ref = txp.plan_fused_linear_plain(x, data, plan)
    assert _rel_err(y, ref) <= 2e-2, _rel_err(y, ref)


# --------------------------------------------------------------------------
# the vlm, MoE and MLA families' shapes: K1 at their packed projections,
# K2 / K3 at head_dim 128 with 4 and 16 query heads a KV head
# --------------------------------------------------------------------------

# (model, projection, N, K): pixtral_12b's fused QKV and wo, qwen3_moe's
# (64 query / 4 KV heads of 128), deepseek_v2_lite's MLA wq and wo
_FAMILY_SHAPES = (("pixtral_12b", "wqkv", 6144, 5120),
                  ("pixtral_12b", "wo", 5120, 4096),
                  ("qwen3_moe", "wqkv", 9216, 4096),
                  ("qwen3_moe", "wo", 4096, 8192),
                  ("deepseek_v2_lite", "wq", 3072, 2048),
                  ("deepseek_v2_lite", "wo", 2048, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 1024], ids=["stream_m4", "tc_m1024"])
@pytest.mark.parametrize("model,proj,n,k", _FAMILY_SHAPES)
def test_plan_dds_at_the_family_projection_shapes_on_card(model, proj, n, k,
                                                          m):
    """K1 on a 128x128 pack at density 0.2, bf16 x and values, at a decode
    step's M = 4 slots (the ``stream`` instance) and a prefill's M = 1024
    (``tc``), against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _k1_at_shape(n, k, m)


def _k1_at_shape(n, k, m):
    from repro_torch.kernels import bsr_matmul as bm
    rng = np.random.RandomState(n + k)
    tile = (128, 128)
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // 128, k // 128) < 0.2, np.ones(tile, np.float32))
    pk = pack_bsr(w, tile)
    plan = txp.build_plan(pk)
    data = txp.pack_plan_data(plan, pk.data).cuda().bfloat16()
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().bfloat16()
    inst = bm.plan_instance(m, tile, x.dtype, data.dtype)
    assert inst == ("stream" if m == 4 else "tc")
    before = bm.plan_dds.launches
    y = bm.plan_dds(x, data, txp.plan_schedule(plan), n=n, tile=tile)
    assert bm.plan_dds.launches == before + 1 and y.shape == (m, n)
    ref = txp.plan_fused_linear_plain(x, data, plan)
    assert _rel_err(y, ref) <= 2e-2, _rel_err(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("hkv,g", [(8, 4), (4, 16)],
                         ids=["pixtral_g4", "qwen3_g16"])
def test_decode_kernels_at_head_dim_128_on_card(hkv, g, paged):
    """K2 on a 1280-slot linear bf16 cache and K3 on its 80 pages of 16, at
    B = 4 ragged positions with an inactive slot, D = 128 and G = 4
    (pixtral_12b) or 16 (qwen3_moe, the G * rows > 8192 chunked path for
    long splits), against the plain versions; K3 bit-exact against K2 over
    the gathered view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain,
                                                  paged_flash_decode,
                                                  paged_flash_decode_plain)
    from repro_torch.models.common import paged_view
    rng = np.random.RandomState(128 + g)
    b, t, d, ps = 4, 1280, 128, 16
    dtype = torch.bfloat16
    q, k, v = _decode_inputs(rng, dtype, b, t, hkv * g, hkv, d)
    posl = [1279, -1, 700, 333]
    kvp = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(
        b, 1)
    lim = torch.tensor([max(p, 0) for p in posl], device="cuda")[:, None]
    kvp = torch.where(kvp <= lim, kvp, torch.full_like(kvp, -1))
    kvp[1] = -1
    pos = torch.tensor(posl, dtype=torch.int32, device="cuda")
    if not paged:
        before = flash_decode.launches
        out = flash_decode(q, k, v, kvp, pos)
        assert flash_decode.launches == before + 1
        ref = flash_decode_plain(q, k, v, kvp, pos)
    else:
        npg = t // ps
        perm = torch.from_numpy(rng.permutation(b * npg).astype(
            np.int32)).cuda()
        table = perm.reshape(b, npg).contiguous()
        kp = torch.empty((b * npg, ps, hkv, d), dtype=dtype, device="cuda")
        vp = torch.empty_like(kp)
        kp[table.long()] = k.reshape(b, npg, ps, hkv, d)
        vp[table.long()] = v.reshape(b, npg, ps, hkv, d)
        before = paged_flash_decode.launches
        out = paged_flash_decode(q, kp, vp, table, kvp, pos)
        assert paged_flash_decode.launches == before + 1
        ref = paged_flash_decode_plain(q, kp, vp, table, kvp, pos)
        dense = flash_decode(q, paged_view(kp, table, kvp),
                             paged_view(vp, table, kvp), kvp, pos,
                             kv_split=npg)
        assert torch.equal(out, dense)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= \
        _DECODE_TOL[dtype] * scale
    assert float(out[1].float().abs().max()) == 0.0      # inactive slot


# --------------------------------------------------------------------------
# the hybrid and audio families' shapes: K1 at recurrentgemma_9b's packed
# projections, K2 at its MQA ring and at whisper_base's decoder cache
# --------------------------------------------------------------------------

# recurrentgemma_9b (16 query heads / 1 KV head of 256, d 4096, geglu
# d_ff 12288): the local layers' fused QKV and wo, the FFN's wi and wo
_RECURRENTGEMMA_SHAPES = (("wqkv", 4608, 4096), ("attn_wo", 4096, 4096),
                          ("ffn_wi", 12288, 4096), ("ffn_wo", 4096, 12288))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 1024], ids=["stream_m4", "tc_m1024"])
@pytest.mark.parametrize("proj,n,k", _RECURRENTGEMMA_SHAPES)
def test_plan_dds_at_recurrentgemma_shapes_on_card(proj, n, k, m):
    """K1 on a 128x128 pack at density 0.2, bf16, at a decode step's M = 4
    (``stream``) and a prefill's M = 1024 (``tc``), against its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _k1_at_shape(n, k, m)


def _ring_map(t, pos):
    """Slot j of a T-slot ring after writing 0..pos: the latest position
    congruent to j (-1 where none)."""
    j = np.arange(t)
    src = j + t * ((pos - j) // t)
    return np.where((src >= 0) & (src <= pos), src, -1).astype(np.int32)


# (label, Hkv, G, D, T, window, ring positions; -1 = an inactive slot):
# recurrentgemma_9b's local layers keep a ring of min(cache_len, 2048) =
# 1280 slots (slot 0 wrapped past the ring), whisper_base's decoder a
# linear 448-position cache
_DECODE_FAMILY_CASES = (
    ("recurrentgemma_g16_d256", 1, 16, 256, 1280, 2048,
     [2500, -1, 1279, 333]),
    ("whisper_g1_d64", 8, 1, 64, 448, 0, [447, 100, -1, 5]))


@pytest.mark.cuda
@pytest.mark.parametrize("label,hkv,g,d,t,window,posl", _DECODE_FAMILY_CASES,
                         ids=[c[0] for c in _DECODE_FAMILY_CASES])
def test_flash_decode_at_the_hybrid_and_audio_shapes_on_card(
        label, hkv, g, d, t, window, posl):
    """K2 at B = 4 against its plain version (a wrapped ring, an inactive
    slot that gives zeros), and bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    rng = np.random.RandomState(d + g)
    dtype = torch.bfloat16
    b = len(posl)
    q, k, v = _decode_inputs(rng, dtype, b, t, hkv * g, hkv, d)
    kvp = torch.from_numpy(np.stack([_ring_map(t, p) for p in posl])).cuda()
    pos = torch.tensor(posl, dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    out = flash_decode(q, k, v, kvp, pos, window=window)
    assert flash_decode.launches == before + 1
    ref = flash_decode_plain(q, k, v, kvp, pos, window=window)
    again = flash_decode(q, k, v, kvp, pos, window=window)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= \
        _DECODE_TOL[dtype] * scale
    assert torch.equal(out, again)
    inactive = posl.index(-1)
    assert float(out[inactive].float().abs().max()) == 0.0
