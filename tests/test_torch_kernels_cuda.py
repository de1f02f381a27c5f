"""Kernels K1 (``csrc/plan_dds.cu``), K2 and K3 (``csrc/flash_decode.cu``)
on the card against their plain versions.

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
