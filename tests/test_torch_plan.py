"""The port's plan execution against the JAX reference: ``plan_linear``
(backend 'plan') and ``plan_linear_pallas`` (backend 'plan_pallas', whose
kernel K1 runs its plain version on the CPU) against JAX ``plan_linear`` and
the Pallas ``plan_linear_pallas`` in interpret mode, as
tests/test_pallas_serving.py runs it. The CUDA kernel itself is held to its
plain version by tests/test_torch_kernels_cuda.py and by chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import exec_plan as jxp  # noqa: E402
from repro.kernels.bsr_matmul import pack_bsr as j_pack  # noqa: E402

from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.bsr_matmul import pack_bsr, plan_dds  # noqa: E402


def _sparse_weight(rng, n, k, tile, density):
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    return w * np.kron(mask, np.ones(tile, np.float32))


def _both(w, tile, pad_tiles=0):
    """The same weight packed by both packages: (jax plan, jax values,
    port plan, port values)."""
    jpk, tpk = j_pack(w, tile), pack_bsr(w, tile)
    if pad_tiles:
        jpk = j_pack(w, tile, nnzt=jpk.real_nnzt + pad_tiles)
        tpk = pack_bsr(w, tile, nnzt=tpk.real_nnzt + pad_tiles)
    jpl, tpl = jxp.build_plan(jpk), txp.build_plan(tpk)
    return (jpl, jxp.pack_plan_data(jpl, jpk.data),
            tpl, txp.pack_plan_data(tpl, tpk.data))


def _check_all(x, jpl, jd, tpl, td, atol, rtol=0.0):
    """Port plan / plan_pallas against JAX plan / interpret-mode Pallas."""
    y_j = np.asarray(jxp.plan_linear(jnp.asarray(x), jd, jpl))
    y_jp = np.asarray(jxp.plan_linear_pallas(jnp.asarray(x), jd, jpl))
    xt = torch.from_numpy(x)
    y_t = txp.plan_linear(xt, td, tpl).numpy()
    y_tp = txp.plan_linear_pallas(xt, td, tpl).numpy()
    for got, want, what in ((y_tp, y_jp, "pallas vs jax pallas"),
                            (y_tp, y_j, "pallas vs jax plan"),
                            (y_t, y_j, "plan vs jax plan"),
                            (y_tp, y_t, "pallas vs plan")):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=what)


# Tolerances: the reference's own plan-vs-pallas bars
# (tests/test_pallas_serving.py) -- fp32 sums in another order.

@pytest.mark.parametrize("density,pad_tiles", [(0.4, 0), (0.15, 0), (0.4, 5)])
def test_plan_linear_pallas_matches_jax(density, pad_tiles):
    rng = np.random.RandomState(1)
    n, k, m, tile = 96, 128, 24, (16, 32)
    w = _sparse_weight(rng, n, k, tile, density)
    x = rng.randn(m, k).astype(np.float32)
    _check_all(x, *_both(w, tile, pad_tiles), atol=1e-5)


def test_plan_linear_pallas_spill_edge_rows_match_jax():
    rng = np.random.RandomState(2)
    n, k, tile = 128, 1024, (16, 64)
    w = np.zeros((n, k), np.float32)
    w[:16, :] = rng.randn(16, k)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    jpl, jd, tpl, td = _both(w, tile)
    assert tpl.spilled
    x = rng.randn(20, k).astype(np.float32)
    _check_all(x, jpl, jd, tpl, td, atol=1e-4, rtol=1e-5)


def test_plan_matmul_pallas_fused_qkv_matches_jax():
    rng = np.random.RandomState(3)
    k, tile = 64, (16, 16)
    w = np.concatenate([_sparse_weight(rng, 48, k, tile, 0.5)
                        for _ in range(3)])
    jpl, jd, tpl, td = _both(w, tile)
    x = rng.randn(2, 5, k).astype(np.float32)
    y_j = np.asarray(jxp.plan_matmul_pallas(jnp.asarray(x), jd, jpl))
    y_t = txp.plan_matmul_pallas(torch.from_numpy(x), td, tpl)
    assert tuple(y_t.shape) == (2, 5, 144)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-5)
    np.testing.assert_allclose(
        txp.plan_matmul(torch.from_numpy(x), td, tpl).numpy(),
        np.asarray(jxp.plan_matmul(jnp.asarray(x), jd, jpl)), atol=1e-5)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
def test_plan_fused_linear_epilogue_matches_jax(act):
    rng = np.random.RandomState(4)
    n, k, m, tile = 64, 96, 16, (16, 16)
    w = _sparse_weight(rng, n, k, tile, 0.5)
    jpl, jd, tpl, td = _both(w, tile)
    x = rng.randn(m, k).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    y_j = np.asarray(jxp.plan_fused_linear(jnp.asarray(x), jd, jpl,
                                           bias=jnp.asarray(b), act=act))
    y_t = txp.plan_fused_linear(torch.from_numpy(x), td, tpl,
                                bias=torch.from_numpy(b), act=act).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, err_msg=str(act))


@pytest.mark.parametrize("tile,density", [((32, 1), 0.3), ((128, 128), 0.5)])
def test_paper_and_main_path_tiles_match_jax_plan(tile, density):
    """The paper's 32x1 block and the main path's 128x128 tile through the
    plain version (the interpret-mode Pallas oracle is too slow here; JAX
    plan_linear is its reference)."""
    rng = np.random.RandomState(5)
    n, k = (64, 64) if tile == (32, 1) else (256, 384)
    w = _sparse_weight(rng, n, k, tile, density)
    jpl, jd, tpl, td = _both(w, tile)
    x = (0.1 * rng.randn(40, k)).astype(np.float32)
    y_j = np.asarray(jxp.plan_linear(jnp.asarray(x), jd, jpl))
    y_tp = txp.plan_linear_pallas(torch.from_numpy(x), td, tpl).numpy()
    np.testing.assert_allclose(y_tp, y_j, atol=1e-5)


def test_bf16_values_accumulate_in_fp32():
    """ServingSpec.dtype='bfloat16' casts only the packs: fp32 activations
    against bf16 values, accumulated in fp32, written fp32."""
    rng = np.random.RandomState(6)
    n, k, tile = 64, 64, (16, 16)
    w = _sparse_weight(rng, n, k, tile, 0.5)
    _, _, tpl, td = _both(w, tile)
    td16 = td.to(torch.bfloat16)
    x = torch.from_numpy(rng.randn(8, k).astype(np.float32))
    y = txp.plan_linear_pallas(x, td16, tpl)
    assert y.dtype == torch.float32
    ref = x.double() @ torch.from_numpy(w).to(torch.bfloat16).double().t()
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-4)
    yb = txp.plan_linear_pallas(x.bfloat16(), td16, tpl)
    assert yb.dtype == torch.bfloat16


def test_dispatch_defaults_and_no_fallback():
    """CPU tensors default to 'plan'; the kernel wrapper runs its plain
    version on the CPU without counting a launch, and a tensor on any other
    device raises instead of falling back."""
    rng = np.random.RandomState(7)
    w = _sparse_weight(rng, 64, 64, (16, 16), 0.5)
    _, _, tpl, td = _both(w, (16, 16))
    x = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    assert ops.default_plan_backend(x) == "plan"
    before = plan_dds.launches
    y1 = ops.plan_dispatch(x, td, tpl, backend="plan_pallas")
    y2 = ops.plan_dispatch(x, td, tpl)
    assert plan_dds.launches == before
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        ops.plan_dispatch(x, td, tpl, backend="bsr")
    with pytest.raises(NotImplementedError):
        plan_dds(x.to("meta"), td.to("meta"), txp.plan_schedule(tpl),
                 n=64, tile=(16, 16))


@pytest.mark.parametrize("k", [48, 80])
def test_x_of_another_width_than_the_plan_raises(k):
    """An x whose K is not the plan's raises on every path: the kernel
    would otherwise read past each row of x (or stop short of it)."""
    rng = np.random.RandomState(8)
    w = _sparse_weight(rng, 64, 64, (16, 16), 0.5)
    _, _, tpl, td = _both(w, (16, 16))
    x = torch.from_numpy(rng.randn(4, k).astype(np.float32))
    with pytest.raises(ValueError):
        txp.plan_fused_linear(x, td, tpl)
    with pytest.raises(ValueError):
        ops.plan_dispatch(x, td, tpl, backend="plan_pallas")
    # the kernel wrapper checks K before it looks for a card
    with pytest.raises(ValueError):
        plan_dds(x.to("meta"), td.to("meta"), txp.plan_schedule(tpl),
                 n=64, tile=(16, 16))


def test_plan_fused_linear_raises_on_inputs_that_require_grad():
    """The fused-epilogue entry has no backward (as in the reference): on
    the CPU (its plain route) an input that requires grad raises instead of
    silently cutting the graph; under no_grad it serves. The differentiable
    entry is plan_linear_pallas."""
    rng = np.random.RandomState(9)
    w = _sparse_weight(rng, 64, 96, (16, 16), 0.5)
    _, _, tpl, td = _both(w, (16, 16))
    x = torch.from_numpy(rng.randn(8, 96).astype(np.float32))
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    with pytest.raises(RuntimeError, match="forward-only"):
        txp.plan_fused_linear(x.clone().requires_grad_(True), td, tpl,
                              act="gelu")
    with pytest.raises(RuntimeError, match="forward-only"):
        txp.plan_fused_linear(x, td.clone().requires_grad_(True), tpl)
    with pytest.raises(RuntimeError, match="forward-only"):
        txp.plan_fused_linear(x, td, tpl, bias=b.clone().requires_grad_(True))
    with torch.no_grad():
        y = txp.plan_fused_linear(x.clone().requires_grad_(True), td, tpl,
                                  bias=b, act="gelu")
    np.testing.assert_allclose(
        y.numpy(), txp.plan_fused_linear_plain(x, td, tpl, bias=b,
                                               act="gelu").numpy())
    xg = x.clone().requires_grad_(True)
    txp.plan_linear_pallas(xg, td, tpl).sum().backward()
    assert xg.grad is not None
