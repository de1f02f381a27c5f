"""The backward kernels' plain versions and the differentiable block-sparse
ops against the JAX reference.

K4 (``dds`` / ``dds_t`` / ``plan_dds_t``) and K5 (``sddmm`` /
``plan_sddmm``) run their plain versions on CPU tensors; they are held here
to the reference's Pallas kernels in interpret mode, as
tests/test_kernels.py and tests/test_pallas_serving.py run them. The CUDA
kernels themselves are held to these plain versions by
tests/test_torch_kernels_cuda.py and by chip_smoke.py on the card.

Tolerances are the reference's own bars in those files: K4 against the
reference within 1e-3 (fp32) and 2e-1 (bf16) of max(1, max|ref|), K5 within
rtol 1e-3 / atol 1e-2 (test_kernels.py); plan-layout forward within 1e-5
and gradients within rtol 2e-5 / atol 1e-4 (test_pallas_serving.py; for the
spilling pattern's large gradients, 1e-6 of the largest, see _grad_atol);
bsr_linear's dX within rtol 1e-3 / atol 1e-2 (test_kernels.py). Padding
gradients are held to exactly zero.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import exec_plan as jxp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import bsr_matmul as tbm  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jbm = importlib.import_module("repro.kernels.bsr_matmul")

# (M, N, K, tile, density, bm) -- tests/test_kernels.py's SHAPES
SHAPES = [
    (32, 128, 128, (32, 64), 0.4, 16),
    (64, 256, 128, (64, 128), 0.25, 32),
    (100, 128, 384, (32, 128), 0.5, 32),     # M not tile-aligned
    (16, 512, 256, (128, 128), 0.1, 16),     # very sparse
    (8, 64, 64, (64, 64), 1.0, 8),           # fully dense pattern
]
DTYPES = {"fp32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_weight(rng, n, k, tile, density):
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    return w * np.kron(mask, np.ones(tile, np.float32))


def _packs(w, tile, dtype, pad=0):
    """The same weight packed by both packages, values in ``dtype``."""
    jpk, tpk = jbm.pack_bsr(w, tile), tbm.pack_bsr(w, tile)
    if pad:
        jpk = jbm.pack_bsr(w, tile, nnzt=jpk.real_nnzt + pad)
        tpk = tbm.pack_bsr(w, tile, nnzt=tpk.real_nnzt + pad)
    jdt, tdt = DTYPES[dtype]
    jpk = jpk.__class__(jpk.data.astype(jdt), jpk.row_id, jpk.col_id,
                        jpk.t_perm, jpk.real_nnzt, jpk.shape, jpk.tile)
    return jpk, tpk, torch.from_numpy(tpk.data).to(tdt)


def _t(a, dtype="fp32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _j(a, dtype="fp32"):
    return jnp.asarray(a, dtype=DTYPES[dtype][0])


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _bar(dtype, ref):
    return (1e-3 if dtype == "fp32" else 2e-1) * max(1.0, np.abs(ref).max())


# --------------------------------------------------------------------------
# K4 / K5 over a flat KernelBSR against the interpret-mode Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,n,k,tile,density,bm", SHAPES)
def test_dds_plain_matches_jax_kernel(m, n, k, tile, density, bm, dtype):
    rng = np.random.RandomState(0)
    w = _sparse_weight(rng, n, k, tile, density)
    x = rng.randn(m, k).astype(np.float32)
    jpk, tpk, data = _packs(w, tile, dtype)
    want = _np(jbm.dds(_j(x, dtype), jpk, bm=bm))
    got = tbm.dds(_t(x, dtype), tpk, data)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), want, atol=_bar(dtype, want))
    before = tbm.dds.launches
    tbm.dds(_t(x, dtype), tpk, data)
    assert tbm.dds.launches == before       # the CPU runs the plain version


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,n,k,tile,density,bm", SHAPES)
def test_dds_t_plain_matches_jax_kernel(m, n, k, tile, density, bm, dtype):
    rng = np.random.RandomState(1)
    w = _sparse_weight(rng, n, k, tile, density)
    dy = rng.randn(m, n).astype(np.float32)
    jpk, tpk, data = _packs(w, tile, dtype)
    want = _np(jbm.dds_t(_j(dy, dtype), jpk, bm=bm))
    got = tbm.dds_t(_t(dy, dtype), tpk, data)
    np.testing.assert_allclose(_np(got), want, atol=_bar(dtype, want))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,n,k,tile,density,bm", SHAPES[:3])
@pytest.mark.parametrize("pad", [0, 3])
def test_sddmm_plain_matches_jax_kernel(m, n, k, tile, density, bm, dtype,
                                        pad):
    rng = np.random.RandomState(2)
    w = _sparse_weight(rng, n, k, tile, density)
    dy = rng.randn(m, n).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    jpk, tpk, data = _packs(w, tile, dtype, pad)
    want = _np(jbm.sddmm(_j(dy, dtype), _j(x, dtype), jpk, bm=bm))
    got = tbm.sddmm(_t(dy, dtype), _t(x, dtype), tpk, data)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "fp32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=1e-2)
    else:
        np.testing.assert_allclose(_np(got), want, atol=_bar(dtype, want))
    # padding tiles are exactly zero (they must stay dead)
    assert np.all(_np(got)[tpk.real_nnzt:] == 0.0)


# --------------------------------------------------------------------------
# K4 / K5 over the plan layout
# --------------------------------------------------------------------------

def _spill_weight(rng):
    """tests/test_pallas_serving.py's skewed pattern: block row 0 owns every
    column tile, rows 1..7 one diagonal tile each -- the plan spills."""
    n, k = 128, 1024
    w = np.zeros((n, k), np.float32)
    w[:16, :] = rng.randn(16, k)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    return w


PLAN_CASES = [("d0.4", 0.4, 0), ("d0.15", 0.15, 0), ("d0.4+5", 0.4, 5),
              ("spill", None, 0)]


def _plan_case(name):
    """(w, tile, m, jax plan, jax values, port plan, port values)."""
    _, density, pad = next(c for c in PLAN_CASES if c[0] == name)
    rng = np.random.RandomState(1)
    if density is None:
        w, tile, m = _spill_weight(rng), (16, 64), 20
    else:
        w, tile, m = _sparse_weight(rng, 96, 128, (16, 32), density), \
            (16, 32), 24
    jpk, tpk, _ = _packs(w, tile, "fp32", pad)
    jpl, tpl = jxp.build_plan(jpk), txp.build_plan(tpk)
    assert tpl.spilled == (density is None)
    return (w, tile, m, jpl, jxp.pack_plan_data(jpl, jpk.data), tpl,
            txp.pack_plan_data(tpl, tpk.data))


@pytest.mark.parametrize("case", [c[0] for c in PLAN_CASES])
def test_plan_dds_t_and_plan_sddmm_plain_match_jax_kernels(case):
    w, tile, m, jpl, jd, tpl, td = _plan_case(case)
    n, k = w.shape
    rng = np.random.RandomState(3)
    dy = rng.randn(m, n).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    # the transposed schedule is the reference's, byte for byte
    for a, b in zip(txp.plan_t_sequence(tpl), jxp.plan_t_sequence(jpl)):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jbm.plan_dds_t(jnp.asarray(dy), jd,
                                     jxp.plan_t_sequence(jpl), k=k,
                                     tile=tile))
    got = tbm.plan_dds_t(_t(dy), td, txp.plan_t_schedule(tpl), k=k,
                         tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
    want = np.asarray(jbm.plan_sddmm(jnp.asarray(dy), jnp.asarray(x),
                                     jxp.plan_kernel_sequence(jpl),
                                     tile=tile, out_dtype=jnp.float32))
    got = tbm.plan_sddmm(_t(dy), _t(x), txp.plan_schedule(tpl), tile=tile)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)


# --------------------------------------------------------------------------
# the two differentiable plan ops (both repairs): padding slots exactly zero
# --------------------------------------------------------------------------

def _grad_atol(want):
    """The reference's 1e-4, or 1e-6 of the largest gradient where that is
    more: the spilling case sums K=1024 products of a row of magnitude ~500
    in another order, which leaves ~2e-4 on entries that cancel to ~1."""
    return max(1e-4, 1e-6 * float(np.abs(want).max()))


def _jax_plan_grads(x, jd, jpl):
    return jax.grad(lambda x_, d_: jnp.sum(jxp.plan_linear(x_, d_, jpl) ** 2),
                    argnums=(0, 1))(jnp.asarray(x), jd)


@pytest.mark.parametrize("op", ["plan_linear", "plan_linear_pallas"])
@pytest.mark.parametrize("case", [c[0] for c in PLAN_CASES])
def test_plan_grads_match_jax_with_dead_padding_slots(case, op):
    """Both plan ops have the reference's custom backward: the real slots'
    gradients match JAX plan_linear's jax.grad and every padding slot gets
    exactly 0 (before the repair, plain autograd gave padding slots
    gradient; the CUDA path had no gradient at all)."""
    w, tile, m, jpl, jd, tpl, td = _plan_case(case)
    x = np.random.RandomState(4).randn(m, w.shape[1]).astype(np.float32)
    gx_j, gd_j = (np.asarray(g) for g in _jax_plan_grads(x, jd, jpl))
    xt = _t(x).requires_grad_(True)
    dt = td.clone().requires_grad_(True)
    y = getattr(txp, op)(xt, dt, tpl)
    (y ** 2).sum().backward()
    for got, want in ((xt.grad, gx_j), (dt.grad, gd_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=_grad_atol(want))
    dead = ~np.asarray(tpl.slot_mask)
    assert dead.any()
    assert np.all(dt.grad.numpy()[dead] == 0.0)


def test_plan_linear_pallas_grads_through_the_batched_dispatch():
    """plan_dispatch('plan_pallas') differentiates through leading dims, in
    x and in the values, as the 'plan' backend does."""
    w, tile, m, jpl, jd, tpl, td = _plan_case("d0.4+5")
    x = np.random.RandomState(5).randn(2, 3, w.shape[1]).astype(np.float32)
    grads = {}
    for backend in ("plan", "plan_pallas"):
        xt = _t(x).requires_grad_(True)
        dt = td.clone().requires_grad_(True)
        tops.plan_dispatch(xt, dt, tpl, backend).square().sum().backward()
        grads[backend] = (xt.grad, dt.grad)
    for a, b in zip(grads["plan"], grads["plan_pallas"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-4)


# --------------------------------------------------------------------------
# bsr_linear: forward and grads for each backend against JAX bsr_linear
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "rowpack", "gather", "ref"])
def test_bsr_linear_matches_jax_with_dead_padding_tiles(backend):
    rng = np.random.RandomState(4)
    n, k, m, tile = 128, 256, 32, (64, 128)
    w = _sparse_weight(rng, n, k, tile, 0.5)
    x = rng.randn(m, k).astype(np.float32)
    jpk, tpk, data = _packs(w, tile, "fp32", pad=2)

    def jloss(x_, d_):
        return jnp.sum(jops.bsr_linear(x_, d_, jpk, backend) ** 2)

    y_j = np.asarray(jops.bsr_linear(jnp.asarray(x), jpk.data, jpk, backend))
    gx_j, gd_j = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jpk.data))
    xt = _t(x).requires_grad_(True)
    dt = data.clone().requires_grad_(True)
    y = tops.bsr_linear(xt, dt, tpk, backend)
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=1e-3)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=1e-3, atol=1e-2)
    real = tpk.pad_mask()
    np.testing.assert_allclose(dt.grad.numpy()[real], gd_j[real], rtol=1e-3,
                               atol=1e-2)
    assert np.all(dt.grad.numpy()[~real] == 0.0)


def test_bsr_matmul_defaults_and_linear_pack_route():
    """The CPU default is 'rowpack'; a KernelBSR pack through
    models.common.linear is the same differentiable product, and a pack
    kind it does not know raises."""
    from repro_torch.models.common import linear
    rng = np.random.RandomState(7)
    w = _sparse_weight(rng, 64, 128, (32, 64), 0.5)
    tpk = tbm.pack_bsr(w, (32, 64))
    x = _t(rng.randn(2, 5, 128))
    assert tops.default_backend(x) == "rowpack"
    y = linear({"w": torch.from_numpy(tpk.data)}, x, tpk)
    np.testing.assert_allclose(y.numpy(), x.numpy() @ w.T, atol=1e-4)
    for backend in ("pallas", "gather", "ref"):
        yb = tops.bsr_matmul(x, tpk, backend)
        np.testing.assert_allclose(yb.numpy(), y.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        tops.bsr_linear(x[0], torch.from_numpy(tpk.data), tpk, "dense")
    with pytest.raises(NotImplementedError):
        tbm.dds(x[0].to("meta"), tpk, torch.from_numpy(tpk.data).to("meta"))

    class ShardedPlan:   # a reference pack kind the port does not serve
        pass
    with pytest.raises(TypeError, match="unknown pack kind ShardedPlan"):
        linear({"w": None}, x, ShardedPlan())
