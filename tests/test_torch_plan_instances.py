"""The instances of kernels K1 (``plan_dds``) and K6 (``plan_dds_q``) on the
CPU: the pinned table by which the wrapper picks one
(``bsr_matmul.plan_instance``) and the dynamic shared memory it asks for,
and a test-local oracle of each instance's order of summation -- the
``stream`` lane split and xor-shuffle tree, the ``fp32`` k-step order and
the ``tc`` 16-deep k-steps, each with the per-tile scale fold -- against the
plain versions and the reference's Pallas kernels in interpret mode, on the
same numpy-seeded inputs at small widths. The kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``)."""
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import exec_plan as jxp  # noqa: E402
from repro_torch.kernels import bsr_matmul as tbm  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402

jbm = importlib.import_module("repro.kernels.bsr_matmul")

F32, BF16 = torch.float32, torch.bfloat16
I8, FP8 = torch.int8, torch.float8_e4m3fn
# the kernel phase's tolerances (chip_smoke.py): fp32 outputs within 1e-5 of
# max|ref| (sums in another order), bf16 outputs within one bf16 rounding
# step of the output with margin
TOL = {F32: 1e-5, BF16: 2e-2}


# --------------------------------------------------------------------------
# the pinned choice
# --------------------------------------------------------------------------

# (M, tile, x dtype, value dtype, aligned) -> instance. The vector instances
# need bk % 16 == 0 and bn % 8 == 0 and 16-byte aligned operands; 'stream'
# takes M <= 16 and bk <= 128; 'tc' takes bf16 x with 2- or 1-byte values.
PINNED = [
    # the M boundaries, gemma3_4b's and BERT-base's 128x128 tiles
    (1, (128, 128), BF16, BF16, True, "stream"),
    (4, (128, 128), BF16, BF16, True, "stream"),
    (16, (128, 128), BF16, BF16, True, "stream"),
    (17, (128, 128), BF16, BF16, True, "tc"),
    (64, (128, 128), BF16, BF16, True, "tc"),
    (1024, (128, 128), BF16, BF16, True, "tc"),
    (4, (128, 128), F32, F32, True, "stream"),
    (16, (128, 128), F32, F32, True, "stream"),
    (17, (128, 128), F32, F32, True, "fp32"),
    (384, (128, 128), F32, F32, True, "fp32"),
    (3072, (128, 128), F32, F32, True, "fp32"),
    # every dtype pair above the stream boundary
    (384, (128, 128), F32, BF16, True, "fp32"),
    (384, (128, 128), BF16, F32, True, "fp32"),
    (384, (128, 128), F32, I8, True, "fp32"),
    (384, (128, 128), F32, FP8, True, "fp32"),
    (384, (128, 128), BF16, I8, True, "tc"),
    (384, (128, 128), BF16, FP8, True, "tc"),
    # and below it
    (4, (128, 128), F32, BF16, True, "stream"),
    (4, (128, 128), BF16, F32, True, "stream"),
    (4, (128, 128), F32, I8, True, "stream"),
    (4, (128, 128), BF16, I8, True, "stream"),
    (4, (128, 128), BF16, FP8, True, "stream"),
    # tile classes: small vector tiles, a depth past the stream instance's
    # 32 lanes of 4 values, and tiles only the general instance takes
    (4, (16, 32), F32, F32, True, "stream"),
    (24, (16, 32), F32, F32, True, "fp32"),
    (4, (8, 16), BF16, BF16, True, "stream"),
    (4, (16, 64), BF16, I8, True, "stream"),
    (4, (128, 256), BF16, BF16, True, "tc"),
    (4, (128, 256), F32, F32, True, "fp32"),
    (4, (32, 1), F32, F32, True, "general"),
    (384, (32, 1), BF16, BF16, True, "general"),
    (4, (1, 32), BF16, BF16, True, "general"),
    (384, (16, 4), F32, I8, True, "general"),
    (4, (12, 16), F32, F32, True, "general"),
    (384, (16, 24), BF16, BF16, True, "general"),
    # an operand off a 16-byte boundary
    (4, (128, 128), BF16, BF16, False, "general"),
    (384, (128, 128), F32, F32, False, "general"),
]


@pytest.mark.parametrize("m,tile,x_dtype,v_dtype,aligned,want", PINNED)
def test_plan_instance_pinned_table(m, tile, x_dtype, v_dtype, aligned,
                                    want):
    assert tbm.plan_instance(m, tile, x_dtype, v_dtype, aligned) == want
    assert tbm.instance_takes(want, m, tile, x_dtype, v_dtype, aligned)
    # 'general' takes everything; the instance picked is the first of the
    # preference order that takes the call
    assert tbm.instance_takes("general", m, tile, x_dtype, v_dtype, aligned)
    order = tbm.PLAN_INSTANCES
    assert not any(tbm.instance_takes(i, m, tile, x_dtype, v_dtype, aligned)
                   for i in order[:order.index(want)])


@pytest.mark.parametrize("instance,x_dtype,v_dtype,want", [
    ("stream", BF16, BF16, 0), ("general", F32, F32, 0),
    ("fp32", F32, F32, 40960), ("fp32", F32, BF16, 32768),
    ("fp32", BF16, F32, 32768), ("fp32", BF16, BF16, 24576),
    ("fp32", F32, I8, 32768), ("fp32", BF16, FP8, 24576),
    ("tc", BF16, BF16, 61440), ("tc", BF16, I8, 49152),
    ("tc", BF16, FP8, 49152)])
def test_plan_smem_bytes_pinned(instance, x_dtype, v_dtype, want):
    """The fp32 ring: 4 stages of 64 rows of x and 64 of values, 16 deep;
    the tc ring: 6 stages, 32 deep; rows padded to a 16-byte multiple. Only
    the tc ring of bf16 values passes the 48 KB default."""
    assert tbm.plan_smem_bytes(instance, x_dtype, v_dtype) == want


def test_unknown_instance_raises():
    with pytest.raises(ValueError, match="unknown instance"):
        tbm.instance_takes("wgmma", 4, (128, 128), BF16, BF16)


def test_forced_instance_is_checked_before_any_device_work():
    """A pinned instance that cannot take the call raises in Python; the
    CPU route of plan_dds_q still runs the plain version."""
    x = torch.zeros((17, 128))
    with pytest.raises(ValueError, match="instance 'stream'"):
        tbm._pick_instance("plan_dds", "stream", 17, (128, 128), x,
                           torch.zeros((1, 1, 128, 128)))
    with pytest.raises(ValueError, match="instance 'tc'"):
        tbm._pick_instance("plan_dds", "tc", 64, (128, 128), x,
                           torch.zeros((1, 1, 128, 128)))
    assert tbm._pick_instance("plan_dds", None, 4, (32, 1), x,
                              torch.zeros((1, 1, 32, 1))) == "general"


# --------------------------------------------------------------------------
# test-local oracles of the instances' order of summation
# --------------------------------------------------------------------------

def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64 and the sum is
    rounded once more (to fp64, then fp32: off from a true fma only at a
    double-rounding tie)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _scale(scales, t, p_max, gran):
    return np.float32(scales.reshape(-1)[t // p_max if gran == "row" else t])


def oracle_stream(x, w, sched, tile, scales=None, gran="block"):
    """The stream instance: lane c of a row's g lanes sums values
    4c .. 4c + 3 of every tile row over the run in schedule order (a tile's
    partial scaled into the lane's sum, for quantized values); then the xor
    tree adds the lanes, every step a + a[lane ^ off]. x (M, K) and w
    (tiles, bn, bk) hold the values as fp32. Returns (M, N) fp32 before the
    epilogue."""
    m, _ = x.shape
    bn, bk = tile
    ch = bk // 4
    rw = 1
    while rw * 2 * ch <= 32:
        rw *= 2
    g = 32 // rw
    y = np.zeros((m, sched.n_brows * bn), np.float32)
    for r in range(sched.n_brows):
        acc = np.zeros((g, m, bn), np.float32)
        for j in range(sched.seg[r], sched.seg[r + 1]):
            t, col = int(sched.tile_seq[j]), int(sched.col_seq[j])
            xv = x[:, col * bk:(col + 1) * bk].reshape(m, ch, 4)
            xv = xv.transpose(1, 0, 2)[:, :, None, :]          # (ch, M, 1, 4)
            wv = w[t].reshape(bn, ch, 4).transpose(1, 0, 2)[:, None]
            if scales is None:
                lanes = acc[:ch]
                for v in range(4):
                    lanes = _fma(xv[..., v], wv[..., v], lanes)
                acc[:ch] = lanes
            else:
                part = np.zeros((ch, m, bn), np.float32)
                for v in range(4):
                    part = _fma(xv[..., v], wv[..., v], part)
                acc[:ch] = _fma(_scale(scales, t, sched.p_max, gran), part,
                                acc[:ch])
        off = g // 2
        while off:
            acc = (acc + acc[np.arange(g) ^ off]).astype(np.float32)
            off //= 2
        y[:, r * bn:(r + 1) * bn] = acc[0]
    return y


def oracle_ksteps(x, w, sched, tile, kstep, scales=None, gran="block"):
    """The fp32 (kstep 1: one fma a value) and tc (kstep 16: one m16n8k16
    step adds its 16 products to the fragment) instances: each output sums
    the run's tiles in schedule order, k ascending in steps of ``kstep``;
    quantized tiles in their own partial, folded in as acc += s * partial.
    Returns (M, N) fp32 before the epilogue."""
    m, _ = x.shape
    bn, bk = tile
    y = np.zeros((m, sched.n_brows * bn), np.float32)
    for r in range(sched.n_brows):
        acc = np.zeros((m, bn), np.float32)
        for j in range(sched.seg[r], sched.seg[r + 1]):
            t, col = int(sched.tile_seq[j]), int(sched.col_seq[j])
            part = np.zeros((m, bn), np.float32)
            for k0 in range(0, bk, kstep):
                xs = x[:, col * bk + k0:col * bk + k0 + kstep]
                step = xs.astype(np.float64) @ w[t][:, k0:k0 + kstep].astype(
                    np.float64).T
                if scales is None:
                    acc = (acc.astype(np.float64) + step).astype(np.float32)
                else:
                    part = (part.astype(np.float64) + step).astype(np.float32)
            if scales is not None:
                acc = _fma(_scale(scales, t, sched.p_max, gran), part, acc)
        y[:, r * bn:(r + 1) * bn] = acc
    return y


def _epilogue(y, bias, act, dtype):
    y = torch.from_numpy(y)
    if bias is not None:
        y = y + torch.from_numpy(bias)
    return tbm.act_epilogue(y, act).to(dtype)


# --------------------------------------------------------------------------
# the cases: a spilling plan, fused QKV, an all-zero block row
# --------------------------------------------------------------------------

def _spill_weight():
    rng = np.random.RandomState(3)
    w = np.zeros((128, 1024), np.float32)
    w[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    return w, (16, 64)


def _sparse(rng, n, k, tile, density):
    w = rng.randn(n, k).astype(np.float32)
    return w * np.kron(rng.rand(n // tile[0], k // tile[1]) < density,
                       np.ones(tile, np.float32))


def _qkv_weight():
    rng = np.random.RandomState(4)
    tile = (16, 16)
    return np.concatenate([_sparse(rng, 48, 64, tile, 0.5)
                           for _ in range(3)]), tile


def _zero_row_weight():
    rng = np.random.RandomState(5)
    tile = (16, 32)
    w = _sparse(rng, 64, 128, tile, 0.6)
    w[:16] = 0.0                         # block row 0: one stored zero tile
    return w, tile


CASES = {"spill": _spill_weight, "fused qkv": _qkv_weight,
         "zero row": _zero_row_weight}


@functools.lru_cache(maxsize=None)
def _case(name, values):
    """(port plan, port schedule, JAX plan, JAX values, port values,
    quantized values and scales or None, granularity) of a case. ``values``
    is 'fp32', 'bf16', or '<int8|fp8>-<block|row>'."""
    w, tile = CASES[name]()
    jpk, tpk = jbm.pack_bsr(w, tile), tbm.pack_bsr(w, tile)
    jplan, tplan = jxp.plan_for_pack(jpk), txp.plan_for_pack(tpk)
    jd = jxp.pack_plan_data(jplan, jpk.data)
    td = txp.pack_plan_data(tplan, tpk.data)
    if name == "spill":
        assert tplan.spilled
    if name == "fused qkv":
        assert tplan.shape == (144, 64)
    quant = gran = None
    if "-" in values:
        qdtype, gran = values.split("-")
        jq, js = jxp.quantize_plan_values(jd, qdtype, gran)
        tq, ts = txp.quantize_plan_values(td, qdtype, gran)
        quant = (jq, js, tq, ts)
    return tplan, txp.plan_schedule(tplan), jplan, jd, td, quant, gran


def _inputs(tplan, m, x_dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, tplan.shape[1]).astype(np.float32)
    b = rng.randn(tplan.shape[0]).astype(np.float32)
    x = torch.from_numpy(x).to(x_dtype)
    return x, b


def _references(name, values, x, b, act):
    """The plain version's and the reference's interpret-mode outputs."""
    tplan, sched, jplan, jd, td, quant, gran = _case(name, values)
    n, k = tplan.shape
    tile = tplan.tile
    jx = jnp.asarray(x.float().numpy())
    if x.dtype == BF16:
        jx = jx.astype(jnp.bfloat16)
    if quant is None:
        tdv = td.to(BF16) if values == "bf16" else td
        plain = txp.plan_fused_linear_plain(x, tdv, tplan,
                                            bias=torch.from_numpy(b), act=act)
        jdv = jd.astype(jnp.bfloat16) if values == "bf16" else jd
        ref = jbm.plan_dds(jx, jdv, jxp.plan_kernel_sequence(jplan), n=n,
                           tile=tile, bias=jnp.asarray(b), act=act,
                           interpret=True)
    else:
        jq, js, tq, ts = quant
        plain = tbm.plan_dds_q(x, tq, ts, sched, n=n, tile=tile,
                               granularity=gran, bias=torch.from_numpy(b),
                               act=act)
        ref = jbm.plan_dds_q(jx, jq, js, jxp.plan_kernel_sequence(jplan),
                             n=n, tile=tile, granularity=gran,
                             bias=jnp.asarray(b), act=act, interpret=True)
    return plain, torch.from_numpy(np.array(ref, np.float32))


def _oracle(instance, name, values, x):
    tplan, sched, _, _, td, quant, gran = _case(name, values)
    tile = tplan.tile
    xs = x.float().numpy()
    if quant is None:
        w = td.to(BF16) if values == "bf16" else td
        w, scales = w.float().reshape(-1, *tile).numpy(), None
    else:
        _, _, tq, ts = quant
        w, scales = tq.float().reshape(-1, *tile).numpy(), ts.numpy()
    if instance == "stream":
        return oracle_stream(xs, w, sched, tile, scales, gran)
    return oracle_ksteps(xs, w, sched, tile, 16 if instance == "tc" else 1,
                         scales, gran)


def _close(got, want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * scale, (err, TOL[dtype] * scale)


@pytest.mark.parametrize("values", ["fp32", "int8-block", "fp8-row"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("instance,m,x_dtype", [
    ("stream", 4, F32), ("stream", 16, F32), ("fp32", 20, F32)])
def test_instance_order_matches_plain_and_jax_fp32(instance, m, x_dtype,
                                                   case, values):
    tplan = _case(case, values)[0]
    x, b = _inputs(tplan, m, x_dtype, seed=m)
    tile = tplan.tile
    v_dtype = {"fp32": F32, "int8": I8, "fp8": FP8}[values.split("-")[0]]
    assert tbm.instance_takes(instance, m, tile, x_dtype, v_dtype)
    got = _epilogue(_oracle(instance, case, values, x), b, "gelu", x_dtype)
    plain, ref = _references(case, values, x, b, "gelu")
    _close(got, plain, x_dtype)
    _close(got, ref, x_dtype)
    if case == "zero row":
        # block row 0 holds only zeros: the product there is exactly zero
        pre = _oracle(instance, case, values, x)
        assert float(np.abs(pre[:, :tile[0]]).max()) == 0.0


@pytest.mark.parametrize("values", ["bf16", "int8-block", "fp8-row"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tc_order_matches_plain_and_jax_bf16(case, values):
    tplan = _case(case, values)[0]
    x, b = _inputs(tplan, 40, BF16, seed=40)
    v_dtype = {"bf16": BF16, "int8": I8, "fp8": FP8}[values.split("-")[0]]
    assert tbm.plan_instance(40, tplan.tile, BF16, v_dtype) == "tc"
    got = _epilogue(_oracle("tc", case, values, x), b, "silu", BF16)
    plain, ref = _references(case, values, x, b, "silu")
    _close(got, plain, BF16)
    _close(got, ref, BF16)


def test_stream_oracle_adds_lanes_by_the_xor_tree():
    """One tile of an 8 x 16 block: 4 lanes of 4 values a row, so the tree
    is (l0 + l2) + (l1 + l3). Lane sums 1e8, 1, -1e8, 1 give exactly 2 that
    way; summed in k order (the fp32 instance) they give 1, since
    1e8 + 1 rounds to 1e8 in fp32."""
    sched = type("S", (), dict(n_brows=1, p_max=1, seg=np.array([0, 1]),
                               tile_seq=np.array([0]),
                               col_seq=np.array([0])))()
    x = np.zeros((1, 16), np.float32)
    x[0, [0, 4, 8, 12]] = [1e8, 1.0, -1e8, 1.0]
    w = np.ones((1, 8, 16), np.float32)
    assert np.all(oracle_stream(x, w, sched, (8, 16)) == 2.0)
    assert np.all(oracle_ksteps(x, w, sched, (8, 16), 1) == 1.0)
