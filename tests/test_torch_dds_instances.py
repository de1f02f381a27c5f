"""The instances of kernel K4 (``dds`` / ``dds_t`` / ``plan_dds_t``) on the
CPU: the pinned tables by which the wrapper picks one
(``bsr_matmul.dds_instance``, ``dds_block_rows``), and a test-local oracle
of the order of summation both instances keep -- each output one fmaf chain
over its output block's run of tiles in sequence order, k ascending inside
each tile, exact zeros for an empty run -- against the plain versions and
the reference's Pallas kernels in interpret mode, on the same numpy-seeded
inputs at small widths. The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``: ring bitwise equal to general)."""
import importlib
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import exec_plan as jxp  # noqa: E402
from repro_torch.kernels import bsr_matmul as tbm  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402

jbm = importlib.import_module("repro.kernels.bsr_matmul")

F32, BF16 = torch.float32, torch.bfloat16
# the kernel phase's tolerances (chip_smoke.py): fp32 outputs within 1e-5 of
# max|ref| (sums in another order), bf16 outputs within one bf16 rounding
# step of the output with margin
TOL = {F32: 1e-5, BF16: 2e-2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the pinned choices
# --------------------------------------------------------------------------

# (M, stored tile, dtype, transposed, aligned) -> K4 instance: the ring
# takes fp32 X and values, 16-byte aligned, with a depth iw (bk as stored,
# bn transposed) that is a multiple of 16 and an output width ow (bn as
# stored, bk transposed) that is a multiple of 4
DDS_PINNED = [
    (3072, (128, 128), F32, True, True, "ring"),    # the packed training step
    (3072, (128, 128), F32, False, True, "ring"),
    (256, (128, 128), F32, False, True, "ring"),    # the autotuner's dds
    (384, (128, 128), F32, True, True, "ring"),
    (1, (128, 128), F32, False, True, "ring"),
    (1, (64, 64), F32, True, True, "ring"),
    (17, (64, 64), F32, False, True, "ring"),
    (17, (16, 64), F32, False, True, "ring"),       # ow 16, iw 64
    (20, (16, 64), F32, True, True, "ring"),        # the spilling plan's tile
    (24, (16, 8), F32, True, True, "ring"),         # iw 16, ow 8
    (24, (16, 8), F32, False, True, "general"),     # iw 8
    (24, (8, 16), F32, False, True, "ring"),        # ow 8, iw 16
    (24, (8, 16), F32, True, True, "general"),      # iw 8
    (24, (16, 6), F32, True, True, "general"),      # ow 6
    (40, (32, 1), F32, False, True, "general"),     # the paper's 32 x 1 tile
    (40, (32, 1), F32, True, True, "general"),
    (3072, (32, 1), F32, True, True, "general"),
    (40, (1, 32), F32, False, True, "general"),
    (40, (1, 32), F32, True, True, "general"),
    (3072, (128, 128), BF16, True, True, "general"),
    (384, (64, 64), BF16, False, True, "general"),
    (17, (16, 64), BF16, True, True, "general"),
    (3072, (128, 128), F32, True, False, "general"),  # an operand off 16 B
    (17, (16, 64), F32, False, False, "general"),
]


@pytest.mark.parametrize("m,tile,dtype,transposed,aligned,want", DDS_PINNED)
def test_dds_instance_pinned_table(m, tile, dtype, transposed, aligned, want):
    assert tbm.dds_instance(m, tile, dtype, transposed, aligned) == want
    assert tbm.dds_takes(want, m, tile, dtype, transposed, aligned)
    assert tbm.dds_takes("general", m, tile, dtype, transposed, aligned)
    order = tbm.DDS_INSTANCES
    assert not any(tbm.dds_takes(i, m, tile, dtype, transposed, aligned)
                   for i in order[:order.index(want)])


TILE_CLASSES = ((128, 128), (64, 64), (16, 64), (32, 1), (1, 32))


@pytest.mark.parametrize("m", [1, 17, 256, 384, 3072])
def test_dds_instance_follows_the_rule_for_every_tile_class(m):
    """Every tile class, fp32 / bf16, both orientations, aligned or not:
    the ring exactly where it takes the call, and M never decides it."""
    for tile, dtype, transposed, aligned in itertools.product(
            TILE_CLASSES, (F32, BF16), (False, True), (True, False)):
        ow, iw = (tile[1], tile[0]) if transposed else tile
        ring = (dtype == F32 and aligned and iw % 16 == 0 and ow % 4 == 0)
        want = "ring" if ring else "general"
        assert tbm.dds_instance(m, tile, dtype, transposed, aligned) == want
        assert tbm.dds_instance(1, tile, dtype, transposed, aligned) == want


# (M, output blocks, ow) -> rows of X a ring block takes. The BERT-base
# projections' dX at the training batch (M=3072: dX of qkv, attn_out and
# ffn_in has 6 block columns, ffn_out's 24), the autotuner's dds forward at
# m=256 (qkv 18 block rows, ffn_in 24, attn_out and ffn_out 6), dX at the
# serving M, one decode row, and either side of 4 x 132 blocks.
BLOCK_ROWS_PINNED = [
    (3072, 6, 128, 64),          # 48 x 6 x 2 = 576 blocks
    (3072, 24, 128, 64),         # 2304
    (256, 18, 128, 32),          # 144
    (256, 24, 128, 32),
    (256, 6, 128, 32),
    (384, 6, 128, 32),
    (384, 24, 128, 32),
    (1, 24, 128, 32),
    (3072, 5, 128, 32),          # 480
    (64 * 264, 1, 128, 64),      # 528: the edge
    (64 * 263, 1, 128, 32),      # 526
    (20, 2, 64, 32),             # the spilling plan's dX
    (3072, 64, 16, 64),          # 48 x 64 x 1 = 3072
]


@pytest.mark.parametrize("m,n_out,ow,want", BLOCK_ROWS_PINNED)
def test_dds_block_rows_pinned(m, n_out, ow, want):
    assert tbm.dds_block_rows(m, n_out, ow) == want


@pytest.mark.parametrize("m,n,tile", [(384, 2304, (128, 128)),
                                      (3072, 768, (128, 128)),
                                      (100, 128, (32, 128))])
def test_masked_block_rows_is_the_dds_rule_over_n_tiles(m, n, tile):
    assert tbm.masked_block_rows(m, n, tile) == tbm.dds_block_rows(
        m, n // tile[0], tile[0])


def test_unknown_dds_instance_raises():
    with pytest.raises(ValueError, match="unknown instance"):
        tbm.dds_takes("wgmma", 4, (128, 128), F32, False)


def test_pinned_dds_instance_is_checked_before_any_device_work():
    """A pinned ring that cannot take the call raises before anything is
    allocated or launched: bf16, a (32, 1) tile, an operand off 16 bytes."""
    w = np.zeros((64, 128), np.float32)
    w[:32, :64] = 1.0
    pk = tbm.pack_bsr(w, (32, 64))
    seq = tbm.bsr_sequence(pk)
    data = torch.from_numpy(pk.data)
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="instance 'ring'"):
        tbm._dds_launch("dds", x.to(BF16), data.to(BF16), seq,
                        tile=(32, 64), transposed=False, instance="ring")
    with pytest.raises(ValueError, match="instance 'ring'"):
        tbm._dds_launch("dds", x, data.to(BF16), seq, tile=(32, 64),
                        transposed=False, instance="ring")
    xu = torch.zeros(8 * 128 + 1)[1:].view(8, 128)
    with pytest.raises(ValueError, match="instance 'ring'"):
        tbm._dds_launch("dds", xu, data, seq, tile=(32, 64),
                        transposed=False, instance="ring")
    pk1 = tbm.pack_bsr(np.ones((64, 64), np.float32), (32, 1))
    with pytest.raises(ValueError, match="instance 'ring'"):
        tbm._dds_launch("dds_t", torch.zeros((8, 64)),
                        torch.from_numpy(pk1.data), tbm.bsr_t_sequence(pk1),
                        tile=(32, 1), transposed=True, instance="ring")


# --------------------------------------------------------------------------
# a test-local oracle of both instances' order of summation
# --------------------------------------------------------------------------

def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64 and the sum is
    rounded once more (to fp64, then fp32: off from a true fma only at a
    double-rounding tie)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def oracle_dds(x, values, seq, tile, transposed):
    """K4: output block r's (M, ow) columns are one fmaf chain for each
    output over r's run of tiles in sequence order (padding tiles visited
    as the sequence holds them), k ascending inside each tile; an empty run
    gives exact zeros. x (M, n_in * iw) and values (tiles, bn, bk) hold
    fp32 values; ``transposed`` reads each stored tile as its transpose."""
    ow, iw = (tile[1], tile[0]) if transposed else tile
    m = x.shape[0]
    y = np.zeros((m, seq.n_out * ow), np.float32)
    for r in range(seq.n_out):
        acc = np.zeros((m, ow), np.float32)
        for j in range(seq.seg[r], seq.seg[r + 1]):
            t = values[seq.tile_seq[j]]
            t = t.T if transposed else t                 # (ow, iw)
            xin = x[:, seq.col_seq[j] * iw:(seq.col_seq[j] + 1) * iw]
            for k in range(iw):
                acc = _fma(xin[:, k][:, None], t[:, k][None, :], acc)
        y[:, r * ow:(r + 1) * ow] = acc
    return y


def _close(got, want, dtype):
    got, want = (torch.from_numpy(np.array(a, np.float32))
                 if not isinstance(a, torch.Tensor) else a.float()
                 for a in (got, want))
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (err, TOL[dtype] * scale)


def _sparse(rng, n, k, tile, density):
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    mask[0, :] = False                   # an all-zero block row
    mask[:, -1] = False                  # an all-zero block column
    return w * np.kron(mask, np.ones(tile, np.float32))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == BF16 else jnp.float32


# (M, N, K, tile, bm, dtype): tests/test_kernels.py's shapes (M off the
# block heights), the ring's smallest depth, the general instance's (32, 1)
# tile, and bf16 through the general instance; every pack has an empty
# block row and column and two padding tiles
DDS_CASES = [
    (32, 128, 128, (32, 64), 16, F32),
    (100, 128, 384, (32, 128), 32, F32),
    (16, 512, 256, (128, 128), 16, F32),
    (24, 64, 96, (16, 16), 8, F32),
    (40, 64, 96, (32, 1), 8, F32),
    (33, 128, 256, (32, 64), 16, BF16),
]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,n,k,tile,bm,dtype", DDS_CASES)
def test_dds_oracle_matches_plain_and_jax(m, n, k, tile, bm, dtype,
                                          transposed):
    """dds / dds_t over a padded KernelBSR: the oracle's empty output
    blocks exact zeros, the oracle within the tolerance of the plain
    version and of the reference's interpret-mode kernel."""
    rng = np.random.RandomState(m + n + int(transposed))
    w = _sparse(rng, n, k, tile, 0.5)
    jpk, tpk = jbm.pack_bsr(w, tile), tbm.pack_bsr(w, tile)
    jpk = jbm.pack_bsr(w, tile, nnzt=jpk.real_nnzt + 2)
    tpk = tbm.pack_bsr(w, tile, nnzt=tpk.real_nnzt + 2)
    data = torch.from_numpy(tpk.data).to(dtype)
    a = torch.from_numpy(rng.randn(m, n if transposed else k).astype(
        np.float32)).to(dtype)
    seq = tbm.bsr_t_sequence(tpk) if transposed else tbm.bsr_sequence(tpk)
    assert seq.n_tiles == tpk.nnzt          # padding visited too
    got = oracle_dds(a.float().numpy(), data.float().numpy(), seq, tile,
                     transposed)
    # the all-zero block column (dX) / block row (Y): the pack stores a zero
    # tile there, so its run is not empty but its outputs are exact zeros
    empty = (k // tile[1] - 1) if transposed else 0
    width = tile[1] if transposed else tile[0]
    assert np.all(got[:, empty * width:(empty + 1) * width] == 0.0)
    got = torch.from_numpy(got).to(dtype)
    fn = tbm.dds_t if transposed else tbm.dds
    plain = fn(a, tpk, data)
    jfn = jbm.dds_t if transposed else jbm.dds
    jpk = jpk.__class__(jpk.data.astype(_jdt(dtype)), jpk.row_id, jpk.col_id,
                        jpk.t_perm, jpk.real_nnzt, jpk.shape, jpk.tile)
    ref = jfn(jnp.asarray(a.float().numpy()).astype(_jdt(dtype)), jpk, bm=bm,
              interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    _close(got, plain, dtype)
    _close(got, ref, dtype)
    assert torch.equal(plain[:, empty * width:(empty + 1) * width].float(),
                       torch.zeros(m, width))


def _spill_weight():
    rng = np.random.RandomState(3)
    w = np.zeros((128, 1024), np.float32)
    w[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    return w, (16, 64), 0


def _qkv_weight():
    rng = np.random.RandomState(4)
    tile = (16, 16)
    return np.concatenate([_sparse(rng, 48, 64, tile, 0.5)
                           for _ in range(3)]), tile, 0


def _padded_weight():
    rng = np.random.RandomState(5)
    return _sparse(rng, 96, 128, (16, 32), 0.4), (16, 32), 5


def _zero_column_weight():
    rng = np.random.RandomState(6)
    w = _sparse(rng, 64, 128, (16, 32), 0.6)
    w[:, 32:64] = 0.0                    # block column 1: an empty dX block
    return w, (16, 32), 0


PLAN_CASES = {"spill": _spill_weight, "fused qkv": _qkv_weight,
              "padded": _padded_weight, "zero column": _zero_column_weight}


@pytest.mark.parametrize("m", [20, 37])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_dds_t_oracle_matches_plain_and_jax(name, m):
    """plan_dds_t over the plan's transposed schedule, which reads the
    row-grouped pack in place: the spilling plan, fused QKV, padded nnzt,
    an empty block column (exact zeros)."""
    w, tile, pad = PLAN_CASES[name]()
    jpk, tpk = jbm.pack_bsr(w, tile), tbm.pack_bsr(w, tile)
    if pad:
        jpk = jbm.pack_bsr(w, tile, nnzt=jpk.real_nnzt + pad)
        tpk = tbm.pack_bsr(w, tile, nnzt=tpk.real_nnzt + pad)
    jplan, tplan = jxp.build_plan(jpk), txp.build_plan(tpk)
    assert tplan.spilled == (name == "spill")
    jd = jxp.pack_plan_data(jplan, jpk.data)
    td = txp.pack_plan_data(tplan, tpk.data)
    n, k = w.shape
    ts = txp.plan_t_schedule(tplan)
    assert tbm.dds_instance(m, tile, F32, True) == "ring"
    dy = np.random.RandomState(m).randn(m, n).astype(np.float32)
    got = oracle_dds(dy, td.reshape(-1, *tile).numpy(), ts, tile, True)
    plain = tbm.plan_dds_t(torch.from_numpy(dy), td, ts, k=k, tile=tile)
    ref = np.asarray(jbm.plan_dds_t(jnp.asarray(dy), jd,
                                    jxp.plan_t_sequence(jplan), k=k,
                                    tile=tile, interpret=True))
    _close(got, plain, F32)
    _close(got, ref, F32)
    if name == "zero column":            # a stored zero tile: exact zeros
        assert np.all(got[:, 32:64] == 0.0)
        assert bool((plain[:, 32:64] == 0).all())


def test_empty_run_gives_exact_zeros():
    """An output block with no tile in its run (a schedule with block
    column 1's tiles taken out) is written as exact zeros by the oracle, as
    both instances write it, and by the plain version."""
    w, tile, _ = _zero_column_weight()
    w[:, 32:64] = np.random.RandomState(7).randn(64, 32)
    tplan = txp.build_plan(tbm.pack_bsr(w, tile))
    ts = txp.plan_t_schedule(tplan)
    keep = ts.row_ids != 1
    assert not keep.all()
    cut = tbm.TileSequence(ts.row_ids[keep], ts.col_seq[keep],
                           ts.tile_seq[keep], n_out=ts.n_out, n_in=ts.n_in)
    assert cut.seg[1] == cut.seg[2]
    td = txp.pack_plan_data(tplan, tbm.pack_bsr(w, tile).data)
    dy = np.random.RandomState(8).randn(24, 64).astype(np.float32)
    got = oracle_dds(dy, td.reshape(-1, *tile).numpy(), cut, tile, True)
    plain = tbm.plan_dds_t(torch.from_numpy(dy), td, cut, k=128, tile=tile)
    assert np.all(got[:, 32:64] == 0.0) and np.abs(got).max() > 0
    assert bool((plain[:, 32:64] == 0).all())
    _close(got, plain, F32)


def test_dds_oracle_sums_tiles_in_sequence_order():
    """One output fed by two tiles of depth 2 whose products are (1e8, 1)
    and (-1e8, 1): one chain, tile after tile, gives ((1e8 + 1) - 1e8) + 1
    = 1 in fp32 (1e8 + 1 rounds to 1e8); a chain taken k-major across the
    tiles gives (1e8 - 1e8) + 1 + 1 = 2. The run's order is part of the
    result, so both instances keep it."""
    x = np.array([[1e8, 1.0, -1e8, 1.0]], np.float32)
    values = np.ones((2, 1, 2), np.float32)
    seq = tbm.TileSequence([0, 0], [0, 1], [0, 1], n_out=1, n_in=2)
    y = oracle_dds(x, values, seq, (1, 2), False)
    assert y[0, 0] == 1.0
    inter = np.float32(0)
    for k in range(2):
        for j in range(2):
            inter = _fma(x[0, 2 * j + k], values[j, 0, k], inter)
    assert inter == 2.0
