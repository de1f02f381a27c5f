"""The instances of kernels K5 (``sddmm`` / ``plan_sddmm``) and K7
(``masked_matmul``) on the CPU: the pinned tables by which the wrappers pick
one (``bsr_matmul.sddmm_instance``, ``sddmm_splits``, ``masked_instance``,
``masked_block_rows``), and test-local oracles of each instance's order of
summation -- K5's ring as one fmaf chain over each chunk of M, the chunks'
partials added in split order (one chain over M when S = 1, as the general
instance); K7 as one fmaf chain over the compacted unmasked k -- against the
plain versions and the reference's Pallas kernels in interpret mode, on the
same numpy-seeded inputs at small widths. The kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``)."""
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

# (M, tile, dtype, aligned) -> K5 instance: the ring takes fp32 dY and X
# with bn and bk multiples of 4 and 16-byte aligned operands
SDDMM_PINNED = [
    (3072, (128, 128), F32, True, "ring"),      # the packed training step
    (384, (128, 128), F32, True, "ring"),
    (1, (128, 128), F32, True, "ring"),
    (17, (64, 128), F32, True, "ring"),
    (17, (32, 64), F32, True, "ring"),
    (24, (16, 32), F32, True, "ring"),
    (20, (16, 64), F32, True, "ring"),          # the spilling plan's tile
    (3072, (128, 128), BF16, True, "general"),
    (3072, (32, 1), F32, True, "general"),      # the paper's 32 x 1 tile
    (40, (32, 1), BF16, True, "general"),
    (40, (1, 32), F32, True, "general"),
    (40, (32, 6), F32, True, "general"),
    (40, (6, 32), F32, True, "general"),
    (3072, (128, 128), F32, False, "general"),  # an operand off 16 bytes
]


@pytest.mark.parametrize("m,tile,dtype,aligned,want", SDDMM_PINNED)
def test_sddmm_instance_pinned_table(m, tile, dtype, aligned, want):
    assert tbm.sddmm_instance(m, tile, dtype, aligned) == want
    assert tbm.sddmm_takes(want, m, tile, dtype, aligned)
    assert tbm.sddmm_takes("general", m, tile, dtype, aligned)
    order = tbm.SDDMM_INSTANCES
    assert not any(tbm.sddmm_takes(i, m, tile, dtype, aligned)
                   for i in order[:order.index(want)])


# (M, tiles, tile, splits asked for) -> (S, chunk). The kernel phase's
# BERT-base projections at density 0.2 (chip_smoke.py's draws: 27, 10, 32
# and 41 tiles of 128 x 128), the packed training step's near-dense union
# (up to 108 / 36 / 144 / 144 tiles), a grid that fills the target alone,
# M below two 128-row chunks, ragged M, and S asked for by a caller.
SPLITS_PINNED = [
    (3072, 27, (128, 128), None, (8, 384)),
    (3072, 10, (128, 128), None, (8, 384)),
    (3072, 32, (128, 128), None, (8, 384)),
    (3072, 41, (128, 128), None, (8, 384)),
    (3072, 108, (128, 128), None, (5, 640)),
    (3072, 104, (128, 128), None, (6, 512)),
    (3072, 36, (128, 128), None, (8, 384)),
    (3072, 144, (128, 128), None, (4, 768)),
    (3072, 1, (128, 128), None, (8, 384)),
    (3072, 528, (128, 128), None, (1, 3072)),
    (3072, 500, (32, 1), None, (5, 640)),
    (3072, 27, (128, 128), 1, (1, 3072)),
    (3072, 27, (128, 128), 7, (6, 512)),
    (384, 27, (128, 128), None, (3, 128)),
    (300, 3, (32, 64), None, (2, 256)),
    (255, 3, (32, 64), None, (1, 255)),
    (17, 5, (128, 128), None, (1, 17)),
    (1, 5, (128, 128), 3, (1, 1)),
    (17, 5, (128, 128), 3, (3, 6)),
    (100, 5, (32, 64), 3, (3, 34)),
    (3072, 0, (128, 128), None, (1, 3072)),
]


@pytest.mark.parametrize("m,tiles,tile,splits,want", SPLITS_PINNED)
def test_sddmm_splits_pinned(m, tiles, tile, splits, want):
    s, chunk = tbm.sddmm_splits(m, tiles, tile, splits)
    assert (s, chunk) == want
    # every chunk holds rows, and together they hold all M
    assert (s - 1) * chunk < m <= s * chunk


@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000, 3072, 4096, 10000])
def test_sddmm_splits_follow_the_rule(m):
    """S from (sub-tile blocks, M) alone: enough chunks to reach the target
    grid and no more, at most SDDMM_MAX_SPLITS, chunks of whole
    SDDMM_SPLIT_ROWS rows; one chunk where the grid fills the target or M
    holds fewer than two chunks."""
    rows = tbm.SDDMM_SPLIT_ROWS
    target = tbm.SDDMM_TARGET_BLOCKS
    for tiles in (1, 3, 10, 27, 100, 1000):
        blocks = tiles * 4                       # 128 x 128 tiles
        s, chunk = tbm.sddmm_splits(m, tiles, (128, 128))
        assert 1 <= s <= tbm.SDDMM_MAX_SPLITS
        assert (s - 1) * chunk < m <= s * chunk
        assert s <= -(-target // blocks)
        if s > 1:
            assert chunk % rows == 0
        if blocks >= target or m < 2 * rows:
            assert s == 1


# (M, tile, x dtype, W dtype, aligned) -> K7 instance: the ring takes fp32
# X and W with bk a multiple of 16 and 16-byte aligned operands
MASKED_PINNED = [
    (384, (128, 128), F32, F32, True, "ring"),   # the negative control
    (1, (128, 128), F32, F32, True, "ring"),
    (100, (32, 128), F32, F32, True, "ring"),
    (32, (32, 64), F32, F32, True, "ring"),
    (24, (16, 32), F32, F32, True, "ring"),
    (24, (16, 16), F32, F32, True, "ring"),
    (40, (32, 1), F32, F32, True, "general"),
    (40, (32, 8), F32, F32, True, "general"),
    (40, (32, 24), F32, F32, True, "general"),
    (130, (128, 128), BF16, BF16, True, "general"),
    (130, (128, 128), F32, BF16, True, "general"),
    (130, (128, 128), BF16, F32, True, "general"),
    (384, (128, 128), F32, F32, False, "general"),
]


@pytest.mark.parametrize("m,tile,x_dtype,w_dtype,aligned,want", MASKED_PINNED)
def test_masked_instance_pinned_table(m, tile, x_dtype, w_dtype, aligned,
                                      want):
    assert tbm.masked_instance(m, tile, x_dtype, w_dtype, aligned) == want
    assert tbm.masked_takes(want, m, tile, x_dtype, w_dtype, aligned)
    order = tbm.MASKED_INSTANCES
    assert not any(tbm.masked_takes(i, m, tile, x_dtype, w_dtype, aligned)
                   for i in order[:order.index(want)])


# (M, N, tile) -> rows of X a ring block takes: the BERT-base projections at
# the serving M (384), the autotuner's (256), two (1, 384) requests and a
# (8, 384) batch
BLOCK_ROWS_PINNED = [
    (384, 2304, (128, 128), 32),
    (384, 768, (128, 128), 32),
    (384, 3072, (128, 128), 32),
    (256, 3072, (128, 128), 32),
    (768, 3072, (128, 128), 64),
    (3072, 768, (128, 128), 64),
    (3072, 2304, (128, 128), 64),
    (1, 768, (128, 128), 32),
    (100, 128, (32, 128), 32),
]


@pytest.mark.parametrize("m,n,tile,want", BLOCK_ROWS_PINNED)
def test_masked_block_rows_pinned(m, n, tile, want):
    assert tbm.masked_block_rows(m, n, tile) == want


def test_unknown_instances_raise():
    with pytest.raises(ValueError, match="unknown instance"):
        tbm.sddmm_takes("wgmma", 4, (128, 128), F32)
    with pytest.raises(ValueError, match="unknown instance"):
        tbm.masked_takes("wgmma", 4, (128, 128), F32, F32)


def test_pinned_sddmm_instance_is_checked_before_any_device_work():
    """A pinned instance that cannot take the call raises before anything
    is allocated or launched; the general instance takes one chunk only."""
    rows = torch.zeros(3, dtype=torch.int32)
    dy, x = torch.zeros((8, 64), dtype=BF16), torch.zeros((8, 128),
                                                          dtype=BF16)
    with pytest.raises(ValueError, match="instance 'ring'"):
        tbm._sddmm_launch("sddmm", dy, x, rows, rows, tile=(32, 64),
                          n_real=3, out_dtype=F32, instance="ring",
                          splits=None)
    with pytest.raises(ValueError, match="one chunk"):
        tbm._sddmm_launch("sddmm", dy, x, rows, rows, tile=(32, 64),
                          n_real=3, out_dtype=F32, instance="general",
                          splits=2)


# --------------------------------------------------------------------------
# test-local oracles of the instances' order of summation
# --------------------------------------------------------------------------

def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64 and the sum is
    rounded once more (to fp64, then fp32: off from a true fma only at a
    double-rounding tie)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def oracle_sddmm(dy, x, rows, cols, tile, n_real, n_tiles, splits, chunk):
    """K5: tile j's chunk s sums its rows of dY[:, row_j]^T X[:, col_j] in
    one fmaf chain, m ascending; the S partials are added in split order
    (S = 1: one chain over M, the general instance). Tiles j >= n_real are
    exact zeros. dy (M, N) and x (M, K) hold fp32 values."""
    bn, bk = tile
    m = dy.shape[0]
    out = np.zeros((n_tiles, bn, bk), np.float32)
    for j in range(n_real):
        a = dy[:, rows[j] * bn:(rows[j] + 1) * bn]
        b = x[:, cols[j] * bk:(cols[j] + 1) * bk]
        total = None
        for s in range(splits):
            acc = np.zeros((bn, bk), np.float32)
            for r in range(s * chunk, min(m, (s + 1) * chunk)):
                acc = _fma(a[r][:, None], b[r][None, :], acc)
            total = acc if total is None else (total + acc).astype(np.float32)
        out[j] = total
    return out


def oracle_masked(x, w, mask, tile):
    """K7: each output one fmaf chain over the unmasked K tiles of its N
    tile in order, k ascending inside each; an all-masked tile row gives
    exact zeros. x (M, K) and w (N, K) hold fp32 values."""
    bn, bk = tile
    m = x.shape[0]
    y = np.zeros((m, w.shape[0]), np.float32)
    for r in range(mask.shape[0]):
        acc = np.zeros((m, bn), np.float32)
        for kt in np.flatnonzero(mask[r]):
            for k in range(kt * bk, (kt + 1) * bk):
                acc = _fma(x[:, k][:, None], w[r * bn:(r + 1) * bn, k][None],
                           acc)
        y[:, r * bn:(r + 1) * bn] = acc
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
    return w * np.kron(mask, np.ones(tile, np.float32))


def _round(a, dtype):
    return torch.from_numpy(a).to(dtype)


# (M, tile, splits asked for or None, dtype): ragged M, M below one chunk,
# S = 1, and bf16 inputs through the general instance
SDDMM_CASES = [
    (17, (32, 64), None, F32),       # below one 128-row chunk: S = 1
    (100, (32, 64), 3, F32),         # ragged chunks 34, 34, 32
    (300, (32, 64), None, F32),      # S = 2: chunks of 256 and 44
    (300, (32, 64), 1, F32),         # one chain over M
    (40, (32, 1), None, F32),        # general only
    (64, (32, 64), None, BF16),      # general, bf16 inputs
]


@pytest.mark.parametrize("m,tile,splits,dtype", SDDMM_CASES)
def test_sddmm_oracle_matches_plain_and_jax(m, tile, splits, dtype):
    """sddmm over a KernelBSR with two padding tiles (exactly 0)."""
    rng = np.random.RandomState(m)
    w = _sparse(rng, 128, 256, tile, 0.5)
    jpk, tpk = jbm.pack_bsr(w, tile), tbm.pack_bsr(w, tile)
    jpk = jbm.pack_bsr(w, tile, nnzt=jpk.real_nnzt + 2)
    tpk = tbm.pack_bsr(w, tile, nnzt=tpk.real_nnzt + 2)
    dy = _round(rng.randn(m, 128).astype(np.float32), dtype)
    x = _round(rng.randn(m, 256).astype(np.float32), dtype)
    inst = tbm.sddmm_instance(m, tile, dtype)
    s, chunk = ((1, m) if inst == "general"
                else tbm.sddmm_splits(m, tpk.real_nnzt, tile, splits))
    seq = tbm.bsr_sequence(tpk)
    got = oracle_sddmm(dy.float().numpy(), x.float().numpy(), seq.row_ids,
                       seq.col_seq, tile, tpk.real_nnzt, tpk.nnzt, s, chunk)
    assert np.all(got[tpk.real_nnzt:] == 0.0)
    got = torch.from_numpy(got).to(dtype)
    plain = tbm.sddmm(dy, x, tpk, torch.from_numpy(tpk.data).to(dtype))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    ref = jbm.sddmm(jnp.asarray(dy.float().numpy()).astype(jdt),
                    jnp.asarray(x.float().numpy()).astype(jdt),
                    jpk.__class__(jpk.data.astype(jdt), jpk.row_id,
                                  jpk.col_id, jpk.t_perm, jpk.real_nnzt,
                                  jpk.shape, jpk.tile), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    _close(got, plain, dtype)
    _close(got, ref, dtype)


def _spill_weight():
    rng = np.random.RandomState(3)
    w = np.zeros((128, 1024), np.float32)
    w[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    return w, (16, 64)


@pytest.mark.parametrize("m,splits", [(20, None), (260, None), (100, 4)])
def test_plan_sddmm_oracle_matches_plain_and_jax_on_the_spilling_plan(
        m, splits):
    w, tile = _spill_weight()
    jplan = jxp.plan_for_pack(jbm.pack_bsr(w, tile))
    tplan = txp.plan_for_pack(tbm.pack_bsr(w, tile))
    assert tplan.spilled
    sched = txp.plan_schedule(tplan)
    rng = np.random.RandomState(m)
    dy = rng.randn(m, 128).astype(np.float32)
    x = rng.randn(m, 1024).astype(np.float32)
    assert tbm.sddmm_instance(m, tile, F32) == "ring"
    s, chunk = tbm.sddmm_splits(m, sched.n_tiles, tile, splits)
    assert (s > 1) == (m >= 256 or splits is not None)
    got = oracle_sddmm(dy, x, sched.row_ids, sched.col_seq, tile,
                       sched.n_tiles, sched.n_tiles, s, chunk)
    plain = tbm.plan_sddmm(torch.from_numpy(dy), torch.from_numpy(x), sched,
                           tile=tile)
    ref = np.asarray(jbm.plan_sddmm(
        jnp.asarray(dy), jnp.asarray(x), jxp.plan_kernel_sequence(jplan),
        tile=tile, out_dtype=jnp.float32, interpret=True))
    _close(got, plain, F32)
    _close(got, ref, F32)


def test_sddmm_oracle_adds_the_splits_in_order():
    """dY's column holds 1e8, 1, -1e8, 1 against X = 1: one chain over M
    gives ((1e8 + 1) - 1e8) + 1 = 1 (1e8 + 1 rounds to 1e8 in fp32); two
    chunks of two rows give 1e8 + (-1e8 + 1) = 0. The chunk edges are part
    of the result, so S is pinned by the wrapper's table."""
    dy = np.array([[1e8], [1.0], [-1e8], [1.0]], np.float32)
    x = np.ones((4, 1), np.float32)
    rows = cols = np.array([0])
    one = oracle_sddmm(dy, x, rows, cols, (1, 1), 1, 1, 1, 4)
    two = oracle_sddmm(dy, x, rows, cols, (1, 1), 1, 1, 2, 2)
    assert one[0, 0, 0] == 1.0 and two[0, 0, 0] == 0.0
    assert tbm.sddmm_splits(4, 1, (1, 1), 2) == (2, 2)


# (M, N, K, tile, dtype): M off the block heights, the general instance's
# (32, 1) tile, bf16 through the general instance
MASKED_CASES = [
    (17, 128, 256, (32, 64), F32),
    (100, 128, 384, (32, 128), F32),
    (70, 64, 96, (16, 32), F32),
    (40, 64, 64, (32, 1), F32),
    (33, 128, 256, (32, 64), BF16),
]


@pytest.mark.parametrize("m,n,k,tile,dtype", MASKED_CASES)
def test_masked_oracle_matches_plain_and_jax(m, n, k, tile, dtype):
    """Values left in every tile, masked ones too; an all-masked tile row
    gives exact zeros."""
    rng = np.random.RandomState(m + n)
    w = _round(rng.randn(n, k).astype(np.float32), dtype)
    x = _round(rng.randn(m, k).astype(np.float32), dtype)
    mask = rng.rand(n // tile[0], k // tile[1]) < 0.4
    mask[0, :] = False
    got = oracle_masked(x.float().numpy(), w.float().numpy(), mask, tile)
    assert np.all(got[:, :tile[0]] == 0.0)
    full = x.float().numpy() @ w.float().numpy().T
    assert np.abs(got - full).max() > 1e-2      # the masked tiles skipped
    got = torch.from_numpy(got).to(dtype)
    plain = tbm.masked_matmul(x, w, mask, tile=tile)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    ref = jbm.masked_matmul(jnp.asarray(x.float().numpy()).astype(jdt),
                            jnp.asarray(w.float().numpy()).astype(jdt),
                            jnp.asarray(mask), tile=tile, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    _close(got, plain, dtype)
    _close(got, ref, dtype)
