"""The port's host side against the JAX reference: block masks and pruning
recipes give the same masks, tree paths and leaf order match, and the tile
pack, plan, kernel schedule and fingerprints are byte-identical."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.core import SparsityConfig as JSparsity  # noqa: E402
from repro.core.pruner import _path_name  # noqa: E402
from repro.core.pruner import oneshot_prune as j_oneshot  # noqa: E402
from repro.core.pruner import tied_prune as j_tied  # noqa: E402
from repro.core.sparsity import topk_block_mask as j_topk  # noqa: E402
from repro.kernels import exec_plan as jxp  # noqa: E402
from repro.kernels.bsr_matmul import pack_bsr as j_pack  # noqa: E402

from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core import PatternRegistry, SparsityConfig  # noqa: E402
from repro_torch.core.pruner import oneshot_prune, tied_prune  # noqa: E402
from repro_torch.core.sparsity import topk_block_mask  # noqa: E402
from repro_torch.core.tree import flatten_with_path, path_name  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels.bsr_matmul import pack_bsr  # noqa: E402
from repro_torch.models import init_model  # noqa: E402

TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/wi", "ffn/wo")


def _sparse_weight(rng, n, k, tile, density):
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    return w * np.kron(mask, np.ones(tile, np.float32))


@pytest.fixture(scope="module")
def bert_params():
    """The smoke BERT tree in both packages (the port's seeded init handed
    to JAX through numpy)."""
    tp = init_model(0, get_config("bert_base", smoke=True), device="cpu")
    return jax.tree.map(jnp.asarray, params_to_numpy(tp)), tp


def _masks_equal(jm, tm):
    jl = jax.tree_util.tree_leaves(jm)
    tl = [leaf for _, leaf in flatten_with_path(tm)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------------
# masks and pruning recipes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block,sparsity", [
    ((64, 96), (16, 16), 0.8), ((128, 64), (32, 1), 0.5),
    ((48, 48), (16, 16), 0.3)])
def test_topk_block_mask_matches_jax(shape, block, sparsity):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(j_topk(jnp.asarray(w), block, sparsity))
    got = topk_block_mask(torch.from_numpy(w), block, sparsity).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_block_mask_ties_break_by_flat_index():
    """Many exactly tied norms: lax.top_k keeps the lowest flat indices;
    the port's stable sort must keep the same ones."""
    rng = np.random.RandomState(2)
    base = rng.randn(16, 16).astype(np.float32)
    w = np.tile(base, (4, 6))                     # 24 identical blocks
    w[:16, 16:32] *= 2.0                          # one strictly larger block
    for sparsity in (0.5, 0.75, 0.9):
        want = np.asarray(j_topk(jnp.asarray(w), (16, 16), sparsity))
        got = topk_block_mask(torch.from_numpy(w), (16, 16),
                              sparsity).numpy()
        np.testing.assert_array_equal(got, want)


def test_tree_paths_and_order_match_jax(bert_params):
    jp, tp = bert_params
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = flatten_with_path(tp)
    assert [_path_name(p) for p, _ in jflat] == \
        [path_name(p) for p, _ in tflat]
    assert "layers/[1]/attn/wq/w" in [path_name(p) for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("recipe", ["oneshot", "tied"])
@pytest.mark.parametrize("block,sparsity", [((16, 16), 0.5),
                                            ((16, 16), 0.8),
                                            ((32, 1), 0.8)])
def test_prune_recipes_match_jax(bert_params, recipe, block, sparsity):
    jp, tp = bert_params
    jcfg = JSparsity(block_shape=block, sparsity=sparsity, targets=TARGETS)
    tcfg = SparsityConfig(block_shape=block, sparsity=sparsity,
                          targets=TARGETS)
    jfn, tfn = ((j_oneshot, oneshot_prune) if recipe == "oneshot"
                else (j_tied, tied_prune))
    jpr, jm = jfn(jp, jcfg)
    tpr, tm = tfn(tp, tcfg)
    _masks_equal(jm, tm)
    for a, b in zip(jax.tree_util.tree_leaves(jpr),
                    [leaf for _, leaf in flatten_with_path(tpr)]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_tied_prune_with_tied_norms_matches_jax():
    """Every layer holds the same weights, so the group's mean norms tie
    across many blocks -- the mean is taken in fp32 in member order and the
    ties fall to the lower flat index, as in the reference."""
    rng = np.random.RandomState(3)
    blk = rng.randn(16, 16).astype(np.float32)
    w = np.tile(blk, (4, 4))
    w[16:32] *= 3.0
    tree = {"layers": tuple({"attn": {"wq": {"w": w.copy()},
                                      "wo": {"w": (w * 0.5).copy()}}}
                            for _ in range(3))}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = params_from_numpy(tree)
    for sparsity in (0.5, 0.8):
        jcfg = JSparsity(block_shape=(16, 16), sparsity=sparsity,
                         targets=TARGETS)
        tcfg = SparsityConfig(block_shape=(16, 16), sparsity=sparsity,
                              targets=TARGETS)
        _masks_equal(j_tied(jt, jcfg)[1], tied_prune(tt, tcfg)[1])


# --------------------------------------------------------------------------
# tile pack, plan, schedule: byte-identical
# --------------------------------------------------------------------------

def _spill_weight(rng):
    n, k = 128, 1024
    w = np.zeros((n, k), np.float32)
    w[:16, :] = rng.randn(16, k)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    return w


def _skewed_weight(rng):
    # tests/test_exec_plan.py's spill pattern: one dense row, rest sparse
    n, k, tile = 128, 512, (16, 32)
    w = _sparse_weight(rng, n, k, tile, 0.1)
    w[:16] = rng.randn(16, k)
    return w


_CASES = {
    # (maker, tile, pad_tiles)
    "exec_plan_32x64": (lambda r: _sparse_weight(r, 128, 256, (32, 64), 0.4),
                        (32, 64), 0),
    "exec_plan_32x64_pad7": (lambda r: _sparse_weight(r, 128, 256, (32, 64),
                                                      0.4), (32, 64), 7),
    "pallas_16x32": (lambda r: _sparse_weight(r, 96, 128, (16, 32), 0.4),
                     (16, 32), 0),
    "pallas_16x32_sparse": (lambda r: _sparse_weight(r, 96, 128, (16, 32),
                                                     0.15), (16, 32), 0),
    "pallas_16x32_pad5": (lambda r: _sparse_weight(r, 96, 128, (16, 32),
                                                   0.4), (16, 32), 5),
    "spill_edge_16x64": (_spill_weight, (16, 64), 0),
    "skewed_16x32": (_skewed_weight, (16, 32), 0),
    "fused_qkv_16x16": (lambda r: np.concatenate(
        [_sparse_weight(r, 48, 64, (16, 16), 0.5) for _ in range(3)]),
        (16, 16), 0),
    "epilogue_16x16": (lambda r: _sparse_weight(r, 64, 96, (16, 16), 0.5),
                       (16, 16), 0),
    "paper_32x1": (lambda r: _sparse_weight(r, 64, 64, (32, 1), 0.3),
                   (32, 1), 0),
    "empty_rows_cols": (lambda r: np.zeros((64, 64), np.float32),
                        (16, 16), 0),
}


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pack_plan_schedule_byte_identical(case):
    maker, tile, pad = _CASES[case]
    w = maker(np.random.RandomState(7))
    jpk, tpk = j_pack(w, tile), pack_bsr(w, tile)
    if pad:
        jpk = j_pack(w, tile, nnzt=jpk.real_nnzt + pad)
        tpk = pack_bsr(w, tile, nnzt=tpk.real_nnzt + pad)
    _assert_same(jpk.data, tpk.data, "data")
    for f in ("row_id", "col_id", "t_perm"):
        _assert_same(getattr(jpk, f), getattr(tpk, f), f)
    assert (jpk.real_nnzt, jpk.shape, jpk.tile) == \
        (tpk.real_nnzt, tpk.shape, tpk.tile)
    assert jxp.kernel_pattern_fingerprint(jpk) == \
        txp.kernel_pattern_fingerprint(tpk)

    jpl, tpl = jxp.build_plan(jpk), txp.build_plan(tpk)
    for f in ("col_idx", "slot_mask", "row_of_vrow", "vrow", "slot"):
        _assert_same(getattr(jpl, f), getattr(tpl, f), f)
    assert jpl.fingerprint == tpl.fingerprint
    assert (jpl.nnzt, jpl.real_nnzt, jpl.spilled) == \
        (tpl.nnzt, tpl.real_nnzt, tpl.spilled)
    for a, b, name in zip(jxp.plan_kernel_sequence(jpl),
                          txp.plan_kernel_sequence(tpl),
                          ("row_seq", "col_seq", "vrow_seq", "slot_seq")):
        _assert_same(a, b, name)
    _assert_same(jxp.pack_plan_data(jpl, jpk.data),
                 txp.pack_plan_data(tpl, tpk.data).numpy(), "data_rp")
    if case == "spill_edge_16x64":
        assert tpl.spilled


def test_choose_capacity_matches_jax():
    rng = np.random.RandomState(4)
    for _ in range(20):
        counts = rng.randint(0, 12, size=rng.randint(1, 30))
        counts[0] = max(counts[0], 1)
        for bk in (1, 16, 64, 128):
            assert txp._choose_capacity(counts, bk) == \
                jxp._choose_capacity(counts, bk)


def test_plan_registry_shares_identical_patterns():
    w = _sparse_weight(np.random.RandomState(5), 64, 64, (16, 16), 0.5)
    reg = PatternRegistry()
    a = txp.plan_for_pack(pack_bsr(w, (16, 16)), reg)
    b = txp.plan_for_pack(pack_bsr(w.copy(), (16, 16)), reg)
    assert a is b
    assert (reg.stats.hits, reg.stats.misses) == (1, 1)
    assert reg.n_unique_patterns() == 1


def test_checkpoint_leaf_order_matches_jax(tmp_path):
    """Leaves are numbered in JAX flatten order (sorted dict keys), whatever
    the tree's insertion order: both stores write the same arrays.npz."""
    rng = np.random.RandomState(6)
    tree = {"z": {"b": rng.randn(3).astype(np.float32),
                  "a": rng.randn(2, 2).astype(np.float32)},
            "layers": ({"w": rng.randn(4).astype(np.float32)}, None,
                       {"w": np.arange(3, dtype=np.int32)}),
            "m": rng.randn(1).astype(np.float32)}
    JStore(str(tmp_path / "j")).save(0, jax.tree.map(jnp.asarray, tree),
                                     blocking=True)
    CheckpointStore(str(tmp_path / "t")).save(0, params_from_numpy(tree))
    with np.load(tmp_path / "j/step_000000000/arrays.npz") as a, \
            np.load(tmp_path / "t/step_000000000/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            _assert_same(a[name], b[name], name)
