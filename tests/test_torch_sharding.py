"""The port's sharding host side against the JAX reference, in one process:
``ShardedPlan`` layouts and fingerprints byte-identical (S in {2, 4, 8},
both axes, the identical-shard regression of ``test_sharded_serving.py``),
every sharding rule spec-equal for every leaf of every registry config at
full width on six meshes (abstract shapes: ``jax.eval_shape`` and an
``AbstractMesh`` on the reference side, the port's rules on the same names
and shapes, and the port's own cache tree on the meta device), the pack
codec's arrays and metas equal, the autotune shard keys and
``shard_subpack``, ``shard_axis_for``, the spec validation cases, and the
rank-local plan views (``exec_plan.local_plan``) reassembling the whole
product. The multi-rank serving tests are ``test_torch_tp_serving.py``."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_config  # noqa: E402
from repro.core.pattern_reuse import PatternRegistry as JRegistry  # noqa
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import exec_plan as jxp  # noqa: E402
from repro.kernels.bsr_matmul import pack_bsr as j_pack  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.common import PagedLayout as JPaged  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro.serving import serialize as jser  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PatternRegistry  # noqa: E402
from repro_torch.core.tree import flatten_with_path  # noqa: E402
from repro_torch.kernels import autotune as tat  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels.bsr_matmul import pack_bsr  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import PagedLayout  # noqa: E402
from repro_torch.serving import ServingSpec  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402
from repro_torch.serving import serialize as tser  # noqa: E402

CPU = torch.device("cpu")

#: (shape, axes) of the meshes the rules are held on
MESHES = (((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")), ((1, 8), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
MESH_IDS = ["x".join(map(str, m[0])) for m in MESHES]


def _meshes(i):
    shape, axes = MESHES[i]
    return AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (trailing Nones explicit)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _leaf_shapes(tree):
    """{reference leaf name: shape} of a JAX (abstract) tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsh._leaf_name(p): tuple(x.shape) for p, x in flat}


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    cfg = j_config(arch)
    return _leaf_shapes(jax.eval_shape(
        lambda: japi.init_model(jax.random.PRNGKey(0), cfg)))


def _j_cache(arch, paged):
    cfg = j_config(arch)
    params = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0),
                                                    cfg))
    if cfg.family == "audio":
        frames = jax.ShapeDtypeStruct((8, cfg.n_audio_ctx, cfg.d_model),
                                      jnp.float32)
        return jax.eval_shape(lambda p, f: japi.init_cache(p, cfg, 8, 64,
                                                           frames=f),
                              params, frames)
    layout = JPaged(page_size=16, n_pages=32) if paged else None
    return jax.eval_shape(lambda p: japi.init_cache(p, cfg, 8, 64,
                                                    paged=layout), params)


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch, paged):
    return _leaf_shapes(_j_cache(arch, paged))


DECODERS = tuple(a for a in ARCHS if a != "bert_base")
LM_ARCHS = tuple(a for a in DECODERS if a != "whisper_base")


# --------------------------------------------------------------------------
# sharded plans: byte-identical to the reference
# --------------------------------------------------------------------------

def _weight(seed, n, k, tile, density):
    rng = np.random.RandomState(seed)
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    return w * np.kron(mask, np.ones(tile, np.float32))


def _plans_equal(jp, tp):
    for f in ("col_idx", "slot_mask", "row_of_vrow", "vrow", "slot"):
        a, b = np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert jp.fingerprint == tp.fingerprint
    assert tuple(jp.shard_fingerprints) == tuple(tp.shard_fingerprints)
    assert (jp.n_shards, jp.shard_axis, jp.shape, jp.tile, jp.nnzt,
            jp.real_nnzt) == (tp.n_shards, tp.shard_axis, tp.shape, tp.tile,
                              tp.nnzt, tp.real_nnzt)
    assert tp.spilled and tp.n_vrows % tp.n_shards == 0


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("axis", ["out", "in"])
def test_build_sharded_plan_bytes_equal_reference(axis, n_shards):
    w = _weight(n_shards, 256, 128, (16, 16), 0.4)
    jp = jxp.build_sharded_plan(j_pack(w, (16, 16)), n_shards, axis)
    tp = txp.build_sharded_plan(pack_bsr(w, (16, 16)), n_shards, axis)
    _plans_equal(jp, tp)
    for s in range(n_shards):
        assert txp.shard_pattern_fingerprint(pack_bsr(w, (16, 16)),
                                             n_shards, axis, s) == \
            jxp.shard_pattern_fingerprint(j_pack(w, (16, 16)), n_shards,
                                          axis, s)


@pytest.mark.parametrize("axis", ["out", "in"])
def test_shard_layout_and_registry_stats_equal_reference(axis):
    """``_shard_layout`` on one shard's tiles, and a registry-cached build
    (twice) with the same per-shard hit / miss counts as the reference."""
    w = _weight(7, 128, 128, (16, 16), 0.5)
    jpk, tpk = j_pack(w, (16, 16)), pack_bsr(w, (16, 16))
    rows = np.asarray(tpk.row_id[: tpk.real_nnzt], np.int64)
    cols = np.asarray(tpk.col_id[: tpk.real_nnzt], np.int64)
    sel = rows < 4
    for a, b in zip(jxp._shard_layout(rows[sel], cols[sel], 3),
                    txp._shard_layout(rows[sel], cols[sel], 3)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jreg, treg, jst, tst = JRegistry(), PatternRegistry(), {}, {}
    for _ in range(2):
        jp = jxp.build_sharded_plan(jpk, 4, axis, registry=jreg,
                                    shard_stats=jst)
        tp = txp.build_sharded_plan(tpk, 4, axis, registry=treg,
                                    shard_stats=tst)
        _plans_equal(jp, tp)
    assert jst == tst and set(tst) == {0, 1, 2, 3}


@pytest.mark.parametrize("axis", ["out", "in"])
def test_identical_shard_patterns_share_layouts_correctly(axis):
    """``test_sharded_serving.py``'s regression: shards whose local
    sub-patterns coincide share one position-independent cached layout,
    re-offset to each shard's global rows / cols -- layouts equal to the
    reference's and the product equal to the dense one."""
    tile = (16, 16)
    blk = np.random.RandomState(0).rand(2, 2) < 0.7
    mask = np.kron(np.ones((4, 2), bool), blk)
    w = np.random.RandomState(1).randn(128, 64).astype(np.float32)
    w *= np.kron(mask, np.ones(tile, np.float32))
    reg = PatternRegistry()
    tp = txp.build_sharded_plan(pack_bsr(w, tile), 4, axis, registry=reg)
    assert reg.stats.hits > 0
    _plans_equal(jxp.build_sharded_plan(j_pack(w, tile), 4, axis,
                                        registry=JRegistry()), tp)
    data = txp.pack_plan_data(tp, pack_bsr(w, tile).data)
    x = np.random.RandomState(2).randn(3, 64).astype(np.float32)
    y = txp.plan_linear(torch.from_numpy(x), data, tp)
    np.testing.assert_allclose(y.numpy(), x @ w.T, atol=1e-4)


def test_indivisible_pattern_raises_and_predicate():
    w = np.random.RandomState(2).randn(48, 48).astype(np.float32)
    pk = pack_bsr(w, (16, 16))
    assert not txp.shard_divisible(pk, 8, "out")
    assert txp.shard_divisible(pk, 3, "in")
    with pytest.raises(ValueError):
        txp.build_sharded_plan(pk, 8, "out")


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("axis", ["out", "in"])
def test_local_plans_reassemble_the_whole_product(axis, n_shards):
    """Each rank's view (``local_plan`` over its vrow slice of the values)
    gives its output block ('out': concatenated) or an fp32 partial of
    every output ('in': summed) -- the whole plan's product; a shard that
    misses block rows reads exact zeros there, and kernel K1's schedule
    refuses such a plan."""
    w = _weight(3, 128, 256, (16, 16), 0.25)
    pk = pack_bsr(w, (16, 16))
    sp = txp.build_sharded_plan(pk, n_shards, axis)
    vals = txp.pack_plan_data(sp, pk.data)
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 256).astype(
        np.float32))
    whole = txp.plan_linear(x, vals, sp)
    v = sp.vrows_per_shard
    parts, missing = [], False
    for s in range(n_shards):
        lp = txp.local_plan(sp, s)
        assert lp.spilled and lp.n_vrows == v
        local = vals[s * v:(s + 1) * v]
        if axis == "out":
            parts.append(txp.plan_linear(x, local, lp))
        else:
            k = lp.shape[1]
            parts.append(txp._plan_fwd_f32(x[:, s * k:(s + 1) * k], local,
                                           lp))
        rows = np.unique(np.asarray(lp.row_of_vrow)[np.asarray(lp.vrow)])
        if len(rows) < lp.n_brows:
            missing = True
            with pytest.raises(AssertionError, match="every output block"):
                txp.plan_kernel_sequence(lp)
    got = torch.cat(parts, dim=1) if axis == "out" else sum(parts)
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), x.numpy() @ w.T, atol=1e-4)
    assert missing or axis == "out"


# --------------------------------------------------------------------------
# the sharding rules, every leaf of every registry config at full width
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_param_equals_reference(arch, mesh_i):
    jm, tm = _meshes(mesh_i)
    shapes = _param_shapes(arch)
    for mode in ("train", "inference"):
        for name, shape in shapes.items():
            want = _norm(jsh.spec_for_param(name, shape, jm, mode),
                         len(shape))
            got = tsh.spec_for_param(name, shape, tm, mode)
            assert got == want, (mode, name, shape)
    # the tree form: param_shardings over a tree of (meta) tensors
    tree = {"embed": {"w": torch.empty((4096, 64), device="meta")},
            "norm": {"scale": torch.empty((64,), device="meta")}}
    assert tsh.param_shardings(tree, tm, "inference") == {
        "embed": {"w": tsh.spec_for_param("embed/w", (4096, 64), tm,
                                          "inference")},
        "norm": {"scale": (None,)}}


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", DECODERS)
def test_spec_for_cache_equals_reference(arch, mesh_i):
    """Dense caches (and paged pools for the LM families): the reference's
    ``cache_shardings`` over its abstract cache against the port's rules on
    the port's own cache tree (meta device, same names and shapes)."""
    jm, tm = _meshes(mesh_i)
    cfg = get_config(arch)
    for paged in ((False, True) if arch in LM_ARCHS else (False,)):
        jc = _j_cache(arch, paged)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            japi.cache_shardings(jc, jm),
            is_leaf=lambda x: isinstance(x, NamedSharding))
        want = {jsh._leaf_name(p): s.spec for p, s in flat}
        shapes = _cache_shapes(arch, paged)
        if arch in LM_ARCHS:
            tc = tlm.init_cache(cfg, 8, 64, paged=PagedLayout(16, 32)
                                if paged else None, device="meta")
            own = {tsh.leaf_name(p): tuple(x.shape)
                   for p, x in flatten_with_path(tc)}
            assert own == shapes
            specs = tsh.cache_shardings(tc, tm)
            got = {tsh.leaf_name(p): _spec_of(specs, p)
                   for p, _ in flatten_with_path(tc)}
        else:
            got = {n: tsh.spec_for_cache(n, s, tm) for n, s in shapes.items()}
        assert set(got) == set(want)
        for name, spec in got.items():
            assert spec == _norm(want[name], len(shapes[name])), name


def _spec_of(specs, path):
    for k in path:
        specs = specs[k]
    return specs


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
def test_batch_shardings_equal_reference(mesh_i):
    jm, tm = _meshes(mesh_i)
    shapes = {"tokens": (64, 128), "labels": (64, 128), "one": (1, 4096),
              "odd": (3, 7), "mm_embeds": (32, 256, 1024),
              "frames": (1, 1500, 512)}
    jb = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jsh.batch_shardings(jb, jm),
        is_leaf=lambda x: isinstance(x, NamedSharding))
    want = {jsh._leaf_name(p): s.spec for p, s in flat}
    got = tsh.batch_shardings({k: torch.empty(v, device="meta")
                               for k, v in shapes.items()}, tm)
    for k, v in shapes.items():
        assert got[k] == _norm(want[k], len(v)), k
        # the sequence-parallel branch (one row, S over the dp axes),
        # named as the reference's spec takes it
        ref = _norm(want[k], len(v))
        assert tsh.is_sequence_parallel(got[k]) == (
            ref[0] is None and ref[1] is not None), k
    assert tsh.replicated(tm) == tuple(jsh.replicated(jm).spec)


def test_mesh_helpers_equal_reference():
    from repro.launch import mesh as jmesh
    for shape, axes in MESHES:
        jm, tm = AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)
        assert tmesh.dp_axes(tm) == jmesh.dp_axes(jm)
        for names in ("data", "model", ("pod", "data"), ("data", "model")):
            assert tmesh.axis_size(tm, names) == jmesh.axis_size(
                type("M", (), {"axis_names": jm.axis_names,
                               "devices": np.zeros(shape)})(), names)
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}


def test_local_shard_cuts_a_ranks_block():
    m = tmesh.make_mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 12).reshape(8, 12)
    spec = ("data", "model")
    got = tsh.local_shard(x, spec, m, {"data": 1, "model": 2})
    torch.testing.assert_close(got, x[4:8, 6:9])
    assert tsh.shard_shape((8, 12), spec, m) == (4, 3)
    both = tsh.local_shard(x, (("data", "model"), None), m,
                           {"data": 1, "model": 3})
    torch.testing.assert_close(both, x[7:8])
    assert tsh.local_shard(x, (None, None), m, {"data": 1}) is x
    with pytest.raises(ValueError, match="does not divide"):
        tsh.local_shard(torch.zeros(6, 3), (None, "model"), m, {"model": 0})


# --------------------------------------------------------------------------
# export, codec, autotune, spec
# --------------------------------------------------------------------------

def test_shard_axis_for_equals_reference():
    for proj in ("wq", "wk", "wv", "wqkv", "wo", "wi", "wg"):
        assert texport.shard_axis_for(proj) == jexport.shard_axis_for(proj)


def _codec_packs(quant: bool):
    """The same packs in both packages: a sharded 'out' plan, a sharded
    'in' plan (shared by two keys), a replicated plan and, with ``quant``,
    an int8 QuantPlan over a sharded plan."""
    out = {}
    for side, pack_fn, xp in (("j", j_pack, jxp), ("t", pack_bsr, txp)):
        w1 = _weight(1, 128, 64, (16, 16), 0.5)
        w2 = _weight(2, 64, 128, (16, 16), 0.5)
        w3 = _weight(3, 48, 64, (16, 16), 0.5)
        p1 = xp.build_sharded_plan(pack_fn(w1, (16, 16)), 4, "out")
        p2 = xp.build_sharded_plan(pack_fn(w2, (16, 16)), 4, "in")
        p3 = xp.plan_for_pack(pack_fn(w3, (16, 16)))
        packs = {"a/wqkv": p1, "a/wo": p2, "b/wo": p2, "c/wq": p3}
        if quant:
            data = (jnp.asarray if side == "j" else torch.from_numpy)(
                pack_fn(w1, (16, 16)).data)
            packs["d/wi"], _ = xp.quantize_for_plan(p1, data, "int8",
                                                    backend="plan")
        out[side] = packs
    return out["j"], out["t"]


@pytest.mark.parametrize("quant", [False, True], ids=["plan", "int8"])
def test_codec_arrays_and_metas_equal_reference(quant):
    jpacks, tpacks = _codec_packs(quant)
    ja, jm = jser.packs_to_arrays(jpacks)
    ta, tm = tser.packs_to_arrays(tpacks)
    assert jm == tm
    assert set(ja) == set(ta)
    for k in ja:
        a, b = np.asarray(ja[k]), np.asarray(ta[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    back = tser.packs_from_arrays(tm, ta, PatternRegistry())
    assert set(back) == set(tpacks)
    for key, pk in tpacks.items():
        got = back[key]
        plan = pk.plan if isinstance(pk, txp.QuantPlan) else pk
        gplan = got.plan if isinstance(got, txp.QuantPlan) else got
        assert type(gplan) is type(plan) and gplan.fingerprint == \
            plan.fingerprint
        if isinstance(plan, txp.ShardedPlan):
            assert (gplan.n_shards, gplan.shard_axis,
                    gplan.shard_fingerprints) == (
                plan.n_shards, plan.shard_axis, plan.shard_fingerprints)
    assert back["a/wo"] is back["b/wo"]
    # the reference reads the port's arrays back too
    jback = jser.packs_from_arrays(tm, ta, JRegistry())
    assert {k: type(v).__name__ for k, v in jback.items()} == \
        {k: type(v).__name__ for k, v in back.items()}


def _sans_device(key):
    parts = key.split(":")
    i = parts.index("cpu")
    return ":".join(parts[:i] + parts[i + 2:])


@pytest.mark.parametrize("shard", [(4, "out"), (4, "in"), (2, "out"),
                                   (8, "in"), (3, "out")])
def test_autotune_shard_keys_and_subpack_equal_reference(shard, tmp_path,
                                                         monkeypatch):
    """Stub-mode choices keyed with the shard layout and sub-shape (an
    indivisible pattern keyed unsharded), their stub costs computed on the
    most occupied shard's sub-pattern -- all equal to the reference's."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    w = _weight(5, 128, 128, (16, 16), 0.3)
    jpk, tpk = j_pack(w, (16, 16)), pack_bsr(w, (16, 16))
    cands = ("dense", "plan")
    jc = jat.choose_backend(jpk, m=32, stub=True, candidates=cands,
                            shard=shard,
                            cache=jat.AutotuneCache(str(tmp_path / "j")))
    tc = tat.choose_backend(tpk, m=32, stub=True, candidates=cands,
                            shard=shard, device=CPU,
                            cache=tat.AutotuneCache(str(tmp_path / "t")))
    assert _sans_device(tc.key) == _sans_device(jc.key)
    assert tc.backend == jc.backend and tc.costs == jc.costs
    if txp.shard_divisible(tpk, *shard):
        js, ts = jat.shard_subpack(jpk, *shard), tat.shard_subpack(tpk,
                                                                   *shard)
        assert txp.kernel_pattern_fingerprint(ts) == \
            jxp.kernel_pattern_fingerprint(js)
        np.testing.assert_array_equal(np.asarray(ts.data),
                                      np.asarray(js.data))


def test_spec_validation():
    """``test_sharded_serving.py``'s cases, and each spec's dict round trip
    read by the other package."""
    with pytest.raises(ValueError):
        ServingSpec(partition="nope")
    with pytest.raises(ValueError):            # tp mesh needs data == 1
        ServingSpec(mesh_shape=(2, 4), partition="tp")
    with pytest.raises(ValueError):            # bsr has no sharded layout
        ServingSpec(mesh_shape=(1, 8), partition="tp", backend="bsr")
    with pytest.raises(ValueError):            # neither has plan_pallas
        ServingSpec(mesh_shape=(1, 4), partition="tp",
                    backend="plan_pallas")
    with pytest.raises(ValueError):            # page ids are one space
        ServingSpec(mesh_shape=(2, 1), partition="dp", kv_layout="paged")
    spec = ServingSpec(mesh_shape=(2, 4), partition="tp+dp")
    assert spec.model_shards == 4 and spec.data_shards == 2
    rt = ServingSpec.from_dict(spec.to_dict())
    assert rt == spec and rt.mesh_shape == (2, 4)
    assert JSpec.from_dict(spec.to_dict()).mesh_shape == (2, 4)
    dp = ServingSpec(mesh_shape=(4, 1), partition="dp", backend="plan_pallas")
    assert dp.model_shards == 1 and dp.data_shards == 4


MESH_FAMILIES = ("pixtral_12b", "qwen3_moe_235b_a22b", "deepseek_v2_lite_16b",
                 "mamba2_780m", "recurrentgemma_9b", "whisper_base")


@pytest.mark.parametrize("arch", MESH_FAMILIES)
def test_every_family_prepares_on_a_mesh(arch):
    """Every registry family prepares on a (1, 2) mesh (``place=False``:
    the sharded export on one process) and gets its shard objects on a
    rank of it: the vlm and moe families' packs are ShardedPlans; mamba2
    has no packs (no attention or FFN) and its ``in_proj`` / ``out_proj``
    are column / row DenseShards beside its SSD heads and conv channels;
    recurrentgemma's FFN and local-attention packs are ShardedPlans, its
    RG-LRU projections DenseShards with the width shard; whisper, served
    with ``prune="none"`` as the reference serves it, has no packs and its
    encoder, decoder and cross-attention heads shard."""
    from repro_torch.models.api import init_model
    from repro_torch.models import common as tcommon
    from repro_torch.serving import prepare_servable
    from repro_torch.serving import servable as tservable

    class Rank(tmesh.AbstractMesh):
        def coord(self, axis):
            return {"model": 1}.get(axis, 0)
    cfg = get_config(arch, smoke=True)
    spec = ServingSpec(tile=(16, 16), sparsity=0.5,
                       prune="none" if arch == "whisper_base" else "oneshot",
                       mesh_shape=(1, 2))
    sv = prepare_servable(init_model(0, cfg, device="cpu"), cfg, spec,
                          device="cpu", place=False)
    mesh = Rank((1, 2), ("data", "model"))
    specs = tservable.serving_param_shardings(sv.params, sv.packs, mesh)
    run = tservable._exec_packs(sv.packs, sv.params, specs, cfg, mesh)
    kinds = {k: type(v).__name__ for k, v in run.items()
             if k not in sv.packs}
    assert all(isinstance(p, txp.ShardedPlan) for p in sv.packs.values())
    if arch in ("mamba2_780m", "whisper_base"):
        assert not sv.packs
    else:
        assert sv.packs
    want = {
        "mamba2_780m": {"blocks/0/mixer/in_proj": "DenseShard",
                        "blocks/0/mixer/out_proj": "DenseShard",
                        "blocks/0/mixer/heads": "SSDHeadShard",
                        "blocks/0/mixer/conv": "ChannelShard"},
        "recurrentgemma_9b": {f"blocks/{i}/mixer/{k}": "DenseShard"
                              for i in (0, 1) for k in (
                                  "in_x", "in_gate", "w_a", "w_i", "out")},
        "whisper_base": {f"{s}/{a}/heads": "HeadShard" for s, a in (
            ("enc_layers", "attn"), ("dec_layers", "attn"),
            ("dec_layers", "xattn"))},
    }.get(arch, {})
    if arch == "recurrentgemma_9b":
        want.update({f"blocks/{i}/mixer/width": "ChannelShard"
                     for i in (0, 1)})
    assert {k: kinds.get(k) for k in want} == want
    if arch == "mamba2_780m":
        assert run["blocks/0/mixer/in_proj"].axis == "out"
        assert run["blocks/0/mixer/out_proj"].axis == "in"
    if arch == "whisper_base":
        assert isinstance(run["dec_layers/xattn/wk"], tcommon.DenseShard)


def _model_entries_allowed(name, shape, spec):
    """Where a serving leaf may carry "model": a linear weight's row or
    column dim (``.../w``: projections, the embedding and head tables),
    BERT's ``pos`` rows, a routed-expert tensor's E axis."""
    from repro_torch.serving.servable import _routed_expert
    dims = {d for d, e in enumerate(spec) if e == "model"}
    if not dims:
        return True
    if _routed_expert(name, len(shape)):
        return dims == {len(shape) - 3}
    if name.endswith("/w"):
        return dims <= {len(shape) - 2, len(shape) - 1}
    return name == "pos" and dims == {0}


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)],
                         ids=["1x2", "1x4", "2x2"])
def test_serving_specs_give_model_only_where_consumed(mesh_shape):
    """For every registry config at full width (abstract shapes, nothing
    allocated): a mesh servable's leaf specs put "model" only on a linear
    weight's rows or columns, the embedding / head tables, BERT's ``pos``
    and routed experts' E axis -- never on a stacked vector such as the
    (n_periods, d) norm scales, which ``spec_for_param``'s generic 2-D
    rule cuts over their period axis once they exceed 4096 elements."""
    from repro_torch.serving.servable import _leaf_spec
    mesh = tmesh.make_mesh(mesh_shape, ("data", "model"))
    cut_by_rule, experts = [], 0
    for arch in ARCHS:
        for name, shape in _param_shapes(arch).items():
            spec = _leaf_spec(name, shape, {}, mesh)
            assert "data" not in spec, (arch, name)
            assert _model_entries_allowed(name, shape, spec), \
                (arch, name, shape, spec)
            rule = tsh.spec_for_param(name, shape, mesh, mode="inference")
            if "norm" in name and "model" in rule:
                cut_by_rule.append((arch, name))
                assert "model" not in spec
            experts += "model" in spec and len(shape) >= 3 \
                and not name.endswith("/w")
    # the rule would cut chatglm3's, internlm2's and pixtral's stacked
    # norm scales (the fault the servable repairs); MoE experts shard
    assert {a for a, _ in cut_by_rule} >= {"chatglm3_6b", "internlm2_20b",
                                           "pixtral_12b"}
    assert experts > 0


def test_local_cache_allocation_and_shard_cache():
    """``init_cache(mesh=)`` allocates each leaf's ``spec_for_cache`` shard
    (slots over "data", KV heads over "model"; pools shard heads only) and
    ``shard_cache`` cuts a whole cache to the same shapes and values."""
    from repro_torch.models import api as tapi

    class Rank(tmesh.AbstractMesh):
        def coord(self, axis):
            return {"data": 1, "model": 1}.get(axis, 0)
    cfg = get_config("deepseek_7b", smoke=True)       # 4 KV heads, global
    params = {"embed": {"w": torch.zeros(4, 4)}}
    m = Rank((2, 2), ("data", "model"))
    for paged in (None, PagedLayout(8, 8)):
        whole = tapi.init_cache(params, cfg, 4, 32, paged=paged)
        for x in whole["blocks"][0]["mix"].values():
            x.copy_(torch.arange(x.numel()).reshape(x.shape).to(x.dtype))
        local = tapi.init_cache(params, cfg, 4, 32, paged=paged, mesh=m)
        cut = tapi.shard_cache(whole, cfg, m)
        for (p, a), (_, b) in zip(flatten_with_path(local),
                                  flatten_with_path(cut)):
            assert a.shape == b.shape and a.dtype == b.dtype, p
        k = cut["blocks"][0]["mix"]["k_pages" if paged else "k"]
        kw = whole["blocks"][0]["mix"]["k_pages" if paged else "k"]
        if paged:
            torch.testing.assert_close(k, kw[:, :, :, 2:4])
        else:
            torch.testing.assert_close(k, kw[:, 2:4, :, 2:4])
        pm = local["blocks"][0]["mix"]["pos_map"]
        assert bool((pm == -1).all())


def test_serving_step_builders_match_jax():
    """``make_prefill_step`` / ``make_serve_step``: greedy tokens equal the
    reference's on the same smoke weights."""
    from repro.launch import steps as jsteps
    from repro.models import init_model as j_init

    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import api as tapi
    cfg, jcfg = get_config("deepseek_7b", smoke=True), \
        j_config("deepseek_7b", smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 7))
    got = tsteps.make_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(
        toks)})
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    assert got.tolist() == np.asarray(want).tolist()
    tok = toks[:, :1].astype(np.int32)
    jc = japi.init_cache(jp, jcfg, 2, 16)
    tc = tapi.init_cache(tp, cfg, 2, 16)
    jn, _ = jsteps.make_serve_step(jcfg)(jp, jc, jnp.asarray(tok), 0)
    tn, _ = tsteps.make_serve_step(cfg)(tp, tc, torch.from_numpy(tok), 0)
    assert tn.dtype == torch.int32 and tn.tolist() == np.asarray(jn).tolist()
