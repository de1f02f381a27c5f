"""Quantized sparse packs and the masked negative control in the port
against the JAX reference on the CPU: the quantization bytes (int8 and fp8,
'block' and 'row' scales, the spill edge, all-zero blocks), the plain
dequant-fused product and its dX, the plain versions of kernels K6
(``plan_dds_q_plain``) and K7 (``masked_matmul_plain``) against the
reference's Pallas kernels in interpret mode, the export's quantized values
and stats, ``Servable.forward`` for every new backend, artifacts crossing
both ways, and engine greedy tokens over int8 packs. Plus a serve with JAX
blocked."""
import dataclasses
import io
import os
import subprocess
import sys
import textwrap
import types
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core.pattern_reuse import PatternRegistry as JRegistry  # noqa: E402
from repro.core.sparsity import prune_to_sparsity  # noqa: E402
import importlib  # noqa: E402
jbm = importlib.import_module("repro.kernels.bsr_matmul")
from repro.kernels import exec_plan as jxp  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import load_servable as j_load  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402
from repro.serving.export import export_params as j_export  # noqa: E402
from repro.serving.servable import Servable as JServable  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pattern_reuse import PatternRegistry  # noqa: E402
from repro_torch.kernels import bsr_matmul as tbm  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels.autotune import MaskedPack  # noqa: E402
from repro_torch.serving import (ServingSpec, export_params,  # noqa: E402
                                 load_servable, prepare_servable)
from repro_torch.serving.servable import Servable, pinned_chooser  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 results of the two packages: same math, sums in another order
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread_and_own_cache(tmp_path, monkeypatch):
    """Small tensors: one intra-op thread keeps these tests from
    oversubscribing the cores parallel workers share; any autotune winner
    goes to a cache of the test's own."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weight(n, k, tile, sparsity, seed):
    rng = np.random.RandomState(seed)
    w = jnp.asarray(rng.randn(n, k).astype(np.float32))
    return np.asarray(prune_to_sparsity(w, tile, sparsity)[0])


def _plans(w, tile, pad=0):
    """(JAX plan, its row-grouped values, port plan, port values)."""
    jpk = jbm.pack_bsr(w, tile)
    tpk = tbm.pack_bsr(w, tile)
    if pad:
        jpk = jbm.pack_bsr(w, tile, nnzt=jpk.real_nnzt + pad)
        tpk = tbm.pack_bsr(w, tile, nnzt=tpk.real_nnzt + pad)
    jplan, tplan = jxp.plan_for_pack(jpk), txp.plan_for_pack(tpk)
    return (jplan, jxp.pack_plan_data(jplan, jpk.data), tplan,
            txp.pack_plan_data(tplan, tpk.data))


def _raw(a):
    """Bytes of a JAX array or a tensor, fp8 included."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.float8_e4m3fn:
            t = t.view(torch.uint8)
        return t.numpy().tobytes()
    return np.asarray(a).tobytes()


def _quant_both(jd, td, qdtype, gran):
    jq, js = jxp.quantize_plan_values(jd, qdtype, gran)
    tq, ts = txp.quantize_plan_values(td, qdtype, gran)
    return jq, js, tq, ts


# --------------------------------------------------------------------------
# quantization bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("tile,n,k,sparsity,seed", [
    ((16, 16), 64, 64, 0.5, 0),      # square tile below the block threshold
    ((32, 1), 64, 16, 0.5, 1),       # skinny tile -> 'row' scales
    ((16, 64), 32, 256, 0.1, 3),     # the (16, 64) spill edge
    ((128, 128), 256, 256, 0.5, 2),  # the serving default
])
def test_quantize_plan_values_byte_identical(qdtype, tile, n, k, sparsity,
                                             seed):
    jplan, jd, tplan, td = _plans(_weight(n, k, tile, sparsity, seed), tile)
    gran = txp.quant_granularity(tile)
    assert gran == jxp.quant_granularity(tile)
    jq, js, tq, ts = _quant_both(jd, td, qdtype, gran)
    assert tq.dtype == (torch.int8 if qdtype == "int8"
                        else torch.float8_e4m3fn)
    assert tuple(tq.shape) == tuple(jq.shape)
    assert tuple(ts.shape) == tuple(js.shape) and ts.dtype == torch.float32
    assert _raw(tq) == _raw(jq) and _raw(ts) == _raw(js)
    rt_t = txp.dequantize_plan_values(tq, ts).numpy()
    rt_j = np.asarray(jxp.dequantize_plan_values(jq, js))
    assert rt_t.tobytes() == rt_j.tobytes()


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_zero_blocks_quantize_exact(qdtype):
    """All-zero groups get scale 1.0 and dequantize to exact zeros, in both
    packages, byte for byte."""
    d = np.zeros((3, 2, 16, 16), np.float32)
    d[1, 0] = np.random.RandomState(4).randn(16, 16)
    jq, js, tq, ts = _quant_both(jnp.asarray(d), torch.from_numpy(d),
                                 qdtype, "block")
    assert _raw(tq) == _raw(jq) and _raw(ts) == _raw(js)
    s = ts.numpy()
    assert np.all(s[[0, 2]] == 1.0) and s[1, 1] == 1.0
    rt = txp.dequantize_plan_values(tq, ts).numpy()
    assert np.all(rt[[0, 2]] == 0.0) and np.all(rt[1, 1] == 0.0)


# --------------------------------------------------------------------------
# the plain dequant-fused product and its gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("tile,sparsity", [((16, 16), 0.5), ((16, 64), 0.1),
                                           ((32, 1), 0.5)])
def test_plan_q_linear_forward_and_dx_match_jax(qdtype, tile, sparsity):
    """Forward and dX of ``plan_q_linear`` against the reference's
    custom_vjp; the quantized values' and scales' gradients are exactly
    zero."""
    jplan, jd, tplan, td = _plans(_weight(64, 128, tile, sparsity, 1), tile)
    gran = txp.quant_granularity(tile)
    jq, js, tq, ts = _quant_both(jd, td, qdtype, gran)
    x = np.random.RandomState(2).randn(8, 128).astype(np.float32)

    def jloss(x_):
        return jnp.sum(jxp.plan_q_linear(x_, jq, js, jplan) ** 2)
    y_j = np.asarray(jxp.plan_q_linear(jnp.asarray(x), jq, js, jplan))
    gx_j = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = ts.clone().requires_grad_(True)
    qt = tq.clone().requires_grad_(qdtype == "fp8")
    y = txp.plan_q_linear(xt, qt, st, tplan)
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=TOL, rtol=TOL)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, atol=1e-3, rtol=TOL)
    assert st.grad is not None and float(st.grad.abs().max()) == 0.0
    if qdtype == "fp8":
        assert float(qt.grad.float().abs().max()) == 0.0


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_plan_q_linear_pallas_is_forward_only(qdtype):
    jplan, jd, tplan, td = _plans(_weight(32, 64, (16, 16), 0.5, 9),
                                  (16, 16))
    tq, ts = txp.quantize_plan_values(td, qdtype, "block")
    x = torch.zeros((4, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        txp.plan_q_linear_pallas(x, tq, ts, tplan)
    with torch.no_grad():
        y = txp.plan_q_matmul_pallas(x.reshape(2, 2, 64), tq, ts, tplan)
    assert tuple(y.shape) == (2, 2, 32)


# --------------------------------------------------------------------------
# the plain versions of K6 and K7 against the reference's Pallas kernels
# --------------------------------------------------------------------------

def _spill_weight():
    rng = np.random.RandomState(3)
    w = np.zeros((128, 1024), np.float32)
    w[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    return w


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("case,act,bias", [
    ("random (16,16)", "gelu", True),
    ("(32,1) row scales", "relu", True),
    ("spill edge (16,64)", "silu", True),
    ("padded nnzt +5 (16,32)", None, False),
])
def test_plan_dds_q_plain_matches_jax_interpret(qdtype, case, act, bias):
    w, tile, pad = {
        "random (16,16)": (_weight(64, 96, (16, 16), 0.5, 5), (16, 16), 0),
        "(32,1) row scales": (_weight(64, 64, (32, 1), 0.6, 6), (32, 1), 0),
        "spill edge (16,64)": (_spill_weight(), (16, 64), 0),
        "padded nnzt +5 (16,32)": (_weight(96, 128, (16, 32), 0.6, 7),
                                   (16, 32), 5),
    }[case]
    jplan, jd, tplan, td = _plans(w, tile, pad)
    if case.startswith("spill"):
        assert tplan.spilled
    gran = txp.quant_granularity(tile)
    jq, js, tq, ts = _quant_both(jd, td, qdtype, gran)
    n, k = w.shape
    rng = np.random.RandomState(8)
    x = rng.randn(20, k).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    want = np.asarray(jbm.plan_dds_q(
        jnp.asarray(x), jq, js, jxp.plan_kernel_sequence(jplan), n=n,
        tile=tile, granularity=gran, act=act, interpret=True,
        bias=None if b is None else jnp.asarray(b)))
    before = tbm.plan_dds_q.launches
    got = tbm.plan_dds_q(torch.from_numpy(x), tq, ts,
                         txp.plan_schedule(tplan), n=n, tile=tile,
                         granularity=gran, act=act,
                         bias=None if b is None else torch.from_numpy(b))
    assert tbm.plan_dds_q.launches == before      # the plain version ran
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=1e-5)
    # and through the exec-plan entry with the same epilogue
    with torch.no_grad():
        y2 = txp.plan_q_linear_pallas(
            torch.from_numpy(x), tq, ts, tplan, act=act,
            bias=None if b is None else torch.from_numpy(b))
    assert torch.equal(y2, got)


@pytest.mark.parametrize("m,n,k,tile,density", [
    (32, 128, 128, (32, 64), 0.4), (64, 256, 128, (64, 128), 0.25),
    (100, 128, 384, (32, 128), 0.5), (16, 512, 256, (128, 128), 0.1),
    (40, 64, 64, (32, 1), 0.3)])
def test_masked_matmul_plain_matches_jax_interpret(m, n, k, tile, density):
    """Non-zero values in the masked tiles: both skip them."""
    rng = np.random.RandomState(3)
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    mask[0, 0] = False
    x = rng.randn(m, k).astype(np.float32)
    want = np.asarray(jbm.masked_matmul(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(mask), tile=tile,
                                        interpret=True))
    before = tbm.masked_matmul.launches
    got = tbm.masked_matmul(torch.from_numpy(x), torch.from_numpy(w), mask,
                            tile=tile).numpy()
    assert tbm.masked_matmul.launches == before
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-5)
    ref = x @ (w * np.kron(mask, np.ones(tile, np.float32))).T
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-5)
    assert np.abs(got - x @ w.T).max() > 1e-2      # the skipped tiles
    with pytest.raises(ValueError):
        tbm.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          mask[:-1], tile=tile)


# --------------------------------------------------------------------------
# export, servable, stats
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bert():
    jcfg = jax_config("bert_base", smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 24))
    return jcfg, get_config("bert_base", smoke=True), jp, tp, toks


def _spec_kw(backend, union=True, **kw):
    return dict(dict(tile=(16, 16), sparsity=0.5, prune="tied",
                     fuse_qkv=True, cross_layer_union=union,
                     backend=backend), **kw)


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves_by_path(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves_by_path(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("union", [True, False])
def test_export_quant_values_and_stats_match_jax(bert, qdtype, union):
    """The same pruned weights export to byte-identical qvalues and scales,
    the same per-group quantization meta and the same quant_stats()."""
    jcfg, cfg, jp, tp, toks = bert
    kw = _spec_kw("plan", union, pack_quant=qdtype)
    js = j_prepare(jp, jcfg, JSpec(**kw))
    ts = prepare_servable(tp, cfg, ServingSpec(**kw), device="cpu")
    assert set(ts.packs) == set(js.packs)
    for key, pk in ts.packs.items():
        assert isinstance(pk, txp.QuantPlan)
        assert pk.fingerprint == js.packs[key].fingerprint
    jl, tl = _leaves_by_path(js.params), _leaves_by_path(ts.params)
    assert set(jl) == set(tl)
    quant = [p for p in tl if p.endswith("/scale")
             and tl.get(p[:-len("scale")] + "w") is not None
             and tl[p[:-len("scale")] + "w"].dtype in tbm.QUANT_VALUE_DTYPES]
    assert len(quant) == len(ts.packs)
    for path in quant + [p[:-len("scale")] + "w" for p in quant]:
        assert _raw(tl[path]) == _raw(jl[path]), path
    j_meta = {k: v["quant"] for k, v in js.export_stats.items()
              if isinstance(v, dict) and "quant" in v}
    t_meta = {k: v["quant"] for k, v in ts.export_stats.items()
              if isinstance(v, dict) and "quant" in v}
    assert t_meta == j_meta and t_meta
    assert ts.quant_stats() == js.quant_stats()
    assert ts.stats()["quant"] == js.stats()["quant"]
    assert ts.stats()["padded_flop_ratio"] == js.stats()["padded_flop_ratio"]


_JAX_SERVED = {}


def _jax_served(bert, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_SERVED:
        jcfg, _, jp, _, toks = bert
        js = j_prepare(jp, jcfg, JSpec(**kw))
        _JAX_SERVED[key] = js, np.asarray(js.forward(jnp.asarray(toks)))
    return _JAX_SERVED[key]


@pytest.mark.parametrize("backend,quant", [
    ("plan", "int8"), ("plan", "fp8"), ("plan_pallas", "int8"),
    ("plan_pallas", "fp8"), ("bsr", "none")])
def test_servable_forward_matches_jax(bert, backend, quant):
    jcfg, cfg, jp, tp, toks = bert
    kw = _spec_kw(backend, pack_quant=quant)
    js, want = _jax_served(bert, **kw)
    ts = prepare_servable(tp, cfg, ServingSpec(**kw), device="cpu")
    got = ts.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    kinds = {type(p).__name__ for p in ts.packs.values()}
    assert kinds == {type(p).__name__ for p in js.packs.values()}
    if quant != "none":
        assert all(p.backend == backend for p in ts.packs.values())


def _pinned(backend):
    def chooser(pack, shard=None):
        return types.SimpleNamespace(backend=backend, cache_hit=False,
                                     mode="pinned")
    return chooser


def _choice_servables(bert, backend, union=True):
    """JAX and port servables whose every pattern the export pins to
    ``backend`` (as prepare_servable pins 'plan_pallas')."""
    jcfg, cfg, jp, tp, toks = bert
    spec_kw = _spec_kw("auto", union, prune="none")
    jpruned = j_prepare(jp, jcfg, JSpec(**_spec_kw("dense"))).params
    reg = JRegistry()
    jsp, jpk, jst = j_export(jpruned, jcfg, tile=(16, 16), fuse_qkv=True,
                             cross_layer_union=union, registry=reg,
                             backend_chooser=_pinned(backend))
    js = JServable(jsp, jcfg, JSpec(**spec_kw), jpk, reg, export_stats=jst)
    tpruned = params_from_numpy(jax.tree.map(np.asarray, jpruned))
    treg = PatternRegistry()
    tsp, tpk, tst = export_params(tpruned, cfg, tile=(16, 16), fuse_qkv=True,
                                  cross_layer_union=union, registry=treg,
                                  backend_chooser=pinned_chooser(backend),
                                  device="cpu")
    ts = Servable(tsp, cfg, ServingSpec(**spec_kw), tpk, treg, "cpu",
                  export_stats=tst)
    return js, ts


@pytest.mark.parametrize("backend,union", [("masked", True),
                                           ("masked", False),
                                           ("gather", True),
                                           ("pallas", False)])
def test_chooser_pinned_backends_match_jax(bert, backend, union):
    """The masked negative control (and two BackendChoice arms) through
    ``export_params(backend_chooser=...)``: the same packs, fingerprints
    and stats, and forward parity with JAX."""
    from repro.serving.serialize import pattern_key as j_pattern_key
    from repro_torch.serving.serialize import pattern_key
    jcfg, cfg, jp, tp, toks = bert
    js, ts = _choice_servables(bert, backend, union)
    assert set(ts.packs) == set(js.packs)
    for key, pk in ts.packs.items():
        assert pattern_key(pk) == j_pattern_key(js.packs[key])
        if backend == "masked":
            assert isinstance(pk, MaskedPack)
            np.testing.assert_array_equal(pk.tile_mask,
                                          js.packs[key].tile_mask)
    assert ts.stats()["autotune"] == js.stats()["autotune"]
    want = np.asarray(js.forward(jnp.asarray(toks)))
    got = ts.forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


# --------------------------------------------------------------------------
# artifacts both ways
# --------------------------------------------------------------------------

def _jax_artifact(bert, kind, path):
    """A servable of pack kind ``kind`` saved by JAX; returns its logits."""
    jcfg, cfg, jp, tp, toks = bert
    if kind in ("quant_int8", "quant_fp8"):
        js, want = _jax_served(bert, **_spec_kw(
            "plan_pallas", pack_quant=kind.split("_")[1]))
    elif kind == "bsr":
        js, want = _jax_served(bert, **_spec_kw("bsr"))
    else:
        js, _ = _choice_servables(bert, {"masked": "masked",
                                         "choice": "rowpack"}[kind])
        want = np.asarray(js.forward(jnp.asarray(toks)))
    js.save(path)
    return js, want


@pytest.mark.parametrize("kind", ["quant_int8", "quant_fp8", "masked",
                                  "choice", "bsr"])
def test_jax_saved_servables_load_into_the_port(bert, kind, tmp_path):
    jcfg, cfg, jp, tp, toks = bert
    js, want = _jax_artifact(bert, kind, str(tmp_path / "j"))
    ts = load_servable(str(tmp_path / "j"), device="cpu")
    assert {k: type(p).__name__ for k, p in ts.packs.items()} == \
        {k: type(p).__name__ for k, p in js.packs.items()}
    got = ts.forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    if kind.startswith("quant"):
        assert ts.quant_stats() == js.quant_stats()
        q = next(v for k, v in _leaves_by_path(ts.params).items()
                 if k.endswith("/w") and v.dtype != torch.float32)
        assert q.dtype == (torch.int8 if kind.endswith("int8")
                           else torch.float8_e4m3fn)


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("kind", ["quant_int8", "quant_fp8", "masked",
                                  "choice", "bsr"])
def test_port_saved_servables_match_the_reference_artifact(bert, kind,
                                                           tmp_path):
    """The port's arrays.npz holds the reference's bytes member for member
    (fp8 leaves under the header numpy writes for ml_dtypes arrays) and
    the JAX package loads the port's artifact -- except fp8, which the
    reference's own store cannot restore (``astype`` from raw bytes)."""
    jcfg, cfg, jp, tp, toks = bert
    js, want = _jax_artifact(bert, kind, str(tmp_path / "j"))
    ts = load_servable(str(tmp_path / "j"), device="cpu")
    ts.save(str(tmp_path / "t"))
    step = "step_000000000/arrays.npz"
    assert _npz_members(tmp_path / "t" / step) == \
        _npz_members(tmp_path / "j" / step)
    again = load_servable(str(tmp_path / "t"), device="cpu")
    assert torch.equal(again.forward(torch.from_numpy(toks)),
                       ts.forward(torch.from_numpy(toks)))
    if kind == "quant_fp8":
        with pytest.raises(ValueError):
            j_load(str(tmp_path / "j"))
        return
    back = j_load(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(back.forward(jnp.asarray(toks))),
                               want, atol=1e-6)


def test_fp8_leaf_header_is_the_ml_dtypes_one():
    from repro_torch.checkpoint.store import _npy_bytes, to_host
    t = torch.tensor([1.0, -2.5, 448.0]).to(torch.float8_e4m3fn)
    buf = io.BytesIO()
    np.lib.format.write_array(
        buf, np.asarray(jnp.array([1.0, -2.5, 448.0], jnp.float8_e4m3fn)))
    assert _npy_bytes(to_host(t)) == buf.getvalue()


# --------------------------------------------------------------------------
# engine greedy tokens over int8 packs
# --------------------------------------------------------------------------

def _scaled(jp):
    def one(path, x):
        names = [str(getattr(k, "key", "")) for k in path]
        if ("attn" in names or "ffn" in names) and not any(
                "norm" in n for n in names):
            return x * 20.0
        return x
    return jax.tree_util.tree_map_with_path(one, jp)


def _greedy(sv, vocab):
    eng = sv.engine(max_slots=4, cache_len=64, sync_every=4)
    prng = np.random.RandomState(7)
    reqs = [eng.submit([int(t) for t in prng.randint(1, vocab, (3 + 2 * i,))],
                       max_new_tokens=8) for i in range(8)]
    eng.run()
    out = [list(r.tokens) for r in reqs]
    stats = eng.stats_dict()
    eng.close()
    return out, stats


_GEMMA_BASE = dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                   targets=("attn/wq", "attn/wk", "attn/wv", "attn/wo"))


def _gemma(scale):
    jcfg = jax_config("gemma3_4b", smoke=True)
    jp = j_init(jax.random.PRNGKey(2), jcfg)
    jp = _scaled(jp) if scale else jp
    return jcfg, get_config("gemma3_4b", smoke=True), jp, \
        params_from_numpy(jax.tree.map(np.asarray, jp))


def test_engine_greedy_tokens_with_int8_packs_match_jax():
    """gemma3 smoke config with scaled weights (see test_torch_engine.py):
    the port's int8-pack engine (kernel K6's plain version) gives the JAX
    int8-pack engine's greedy tokens and the same 'quant' stats."""
    jcfg, cfg, jp, tp = _gemma(scale=True)
    j8 = j_prepare(jp, jcfg, JSpec(backend="plan", pack_quant="int8",
                                   **_GEMMA_BASE))
    t8 = prepare_servable(tp, cfg, ServingSpec(
        backend="plan_pallas", pack_quant="int8", **_GEMMA_BASE),
        device="cpu")
    want, jstats = _greedy(j8, jcfg.vocab_size)
    got, stats = _greedy(t8, cfg.vocab_size)
    assert got == want
    assert stats["quant"] == jstats["quant"]


def test_engine_int8_agreement_with_fp_packs():
    """The reference's acceptance gate (tests/test_quant_packs.py): >= 99%
    greedy agreement between int8 and fp32 packs over a full engine run on
    the gemma3 smoke config at its init scale."""
    jcfg, cfg, jp, tp = _gemma(scale=False)
    t8 = prepare_servable(tp, cfg, ServingSpec(
        backend="plan", pack_quant="int8", **_GEMMA_BASE), device="cpu")
    t32 = prepare_servable(tp, cfg, ServingSpec(backend="plan",
                                                **_GEMMA_BASE), device="cpu")
    got, _ = _greedy(t8, cfg.vocab_size)
    fp, _ = _greedy(t32, cfg.vocab_size)
    total = sum(len(s) for s in fp)
    matched = sum(a == b for s1, s2 in zip(fp, got) for a, b in zip(s1, s2))
    assert matched / total >= 0.99


# --------------------------------------------------------------------------
# no JAX
# --------------------------------------------------------------------------

def test_quantized_and_masked_serving_without_jax():
    """With ``sys.modules['jax'] = None`` the port quantizes, serves through
    the K6 and K7 entry points (their plain versions on the CPU), saves and
    reloads -- and imports nothing of jax or the JAX package."""
    code = textwrap.dedent("""
        import sys, tempfile
        sys.modules["jax"] = None
        import torch
        from repro_torch.configs import get_config
        from repro_torch.core.pattern_reuse import PatternRegistry
        from repro_torch.kernels import autotune, bsr_matmul, exec_plan, ops
        from repro_torch.models import init_model
        from repro_torch.serving import (ServingSpec, export_params,
                                         load_servable, prepare_servable)
        from repro_torch.serving.servable import Servable, pinned_chooser
        cfg = get_config("bert_base", smoke=True)
        params = init_model(0, cfg, device="cpu")
        spec = ServingSpec(tile=(16, 16), sparsity=0.5,
                           backend="plan_pallas", pack_quant="fp8")
        sv = prepare_servable(params, cfg, spec, device="cpu")
        toks = torch.zeros((1, 8), dtype=torch.int64)
        y = sv.forward(toks)
        d = tempfile.mkdtemp()
        sv.save(d)
        assert torch.equal(load_servable(d, device="cpu").forward(toks), y)
        reg = PatternRegistry()
        sp, packs, st = export_params(
            params, cfg, tile=(16, 16), registry=reg,
            backend_chooser=pinned_chooser("masked"), device="cpu")
        ctrl = Servable(sp, cfg, spec, packs, reg, "cpu", export_stats=st)
        assert torch.isfinite(ctrl.forward(toks)).all()
        bad = [m for m in sys.modules
               if m == "repro" or m.startswith("repro.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("ok", sv.quant_stats()["compression_ratio"] > 3.0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ok True" in out.stdout


def test_spec_rejects_quant_on_an_unquantizable_backend():
    with pytest.raises(ValueError):
        ServingSpec(backend="bsr", pack_quant="int8")
    with pytest.raises(ValueError):
        ServingSpec(pack_quant="int4")
    assert dataclasses.replace(ServingSpec(), pack_quant="fp8").pack_quant \
        == "fp8"
