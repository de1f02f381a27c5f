"""The port's BERT serving path against the JAX reference on the bert_base
smoke config: the same JAX-initialised weights (through
``bridge.params_from_numpy``) served by both packages for the 'plan',
'plan_pallas' and 'dense' backends, with fused QKV and cross-layer union on
and off; servables saved by JAX load into the port; the port's export gives
the same packs. Plus the entry-point contracts: the port imports without
JAX, runs on the card unless told otherwise, and raises for options outside
this slice."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import load_servable as j_load  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402
from repro.serving.serialize import pattern_key as j_pattern_key  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.exec_plan import PlanChoice  # noqa: E402
from repro_torch.models import init_model, model_forward  # noqa: E402
from repro_torch.serving import (ServingSpec, load_servable,  # noqa: E402
                                 prepare_servable)
from repro_torch.serving.serialize import pattern_key  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 logits of the two packages: same math, sums in another order
TOL = 1e-4


@pytest.fixture(scope="module")
def bert():
    jcfg = jax_config("bert_base", smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 24))
    return jcfg, get_config("bert_base", smoke=True), jp, tp, toks


def _spec_kw(backend, fuse, union, prune="tied"):
    return dict(tile=(16, 16), sparsity=0.5, prune=prune, fuse_qkv=fuse,
                cross_layer_union=union, backend=backend)


_JAX_SERVED = {}


def _jax_served(bert, **kw):
    """(JAX servable, its logits) per spec, built once per module."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_SERVED:
        jcfg, _, jp, _, toks = bert
        js = j_prepare(jp, jcfg, JSpec(**kw))
        _JAX_SERVED[key] = js, np.asarray(js.forward(jnp.asarray(toks)))
    return _JAX_SERVED[key]


def test_dense_forward_matches_jax(bert):
    """models.api.model_forward on the reference's pruned dense tree (the
    dense servable's params) against that servable's logits."""
    jcfg, cfg, jp, tp, toks = bert
    js, want = _jax_served(bert, **_spec_kw("dense", True, True))
    pruned = params_from_numpy(jax.tree.map(np.asarray, js.params))
    got, aux = model_forward(pruned, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("backend,fuse,union", [
    ("plan", True, True), ("plan", True, False), ("plan", False, True),
    ("plan", False, False), ("plan_pallas", True, True),
    ("plan_pallas", True, False), ("plan_pallas", False, True),
    ("plan_pallas", False, False), ("dense", True, True)])
def test_servable_forward_matches_jax(bert, backend, fuse, union):
    jcfg, cfg, jp, tp, toks = bert
    kw = _spec_kw(backend, fuse, union)
    js, want = _jax_served(bert, **kw)
    ts = prepare_servable(tp, cfg, ServingSpec(**kw), device="cpu")
    got = ts.forward(torch.from_numpy(toks))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the port's export gives the same packs: keys, kinds and fingerprints
    assert {k: j_pattern_key(v) for k, v in js.packs.items()} == \
        {k: pattern_key(v) for k, v in ts.packs.items()}
    if backend == "plan_pallas":
        assert all(isinstance(p, PlanChoice) for p in ts.packs.values())
    jst, tst = js.stats(), ts.stats()
    for key in ("packed_projections", "unique_patterns", "registry"):
        assert jst[key] == tst[key], key
    for key in ("density", "union_overhead", "padded_flop_ratio"):
        assert (jst[key] is None) == (tst[key] is None), key
        if jst[key] is not None:
            assert abs(jst[key] - tst[key]) < 1e-12, key
    assert ts.pack_bytes()[0] == js.pack_bytes()[0]


def test_oneshot_prune_servable_matches_jax(bert):
    jcfg, cfg, jp, tp, toks = bert
    kw = _spec_kw("plan_pallas", True, False, prune="oneshot")
    want = np.asarray(j_prepare(jp, jcfg, JSpec(**kw)).forward(
        jnp.asarray(toks)))
    got = prepare_servable(tp, cfg, ServingSpec(**kw), device="cpu").forward(
        torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("backend", ["plan_pallas", "plan", "dense"])
def test_jax_saved_servable_loads_into_port(bert, tmp_path, backend):
    jcfg, cfg, jp, tp, toks = bert
    js, want = _jax_served(bert, **_spec_kw(backend, True, True))
    js.save(str(tmp_path / "sv"))
    ts = load_servable(str(tmp_path / "sv"), device="cpu")
    assert ts.spec.backend == backend and ts.cfg == cfg
    assert {k: pattern_key(v) for k, v in ts.packs.items()} == \
        {k: j_pattern_key(v) for k, v in js.packs.items()}
    got = ts.forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    assert ts.stats()["registry_at_save"] == js.stats()["registry"]


def test_port_save_load_roundtrip_and_jax_reads_it(bert, tmp_path):
    jcfg, cfg, jp, tp, toks = bert
    ts = prepare_servable(tp, cfg, ServingSpec(**_spec_kw(
        "plan_pallas", True, True)), device="cpu")
    y = ts.forward(torch.from_numpy(toks))
    ts.save(str(tmp_path / "sv"))
    again = load_servable(str(tmp_path / "sv"), device="cpu")
    assert torch.equal(again.forward(torch.from_numpy(toks)), y)
    assert len({id(p.plan) for p in again.packs.values()}) == \
        ts.stats()["unique_patterns"]
    js = j_load(str(tmp_path / "sv"))
    np.testing.assert_allclose(np.asarray(js.forward(jnp.asarray(toks))),
                               y.numpy(), atol=TOL)


def test_bf16_packs_serve_and_roundtrip(bert, tmp_path):
    """spec.dtype='bfloat16' casts only the packed values; they save as raw
    2-byte values and reload bit-equal."""
    jcfg, cfg, jp, tp, toks = bert
    kw = dict(_spec_kw("plan_pallas", True, True), dtype="bfloat16")
    ts = prepare_servable(tp, cfg, ServingSpec(**kw), device="cpu")
    assert ts.params["layers"][0]["attn"]["wqkv"]["w"].dtype == \
        torch.bfloat16
    assert ts.params["embed"]["w"].dtype == torch.float32
    js, want = _jax_served(bert, **kw)
    y = ts.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(y.numpy(), want, atol=TOL)
    js.save(str(tmp_path / "j"))
    from_jax = load_servable(str(tmp_path / "j"), device="cpu")
    assert torch.equal(from_jax.forward(torch.from_numpy(toks)), y)
    ts.save(str(tmp_path / "t"))
    again = load_servable(str(tmp_path / "t"), device="cpu")
    assert torch.equal(again.forward(torch.from_numpy(toks)), y)


def test_port_serves_without_jax():
    """The port imports neither jax nor the JAX package: with
    ``sys.modules['jax'] = None`` it still initialises, prunes, exports and
    serves the smoke config on the CPU."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models import init_model
        from repro_torch.serving import ServingSpec, prepare_servable
        cfg = get_config("bert_base", smoke=True)
        params = init_model(0, cfg, device="cpu")
        sv = prepare_servable(params, cfg, ServingSpec(
            tile=(16, 16), sparsity=0.5, backend="plan_pallas"),
            device="cpu")
        y = sv.forward(torch.zeros((2, 8), dtype=torch.long))
        assert y.shape == (2, 8, cfg.vocab_size) and torch.isfinite(y).all()
        bad = [m for m in sys.modules
               if m == "repro" or m.startswith("repro.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("served", sv.stats()["packed_projections"])
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 8" in out.stdout


def test_entry_points_need_a_card_unless_told_cpu(bert, tmp_path):
    """Without device=, the entry points run on the card -- and raise on a
    machine that has none (there is no silent move to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device exists")
    jcfg, cfg, jp, tp, toks = bert
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_servable(tp, cfg, ServingSpec(**_spec_kw("plan", True,
                                                         True)))
    ts = prepare_servable(tp, cfg, ServingSpec(**_spec_kw("plan", True,
                                                          True)),
                          device="cpu")
    ts.save(str(tmp_path / "sv"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_servable(str(tmp_path / "sv"))


@pytest.mark.parametrize("kw,item", [
    (dict(mesh_shape=(1, 2), backend="plan"), "needs torch.distributed"),
    (dict(mesh_shape=(1, 2), pack_quant="int8", backend="plan"),
     "needs torch.distributed"),
    (dict(mesh_shape=(2, 1), partition="dp", backend="dense"),
     "needs torch.distributed"),
    (dict(mesh_shape=(1, 2), backend="auto"), "needs torch.distributed"),
])
def test_options_outside_the_slice_raise(bert, kw, item):
    # a mesh is served since the sharding slice (ROADMAP.md Queue 1 item
    # 6), one process per mesh position: without the process group up
    # with data * model ranks, prepare_servable says how to start them
    jcfg, cfg, jp, tp, toks = bert
    spec = ServingSpec(**dict(_spec_kw("plan", True, True), **kw))
    with pytest.raises(ValueError, match=item):
        prepare_servable(tp, cfg, spec, device="cpu")


def test_other_families_raise():
    """The SSM family raised here until it was ported (ROADMAP.md Queue 1
    item 4); now init_model draws the reference's tree layout for it."""
    from repro_torch.core.tree import flatten_with_path, path_name
    cfg = get_config("mamba2_780m", smoke=True)
    own = init_model(0, cfg, device="cpu")
    ref = j_init(jax.random.PRNGKey(0), jax_config("mamba2_780m", smoke=True))
    layout = {path_name(p): tuple(x.shape) for p, x in flatten_with_path(own)}
    want = {path_name(p): tuple(np.shape(x)) for p, x in
            flatten_with_path(jax.tree.map(np.asarray, ref))}
    assert layout == want and "blocks/[0]/mixer/A_log" in layout


def test_seeded_init_is_deterministic():
    cfg = get_config("bert_base", smoke=True)
    a, b = init_model(3, cfg, device="cpu"), init_model(3, cfg, device="cpu")
    c = init_model(4, cfg, device="cpu")
    assert torch.equal(a["layers"][1]["ffn"]["wo"]["w"],
                       b["layers"][1]["ffn"]["wo"]["w"])
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])
    assert tuple(a["layers"][0]["attn"]["wq"]["w"].shape) == (64, 64)
