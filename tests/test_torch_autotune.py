"""The port's measured backend chooser (``kernels/autotune.py``) against the
JAX reference on the CPU: the winner cache (frozen timer, key separation,
v1 invalidation, corrupt files), cache keys equal to the reference's but
for the device field, the stub proxy's numbers, ``backend='auto'`` serving
the reference's winners in stub mode, the choice and masked pack kinds
(fingerprints, codec, linear), and ``choose_decode_kernel``. Plus an import
with JAX blocked."""
import json
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
from repro.core.sparsity import prune_to_sparsity  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels.exec_plan import plan_for_pack as j_plan_for_pack  # noqa: E402
from repro.kernels.exec_plan import PlanChoice as JPlanChoice  # noqa: E402
from repro.kernels.exec_plan import quantize_for_plan as j_quant  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402
from repro.serving.serialize import pattern_key as j_pattern_key  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels.autotune import (AutotuneCache,  # noqa: E402
                                          BackendChoice, MaskedPack,
                                          choose_backend,
                                          choose_decode_kernel,
                                          dense_from_pack, masked_pack_from,
                                          stub_costs)
from repro_torch.kernels.bsr_matmul import pack_bsr  # noqa: E402
from repro_torch.serving import (ServingSpec, load_servable,  # noqa: E402
                                 prepare_servable)
from repro_torch.serving.serialize import (packs_from_arrays,  # noqa: E402
                                           packs_to_arrays, pattern_key)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread_and_own_cache(tmp_path, monkeypatch):
    """One intra-op thread (parallel workers share the cores); a winner
    cache of the test's own; no stub switch from the environment."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "env.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_STUB", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(n=64, k=48, tile=(16, 16), sparsity=0.5, seed=0):
    rng = np.random.RandomState(seed)
    w = jnp.asarray(rng.randn(n, k).astype(np.float32))
    return np.asarray(prune_to_sparsity(w, tile, sparsity)[0])


def _packs(**kw):
    """(JAX KernelBSR, port KernelBSR) of the same pruned weight."""
    from repro.kernels.bsr_matmul import pack_bsr as j_pack_bsr
    tile = kw.get("tile", (16, 16))
    w = _w(**kw)
    return j_pack_bsr(w, tile), pack_bsr(w, tile)


def _sans_device(key):
    """A cache key without its device field (the one field that differs
    between the two packages on the same machine)."""
    parts = key.split(":")
    i = parts.index("cpu")
    return ":".join(parts[:i] + parts[i + 2:])


# --------------------------------------------------------------------------
# chooser mechanics
# --------------------------------------------------------------------------

def test_frozen_timer_picks_argmin_and_persists(tmp_path):
    _, pk = _packs()
    frozen = {"dense": 5.0, "gather": 3.0, "rowpack": 4.0, "plan": 1.0}
    cache = AutotuneCache(str(tmp_path / "at.json"))
    c = choose_backend(pk, m=32, candidates=tuple(frozen), cache=cache,
                       stub=False, device=CPU,
                       timer=lambda name, fn, args: frozen[name])
    assert c.backend == "plan" and not c.cache_hit and c.mode == "wallclock"
    assert cache.stats.misses == 1
    cache2 = AutotuneCache(str(tmp_path / "at.json"))    # "new process"
    c2 = choose_backend(pk, m=32, candidates=tuple(frozen), cache=cache2,
                        stub=False, device=CPU,
                        timer=lambda name, fn, args: 1.0 / 0.0)
    assert c2.backend == "plan" and c2.cache_hit
    assert cache2.stats.hits == 1


def test_cache_key_separates_pattern_m_mode_quant_and_dtype(tmp_path):
    cache = AutotuneCache(str(tmp_path / "at.json"))
    _, pk1 = _packs(seed=0)
    _, pk2 = _packs(seed=1)
    t = lambda name, fn, args: {"dense": 1.0, "plan": 2.0}[name]  # noqa
    kw = dict(candidates=("dense", "plan"), cache=cache, device=CPU)
    keys = [choose_backend(pk1, m=32, stub=False, timer=t, **kw).key,
            choose_backend(pk2, m=32, stub=False, timer=t, **kw).key,
            choose_backend(pk1, m=64, stub=False, timer=t, **kw).key,
            choose_backend(pk1, m=32, stub=True, **kw).key,
            choose_backend(pk1, m=32, stub=True, quant="int8", **kw).key]
    import dataclasses
    pk16 = dataclasses.replace(pk1, data=torch.from_numpy(pk1.data).to(
        torch.bfloat16))
    keys.append(choose_backend(pk16, m=32, stub=True, **kw).key)
    assert len(set(keys)) == 6
    assert cache.stats.hits == 0 and cache.stats.misses == 6
    assert ":qint8:" in keys[4] and ":wbfloat16:" in keys[5]
    assert ":d1:" in keys[0] and ":cpu:cpu:" in keys[0]


def test_sharded_choice_raises_naming_its_slice():
    """Sharded autotuning raised here (naming ROADMAP.md Queue 1 item 6)
    until the sharding slice: a sharded choice is now keyed with the shard
    layout and sub-shape, as the reference keys it."""
    _, pk = _packs(n=128, k=128)
    ch = choose_backend(pk, m=32, stub=True, shard=(4, "out"), device=CPU)
    assert ":d1:sout4x32x128:stub:" in ch.key and not ch.cache_hit
    # a single shard is the unsharded problem
    one = choose_backend(pk, m=32, stub=True, shard=(1, "out"), device=CPU)
    assert one.backend and ":s" not in one.key.split(":stub:")[0]


def test_cache_v1_file_invalidates_without_crash(tmp_path):
    path = tmp_path / "at.json"
    path.write_text(json.dumps(
        {"version": 1, "entries": {"stalekey": {"backend": "gather"}}}))
    _, pk = _packs()
    c = choose_backend(pk, m=32, candidates=("dense", "plan"),
                       cache=AutotuneCache(str(path)), stub=True, device=CPU)
    assert not c.cache_hit
    doc = json.loads(path.read_text())
    assert doc["version"] == autotune.CACHE_VERSION == jat.CACHE_VERSION
    assert c.key in doc["entries"] and "stalekey" not in doc["entries"]
    path.write_text("{not json")
    c2 = choose_backend(pk, m=32, candidates=("dense", "plan"),
                        cache=AutotuneCache(str(path)), stub=True,
                        device=CPU)
    assert not c2.cache_hit


@pytest.mark.parametrize("payload", [
    b"",
    b"\x00\x9c\xffgarbage\x81",
    b"[1, 2, 3]",
    b'"just a string"',
    b'{"version": 2, "entries": [1, 2]}',
    b'{"version": 2, "entries": {"k": "notadict"}}',
    b'{"version": 2, "entries": {"k": {"backend": "dense"}',
])
def test_cache_corrupt_file_reads_empty_and_is_rewritten(tmp_path, payload):
    path = tmp_path / "at.json"
    path.write_bytes(payload)
    cache = AutotuneCache(str(path))
    assert cache.get("anything") is None
    cache.put("k2", {"backend": "plan"})
    doc = json.loads(path.read_text())
    assert doc["version"] == autotune.CACHE_VERSION
    assert doc["entries"]["k2"] == {"backend": "plan"}
    assert all(isinstance(v, dict) for v in doc["entries"].values())
    assert AutotuneCache(str(path)).get("k2") == {"backend": "plan"}


def test_cache_corrupt_file_end_to_end_choose(tmp_path):
    path = tmp_path / "at.json"
    path.write_bytes(b"\x89PNG not a json file at all")
    _, pk = _packs()
    kw = dict(candidates=("dense", "plan"), stub=True, device=CPU)
    c1 = choose_backend(pk, m=32, cache=AutotuneCache(str(path)), **kw)
    c2 = choose_backend(pk, m=32, cache=AutotuneCache(str(path)), **kw)
    assert not c1.cache_hit and c2.cache_hit and c2.backend == c1.backend


def test_default_cache_path_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert autotune.default_cache().path == str(tmp_path / "x.json")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert autotune.default_cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro", "autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_STUB", "1")
    assert autotune.stub_mode()
    monkeypatch.setenv("REPRO_AUTOTUNE_STUB", "0")
    assert not autotune.stub_mode()


# --------------------------------------------------------------------------
# the reference's keys and numbers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n=128, k=128, sparsity=0.8,
                                             seed=13),
                                dict(n=64, k=64, tile=(32, 1), seed=2),
                                dict(n=32, k=256, tile=(16, 64),
                                     sparsity=0.1, seed=3)])
def test_stub_costs_are_the_reference_numbers(kw):
    jpk, tpk = _packs(**kw)
    cands = autotune.CANDIDATES + autotune.QUANT_CANDIDATES
    assert cands == jat.CANDIDATES + jat.QUANT_CANDIDATES
    assert autotune.INTERPRET_ONLY == jat.INTERPRET_ONLY
    assert stub_costs(tpk, 96, cands, device=CPU) == \
        jat.stub_costs(jpk, 96, cands)


@pytest.mark.parametrize("quant,cands", [("none", None), ("int8", None),
                                         ("none", ("dense", "plan"))])
def test_stub_choice_and_key_equal_the_reference(tmp_path, quant, cands):
    jpk, tpk = _packs(n=128, k=128, sparsity=0.8, seed=13)
    j = jat.choose_backend(jpk, m=64, candidates=cands, stub=True,
                           quant=quant,
                           cache=jat.AutotuneCache(str(tmp_path / "j")))
    t = choose_backend(tpk, m=64, candidates=cands, stub=True, quant=quant,
                       cache=AutotuneCache(str(tmp_path / "t")), device=CPU)
    assert t.backend == j.backend and t.costs == j.costs
    assert _sans_device(t.key) == _sans_device(j.key)


def test_wallclock_measure_small_pattern():
    """The real clock on the CPU: positive times per candidate and the
    paired-ratio scores (the anchor scores 1.0 against itself)."""
    _, pk = _packs(n=32, k=32)
    times, scores = autotune.measure(
        pk, 8, ("dense", "gather", "rowpack", "plan", "plan_q8"), reps=2,
        device=CPU)
    assert all(t > 0 for t in times.values()) and len(times) == 5
    assert scores["dense"] == 1.0
    assert all(s > 0 for s in scores.values())


def test_arms_without_a_kernel_leave_the_cpu_wallclock_set(tmp_path):
    _, pk = _packs()
    c = choose_backend(pk, m=16, cache=AutotuneCache(str(tmp_path / "a")),
                       reps=1, device=CPU, quant="int8")
    assert c.mode == "wallclock"
    assert set(c.costs) == {"dense", "gather", "rowpack", "plan", "plan_q8"}


# --------------------------------------------------------------------------
# backend='auto' through the servable (stub mode, deterministic)
# --------------------------------------------------------------------------

def _auto_case(arch, seed):
    jcfg = jax_config(arch, smoke=True)
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, get_config(arch, smoke=True), jp, tp


@pytest.mark.parametrize("arch,quant,union", [
    ("bert_base", "none", True), ("bert_base", "int8", True),
    ("bert_base", "none", False), ("deepseek_7b", "none", True),
    ("deepseek_7b", "int8", True)])
def test_backend_auto_serves_the_reference_winners(tmp_path, monkeypatch,
                                                   arch, quant, union):
    """Stub mode: the same winner for every group as the JAX servable,
    forward parity with it, and a second prepare answered from the cache."""
    monkeypatch.setenv("REPRO_AUTOTUNE_STUB", "1")
    jcfg, cfg, jp, tp = _auto_case(arch, 1)
    kw = dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
              targets=ATTN_TARGETS, backend="auto", autotune_m=64,
              pack_quant=quant, cross_layer_union=union)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "j.json"))
    js = j_prepare(jp, jcfg, JSpec(**kw))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    ts = prepare_servable(tp, cfg, ServingSpec(**kw), device=CPU)
    ja, ta = js.stats()["autotune"], ts.stats()["autotune"]
    assert ta["backends"] == ja["backends"] and ta["mode"] == "stub"
    assert (ta["cache_hits"], ta["cache_misses"]) == \
        (ja["cache_hits"], ja["cache_misses"])
    assert {k: pattern_key(p) for k, p in ts.packs.items()} == \
        {k: j_pattern_key(p) for k, p in js.packs.items()}
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 8))
    np.testing.assert_allclose(ts.forward(torch.from_numpy(toks)).numpy(),
                               np.asarray(js.forward(jnp.asarray(toks))),
                               atol=1e-4)
    again = prepare_servable(tp, cfg, ServingSpec(**kw), device=CPU)
    a2 = again.stats()["autotune"]
    assert a2["cache_hits"] == len(a2["backends"])
    assert a2["backends"] == ta["backends"]
    with open(tmp_path / "t.json") as f:
        tkeys = {_sans_device(k) for k in json.load(f)["entries"]}
    with open(tmp_path / "j.json") as f:
        jkeys = {_sans_device(k) for k in json.load(f)["entries"]}
    assert tkeys == jkeys


def test_backend_auto_save_load(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_STUB", "1")
    jcfg, cfg, jp, tp = _auto_case("deepseek_7b", 2)
    spec = ServingSpec(tile=(16, 16), sparsity=0.5, prune="oneshot",
                       targets=ATTN_TARGETS, backend="auto", autotune_m=64)
    sv = prepare_servable(tp, cfg, spec, device=CPU)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 6)))
    want = sv.forward(toks)
    sv.save(str(tmp_path / "ckpt"))
    sv2 = load_servable(str(tmp_path / "ckpt"), device=CPU)
    assert torch.equal(sv2.forward(toks), want)
    assert sv2.stats()["autotune"]["backends"] == \
        sv.stats()["autotune"]["backends"]


# --------------------------------------------------------------------------
# the choice and masked pack kinds
# --------------------------------------------------------------------------

def test_pattern_keys_equal_the_reference_for_every_kind():
    jpk, tpk = _packs()
    jplan, tplan = j_plan_for_pack(jpk), txp.plan_for_pack(tpk)
    jq, _ = j_quant(jplan, jpk.data, "int8", backend="plan_pallas")
    tq, _ = txp.quantize_for_plan(tplan, tpk.data, "int8",
                                  backend="plan_pallas")
    pairs = [(jpk, tpk), (jplan, tplan),
             (JPlanChoice(jplan), txp.PlanChoice(tplan)), (jq, tq),
             (jat.BackendChoice(jpk, "gather"), BackendChoice(tpk, "gather")),
             (jat.masked_pack_from(jpk), masked_pack_from(tpk))]
    for j, t in pairs:
        assert pattern_key(t) == j_pattern_key(j), type(t).__name__
    np.testing.assert_array_equal(dense_from_pack(tpk),
                                  jat.dense_from_pack(jpk))
    assert masked_pack_from(tpk).density == jat.masked_pack_from(jpk).density


def test_choice_and_masked_packs_roundtrip():
    _, pk = _packs()
    packs = {"a/wq": BackendChoice(pk, "gather"),
             "b/wq": BackendChoice(pk, "rowpack"),
             "c/wq": masked_pack_from(pk), "d/wq": pk}
    assert len({pattern_key(p) for p in packs.values()}) == 4
    arrays, meta = packs_to_arrays(packs)
    assert [m["kind"] for m in meta["patterns"]] == ["choice", "choice",
                                                     "masked", "bsr"]
    restored = packs_from_arrays(json.loads(json.dumps(meta)), arrays)
    assert restored["a/wq"].backend == "gather"
    assert restored["b/wq"].backend == "rowpack"
    np.testing.assert_array_equal(restored["c/wq"].tile_mask,
                                  packs["c/wq"].tile_mask)
    for key in packs:
        assert pattern_key(restored[key]) == pattern_key(packs[key])


def test_masked_and_choice_linear_parity():
    from repro_torch.models.common import linear
    _, pk = _packs()
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 48).astype(
        np.float32))
    w = torch.from_numpy(dense_from_pack(pk))
    ref = x @ w.t()
    for pack, v in [(BackendChoice(pk, "gather"), pk.data),
                    (BackendChoice(pk, "rowpack"), pk.data),
                    (BackendChoice(pk, "pallas"), pk.data),
                    (masked_pack_from(pk), w)]:
        got = linear({"w": torch.as_tensor(v)}, x, pack)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)
    assert isinstance(masked_pack_from(pk), MaskedPack)


# --------------------------------------------------------------------------
# decode-kernel selection
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [dict(), dict(b=4, t=1280, hq=8, hkv=4,
                                                d=256),
                                   dict(b=2, t=64, hq=4, hkv=4, d=16,
                                        window=32, kv_split=2)])
def test_choose_decode_kernel_stub_equals_the_reference(tmp_path, shape):
    j = jat.choose_decode_kernel(
        **shape, stub=True, cache=jat.AutotuneCache(str(tmp_path / "j")))
    t = choose_decode_kernel(**shape, stub=True, device=CPU,
                             cache=AutotuneCache(str(tmp_path / "t")))
    assert t.backend == j.backend == "xla" and t.costs == j.costs
    assert _sans_device(t.key) == _sans_device(j.key)
    kw = {k: v for k, v in dict(dict(b=8, t=512, hq=8, hkv=8, d=64),
                                **shape).items() if k != "window"}
    kw["kv_split"] = kw.get("kv_split") or autotune.default_kv_split(kw["t"])
    assert autotune.decode_stub_costs(**kw, device=CPU) == \
        jat.decode_stub_costs(**kw)
    with pytest.raises(ValueError):
        choose_decode_kernel(hq=0, stub=True, device=CPU)


def test_servable_resolves_auto_decode_kernel_through_the_chooser(
        monkeypatch):
    """decode_kernel='auto' on a CPU servable: the chooser measures the
    plain composition only (K2 has no kernel here) and pins 'xla'; the env
    and a non-'auto' spec win over it."""
    cfg = get_config("gemma3_4b", smoke=True)
    from repro_torch.models import init_model
    params = init_model(0, cfg, device=CPU)
    spec = ServingSpec(tile=(16, 16), sparsity=0.5, backend="plan")
    sv = prepare_servable(params, cfg, spec, device=CPU)
    assert sv.decode_kernel_kind() == "xla"
    with open(os.environ["REPRO_AUTOTUNE_CACHE"]) as f:
        keys = list(json.load(f)["entries"])
    assert len(keys) == 1 and keys[0].startswith(
        f"decode:b8t512h{cfg.n_heads}g{cfg.n_kv_heads}d{cfg.head_dim}")
    monkeypatch.setenv("REPRO_DECODE_KERNEL", "flash")
    assert prepare_servable(params, cfg, spec,
                            device=CPU).decode_kernel_kind() == "flash"


# --------------------------------------------------------------------------
# no JAX
# --------------------------------------------------------------------------

def test_autotune_runs_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from repro_torch.kernels import autotune
        from repro_torch.kernels.bsr_matmul import pack_bsr
        w = np.random.RandomState(0).randn(64, 64).astype(np.float32)
        w[:16] = 0.0
        pk = pack_bsr(w, (16, 16))
        cache = autotune.AutotuneCache({str(tmp_path / "at.json")!r})
        c = autotune.choose_backend(pk, m=16, cache=cache, stub=False,
                                    reps=1, device="cpu", quant="int8")
        d = autotune.choose_decode_kernel(b=2, t=64, hq=4, hkv=2, d=16,
                                          cache=cache, device="cpu")
        bad = [m for m in sys.modules
               if m == "repro" or m.startswith("repro.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("winner", c.backend, d.backend)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "winner" in out.stdout and out.stdout.strip().endswith("xla")
