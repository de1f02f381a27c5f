"""The port's continuous-batching engine against the JAX engine: greedy
tokens equal on the same weights and traffic in the dense and paged
layouts, per-step (sync_every 1) and fused (sync_every 8); a radix
prefix-sharing hit and preempt-resume (re-prefill and page retention) on
deepseek_7b; EOS mid-window; a servable saved by JAX serving in the port.
Plus the engine's own lifecycle contracts: rejections, queue policies,
cancel, deadlines, non-finite quarantine, window-failure recovery, the
options that still raise (and the audio engine that no longer does), and
serving with JAX blocked.

The smoke weights are JAX's init with the attention and FFN weights scaled
by 20: at the init scale (0.02) a smoke model just repeats its input token,
which would make greedy parity vacuous."""
import os
import re
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (ServingSpec, load_servable,  # noqa: E402
                                 prepare_servable)
from repro_torch.serving.engine import FailureReason  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(tile=(16, 16), sparsity=0.5, prune="tied", backend="plan_pallas")
_SERVED = {}


def _scaled(jp):
    def one(path, x):
        names = [str(getattr(k, "key", "")) for k in path]
        if ("attn" in names or "ffn" in names) and not any(
                "norm" in n for n in names):
            return x * 20.0
        return x
    return jax.tree_util.tree_map_with_path(one, jp)


def _servables(arch):
    """(JAX servable, port servable) on the same scaled smoke weights."""
    if arch not in _SERVED:
        jcfg = jax_config(arch, smoke=True)
        jp = _scaled(j_init(jax.random.PRNGKey(0), jcfg))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        _SERVED[arch] = (j_prepare(jp, jcfg, JSpec(**SPEC)),
                         prepare_servable(tp, get_config(arch, smoke=True),
                                          ServingSpec(**SPEC), device="cpu"))
    return _SERVED[arch]


def _prompts(vocab, lengths, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lengths]


# five requests over three slots (slots recycle); the 40-token prompt is
# past gemma's smoke window (32), so its ring wraps in prefill
GEMMA_PROMPTS = (5, 3, 21, 40, 9)


def _serve(sv, prompts, max_new=8, eos=None, **kw):
    eng = sv.engine(max_slots=3, cache_len=64, **kw)
    hs = [eng.submit(p, max_new_tokens=max_new,
                     eos_id=None if eos is None else eos[i])
          for i, p in enumerate(prompts)]
    eng.run()
    if hasattr(eng, "verify_invariants"):
        eng.verify_invariants()
    return [(h.status, list(h.tokens)) for h in hs], eng


_JAX_RUNS = {}


def _jax_run(arch, key, fn):
    if (arch, key) not in _JAX_RUNS:
        _JAX_RUNS[(arch, key)] = fn()
    return _JAX_RUNS[(arch, key)]


@pytest.mark.parametrize("layout,sync_every", [("dense", 1), ("dense", 8),
                                               ("paged", 1), ("paged", 8)])
def test_engine_greedy_tokens_match_jax(layout, sync_every):
    js, ts = _servables("gemma3_4b")
    prompts = _prompts(512, GEMMA_PROMPTS)
    want, _ = _jax_run("gemma3_4b", (layout, sync_every), lambda: _serve(
        js, prompts, kv_layout=layout, sync_every=sync_every))
    got, eng = _serve(ts, prompts, kv_layout=layout, sync_every=sync_every)
    assert eng.kv_layout == layout
    assert all(s == "done" for s, _ in got)
    assert len({tuple(t) for _, t in got}) == len(got)    # not degenerate
    assert got == want
    st = eng.stats_dict()
    assert st["completed"] == len(prompts) and st["prefills"] == len(prompts)
    assert st["kv"]["layout"] == layout


def test_eos_mid_window_matches_jax():
    js, ts = _servables("gemma3_4b")
    prompts = _prompts(512, GEMMA_PROMPTS)
    ref, _ = _jax_run("gemma3_4b", ("dense", 8), lambda: _serve(
        js, prompts, kv_layout="dense", sync_every=8))
    eos = [ref[0][1][3], None, ref[2][1][5], None, None]
    want, _ = _serve(js, prompts, eos=eos, kv_layout="dense", sync_every=8)
    got, _ = _serve(ts, prompts, eos=eos, kv_layout="dense", sync_every=8)
    assert got == want
    assert len(got[0][1]) == 4 and got[0][1][-1] == eos[0]
    assert len(got[2][1]) == 6 and got[2][0] == "done"


def _preempt_run(sv, prompts, layout):
    """Fill every slot with low-priority requests, decode a window, then
    submit a high-priority request that must preempt one of them."""
    eng = sv.engine(max_slots=2, cache_len=64, sync_every=4,
                    kv_layout=layout)
    low = [eng.submit(p, max_new_tokens=10) for p in prompts[:2]]
    eng.step()
    high = eng.submit(prompts[2], max_new_tokens=6, priority=5)
    eng.run()
    return ([(h.status, list(h.tokens), h.n_preempted) for h in low + [high]],
            eng)


@pytest.mark.parametrize("arch,layout", [("gemma3_4b", "dense"),
                                         ("deepseek_7b", "paged")])
def test_preempt_resume_matches_jax(arch, layout):
    """gemma (dense): the victim resumes by re-prefilling prompt +
    generated tokens; deepseek (paged, every layer global): by re-attaching
    its retained pages with no prefill."""
    js, ts = _servables(arch)
    prompts = _prompts(512, (6, 9, 4), seed=3)
    want, _ = _preempt_run(js, prompts, layout)
    got, eng = _preempt_run(ts, prompts, layout)
    eng.verify_invariants()
    assert got == want
    assert sum(n for _, _, n in got) == 1 and eng.stats.preemptions == 1
    assert all(s == "done" for s, _, _ in got)
    if layout == "paged":
        assert eng.stats.page_resumes == 1


def test_prefix_sharing_hit_matches_jax():
    """deepseek_7b (every layer global) on the paged layout: prompts that
    share a 32-token prefix are served from shared pages (suffix prefill),
    with the JAX engine's tokens and hit counts."""
    js, ts = _servables("deepseek_7b")
    rng = np.random.RandomState(5)
    shared = rng.randint(0, 512, 32).tolist()
    prompts = [shared + rng.randint(0, 512, n).tolist() for n in (5, 9, 3)]

    def run(sv):
        eng = sv.engine(max_slots=2, cache_len=64, sync_every=8,
                        kv_layout="paged")
        hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        return [list(h.tokens) for h in hs], eng.stats_dict()["kv"]
    want, jkv = run(js)
    got, tkv = run(ts)
    assert got == want
    assert tkv["prefix_hit_tokens"] == jkv["prefix_hit_tokens"] > 0


def test_jax_saved_lm_servable_serves_in_the_port(tmp_path):
    js, ts = _servables("gemma3_4b")
    js.save(str(tmp_path / "lm"))
    loaded = load_servable(str(tmp_path / "lm"), device="cpu")
    assert loaded.cfg == ts.cfg and loaded.spec == ts.spec
    assert sorted(loaded.packs) == sorted(ts.packs)
    toks = np.random.RandomState(6).randint(0, 512, (2, 12))
    want = np.asarray(js.forward(toks))
    np.testing.assert_allclose(loaded.forward(torch.from_numpy(toks)).numpy(),
                               want, atol=1e-4)
    prompts = _prompts(512, GEMMA_PROMPTS)
    ref, _ = _jax_run("gemma3_4b", ("dense", 8), lambda: _serve(
        js, prompts, kv_layout="dense", sync_every=8))
    got, _ = _serve(loaded, prompts, kv_layout="dense", sync_every=8)
    assert got == ref


# --------------------------------------------------------------------------
# the engine's own lifecycle contracts
# --------------------------------------------------------------------------

def test_rejections_queue_policies_cancel_and_deadlines():
    _, ts = _servables("gemma3_4b")
    eng = ts.engine(max_slots=2, cache_len=32, max_queue=2)
    bad = [eng.submit([], 4), eng.submit([1, 2], 0),
           eng.submit(list(range(30)), 8), eng.submit([1, 600], 2)]
    for h in bad:
        assert h.status == "failed"
        assert h.failure.code == FailureReason.REJECTED
    assert eng.stats.rejected == 4
    a, b = eng.submit([1, 2, 3], 4), eng.submit([4, 5], 4)
    c = eng.submit([6], 4)                      # queue full: 'reject'
    assert c.status == "shed" and c.failure.code == FailureReason.QUEUE_FULL
    eng.overflow = "shed-oldest"
    d = eng.submit([7, 8], 4)                   # sheds the oldest (a)
    assert a.status == "shed" and d.status == "queued"
    assert eng.cancel(b) and b.status == "cancelled"
    late = eng.submit([9, 10], 4, deadline_s=-1.0)
    assert late.status == "failed" and late.failure.code == "deadline"
    long = eng.submit([11, 12], 12)
    eng.step()                                  # d and long admitted
    assert eng.cancel(long) and long.status == "active"
    eng.run()
    assert long.status == "cancelled" and 0 < len(long.tokens) < 12
    assert d.status == "done" and len(d.tokens) == 4
    assert not eng.cancel(d)
    eng.verify_invariants()
    assert eng.n_active == 0 and eng.n_queued == 0 and eng.n_free == 2


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_nonfinite_slot_is_quarantined(layout):
    _, ts = _servables("gemma3_4b")
    prompts = _prompts(512, (5, 7, 6), seed=7)
    ref, _ = _serve(ts, prompts, kv_layout=layout, sync_every=4)
    eng = ts.engine(max_slots=3, cache_len=64, sync_every=4,
                    kv_layout=layout)
    hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng._schedule()                             # admit all three
    eng.corrupt_slot(hs[1].slot)
    eng.run()
    eng.verify_invariants()
    assert hs[1].status == "failed"
    assert hs[1].failure.code == FailureReason.NONFINITE_LOGITS
    for i in (0, 2):
        assert (hs[i].status, hs[i].tokens) == ref[i]


def test_window_failure_fails_actives_and_engine_keeps_serving(monkeypatch):
    _, ts = _servables("gemma3_4b")
    eng = ts.engine(max_slots=2, cache_len=64, sync_every=4)
    calls = {"n": 0}
    real = ts.decode_many

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected window fault")
        return real(*a, **kw)
    monkeypatch.setattr(ts, "decode_many", flaky)
    first = [eng.submit(p, 6) for p in _prompts(512, (4, 5), seed=8)]
    eng.step()
    assert all(h.status == "failed" and h.failure.code == "engine_error"
               for h in first)
    later = eng.submit([1, 2, 3], 5)
    eng.run()
    eng.verify_invariants()
    assert later.status == "done" and len(later.tokens) == 5


def _audio_engine():
    """The audio family builds an engine now: a whisper request (frames +
    a 3-token prompt) is served with the JAX engine's tokens."""
    js, ts = _servables("whisper_base")
    frames = np.random.RandomState(2).randn(
        ts.cfg.n_audio_ctx, ts.cfg.d_model).astype(np.float32)
    got = []
    for sv in (js, ts):
        eng = sv.engine(max_slots=2, cache_len=32)
        h = eng.submit([1, 2, 3], max_new_tokens=4, frames=frames)
        eng.run()
        got.append((h.status, list(h.tokens)))
    assert got[0] == got[1] and got[1][0] == "done"


def _mesh_engine():
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import SchedSpec
    _, ts = _servables("gemma3_4b")
    fake = types.SimpleNamespace(cfg=ts.cfg,
                                 spec=ServingSpec(mesh_shape=(1, 2)),
                                 mesh=types.SimpleNamespace(size=2))
    return ServingEngine(fake, max_slots=2, cache_len=32,
                         sched=SchedSpec(fast_fail=True))


def _paged_int8_cache():
    from dataclasses import replace
    from repro_torch.models import api as tapi
    from repro_torch.models.common import PagedLayout
    _, ts = _servables("gemma3_4b")
    return tapi.init_cache(ts.params, replace(ts.cfg, kv_cache_quant=True),
                           2, 32, paged=PagedLayout(page_size=16, n_pages=4))


@pytest.mark.parametrize("build,error,message", [
    (_audio_engine, None, None),
    (_mesh_engine, ValueError, "fast_fail / max_queue_delay_s read each "
                               "rank's clock"),
    (_paged_int8_cache, NotImplementedError,
     "kv_layout='paged' does not compose with kv_cache_quant"),
], ids=["audio", "mesh", "paged_int8"])
def test_unported_engine_options_raise(build, error, message):
    """What still raises: clock-driven SLO control on a mesh engine of more
    than one rank (the ranks' clocks would split their schedules; a mesh
    engine itself is served since ROADMAP.md Queue 1 item 6), and paged
    int8 KV where the reference's model layer raises too (its engine then
    serves dense, as the port's does). The audio family raised here until
    it was ported (ROADMAP.md Queue 1 item 4); its case now serves a
    request as the JAX engine does (``error`` None)."""
    if error is None:
        build()
        return
    with pytest.raises(error, match=re.escape(message)):
        build()


def test_lm_serves_without_jax():
    """The LM path imports neither jax nor the JAX package: with
    ``sys.modules['jax'] = None`` the port initialises gemma3_4b's smoke
    config, exports it and serves a paged engine on the CPU."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from repro_torch.configs import get_config
        from repro_torch.models import init_model
        from repro_torch.serving import ServingSpec, prepare_servable
        cfg = get_config("gemma3_4b", smoke=True)
        params = init_model(0, cfg, device="cpu")
        sv = prepare_servable(params, cfg, ServingSpec(
            tile=(16, 16), sparsity=0.5, backend="plan_pallas",
            kv_layout="paged", decode_kernel="flash"), device="cpu")
        eng = sv.engine(max_slots=2, cache_len=64, sync_every=4)
        hs = [eng.submit([1, 2, 3, 4, 5], 6), eng.submit(list(range(40)), 3)]
        eng.run()
        assert [h.status for h in hs] == ["done", "done"], hs
        bad = [m for m in sys.modules
               if m == "repro" or m.startswith("repro.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("served", sum(len(h.tokens) for h in hs))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 9" in out.stdout


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    """Every import statement of the port's modules and of chip_smoke.py
    (whose imports sit inside its phase functions) names neither jax nor
    the JAX package."""
    import ast
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 30 and not bad, bad
    models = os.path.join(REPO, "src", "repro_torch", "models")
    assert {os.path.join(models, n) for n in ("moe.py", "mla.py")} <= set(
        files)
