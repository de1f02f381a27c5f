"""The ssm, hybrid and audio families in the port against the JAX reference,
on the mamba2_780m, recurrentgemma_9b and whisper_base smoke configs (fp32)
with JAX-initialised weights bridged as numpy -- the port's copies of the
reference's cases for these families:

* ``model_forward`` (whisper with encoder frames), decode == forward
  (``test_models.py``), one-pass prefill == token-by-token prefill
  (``test_engine.py``);
* the engine: greedy tokens equal to the JAX engine's, with ``kv_layout=
  'paged'`` logging its blocker and serving dense; batched == sequential,
  fused == per-step (``test_decode_many.py``), chunked == one-shot == the
  JAX engine's chunked run (``test_chunked_prefill.py``'s hybrid-ssm /
  hybrid-rglru), slot recycling, inactive rows and freed slots bitwise
  equal to a fresh cache (``test_engine.py``), whisper's chunked-prefill
  gate and its rejection of a request without frames;
* the export: recurrentgemma's packs (FFN and local-attention projections
  only; the RG-LRU projections stay dense) equal to the reference's and a
  saved servable reloading bit-equal, mamba2 with no packs, whisper
  unexported with the reference's reason;
* a bf16 tree of each family crossing the bridge leaf for leaf.

Engine cases scale the smoke attention / FFN / mixer projections by 20: at
the init scale a smoke model repeats one token and greedy parity would be
vacuous."""
import dataclasses
import logging

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core.pruner import tied_prune as j_tied  # noqa: E402
from repro.core.sparsity import SparsityConfig as JSp  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import SchedSpec as JSched  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402
from repro.serving.export import export_params as j_export  # noqa: E402
from repro.serving.serialize import pattern_key as j_pattern_key  # noqa

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pruner import tied_prune  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.core.tree import flatten_with_path, path_name  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving import (SchedSpec, ServingSpec,  # noqa: E402
                                 load_servable, prepare_servable)
from repro_torch.serving.export import export_params  # noqa: E402
from repro_torch.serving.serialize import pattern_key  # noqa: E402

from test_torch_lm import _assert_cache_equal, _np, _t  # noqa: E402

TOL = 1e-4
ARCHS = ("mamba2_780m", "recurrentgemma_9b", "whisper_base")
RECURRENT = ("mamba2_780m", "recurrentgemma_9b")
SPEC = dict(tile=(16, 16), sparsity=0.5, prune="tied", backend="plan_pallas")
_PROJ = ("attn", "ffn", "xattn", "in_proj", "out_proj", "in_x", "in_gate",
         "out")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(jp):
    def one(path, x):
        names = [str(getattr(k, "key", "")) for k in path]
        if any(n in _PROJ for n in names) and not any("norm" in n
                                                       for n in names):
            return x * 20.0
        return x
    return jax.tree_util.tree_map_with_path(one, jp)


_MODELS = {}


def _model(arch):
    """(JAX config, port config, JAX params, port params), init scale."""
    if arch not in _MODELS:
        jcfg = jax_config(arch, smoke=True)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        _MODELS[arch] = (jcfg, get_config(arch, smoke=True), jp,
                         params_from_numpy(jax.tree.map(np.asarray, jp)))
    return _MODELS[arch]


def _frames(cfg, b, seed):
    return np.random.RandomState(seed).randn(
        b, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)


def _batches(jcfg, toks, seed=0):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if jcfg.family == "audio":
        fr = _frames(jcfg, toks.shape[0], seed)
        jb["frames"], tb["frames"] = jnp.asarray(fr), _t(fr)
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, cfg, jp, tp = _model(arch)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 32))
    jb, tb = _batches(jcfg, toks)
    want, _ = japi.model_forward(jp, jcfg, jb)
    got, aux = tapi.model_forward(tp, cfg, tb)
    assert got.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _caches(jcfg, cfg, jp, tp, b, cache_len, seed=0):
    if jcfg.family != "audio":
        return (japi.init_cache(jp, jcfg, b, cache_len),
                tapi.init_cache(tp, cfg, b, cache_len))
    fr = _frames(jcfg, b, seed)
    return (japi.init_cache(jp, jcfg, b, cache_len, frames=jnp.asarray(fr)),
            tapi.init_cache(tp, cfg, b, cache_len, frames=_t(fr)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """40 decode steps from an empty cache give the teacher-forced forward's
    logits (``test_models.py::test_decode_matches_forward``'s 2e-3), and
    each step the reference's decode logits."""
    jcfg, cfg, jp, tp = _model(arch)
    b, s = 2, 40
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, s))
    _, tb = _batches(jcfg, toks, seed=3)
    fwd, _ = tapi.model_forward(tp, cfg, tb)
    jc, tc = _caches(jcfg, cfg, jp, tp, b, s, seed=3)
    jstep = jax.jit(lambda c, tok, pos: japi.decode_step(jp, c, jcfg, tok,
                                                         pos))
    errs = []
    for t in range(s):
        tok = toks[:, t:t + 1].astype(np.int32)
        jl, jc = jstep(jc, jnp.asarray(tok), jnp.int32(t))
        tl, tc = tapi.decode_step(tp, tc, cfg, _t(tok), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        errs.append(float((tl[:, 0] - fwd[:, t]).abs().max()))
    assert max(errs) < 2e-3, max(errs)
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("arch", RECURRENT)
def test_one_pass_prefill_matches_sequential(arch):
    """prefill_cache (one forward pass, bucket padding as identity steps,
    the local layers' ring wrapped) == token-by-token decode prefill, and
    the reference's prefill; both caches continue identically."""
    jcfg, cfg, jp, tp = _model(arch)
    L, bucket, cache_len = 41, 64, 64
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (1, L))
    padded = np.zeros((1, bucket), np.int32)
    padded[:, :L] = toks
    ref = tapi.init_cache(tp, cfg, 1, cache_len)
    for t in range(L):
        lg_ref, ref = tapi.decode_step(tp, ref, cfg, _t(toks[:, t:t + 1]), t)
    pf = tapi.init_cache(tp, cfg, 1, cache_len)
    lg_pf, pf = tapi.prefill_cache(tp, pf, cfg, _t(padded), L)
    jl, jc = japi.prefill_cache(jp, japi.init_cache(jp, jcfg, 1, cache_len),
                                jcfg, jnp.asarray(padded), L)
    np.testing.assert_allclose(lg_pf[:, L - 1].numpy(), lg_ref[:, 0].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(lg_pf[:, :L].numpy(), np.asarray(jl)[:, :L],
                               atol=TOL)
    _assert_cache_equal(pf, jc)
    cur = int(lg_ref[0, 0].argmax())
    for t in range(L, L + 6):
        tok = torch.tensor([[cur]], dtype=torch.int32)
        lg_r, ref = tapi.decode_step(tp, ref, cfg, tok, t)
        lg_p, pf = tapi.decode_step(tp, pf, cfg, tok, t)
        np.testing.assert_allclose(lg_p.numpy(), lg_r.numpy(), atol=1e-5)
        cur = int(lg_r[0, 0].argmax())


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_rows_leave_cache_untouched(arch):
    """A pos = -1 row writes no KV and advances no recurrent state; the
    active row does write (``test_engine.py``'s case, bitwise here)."""
    jcfg, cfg, jp, tp = _model(arch)
    _, cache = _caches(jcfg, cfg, jp, tp, 2, 32, seed=4)
    before = {k: _np(tapi.read_slot(cache, cfg, k)) for k in (0, 1)}
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    tapi.decode_step(tp, cache, cfg, tok, torch.tensor([0, -1],
                                                       dtype=torch.int32))
    after = {k: _np(tapi.read_slot(cache, cfg, k)) for k in (0, 1)}
    for name, x in before[1].items():
        np.testing.assert_array_equal(after[1][name], x, err_msg=name)
    assert any(not np.array_equal(after[0][n], x)
               for n, x in before[0].items())


@pytest.mark.parametrize("arch", ARCHS)
def test_freed_slot_equals_fresh_cache(arch):
    """free_slot zeroes KV, recurrent state, conv history and (audio) the
    cross K/V: the freed slot is bitwise a never-used slot."""
    jcfg, cfg, jp, tp = _model(arch)
    _, cache = _caches(jcfg, cfg, jp, tp, 3, 32, seed=5)
    fresh = tapi.init_cache(tp, cfg, 3, 32) if jcfg.family != "audio" else \
        tapi.init_cache(tp, cfg, 3, 32, frames=torch.zeros(
            (3, cfg.n_audio_ctx, cfg.d_model)))
    tok = torch.tensor([[3], [4], [5]], dtype=torch.int32)
    for t in range(4):
        tapi.decode_step(tp, cache, cfg, tok, t)
    tapi.free_slot(cache, cfg, 1)
    got, want = _np(tapi.read_slot(cache, cfg, 1)), _np(tapi.read_slot(
        fresh, cfg, 1))
    if jcfg.family == "audio":          # zero frames still encode to K/V
        want = {k: (np.zeros_like(v) if k.startswith("cross") else v)
                for k, v in want.items()}
    for name, x in want.items():
        np.testing.assert_array_equal(got[name], x, err_msg=name)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

_SERVED = {}


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


def _traffic(arch, lengths, seed=1):
    cfg = get_config(arch, smoke=True)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    frames = ([rng.randn(cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
               for _ in lengths] if cfg.family == "audio" else None)
    return prompts, frames


def _serve(sv, prompts, frames=None, max_new=8, max_slots=3, cache_len=64,
           **kw):
    eng = sv.engine(max_slots=max_slots, cache_len=cache_len, **kw)
    hs = [eng.submit(p, max_new_tokens=max_new,
                     **({} if frames is None else {"frames": frames[i]}))
          for i, p in enumerate(prompts)]
    eng.run()
    if hasattr(eng, "verify_invariants"):
        eng.verify_invariants()
    return hs, eng


_JAX_RUNS = {}


def _jax_tokens(arch, key, prompts, frames, **kw):
    if (arch, key) not in _JAX_RUNS:
        js, _ = _servables(arch)
        hs, _ = _serve(js, prompts, frames, **kw)
        _JAX_RUNS[arch, key] = [(h.status, list(h.tokens)) for h in hs]
    return _JAX_RUNS[arch, key]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch, caplog):
    """Five requests over three slots (slots recycle), fused windows of 8:
    every token equals the JAX engine's. ``kv_layout='paged'`` logs why
    these configs cannot page and serves dense, with the same tokens."""
    _, ts = _servables(arch)
    prompts, frames = _traffic(arch, (5, 3, 21, 40, 9))
    want = _jax_tokens(arch, "main", prompts, frames)
    hs, _ = _serve(ts, prompts, frames)
    got = [(h.status, list(h.tokens)) for h in hs]
    assert all(s == "done" for s, _ in got)
    assert len({tuple(t) for _, t in got}) > 1            # not degenerate
    assert got == want
    with caplog.at_level(logging.INFO, logger="repro_torch.serving"):
        hs, eng = _serve(ts, prompts, frames, kv_layout="paged")
    assert eng.kv_layout == "dense"
    blocker = ("family 'audio' (cross-attn caches are per-request)"
               if arch == "whisper_base"
               else "no linear attention/MLA layers to page")
    assert blocker in caplog.text
    assert [(h.status, list(h.tokens)) for h in hs] == want


def _sequential(sv, prompt, max_new, cache_len, frames=None):
    """Batch-1 reference: the prompt through the decode path token by
    token, then greedy generation (``test_engine.py``'s ``_sequential``)."""
    cache = sv.init_cache(1, cache_len, frames=None if frames is None
                          else frames[None])
    logits = None
    for t, tok in enumerate(prompt):
        logits, cache = sv.decode_step(cache, [[tok]], t)
    toks, logs = [], []
    pos = len(prompt)
    cur = int(logits[0, 0].argmax())
    toks.append(cur)
    logs.append(logits[0, 0].numpy())
    while len(toks) < max_new:
        logits, cache = sv.decode_step(cache, [[cur]], pos)
        pos += 1
        cur = int(logits[0, 0].argmax())
        toks.append(cur)
        logs.append(logits[0, 0].numpy())
    return toks, logs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_sequential(arch):
    """Four co-active requests of mixed lengths: the engine's tokens and
    step logits equal batch-1 sequential decoding
    (``test_engine.py::test_engine_matches_sequential[_audio]``)."""
    _, ts = _servables(arch)
    prompts, frames = _traffic(arch, (3, 11, 7, 5), seed=4)
    hs, _ = _serve(ts, prompts, frames, max_new=6, max_slots=4,
                   collect_logits=True)
    for i, (h, p) in enumerate(zip(hs, prompts)):
        want_toks, want_logs = _sequential(
            ts, p, 6, 64, None if frames is None else frames[i])
        assert h.done and h.tokens == want_toks
        for got, want in zip(h.step_logits, want_logs):
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_recycling_is_hygienic(arch):
    """Six requests through two slots: every recycled slot serves its next
    request exactly as a fresh engine would (``test_engine.py``)."""
    _, ts = _servables(arch)
    prompts, frames = _traffic(arch, (3, 9, 5, 12, 4, 7), seed=6)
    hs, eng = _serve(ts, prompts, frames, max_new=5, max_slots=2,
                     collect_logits=True)
    assert all(h.done for h in hs)
    for i, (h, p) in enumerate(zip(hs, prompts)):
        want_toks, want_logs = _sequential(
            ts, p, 5, 64, None if frames is None else frames[i])
        assert h.tokens == want_toks
        for got, want in zip(h.step_logits, want_logs):
            np.testing.assert_allclose(got, want, atol=1e-5)
    assert eng.stats.completed == eng.stats.prefills == len(prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_matches_per_step(arch):
    """Six mixed-length requests through two slots: fused windows of 4 give
    the per-step engine's tokens (``test_decode_many.py``)."""
    _, ts = _servables(arch)
    prompts, frames = _traffic(arch, (3, 11, 7, 5, 9, 4), seed=5)
    ref, _ = _serve(ts, prompts, frames, max_new=6, max_slots=2,
                    sync_every=1)
    got, eng = _serve(ts, prompts, frames, max_new=6, max_slots=2,
                      sync_every=4)
    assert [h.tokens for h in got] == [h.tokens for h in ref]
    assert all(h.done for h in got)
    assert eng.stats.windows < eng.stats.steps


@pytest.mark.parametrize("arch", RECURRENT, ids=["hybrid-ssm",
                                                 "hybrid-rglru"])
def test_chunked_prefill_equals_one_shot_and_jax(arch):
    """``test_chunked_prefill.py``'s recurrent cases: chunks of 8 (budget
    16) continue each slot's carried state and conv history, and give the
    one-shot engine's tokens and the JAX engine's chunked tokens."""
    js, ts = _servables(arch)
    prompts, _ = _traffic(arch, (5, 23, 3, 37), seed=3)
    kw = dict(max_new=6, max_slots=4, max_queue=16)
    base, _ = _serve(ts, prompts, **kw)
    got, eng = _serve(ts, prompts, sched=SchedSpec(max_chunk=8,
                                                   token_budget=16), **kw)
    want, _ = _serve(js, prompts, sched=JSched(max_chunk=8, token_budget=16),
                     **kw)
    assert eng._chunking and eng.stats.prefill_chunks > len(prompts)
    assert all(h.status == "done" for h in got)
    assert [h.tokens for h in got] == [h.tokens for h in base] == \
        [h.tokens for h in want]


def test_audio_gates_and_frames(caplog):
    """whisper: chunked prefill logs its blocker and admits one-shot
    through the decode path; a request without frames is rejected at
    submission, as in the reference."""
    _, ts = _servables("whisper_base")
    prompts, frames = _traffic("whisper_base", (4, 6), seed=7)
    with caplog.at_level(logging.INFO, logger="repro_torch.serving"):
        hs, eng = _serve(ts, prompts, frames, max_new=4,
                         sched=SchedSpec(max_chunk=2, token_budget=4))
    assert not eng._chunking and eng.stats.prefill_chunks == 0
    assert "family 'audio' prefills through the decode path" in caplog.text
    assert all(h.status == "done" for h in hs)
    eng = ts.engine(max_slots=2, cache_len=32)
    h = eng.submit([1, 2, 3], max_new_tokens=2)
    assert h.status == "failed" and h.failure.code == "rejected"
    assert "audio requests need encoder frames" in h.failure.message


# --------------------------------------------------------------------------
# export and a saved servable
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_export_matches_jax_and_reloads_bit_equal(arch, tmp_path):
    """The port's export gives the reference's packs, values and stats:
    recurrentgemma packs its local attention and FFNs, never the RG-LRU
    projections; mamba2 packs nothing; whisper returns its params with the
    reference's ``__unsupported__`` reason. A saved servable reloads with
    bit-equal logits."""
    jcfg, cfg, jp, tp = _model(arch)
    kw = dict(block_shape=(16, 16), sparsity=0.5,
              targets=("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                       "ffn/wi", "ffn/wo"))
    jpr, _ = j_tied(jp, JSp(**kw))
    tpr, _ = tied_prune(tp, SparsityConfig(**kw))
    jsp, jpacks, jst = j_export(jpr, jcfg, tile=(16, 16))
    tsp, tpacks, tst = export_params(tpr, cfg, tile=(16, 16))
    assert sorted(tpacks) == sorted(jpacks)
    for key in jpacks:
        assert pattern_key(tpacks[key]) == j_pattern_key(jpacks[key]), key
        assert tst[key]["union_nnzt"] == jst[key]["union_nnzt"], key
    a, b = _np(tsp), _np(jax.tree.map(np.asarray, jsp))
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    if arch == "recurrentgemma_9b":
        assert tpacks and not any("/mixer/" in k for k in tpacks)
        assert {k.rsplit("/", 2)[1] for k in tpacks} == {"attn", "ffn"}
    else:
        assert tpacks == {}
    if arch == "whisper_base":
        assert tst == jst and "__unsupported__" in tst
    sv = prepare_servable(tp, cfg, ServingSpec(**SPEC), device="cpu")
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 24))
    _, batch = _batches(jcfg, toks, seed=8)
    want = sv.forward(batch)
    back = load_servable(sv.save(str(tmp_path / arch)), device="cpu")
    assert sorted(back.packs) == sorted(sv.packs)
    assert torch.equal(back.forward(batch), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tree_crosses_the_bridge(arch):
    """A bf16 tree (fp32 A_log / D / dt_bias / lam leaves) crosses over leaf
    for leaf: the same paths, dtypes and bytes; the port's own init draws
    the same layout."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jp)
    jleaves = {path_name(p): x for p, x in flatten_with_path(jp)}
    tleaves = {path_name(p): x for p, x in flatten_with_path(tp)}
    assert sorted(jleaves) == sorted(tleaves)
    for name, x in jleaves.items():
        t = tleaves[name]
        assert tuple(t.shape) == x.shape, name
        assert str(t.dtype).split(".")[1] == x.dtype.name, name
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert raw.numpy().tobytes() == x.tobytes(), name
    own = tapi.init_model(0, cfg, device="cpu")
    olv = {path_name(p): x for p, x in flatten_with_path(own)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in olv.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tleaves.items()}
