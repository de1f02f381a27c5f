"""The vlm, MoE and MLA families in the port against the JAX reference, on
the pixtral_12b, qwen3_moe_235b_a22b and deepseek_v2_lite_16b smoke configs
(fp32) with JAX-initialised weights bridged as numpy:

* ``model_forward`` (pixtral with ``mm_embeds``; the MoE aux loss),
  ``prefill_cache``, 40 ragged ``decode_step`` tokens and chunked
  ``prefill_suffix``, logits and caches;
* the export: pack scopes, pattern keys and packed values as the
  reference's (MoE experts stay unpacked, MLA packs ``wq`` and ``wo``),
  and a saved servable reloading with bit-equal logits;
* the engine: greedy tokens equal to the JAX engine's, dense and paged
  (deepseek on paged latent pools), and the port's copies of the
  reference's family cases -- ``test_engine.py``'s MLA and high-capacity
  MoE engines against sequential decoding, ``test_decode_many.py``'s fused
  == per-step, ``test_chunked_prefill.py``'s MLA chunked == one-shot
  (dense and paged) and its MoE gate, ``test_paged_kv.py``'s MLA paged ==
  dense;
* the calls that raised before the ssm, hybrid and audio families were
  ported (ROADMAP.md Queue 1 item 4) now build what the reference builds,
  and a bf16 MoE + MLA tree crosses the bridge leaf for leaf.

The engine cases scale the smoke attention / FFN weights by 20, as
``test_torch_engine.py`` does: at the init scale a smoke model repeats its
input token and greedy parity would be vacuous."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import LayerKind as JKind  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core.pruner import tied_prune as j_tied  # noqa: E402
from repro.core.sparsity import SparsityConfig as JSp  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402
from repro.serving.export import export_params as j_export  # noqa: E402
from repro.serving.serialize import pattern_key as j_pattern_key  # noqa

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: E402
from repro_torch.core.pruner import tied_prune  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.core.tree import flatten_with_path, path_name  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import (SchedSpec, ServingSpec,  # noqa: E402
                                 load_servable, prepare_servable)
from repro_torch.serving.export import export_params  # noqa: E402
from repro_torch.serving.serialize import pattern_key  # noqa: E402

from test_torch_engine import _scaled  # noqa: E402
from test_torch_lm import _assert_cache_equal, _np  # noqa: E402

# fp32 logits of the two packages: the same math, sums in another order
TOL = 1e-4
ARCHS = ("pixtral_12b", "qwen3_moe_235b_a22b", "deepseek_v2_lite_16b")
ATTN_TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
SPEC = dict(tile=(16, 16), sparsity=0.5, prune="tied", backend="plan_pallas")
_MLA_KW = dict(arch="mla-dense-smoke", family="dense", n_layers=2,
               d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
               vocab_size=512, kv_lora_rank=32, qk_nope_dim=16,
               qk_rope_dim=8, v_head_dim=16, dtype="float32")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and the
    whole suite runs files side by side (wall-clock tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_config(request.param, smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return request.param, jcfg, get_config(request.param, smoke=True), jp, tp


def _batches(jcfg, toks, rng):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if jcfg.family == "vlm":
        mm = rng.randn(toks.shape[0], jcfg.n_patches, jcfg.d_model).astype(
            np.float32)
        jb["mm_embeds"], tb["mm_embeds"] = jnp.asarray(mm), _t(mm)
    return jb, tb


def test_forward_matches_jax(model):
    """Logits and the aux loss (the MoE layers' Switch losses summed); the
    vlm patch embeddings change the logits from the first position on."""
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jb, tb = _batches(jcfg, toks, rng)
    want, jaux = japi.model_forward(jp, jcfg, jb)
    got, aux = tapi.model_forward(tp, cfg, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == (jcfg.family == "moe")
    if jcfg.family == "vlm":
        plain, _ = tapi.model_forward(tp, cfg, {"tokens": _t(toks)})
        assert not torch.allclose(plain[:, 0], got[:, 0])


def test_prefill_then_40_ragged_decode_steps_match_jax(model):
    """prefill_cache (prompt 37 of a 40-token bucket) into two slots, then
    40 greedy decode steps with slot 1 inactive: every step's live logits
    and the caches afterwards are the reference's."""
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(1)
    toks = rng.randint(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jc, tc = japi.init_cache(jp, jcfg, 2, 80), tapi.init_cache(tp, cfg, 2,
                                                               80)
    jl, jc = japi.prefill_cache(jp, jc, jcfg, jnp.asarray(toks), 37)
    tl, tc = tapi.prefill_cache(tp, tc, cfg, _t(toks), 37)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    _assert_cache_equal(tc, jc)
    tok = np.asarray(jl)[:, 36].argmax(-1).astype(np.int32)[:, None]
    pos = np.array([37, -1], np.int32)
    for _ in range(40):
        jl, jc = japi.decode_step(jp, jc, jcfg, jnp.asarray(tok),
                                  jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, cfg, _t(tok), _t(pos))
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=TOL)
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0], np.int32)
    _assert_cache_equal(tc, jc)


def test_prefill_suffix_chunks_match_jax(model):
    """Slot 1 of a 2-slot cache (slot 0 holding a prefilled prompt) takes a
    prompt in two suffix chunks, the second bucket-padded."""
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(2)
    first = rng.randint(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    jc, tc = japi.init_cache(jp, jcfg, 2, 64), tapi.init_cache(tp, cfg, 2,
                                                               64)
    jsub = japi.prefill_cache(jp, japi.init_cache(jp, jcfg, 1, 64), jcfg,
                              jnp.asarray(first), 12)[1]
    tsub = tapi.prefill_cache(tp, tapi.init_cache(tp, cfg, 1, 64), cfg,
                              _t(first), 12)[1]
    jc, tc = japi.write_slot(jc, jcfg, 0, jsub), tapi.write_slot(tc, cfg, 0,
                                                                 tsub)
    start = 0
    for s, length in ((16, 16), (16, 11)):
        chunk = rng.randint(0, jcfg.vocab_size, (1, s)).astype(np.int32)
        jl, jc = japi.prefill_suffix(jp, jc, jcfg, jnp.asarray(chunk), 1,
                                     start, length)
        tl, tc = tapi.prefill_suffix(tp, tc, cfg, _t(chunk), 1, start,
                                     length)
        np.testing.assert_allclose(tl.numpy()[0, :length],
                                   np.asarray(jl)[0, :length], atol=TOL)
        start += length
    _assert_cache_equal(tc, jc)


# --------------------------------------------------------------------------
# export and a saved servable
# --------------------------------------------------------------------------

def test_export_matches_jax_and_reloads_bit_equal(model, tmp_path):
    """The port's export gives the reference's packs (scopes, pattern keys,
    stored tile counts) and values; MoE experts stay raw arrays and an MLA
    layer packs wq and wo only. A saved servable reloads with bit-equal
    logits."""
    arch, jcfg, cfg, jp, tp = model
    kw = dict(block_shape=(16, 16), sparsity=0.5,
              targets=ATTN_TARGETS + ("ffn/wi", "ffn/wo"))
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
    names = {k.rsplit("/", 1)[1] for k in tpacks}
    if cfg.kv_lora_rank:
        assert names <= {"wq", "wo", "wi"} and "wq" in names
    else:
        assert "wqkv" in names
    if cfg.n_experts:
        assert not any(k.startswith("blocks/") and "/ffn/" in k
                       for k in tpacks)
        assert a["blocks/[0]/ffn/wi"].ndim == 4       # (P, E, d, f), raw
    sv = prepare_servable(tp, cfg, ServingSpec(**SPEC), device="cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    _, batch = _batches(jcfg, toks, rng)
    want = sv.forward(batch)
    back = load_servable(sv.save(str(tmp_path / arch)), device="cpu")
    assert sorted(back.packs) == sorted(sv.packs)
    assert torch.equal(back.forward(batch), want)


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


def _prompts(vocab, lengths, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lengths]


def _serve(sv, prompts, max_new=8, max_slots=3, cache_len=64, **kw):
    eng = sv.engine(max_slots=max_slots, cache_len=cache_len, **kw)
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    if hasattr(eng, "verify_invariants"):
        eng.verify_invariants()
    return [(h.status, list(h.tokens)) for h in hs], eng


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch, layout):
    """Five requests over three slots (slots recycle), fused windows of 8:
    every token equals the JAX engine's. MoE routes over the whole batch
    (capacity 1 a step at three slots), so this holds the drops too."""
    js, ts = _servables(arch)
    prompts = _prompts(512, (5, 3, 21, 40, 9))
    want, _ = _serve(js, prompts, kv_layout=layout)
    got, eng = _serve(ts, prompts, kv_layout=layout)
    assert eng.kv_layout == layout
    assert all(s == "done" for s, _ in got)
    assert len({tuple(t) for _, t in got}) > 1            # not degenerate
    assert got == want


def _ref_servables(cfg_kw, pattern, seed=1, **spec_kw):
    """The reference tests' servables (oneshot 50% on the attention
    projections, plan backend), JAX and port, on the same weights."""
    jcfg = JConfig(pattern=tuple(JKind(*k) for k in pattern), **cfg_kw)
    tcfg = ModelConfig(pattern=tuple(LayerKind(*k) for k in pattern),
                       **cfg_kw)
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    spec = dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                targets=ATTN_TARGETS, **spec_kw)
    return (j_prepare(jp, jcfg, JSpec(**spec)),
            prepare_servable(tp, tcfg, ServingSpec(**spec), device="cpu"))


def _moe_high_capacity(**spec_kw):
    jcfg = dataclasses.replace(jax_config("deepseek_v2_lite_16b", smoke=True),
                               capacity_factor=64.0)
    tcfg = dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                               capacity_factor=64.0)
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    spec = dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                targets=ATTN_TARGETS, **spec_kw)
    return (j_prepare(jp, jcfg, JSpec(**spec)),
            prepare_servable(tp, tcfg, ServingSpec(**spec), device="cpu"))


_CASES = {}


def _case(name):
    if name not in _CASES:
        _CASES[name] = (_ref_servables(_MLA_KW, (("mla", "dense"),))
                        if name == "mla" else _moe_high_capacity())
    return _CASES[name]


def _sequential(sv, prompt, max_new, cache_len):
    """Batch-1 reference: the prompt through the decode path token by
    token, then greedy generation (``test_engine.py``'s ``_sequential``)."""
    cache = sv.init_cache(1, cache_len)
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


@pytest.mark.parametrize("name,lengths,max_new,cache_len", [
    ("mla", (4, 9, 13), 5, 64), ("moe_high_capacity", (3, 8), 4, 32)])
def test_engine_matches_sequential(name, lengths, max_new, cache_len):
    """``test_engine.py``'s MLA-dense and high-capacity MoE cases: the
    engine's tokens and step logits equal batch-1 sequential decoding, and
    its tokens the JAX engine's."""
    js, ts = _case(name)
    prompts = _prompts(512, lengths, seed=4)
    runs = {}
    for key, sv in (("jax", js), ("port", ts)):
        eng = sv.engine(max_slots=len(prompts), cache_len=cache_len,
                        collect_logits=True)
        hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run()
        runs[key] = hs
    for h, hj, p in zip(runs["port"], runs["jax"], prompts):
        want_toks, want_logs = _sequential(ts, p, max_new, cache_len)
        assert h.done and h.tokens == want_toks == hj.tokens
        for got, want in zip(h.step_logits, want_logs):
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name,lengths,max_new,cache_len", [
    ("mla", (4, 9, 13), 5, 64), ("moe_high_capacity", (3, 8), 4, 32)])
def test_fused_matches_per_step(name, lengths, max_new, cache_len):
    """``test_decode_many.py``'s MLA and MoE cases: fused windows give the
    per-step engine's tokens."""
    _, ts = _case(name)
    prompts = _prompts(512, lengths, seed=5)
    ref, _ = _serve(ts, prompts, max_new, len(prompts), cache_len,
                    sync_every=1)
    got, eng = _serve(ts, prompts, max_new, len(prompts), cache_len,
                      sync_every=8)
    assert got == ref and all(s == "done" for s, _ in got)
    assert eng.stats.windows < eng.stats.steps


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mla_chunked_prefill_equals_one_shot(layout):
    """``test_chunked_prefill.py``'s MLA case: chunks of 8 (budget 16) give
    one-shot admission's tokens, dense and on paged latent pools."""
    _, ts = _case("mla")
    prompts = _prompts(512, (5, 23, 3, 37), seed=3)
    base, _ = _serve(ts, prompts, 6, 4, 64, kv_layout=layout, max_queue=16)
    got, eng = _serve(ts, prompts, 6, 4, 64, kv_layout=layout, max_queue=16,
                      sched=SchedSpec(max_chunk=8, token_budget=16))
    assert eng._chunking and eng.kv_layout == layout
    assert eng.stats.prefill_chunks > len(prompts)
    assert got == base and all(s == "done" for s, _ in got)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "deepseek_v2_lite_16b"])
def test_chunking_gate_falls_back_for_moe(arch, caplog):
    """MoE routing is batch-global: the engine logs the blocker and admits
    one-shot, the scheduler's other knobs still live."""
    _, ts = _servables(arch)
    import logging
    with caplog.at_level(logging.INFO):
        eng = ts.engine(max_slots=2, cache_len=64,
                        sched=SchedSpec(max_chunk=8, token_budget=16))
    assert not eng._chunking
    assert "MoE ffn (expert routing is batch-global)" in caplog.text
    r = eng.submit(list(range(1, 12)), max_new_tokens=4)
    eng.run()
    assert r.status == "done" and eng.stats.prefill_chunks == 0


def test_mla_paged_engine_is_bitexact_against_dense():
    """``test_paged_kv.py``'s MLA config: the paged engine (latent pools)
    gives the dense engine's tokens; preempt-resume retention is allowed
    for MLA, prefix sharing is not."""
    _, ts = _case("mla")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(10, 31)), [40, 41]]
    dense, _ = _serve(ts, prompts, 8, 4, 64, kv_layout="dense")
    paged, eng = _serve(ts, prompts, 8, 4, 64, kv_layout="paged")
    assert eng.kv_layout == "paged" and eng.kv_stats()["peak_pages_used"] > 0
    assert eng._can_retain and not eng._can_share
    assert paged == dense and all(s == "done" for s, _ in paged)


# --------------------------------------------------------------------------
# what raised before Queue 1 item 4, and the bridge
# --------------------------------------------------------------------------

def _layout(tree):
    return {path_name(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in flatten_with_path(tree)}


def _raise_api():
    """init_model for the ssm family draws the reference's tree layout."""
    cfg = get_config("mamba2_780m", smoke=True)
    own = tapi.init_model(0, cfg, device="cpu")
    jp = jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(0), jax_config("mamba2_780m", smoke=True)))
    assert _layout(own) == _layout(jp)


def _raise_check_kind():
    """An rglru layer kind builds the reference's layer layout."""
    from repro.models import lm as jlm
    cfg = get_config("recurrentgemma_9b", smoke=True)
    jcfg = jax_config("recurrentgemma_9b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    own = tlm._init_layer(gen, cfg, LayerKind("rglru", "dense"), "cpu")
    ref = jax.tree.map(np.asarray, jlm._init_layer(
        jax.random.PRNGKey(0), jcfg, JKind("rglru", "dense")))
    assert _layout(own) == _layout(ref)


def _raise_export():
    """The audio family exports nothing, with the reference's reason."""
    jcfg = jax_config("whisper_base", smoke=True)
    want = j_export({}, jcfg, tile=(16, 16))
    got = export_params({}, get_config("whisper_base", smoke=True),
                        tile=(16, 16))
    assert got == want and got[2]["__unsupported__"]["family"] == "audio"


@pytest.mark.parametrize("build", [_raise_api, _raise_check_kind,
                                   _raise_export],
                         ids=["api_ssm", "lm_rglru", "export_audio"])
def test_unported_families_raise_item_4(build):
    """These calls raised, naming Queue 1 item 4, until the ssm, hybrid and
    audio families were ported; now each builds what the reference does."""
    build()


def test_bf16_moe_and_mla_tree_crosses_the_bridge():
    """A bf16 deepseek_v2_lite tree (fp32 router, bf16 experts, the MLA
    kv_norm) crosses over leaf for leaf: the same paths, dtypes and bytes,
    and the port's own init draws the same layout."""
    jcfg = dataclasses.replace(jax_config("deepseek_v2_lite_16b", smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                              dtype="bfloat16")
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
    assert tleaves["blocks/[0]/ffn/router"].dtype == torch.float32
    assert tleaves["blocks/[0]/ffn/wi"].dtype == torch.bfloat16
    assert "prefix/[0]/attn/kv_norm/scale" in tleaves
    own = tapi.init_model(0, cfg, device="cpu")
    olv = {path_name(p): x for p, x in flatten_with_path(own)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in olv.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tleaves.items()}

