"""The SLO scheduler of the port's engine against the reference: chunked
prefill (``SchedSpec(max_chunk=...)``) equal to one-shot admission in the
dense and paged layouts, and to the JAX engine's chunked tokens; the slot's
K/V and ``pos_map`` after chunked prefills against JAX's (``pos_map``
bitwise, K/V within fp32 rounding); and the reference's scheduler cases of
``tests/test_chunked_prefill.py`` (dense family) and ``tests/test_sched.py``
-- deadline fast-fail, overload shedding, the watchdog snapshot, the
arrival-burst and chunk chaos sites -- with rates pinned as its
``_pin_rates`` does.

The engines run fp32 smoke models pruned 50% at 16x16 on the plain
``plan`` backend, one intra-op thread (the shedding case is wall-clock
sensitive). The JAX servable and the port's are built from the same
JAX-initialised weights (``params_from_numpy``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import LayerKind as JKind  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import SchedSpec as JSched  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.runtime.chaos import (SITE_ARRIVAL_BURST,  # noqa: E402
                                       SITE_PREFILL_CHUNK, SITE_SYNC,
                                       ChaosInjector, straggle)
from repro_torch.serving import (FailureReason, SchedSpec,  # noqa: E402
                                 ServingSpec, TERMINAL_STATES,
                                 prepare_servable)

from test_torch_engine import GEMMA_PROMPTS, _serve  # noqa: E402
from test_torch_engine import _prompts as _gemma_prompts  # noqa: E402
from test_torch_engine import _servables as _gemma_servables  # noqa: E402

ATTN_TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
SCHED = dict(max_chunk=8, token_budget=16)
# mixed lengths: shorter than one chunk, multi-chunk, chunk-boundary exact
PROMPTS_LENS = (5, 23, 3, 37)
# fp32 K/V of two packages: the same math, sums in another order
TOL_KV = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(name, vocab=512, kv=2, pattern=(("attn", 0),)):
    return dict(arch=name, family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=kv, head_dim=16, d_ff=128, vocab_size=vocab,
                dtype="float32"), pattern


CFGS = {
    "attn": _cfg_kw("chunk-attn-smoke"),
    # mixed local + global attention: the chunk path must respect the ring
    # hazard (attend before write) on the windowed layers
    "windowed": _cfg_kw("chunk-window-smoke",
                        pattern=(("attn", 16), ("attn", 0))),
    "sched": _cfg_kw("sched-smoke", vocab=256, kv=4),
}
_SV = {}


def _servables(name, **spec_kw):
    """(JAX servable, port servable, port cfg) on the same weights."""
    key = (name, tuple(sorted(spec_kw.items())))
    if key not in _SV:
        kw, pattern = CFGS[name]
        jcfg = JConfig(pattern=tuple(JKind(m, "dense", window=w)
                                     for m, w in pattern), **kw)
        tcfg = ModelConfig(pattern=tuple(LayerKind(m, "dense", window=w)
                                         for m, w in pattern), **kw)
        jp = j_init(jax.random.PRNGKey(1), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        spec = dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                    targets=ATTN_TARGETS, **spec_kw)
        _SV[key] = (j_prepare(jp, jcfg, JSpec(**spec)),
                    prepare_servable(tp, tcfg, ServingSpec(**spec),
                                     device="cpu"), tcfg)
    return _SV[key]


def _sv(name="attn", **spec_kw):
    return _servables(name, **spec_kw)[1]


def _prompts(vocab=512, lens=PROMPTS_LENS, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lens]


def _drain(sv, prompts, max_new=6, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 64)
    eng = sv.engine(max_queue=16, **kw)
    reqs = [eng.submit(list(p), max_new_tokens=max_new) for p in prompts]
    eng.run()
    return eng, reqs


def _assert_parity(base_reqs, sched_reqs, tag):
    for rb, rs in zip(base_reqs, sched_reqs):
        assert rb.status == rs.status == "done", (
            tag, rb.status, rs.status, rs.failure)
        assert rb.tokens == rs.tokens, (tag, rb.tokens, rs.tokens)


def _tokens(reqs):
    return [(r.status, list(r.tokens)) for r in reqs]


# --------------------------------------------------------------------------
# chunked prefill: equal to one-shot, and to the JAX engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["attn", "windowed"])
def test_chunked_equals_oneshot_dense(family):
    js, ts, _ = _servables(family)
    prompts = _prompts()
    _, base = _drain(ts, prompts)
    eng, chunked = _drain(ts, prompts, sched=SchedSpec(**SCHED))
    assert eng._chunking
    assert eng.stats.prefill_chunks > len(prompts)   # real multi-chunk work
    _assert_parity(base, chunked, family)
    eng.verify_invariants()
    jeng, jchunked = _drain(js, prompts, sched=JSched(**SCHED))
    assert _tokens(chunked) == _tokens(jchunked)
    assert eng.stats.prefill_chunks == jeng.stats.prefill_chunks


@pytest.mark.parametrize("family", ["attn", "windowed"])
def test_chunked_equals_oneshot_paged(family):
    js, ts, _ = _servables(family, kv_layout="paged", kv_page_size=8)
    prompts = _prompts()
    _, base = _drain(ts, prompts)
    eng, chunked = _drain(ts, prompts, sched=SchedSpec(**SCHED))
    assert eng.kv_layout == "paged" and eng._chunking
    _assert_parity(base, chunked, family + "+paged")
    assert eng.kv_stats()["peak_pages_used"] > 0
    eng.verify_invariants()
    jeng, jchunked = _drain(js, prompts, sched=JSched(**SCHED))
    assert _tokens(chunked) == _tokens(jchunked)
    assert eng.stats.prefill_chunks == jeng.stats.prefill_chunks


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_gemma_chunked_tokens_match_jax(layout):
    """gemma3_4b smoke (ring layers of 32 slots and global layers): the
    40-token prompt wraps the rings inside a chunk; port chunked == port
    one-shot == JAX chunked."""
    js, ts = _gemma_servables("gemma3_4b")
    prompts = _gemma_prompts(512, GEMMA_PROMPTS)
    base, _ = _serve(ts, prompts, kv_layout=layout, sync_every=8)
    got, eng = _serve(ts, prompts, kv_layout=layout, sync_every=8,
                      sched=SchedSpec(max_chunk=8, token_budget=24))
    want, jeng = _serve(js, prompts, kv_layout=layout, sync_every=8,
                        sched=JSched(max_chunk=8, token_budget=24))
    assert eng._chunking and eng.stats.prefill_chunks > len(prompts)
    assert got == base == want
    assert eng.stats.prefill_chunks == jeng.stats.prefill_chunks


def test_chunk_kv_and_pos_map_match_jax():
    """Five chunks of 8 through ``prefill_suffix`` into slot 1 of a 3-slot
    cache, for a 37-token prompt on the windowed config (16-slot rings:
    wraps inside chunks 3 and 5): after each chunk the slot's K/V equal
    JAX's within ``TOL_KV`` and every pos_map bitwise; the logits of the
    last real position agree too."""
    js, ts, cfg = _servables("windowed")
    prompt = np.asarray(_prompts(lens=(37,))[0], np.int32)
    tcache = tapi.init_cache(ts.params, cfg, 3, 64)
    jcache = japi.init_cache(js.params, js.cfg, 3, 64)
    slot = 1
    for start in range(0, prompt.size, 8):
        c = min(8, prompt.size - start)
        toks = np.zeros((8,), np.int32)
        toks[:c] = prompt[start:start + c]
        with torch.no_grad():
            tlog, tcache = tapi.prefill_suffix(
                ts.params, tcache, cfg, torch.from_numpy(toks)[None], slot,
                start, c, packs=ts.packs)
        jlog, jcache = japi.prefill_suffix(
            js.params, jcache, js.cfg, jnp.asarray(toks)[None], slot, start,
            c, packs=js.packs)
        for i, (tl, jl) in enumerate(zip(tcache["blocks"],
                                         jcache["blocks"])):
            jm = jl["mix"] if "mix" in jl else jl
            np.testing.assert_array_equal(tl["mix"]["pos_map"].numpy(),
                                          np.asarray(jm["pos_map"]),
                                          err_msg=f"layer {i} at {start}")
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tl["mix"][name].numpy(), np.asarray(jm[name]),
                    atol=TOL_KV, err_msg=f"{name}, layer {i} at {start}")
    np.testing.assert_allclose(tlog[0, c - 1].numpy(),
                               np.asarray(jlog[0, c - 1]), atol=1e-4)
    ring = tcache["blocks"][0]["mix"]["pos_map"][0, slot]
    assert sorted(ring.tolist()) == list(range(21, 37))   # window-latest
    assert (tcache["blocks"][0]["mix"]["pos_map"][:, 0] == -1).all()


def test_chunk_boundary_on_window_edge():
    """Chunk boundaries exactly on the 16-position window edge and on ring
    wrap points do not perturb the stream."""
    js, ts, _ = _servables("windowed")
    prompts = _prompts(lens=(32, 16, 48))
    _, base = _drain(ts, prompts, max_new=8)
    sched = dict(max_chunk=16, token_budget=16)
    eng, chunked = _drain(ts, prompts, max_new=8, sched=SchedSpec(**sched))
    _assert_parity(base, chunked, "window-edge")
    eng.verify_invariants()
    _, jchunked = _drain(js, prompts, max_new=8, sched=JSched(**sched))
    assert _tokens(chunked) == _tokens(jchunked)


def test_chunked_prefill_shares_prefix_pages():
    """A completed request's full prompt pages publish when its chunked
    prefill completes, and a later sharer serves its prefix from them."""
    js, ts, _ = _servables("attn", kv_layout="paged", kv_page_size=8)
    shared = list(range(1, 33))
    prompts = [shared + [100, 101, 102], shared + [200, 201]]
    base_eng = ts.engine(max_slots=4, cache_len=64, max_queue=16)
    base = [base_eng.submit(p, max_new_tokens=6) for p in prompts]
    base_eng.run()
    eng = ts.engine(max_slots=4, cache_len=64, max_queue=16,
                    sched=SchedSpec(**SCHED))
    first = eng.submit(prompts[0], max_new_tokens=6)
    eng.run()                                   # publish prompt pages
    second = eng.submit(prompts[1], max_new_tokens=6)
    eng.run()                                   # prefix hit via pages
    _assert_parity(base, [first, second], "prefix+chunk")
    assert eng.stats.prefix_hit_tokens >= 32
    assert eng.stats.prefilled_tokens < sum(len(p) for p in prompts)
    eng.verify_invariants()


def test_preempt_resume_of_half_prefilled_request():
    """A request preempted mid-prefill (slot held, pos still -1) restarts
    its prefill on re-admission and ends with the exact greedy stream."""
    js, ts, _ = _servables("attn")
    prompt = _prompts(lens=(40,))[0]

    def run(sv, sched_cls):
        eng = sv.engine(max_slots=1, cache_len=64, max_queue=16,
                        sched=sched_cls(max_chunk=4, token_budget=4))
        a = eng.submit(prompt, max_new_tokens=6)
        for _ in range(3):
            eng.step()
        assert a.status == "active" and 0 < a.prefill_pos < a.prefill_target
        assert eng._pos[a.slot] == -1           # admitted, not decoding
        b = eng.submit([9, 8, 7], max_new_tokens=4, priority=10)
        eng.run()
        eng.verify_invariants()
        return a, b
    a, b = run(ts, SchedSpec)
    assert a.status == "done" and b.status == "done"
    assert a.n_preempted >= 1
    _, base = _drain(ts, [prompt])
    assert a.tokens == base[0].tokens
    ja, jb = run(js, JSched)
    assert (a.tokens, b.tokens, a.n_preempted) == (ja.tokens, jb.tokens,
                                                   ja.n_preempted)


def test_budget_prevents_head_of_line_blocking():
    """With a token budget a short prompt submitted behind a long one
    starts decoding (and finishes) before the long prefill completes."""
    _, ts, _ = _servables("attn")
    long_p = _prompts(lens=(48,))[0]
    eng = ts.engine(max_slots=2, cache_len=64, max_queue=16, sync_every=2,
                    sched=SchedSpec(max_chunk=8, token_budget=8,
                                    decode_priority=True))
    order = []
    a = eng.submit(long_p, max_new_tokens=4,
                   on_done=lambda rid, t: order.append("long"))
    b = eng.submit([5, 6, 7], max_new_tokens=4,
                   on_done=lambda rid, t: order.append("short"))
    eng.run()
    assert a.status == b.status == "done"
    assert order[0] == "short"
    assert b.first_token_at < a.first_token_at
    eng.verify_invariants()


def test_sched_spec_roundtrip_via_serving_spec():
    spec = ServingSpec(tile=(16, 16), sparsity=0.5, prune="oneshot",
                       targets=ATTN_TARGETS,
                       sched=SchedSpec(max_chunk=32, token_budget=64,
                                       fast_fail=True))
    back = ServingSpec.from_dict(spec.to_dict())
    assert back.sched == spec.sched
    _, ts, cfg = _servables("attn")
    sv = prepare_servable(ts.params, cfg, ServingSpec(**dict(
        spec.to_dict(), prune="none", sched=spec.sched)), device="cpu")
    eng = sv.engine(max_slots=2, cache_len=64)
    assert eng.sched == spec.sched and eng._chunking   # spec-level default
    eng2 = sv.engine(max_slots=2, cache_len=64, sched=SchedSpec(max_chunk=0))
    assert not eng2._chunking                          # kwarg overrides


# --------------------------------------------------------------------------
# deadline fast-fail, overload shedding (tests/test_sched.py)
# --------------------------------------------------------------------------

def _sched_prompts(n, lo=4, hi=9):
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (rng.randint(lo, hi),)).tolist()
            for _ in range(n)]


def _warm(eng, prompt):
    """One request to completion, so the engine has measured rates."""
    h = eng.submit(list(prompt), max_new_tokens=4)
    eng.run()
    assert h.done
    return h


def _pin_rates(eng, tok_per_s=1000.0):
    """Pin the measured-rate buckets to a known throughput (1 token == 1
    step == 1 ms), so service estimates are deterministic."""
    eng.stats.prefill_s = eng.stats.prefilled_tokens / tok_per_s
    eng.stats.decode_s = eng.stats.steps / tok_per_s


def test_expired_deadline_fails_at_submission():
    eng = _sv("sched").engine(max_slots=2, cache_len=64)
    h = eng.submit(_sched_prompts(1)[0], max_new_tokens=4, deadline_s=-0.001)
    assert h.status == "failed"
    assert h.failure.code == FailureReason.DEADLINE
    assert "at submission" in h.failure.message
    assert eng.stats.deadline_misses == 1
    assert eng.n_active == 0 and eng.stats.prefills == 0


def test_fast_fail_projects_from_measured_rates():
    eng = _sv("sched").engine(max_slots=2, cache_len=64,
                              sched=SchedSpec(fast_fail=True))
    prompt = list(range(1, 9))
    cold = eng.submit(prompt, max_new_tokens=4, deadline_s=30.0)
    assert cold.status == "queued"          # cold: estimation never guesses
    eng.run()
    assert cold.done
    _pin_rates(eng)                         # 1000 tok/s -> est ~0.012 s
    doomed = eng.submit(prompt, max_new_tokens=4, deadline_s=0.001)
    assert doomed.status == "failed"
    assert doomed.failure.code == FailureReason.DEADLINE
    assert "projected" in doomed.failure.message
    ok = eng.submit(prompt, max_new_tokens=4, deadline_s=30.0)
    eng.run()
    assert ok.done
    assert eng.stats.deadline_misses == 1
    eng.verify_invariants()


def test_overload_sheds_lowest_priority_newest_first(monkeypatch):
    """The lowest-priority newest request is shed once the estimated queue
    delay passes the bound. The engine's rate clock (``perf_counter``)
    advances 1 us a reading here, so the measured rates move only as
    ``_pin_rates`` sets them: on the wall clock, a loaded host makes the
    run slow enough that the blocker, preempted by the priority-5 request
    and requeued, is shed in turn (the reference's copy of this test reads
    the wall clock and fails under load)."""
    import itertools
    import types

    from repro_torch.serving import engine as engine_mod
    ticks = itertools.count()
    monkeypatch.setattr(engine_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 1e-6,
        monotonic=engine_mod.time.monotonic))
    eng = _sv("sched").engine(max_slots=1, cache_len=64, sync_every=2,
                              sched=SchedSpec(max_queue_delay_s=0.020))
    prompt = list(range(1, 9))
    _warm(eng, prompt)
    _pin_rates(eng)
    blocker = eng.submit(prompt, max_new_tokens=8)
    eng.step()
    assert blocker.status == "active"
    _pin_rates(eng)                         # re-pin: step() moved the rates
    a = eng.submit(prompt, max_new_tokens=4, priority=0)
    assert a.status == "queued"             # backlog 0.012 <= 0.020
    b = eng.submit(prompt, max_new_tokens=4, priority=5)
    assert b.status == "queued"             # the higher tier survives...
    assert a.status == "shed"               # ...the p0 request is shed
    assert a.failure.code == FailureReason.OVERLOAD
    assert "max_queue_delay_s" in a.failure.message
    c = eng.submit(prompt, max_new_tokens=4, priority=0)
    assert c.status == "shed"               # the newest lowest tier
    assert b.status == "queued"
    eng.run()
    assert blocker.done and b.done
    assert eng.stats.shed == 2
    eng.verify_invariants()
    for h in (blocker, a, b, c):
        assert h.status in TERMINAL_STATES


def test_cold_engine_never_sheds_at_submission():
    eng = _sv("sched").engine(max_slots=1, cache_len=64,
                              sched=SchedSpec(max_queue_delay_s=1e-9))
    hs = [eng.submit(p, max_new_tokens=4) for p in _sched_prompts(4)]
    assert all(h.status in ("queued", "active") for h in hs)
    eng.run()
    for h in hs:
        assert h.status in TERMINAL_STATES
    assert hs[0].done
    shed = [h for h in hs if h.status == "shed"]
    assert shed and all(h.failure.code == FailureReason.OVERLOAD
                        for h in shed)
    eng.verify_invariants()


# --------------------------------------------------------------------------
# watchdog snapshot and the open-loop chaos sites (tests/test_sched.py)
# --------------------------------------------------------------------------

def test_watchdog_snapshot_in_stats_dict():
    chaos = ChaosInjector()
    chaos.inject(SITE_SYNC, at=1, action=straggle(0.08))
    seen = []
    eng = _sv("sched").engine(max_slots=1, cache_len=64, max_queue=8,
                              watchdog_timeout_s=0.02, chaos=chaos,
                              on_stall=lambda label, s: seen.append(label))
    try:
        hs = [eng.submit(p, max_new_tokens=4) for p in _sched_prompts(3)]
        eng.run()
        assert all(h.done for h in hs)
        assert eng.stats.watchdog_stalls >= 1
        assert seen and seen[0] == "decode-window"
        snap = eng.stats_dict()["watchdog"]
        assert snap["site"] == "decode-window"
        # the watchdog trips at elapsed > timeout; the snapshot rounds to
        # 4 places, so a stall caught at 0.02004 s reads 0.02
        assert snap["elapsed_s"] >= 0.02
        assert snap["stalls"] == eng.stats.watchdog_stalls
        assert snap["n_active"] + snap["n_queued"] >= 1
        for row in snap["active"] + snap["queued"]:
            assert {"req_id", "status", "prefill_pos", "prefill_target",
                    "n_generated", "age_s"} <= set(row)
    finally:
        eng.close()


def test_arrival_burst_action_conserves_every_submission():
    chaos = ChaosInjector()
    burst = []

    def storm(ctx):
        e = ctx["engine"]
        burst.extend(e.submit([7, 7, 7], max_new_tokens=3)
                     for _ in range(5))
    chaos.inject(SITE_ARRIVAL_BURST, at=1, action=storm)
    eng = _sv("sched").engine(max_slots=2, cache_len=64, max_queue=4,
                              overflow="reject", chaos=chaos)
    hs = [eng.submit(p, max_new_tokens=4) for p in _sched_prompts(3)]
    eng.run()
    assert chaos.fired(SITE_ARRIVAL_BURST) == 1
    all_reqs = burst + hs
    assert len(all_reqs) == 8
    for h in all_reqs:
        assert h.status in TERMINAL_STATES, h.req_id
    assert any(h.status == "shed" for h in burst)
    assert (eng.stats.completed + eng.stats.failed + eng.stats.cancelled
            + eng.stats.shed == len(all_reqs))
    eng.verify_invariants()


def test_arrival_burst_exception_sheds_only_that_submission():
    chaos = ChaosInjector()
    chaos.inject(SITE_ARRIVAL_BURST, at=2, exc=RuntimeError("ingest down"))
    eng = _sv("sched").engine(max_slots=2, cache_len=64, chaos=chaos)
    hs = [eng.submit(p, max_new_tokens=4) for p in _sched_prompts(3)]
    assert hs[1].status == "shed"
    assert hs[1].failure.code == FailureReason.OVERLOAD
    assert "ingest" in hs[1].failure.message
    eng.run()
    assert hs[0].done and hs[2].done
    eng.verify_invariants()


def test_prefill_chunk_fault_contains_blast_radius():
    """A fault at the second chunk of the long prompt fails only that
    request; the co-resident request's stream equals an uninjected chunked
    run, and the engine then serves the faulted prompt."""
    sched = SchedSpec(max_chunk=8, token_budget=32)
    long_p = _sched_prompts(1, lo=24, hi=25)[0]
    short_p = _sched_prompts(1)[0]
    sv = _sv("sched")
    ref_eng = sv.engine(max_slots=2, cache_len=64, sched=sched)
    refs = [ref_eng.submit(p, max_new_tokens=5) for p in (long_p, short_p)]
    ref_eng.run()
    assert all(h.done for h in refs)

    chaos = ChaosInjector()
    chaos.inject(SITE_PREFILL_CHUNK, at=2, exc=RuntimeError("chunk lost"))
    eng = sv.engine(max_slots=2, cache_len=64, sched=sched, chaos=chaos)
    hs = [eng.submit(p, max_new_tokens=5) for p in (long_p, short_p)]
    eng.run()
    failed = [h for h in hs if h.status == "failed"]
    assert len(failed) == 1 and failed[0] is hs[0]
    assert failed[0].failure.code == FailureReason.PREFILL_ERROR
    assert hs[1].done and hs[1].tokens == refs[1].tokens
    eng.verify_invariants()
    assert eng.n_free == eng.max_slots and eng.n_active == 0
    retry = eng.submit(long_p, max_new_tokens=5)
    eng.run()
    assert retry.done and retry.tokens == refs[0].tokens
    assert eng.stats.prefill_chunks > 0
    eng.verify_invariants()


def test_prefill_chunk_straggler_trips_chunk_watchdog():
    """straggle() at the chunk site stalls the armed 'prefill-chunk'
    section (the port arms before the site fires); the snapshot shows the
    mid-prefill row."""
    chaos = ChaosInjector()
    chaos.inject(SITE_PREFILL_CHUNK, at=2, action=straggle(0.08))
    snaps = []          # each stall's snapshot (stats_dict keeps the last)
    eng = _sv("sched").engine(
        max_slots=1, cache_len=64, watchdog_timeout_s=0.02, chaos=chaos,
        sched=SchedSpec(max_chunk=8, token_budget=8),
        on_stall=lambda label, s: snaps.append(eng.stats_dict()["watchdog"]))
    try:
        h = eng.submit(list(range(1, 25)), max_new_tokens=4)
        eng.run()
        assert h.done
        assert eng.stats.watchdog_stalls >= 1
        chunk = [sn for sn in snaps if sn["site"] == "prefill-chunk"]
        assert chunk and any(r["prefill_target"] > 0
                             for r in chunk[0]["active"])
    finally:
        eng.close()


def test_every_chunk_length_has_a_k1_instance_and_none_raises():
    """Chunk prefill hands K1 every M from 1 to max_chunk (tails of any
    length): ``plan_instance`` has an instance for each, and a call that no
    instance takes raises instead of being padded to fit."""
    from repro_torch.kernels import bsr_matmul as bm
    for m in range(1, 257):
        inst = bm.plan_instance(m, (128, 128), torch.bfloat16,
                                torch.bfloat16)
        assert inst == ("stream" if m <= bm.STREAM_MAX_M else "tc"), m
    with pytest.raises(ValueError, match="no instance of .* takes M=37"):
        bm._choose("plan_dds", None, ("stream", "tc"),
                   lambda *a: False, (37,), "M=37")
