"""Chaos sites and the watchdog of the port's engine: the engine cases of
``tests/test_chaos.py`` (every fault class at the engine's hook points:
structured failures for the targeted requests only, every other request's
tokens equal to an uninjected run, no slot leak, the queue conserved, the
engine serving afterwards; slot hygiene after a mid-step exception) and
the watchdog and prefill-failure cases of ``tests/test_engine_lifecycle.py``
(a straggling window trips it, a healthy engine stays quiet). The
uninjected runs are also held against the JAX engine's tokens."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import LayerKind as JKind  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: E402
from repro_torch.runtime import chaos as chaos_mod  # noqa: E402
from repro_torch.runtime.chaos import (SITE_ALLOC, SITE_PAGE_ALLOC,  # noqa
                                       SITE_PREFILL, SITE_SYNC, SITE_WINDOW,
                                       ChaosInjector, poison_slot, straggle)
from repro_torch.serving import (FailureReason, ServingSpec,  # noqa: E402
                                 TERMINAL_STATES, prepare_servable)

ATTN_TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
_SV = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _servables(layout="dense"):
    """(JAX, port) servables of the reference's chaos-smoke config on the
    same weights."""
    if layout not in _SV:
        kw = dict(arch="chaos-smoke", family="dense", n_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=256, dtype="float32")
        jcfg = JConfig(pattern=(JKind("attn", "dense"),), **kw)
        tcfg = ModelConfig(pattern=(LayerKind("attn", "dense"),), **kw)
        jp = j_init(jax.random.PRNGKey(1), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        spec = dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                    targets=ATTN_TARGETS, kv_layout=layout)
        _SV[layout] = (j_prepare(jp, jcfg, JSpec(**spec)),
                       prepare_servable(tp, tcfg, ServingSpec(**spec),
                                        device="cpu"))
    return _SV[layout]


def _prompts(n, seed=3, lo=4, hi=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (rng.randint(lo, hi),)).tolist()
            for _ in range(n)]


def _reference_tokens(sv, prompts, max_new=6, sync_every=3):
    eng = sv.engine(max_slots=2, cache_len=64, sync_every=sync_every)
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    assert all(h.done for h in hs)
    return [list(h.tokens) for h in hs]


def _arm(chaos, fault):
    """Arm one fault class; returns the FailureReason code the targeted
    request must fail with (None = no request may fail)."""
    if fault == "alloc":
        chaos.inject(SITE_ALLOC, at=2, exc=MemoryError("no slot memory"))
        return FailureReason.PREFILL_ERROR
    if fault == "prefill":
        chaos.inject(SITE_PREFILL, at=2, exc=RuntimeError("bad prefill"))
        return FailureReason.PREFILL_ERROR
    if fault == "nan-window":
        chaos.inject(SITE_WINDOW, at=2, action=poison_slot())
        return FailureReason.NONFINITE_LOGITS
    if fault == "window-error":
        chaos.inject(SITE_WINDOW, at=2, exc=RuntimeError("device lost"))
        return FailureReason.ENGINE_ERROR
    if fault == "straggler":
        chaos.inject(SITE_SYNC, at=1, action=straggle(0.05))
        return None
    if fault == "page-alloc":
        chaos.inject(SITE_PAGE_ALLOC, at=2, exc=RuntimeError("pool lost"))
        return FailureReason.PREFILL_ERROR
    raise AssertionError(fault)


@pytest.mark.parametrize("layout,fault", [
    ("dense", "alloc"), ("dense", "prefill"), ("dense", "nan-window"),
    ("dense", "window-error"), ("dense", "straggler"),
    ("paged", "nan-window"), ("paged", "page-alloc")])
def test_engine_survives_fault_class(layout, fault):
    """Every fault class: structured failures for the targeted requests
    only, the other requests' tokens equal to the uninjected run (itself
    equal to the JAX engine's), no slot leak, the queue conserved, and the
    engine serving afterwards."""
    js, ts = _servables(layout)
    prompts = _prompts(4)
    ref = _reference_tokens(ts, prompts)
    assert ref == _reference_tokens(js, prompts)
    chaos = ChaosInjector()
    code = _arm(chaos, fault)
    eng = ts.engine(max_slots=2, cache_len=64, sync_every=3, chaos=chaos)
    hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for h in hs:
        assert h.status in TERMINAL_STATES
    failed = [h for h in hs if h.status == "failed"]
    if code is None:
        assert not failed
    else:
        assert failed, f"fault {fault!r} never failed a request"
        for h in failed:
            assert h.failure is not None and h.failure.code == code
        assert chaos.fired() >= 1
    for h, want in zip(hs, ref):
        if h.status == "done":
            assert h.tokens == want, (fault, h.req_id)
    if fault == "window-error":
        assert len(failed) <= 2 and sum(h.done for h in hs) >= 2
    eng.verify_invariants()
    assert eng.n_free == eng.max_slots and eng.n_active == 0
    assert (eng.stats.completed + eng.stats.failed + eng.stats.cancelled
            + eng.stats.shed == len(hs))
    again = [eng.submit(p, max_new_tokens=6) for p in prompts[:2]]
    eng.run()
    for h, want in zip(again, ref[:2]):
        assert h.done and h.tokens == want


def test_slot_hygiene_under_mid_step_exception():
    """A failure mid-step leaks nothing: freed == fresh, and the same
    engine serves the failed request's prompt to the reference tokens."""
    _, ts = _servables()
    prompts = _prompts(2)
    ref = _reference_tokens(ts, prompts)
    chaos = ChaosInjector()
    chaos.inject(SITE_PREFILL, at=1, exc=RuntimeError("first admission"))
    eng = ts.engine(max_slots=2, cache_len=64, sync_every=3, chaos=chaos)
    hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    assert hs[0].status == "failed"
    assert hs[0].failure.code == FailureReason.PREFILL_ERROR
    assert hs[1].done and hs[1].tokens == ref[1]
    eng.verify_invariants()
    assert eng.n_free == eng.max_slots
    retry = eng.submit(prompts[0], max_new_tokens=6)
    eng.run()
    assert retry.done and retry.tokens == ref[0]
    assert eng.stats.prefills == 2          # the failed admission not counted


def test_prefill_failure_is_isolated_to_its_request():
    _, ts = _servables()
    chaos = chaos_mod.ChaosInjector()
    eng = ts.engine(max_slots=2, cache_len=64, sync_every=2, chaos=chaos)
    chaos.inject(chaos_mod.SITE_PREFILL, at=2,
                 exc=RuntimeError("injected prefill blow-up"))
    life = _prompts(2, seed=11, hi=10)
    ok = eng.submit(life[0], max_new_tokens=4)
    bad = eng.submit(life[1], max_new_tokens=4)
    eng.run()
    assert ok.done
    assert bad.status == "failed"
    assert bad.failure.code == FailureReason.PREFILL_ERROR
    assert "injected prefill blow-up" in bad.failure.message
    eng.verify_invariants()
    assert eng.n_free == eng.max_slots


def test_watchdog_detects_straggler_window():
    """A straggling sync trips the armed watchdog; the request completes
    (detection only) and stats_dict() reports the stall."""
    _, ts = _servables()
    stalls = []
    chaos = chaos_mod.ChaosInjector()
    chaos.inject(chaos_mod.SITE_SYNC, at=1, action=chaos_mod.straggle(0.25))
    eng = ts.engine(max_slots=1, cache_len=64, sync_every=2,
                    watchdog_timeout_s=0.05, chaos=chaos,
                    on_stall=lambda label, s: stalls.append((label, s)))
    try:
        h = eng.submit(_prompts(1, seed=11, hi=10)[0], max_new_tokens=4)
        eng.run()
        assert h.done
        assert eng.stats.watchdog_stalls >= 1
        assert stalls and stalls[0][0] == "decode-window"
        assert stalls[0][1] > 0.05
        wd = eng.stats_dict()["watchdog"]
        assert wd["stalls"] >= 1 and wd["site"] == "decode-window"
    finally:
        eng.close()


def test_watchdog_quiet_on_healthy_engine():
    _, ts = _servables()
    eng = ts.engine(max_slots=2, cache_len=64, sync_every=2,
                    watchdog_timeout_s=30.0)
    try:
        hs = [eng.submit(p, max_new_tokens=4)
              for p in _prompts(3, seed=11, hi=10)]
        eng.run()
        assert all(h.done for h in hs)
        assert eng.stats.watchdog_stalls == 0
        wd = eng.stats_dict()["watchdog"]
        assert wd == {"timeout_s": 30.0, "stalls": 0}
    finally:
        eng.close()
    eng.close()                             # idempotent
