"""The port's Mamba-2 SSD mixer (``models/ssm.py``) and the shared conv
history helper against the JAX reference, on the mamba2_780m smoke config
(fp32) with JAX-initialised weights bridged as numpy:

* ``prefill_conv_history`` bitwise, prompts shorter and longer than the
  conv window;
* ``_ssd_chunked`` against the reference's and against the step-by-step
  recurrence (``tests/test_models.py``'s check), padded last chunk and a
  seeded initial state;
* ``apply_ssm`` in its four modes -- the whole-sequence forward, the
  one-pass prompt prefill (bucket padding are identity steps), a chunk
  continued from a slot's state, the O(1) decode step with ragged and
  inactive rows (inactive rows bitwise untouched).

Tolerances are stated in units of max|y|: the two packages compute the
same fp32 products, but ``cumsum`` and the einsums may sum in another
order."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

# max |port - reference| in units of max |reference|
REL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, \
        f"{what}: max|d| {err:.3e} > {rel} x {scale:.3e}"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixer():
    jcfg = jax_config("mamba2_780m", smoke=True)
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    # non-trivial decay, dt and skip: the init's zeros / ones would leave
    # A = -1 and dt_bias = 0 for every head
    rng = np.random.RandomState(0)
    h = jp["A_log"].shape[0]
    jp = dict(jp, A_log=jnp.asarray(rng.randn(h).astype(np.float32) * 0.5),
              dt_bias=jnp.asarray(rng.randn(h).astype(np.float32)),
              D=jnp.asarray(rng.randn(h).astype(np.float32)),
              conv_b=jnp.asarray(rng.randn(*jp["conv_b"].shape).astype(
                  np.float32) * 0.1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, get_config("mamba2_780m", smoke=True), jp, tp


@pytest.mark.parametrize("s,length", [(16, 16), (16, 11), (16, 2), (8, 1)])
def test_prefill_conv_history_bytes(s, length):
    """The conv cache after a one-pass prefill: the last W-1 real inputs,
    zero-filled in front for prompts shorter than the window."""
    rng = np.random.RandomState(s + length)
    x = rng.randn(2, s, 5).astype(np.float32)
    valid = (np.arange(s) < length)[None, :, None]
    want = jcommon.prefill_conv_history(jnp.asarray(x), jnp.asarray(valid),
                                        length, 3, jnp.float32)
    got = tcommon.prefill_conv_history(_t(x), _t(valid), length, 3,
                                       torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.abs(rng.randn(b, s, h)).astype(np.float32) * 0.5
    a_neg = -np.abs(rng.randn(h)).astype(np.float32)
    da = (dt * a_neg[None, None, :]).astype(np.float32)
    bm = rng.randn(b, s, n).astype(np.float32)
    cm = rng.randn(b, s, n).astype(np.float32)
    return x, dt, da, bm, cm


@pytest.mark.parametrize("s,chunk,seeded", [(64, 16, False), (50, 16, False),
                                            (50, 16, True), (7, 32, True)])
def test_ssd_chunked_matches_jax(s, chunk, seeded):
    """y and the final state against the reference's _ssd_chunked: a
    padded last chunk (s = 50), a single short chunk, a seeded state."""
    b, h, p, n = 2, 3, 4, 8
    x, dt, da, bm, cm = _ssd_inputs(s, b, s, h, p, n)
    init = (np.random.RandomState(9).randn(b, h, p, n).astype(np.float32)
            if seeded else None)
    jy, jst = jssm._ssd_chunked(
        *map(jnp.asarray, (x, dt, da, bm, cm)), chunk, return_state=True,
        initial_state=None if init is None else jnp.asarray(init))
    ty, tst = tssm._ssd_chunked(*map(_t, (x, dt, da, bm, cm)), chunk,
                                initial_state=None if init is None
                                else _t(init))
    _close(ty, jy, what="y")
    _close(tst, jst, what="state")


def test_ssd_chunked_equals_recurrence():
    """Chunked SSD == the step-by-step linear recurrence
    (``tests/test_models.py::test_ssd_chunked_equals_recurrence``)."""
    b, s, h, p, n = 1, 64, 2, 4, 8
    x, dt, da, bm, cm = _ssd_inputs(5, b, s, h, p, n)
    y, final = tssm._ssd_chunked(*map(_t, (x, dt, da, bm, cm)), 16)
    state = np.zeros((b, h, p, n), np.float32)
    ref = np.zeros_like(y.numpy())
    for t in range(s):
        decay = np.exp(da[:, t])[..., None, None]
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        state = state * decay + upd
        ref[:, t] = np.einsum("bhpn,bn->bhp", state, cm[:, t])
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(final.numpy(), state, rtol=1e-3, atol=1e-3)


def _xin(seed, b, s, d):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def test_apply_ssm_forward_matches_jax(mixer):
    jcfg, cfg, jp, tp = mixer
    x = _xin(1, 2, 45, cfg.d_model)
    jy, _ = jssm.apply_ssm(jp, jnp.asarray(x), jcfg)
    ty, _ = tssm.apply_ssm(tp, _t(x), cfg)
    _close(ty, jy, what="forward")


@pytest.mark.parametrize("length", [37, 40, 2])
def test_apply_ssm_prefill_matches_jax(mixer, length):
    """One-pass prefill of a 40-step bucket: the output and the rewritten
    cache (state at length-1, conv history) are the reference's; a reused
    cache keeps nothing of its previous content."""
    jcfg, cfg, jp, tp = mixer
    x = _xin(2, 1, 40, cfg.d_model)
    jc = jssm.init_cache_ssm(jcfg, 1)
    tc = tssm.init_cache_ssm(cfg, 1)
    tc["state"].fill_(3.0)
    tc["conv"].fill_(-2.0)
    jy, jc = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, cache=jc,
                            prefill_len=length)
    ty, tc = tssm.apply_ssm(tp, _t(x), cfg, cache=tc, prefill_len=length)
    _close(ty[:, :length], np.asarray(jy)[:, :length], what="y")
    _close(tc["state"], jc["state"], what="state")
    _close(tc["conv"], jc["conv"], what="conv")


def test_apply_ssm_chunk_continuation_matches_jax(mixer):
    """Slot 1 of a 3-slot cache takes a prompt in two chunks (the second
    bucket-padded), continuing from its state and conv history; the other
    slots stay bitwise as they were."""
    jcfg, cfg, jp, tp = mixer
    rng = np.random.RandomState(3)
    st = rng.randn(3, *tssm.init_cache_ssm(cfg, 1)["state"].shape[1:])
    cv = rng.randn(3, *tssm.init_cache_ssm(cfg, 1)["conv"].shape[1:])
    jc = {"state": jnp.asarray(st.astype(np.float32)),
          "conv": jnp.asarray(cv.astype(np.float32))}
    tc = {"state": _t(st.astype(np.float32)), "conv": _t(cv.astype(
        np.float32))}
    before = {k: v.clone() for k, v in tc.items()}
    for n, length in ((24, 24), (16, 9)):
        x = _xin(n + length, 1, n, cfg.d_model)
        jy, jc = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, cache=jc,
                                prefill_len=length, page_slot=1)
        ty, tc = tssm.apply_ssm(tp, _t(x), cfg, cache=tc, prefill_len=length,
                                page_slot=1)
        _close(ty[:, :length], np.asarray(jy)[:, :length], what="y")
        _close(tc["state"], jc["state"], what="state")
        _close(tc["conv"], jc["conv"], what="conv")
    for k in tc:
        for slot in (0, 2):
            assert torch.equal(tc[k][slot], before[k][slot]), k


def test_apply_ssm_decode_ragged_inactive_matches_jax(mixer):
    """Eight decode steps over four slots at ragged positions, slot 2
    inactive throughout and slot 3 from step 4: outputs and caches are the
    reference's, inactive rows bitwise untouched."""
    jcfg, cfg, jp, tp = mixer
    rng = np.random.RandomState(4)
    shape = tssm.init_cache_ssm(cfg, 4)
    st = rng.randn(*shape["state"].shape).astype(np.float32)
    cv = rng.randn(*shape["conv"].shape).astype(np.float32)
    jc = {"state": jnp.asarray(st), "conv": jnp.asarray(cv)}
    tc = {"state": _t(st), "conv": _t(cv)}
    pos = np.array([5, 17, -1, 2], np.int32)
    for step in range(8):
        if step == 4:
            pos[3] = -1
        frozen = {k: v[pos < 0].clone() for k, v in tc.items()}
        x = _xin(10 + step, 4, 1, cfg.d_model)
        jy, jc = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, cache=jc,
                                pos=jnp.asarray(pos))
        ty, tc = tssm.apply_ssm(tp, _t(x), cfg, cache=tc, pos=_t(pos))
        live = pos >= 0
        _close(ty[live], np.asarray(jy)[live], what="y")
        _close(tc["state"], jc["state"], what="state")
        _close(tc["conv"], jc["conv"], what="conv")
        for k, v in tc.items():
            assert torch.equal(v[pos < 0], frozen[k]), k
        pos = np.where(pos >= 0, pos + 1, pos)
