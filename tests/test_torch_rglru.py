"""The port's RG-LRU block (``models/rglru.py``) against the JAX reference,
on the recurrentgemma_9b smoke config (fp32) with JAX-initialised weights
bridged as numpy:

* ``softplus`` against ``jax.nn.softplus`` (``logaddexp(x, 0)``, not
  torch's thresholded formula) within 2 ulps -- the two libraries' exp and
  log1p round differently -- NaN and large inputs included;
* the parallel scan against ``jax.lax.associative_scan`` up to S = 1100:
  the same odd/even recursion, so the carried h is bitwise equal; the
  decay products agree except in the subnormal range, which XLA flushes
  to zero (|d| <= the smallest normal fp32, 1.18e-38);
* the scan against the plain sequential recurrence at S = 1100;
* ``apply_rglru`` in its four modes -- the forward, the one-pass prefill
  (padding steps a = 1, u = 0), a chunk continued from a slot's carried h
  and conv history, the decode step with ragged and inactive rows
  (inactive rows bitwise untouched).

Module tolerances are in units of max|y| (the matmuls may sum in another
order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.common import softplus  # noqa: E402

from test_torch_ssm import _close, _t, _xin  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    jcfg = jax_config("recurrentgemma_9b", smoke=True)
    jp = jrg.init_rglru(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, get_config("recurrentgemma_9b", smoke=True), jp, tp


def test_softplus_matches_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.array([np.nan, np.inf, -np.inf, 88.0, 1e-8],
                                 np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = softplus(_t(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_max_ulp(got[~np.isnan(want)],
                                    want[~np.isnan(want)], maxulp=2)


def _scan_inputs(seed, b, s, w):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    u = rng.randn(b, s, w).astype(np.float32)
    return a, u


def _jax_scan(a, u):
    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]
    return jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(u)),
                                    axis=1)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 300, 1100])
def test_associative_scan_matches_jax(s):
    a, u = _scan_inputs(s, 2, s, 24)
    ja, jh = _jax_scan(a, u)
    ta, th = trg.associative_scan(_t(a), _t(u))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=TINY)
    normal = np.abs(np.asarray(ja)) >= TINY
    np.testing.assert_array_equal(ta.numpy()[normal], np.asarray(ja)[normal])


def test_scan_equals_sequential_recurrence_at_1100():
    """h_t = a_t h_{t-1} + u_t in order, fp64, against the scan: the
    recursion's reassociation stays within 1e-5 of max|h|."""
    a, u = _scan_inputs(11, 2, 1100, 24)
    _, th = trg.associative_scan(_t(a), _t(u))
    h = np.zeros((2, 24))
    ref = np.zeros((2, 1100, 24))
    for t in range(1100):
        h = a[:, t].astype(np.float64) * h + u[:, t]
        ref[:, t] = h
    _close(th.numpy().astype(np.float64), ref, what="h")


def test_apply_rglru_forward_matches_jax(block):
    jcfg, cfg, jp, tp = block
    x = _xin(1, 2, 45, cfg.d_model)
    jy, _ = jrg.apply_rglru(jp, jnp.asarray(x), jcfg)
    ty, _ = trg.apply_rglru(tp, _t(x), cfg)
    _close(ty, jy, what="forward")


@pytest.mark.parametrize("length", [37, 40, 2])
def test_apply_rglru_prefill_matches_jax(block, length):
    """One-pass prefill of a 40-step bucket: the output, h at length-1 and
    the conv history; a reused cache keeps nothing of its old content."""
    jcfg, cfg, jp, tp = block
    x = _xin(2, 1, 40, cfg.d_model)
    jc = jrg.init_cache_rglru(jcfg, 1)
    tc = trg.init_cache_rglru(cfg, 1)
    tc["h"].fill_(3.0)
    tc["conv"].fill_(-2.0)
    jy, jc = jrg.apply_rglru(jp, jnp.asarray(x), jcfg, cache=jc,
                             prefill_len=length)
    ty, tc = trg.apply_rglru(tp, _t(x), cfg, cache=tc, prefill_len=length)
    _close(ty[:, :length], np.asarray(jy)[:, :length], what="y")
    _close(tc["h"], jc["h"], what="h")
    _close(tc["conv"], jc["conv"], what="conv")


def test_apply_rglru_chunk_continuation_matches_jax(block):
    """Slot 1 of a 3-slot cache takes a prompt in two chunks (the second
    bucket-padded), the carried h injected as aa * h_prev + hh; the other
    slots stay bitwise as they were."""
    jcfg, cfg, jp, tp = block
    rng = np.random.RandomState(3)
    one = trg.init_cache_rglru(cfg, 3)
    hh = rng.randn(*one["h"].shape).astype(np.float32)
    cv = rng.randn(*one["conv"].shape).astype(np.float32)
    jc = {"h": jnp.asarray(hh), "conv": jnp.asarray(cv)}
    tc = {"h": _t(hh), "conv": _t(cv)}
    before = {k: v.clone() for k, v in tc.items()}
    for n, length in ((24, 24), (16, 9)):
        x = _xin(n + length, 1, n, cfg.d_model)
        jy, jc = jrg.apply_rglru(jp, jnp.asarray(x), jcfg, cache=jc,
                                 prefill_len=length, page_slot=1)
        ty, tc = trg.apply_rglru(tp, _t(x), cfg, cache=tc,
                                 prefill_len=length, page_slot=1)
        _close(ty[:, :length], np.asarray(jy)[:, :length], what="y")
        _close(tc["h"], jc["h"], what="h")
        _close(tc["conv"], jc["conv"], what="conv")
    for k in tc:
        for slot in (0, 2):
            assert torch.equal(tc[k][slot], before[k][slot]), k


def test_apply_rglru_decode_ragged_inactive_matches_jax(block):
    """Eight decode steps over four slots, slot 2 inactive throughout and
    slot 3 from step 4: outputs and caches are the reference's, inactive
    rows bitwise untouched."""
    jcfg, cfg, jp, tp = block
    rng = np.random.RandomState(4)
    one = trg.init_cache_rglru(cfg, 4)
    hh = rng.randn(*one["h"].shape).astype(np.float32)
    cv = rng.randn(*one["conv"].shape).astype(np.float32)
    jc = {"h": jnp.asarray(hh), "conv": jnp.asarray(cv)}
    tc = {"h": _t(hh), "conv": _t(cv)}
    pos = np.array([5, 17, -1, 2], np.int32)
    for step in range(8):
        if step == 4:
            pos[3] = -1
        frozen = {k: v[pos < 0].clone() for k, v in tc.items()}
        x = _xin(10 + step, 4, 1, cfg.d_model)
        jy, jc = jrg.apply_rglru(jp, jnp.asarray(x), jcfg, cache=jc,
                                 pos=jnp.asarray(pos))
        ty, tc = trg.apply_rglru(tp, _t(x), cfg, cache=tc, pos=_t(pos))
        live = pos >= 0
        _close(ty[live], np.asarray(jy)[live], what="y")
        _close(tc["h"], jc["h"], what="h")
        _close(tc["conv"], jc["conv"], what="conv")
        for k, v in tc.items():
            assert torch.equal(v[pos < 0], frozen[k]), k
        pos = np.where(pos >= 0, pos + 1, pos)
