"""The port's enc-dec backbone (``models/encdec.py``) and cross-attention
(``attention.apply_attention(kv_override=...)``) against the JAX reference,
on the whisper_base smoke config (fp32) with JAX-initialised weights bridged
as numpy: ``encode``, the teacher-forced ``forward``, ``init_cache`` (self
caches + cross K/V), ``decode_step`` at ragged positions with an inactive
row (its cache bitwise untouched), and the slot ops -- every leaf layer-
stacked with the slot at axis 1, a reset zeroing the slot's cross K/V too.
fp32 logits of the two packages agree to 1e-4 (sums in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402

from test_torch_lm import _assert_cache_equal, _np, _t  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("whisper_base", smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, get_config("whisper_base", smoke=True), jp, tp


def _frames(cfg, b, seed=0):
    return np.random.RandomState(seed).randn(
        b, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)


def test_encode_matches_jax(model):
    jcfg, cfg, jp, tp = model
    fr = _frames(cfg, 2)
    want = jencdec.encode(jp, jcfg, jnp.asarray(fr))
    got = tencdec.encode(tp, cfg, _t(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_forward_matches_jax(model):
    jcfg, cfg, jp, tp = model
    fr = _frames(cfg, 2, 1)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 12))
    want, jaux = japi.model_forward(jp, jcfg, {"frames": jnp.asarray(fr),
                                               "tokens": jnp.asarray(toks)})
    got, aux = tapi.model_forward(tp, cfg, {"frames": _t(fr),
                                            "tokens": _t(toks)})
    assert got.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_init_cache_matches_jax(model):
    """The self caches start empty (pos_map -1), one per decoder layer; the
    cross K/V are the encoder output's projections."""
    jcfg, cfg, jp, tp = model
    fr = _frames(cfg, 3, 2)
    jc = japi.init_cache(jp, jcfg, 3, 24, frames=jnp.asarray(fr))
    tc = tapi.init_cache(tp, cfg, 3, 24, frames=_t(fr))
    _assert_cache_equal(tc, jc)
    assert tc["self"]["k"].shape == (cfg.n_layers, 3, 24, cfg.n_kv_heads,
                                     cfg.head_dim)
    assert bool((tc["self"]["pos_map"] == -1).all())
    # real storage per layer, not a broadcast view
    tc["self"]["k"][0].fill_(1.0)
    assert float(tc["self"]["k"][1].abs().max()) == 0.0


def test_decode_step_ragged_inactive_matches_jax(model):
    """Ten decode steps over three slots at ragged positions, slot 1
    inactive from step 4: live logits and the caches are the reference's;
    the inactive slot's leaves stay bitwise as they were."""
    jcfg, cfg, jp, tp = model
    fr = _frames(cfg, 3, 3)
    jc = japi.init_cache(jp, jcfg, 3, 24, frames=jnp.asarray(fr))
    tc = tapi.init_cache(tp, cfg, 3, 24, frames=_t(fr))
    rng = np.random.RandomState(4)
    pos = np.array([0, 3, 7], np.int32)
    for step in range(10):
        if step == 4:
            pos[1] = -1
        frozen = tapi.read_slot(tc, cfg, 1) if pos[1] < 0 else None
        tok = rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = japi.decode_step(jp, jc, jcfg, jnp.asarray(tok),
                                  jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, cfg, _t(tok), _t(pos))
        live = pos >= 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=TOL)
        if frozen is not None:
            after = _np(tapi.read_slot(tc, cfg, 1))
            for name, x in _np(frozen).items():
                np.testing.assert_array_equal(after[name], x, err_msg=name)
        pos = np.where(pos >= 0, pos + 1, pos)
    _assert_cache_equal(tc, jc)


def test_slot_ops_match_jax(model):
    """write_slot installs a batch-1 cache (cross K/V included), read_slot
    is its inverse, reset_slot zeroes the self KV (pos_map -1) AND the
    cross K/V -- as the reference's slot ops do."""
    jcfg, cfg, jp, tp = model
    fr = _frames(cfg, 2, 5)
    sub_fr = _frames(cfg, 1, 6)
    jc = japi.init_cache(jp, jcfg, 2, 16, frames=jnp.asarray(fr))
    tc = tapi.init_cache(tp, cfg, 2, 16, frames=_t(fr))
    jsub = japi.init_cache(jp, jcfg, 1, 16, frames=jnp.asarray(sub_fr))
    tsub = tapi.init_cache(tp, cfg, 1, 16, frames=_t(sub_fr))
    tok = np.array([[7]], np.int32)
    jsub = japi.decode_step(jp, jsub, jcfg, jnp.asarray(tok), 0)[1]
    tsub = tapi.decode_step(tp, tsub, cfg, _t(tok), 0)[1]
    jc = japi.write_slot(jc, jcfg, 1, jsub)
    tc = tapi.write_slot(tc, cfg, 1, tsub)
    _assert_cache_equal(tc, jc)
    _assert_cache_equal(tapi.read_slot(tc, cfg, 1), japi.read_slot(
        jc, jcfg, 1))
    jc = japi.reset_slot(jc, jcfg, 1)
    tc = tapi.reset_slot(tc, cfg, 1)
    _assert_cache_equal(tc, jc)
    assert float(tc["cross_k"][:, 1].abs().max()) == 0.0
    assert float(tc["cross_v"][:, 1].abs().max()) == 0.0
    assert bool((tc["self"]["pos_map"][:, 1] == -1).all())
    assert float(tc["cross_k"][:, 0].abs().max()) > 0.0


@pytest.mark.parametrize("mode", ["forward", "decode"])
def test_cross_attention_kv_override_matches_jax(model, mode):
    """Cross-attention over given K/V: q projected (no RoPE), K/V used as
    they are; without a cache it attends every position, with one (``{}``)
    the single-token decode over all T_audio positions."""
    jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(8)
    lp_j = jax.tree.map(lambda x: x[0], jp["dec_layers"])["xattn"]
    lp_t = {k: {"w": v["w"][0]} for k, v in tp["dec_layers"]["xattn"].items()}
    s = 5 if mode == "forward" else 1
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    k = rng.randn(2, 40, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    v = rng.randn(2, 40, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    pos = np.array([3, 9], np.int32)
    kw_j = dict(positions=jnp.asarray(pos)[:, None] if s == 1 else
                jnp.arange(s)[None], kv_override=(jnp.asarray(k),
                                                  jnp.asarray(v)),
                causal=False)
    kw_t = dict(positions=_t(pos)[:, None] if s == 1 else
                torch.arange(s)[None], kv_override=(_t(k), _t(v)),
                causal=False)
    if mode == "decode":
        kw_j.update(cache={}, pos=jnp.asarray(pos))
        kw_t.update(cache={}, pos=_t(pos))
    want, _ = jattn.apply_attention(lp_j, jnp.asarray(x), jcfg, **kw_j)
    got, _ = tattn.apply_attention(lp_t, _t(x), cfg, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
