"""The port's Multi-head Latent Attention (``models/mla.py``) against the JAX
reference, fp32, on JAX-initialised weights bridged as numpy: the expanded
path without a cache (full attention, and chunked flash attention past
1024 positions), the one-pass prompt prefill and its latent cache, the
chunk / suffix prefill on dense and paged latents, the absorbed decode at
ragged positions with an inactive row (dense and paged), the paged slot
ops on latent pools, and a whole-cache prefill on a paged layout raising.
Plus flash attention without grad against the reference's output (its
gradients are held in tests/test_torch_lm_train.py).

The model-level cases run the reference's MLA test config (an MLA mixer
with a dense FFN, ``tests/test_engine.py``'s ``_mla_dense_cfg``) and the
deepseek_v2_lite_16b smoke config."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import LayerKind as JKind  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.attention import flash_attention as j_flash  # noqa: E402
from repro.models.common import PagedLayout as JLayout  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402
from repro_torch.models.common import PagedLayout  # noqa: E402

from test_torch_lm import _assert_cache_equal  # noqa: E402

# fp32 outputs of the two packages: the same math, sums in another order
TOL = 1e-4
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


@pytest.fixture(scope="module", params=["mla_dense", "deepseek_v2_lite_16b"])
def model(request):
    if request.param == "mla_dense":
        jcfg = JConfig(pattern=(JKind("mla", "dense"),), **_MLA_KW)
        cfg = ModelConfig(pattern=(LayerKind("mla", "dense"),), **_MLA_KW)
    else:
        jcfg = jax_config(request.param, smoke=True)
        cfg = get_config(request.param, smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's weights (kv_norm scale nonzero) and both configs."""
    jcfg = JConfig(pattern=(JKind("mla", "dense"),), **_MLA_KW)
    cfg = ModelConfig(pattern=(LayerKind("mla", "dense"),), **_MLA_KW)
    jp = jmla.init_mla(jax.random.PRNGKey(3), jcfg)
    jp["kv_norm"]["scale"] = jnp.asarray(np.random.RandomState(3).randn(
        jcfg.kv_lora_rank).astype(np.float32) * 0.1)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(rng, b, s, d):
    return rng.randn(b, s, d).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("s", [40, 1100])
def test_expanded_path_matches_jax(layer, s):
    """No cache: full attention up to 1024 positions, chunked flash
    attention beyond (both packages switch at the same length)."""
    jcfg, cfg, jp, tp = layer
    x = _x(np.random.RandomState(0), 1, s, jcfg.d_model)
    positions = np.arange(s)[None]
    want, _ = jmla.apply_mla(jp, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(positions))
    with torch.no_grad():
        got, cache = tmla.apply_mla(tp, _t(x), cfg, positions=_t(positions))
    assert cache is None
    _close(got, want)


def test_prompt_prefill_writes_the_latent_cache(layer):
    jcfg, cfg, jp, tp = layer
    x = _x(np.random.RandomState(1), 2, 40, jcfg.d_model)
    positions = np.arange(40)[None]
    jc = jmla.init_cache_mla(jcfg, 2, 64)
    tc = tmla.init_cache_mla(cfg, 2, 64)
    tc["c_kv"].fill_(3.0)                 # stale content must not survive
    want, jc = jmla.apply_mla(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(positions), cache=jc,
                              prefill_len=37)
    got, tc2 = tmla.apply_mla(tp, _t(x), cfg, positions=_t(positions),
                              cache=tc, prefill_len=37)
    assert tc2 is tc
    _close(got, want)
    for name in ("c_kv", "k_rope", "pos_map"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=TOL, err_msg=name)
    assert int(tc["pos_map"][0, 37]) == -1 and float(
        tc["c_kv"][:, 37:].abs().sum()) == 0.0


def test_whole_cache_prefill_on_pages_raises(layer):
    jcfg, cfg, jp, tp = layer
    tc = tmla.init_cache_mla(cfg, 1, 32, paged=PagedLayout(8, 4))
    x = _t(_x(np.random.RandomState(2), 1, 8, cfg.d_model))
    with pytest.raises(NotImplementedError, match="paged MLA layout"):
        tmla.apply_mla(tp, x, cfg, positions=torch.arange(8)[None],
                       cache=tc)


def _paged_pair(jcfg, cfg, b, t, rows):
    jc = jmla.init_cache_mla(jcfg, b, t, paged=JLayout(8, 12))
    tc = tmla.init_cache_mla(cfg, b, t, paged=PagedLayout(8, 12))
    table = np.full((b, t // 8), -1, np.int32)
    for slot, row in rows.items():
        table[slot, :len(row)] = row
    jc["page_table"] = jnp.asarray(table)
    tc["page_table"].copy_(_t(table))
    return jc, tc


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunk_prefill_matches_jax(layer, layout):
    """Slot 1 of a 2-slot cache takes a prompt in three chunks (the last
    one bucket-padded past its real length): each chunk's output, and the
    cache after each, are the reference's."""
    jcfg, cfg, jp, tp = layer
    rng = np.random.RandomState(4)
    t = 48
    if layout == "dense":
        jc, tc = jmla.init_cache_mla(jcfg, 2, t), tmla.init_cache_mla(
            cfg, 2, t)
    else:
        jc, tc = _paged_pair(jcfg, cfg, 2, t, {1: [7, 2, 10, 4, 0, 5]})
    start = 0
    for s, length in ((16, 16), (16, 16), (16, 9)):
        x = _x(rng, 1, s, jcfg.d_model)
        positions = start + np.arange(s)[None]
        kw = dict(prefill_len=length, page_slot=1, page_start=start)
        want, jc = jmla.apply_mla(jp, jnp.asarray(x), jcfg,
                                  positions=jnp.asarray(positions),
                                  cache=jc, **kw)
        got, tc = tmla.apply_mla(tp, _t(x), cfg, positions=_t(positions),
                                 cache=tc, **kw)
        _close(got[:, :length], np.asarray(want)[:, :length])
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(
                jc[name]), atol=TOL, err_msg=f"{name} after {start}")
        start += length


def _prefilled(jp, tp, jcfg, cfg, lengths, slots, t, paged=False):
    """A ``slots``-slot LM cache with a prompt prefilled into each listed
    slot (dense sub-caches written in, page-written when ``paged``)."""
    rng = np.random.RandomState(5)
    if paged:
        jc = japi.init_cache(jp, jcfg, slots, t, paged=JLayout(8, 16))
        tc = tapi.init_cache(tp, cfg, slots, t, paged=PagedLayout(8, 16))
    else:
        jc, tc = japi.init_cache(jp, jcfg, slots, t), tapi.init_cache(
            tp, cfg, slots, t)
    rows = {0: [3, 9, 1, 12, 6, 2], 2: [8, 0, 15, 4, 11, 13]}
    last = {}
    for slot, n in lengths.items():
        toks = rng.randint(0, jcfg.vocab_size, (1, n)).astype(np.int32)
        jsub = japi.prefill_cache(jp, japi.init_cache(jp, jcfg, 1, t), jcfg,
                                  jnp.asarray(toks), n)[1]
        tl, tsub = tapi.prefill_cache(tp, tapi.init_cache(tp, cfg, 1, t),
                                      cfg, _t(toks), n)
        last[slot] = int(tl[0, n - 1].argmax())
        if paged:
            row = np.asarray(rows[slot], np.int32)
            jc = japi.write_slot_paged(jc, jcfg, slot, jsub, jnp.asarray(row))
            tc = tapi.write_slot_paged(tc, cfg, slot, tsub, _t(row))
        else:
            jc = japi.write_slot(jc, jcfg, slot, jsub)
            tc = tapi.write_slot(tc, cfg, slot, tsub)
    return jc, tc, last


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_absorbed_decode_ragged_with_inactive_row(model, layout):
    """Slots 0 and 2 at positions 20 and 33, slot 1 inactive: four decode
    steps' logits of the live rows and the latent caches after them are
    the reference's; the inactive row's cache stays untouched."""
    jcfg, cfg, jp, tp = model
    t = 48
    jc, tc, last = _prefilled(jp, tp, jcfg, cfg, {0: 20, 2: 33}, 3, t,
                              paged=layout == "paged")
    _assert_cache_equal(tc, jc)
    tok = np.array([[last[0]], [0], [last[2]]], np.int32)
    pos = np.array([20, -1, 33], np.int32)
    for _ in range(4):
        jl, jc = japi.decode_step(jp, jc, jcfg, jnp.asarray(tok),
                                  jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, cfg, _t(tok), _t(pos))
        for r in (0, 2):
            np.testing.assert_allclose(tl.numpy()[r], np.asarray(jl)[r],
                                       atol=TOL)
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0, 1], np.int32)
    _assert_cache_equal(tc, jc)
    for c in tc["prefix"] + tc["blocks"]:
        assert int(c["mix"]["pos_map"][..., 1, :].max()) == -1


def test_paged_decode_is_bitexact_against_dense(model):
    """The page view is elementwise the dense latent cache, so paged and
    dense absorbed decode give the same bits."""
    jcfg, cfg, jp, tp = model
    _, dense, last = _prefilled(jp, tp, jcfg, cfg, {0: 20, 2: 33}, 3, 48)
    _, paged, _ = _prefilled(jp, tp, jcfg, cfg, {0: 20, 2: 33}, 3, 48,
                             paged=True)
    tok = _t(np.array([[last[0]], [0], [last[2]]], np.int32))
    pos = _t(np.array([20, -1, 33], np.int32))
    a, _ = tapi.decode_step(tp, dense, cfg, tok, pos)
    b, _ = tapi.decode_step(tp, paged, cfg, tok, pos)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def test_slot_ops_on_latent_pools_match_jax(model):
    """write_slot_paged fills the c_kv / k_rope pools page by page,
    restore_slot_paged re-attaches a page row, reset_slot empties the
    slot's dense leaves; every leaf as the reference's."""
    jcfg, cfg, jp, tp = model
    jc, tc, _ = _prefilled(jp, tp, jcfg, cfg, {0: 20, 2: 33}, 3, 48,
                           paged=True)
    _assert_cache_equal(tc, jc)
    row = np.array([5, 14, -1, -1, -1, -1], np.int32)
    jc = japi.restore_slot_paged(jc, jcfg, 1, jnp.asarray(row), 11)
    tc = tapi.restore_slot_paged(tc, cfg, 1, _t(row), 11)
    _assert_cache_equal(tc, jc)
    jc = japi.free_slot(jc, jcfg, 2)
    tc = tapi.free_slot(tc, cfg, 2)
    _assert_cache_equal(tc, jc)


# --------------------------------------------------------------------------
# the flash-attention guard (ROADMAP.md Queue 3's fault, now raising)
# --------------------------------------------------------------------------

def _qkv(rng):
    return [rng.randn(1, 40, h, 16).astype(np.float32) for h in (4, 2, 2)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_without_grad_matches_jax(causal):
    q, k, v = _qkv(np.random.RandomState(7))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, q_chunk=16, kv_chunk=16)
    tq = _t(q).requires_grad_(True)
    with torch.no_grad():
        got = flash_attention(tq, _t(k), _t(v), causal=causal, q_chunk=16,
                              kv_chunk=16)
    _close(got, want)
