"""The port's dense-family LM (``models/lm.py`` through ``models/api.py``)
against the JAX reference on the gemma3_4b, deepseek_7b, chatglm3_6b and
internlm2_20b smoke configs (fp32), on JAX-initialised weights bridged as
numpy: ``forward``, ``prefill_cache`` and ``decode_step`` logits at ragged
positions with inactive rows (both decode kernels, dense and paged caches),
``decode_many``, the paged primitives' drop semantics, the slot ops, the
LM export and the greedy sampler."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.kernels.flash_decode import \
    decode_kernel_override as j_override  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models.common import PagedLayout as JLayout  # noqa: E402
from repro.serving.export import export_params as j_export  # noqa: E402
from repro.serving.serialize import pattern_key as j_pattern_key  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import flatten_with_path, path_name  # noqa: E402
from repro_torch.kernels.flash_decode import \
    decode_kernel_override  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.common import (PagedLayout, paged_bulk_write,  # noqa
                                       paged_row_write, paged_view)
from repro_torch.models.sampling import (sample_token_row,  # noqa: E402
                                         sample_tokens)
from repro_torch.serving.export import export_params  # noqa: E402
from repro_torch.serving.serialize import pattern_key  # noqa: E402

# fp32 logits of the two packages: same math, sums in another order
TOL = 1e-4
ARCHS = ("gemma3_4b", "deepseek_7b", "chatglm3_6b", "internlm2_20b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_config(request.param, smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return request.param, jcfg, get_config(request.param, smoke=True), jp, tp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(tree):
    """A cache tree (JAX or torch) -> {path name: numpy array}."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {path_name(p): x.numpy() for p, x in flatten_with_path(tree)}
    out = {}
    for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        if not hasattr(k, "idx") else f"[{k.idx}]"
                        for k in p)
        out[name] = np.asarray(x)
    return out


def _assert_cache_equal(tcache, jcache):
    a, b = _np(tcache), _np(jcache)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], atol=TOL, err_msg=name)


def test_forward_matches_jax(model):
    arch, jcfg, cfg, jp, tp = model
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 40))
    want, _ = japi.model_forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tapi.model_forward(tp, cfg, {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_prefill_then_ragged_decode_matches_jax(model, kernel):
    """prefill_cache on two slots (prompt 37 of a 40-token bucket; past
    gemma's smoke window of 32, so the ring wraps), then three decode steps
    with one slot inactive; caches and active logits agree."""
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(1)
    toks = rng.randint(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jc = japi.init_cache(jp, jcfg, 2, 64)
    tc = tapi.init_cache(tp, cfg, 2, 64)
    jl, jc = japi.prefill_cache(jp, jc, jcfg, jnp.asarray(toks), 37)
    tl, tc = tapi.prefill_cache(tp, tc, cfg, _t(toks), 37)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    _assert_cache_equal(tc, jc)
    pos = np.array([37, -1], np.int32)
    tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    for _ in range(3):
        with j_override(kernel):
            jl, jc = japi.decode_step(jp, jc, jcfg, jnp.asarray(tok),
                                      jnp.asarray(pos))
        with decode_kernel_override(kernel):
            tl, tc = tapi.decode_step(tp, tc, cfg, _t(tok), _t(pos))
        assert tl.shape == (2, 1, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=TOL)
        pos = pos + np.array([1, 0], np.int32)
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_paged_decode_matches_dense_and_jax(model, kernel):
    """A paged cache filled with write_slot_paged decodes like the dense
    one (the xla path is bit-exact: the page view is elementwise the dense
    cache) and like JAX's paged decode."""
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(2)
    toks = rng.randint(0, jcfg.vocab_size, (1, 24)).astype(np.int32)
    layout = PagedLayout(page_size=8, n_pages=12)
    jlayout = JLayout(page_size=8, n_pages=12)
    row = np.array([5, 2, 9, -1, -1, -1, -1, -1], np.int32)
    jsub = japi.init_cache(jp, jcfg, 1, 64)
    _, jsub = japi.prefill_cache(jp, jsub, jcfg, jnp.asarray(toks), 20)
    jpaged = japi.init_cache(jp, jcfg, 2, 64, paged=jlayout)
    jpaged = japi.write_slot_paged(jpaged, jcfg, 1, jsub, jnp.asarray(row))
    jdense = japi.write_slot(japi.init_cache(jp, jcfg, 2, 64), jcfg, 1, jsub)
    tsub = tapi.init_cache(tp, cfg, 1, 64)
    _, tsub = tapi.prefill_cache(tp, tsub, cfg, _t(toks), 20)
    tpaged = tapi.write_slot_paged(tapi.init_cache(tp, cfg, 2, 64,
                                                   paged=layout),
                                   cfg, 1, tsub, _t(row))
    tdense = tapi.write_slot(tapi.init_cache(tp, cfg, 2, 64), cfg, 1, tsub)
    _assert_cache_equal(tpaged, jpaged)
    tok = np.array([[0], [int(toks[0, 19])]], np.int32)
    pos = np.array([-1, 20], np.int32)
    with j_override(kernel):
        jl, _ = japi.decode_step(jp, jpaged, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos))
    with decode_kernel_override(kernel):
        tl, tpaged = tapi.decode_step(tp, tpaged, cfg, _t(tok), _t(pos))
        dl, _ = tapi.decode_step(tp, tdense, cfg, _t(tok), _t(pos))
    np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1], atol=TOL)
    if kernel == "xla":
        assert torch.equal(tl[1], dl[1])
    else:
        np.testing.assert_allclose(tl.numpy()[1], dl.numpy()[1], atol=TOL)


def test_decode_many_matches_jax_with_eos_and_budgets(model):
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    jc = japi.init_cache(jp, jcfg, 3, 48)
    tc = tapi.init_cache(tp, cfg, 3, 48)
    jl, jc = japi.prefill_cache(jp, jc, jcfg, jnp.asarray(toks), 16)
    _, tc = tapi.prefill_cache(tp, tc, cfg, _t(toks), 16)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos = np.array([16, 16, -1], np.int32)
    rem = np.array([6, 3, 0], np.int32)
    # first find a token the first slot emits mid-window, then stop on it
    jt, _, _ = japi.decode_many(jp, jax.tree.map(jnp.copy, jc), jcfg,
                                jnp.asarray(tok), jnp.asarray(pos), 6,
                                remaining=jnp.asarray(rem))
    eos = np.array([int(np.asarray(jt)[2, 0]), -1, -1], np.int32)
    jt, jv, js = japi.decode_many(jp, jc, jcfg, jnp.asarray(tok),
                                  jnp.asarray(pos), 6,
                                  remaining=jnp.asarray(rem),
                                  eos_id=jnp.asarray(eos))
    tt, tv, ts = tapi.decode_many(tp, tc, cfg, _t(tok), _t(pos), 6,
                                  remaining=_t(rem), eos_id=_t(eos))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(np.where(tv.numpy(), tt.numpy(), 0),
                                  np.where(np.asarray(jv), np.asarray(jt), 0))
    for k in ("token", "pos", "remaining", "failed"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    assert not bool(tv[3:, 0].any())       # slot 0 stopped on its EOS


def test_slot_ops_match_jax(model):
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    jsub = japi.init_cache(jp, jcfg, 1, 32)
    _, jsub = japi.prefill_cache(jp, jsub, jcfg, jnp.asarray(toks), 12)
    tsub = tapi.init_cache(tp, cfg, 1, 32)
    _, tsub = tapi.prefill_cache(tp, tsub, cfg, _t(toks), 12)
    jc = japi.write_slot(japi.init_cache(jp, jcfg, 3, 32), jcfg, 2, jsub)
    tc = tapi.write_slot(tapi.init_cache(tp, cfg, 3, 32), cfg, 2, tsub)
    _assert_cache_equal(tc, jc)
    back = tapi.read_slot(tc, cfg, 2)
    _assert_cache_equal(back, japi.read_slot(jc, jcfg, 2))
    _assert_cache_equal(back, tsub)
    tapi.reset_slot(back, cfg, 0)                # a copy: tc is untouched
    _assert_cache_equal(tapi.read_slot(tc, cfg, 2), tsub)
    tc = tapi.free_slot(tc, cfg, 2)
    jc = japi.free_slot(jc, jcfg, 2)
    _assert_cache_equal(tc, jc)
    _assert_cache_equal(tc, tapi.init_cache(tp, cfg, 3, 32))


def test_restore_slot_paged_matches_jax(model):
    arch, jcfg, cfg, jp, tp = model
    row = np.array([3, 0, -1, -1], np.int32)
    jc = japi.init_cache(jp, jcfg, 2, 32, paged=JLayout(8, 6))
    tc = tapi.init_cache(tp, cfg, 2, 32, paged=PagedLayout(8, 6))
    jc = japi.restore_slot_paged(jc, jcfg, 1, jnp.asarray(row), 13)
    tc = tapi.restore_slot_paged(tc, cfg, 1, _t(row), 13)
    _assert_cache_equal(tc, jc)


# --------------------------------------------------------------------------
# paged primitives: the reference's scatters drop invalid rows out of
# bounds; the port never writes them
# --------------------------------------------------------------------------

def test_paged_row_write_drops_invalid():
    pool = torch.zeros((3, 4, 2))
    table = torch.tensor([[1, -1]], dtype=torch.int32)
    val = torch.ones((1, 2))
    # pos 6 -> chunk 1 -> unmapped: the write is skipped, nothing wraps
    out = paged_row_write(pool.clone(), table, torch.tensor([6]), val,
                          torch.tensor([True]))
    assert float(out.abs().sum()) == 0.0
    out = paged_row_write(pool.clone(), table, torch.tensor([2]), val,
                          torch.tensor([True]))     # chunk 0 -> page 1 row 2
    assert float(out[1, 2].sum()) == 2.0 and float(out.abs().sum()) == 2.0
    out = paged_row_write(pool.clone(), table, torch.tensor([2]), val,
                          torch.tensor([False]))    # inactive slot: skipped
    assert float(out.abs().sum()) == 0.0


def test_paged_row_write_invalid_row_never_clobbers_a_valid_one():
    """An inactive row whose clipped destination is a live row's page and
    offset must not overwrite that row's new value."""
    pool = torch.full((4, 4, 2), 7.0)
    table = torch.tensor([[2, -1], [2, -1], [-1, -1]], dtype=torch.int32)
    val = torch.tensor([[1.0, 1.0], [5.0, 5.0], [9.0, 9.0]])
    out = paged_row_write(pool.clone(), table, torch.tensor([1, 1, 1]), val,
                          torch.tensor([True, False, True]))
    assert out[2, 1].tolist() == [1.0, 1.0]
    changed = (out != 7.0).any(dim=-1)
    assert int(changed.sum()) == 1
    # no valid row at all: the pool is unchanged
    out = paged_row_write(pool.clone(), table, torch.tensor([1, 1, 1]), val,
                          torch.tensor([False, False, False]))
    assert torch.equal(out, pool)


def test_paged_view_zeroes_unmapped():
    pool = torch.full((3, 4, 2), 7.0)
    table = torch.tensor([[2, -1]], dtype=torch.int32)
    pos_map = torch.tensor([[0, 1, 2, -1, -1, -1, -1, -1]],
                           dtype=torch.int32)
    view = paged_view(pool, table, pos_map)
    assert tuple(view.shape) == (1, 8, 2)
    assert torch.all(view[0, :3] == 7.0) and torch.all(view[0, 3:] == 0.0)


def test_paged_bulk_write_roundtrip():
    vals = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    pool = torch.zeros((4, 4, 2))
    row = torch.tensor([3, 1, -1, -1], dtype=torch.int32)  # past page 2 skip
    paged_bulk_write(pool, row, vals)
    pos_map = torch.full((1, 16), -1, dtype=torch.int32)
    pos_map[0, :8] = torch.arange(8, dtype=torch.int32)
    view = paged_view(pool, row[None], pos_map)
    assert torch.equal(view[0, :8], vals[:8])
    assert torch.all(view[0, 8:] == 0.0)
    assert float(pool[0].abs().sum()) == 0.0 and float(
        pool[2].abs().sum()) == 0.0


# --------------------------------------------------------------------------
# export and sampling
# --------------------------------------------------------------------------

def test_lm_export_matches_jax(model):
    """The port's device-side LM export gives the reference's packs (same
    scopes and pattern fingerprints) and the same row-grouped values."""
    arch, jcfg, cfg, jp, tp = model
    from repro.core.pruner import tied_prune as j_tied
    from repro.core.sparsity import SparsityConfig as JSp
    from repro_torch.core.pruner import tied_prune
    from repro_torch.core.sparsity import SparsityConfig
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


def test_greedy_sampling_and_unported_options():
    """Greedy sampling takes the first index on ties; what still raises:
    paged int8 KV (the reference raises too). mamba2 raised here until the
    ssm family was ported (ROADMAP.md Queue 1 item 4); its init now gives
    the reference's decode cache layout."""
    logits = torch.tensor([[0.1, 0.9, 0.9], [2.0, -1.0, 0.5]])
    assert sample_tokens(logits).tolist() == [1, 0]   # ties: first index
    assert sample_token_row(np.array([0.0, 3.0, 3.0])) == 1
    from dataclasses import replace
    from repro_torch.models.attention import init_cache_attn
    cfg = get_config("gemma3_4b", smoke=True)
    with pytest.raises(NotImplementedError, match="kv_cache_quant"):
        init_cache_attn(replace(cfg, kv_cache_quant=True), 1, 8,
                        paged=PagedLayout(page_size=4, n_pages=4))
    mcfg = get_config("mamba2_780m", smoke=True)
    jmcfg = jax_config("mamba2_780m", smoke=True)
    own = tapi.init_model(0, mcfg, device="cpu")
    got = _np(tapi.init_cache(own, mcfg, 2, 16))
    want = _np(japi.init_cache(j_init(jax.random.PRNGKey(0), jmcfg), jmcfg,
                               2, 16))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def test_bf16_scale_embedding_rounds_like_jax():
    """gemma's sqrt(d) embedding scale is rounded to the model dtype first
    (sqrt(2560) = 50.596 becomes 50.5 in bf16), as the reference does."""
    from repro_torch.models.lm import _embed
    from dataclasses import replace
    cfg = replace(get_config("gemma3_4b", smoke=True), d_model=2560,
                  dtype="bfloat16")
    emb = torch.ones((4, 2560), dtype=torch.bfloat16)
    h = _embed({"embed": {"w": emb}}, cfg, torch.tensor([[1]]))
    assert h.dtype == torch.bfloat16 and float(h[0, 0, 0]) == 50.5
