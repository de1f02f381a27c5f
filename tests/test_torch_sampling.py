"""Sampling at temperature > 0 in the port against the reference.

The port computes JAX's threefry2x32 keys in torch (``models/prng.py``):
``PRNGKey``, ``fold_in`` chains over (slot, position) pairs, and the random
bits and uniform draws are bitwise equal to ``jax.random``'s. Gumbel
scores take two fp32 logarithms, which torch and XLA round on their own:
the inner ``log(u)`` agrees to 1 ulp, so each score ``-log(t)`` agrees to
2 ulps at max(|score|, 1) (an ulp of ``t`` near 1 is an absolute error of
about one ulp of 1 in the score, plus each side's last rounding). Tokens
of ``sample_tokens`` / ``sample_token_row`` and of the engine (dense and
paged, per-step and fused) are equal to the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.sampling import sample_token_row as j_row  # noqa: E402
from repro.models.sampling import sample_tokens as j_tokens  # noqa: E402
from repro.models.sampling import slot_keys as j_slot_keys  # noqa: E402

from repro_torch.models import prng  # noqa: E402
from repro_torch.models.sampling import (sample_token_row,  # noqa: E402
                                         sample_tokens, slot_keys)

from test_torch_engine import GEMMA_PROMPTS, _prompts, _serve  # noqa: E402
from test_torch_engine import _servables  # noqa: E402

V = 512
TOP_KS = (0, 1, 5, V)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: small tensors, and parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 1234, -5, 2 ** 31 - 1, 2 ** 33 + 7])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _u32(jax.random.PRNGKey(seed)))


def test_fold_in_chains_over_slots_and_positions_match_jax():
    """64 (slot, position) pairs, position -1 clamped to 0 as the engine
    does for inactive rows: ``fold_in(fold_in(key, slot), max(pos, 0))``,
    batched and one at a time, and ``slot_keys`` against the reference's."""
    jk, tk = jax.random.PRNGKey(1234), prng.PRNGKey(1234)
    rng = np.random.RandomState(0)
    slots = np.arange(64) % 4
    pos = rng.randint(-1, 2000, 64)
    pos[:4] = -1
    want = np.stack([_u32(jax.random.fold_in(jax.random.fold_in(jk, int(s)),
                                             max(int(p), 0)))
                     for s, p in zip(slots, pos)])
    got = prng.fold_in(prng.fold_in(tk, torch.from_numpy(slots)),
                       torch.from_numpy(pos).clamp_min(0))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        slot_keys(tk, torch.from_numpy(pos[:8])).numpy(),
        _u32(j_slot_keys(jk, jnp.asarray(pos[:8], jnp.int32))))


@pytest.mark.parametrize("n", [V, 5, 64, 262144])
def test_random_bits_and_uniform_match_jax_bitwise(n):
    """Shapes (V,) and (top_k,), and gemma3_4b's vocabulary."""
    jk = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    tk = prng.fold_in(prng.PRNGKey(7), 3)
    np.testing.assert_array_equal(prng.random_bits(tk, (n,)).numpy(),
                                  _u32(jax.random.bits(jk, (n,))))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        want = np.asarray(jax.random.uniform(jk, (n,), minval=lo, maxval=hi))
        got = prng.uniform(tk, (n,), lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_random_bits_of_batched_keys_and_2d_shapes_match_jax():
    jks = jax.random.split(jax.random.PRNGKey(3), 4)
    tks = torch.from_numpy(_u32(jks))
    want = np.stack([_u32(jax.random.bits(k, (3, 5))) for k in jks])
    np.testing.assert_array_equal(prng.random_bits(tks, (3, 5)).numpy(),
                                  want)


def test_gumbel_within_two_ulps_of_jax():
    tiny = np.finfo(np.float32).tiny
    worst_log = worst = 0.0
    for s in range(8):
        jk = jax.random.fold_in(jax.random.PRNGKey(7), s)
        tk = prng.fold_in(prng.PRNGKey(7), s)
        u = np.asarray(jax.random.uniform(jk, (V * 64,), minval=tiny,
                                          maxval=1.0))
        jl = np.asarray(jnp.log(u))
        tl = torch.log(torch.from_numpy(u.copy())).numpy()
        worst_log = max(worst_log, float(np.max(
            np.abs(jl - tl) / np.spacing(np.abs(jl)))))
        jg = np.asarray(jax.random.gumbel(jk, (V * 64,)))
        tg = prng.gumbel(tk, (V * 64,)).numpy()
        ulp = np.spacing(np.maximum(np.abs(jg), np.float32(1.0)))
        worst = max(worst, float(np.max(np.abs(jg - tg) / ulp)))
    assert worst_log <= 1.0, worst_log
    assert worst <= 2.0, worst


def _logits(rows, seed=0, tied=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, V) * 3.0).astype(np.float32)
    if tied:
        x[:, 100:110] = 9.0             # ten tied maxima in every row
        x[:, 300:305] = 9.0
    return x


@pytest.mark.parametrize("temperature", [0.5, 1.0])
@pytest.mark.parametrize("top_k", TOP_KS)
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_sample_tokens_match_jax(temperature, top_k, tied):
    """256 seeded rows at ragged positions (some inactive, pos -1)."""
    logits = _logits(256, tied=tied)
    pos = np.random.RandomState(1).randint(-1, 1500, 256).astype(np.int32)
    want = np.asarray(j_tokens(jnp.asarray(logits), jax.random.PRNGKey(99),
                               jnp.asarray(pos), temperature=temperature,
                               top_k=top_k))
    got = sample_tokens(torch.from_numpy(logits), prng.PRNGKey(99),
                        torch.from_numpy(pos), temperature=temperature,
                        top_k=top_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if top_k != 1:
        assert len(set(got.tolist())) > 1       # the sampler drew


@pytest.mark.parametrize("temperature", [0.5, 1.0])
@pytest.mark.parametrize("top_k", TOP_KS)
def test_sample_token_row_matches_jax(temperature, top_k):
    logits = _logits(16, seed=2, tied=True)
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    for i in range(16):
        slot, position = i % 4, 37 * i - 1
        want = j_row(logits[i], jk, slot, position, temperature=temperature,
                     top_k=top_k)
        assert sample_token_row(logits[i], tk, slot, position,
                                temperature=temperature,
                                top_k=top_k) == want
        assert sample_token_row(torch.from_numpy(logits[i]), tk, slot,
                                position, temperature=temperature,
                                top_k=top_k) == want


def test_topk_one_is_greedy_with_lower_index_on_ties():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    got = sample_tokens(logits, prng.PRNGKey(0), torch.tensor([3, 9]),
                        temperature=0.7, top_k=1)
    assert got.tolist() == [1, 0]


_ENGINE_RUNS = {}


@pytest.mark.parametrize("layout,sync_every", [("dense", 1), ("dense", 8),
                                               ("paged", 1), ("paged", 8)])
def test_engine_sampled_tokens_match_jax(layout, sync_every):
    """gemma3_4b smoke at temperature 0.8, top_k 0 and 40: the first token
    sampled on the host at admission, the rest in decode windows."""
    js, ts = _servables("gemma3_4b")
    prompts = _prompts(512, GEMMA_PROMPTS)
    for top_k in (0, 40):
        kw = dict(kv_layout=layout, sync_every=sync_every, temperature=0.8,
                  top_k=top_k, seed=1234)
        key = (layout, sync_every, top_k)
        if key not in _ENGINE_RUNS:
            _ENGINE_RUNS[key] = _serve(js, prompts, **kw)[0]
        want = _ENGINE_RUNS[key]
        got, eng = _serve(ts, prompts, **kw)
        assert all(s == "done" for s, _ in got)
        assert got == want, (top_k, got, want)
        greedy, _ = _serve(ts, prompts, kv_layout=layout,
                           sync_every=sync_every)
        assert got != greedy                    # the sampler drew


def test_engine_sampled_tokens_with_chunked_prefill_match_jax():
    """The first token of a chunk-prefilled request is sampled where its
    last chunk lands (``_prefill_chunk``), with the key of (slot, length
    - 1): the port's tokens equal the JAX engine's."""
    from repro.serving import SchedSpec as JSched
    from repro_torch.serving import SchedSpec
    js, ts = _servables("gemma3_4b")
    prompts = _prompts(512, GEMMA_PROMPTS)
    kw = dict(kv_layout="dense", sync_every=8, temperature=1.0, top_k=5,
              seed=7)
    sched = dict(max_chunk=8, token_budget=24)
    want, jeng = _serve(js, prompts, sched=JSched(**sched), **kw)
    got, eng = _serve(ts, prompts, sched=SchedSpec(**sched), **kw)
    assert eng.stats.prefill_chunks == jeng.stats.prefill_chunks > 0
    assert all(s == "done" for s, _ in got)
    assert got == want
