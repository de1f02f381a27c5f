"""The int8 KV cache (``cfg.kv_cache_quant``) in the port against the
reference: the quantizer's bytes (int8 values, bf16 scales) bitwise equal
to ``repro.models.attention._quantize_kv``; decode over the quantized cache
close to the exact forward (the reference's own bar, 2% of max|logits|);
engine greedy tokens equal to the JAX engine's; and the reference's gates
-- the paged layout and chunked prefill fall back (paged int8 caches raise
at the model layer in both packages) -- with decode staying on the plain
composition, never on K2/K3, as in the reference."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models.attention import _quantize_kv as j_quantize  # noqa: E402
from repro.models.common import PagedLayout as JLayout  # noqa: E402
from repro.serving import SchedSpec as JSched  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_decode import \
    decode_kernel_override  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import PagedLayout  # noqa: E402
from repro_torch.serving import SchedSpec, ServingSpec  # noqa: E402
from repro_torch.serving import prepare_servable  # noqa: E402

from test_torch_engine import GEMMA_PROMPTS, SPEC, _prompts  # noqa: E402
from test_torch_engine import _scaled, _serve  # noqa: E402

_SERVED = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int8_servables(arch="gemma3_4b"):
    """(JAX, port) servables with kv_cache_quant on the scaled smoke
    weights of test_torch_engine."""
    if arch not in _SERVED:
        jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                                   kv_cache_quant=True)
        tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   kv_cache_quant=True)
        jp = _scaled(j_init(jax.random.PRNGKey(0), jcfg))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        _SERVED[arch] = (j_prepare(jp, jcfg, JSpec(**SPEC)),
                         prepare_servable(tp, tcfg, ServingSpec(**SPEC),
                                          device="cpu"))
    return _SERVED[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise_equal_to_jax(dtype):
    """Random rows over five decades of magnitude, an all-zero row (the
    1e-6 scale floor) and rows whose amax / 127 rounds differently in bf16
    than the fp32 scale used for the values."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 4, 32) * np.exp(rng.uniform(-6, 6, (2, 9, 4, 1)))
    x[0, 3] = 0.0
    x = x.astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jq, js = j_quantize(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tq, ts = tattn._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))


def test_int8_kv_cache_decode_close_to_exact():
    """The port's counterpart of the reference's test of the same name:
    deepseek_7b smoke, decode over an int8 cache token by token, logits
    within 2% of max|logits| of the full-precision forward; and within
    1e-4 of the reference's int8 decode on the same weights."""
    cfg0 = get_config("deepseek_7b", smoke=True)
    cfgq = dataclasses.replace(cfg0, kv_cache_quant=True)
    jcfg0 = jax_config("deepseek_7b", smoke=True)
    jcfgq = dataclasses.replace(jcfg0, kv_cache_quant=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    b, s = 2, 32
    toks = np.random.RandomState(7).randint(0, cfg0.vocab_size, (b, s))
    with torch.no_grad():
        fwd, _ = tapi.model_forward(tp, cfg0,
                                    {"tokens": torch.from_numpy(toks)})
        cache = tapi.init_cache(tp, cfgq, b, s)
        assert cache["blocks"][0]["mix"]["k"].dtype == torch.int8
        assert cache["blocks"][0]["mix"]["k_scale"].dtype == torch.bfloat16
        jcache = japi.init_cache(jp, jcfgq, b, s)
        errs, gaps = [], []
        for t in range(s):
            lg, cache = tapi.decode_step(tp, cache, cfgq,
                                         torch.from_numpy(toks[:, t:t + 1]),
                                         t)
            jlg, jcache = japi.decode_step(jp, jcache, jcfgq,
                                           jnp.asarray(toks[:, t:t + 1]),
                                           jnp.int32(t))
            errs.append(float((lg[:, 0] - fwd[:, t]).abs().max()))
            gaps.append(float(np.abs(lg[:, 0].numpy()
                                     - np.asarray(jlg[:, 0])).max()))
    rel = max(errs) / float(fwd.abs().max())
    assert rel < 0.02, rel
    assert max(gaps) < 1e-4, max(gaps)
    # the quantized cache itself equals the reference's, byte for byte
    jleaf = jcache["blocks"][0]
    tleaf = cache["blocks"][0]["mix"]
    np.testing.assert_array_equal(tleaf["k"].numpy(), np.asarray(
        jleaf["mix"]["k"] if "mix" in jleaf else jleaf["k"]))


@pytest.mark.parametrize("sync_every", [1, 8])
def test_engine_int8_kv_tokens_match_jax(sync_every):
    """gemma3_4b smoke (ring and global layers; the 40-token prompt wraps
    the 32-slot ring in prefill) served with int8 KV: greedy tokens equal
    to the JAX engine's, and the KV bytes about half the bf16 engine's."""
    js, ts = _int8_servables()
    prompts = _prompts(512, GEMMA_PROMPTS)
    want, _ = _serve(js, prompts, kv_layout="dense", sync_every=sync_every)
    got, eng = _serve(ts, prompts, kv_layout="dense", sync_every=sync_every)
    assert all(st == "done" for st, _ in got)
    assert len({tuple(t) for _, t in got}) == len(got)
    assert got == want
    from test_torch_engine import _servables
    _, ts16 = _servables("gemma3_4b")
    bf16 = ts16.engine(max_slots=3, cache_len=64).stats_dict()["kv"]
    int8 = eng.stats_dict()["kv"]["kv_bytes_total"]
    assert int8 < 0.6 * bf16["kv_bytes_total"]


def test_int8_decode_never_reaches_k2_or_k3(monkeypatch):
    """With the flash decode kernels pinned, an int8 cache still decodes
    through the plain composition over the dequantized cache (the
    reference routes it there too)."""
    from test_torch_engine import _servables
    _, ts = _int8_servables()
    _, ts16 = _servables("gemma3_4b")

    class Reached(Exception):
        pass

    def boom(*a, **kw):
        raise Reached("K2/K3 reached")
    monkeypatch.setattr(tattn, "flash_decode", boom)
    monkeypatch.setattr(tattn, "paged_flash_decode", boom)
    monkeypatch.setattr(ts, "_decode_kind", "flash")
    eng = ts.engine(max_slots=2, cache_len=64, sync_every=4)
    h = eng.submit([1, 2, 3, 4, 5], max_new_tokens=6)
    eng.run()
    assert h.status == "done" and len(h.tokens) == 6
    # the control: a bf16 cache with the same pin does reach K2
    cache = ts16.init_cache(2, 64)
    with decode_kernel_override("flash"), pytest.raises(Reached):
        tapi.decode_step(ts16.params, cache, ts16.cfg,
                         torch.ones((2, 1), dtype=torch.int32), 0,
                         packs=ts16.packs)


def test_paged_int8_falls_back_to_dense_and_raises_at_the_model_layer():
    js, ts = _int8_servables()
    jeng = js.engine(max_slots=2, cache_len=64, kv_layout="paged")
    teng = ts.engine(max_slots=2, cache_len=64, kv_layout="paged")
    assert jeng.kv_layout == teng.kv_layout == "dense"
    with pytest.raises(NotImplementedError, match="kv_cache_quant"):
        japi.init_cache(js.params, js.cfg, 2, 64,
                        paged=JLayout(page_size=16, n_pages=8))
    with pytest.raises(NotImplementedError, match="kv_cache_quant"):
        tapi.init_cache(ts.params, ts.cfg, 2, 64,
                        paged=PagedLayout(page_size=16, n_pages=8))


def test_chunked_int8_falls_back_to_one_shot():
    """SchedSpec chunking is gated off for int8 KV (the chunk path would
    attend unquantized chunk K/V) and the engine admits one-shot with the
    scheduler's other knobs live: the JAX engine's tokens, no chunks."""
    js, ts = _int8_servables()
    prompts = _prompts(512, GEMMA_PROMPTS)
    sched = dict(max_chunk=8, token_budget=16)
    want, jeng = _serve(js, prompts, sched=JSched(**sched))
    got, eng = _serve(ts, prompts, sched=SchedSpec(**sched))
    assert not eng._chunking and not jeng._chunking
    assert eng.stats.prefill_chunks == 0
    assert got == want
    cache = ts.init_cache(1, 64)
    with pytest.raises(NotImplementedError, match="kv_cache_quant"):
        ts.suffix_prefill(cache, torch.zeros(8, dtype=torch.int32), 0, 0, 8)
