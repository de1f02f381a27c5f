"""LM training in the port against the JAX reference, on the CPU.

* ``flash_attention``'s backward (``attention._Flash``, the reference's
  FA2-schedule custom VJP) against ``jax.vjp`` of the reference's
  ``flash_attention``: ragged last chunks in q and k, causal and not, a
  window, a query offset, GQA; fp32 and bf16. ``softcap > 0`` raises under
  grad (the reference's backward ignores the softcap).
* ``value_and_grad(make_loss_fn(cfg))`` on the ten LM smoke configs (whisper
  with encoder frames, pixtral with patch embeddings) against
  ``jax.value_and_grad`` of the reference's loss on the same weights and
  batch, then the update against the reference's ``adamw_update`` fed the
  port's gradients (the reason for the split: tests/test_torch_train.py);
  MLA's prefill and a gemma3 period past 1024 positions, where the global
  layer takes flash attention and the local ones ``local_attention``.
* Per-period remat and the donating, chunked AdamW update
  against their plain counterparts, bit for bit; no fp32 head copy cached
  by a training step.

Weights are made in JAX and carried across with ``bridge.params_from_numpy``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core.sparsity import SparsityConfig as JSp  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models.attention import flash_attention as j_flash  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402

from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.core.tree import (flatten_with_path, leaves,  # noqa: E402
                                   path_name, unflatten)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402
from repro_torch.models.api import init_model  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402

SP = dict(block_shape=(16, 16), sparsity=0.5, lambda_reg=1e-2)
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_name(tree):
    return {path_name(p): leaf for p, leaf in flatten_with_path(tree)}


def _assert_trees(got, want, rtol, atol_rel, what):
    """Leaf by leaf: |got - want| <= rtol |want| + atol_rel * max|want|."""
    got = _by_name(got)
    want = {path_name(p): np.asarray(leaf, np.float32) for p, leaf in
            flatten_with_path(jax.tree.map(np.asarray, want))}
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name].float().numpy()
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_rel * max(1e-30, np.abs(w).max()),
            err_msg=f"{what}: {name}")


# --------------------------------------------------------------------------
# (a), (b): the flash-attention backward
# --------------------------------------------------------------------------

FLASH_MODES = {"causal": dict(causal=True), "full": dict(causal=False),
               "window": dict(causal=True, window=24),
               "offset": dict(causal=True, q_offset=8)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(FLASH_MODES))
def test_flash_attention_grads_match_jax_vjp(mode, dtype):
    """B 2, S 100, Hq 4, Hkv 2, D 16, chunks of 16: q and k both end in a
    ragged chunk. dq, dk, dv against jax.vjp of the reference's custom VJP:
    fp32 within 1e-5 of each gradient's max|g| (measured: 5e-7), bf16
    within 1e-2 (measured: 4e-4)."""
    kw = FLASH_MODES[mode]
    rng = np.random.RandomState(3)
    q = rng.randn(2, 100, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 100, 2, 16).astype(np.float32) for _ in range(2))
    do = rng.randn(2, 100, 4, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, q_chunk=16,
                                               kv_chunk=16, **kw),
                       *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    got_out = flash_attention(tq, tk, tv, q_chunk=16, kv_chunk=16, **kw)
    got = torch.autograd.grad(got_out, (tq, tk, tv),
                              torch.from_numpy(do).to(tdt))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got_out.detach().float().numpy(),
                               np.asarray(out, np.float32), rtol=0,
                               atol=tol * float(np.abs(np.asarray(
                                   out, np.float32)).max()))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == w.shape
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=f"d{name}")


def test_flash_attention_softcap_with_grad_raises():
    """The reference's backward ignores the softcap, so the port refuses a
    softcapped backward; without grad the forward is the reference's."""
    rng = np.random.RandomState(4)
    q = rng.randn(1, 40, 4, 16).astype(np.float32)
    k, v = (rng.randn(1, 40, 2, 16).astype(np.float32) for _ in range(2))
    tq = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="softcap"):
        flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        q_chunk=16, kv_chunk=16, softcap=5.0)
    with torch.no_grad():
        got = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                              q_chunk=16, kv_chunk=16, softcap=5.0)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_chunk=16, kv_chunk=16, softcap=5.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# (c), (d): loss and gradients of every LM family, then the update
# --------------------------------------------------------------------------

def _cfgs(arch, **replace):
    jsp, tsp = JSp(**SP), SparsityConfig(**SP)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), sparsity=jsp,
                               **replace)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), sparsity=tsp,
                               **replace)
    return jcfg, tcfg


def _batch(cfg, b, s, seed=0):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.randn(b, cfg.n_audio_ctx,
                                  cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        out["mm_embeds"] = rng.randn(b, cfg.n_patches,
                                     cfg.d_model).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in out.items()}
    tb = {k: (torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v)) for k, v in out.items()}
    return jb, tb


def _step_parity(jcfg, tcfg, b, s, seed=0):
    """Loss and gradients against jax.value_and_grad; the update against
    the reference's adamw_update fed the port's gradients."""
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jb, tb = _batch(jcfg, b, s, seed)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(jcfg),
                                                has_aux=True))(jp, jb)
    tl, taux, tg = tsteps.value_and_grad(tsteps.make_loss_fn(tcfg), tp, tb)
    assert np.isfinite(float(tl))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(taux["aux"]) == pytest.approx(float(jaux["aux"]), rel=1e-5,
                                               abs=1e-7)
    _assert_trees(tg, jg, 1e-4, 1e-5, "grads")

    jc, tc = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    tp1, to1, tm = topt.adamw_update(tg, topt.init_opt_state(tp, tc), tp, tc,
                                     tcfg.sparsity)
    jp1, jo1, jm = jax.jit(lambda g, o, p: jopt.adamw_update(
        g, o, p, jc, jcfg.sparsity))(
        jax.tree.map(jnp.asarray, params_to_numpy(tg)),
        jopt.init_opt_state(jp, jc), jp)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    _assert_trees(tp1, jp1, 1e-5, 1e-6, "params after the update")
    _assert_trees(to1["v"], jo1["v"], 1e-5, 1e-6, "v after the update")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_lm_loss_and_grads_match_jax(arch):
    """Every LM family the reference trains, fp32 smoke configs, B 2, S 32:
    the loss within 1e-5 relative and every gradient within 1e-4 relative
    plus 1e-5 of its leaf's max|g|, the bars of the BERT train step."""
    jcfg, tcfg = _cfgs(arch)
    _step_parity(jcfg, tcfg, 2, 32)


@pytest.mark.parametrize("arch,layers", [("deepseek_v2_lite_16b", 1),
                                         ("gemma3_4b", 3)])
def test_lm_grads_past_1024_positions_match_jax(arch, layers):
    """S = 1100, B 1: MLA's expanded prefill reaches flash attention (v
    padded to the q/k head width, the padding's gradient dropped); a gemma3
    period (2 local : 1 global) sends the global layer through flash
    attention and the local layers through ``local_attention``."""
    jcfg, tcfg = _cfgs(arch, n_layers=layers)
    _step_parity(jcfg, tcfg, 1, 1100)


# --------------------------------------------------------------------------
# (e), (f), (g): remat, donation, the head copy
# --------------------------------------------------------------------------

def _no_checkpoint(fn, *args, use_reentrant, **kwargs):
    _no_checkpoint.calls += 1
    return fn(*args, **kwargs)


@pytest.mark.parametrize("arch", ["gemma3_4b", "qwen3_moe_235b_a22b",
                                  "whisper_base"])
def test_remat_grads_equal_plain_autograd_bitwise(arch, monkeypatch):
    """Per-period checkpointing (decoder layers for enc-dec) changes no bit
    of the loss or the gradients on the CPU."""
    cfg = get_config(arch, smoke=True)
    params = init_model(0, cfg, device="cpu")
    _, tb = _batch(cfg, 2, 32)
    loss_fn = tsteps.make_loss_fn(cfg)
    assert lm_mod.remat_active(
        [p.detach().requires_grad_(True) for p in leaves(params)])
    l1, _, g1 = tsteps.value_and_grad(loss_fn, params, tb)
    for mod in (lm_mod, encdec_mod):        # checkpoint -> a plain call
        monkeypatch.setattr(mod, "checkpoint", _no_checkpoint)
    _no_checkpoint.calls = 0
    l0, _, g0 = tsteps.value_and_grad(loss_fn, params, tb)
    assert _no_checkpoint.calls > 0
    assert torch.equal(l1, l0)
    for (path, a), b in zip(flatten_with_path(g1), leaves(g0)):
        assert torch.equal(a, b), path_name(path)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("prox", [False, True])
def test_donated_update_equals_functional_bitwise(prox, chunked,
                                                  monkeypatch):
    """adamw_update(donate=True) writes the functional update's numbers
    into the given tensors (same data_ptr) and returns the same trees; with
    CHUNK_ELEMS lowered the embedding and the stacked layer weights update
    in chunks (whole 16-row block rows under the prox), bitwise equal to
    the unchunked update."""
    cfg = dataclasses.replace(get_config("gemma3_4b", smoke=True),
                              sparsity=SparsityConfig(**SP))
    params = init_model(1, cfg, device="cpu")
    sp = cfg.sparsity if prox else None
    tc = topt.AdamWConfig(**OPT)
    gen = torch.Generator().manual_seed(2)
    grads = unflatten(params, [torch.randn(p.shape, generator=gen) * 0.05
                               for p in leaves(params)])
    state = topt.init_opt_state(params, tc)
    want_p, want_s = params, state
    for _ in range(2):
        want_p, want_s, want_m = topt.adamw_update(grads, want_s, want_p, tc,
                                                   sp)
    if chunked:
        monkeypatch.setattr(topt, "CHUNK_ELEMS", 3000)
        big = [p for p in leaves(params) if p.numel() > 3000]
        assert any(p.ndim == 2 for p in big) and any(p.ndim == 3
                                                     for p in big)
    p = unflatten(params, [x.clone() for x in leaves(params)])
    s = topt.init_opt_state(params, tc)
    ptrs = [x.data_ptr() for x in leaves(p) + leaves(s)]
    for _ in range(2):
        p2, s2, m = topt.adamw_update(grads, s, p, tc, sp, donate=True)
        assert p2 is p and s2 is s
    assert [x.data_ptr() for x in leaves(p) + leaves(s)] == ptrs
    assert int(s["step"]) == int(want_s["step"]) == 2
    assert torch.equal(m["grad_norm"], want_m["grad_norm"])
    for name, tree, ref in (("params", p, want_p), ("m", s["m"], want_s["m"]),
                            ("v", s["v"], want_s["v"])):
        for (path, a), b in zip(flatten_with_path(tree), leaves(ref)):
            assert torch.equal(a, b), f"{name}: {path_name(path)}"


def test_training_step_caches_no_fp32_head():
    """A bf16 step's fp32 head is made fresh under autograd: nothing lands
    in ``lm._HEAD_F32`` (a cached copy would keep its graph, and through it
    the tied embedding, alive), and the tied embedding gets the head's
    gradient too, equal to a step with the cache left empty."""
    cfg = dataclasses.replace(get_config("gemma3_4b", smoke=True),
                              dtype="bfloat16")
    params = init_model(0, cfg, device="cpu")
    _, tb = _batch(cfg, 1, 16)
    before = dict(lm_mod._HEAD_F32)
    step = tsteps.make_train_step(cfg, topt.AdamWConfig(**OPT))
    _, _, metrics = step(params, topt.init_opt_state(
        params, topt.AdamWConfig(**OPT)), tb)
    assert np.isfinite(float(metrics["loss"]))
    assert dict(lm_mod._HEAD_F32).keys() == before.keys()
    # a copy cached while grad was off does not cut the head's gradient
    loss_fn = tsteps.make_loss_fn(cfg)

    def embed_grad(cached):
        live = unflatten(params, [x.detach().requires_grad_(True)
                                  for x in leaves(params)])
        if cached:
            with torch.no_grad():
                lm_mod.forward(live, cfg, tb["tokens"])
            assert id(live["embed"]["w"]) in lm_mod._HEAD_F32
        loss, _ = loss_fn(live, tb)
        return torch.autograd.grad(loss, live["embed"]["w"])[0]
    assert torch.equal(embed_grad(True), embed_grad(False))
