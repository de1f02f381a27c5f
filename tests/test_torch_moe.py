"""The port's MoE FFN (``models/moe.py``) against the JAX reference on the
qwen3_moe_235b_a22b and deepseek_v2_lite_16b smoke configs (fp32, the
latter with a shared expert), on JAX-initialised weights bridged as numpy:
the output, the aux loss, the top-k expert indices and the set of dropped
(token, expert) assignments at the configs' own capacity; a router with
duplicated columns, where every token's top experts tie; the reference's
capacity test (with headroom, shuffling tokens shuffles the output); and a
combine that gives the same bits on every run."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.moe import apply_moe as j_apply  # noqa: E402
from repro.models.moe import init_moe as j_init  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.moe import (apply_moe, capacity, init_moe,  # noqa
                                    route)

# fp32 outputs of the two packages: the same products, summed in another
# order inside the expert matmuls, so within 1e-5 of max|y|
TOL_REL = 1e-5
ARCHS = ("qwen3_moe_235b_a22b", "deepseek_v2_lite_16b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and the
    whole suite runs files side by side (wall-clock tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **replace):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _j_dispatch(jp, x2, jcfg):
    """The reference's routing (``repro/models/moe.py:35-48``) spelled out:
    top-k indices, the expert-sorted assignments' token and expert, their
    slot in the expert and the capacity."""
    t, k, e = x2.shape[0], jcfg.top_k, jcfg.n_experts
    cap = max(1, int(t * k / e * jcfg.capacity_factor))
    probs = jax.nn.softmax(jnp.asarray(x2) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(e))
    pos_in_seg = jnp.arange(t * k) - seg_start[sorted_e]
    return (np.asarray(idx), np.asarray(order // k), np.asarray(sorted_e),
            np.asarray(pos_in_seg), cap)


def _t_dispatch(tp, x2, cfg):
    _, _, idx, sorted_e, order, pos_in_seg = route(
        tp["router"], torch.from_numpy(x2), cfg)
    return (idx.numpy(), (order // cfg.top_k).numpy(), sorted_e.numpy(),
            pos_in_seg.numpy(), capacity(x2.shape[0], cfg))


def _dropped(token_src, sorted_e, pos_in_seg, cap):
    over = pos_in_seg >= cap
    return sorted(zip(token_src[over].tolist(), sorted_e[over].tolist()))


def _check_against_jax(jcfg, cfg, jp, tp, x):
    jy, jaux = j_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = apply_moe(tp, torch.from_numpy(x), cfg)
    jy = np.asarray(jy)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), jy,
                               atol=TOL_REL * float(np.abs(jy).max()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    x2 = x.reshape(-1, x.shape[-1])
    j, t = _j_dispatch(jp, x2, jcfg), _t_dispatch(tp, x2, cfg)
    np.testing.assert_array_equal(t[0], j[0])           # top-k indices
    np.testing.assert_array_equal(t[2], j[2])           # sorted experts
    np.testing.assert_array_equal(t[1], j[1])           # their tokens
    np.testing.assert_array_equal(t[3], j[3])           # slots in expert
    assert t[4] == j[4]
    return _dropped(*j[1:]), ty


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax_with_drops(arch):
    """At the config's capacity factor (1.25) 64 tokens overflow some
    experts: the dropped assignments are the reference's, and so are y and
    the aux loss."""
    jcfg, cfg, jp, tp = _pair(arch)
    x = np.random.RandomState(0).randn(4, 16, jcfg.d_model).astype(
        np.float32)
    dropped, _ = _check_against_jax(jcfg, cfg, jp, tp, x)
    assert dropped, "no assignment overflowed: the drop path is not held"


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_go_to_the_lower_expert(arch):
    """Duplicated router columns make every expert tie with its twin: the
    top k, the expert-sorted dispatch and the drops follow lax.top_k's rule
    (the lower expert index first), so y, aux and the drop set equal the
    reference's. Capacity factor 0.5, so the tied twins overflow."""
    jcfg, cfg, jp, tp = _pair(arch, capacity_factor=0.5)
    router = np.asarray(jp["router"]).copy()
    router[:, 1::2] = router[:, 0::2]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.RandomState(1).randn(4, 16, jcfg.d_model).astype(
        np.float32)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, jcfg.d_model))
                          @ tp["router"], dim=-1)
    assert torch.equal(probs[:, 0::2], probs[:, 1::2])   # exact ties
    dropped, _ = _check_against_jax(jcfg, cfg, jp, tp, x)
    idx = _t_dispatch(tp, x.reshape(-1, jcfg.d_model), cfg)[0]
    # each token's first pick is the even twin, its second the odd one
    assert np.all(idx[:, 0] % 2 == 0) and np.all(idx[:, 1] == idx[:, 0] + 1)
    assert dropped


def test_moe_capacity_drops_only_overflow():
    """The port's copy of ``test_models.py``'s case: with capacity to spare
    nothing is dropped and routing is per token, so shuffling the tokens
    shuffles the output."""
    _, cfg, _, tp = _pair("qwen3_moe_235b_a22b", capacity_factor=64.0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 16, cfg.d_model).astype(np.float32))
    y, aux = apply_moe(tp, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(aux))
    perm = torch.from_numpy(rng.permutation(16))
    y2, _ = apply_moe(tp, x[:, perm], cfg)
    np.testing.assert_allclose(y2.numpy(), y[:, perm].numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_is_bitwise_repeatable(arch):
    _, cfg, _, tp = _pair(arch)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        3, 16, cfg.d_model).astype(np.float32))
    a, aux_a = apply_moe(tp, x, cfg)
    b, aux_b = apply_moe(tp, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_init_moe_layout_and_dtypes():
    """fp32 router, experts in the model dtype with the reference's shapes,
    and the shared MLP only where the config has shared experts."""
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                              dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = init_moe(gen, cfg, device="cpu")
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    assert p["router"].dtype == torch.float32
    assert tuple(p["router"].shape) == (d, e)
    for name, shape in (("wi", (e, d, f)), ("wg", (e, d, f)),
                        ("wo", (e, f, d))):
        assert p[name].dtype == torch.bfloat16
        assert tuple(p[name].shape) == shape
    assert tuple(p["shared"]["wi"]["w"].shape) == (
        f * cfg.n_shared_experts, d)
    q = init_moe(gen, get_config("qwen3_moe_235b_a22b", smoke=True),
                 device="cpu")
    assert "shared" not in q


def test_capacity_counts_every_row():
    """Capacity counts the padding and inactive rows too: qwen3's full
    config with 4 decode slots gets int(4 * 8 / 128 * 1.25) = 0, so 1."""
    cfg = get_config("qwen3_moe_235b_a22b")
    assert capacity(4, cfg) == 1
    assert capacity(1024, cfg) == 80
