"""The port's split-K decode attention (K2 ``flash_decode``, K3
``paged_flash_decode``) on the CPU, where the wrappers run their plain
versions, against the JAX kernels in interpret mode on the same numpy
inputs: ragged and scalar positions, inactive slots, shared and per-slot
position maps, ring windows, T not a multiple of the split count, MHA and
G = 16, unmapped and stale pages. The paged plain version is bit-exact
against the dense one over the gathered view with matching splits, as the
kernels are. Plus the kernel-choice precedence."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_decode import flash_decode as j_flash  # noqa: E402
from repro.kernels.flash_decode import \
    paged_flash_decode as j_paged  # noqa: E402
from repro.models.attention import \
    decode_attention as j_decode_attention  # noqa: E402
from repro.models.common import paged_view as j_paged_view  # noqa: E402

from repro_torch.kernels.flash_decode import (  # noqa: E402
    decode_kernel_override, default_kv_split, flash_decode,
    flash_decode_plain, paged_flash_decode, paged_flash_decode_plain,
    resolved_decode_kernel)
from repro_torch.models.attention import decode_attention  # noqa: E402
from repro_torch.models.common import paged_view  # noqa: E402

# fp32 against JAX: the same splits and online-softmax steps, sums in
# another order (the reference's own flash-vs-xla bar is 1e-5)
TOL = 1e-5
# bf16 inputs: both accumulate in fp32 and round the output to bf16 once;
# one bf16 step (2^-8 relative) of outputs bounded by max|v| ~ 4
TOL_BF16 = 4 * 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode_case(rng, b, t, hq, hkv, d, ragged=True):
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    k = rng.randn(b, t, hkv, d).astype(np.float32)
    v = rng.randn(b, t, hkv, d).astype(np.float32)
    kvp = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    if ragged:
        pos = rng.randint(0, t, size=b).astype(np.int32)
        pos[0] = t - 1
        if b > 1:
            pos[1] = -1                      # inactive slot
    else:
        pos = np.full((b,), t - 1, np.int32)
    return q, k, v, kvp, pos


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*map(jnp.asarray, arrays), **kw))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("kv_split", [1, 2, 3, 4])
def test_flash_decode_matches_jax(window, kv_split):
    """Ragged pos with an inactive slot, per-slot (B, T) maps; kv_split=3
    on T=32 pads the last split."""
    rng = np.random.RandomState(6)
    q, k, v, kvp, pos = _decode_case(rng, 3, 32, 8, 4, 16)
    want = _jax(j_flash, q, k, v, kvp, pos, window=window, kv_split=kv_split)
    got = flash_decode(*map(_t, (q, k, v, kvp, pos)), window=window,
                       kv_split=kv_split)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert float(got[1].abs().max()) == 0.0     # inactive slot: zeros
    ref = j_decode_attention(*map(jnp.asarray, (q, k, v, kvp, pos)),
                             window=window)
    active = pos >= 0
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(ref)[active], atol=TOL)


def test_flash_decode_mha_scalar_pos_shared_map():
    """hq == hkv (G = 1), scalar pos and a shared 1-D kv_positions map."""
    rng = np.random.RandomState(7)
    b, t, h, d = 2, 24, 4, 8
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, t, h, d).astype(np.float32)
    v = rng.randn(b, t, h, d).astype(np.float32)
    kvp = np.arange(t, dtype=np.int32)
    want = _jax(j_flash, q, k, v, kvp, np.int32(t - 1))
    got = flash_decode(_t(q), _t(k), _t(v), _t(kvp), t - 1)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_flash_decode_group_16_and_ring_wrap():
    """chatglm3's grouping (G = 16) and a ring cache that has wrapped:
    slot j holds the latest position <= pos congruent to j."""
    rng = np.random.RandomState(8)
    b, t, hq, hkv, d, window = 2, 32, 32, 2, 16, 32
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    k = rng.randn(b, t, hkv, d).astype(np.float32)
    v = rng.randn(b, t, hkv, d).astype(np.float32)
    pos = np.array([70, 40], np.int32)
    j = np.arange(t)
    kvp = np.stack([np.where(j + t * ((p - j) // t) >= 0,
                             j + t * ((p - j) // t), -1) for p in pos])
    kvp = kvp.astype(np.int32)
    want = _jax(j_flash, q, k, v, kvp, pos, window=window)
    got = flash_decode(*map(_t, (q, k, v, kvp, pos)), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_flash_decode_bf16_matches_jax():
    rng = np.random.RandomState(9)
    q, k, v, kvp, pos = _decode_case(rng, 3, 40, 8, 4, 32)
    bf = jnp.bfloat16
    want = np.asarray(j_flash(jnp.asarray(q, bf), jnp.asarray(k, bf),
                              jnp.asarray(v, bf), jnp.asarray(kvp),
                              jnp.asarray(pos)).astype(jnp.float32))
    got = flash_decode(*(_t(a).bfloat16() for a in (q, k, v)), _t(kvp),
                       _t(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16)


def _paged_case(rng, dtype=np.float32):
    b, npg, ps, hkv, hq, d = 2, 4, 8, 2, 4, 16
    kp = rng.randn(b * npg + 3, ps, hkv, d).astype(dtype)
    vp = rng.randn(b * npg + 3, ps, hkv, d).astype(dtype)
    # slot 0: 3 mapped pages + 1 hole; slot 1: 2 mapped pages
    table = np.array([[2, 5, 7, -1], [1, 9, -1, -1]], np.int32)
    pos_map = np.full((b, npg * ps), -1, np.int32)
    pos_map[0, :3 * ps] = np.arange(3 * ps)
    pos_map[1, :2 * ps] = np.arange(2 * ps)
    pos = np.array([3 * ps - 1, ps + 3], np.int32)
    q = rng.randn(b, 1, hq, d).astype(dtype)
    return q, kp, vp, table, pos_map, pos, npg


def test_paged_flash_decode_matches_jax_and_is_bit_exact_vs_dense():
    rng = np.random.RandomState(10)
    q, kp, vp, table, pos_map, pos, npg = _paged_case(rng)
    want = _jax(j_paged, q, kp, vp, table, pos_map, pos)
    got = paged_flash_decode(*map(_t, (q, kp, vp, table, pos_map, pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the port's own paged view equals the reference's
    view = paged_view(_t(kp), _t(table), _t(pos_map))
    np.testing.assert_array_equal(view.numpy(), np.asarray(j_paged_view(
        jnp.asarray(kp), jnp.asarray(table), jnp.asarray(pos_map))))
    dense = flash_decode(_t(q), view, paged_view(_t(vp), _t(table),
                                                 _t(pos_map)),
                         _t(pos_map), _t(pos), kv_split=npg)
    assert torch.equal(got, dense), \
        "the paged plain version must be bit-exact vs the dense one"
    ref = decode_attention(_t(q), view, paged_view(_t(vp), _t(table),
                                                   _t(pos_map)),
                           _t(pos_map), _t(pos))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL)


def test_paged_flash_decode_ignores_stale_and_poisoned_pages():
    """Garbage (huge values, NaN) in unmapped or recycled pages never
    leaks: only pos_map decides visibility."""
    rng = np.random.RandomState(11)
    q, kp, vp, table, pos_map, pos, _ = _paged_case(rng)
    base = paged_flash_decode(*map(_t, (q, kp, vp, table, pos_map, pos)))
    kp2, vp2 = kp.copy(), vp.copy()
    for page in (0, 3, 4, 6, 8, 10):
        kp2[page] = 1e6
        vp2[page] = np.nan
    out = paged_flash_decode(*map(_t, (q, kp2, vp2, table, pos_map, pos)))
    assert torch.equal(base, out)
    want = _jax(j_paged, q, kp2, np.nan_to_num(vp2), table, pos_map, pos)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL)


def test_wrappers_run_the_plain_versions_on_cpu_without_counting():
    rng = np.random.RandomState(12)
    q, k, v, kvp, pos = map(_t, _decode_case(rng, 2, 16, 4, 2, 8))
    n2, n3 = flash_decode.launches, paged_flash_decode.launches
    assert torch.equal(flash_decode(q, k, v, kvp, pos),
                       flash_decode_plain(q, k, v, kvp, pos))
    q, kp, vp, table, pos_map, pos, _ = map(
        lambda a: _t(a) if isinstance(a, np.ndarray) else a,
        _paged_case(rng))
    assert torch.equal(paged_flash_decode(q, kp, vp, table, pos_map, pos),
                       paged_flash_decode_plain(q, kp, vp, table, pos_map,
                                                pos))
    assert (flash_decode.launches, paged_flash_decode.launches) == (n2, n3)


def test_default_kv_split_and_kernel_choice(monkeypatch):
    assert default_kv_split(64) == 1
    assert default_kv_split(512) == 4
    assert default_kv_split(4096) == 8
    monkeypatch.delenv("REPRO_DECODE_KERNEL", raising=False)
    # platform step: the kernels on a CUDA tensor, the plain composition on
    # a CPU tensor
    assert resolved_decode_kernel("cpu") == "xla"
    assert resolved_decode_kernel(torch.device("cuda")) == "flash"
    with decode_kernel_override("flash"):
        assert resolved_decode_kernel("cpu") == "flash"
        with decode_kernel_override("xla"):
            assert resolved_decode_kernel("cuda") == "xla"  # innermost wins
        with decode_kernel_override("auto"):                # a no-op
            assert resolved_decode_kernel("cpu") == "flash"
    monkeypatch.setenv("REPRO_DECODE_KERNEL", "flash")
    assert resolved_decode_kernel("cpu") == "flash"
    with decode_kernel_override("xla"):                     # override > env
        assert resolved_decode_kernel("cpu") == "xla"
    monkeypatch.setenv("REPRO_DECODE_KERNEL", "bogus")
    with pytest.raises(ValueError, match="REPRO_DECODE_KERNEL"):
        resolved_decode_kernel("cpu")
    assert "REPRO_DECODE_KERNEL" in os.environ


# --------------------------------------------------------------------------
# CPU oracle of the CUDA kernels' arithmetic: each split's partial taken
# against the split's own max, the partials combined in split order
# --------------------------------------------------------------------------

_NEG_INF = -1e30


def _oracle_partial(q32, k, v, kvp, pos, window, scale):
    """A split's partial as the split kernel forms it: (M_s, l_s, acc_s)
    with M_s the split's own max of the visible scores (NEG_INF when none),
    p = exp(s - M_s) on visible lanes and 0 elsewhere. q32 (B,H,G,D) fp32;
    k/v (B,H,C,D); kvp (B,C); pos (B,)."""
    ok = (kvp >= 0) & (kvp <= pos[:, None])
    if window > 0:
        ok = ok & (kvp > pos[:, None] - window)
    okb = ok[:, None, None, :]
    s = torch.einsum("bhgd,bhcd->bhgc", q32, k.float()) * scale
    s = torch.where(okb, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(okb, torch.exp(s - m[..., None]), torch.zeros_like(s))
    vz = torch.where(ok[:, None, :, None], v.float(), torch.zeros(()))
    return m, p.sum(dim=-1), torch.einsum("bhgc,bhcd->bhgd", p, vz)


def _neutral_partial(b, hkv, g, d):
    """What an empty split writes: (NEG_INF, 0, 0)."""
    return (torch.full((b, hkv, g), _NEG_INF), torch.zeros((b, hkv, g)),
            torch.zeros((b, hkv, g, d)))


def _oracle_combine(parts, q):
    """The combine kernel: a running (m, l, acc) over the partials in split
    order, m' = max(m, M_s), a = exp(m - m'), c = exp(M_s - m')."""
    b, _, hq, d = q.shape
    hkv, g = parts[0][0].shape[1:]
    m, l, acc = _neutral_partial(b, hkv, g, d)
    for ms, ls, accs in parts:
        m2 = torch.maximum(m, ms)
        a, c = torch.exp(m - m2), torch.exp(ms - m2)
        l = l * a + ls * c
        acc = acc * a[..., None] + accs * c[..., None]
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).reshape(b, 1, hq, d)


def _oracle_flash(q, k, v, kvp, pos, *, window=0, kv_split=None):
    """K2's split and combine kernels in tensor code: every split writes a
    partial, the empty ones past T their neutral one."""
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    num_split = min(kv_split or default_kv_split(t), t)
    ck = -(-t // num_split)
    kvp = torch.as_tensor(kvp).to(torch.int32)
    kvp = (kvp[None] if kvp.dim() == 1 else kvp).expand(b, t)
    posv = torch.as_tensor(pos).to(torch.int32).expand(b)
    q32 = q[:, 0].reshape(b, hkv, g, d).float()
    parts = []
    for s in range(num_split):
        lo, hi = min(s * ck, t), min((s + 1) * ck, t)
        parts.append(_oracle_partial(
            q32, k[:, lo:hi].transpose(1, 2), v[:, lo:hi].transpose(1, 2),
            kvp[:, lo:hi], posv, window, d ** -0.5) if hi > lo
            else _neutral_partial(b, hkv, g, d))
    return _oracle_combine(parts, q)


def _oracle_paged(q, k_pages, v_pages, page_table, pos_map, pos, *,
                  window=0):
    """K3's split and combine kernels in tensor code: one split a page."""
    b, _, hq, d = q.shape
    n_pages, ps, hkv, _ = k_pages.shape
    g = hq // hkv
    pt = page_table.long().clamp(0, n_pages - 1)
    posv = torch.as_tensor(pos).to(torch.int32).expand(b)
    q32 = q[:, 0].reshape(b, hkv, g, d).float()
    parts = [_oracle_partial(q32, k_pages[pt[:, s]].transpose(1, 2),
                             v_pages[pt[:, s]].transpose(1, 2),
                             pos_map[:, s * ps:(s + 1) * ps], posv, window,
                             d ** -0.5)
             for s in range(page_table.shape[1])]
    return _oracle_combine(parts, q)


def _oracle_case(rng, case):
    """(q, k, v, kvp, pos, window, kv_split) of one layout case, fp32."""
    b, t, hq, hkv, d = 3, 32, 8, 4, 16
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    k = rng.randn(b, t, hkv, d).astype(np.float32)
    v = rng.randn(b, t, hkv, d).astype(np.float32)
    kvp = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    pos = np.array([t - 1, 20, 9], np.int32)
    window, kv_split = 0, 4
    if case == "masked_middle_split":       # split 1 of 4 holds no position
        kvp[:, 8:16] = -1
    elif case == "inactive_slot":
        pos[1] = -1
    elif case == "ring_wrap":               # slot j holds the latest position
        pos = np.array([70, 40, 33], np.int32)   # <= pos congruent to j
        j = np.arange(t)
        src = j[None] + t * ((pos[:, None] - j[None]) // t)
        kvp = np.where(src >= 0, src, -1).astype(np.int32)
        window = t
    elif case == "t_not_a_multiple":        # 3 splits of 11, 11, 10
        kv_split = 3
    elif case == "empty_trailing_splits":   # T = 10 over 8 splits of 2
        t = 10
        k, v, kvp = k[:, :t], v[:, :t], kvp[:, :t]
        pos = np.array([9, 4, -1], np.int32)
        kv_split = 8
    elif case == "rising_max":              # every split raises the max
        q = np.abs(q)
        k = 0.1 * k + 0.05 * np.arange(t, dtype=np.float32)[None, :, None,
                                                             None]
        kv_split = 8
    return (q, np.ascontiguousarray(k), np.ascontiguousarray(v), kvp, pos,
            window, kv_split)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["masked_middle_split", "inactive_slot",
                                  "ring_wrap", "t_not_a_multiple",
                                  "empty_trailing_splits", "rising_max"])
def test_split_combine_oracle_matches_plain_and_jax(case, dtype):
    """The kernels' arithmetic (per-split partials against each split's own
    max, combined in order) agrees with flash_decode_plain and the JAX
    kernel in interpret mode on the same inputs."""
    rng = np.random.RandomState(13)
    q, k, v, kvp, pos, window, kv_split = _oracle_case(rng, case)
    tol = TOL if dtype == "fp32" else TOL_BF16
    if dtype == "fp32":
        tq, tk, tv = _t(q), _t(k), _t(v)
        jq, jk, jv = q, k, v
    else:
        tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = _oracle_flash(tq, tk, tv, _t(kvp), _t(pos), window=window,
                        kv_split=kv_split)
    assert got.dtype == tq.dtype
    plain = flash_decode_plain(tq, tk, tv, _t(kvp), _t(pos), window=window,
                               kv_split=kv_split)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=tol)
    want = np.asarray(j_flash(jnp.asarray(jq), jnp.asarray(jk),
                              jnp.asarray(jv), jnp.asarray(kvp),
                              jnp.asarray(pos), window=window,
                              kv_split=kv_split).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    for row in np.flatnonzero(pos < 0):     # an inactive slot: exact zeros
        assert float(got[row].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_split_combine_oracle_paged_is_bit_exact_vs_dense(dtype):
    """One split a page: the paged oracle equals the dense one over the
    gathered view bit for bit, and agrees with paged_flash_decode_plain and
    the JAX paged kernel."""
    rng = np.random.RandomState(14)
    q, kp, vp, table, pos_map, pos, npg = _paged_case(rng)
    tol = TOL if dtype == "fp32" else TOL_BF16
    cast = (lambda a: _t(a)) if dtype == "fp32" else \
        (lambda a: _t(a).bfloat16())
    tq, tkp, tvp = cast(q), cast(kp), cast(vp)
    got = _oracle_paged(tq, tkp, tvp, _t(table), _t(pos_map), _t(pos))
    dense = _oracle_flash(tq, paged_view(tkp, _t(table), _t(pos_map)),
                          paged_view(tvp, _t(table), _t(pos_map)),
                          _t(pos_map), _t(pos), kv_split=npg)
    assert torch.equal(got, dense)
    plain = paged_flash_decode_plain(tq, tkp, tvp, _t(table), _t(pos_map),
                                     _t(pos))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=tol)
    jcast = (lambda a: jnp.asarray(a)) if dtype == "fp32" else \
        (lambda a: jnp.asarray(a, jnp.bfloat16))
    want = np.asarray(j_paged(jcast(q), jcast(kp), jcast(vp),
                              jnp.asarray(table), jnp.asarray(pos_map),
                              jnp.asarray(pos)).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


def test_neutral_partial_leaves_the_combine_bitwise_unchanged():
    """(NEG_INF, 0, 0) folded in at any place changes nothing: exp(NEG_INF -
    NEG_INF) = 1 before the first visible split, exp(NEG_INF - m) = 0
    after it, and l_s = acc_s = 0 either way."""
    rng = np.random.RandomState(15)
    q, k, v, kvp, pos, _, _ = _oracle_case(rng, "masked_middle_split")
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q32 = _t(q)[:, 0].reshape(b, hkv, g, d)
    parts = [_oracle_partial(q32, _t(k)[:, lo:lo + 8].transpose(1, 2),
                             _t(v)[:, lo:lo + 8].transpose(1, 2),
                             _t(kvp)[:, lo:lo + 8], _t(pos), 0, d ** -0.5)
             for lo in range(0, 32, 8)]
    base = _oracle_combine(parts, _t(q))
    neutral = _neutral_partial(b, hkv, g, d)
    for at in range(len(parts) + 1):
        assert torch.equal(
            _oracle_combine(parts[:at] + [neutral] + parts[at:], _t(q)),
            base)
