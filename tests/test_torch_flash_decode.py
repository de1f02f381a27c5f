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
