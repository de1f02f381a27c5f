"""JAX's threefry2x32 PRNG in torch: the keys and draws of ``jax.random``.

The reference samples with ``jax.random`` under its defaults (``jax 0.9``:
threefry2x32 keys, ``jax_threefry_partitionable`` on, 32-bit mode, the
"low" Gumbel mode). Threefry is a fixed integer hash, so the same keys and
random bits come out of torch bit for bit. Every value here is a uint32
held in an int64 tensor and masked to 32 bits after each addition and
shift: torch has no unsigned 32-bit arithmetic on every device, and int64
runs the same code on the CPU and on the card.

A key is an int64 tensor ``(..., 2)``; leading axes batch independent keys
(what ``jax.vmap`` over keys gives). Functions:

  * :func:`PRNGKey` -- ``jax.random.PRNGKey(seed)`` (32-bit mode);
  * :func:`fold_in` -- ``jax.random.fold_in`` for a batch of keys and data;
  * :func:`random_bits` -- ``jax.random.bits(key, shape)`` (uint32), the
    partitionable counter layout: element ``i`` of the flattened shape
    hashes the 64-bit counter ``i`` as its (high, low) words and keeps
    their xor;
  * :func:`uniform`, :func:`gumbel` -- fp32 draws from those bits;
  * :func:`categorical` -- ``argmax(gumbel + logits)`` over the last axis.

The integer functions are bitwise equal to JAX's on any device. ``gumbel``
takes two fp32 logarithms, which torch and XLA may round differently by an
ulp.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["PRNGKey", "fold_in", "threefry2x32", "random_bits", "uniform",
           "gumbel", "categorical"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000          # 1.0f: exponent 0, mantissa 0
_F32_MANTISSA = 23


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; broadcast elementwise. Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the seed is cut to its
    low 32 bits, which become the key's second word (the first is 0)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for keys ``(..., 2)`` and integer
    ``data`` broadcastable to ``key.shape[:-1]`` (each datum taken as a
    uint32): the hash of the counter pair ``(0, data)``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in int64) for keys
    ``(..., 2)``: the result has shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(n) for n in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    k1, k2 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in fp32: the 23 high bits of each draw as the
    mantissa of a number in [1, 2), minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    f = ((bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS).to(torch.int32)
    one = torch.ones((), dtype=torch.float32, device=key.device)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    floats = f.view(torch.float32) - one
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in fp32 ("low" mode): ``-log(-log(u))`` of a
    uniform draw on [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    Gumbel-max sample, the first index on ties. ``key`` is ``(..., 2)``
    with ``key.shape[:-1] == logits.shape[:-1]``; returns int64 indices."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
