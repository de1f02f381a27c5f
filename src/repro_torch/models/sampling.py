"""On-device token sampling for the serving decode paths.

Counterpart of ``repro/models/sampling.py``: greedy, temperature and top-k
sampling over a batch of logit rows with *slot- and position-keyed* PRNG.
The key that slot ``b`` uses to sample the token after position ``p`` is
``fold_in(fold_in(base_key, b), max(p, 0))``, so the fused K-step loop
(``models.api.decode_many``) and the per-step loop draw the same samples.

Keys are JAX's threefry2x32 keys computed in torch (``models/prng.py``):
the same base seed gives the reference's keys and random bits bit for bit,
on the CPU and on the card. ``temperature == 0`` is the greedy argmax (the
first index on ties, as ``jnp.argmax``) and draws nothing. The top-k
restriction keeps ``lax.top_k``'s order -- descending, the lower index
first among equal values -- through a stable sort, which ``torch.topk``
does not promise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import prng

__all__ = ["sample_tokens", "sample_token_row", "slot_keys"]


def slot_keys(key: torch.Tensor, pos, slot_offset: int = 0) -> torch.Tensor:
    """Per-row sampling keys ``(B, 2)`` for a batch of slots:
    ``fold_in(fold_in(key, slot), max(pos, 0))`` with ``slot = row +
    slot_offset`` (a data-parallel rank's rows are slots from its
    offset on)."""
    pos = torch.as_tensor(pos, device=key.device).to(torch.int64)
    rows = int(slot_offset) + torch.arange(pos.shape[0], dtype=torch.int64,
                                           device=key.device)
    return prng.fold_in(prng.fold_in(key, rows), pos.clamp_min(0))


def _sample(rows: torch.Tensor, keys: torch.Tensor, temperature: float,
            top_k: int) -> torch.Tensor:
    """Sample one index a row of ``rows (B, V)`` with keys ``(B, 2)``."""
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its rounded reciprocal, which is not the reference's IEEE quotient
    temp = torch.tensor(float(temperature), dtype=torch.float32,
                        device=rows.device)
    scaled = rows.float() / temp
    if top_k and top_k > 0:
        vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :int(top_k)], idx[:, :int(top_k)]
        choice = prng.categorical(keys, vals)
        return torch.gather(idx, 1, choice[:, None])[:, 0]
    return prng.categorical(keys, scaled)


def sample_tokens(logits, key=None, pos=None, *, temperature: float = 0.0,
                  top_k: int = 0, slot_offset: int = 0):
    """``logits (B, V)`` -> sampled token ids ``(B,)`` int32, on the logits'
    device.

    ``temperature == 0`` is the greedy argmax (``key``/``pos`` unused).
    Otherwise the logits are divided by ``temperature`` and sampled
    categorically, optionally restricted to the ``top_k`` largest entries
    of each row. ``key`` is a ``(2,)`` threefry key (``prng.PRNGKey``) and
    ``pos`` the per-slot positions the samples follow; inactive rows
    (pos < 0) still produce a (meaningless) token -- callers mask them.
    Row ``i`` is slot ``slot_offset + i``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = slot_keys(key.to(logits.device), pos, slot_offset)
    return _sample(logits, keys, temperature, top_k).to(torch.int32)


def sample_token_row(logits_row, key=None, slot: int = 0, position: int = 0,
                     *, temperature: float = 0.0, top_k: int = 0) -> int:
    """Single-row variant for host-side call sites (the engine's
    prefill-sampled first token), with the key derivation of
    :func:`sample_tokens`: ``fold_in(fold_in(key, slot),
    max(position, 0))``."""
    if temperature <= 0.0:
        if isinstance(logits_row, torch.Tensor):
            return int(torch.argmax(logits_row))
        return int(np.argmax(np.asarray(logits_row)))
    row = torch.as_tensor(np.asarray(logits_row)) \
        if not isinstance(logits_row, torch.Tensor) else logits_row
    k = prng.fold_in(prng.fold_in(key.to(row.device), int(slot)),
                     max(int(position), 0))
    return int(_sample(row.reshape(1, -1), k[None], temperature, top_k)[0])
