"""On-device token sampling for the serving decode paths (greedy).

Counterpart of ``repro/models/sampling.py`` for ``temperature == 0``: the
greedy argmax over fp32 logit rows, which takes the first index on ties as
``jnp.argmax`` does. Temperature / top-k sampling with the reference's
slot- and position-keyed PRNG raises: the port draws no random bits that
could match JAX's threefry (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_tokens", "sample_token_row"]

_ITEM_SAMPLING = "ROADMAP.md Queue 1 item 11 (sampling at temperature > 0)"


def _greedy_only(temperature: float, top_k: int):
    if temperature > 0.0:
        raise NotImplementedError(
            f"temperature={temperature} (top_k={top_k}) comes with "
            f"{_ITEM_SAMPLING}")


def sample_tokens(logits, key=None, pos=None, *, temperature: float = 0.0,
                  top_k: int = 0):
    """``logits (B, V)`` -> greedy token ids ``(B,)`` int32, on the logits'
    device (``key``/``pos`` are the reference's PRNG arguments, unused by
    the greedy path)."""
    _greedy_only(temperature, top_k)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token_row(logits_row, key=None, slot: int = 0, position: int = 0,
                     *, temperature: float = 0.0, top_k: int = 0) -> int:
    """Single-row variant for host-side call sites (the engine's
    prefill-sampled first token)."""
    _greedy_only(temperature, top_k)
    if isinstance(logits_row, torch.Tensor):
        return int(torch.argmax(logits_row))
    return int(np.argmax(np.asarray(logits_row)))
