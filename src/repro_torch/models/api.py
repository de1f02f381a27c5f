"""Family-dispatching model API (this slice: the ``bert`` family).

Counterpart of ``repro/models/api.py``; batch key for bert: ``tokens``.
The other families come with ROADMAP.md Queue 1 items 9 and slice 5.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import bert as bert_mod

_ITEM_FAMILIES = ("ROADMAP.md Queue 1 item 9 (LM path) and slice 5 (the "
                  "other families)")


def _bert_only(cfg: ModelConfig):
    if cfg.family != "bert":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with "
            f"{_ITEM_FAMILIES}")


def init_model(seed, cfg: ModelConfig, device=None):
    """Seeded random weights on ``device`` (the CUDA card by default).
    ``seed`` is an int or a ``torch.Generator`` on that device."""
    _bert_only(cfg)
    dev = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    return bert_mod.init_bert(gen, cfg, device=dev)


def model_forward(params, cfg: ModelConfig, batch, packs=None):
    """-> (logits fp32, aux)."""
    _bert_only(cfg)
    logits = bert_mod.forward(params, cfg, batch["tokens"], packs=packs)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
