"""BERT encoder (the paper's pruning target) with MLM head.

Counterpart of ``repro/models/bert.py``: post-LN transformer, learned
positional embeddings, GELU FFN, tied MLM decoder, no biases. Layers are
unrolled so each layer can carry its own block-sparse pattern. ``packs``
routes the projections through the block-sparse layouts exported by
``serving.export``; ``packs=None`` is the dense baseline.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, gelu, init_mlp,
                                       init_norm, linear, normal_init)

MAX_POSITIONS = 512


def init_bert(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Seeded random weights in the reference's tree layout. ``gen`` draws
    every weight in a fixed order, so one seed gives one model."""
    dt = cfg.tdtype
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn": attn.init_attention(gen, cfg, device),
            "norm1": init_norm(cfg.d_model, "ln", dt, device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dt, device),
            "norm2": init_norm(cfg.d_model, "ln", dt, device),
        })
    return {
        "embed": {"w": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                   dt, device)},
        "pos": normal_init(gen, (MAX_POSITIONS, cfg.d_model), 0.02, dt,
                           device),
        "embed_norm": init_norm(cfg.d_model, "ln", dt, device),
        "layers": tuple(layers),
        "mlm_dense": {"w": normal_init(gen, (cfg.d_model, cfg.d_model), 0.02,
                                       dt, device)},
        "mlm_norm": init_norm(cfg.d_model, "ln", dt, device),
    }


def forward(params, cfg: ModelConfig, tokens, *, packs=None):
    """tokens (B, S) int -> MLM logits (B, S, V) fp32."""
    b, s = tokens.shape
    h = params["embed"]["w"][tokens] + params["pos"][None, :s]
    h = apply_norm(params["embed_norm"], h, "ln")
    for i, lp in enumerate(params["layers"]):
        lpacks = _sel(packs, f"layers/{i}")
        out, _ = attn.apply_attention(lp["attn"], h, cfg, causal=False,
                                      packs=_sel(lpacks, "attn"))
        h = apply_norm(lp["norm1"], h + out, "ln")           # post-LN
        out = apply_mlp(lp["ffn"], h, "gelu", packs=_sel(lpacks, "ffn"))
        h = apply_norm(lp["norm2"], h + out, "ln")
    t = gelu(linear(params["mlm_dense"], h))
    t = apply_norm(params["mlm_norm"], t, "ln")
    # a plain product outside any kernel, as the reference leaves it to XLA
    return torch.matmul(t.float(), params["embed"]["w"].float().t())


def _sel(packs, scope):
    if not packs:
        return None
    pre = scope + "/"
    sel = {k[len(pre):]: v for k, v in packs.items() if k.startswith(pre)}
    return sel or None
