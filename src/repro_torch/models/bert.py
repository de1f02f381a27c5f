"""BERT encoder (the paper's pruning target) with MLM head.

Counterpart of ``repro/models/bert.py``: post-LN transformer, learned
positional embeddings, GELU FFN, tied MLM decoder, no biases. Layers are
unrolled so each layer can carry its own block-sparse pattern. ``packs``
routes the projections through the block-sparse layouts exported by
``serving.export``; ``packs=None`` is the dense baseline. A mesh servable's
packs also mark the dense leaves it shards (``common.DenseShard`` under
'embed', 'pos', 'mlm_dense' and the projections' keys).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, embed_lookup,
                                       gelu, head_logits, init_mlp,
                                       init_norm, linear, normal_init,
                                       tp_copy)

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


def forward(params, cfg: ModelConfig, tokens, *, packs=None,
            last_only: bool = False):
    """tokens (B, S) int -> MLM logits (B, S, V) fp32; with ``last_only``
    the last position's alone (B, 1, V).

    ``packs['seq']`` (a ``common.SeqShard``): ``tokens`` are this rank's
    block of S of a sequence-parallel row: its position rows start at the
    block's offset and attention sees the whole row; with ``last_only``
    the ranks not holding the row's last position return None."""
    b, s = tokens.shape
    top = packs or {}
    seq = top.get("seq")
    pos = torch.arange(s, device=tokens.device) if seq is None else \
        seq.positions(s, tokens.device)
    # a mesh Trainer's shards gather their "data" blocks here, once
    emb = _weight(params["embed"]["w"], top.get("embed"))
    h = embed_lookup(emb, tokens, top.get("embed")) \
        + embed_lookup(_weight(params["pos"], top.get("pos")), pos,
                       top.get("pos"))[None]
    h = apply_norm(params["embed_norm"], h, "ln")
    for i, lp in enumerate(params["layers"]):
        lpacks = _sel(packs, f"layers/{i}")
        out, _ = attn.apply_attention(lp["attn"], h, cfg, causal=False,
                                      packs=_sel(lpacks, "attn"), seq=seq)
        h = apply_norm(lp["norm1"], h + out, "ln")           # post-LN
        out = apply_mlp(lp["ffn"], h, "gelu", packs=_sel(lpacks, "ffn"))
        h = apply_norm(lp["norm2"], h + out, "ln")
    if last_only:
        if seq is not None and not seq.last:
            return None
        h = h[:, -1:]
    t = gelu(linear(params["mlm_dense"], tp_copy(h, top.get("mlm_dense")),
                    top.get("mlm_dense")))
    t = apply_norm(params["mlm_norm"], t, "ln")
    # a plain product outside any kernel, as the reference leaves it to XLA
    return head_logits(t, emb.float(), top.get("embed"))


def _weight(w, shard):
    return w if shard is None else shard.weight(w)


def _sel(packs, scope):
    if not packs:
        return None
    pre = scope + "/"
    sel = {k[len(pre):]: v for k, v in packs.items() if k.startswith(pre)}
    return sel or None
