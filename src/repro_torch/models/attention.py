"""Attention for the BERT encoder: bidirectional, no cache.

Counterpart of the BERT part of ``repro/models/attention.py``: the head
split/merge, ``init_attention``, the materialized-scores ``full_attention``
with ``causal=False``, and the no-cache branch of ``apply_attention``
(including the fused-QKV split). Written as plain tensor code like the
reference's einsums. The causal, windowed, flash and cached decode paths
come with the LM slice (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import init_linear, linear

_ITEM_LM = "ROADMAP.md Queue 1 item 9 (the LM model path)"


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _merge_heads(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def init_attention(gen, cfg, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    dt = cfg.tdtype
    p = {"wq": init_linear(gen, d, cfg.n_heads * hd, dt, device=device),
         "wk": init_linear(gen, d, cfg.n_kv_heads * hd, dt, device=device),
         "wv": init_linear(gen, d, cfg.n_kv_heads * hd, dt, device=device),
         "wo": init_linear(gen, cfg.n_heads * hd, d, dt, device=device)}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=device)}
        p["k_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=device)}
    return p


def full_attention(q, k, v, *, causal=False):
    """Materialized-scores attention. q: (B,S,Hq,D), k/v: (B,T,Hkv,D).
    Scores in fp32 scaled by D**-0.5, softmax in fp32, probabilities cast
    to v's dtype before the value product."""
    if causal:
        raise NotImplementedError(f"causal attention comes with {_ITEM_LM}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * (d ** -0.5)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype), v)
    return out.reshape(b, s, hq, d)


def apply_attention(p, x, cfg, *, causal=True, packs=None):
    """x: (B,S,d) -> (out, None), the no-cache bidirectional path.

    When the sparse export fused the q/k/v projections (``packs['wqkv']``),
    one block-sparse matmul produces all three and the output is split at
    the (Hq*D, Hkv*D, Hkv*D) boundaries."""
    if causal:
        raise NotImplementedError(
            f"causal and cached attention come with {_ITEM_LM}")
    if "q_norm" in p or cfg.rotary_fraction > 0:
        raise NotImplementedError(f"qk-norm and RoPE come with {_ITEM_LM}")
    s = x.shape[1]
    if s > 2048:
        raise NotImplementedError(
            f"flash attention (sequences over 2048) comes with {_ITEM_LM}")
    hd = cfg.head_dim
    fused = packs.get("wqkv") if packs else None
    if fused is not None:
        qkv = linear(p["wqkv"], x, fused)
        dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q = _split_heads(qkv[..., :dq], cfg.n_heads, hd)
        k = _split_heads(qkv[..., dq:dq + dkv], cfg.n_kv_heads, hd)
        v = _split_heads(qkv[..., dq + dkv:], cfg.n_kv_heads, hd)
    else:
        q = _split_heads(linear(p["wq"], x, packs and packs.get("wq")),
                         cfg.n_heads, hd)
        k = _split_heads(linear(p["wk"], x, packs and packs.get("wk")),
                         cfg.n_kv_heads, hd)
        v = _split_heads(linear(p["wv"], x, packs and packs.get("wv")),
                         cfg.n_kv_heads, hd)
    out = full_attention(q, k, v, causal=False)
    out = linear(p["wo"], _merge_heads(out), packs and packs.get("wo"))
    return out, None
