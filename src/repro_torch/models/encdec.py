"""Encoder-decoder transformer backbone (the whisper-base shape).

Counterpart of ``repro/models/encdec.py``. The audio conv frontend is a
stub in both packages: the caller feeds precomputed frame embeddings
(B, n_audio_ctx, d_model). Encoder layers are bidirectional; decoder layers
are causal self-attention then cross-attention over the encoder output.

Decode caches: per decoder layer a self-attention KV cache plus the cross
K/V computed once from the encoder output. Every leaf is layer-stacked,
slot at axis 1: ``{'self': {'k', 'v': (L, B, T, Hkv, D), 'pos_map':
(L, B, T)}, 'cross_k', 'cross_v': (L, B, T_audio, Hkv, D)}``. Caches are
written in place (the reference returns updated copies); the slot ops
reset, copy and read every leaf, the cross K/V included. On a mesh (the
mesh servable's shard objects as ``packs``) a rank holds its slots' and
KV heads' shard of every leaf; the encoder, self- and cross-attention run
over its heads.

When autograd records the training forward, each decoder layer runs under
``torch.utils.checkpoint``, as the reference wraps its decoder body in
``jax.checkpoint``; the encoder does not, as in the reference.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm,
                                       column_block, embed_lookup,
                                       head_logits, init_mlp, init_norm,
                                       model_block, normal_init, tp_copy)
from repro_torch.models.lm import (_head_f32, _index, _layer_packs, _table,
                                   _tree_stack, remat_active)


def _init_enc_layer(gen, cfg, device):
    dt = cfg.tdtype
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dt, device),
            "attn": attn.init_attention(gen, cfg, device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dt, device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device)}


def _init_dec_layer(gen, cfg, device):
    dt = cfg.tdtype
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dt, device),
            "attn": attn.init_attention(gen, cfg, device),
            "norm_x": init_norm(cfg.d_model, cfg.norm, dt, device),
            "xattn": attn.init_attention(gen, cfg, device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dt, device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Seeded random weights in the reference's tree layout, the encoder
    and decoder layers stacked on a leading layer axis."""
    dt = cfg.tdtype
    return {
        "enc_pos": normal_init(gen, (cfg.n_audio_ctx, cfg.d_model), 0.02, dt,
                               device),
        "enc_layers": _tree_stack([_init_enc_layer(gen, cfg, device)
                                   for _ in range(max(cfg.n_enc_layers,
                                                      1))]),
        "enc_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
        "embed": {"w": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                   dt, device)},
        "dec_layers": _tree_stack([_init_dec_layer(gen, cfg, device)
                                   for _ in range(max(cfg.n_layers, 1))]),
        "dec_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
    }


def _n_layers(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def encode(params, cfg: ModelConfig, frames, packs=None):
    """frames: (B, T_audio, d) stub embeddings -> encoder output. ``packs``:
    a mesh servable's shard objects (``enc_layers/...``), nothing else."""
    h = frames.to(cfg.tdtype) + params["enc_pos"][None]
    positions = torch.arange(h.shape[1], device=h.device)[None]
    layers = params["enc_layers"]
    scope = _layer_packs(packs, "enc_layers")
    for i in range(_n_layers(layers)):
        lp = _index(layers, i)
        hn = apply_norm(lp["norm1"], h, cfg.norm)
        out, _ = attn.apply_attention(lp["attn"], hn, cfg,
                                      positions=positions, causal=False,
                                      packs=_layer_packs(scope, "attn"))
        h = h + out
        hn = apply_norm(lp["norm2"], h, cfg.norm)
        h = h + apply_mlp(lp["ffn"], hn, cfg.act,
                          packs=_layer_packs(scope, "ffn"))
    return apply_norm(params["enc_norm"], h, cfg.norm)


def _cross_kv(lp, cfg, enc_out, packs=None):
    """The cross K/V (B, T, Hkv, D) of ``enc_out``; with a ``HeadShard``
    in ``packs`` (``dec_layers/xattn/...``) only this rank's heads, from
    its own rows of ``wk`` / ``wv`` where they are exactly those heads
    (in training ``enc_out`` enters them through one ``copy_to``: its
    gradient sums every rank's heads)."""
    b, t, _ = enc_out.shape
    packs = packs or {}
    heads = packs.get("heads")
    lo, hi = (0, cfg.n_kv_heads) if heads is None \
        else model_block(heads.mesh, cfg.n_kv_heads)
    hd = cfg.head_dim
    enc_out = tp_copy(enc_out, packs.get("wk"), packs.get("wv"))

    def proj(name):
        return column_block(lp["xattn"][name], enc_out, packs.get(name),
                            lo * hd, hi * hd,
                            None if heads is None else heads.mesh
                            ).reshape(b, t, hi - lo, hd)
    return proj("wk"), proj("wv")


def _dec_layer(lp, h, cfg, *, positions, enc_out=None, cross_kv=None,
               cache=None, pos=None, packs=None):
    hn = apply_norm(lp["norm1"], h, cfg.norm)
    out, _ = attn.apply_attention(lp["attn"], hn, cfg, positions=positions,
                                  cache=cache, pos=pos,
                                  packs=_layer_packs(packs, "attn"))
    h = h + out
    hn = apply_norm(lp["norm_x"], h, cfg.norm)
    xpacks = _layer_packs(packs, "xattn")
    kv = cross_kv if cross_kv is not None else _cross_kv(lp, cfg, enc_out,
                                                         xpacks)
    out, _ = attn.apply_attention(
        lp["xattn"], hn, cfg, positions=positions, kv_override=kv,
        causal=False, cache={} if cache is not None else None, pos=pos,
        packs=xpacks)
    h = h + out
    hn = apply_norm(lp["norm2"], h, cfg.norm)
    return h + apply_mlp(lp["ffn"], hn, cfg.act,
                         packs=_layer_packs(packs, "ffn"))


def _embed(params, tokens, packs, table=None):
    return embed_lookup(_table(params, "embed", packs) if table is None
                        else table, tokens,
                        packs.get("embed") if packs else None)


def _logits(params, cfg, h, packs=None, table=None):
    """Decoder norm, then fp32 logits over the tied embedding (one fp32
    copy of a bf16 embedding, as ``lm._head_f32`` keeps it; a mesh
    servable gathers the vocabulary blocks, a mesh Trainer keeps its
    block; ``table``: the embedding as ``lm._table`` gave it)."""
    h = apply_norm(params["dec_norm"], h, cfg.norm)
    head = _table(params, "embed", packs) if table is None else table
    return head_logits(h, _head_f32(head),
                       packs.get("embed") if packs else None)


def forward(params, cfg: ModelConfig, frames, tokens, packs=None):
    """(frames, decoder tokens (B, S)) -> (logits (B, S, V) fp32, aux 0).
    ``packs``: a mesh servable's or a mesh Trainer's shard objects (the
    family exports no packs)."""
    enc_out = encode(params, cfg, frames, packs)
    s = tokens.shape[1]
    table = _table(params, "embed", packs)     # one gather, tied head
    h = _embed(params, tokens, packs, table)
    positions = torch.arange(s, device=h.device)[None]
    layers = params["dec_layers"]
    scope = _layer_packs(packs, "dec_layers")
    remat = remat_active(params)
    for i in range(_n_layers(layers)):
        if remat:
            h = checkpoint(_dec_layer, _index(layers, i), h, cfg,
                           positions=positions, enc_out=enc_out,
                           packs=scope, use_reentrant=False)
        else:
            h = _dec_layer(_index(layers, i), h, cfg, positions=positions,
                           enc_out=enc_out, packs=scope)
    return _logits(params, cfg, h, packs, table), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def cache_like(cfg: ModelConfig, n_dec, batch, cache_len, t_audio):
    """Every leaf of a whole decode cache of ``n_dec`` decoder layers on
    the meta device (shapes and dtypes only): what ``launch/sharding``'s
    cache rules and a rank's shard shapes are computed from."""
    one = attn.init_cache_attn(cfg, batch, cache_len, device="meta")
    kv = (n_dec, batch, t_audio, cfg.n_kv_heads, cfg.head_dim)
    return {"self": {k: x[None].expand((n_dec,) + tuple(x.shape))
                     for k, x in one.items()},
            "cross_k": torch.empty(kv, dtype=cfg.tdtype, device="meta"),
            "cross_v": torch.empty(kv, dtype=cfg.tdtype, device="meta")}


def init_cache(params, cfg: ModelConfig, frames, cache_len, packs=None,
               mesh=None):
    """Run the encoder once over ``frames`` (B, T_audio, d); return zeroed
    per-layer self caches (real storage per layer) and the cross K/V.

    With ``mesh`` (a ``launch.mesh.ProcessMesh``; ``packs``: the mesh
    servable's shard objects) this rank's shard of every leaf
    (``launch/sharding.spec_for_cache``): the slots of its "data" block
    where the batch divides (it encodes only their frames) and, under a
    ``HeadShard``, its KV heads of the self and cross K/V."""
    layers = params["dec_layers"]
    n_dec = _n_layers(layers)
    b = frames.shape[0]
    whole = cache_like(cfg, n_dec, b, cache_len, frames.shape[1])
    shapes = {k: tuple(x.shape) for k, x in whole["self"].items()}
    if mesh is not None:
        from repro_torch.launch.sharding import (cache_shardings,
                                                 shard_index, shard_shape)
        specs = cache_shardings(whole, mesh)
        shapes = {k: shard_shape(shapes[k], specs["self"][k], mesh)
                  for k in shapes}
        coord = {a: mesh.coord(a) for a in mesh.axis_names}
        idx, count = shard_index(specs["cross_k"][1], mesh, coord)
        w = b // count
        frames = frames[idx * w:(idx + 1) * w]
    enc_out = encode(params, cfg, frames, packs)
    xpacks = _layer_packs(_layer_packs(packs, "dec_layers"), "xattn")
    cross = [_cross_kv(_index(layers, i), cfg, enc_out, xpacks)
             for i in range(n_dec)]
    return {"self": {k: torch.full(shapes[k], attn.slot_reset_value(k),
                                   dtype=x.dtype, device=enc_out.device)
                     for k, x in whole["self"].items()},
            "cross_k": torch.stack([k for k, _ in cross]),
            "cross_v": torch.stack([v for _, v in cross])}


def decode_step(params, cache, cfg: ModelConfig, token, pos, packs=None):
    """token (B, 1) at ``pos`` (scalar or ragged (B,); rows with pos < 0 are
    inactive and leave their cache untouched) -> (logits (B, 1, V) fp32,
    cache), the self-attention K/V rows written in place. On a mesh
    (``packs``) self- and cross-attention run over the rank's KV heads of
    the cache and are gathered before ``wo``."""
    b = token.shape[0]
    h = _embed(params, token, packs)
    pos = attn.as_slot_positions(pos, b, h.device)
    positions = pos.clamp_min(0)[:, None]
    layers = params["dec_layers"]
    scope = _layer_packs(packs, "dec_layers")
    for i in range(_n_layers(layers)):
        self_c = {k: x[i] for k, x in cache["self"].items()}
        h = _dec_layer(_index(layers, i), h, cfg, positions=positions,
                       cross_kv=(cache["cross_k"][i], cache["cross_v"][i]),
                       cache=self_c, pos=pos, packs=scope)
    return _logits(params, cfg, h, packs), cache


# ---------------------------------------------------------------------------
# slot lifecycle: every cache leaf is layer-stacked, the slot dim at axis 1
# ---------------------------------------------------------------------------

def cache_leaves(cache):
    """(leaf name, tensor) for every cache leaf."""
    for name, x in cache["self"].items():
        yield name, x
    yield "cross_k", cache["cross_k"]
    yield "cross_v", cache["cross_v"]


def reset_slot(cache, slot):
    """Empty request slot ``slot`` in place: the self KV (``pos_map`` -1)
    AND the slot's cross K/V, so a recycled slot cannot leak its previous
    request's audio context."""
    slot = int(slot)
    for name, x in cache_leaves(cache):
        x[:, slot].fill_(attn.slot_reset_value(name))
    return cache


def write_slot(cache, slot, sub):
    """Copy a batch-1 cache (``init_cache`` over one request's frames, then
    its prompt) into slot ``slot``: the self cache and the request's cross
    K/V, in place."""
    slot = int(slot)
    for (_, x), (_, y) in zip(cache_leaves(cache), cache_leaves(sub)):
        x[:, slot].copy_(y[:, 0])
    return cache


def read_slot(cache, slot):
    """Slot ``slot`` as a new batch-1 cache (a copy)."""
    slot = int(slot)
    return {"self": {k: x[:, slot:slot + 1].clone()
                     for k, x in cache["self"].items()},
            "cross_k": cache["cross_k"][:, slot:slot + 1].clone(),
            "cross_v": cache["cross_v"][:, slot:slot + 1].clone()}
