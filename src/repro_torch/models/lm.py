"""Decoder-only LM: forward, one-pass prefill into a decode cache, suffix
prefill, batched decode over request slots, and the slot lifecycle. Layers
mix global / windowed attention, MLA (``models/mla.py``), a Mamba-2 SSD
mixer (``models/ssm.py``) or an RG-LRU block (``models/rglru.py``) with a
dense MLP, a MoE FFN (``models/moe.py``) or none; the vlm family's patch
embeddings replace the first positions of ``forward``'s embedded tokens.

Counterpart of ``repro/models/lm.py`` (the dense, vlm, moe, ssm and hybrid
families). Layer stacks follow the config's ``layer_plan()``: an
unrolled prefix, ``n_periods`` repetitions of the (possibly heterogeneous)
``pattern`` -- stored stacked, period axis first, as the reference's
``lax.scan`` carries them, so a JAX tree bridges over as it is -- and an
unrolled suffix. Here the periods run as a Python loop over views of the
stacked leaves; when autograd records ``forward``, each period runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` over the
scan body), so the backward holds one activation per period boundary.

Caches are preallocated and written **in place**: the reference returns an
updated copy of the cache from every step and its serving engine donates
the old buffers; here ``decode_step``, ``prefill_cache``, ``prefill_suffix``
and the slot ops write into the cache's tensors and return the same tree.

Logits are fp32, as the reference's einsum with fp32 accumulation and
output gives them: the head is applied as an fp32 matrix product, and for a
bf16 model one fp32 copy of the (tied) head is made on first use and kept
as long as the head tensor lives (``_head_f32``; never under autograd).

The recurrent mixers' caches (``state`` / ``h`` and the ``conv`` history)
are slot-dense like the attention rings: one-pass and chunk prefills carry
the state as the reference's do, and the slot ops reset, copy and read them
with the KV leaves.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.core.tree import leaves
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Draw, StackedDraw, apply_mlp,
                                       apply_norm,
                                       embed_lookup, head_logits, init_mlp,
                                       init_norm, normal_init,
                                       paged_bulk_write)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked(n, fn):
    """``fn()`` drawn ``n`` times, stacked leafwise on a new leading axis."""
    parts = [fn() for _ in range(n)]
    return _tree_stack(parts)


def _tree_stack(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _tree_stack([p[k] for p in parts]) for k in first}
    if isinstance(first, Draw):         # deferred: the periods' draws
        return StackedDraw(tuple(parts))
    return torch.stack(parts)


def _init_layer(gen, cfg: ModelConfig, kind: LayerKind, device):
    dt = cfg.tdtype
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, dt, device)}
    if kind.mixer in ("attn", "local"):
        p["attn"] = attn.init_attention(gen, cfg, device)
    elif kind.mixer == "mla":
        p["attn"] = mla_mod.init_mla(gen, cfg, device)
    elif kind.mixer == "ssm":
        p["mixer"] = ssm_mod.init_ssm(gen, cfg, device)
    elif kind.mixer == "rglru":
        p["mixer"] = rglru_mod.init_rglru(gen, cfg, device)
    else:
        raise ValueError(kind.mixer)
    if kind.ffn == "dense":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dt, device)
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device)
    elif kind.ffn == "moe":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dt, device)
        p["ffn"] = moe_mod.init_moe(gen, cfg, device)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Seeded random weights in the reference's tree layout: ``embed``,
    ``final_norm`` (+ ``lm_head`` when untied), ``prefix``, ``blocks`` (one
    period-stacked dict per pattern entry) and ``suffix``."""
    prefix, pattern, n_periods, suffix = cfg.layer_plan()
    dt = cfg.tdtype
    params = {"embed": {"w": normal_init(gen, (cfg.vocab_size, cfg.d_model),
                                         0.02, dt, device)},
              "final_norm": init_norm(cfg.d_model, cfg.norm, dt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_init(
            gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)}
    params["prefix"] = tuple(_init_layer(gen, cfg, kind, device)
                             for kind in prefix)
    params["blocks"] = tuple(
        _stacked(n_periods, lambda kind=kind: _init_layer(gen, cfg, kind,
                                                          device))
        for kind in pattern) if n_periods > 0 else ()
    params["suffix"] = tuple(_init_layer(gen, cfg, kind, device)
                             for kind in suffix)
    return params


# ---------------------------------------------------------------------------
# layer walk
# ---------------------------------------------------------------------------

def _index(tree, i):
    """Period ``i`` of a stacked subtree (views, no copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_packs(packs, scope):
    """Select a scope's packs: keys '<scope>/<name>' -> {'<name>': pack}."""
    if not packs:
        return None
    pre = scope + "/"
    sel = {k[len(pre):]: v for k, v in packs.items() if k.startswith(pre)}
    return sel or None


def _layer_groups(params, cfg: ModelConfig, cache=None):
    """(is a period, [(kind, layer params, layer cache or None, pack
    scope)]) in execution order: the prefix, then each period of the
    pattern, then the suffix."""
    prefix, pattern, n_periods, suffix = cfg.layer_plan()
    yield False, [(kind, params["prefix"][i],
                   cache["prefix"][i] if cache else None, f"prefix/{i}")
                  for i, kind in enumerate(prefix)]
    for per in range(n_periods):
        yield True, [(kind, _index(params["blocks"][i], per),
                      _index(cache["blocks"][i], per) if cache else None,
                      f"blocks/{i}") for i, kind in enumerate(pattern)]
    yield False, [(kind, params["suffix"][i],
                   cache["suffix"][i] if cache else None, f"suffix/{i}")
                  for i, kind in enumerate(suffix)]


def _apply_layer(p, h, cfg, kind: LayerKind, *, positions, cache=None,
                 pos=None, packs=None, prefill_len=None, page_slot=None,
                 page_start=None, seq=None):
    """One layer -> (h, the MoE aux loss or None). ``seq``: a
    sequence-parallel block (``common.SeqShard``; attention layers)."""
    hn = apply_norm(p["norm1"], h, cfg.norm)
    mix_packs = _layer_packs(packs, "attn") or _layer_packs(packs, "mixer")
    kw = dict(cache=cache["mix"] if cache else None, pos=pos,
              packs=mix_packs, prefill_len=prefill_len, page_slot=page_slot)
    if kind.mixer in ("attn", "local"):
        out, _ = attn.apply_attention(p["attn"], hn, cfg, window=kind.window,
                                      positions=positions,
                                      page_start=page_start, seq=seq, **kw)
    elif kind.mixer == "mla":
        out, _ = mla_mod.apply_mla(p["attn"], hn, cfg, positions=positions,
                                   page_start=page_start, **kw)
    elif kind.mixer == "ssm":
        out, _ = ssm_mod.apply_ssm(p["mixer"], hn, cfg, **kw)
    elif kind.mixer == "rglru":
        out, _ = rglru_mod.apply_rglru(p["mixer"], hn, cfg, **kw)
    else:
        raise ValueError(kind.mixer)
    h = h + out
    aux = None
    if kind.ffn != "none" and "ffn" in p:
        hn = apply_norm(p["norm2"], h, cfg.norm)
        if kind.ffn == "moe":
            ffn_packs = _layer_packs(packs, "ffn")
            out, aux = moe_mod.apply_moe(
                p["ffn"], hn, cfg,
                shard=ffn_packs.get("experts") if ffn_packs else None,
                shared_packs=_layer_packs(ffn_packs, "shared"))
        else:
            out = apply_mlp(p["ffn"], hn, cfg.act,
                            packs=_layer_packs(packs, "ffn"))
        h = h + out
    return h, aux


def remat_active(params) -> bool:
    """True when ``forward`` runs each period under
    ``torch.utils.checkpoint`` -- the reference's ``jax.checkpoint`` over
    its scanned periods: grad mode on and some parameter requiring grad."""
    return torch.is_grad_enabled() and any(p.requires_grad
                                           for p in leaves(params))


def _run_layers(params, cfg, h, cache=None, packs=None, remat=False, **kw):
    """Every layer in order -> (h, the layers' MoE aux losses summed, fp32).
    With ``remat`` each period keeps only its input for the backward and
    runs its forward again there; the prefix and suffix do not."""
    def run(h, aux, group):
        for kind, lp, lc, scope in group:
            h, a = _apply_layer(lp, h, cfg, kind, cache=lc,
                                packs=_layer_packs(packs, scope), **kw)
            if a is not None:
                aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for is_period, group in _layer_groups(params, cfg, cache):
        if remat and is_period:
            h, aux = checkpoint(run, h, aux, group, use_reentrant=False)
        else:
            h, aux = run(h, aux, group)
    return h, aux


def _table(params, name, packs):
    """The (V, d) table ``params[name]['w']`` as this rank uses it: a mesh
    Trainer's shard gathers its "data" blocks (``DenseShard.weight``)."""
    shard = packs.get(name) if packs else None
    w = params[name]["w"]
    return w if shard is None else shard.weight(w)


def _embed(params, cfg: ModelConfig, tokens, packs=None, table=None):
    h = embed_lookup(_table(params, "embed", packs) if table is None
                     else table, tokens,
                     packs.get("embed") if packs else None)
    if cfg.scale_embedding:
        # the reference multiplies by sqrt(d) rounded to the model dtype;
        # the factor is rounded on the host, so no copy to the device
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype))
    return h


# id(head tensor) -> (weak ref to it, its version, fp32 copy)
_HEAD_F32: Dict[int, tuple] = {}


def _head_f32(head: torch.Tensor) -> torch.Tensor:
    """The head as fp32: the tensor itself when it is fp32, else one fp32
    copy made on first use, dropped when the head tensor dies and remade if
    it is written in place. Under autograd (grad mode on, the head requiring
    grad) a fresh copy each call, cached nowhere: a cached copy would keep
    its graph -- and through it the head -- alive, and one cached while
    grad was off would cut the head's gradient."""
    if head.dtype == torch.float32:
        return head
    if torch.is_grad_enabled() and head.requires_grad:
        return head.float()
    key = id(head)
    hit = _HEAD_F32.get(key)
    if hit is not None and hit[0]() is head and hit[1] == head._version:
        return hit[2]
    f32 = head.float()
    _HEAD_F32[key] = (weakref.ref(head), head._version, f32)
    weakref.finalize(head, _HEAD_F32.pop, key, None)
    return f32


def _logits(params, cfg: ModelConfig, h, packs=None, table=None):
    """Final norm, then fp32 logits (B, S, V) over the (tied) head
    (``table``: the embedding as ``_table`` gave it, reused when tied)."""
    h = apply_norm(params["final_norm"], h, cfg.norm)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = table if table is not None and name == "embed" else \
        _table(params, name, packs)
    return head_logits(h, _head_f32(head),
                       packs.get(name) if packs else None)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, *, mm_embeds=None, packs=None,
            last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) fp32, the MoE aux loss summed over
    the layers; 0 without MoE). ``mm_embeds`` (B, P, d), the vlm family's
    patch embeddings, replace the first P positions after the embedding
    scale. ``last_only``: the logits of the last position alone.

    ``packs['seq']`` (a ``common.SeqShard``): ``tokens`` are this rank's
    block of S of a sequence-parallel row -- its positions start at the
    block's offset and attention sees the whole row; with ``last_only``
    the ranks not holding the row's last position return None logits."""
    b, s = tokens.shape
    seq = packs.get("seq") if packs else None
    table = _table(params, "embed", packs)     # one gather when tied
    h = _embed(params, cfg, tokens, packs, table)
    if mm_embeds is not None:
        n_p = mm_embeds.shape[1]
        h = torch.cat([mm_embeds.to(h.dtype), h[:, n_p:]], dim=1)
    positions = (torch.arange(s, device=h.device) if seq is None
                 else seq.positions(s, h.device))[None, :]
    h, aux = _run_layers(params, cfg, h, packs=packs,
                         remat=remat_active(params), positions=positions,
                         seq=seq)
    if last_only:
        if seq is not None and not seq.last:
            return None, aux
        h = h[:, -1:]
    return _logits(params, cfg, h, packs, table), aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg, kind: LayerKind, batch, cache_len, paged, lead,
                      device):
    if kind.mixer in ("attn", "local"):
        one = attn.init_cache_attn(cfg, batch, cache_len, kind.window,
                                   paged=paged, device=device)
    elif kind.mixer == "mla":
        one = mla_mod.init_cache_mla(cfg, batch, cache_len, paged=paged,
                                     device=device)
    elif kind.mixer == "ssm":
        one = ssm_mod.init_cache_ssm(cfg, batch, device=device)
    elif kind.mixer == "rglru":
        one = rglru_mod.init_cache_rglru(cfg, batch, device=device)
    else:
        raise ValueError(kind.mixer)
    if lead:
        # real storage per period (written in place), not a broadcast view
        one = {k: x[None].repeat((lead[0],) + (1,) * x.dim())
               for k, x in one.items()}
    return {"mix": one}


def init_cache(cfg: ModelConfig, batch, cache_len, paged=None, device=None):
    """Zeroed decode cache for ``batch`` request slots. ``paged`` (a
    ``models.common.PagedLayout``) moves every global (window 0) attention
    layer and every MLA layer onto page pools; ring caches and the SSM /
    RG-LRU state stay slot-dense (O(window) or O(1) a slot)."""
    prefix, pattern, n_periods, suffix = cfg.layer_plan()
    return {
        "prefix": tuple(_init_layer_cache(cfg, k, batch, cache_len, paged,
                                          (), device) for k in prefix),
        "blocks": tuple(_init_layer_cache(cfg, k, batch, cache_len, paged,
                                          (n_periods,), device)
                        for k in pattern) if n_periods > 0 else (),
        "suffix": tuple(_init_layer_cache(cfg, k, batch, cache_len, paged,
                                          (), device) for k in suffix),
    }


# ---------------------------------------------------------------------------
# slot lifecycle (the batch dim is request slots). Cache leaves carry the
# slot dim at axis 0 in the unrolled prefix/suffix sections and at axis 1 in
# the period-stacked ``blocks``. Page pools (``*_pages``) are skipped by the
# per-slot ops: their axis 0 is physical pages.
# ---------------------------------------------------------------------------

def _sections(cache):
    """(layer cache, slot axis) for every layer."""
    for c in cache["prefix"]:
        yield c, 0
    for c in cache["blocks"]:
        yield c, 1
    for c in cache["suffix"]:
        yield c, 0


def _slot(x, axis, slot):
    return x[slot] if axis == 0 else x[:, slot]


def reset_slot(cache, slot):
    """Empty request slot ``slot`` in place: KV, SSM / RG-LRU state and
    conv history zeros, ``pos_map`` and ``page_table`` -1, so a recycled
    slot cannot leak its previous request (stale page content becomes
    unreachable)."""
    slot = int(slot)
    for c, axis in _sections(cache):
        for name, x in c["mix"].items():
            if not name.endswith("_pages"):
                _slot(x, axis, slot).fill_(attn.slot_reset_value(name))
    return cache


def write_slot(cache, slot, sub):
    """Copy the batch-1 cache ``sub`` (e.g. a prefill result) into slot
    ``slot`` of the batched ``cache``, in place."""
    slot = int(slot)
    for (c, axis), (s, _) in zip(_sections(cache), _sections(sub)):
        for name, x in c["mix"].items():
            _slot(x, axis, slot).copy_(_slot(s["mix"][name], axis, 0))
    return cache


def read_slot(cache, slot):
    """Slot ``slot`` as a new batch-1 cache (a copy: writes to it do not
    reach ``cache``)."""
    slot = int(slot)

    def section(cs, axis):
        return tuple({"mix": {k: (x[slot:slot + 1] if axis == 0
                                  else x[:, slot:slot + 1]).clone()
                              for k, x in c["mix"].items()}} for c in cs)
    return {"prefix": section(cache["prefix"], 0),
            "blocks": section(cache["blocks"], 1),
            "suffix": section(cache["suffix"], 0)}


# pool leaf -> the dense batch-1 sub-cache leaf that feeds it
_POOL_SRC = {"k_pages": "k", "v_pages": "v",
             "c_kv_pages": "c_kv", "k_rope_pages": "k_rope"}


def write_slot_paged(cache, slot, sub, page_row):
    """Insert a dense batch-1 prefill result ``sub`` into paged slot
    ``slot``, in place: each pool leaf takes the sub-cache rows page by
    page into the physical pages named by ``page_row`` (int (NP,), -1 =
    unallocated, skipped), the slot's ``page_table`` row becomes
    ``page_row`` and ``pos_map`` copies over. Every allocated page is fully
    written, so recycled pages cannot leak stale values. Ring caches take
    the ordinary dense slot write."""
    slot = int(slot)
    for (c, axis), (s, _) in zip(_sections(cache), _sections(sub)):
        m, ms = c["mix"], s["mix"]
        if "page_table" not in m:
            for name, x in m.items():
                _slot(x, axis, slot).copy_(_slot(ms[name], axis, 0))
            continue
        row = torch.as_tensor(page_row, device=m["page_table"].device).to(
            torch.int32)
        for name, x in m.items():
            if name in _POOL_SRC:
                y = ms[_POOL_SRC[name]]
                if axis == 0:
                    paged_bulk_write(x, row, y[0])
                else:                       # (P, n_pages, ps, ...) pools
                    for per in range(x.shape[0]):
                        paged_bulk_write(x[per], row, y[per, 0])
            elif name == "page_table":
                _slot(x, axis, slot).copy_(row)
            else:                           # pos_map: plain dense insert
                _slot(x, axis, slot).copy_(_slot(ms[name], axis, 0))
    return cache


def restore_slot_paged(cache, slot, page_row, resume_len):
    """Re-attach retained pages to slot ``slot`` after a preemption (or
    install a prefix hit's pages): ``page_row`` back into the slot's page
    table and positions 0..resume_len-1 live in ``pos_map``. Page content
    is untouched. Paged layers only."""
    slot = int(slot)
    for c, axis in _sections(cache):
        m = c["mix"]
        if "page_table" not in m:
            continue
        t = m["pos_map"].shape[-1]
        ar = torch.arange(t, device=m["pos_map"].device, dtype=torch.int32)
        pm_row = torch.where(ar < int(resume_len), ar, torch.full_like(ar,
                                                                       -1))
        _slot(m["page_table"], axis, slot).copy_(torch.as_tensor(
            page_row, device=ar.device).to(torch.int32))
        _slot(m["pos_map"], axis, slot).copy_(pm_row)
    return cache


# ---------------------------------------------------------------------------
# decode and prefill
# ---------------------------------------------------------------------------

def decode_step(params, cache, cfg: ModelConfig, token, pos, *, packs=None):
    """token (B, 1) + cache at ragged positions ``pos`` (scalar or (B,);
    rows with pos < 0 are inactive, their cache untouched) -> (logits
    (B, 1, V) fp32, cache), the new K/V rows written in place."""
    b = token.shape[0]
    h = _embed(params, cfg, token, packs)
    pos = attn.as_slot_positions(pos, b, h.device)
    positions = pos.clamp_min(0)[:, None]              # (B, 1), rope-safe
    h, _ = _run_layers(params, cfg, h, cache, packs, positions=positions,
                       pos=pos)
    return _logits(params, cfg, h, packs), cache


def _logits_rows(params, cfg, h, packs, last_only, length):
    """The logits of every position, or (``last_only``) of position
    ``length - 1`` alone, (B, 1, V): a mesh servable's prefill gathers the
    vocabulary blocks of that row only."""
    if last_only:
        h = h[:, length - 1:length]
    return _logits(params, cfg, h, packs)


def prefill_cache(params, cache, cfg: ModelConfig, tokens, length=None, *,
                  packs=None, last_only: bool = False):
    """One-pass prompt prefill: ``tokens`` (B, S) from position 0 run
    through the forward attention paths while every layer rewrites its
    cache with positions 0..length-1 (``length`` <= S; the tail is bucket
    padding and leaves no trace). Returns (logits (B, S, V) fp32, cache);
    sample the next token from ``logits[:, length - 1]`` (with
    ``last_only``, the logits are that row alone, (B, 1, V))."""
    b, s = tokens.shape
    length = s if length is None else int(length)
    h = _embed(params, cfg, tokens, packs)
    positions = torch.arange(s, device=h.device)[None, :]
    h, _ = _run_layers(params, cfg, h, cache, packs, positions=positions,
                       prefill_len=length)
    return _logits_rows(params, cfg, h, packs, last_only, length), cache


def prefill_suffix(params, cache, cfg: ModelConfig, tokens, slot, start,
                   length=None, *, packs=None, last_only: bool = False):
    """Prefill only the suffix ``tokens`` (1, S) of a prompt whose first
    ``start`` tokens are already resident in slot ``slot`` of the batched
    cache -- a paged prefix-cache hit, or the next chunk of a chunked
    prefill (dense rings or pages): each layer writes the suffix K/V at
    positions start..start+length-1 and attends over resident prefix +
    suffix. Sample the next token from ``logits[0, length - 1]`` (with
    ``last_only``, the logits are that row alone)."""
    b, s = tokens.shape
    length = s if length is None else int(length)
    h = _embed(params, cfg, tokens, packs)
    positions = int(start) + torch.arange(s, device=h.device)[None, :]
    h, _ = _run_layers(params, cfg, h, cache, packs, positions=positions,
                       prefill_len=length, page_slot=int(slot),
                       page_start=int(start))
    return _logits_rows(params, cfg, h, packs, last_only, length), cache
