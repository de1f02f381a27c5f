"""Multi-head Latent Attention (DeepSeek-V2): a compressed KV cache through a
low-rank joint projection.

Counterpart of ``repro/models/mla.py``. The train / prompt-prefill path
expands per-head K/V from the latent ``c_kv`` of every token; the chunk /
suffix prefill writes the chunk's latents first and attends expanded K/V
built from the slot's latent view; decode uses the *absorbed* form: W_uk is
folded into the query, so scores are taken against the (T, kv_lora_rank)
latent cache directly. Decode is the plain composition on every device, as
the reference runs it with XLA and not with a decode kernel.

On a mesh whose cache shards the latent rank over "model" (``packs
['latent']``, a ``common.LatentShard``) every rank computes the new latent
rows whole and writes its r-block; the absorbed decode all-reduces its fp32
partial scores over the blocks before the rope scores are added, and its
fp32 partial output (``ctx`` block times ``w_uv``'s block columns); a chunk
prefill all-gathers the slot's latent view (exact) and expands it as one
device does; the one-pass prefill needs no collective. The mesh Trainer
cuts the query heads instead (``packs['heads']``): its train path runs
over the rank's heads and keeps the latent projections replicated.

Caches are preallocated and written in place (``models/attention.py``).
The reference also accepts a 1-D shared ``pos_map`` left from an older cache
layout; the port never builds one, so that branch is not carried over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import (NEG_INF, _masked_row_write,
                                          as_slot_positions, flash_attention,
                                          full_attention, masked_attention,
                                          paged_suffix_positions,
                                          prefill_slot_sources)
from repro_torch.models.common import (apply_rope, column_block,
                                       init_linear, linear,
                                       linear_from_block, model_block,
                                       paged_row_write, paged_view, rms_norm)


def init_mla(gen, cfg, device=None):
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.tdtype
    return {
        "wq": init_linear(gen, d, h * (dn + dr), dt, device=device),
        "w_dkv": init_linear(gen, d, r, dt, device=device),    # x -> c_kv
        "w_krope": init_linear(gen, d, dr, dt, device=device),  # shared key
        "w_uk": init_linear(gen, r, h * dn, dt, device=device),  # c -> k_nope
        "w_uv": init_linear(gen, r, h * dv, dt, device=device),  # c -> v
        "wo": init_linear(gen, h * dv, d, dt, device=device),
        "kv_norm": {"scale": torch.zeros((r,), dtype=dt, device=device)},
    }


def init_cache_mla(cfg, batch, cache_len, paged=None, device=None):
    """Latent decode cache: ``c_kv`` (B, T, r) and ``k_rope`` (B, T, dr),
    or with ``paged`` (a ``models.common.PagedLayout``) page pools
    ``c_kv_pages`` / ``k_rope_pages`` (n_pages, page_size, .) addressed
    through a per-slot ``page_table``; ``pos_map`` stays dense (B, T)."""
    dtype = cfg.tdtype
    i32 = torch.int32
    pm = torch.full((batch, cache_len), -1, dtype=i32, device=device)
    if paged is not None:
        npg = paged.table_width(cache_len)
        return {"c_kv_pages": torch.zeros(
                    (paged.n_pages, paged.page_size, cfg.kv_lora_rank),
                    dtype=dtype, device=device),
                "k_rope_pages": torch.zeros(
                    (paged.n_pages, paged.page_size, cfg.qk_rope_dim),
                    dtype=dtype, device=device),
                "page_table": torch.full((batch, npg), -1, dtype=i32,
                                         device=device),
                "pos_map": pm}
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device),
            "pos_map": pm}


def _chunk_prefill(p, cfg, q, c_kv, k_rope, cache, *, length, slot, start,
                   lat=None):
    """One slot's next prompt slice at absolute positions start.. (the first
    ``length`` real): its latents are written first (the latent cache is
    linear, slot == position), then the queries attend expanded K/V built
    from the slot's updated latent view. Returns (1, S, H, dv)."""
    s, dev = q.shape[1], q.device
    if lat is not None:
        c_kv = lat.block(c_kv)
    pos_i = start + torch.arange(s, device=dev)
    valid = torch.arange(s, device=dev) < length
    if "c_kv_pages" in cache:
        cp, rp = cache["c_kv_pages"], cache["k_rope_pages"]
        n, psz = cp.shape[0], cp.shape[1]
        npg = cache["page_table"].shape[1]
        pt_row = cache["page_table"][slot]                       # (NP,)
        pp = pt_row[(pos_i // psz).clamp(0, npg - 1)].long()
        valid = valid & (pp >= 0)
        dest = (pp * psz + pos_i % psz)[valid]
        cp.view(n * psz, cp.shape[2])[dest] = c_kv[0][valid].to(cp.dtype)
        rp.view(n * psz, rp.shape[2])[dest] = \
            k_rope[0, :, 0][valid].to(rp.dtype)
        pm_row = paged_suffix_positions(npg * psz, start, length, device=dev)
        cache["pos_map"][slot] = pm_row
        c_view = paged_view(cp, pt_row[None], pm_row[None])      # (1,T,r)
        r_view = paged_view(rp, pt_row[None], pm_row[None])      # (1,T,dr)
    else:
        c_row, r_row = cache["c_kv"][slot], cache["k_rope"][slot]
        t = c_row.shape[0]
        valid = valid & (pos_i < t)
        c_row[pos_i[valid]] = c_kv[0][valid].to(c_row.dtype)
        r_row[pos_i[valid]] = k_rope[0, :, 0][valid].to(r_row.dtype)
        pm_row = paged_suffix_positions(t, start, length, device=dev)
        cache["pos_map"][slot] = pm_row
        c_view, r_view = c_row[None], r_row[None]
    if lat is not None:
        c_view = lat.gather(c_view)
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    tv = c_view.shape[1]
    k_nope = linear(p["w_uk"], c_view).reshape(1, tv, h, dn)
    v = linear(p["w_uv"], c_view).reshape(1, tv, h, dv)
    k = torch.cat([k_nope, r_view[:, :, None, :].expand(1, tv, h, dr)],
                  dim=-1)
    qpos = pos_i[None, :, None]                                  # (1,S,1)
    ok = (pm_row[None, None, :] >= 0) & (pm_row[None, None, :] <= qpos)
    # v padded to the q/k head width so the shared attention applies
    return masked_attention(q, k, F.pad(v, (0, dn + dr - dv)), ok)[..., :dv]


def _absorbed_decode(p, cfg, q_nope, q_rope, c_kv, k_rope, cache, pos,
                     out_dtype, lat=None):
    """One decode step at ragged per-slot ``pos`` (< 0 = inactive, its cache
    rows untouched): the new latent rows are written in place and the
    absorbed scores run in fp32 against the latent cache. -> (B, 1, H, dv).
    With ``lat`` the cache holds this rank's r-block: the scores and the
    output are fp32 partials over it, all-reduced."""
    b = q_nope.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    r = cfg.kv_lora_rank
    dev = q_nope.device
    posv = as_slot_positions(pos, b, dev)
    active = posv >= 0
    rows = torch.arange(b, device=dev)
    pm = cache["pos_map"]
    if lat is not None:
        c_kv = lat.block(c_kv)
    if "c_kv_pages" in cache:
        # paged latents: the new row goes into the slot's current page and
        # the scores read a gathered slot-contiguous view -- elementwise the
        # dense latent cache, so decode stays bit-exact against it
        pt = cache["page_table"]
        paged_row_write(cache["c_kv_pages"], pt, posv, c_kv[:, 0], active)
        paged_row_write(cache["k_rope_pages"], pt, posv, k_rope[:, 0, 0, :],
                        active)
        _masked_row_write(pm, rows, posv.long().clamp_min(0),
                          posv.clamp_min(0), active)
        c_cache = paged_view(cache["c_kv_pages"], pt, pm)
        r_cache = paged_view(cache["k_rope_pages"], pt, pm)
    else:
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        slot = posv.long().clamp_min(0) % c_cache.shape[1]
        _masked_row_write(c_cache, rows, slot, c_kv[:, 0], active)
        _masked_row_write(r_cache, rows, slot, k_rope[:, 0, 0, :], active)
        _masked_row_write(pm, rows, slot, posv.clamp_min(0), active)
    # the weights keep the (d_out, d_in) layout: w_uk (H*dn, r), w_uv (H*dv, r)
    w_uk = p["w_uk"]["w"].reshape(h, dn, r)
    q_abs = torch.einsum("bqhd,hdr->bqhr", q_nope, w_uk)
    w_uv = p["w_uv"]["w"].reshape(h, dv, r)
    if lat is not None:
        q_abs, w_uv = lat.block(q_abs), lat.block(w_uv)
    s_lat = torch.einsum("bqhr,btr->bhqt", q_abs.float(), c_cache.float())
    if lat is not None:
        s_lat = lat.reduce(s_lat)
    s_rope = torch.einsum("bqhd,btd->bhqt", q_rope.float(), r_cache.float())
    scores = (s_lat + s_rope) * ((dn + dr) ** -0.5)
    ok = (pm >= 0) & (pm <= posv[:, None])              # per-row causal mask
    scores = torch.where(ok[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=dev))
    pr = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqt,btr->bqhr", pr, c_cache.float())
    out = torch.einsum("bqhr,hvr->bqhv", ctx, w_uv.float())
    if lat is not None:
        out = lat.reduce(out)
    return out.to(out_dtype)


def apply_mla(p, x, cfg, *, positions, cache=None, pos=None, packs=None,
              prefill_len=None, page_slot=None, page_start=None):
    """x: (B, S, d) -> (out, cache). The branches of ``apply_attention``:
    no cache (train / forward), a chunk / suffix prefill (S > 1 with
    ``page_slot`` / ``page_start``, dense or paged latents), a one-pass
    prompt prefill (S > 1; dense latents only) and one absorbed decode step
    (S == 1 at ``pos``). ``packs`` may hold ``wq`` and ``wo`` (the
    export's MLA targets, or the mesh Trainer's shards) and ``heads``."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    # the mesh Trainer's head cut (a ``common.HeadShard`` over the H query
    # heads): q from the rank's rows of ``wq``'s column shard, K/V
    # expanded for every head by the replicated ``w_uk`` / ``w_uv`` and cut
    # to the rank's heads (``scatter_to``: their gradient is gathered
    # whole, so the latent projections' gradient is whole and equal on
    # every rank with no "model" reduce), the heads' output block straight
    # into ``wo``'s row-parallel shard
    heads = packs.get("heads") if packs and cache is None else None
    lo, hi = model_block(heads.mesh, h) if heads is not None else (0, h)
    q = column_block(p["wq"], x, packs and packs.get("wq"), lo * (dn + dr),
                     hi * (dn + dr)).reshape(b, s, hi - lo, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, theta=cfg.rope_theta)
    c_kv = rms_norm(linear(p["w_dkv"], x), p["kv_norm"]["scale"])
    k_rope = apply_rope(linear(p["w_krope"], x)[:, :, None, :], positions,
                        theta=cfg.rope_theta)                   # (B,S,1,dr)
    wo = packs and packs.get("wo")
    lat = packs.get("latent") if packs else None

    if cache is not None and s > 1 and page_slot is not None:
        if b != 1:
            raise ValueError("a chunk prefill takes one slot's tokens")
        length = s if prefill_len is None else int(prefill_len)
        o = _chunk_prefill(p, cfg, torch.cat([q_nope, q_rope], dim=-1),
                           c_kv, k_rope, cache, length=length,
                           slot=int(page_slot), start=int(page_start),
                           lat=lat)
        return linear(p["wo"], o.reshape(1, s, h * dv), wo), cache

    if cache is None or s > 1:
        # expanded path: per-head K/V materialized from the latents
        k_nope = linear(p["w_uk"], c_kv).reshape(b, s, h, dn)
        v = linear(p["w_uv"], c_kv).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        if heads is not None:
            k = heads.mesh.scatter_to(k, "model", 2)
            v = heads.mesh.scatter_to(v, "model", 2)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        # v padded to the q/k head width so the shared attention applies
        attn = full_attention if s <= 1024 else flash_attention
        o = attn(qf, k, F.pad(v, (0, dn + dr - dv)), causal=True)[..., :dv]
        out = linear_from_block(p["wo"], o.reshape(b, s, (hi - lo) * dv),
                                wo, heads)
        if cache is None:
            return out, None
        if "c_kv_pages" in cache:
            raise NotImplementedError(
                "whole-cache prompt prefill is undefined for a paged MLA "
                "layout; prefill a dense batch-1 sub-cache and insert it "
                "with write_slot_paged")
        # prompt prefill: rewrite the latent cache (linear, T >= prompt)
        t = cache["c_kv"].shape[1]
        length = s if prefill_len is None else int(prefill_len)
        src, slot_pos = prefill_slot_sources(t, length, s, device=x.device)
        keep = (slot_pos >= 0)[None, :, None]
        c_own = c_kv if lat is None else lat.block(c_kv)
        for name, val in (("c_kv", c_own), ("k_rope", k_rope[:, :, 0, :])):
            buf = cache[name]
            zero = torch.zeros((), dtype=val.dtype, device=x.device)
            buf.copy_(torch.where(keep, val[:, src], zero).to(buf.dtype))
        cache["pos_map"].copy_(slot_pos[None].expand(b, t))
        return out, cache

    if pos is None:
        raise ValueError("a decode step (S == 1) needs pos")
    o = _absorbed_decode(p, cfg, q_nope, q_rope, c_kv, k_rope, cache, pos,
                         x.dtype, lat)
    return linear(p["wo"], o.reshape(b, 1, h * dv), wo), cache
