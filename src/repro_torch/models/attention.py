"""Attention: GQA with RoPE, causal / windowed / chunked-flash prefill,
and single-token decode against (ring-)KV caches, dense or paged.

Counterpart of ``repro/models/attention.py``. The decode branches reach the
split-K kernels of ``kernels/flash_decode.py`` (K2 for dense slot caches,
K3 for page pools) or the plain ``decode_attention`` composition, as
:func:`~repro_torch.kernels.flash_decode.resolved_decode_kernel` says.

Caches are preallocated and written **in place**: where the reference
returns an updated copy of the cache (and its serving engine donates the
old buffers to the compiled step), every cached branch here writes the new
K/V rows and positions into the given tensors and returns the same dict.

With ``cfg.kv_cache_quant`` the dense slot caches hold int8 K/V with one
bf16 scale per (slot, position, head); decode then dequantizes the whole
cache and runs the plain ``decode_attention`` composition, as the reference
does (K2/K3 take bf16 / fp32 caches only).

Cross-attention (``kv_override``, the audio family's decoder) takes the
encoder K/V as they are: no K projection, no q/k norm on them, no RoPE; its
decode step is the plain ``decode_attention`` over every encoder position,
never K2, as in the reference.

``flash_attention`` carries the reference's FA2-schedule backward
(``_Flash``, as ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``): the forward saves
only the output and the per-row logsumexp, the backward recomputes each
tile. Tiles whose every (query, key) pair is masked are skipped in both
directions: they add exact zeros. With ``softcap > 0`` it raises under grad
(the reference's backward ignores the softcap, so its gradient would be
wrong; ROADMAP.md Queue 3).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import (flash_decode,
                                              paged_flash_decode,
                                              resolved_decode_kernel)
from repro_torch.models.common import (apply_rope, init_linear, linear,
                                       paged_row_write, paged_view, rms_norm,
                                       tp_copy)

NEG_INF = -1e30


def as_slot_positions(pos, batch, device=None):
    """Normalize ``pos`` to the ragged per-slot form: an int32 (B,) vector.

    A scalar ``pos`` -- the single-request calling convention -- broadcasts
    to every row. Negative entries mark inactive slots: their cache writes
    are suppressed and their outputs are meaningless."""
    pos = torch.as_tensor(pos, device=device)
    return pos.to(torch.int32).expand(batch).contiguous()


def _masked_row_write(buf, rows, slot, val, active):
    """Write ``val[i]`` into ``buf[i, slot[i]]`` where ``active[i]``, in
    place; inactive rows store their old content back (one scatter, no host
    sync; ``rows`` are distinct, so no two writers meet)."""
    keep = active.reshape((-1,) + (1,) * (val.dim() - 1))
    old = buf[rows, slot]
    buf[rows, slot] = torch.where(keep, val.to(buf.dtype), old)
    return buf


def slot_reset_value(name: str) -> int:
    """Reset value for one cache leaf's slot slice: ``pos_map`` and
    ``page_table`` empty out to -1, everything else to 0. Page-pool leaves
    (``*_pages``) are never reset per slot: their axis 0 is physical pages."""
    return -1 if name in ("pos_map", "page_table") else 0


def prefill_slot_sources(t, length, s, device=None):
    """Cache-slot gather plan for a one-pass prompt prefill.

    A prompt of ``length`` tokens (padded to ``s``, positions 0..length-1)
    lands in a T-slot ring cache at slot = pos % T; slot j ends up holding
    the latest position congruent to j. Returns ``(src, pos)``: per-slot
    source index into the (B, S, ...) prefill tensors (clipped) and the
    per-slot absolute position (-1 = empty). Linear caches (T >= prompt)
    are the ring's trivial case: slot j <- position j."""
    j = torch.arange(t, device=device)
    last = int(length) - 1
    src = j + t * torch.div(last - j, t, rounding_mode="floor")
    ok = (src >= 0) & (src <= last)
    return (src.clamp(0, s - 1),
            torch.where(ok, src, torch.full_like(src, -1)).to(torch.int32))


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _merge_heads(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


# ---------------------------------------------------------------------------
# core attention math (all paths share the grouped-heads convention)
# ---------------------------------------------------------------------------

def _neg_inf_like(s):
    return torch.full((), NEG_INF, dtype=s.dtype, device=s.device)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                   softcap=0.0):
    """Materialized-scores path for short sequences. q: (B,S,Hq,D), k/v:
    (B,T,Hkv,D). Scores in fp32 scaled by D**-0.5, softmax in fp32,
    probabilities cast to v's dtype before the value product."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * (d ** -0.5)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if causal or window > 0:
        qpos = q_offset + torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & ((qpos - kpos) < window)
        scores = torch.where(ok, scores, _neg_inf_like(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype), v)
    return out.reshape(b, s, hq, d)


def _chunks(n, c):
    """[lo, hi) bounds of the chunks of size ``c`` covering 0..n-1 (the
    last one ragged: no padding, so no padded row or column is computed)."""
    return [(lo, min(lo + c, n)) for lo in range(0, n, c)]


def _tile_live(q_lo, q_hi, k_lo, k_hi, causal, window, q_offset):
    """False when every (query, key) pair of the tile is masked."""
    if causal and k_lo > q_offset + q_hi - 1:
        return False
    if window > 0 and q_offset + q_lo - (k_hi - 1) >= window:
        return False
    return True


def _tile_ok(q_lo, q_hi, k_lo, k_hi, causal, window, q_offset, device):
    qpos = q_offset + torch.arange(q_lo, q_hi, device=device)[:, None]
    kpos = torch.arange(k_lo, k_hi, device=device)[None, :]
    ok = torch.ones((q_hi - q_lo, k_hi - k_lo), dtype=torch.bool,
                    device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & ((qpos - kpos) < window)
    return ok


def _heads_major(x, hkv=None):
    """(B, S, H, D) -> fp32 (B, Hkv, G, S, D) for queries (H = Hkv * G,
    ``hkv`` given), fp32 (B, H, S, D) for keys and values."""
    b, s, h, d = x.shape
    if hkv is None:
        return x.permute(0, 2, 1, 3).float()
    return x.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4).float()


def _flash_fwd(q, k, v, causal, window, q_offset, q_chunk, kv_chunk,
               softcap):
    """The reference's ``_flash_fwd_impl``: per (query chunk, KV chunk)
    tile, masked fp32 scores, the running max, probabilities stored in q's
    dtype, fp32 sums. Returns (out (B, S, Hq, D) in q's dtype, lse
    (B, Hkv, G, S) fp32)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    dev = q.device
    qf, kf, vf = _heads_major(q, hkv), _heads_major(k), _heads_major(v)
    outs, lses = [], []
    for q_lo, q_hi in _chunks(s, q_chunk):
        qblk = qf[:, :, :, q_lo:q_hi]
        m = torch.full((b, hkv, g, q_hi - q_lo), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, q_hi - q_lo, d), dtype=torch.float32,
                          device=dev)
        for k_lo, k_hi in _chunks(t, kv_chunk):
            if not _tile_live(q_lo, q_hi, k_lo, k_hi, causal, window,
                              q_offset):
                continue
            s_ = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                              kf[:, :, k_lo:k_hi]) * scale
            if softcap > 0:
                s_ = torch.tanh(s_ / softcap) * softcap
            ok = _tile_ok(q_lo, q_hi, k_lo, k_hi, causal, window, q_offset,
                          dev)
            m_new = torch.maximum(m, torch.where(
                ok, s_, _neg_inf_like(s_)).amax(dim=-1))
            p = torch.where(ok, torch.exp(s_ - m_new[..., None]),
                            torch.zeros((), device=dev)).to(q.dtype)
            corr = torch.exp(m - m_new)
            l = l * corr + p.float().sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.float(), vf[:, :, k_lo:k_hi])
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(
            b, q_hi - q_lo, hq, d))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=-1)


def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_offset, q_chunk,
               kv_chunk):
    """The reference's ``_flash_vjp_bwd`` (the FA2 schedule): KV chunks
    outer, query chunks inner; p = exp(s - lse) and ds = p (dp - delta)
    scale stored in q's dtype, fp32 accumulators, dq summed over the KV
    chunks in ascending order. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    dev = q.device
    qf, kf, vf = _heads_major(q, hkv), _heads_major(k), _heads_major(v)
    dof = _heads_major(dout.to(q.dtype), hkv)
    delta = (dof * _heads_major(out.to(q.dtype), hkv)).sum(dim=-1)
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for k_lo, k_hi in _chunks(t, kv_chunk):
        kblk, vblk = kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi]
        dk_j = torch.zeros_like(kblk)
        dv_j = torch.zeros_like(vblk)
        for q_lo, q_hi in _chunks(s, q_chunk):
            if not _tile_live(q_lo, q_hi, k_lo, k_hi, causal, window,
                              q_offset):
                continue
            qblk, doq = qf[:, :, :, q_lo:q_hi], dof[:, :, :, q_lo:q_hi]
            s_ = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk) * scale
            ok = _tile_ok(q_lo, q_hi, k_lo, k_hi, causal, window, q_offset,
                          dev)
            p = torch.where(ok, torch.exp(s_ - lse[..., q_lo:q_hi, None]),
                            torch.zeros((), device=dev)).to(q.dtype).float()
            dv_j += torch.einsum("bhgqk,bhgqd->bhkd", p, doq)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doq, vblk)
            ds = (p * (dp - delta[..., q_lo:q_hi, None]) * scale).to(
                q.dtype).float()
            dk_j += torch.einsum("bhgqk,bhgqd->bhkd", ds, qblk)
            dq[:, :, :, q_lo:q_hi] += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                                   kblk)
        dk[:, :, k_lo:k_hi] = dk_j
        dv[:, :, k_lo:k_hi] = dv_j
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: saves (q, k, v,
    out, lse), O(S * D), never a probability tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, q_chunk,
                              kv_chunk, 0.0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    q_chunk=1024, kv_chunk=1024, softcap=0.0):
    """Chunked online-softmax attention: O(Cq*Ckv) scores live at a time,
    and under autograd O(S*D) residuals (the output and the logsumexp; the
    backward recomputes each tile). q: (B,S,Hq,D), k/v: (B,T,Hkv,D).

    Raises with ``softcap > 0`` on inputs that require grad with grad mode
    on: the reference's backward ignores the softcap."""
    if softcap > 0:
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            raise NotImplementedError(
                "flash_attention has no backward with softcap > 0: the "
                "reference's backward ignores the softcap (ROADMAP.md "
                "Queue 3)")
        return _flash_fwd(q, k, v, causal, window, q_offset, q_chunk,
                          kv_chunk, softcap)[0]
    return _Flash.apply(q, k, v, causal, window, q_offset, q_chunk, kv_chunk)


def local_attention(q, k, v, *, window, q_offset=0):
    """Banded causal attention: FLOPs O(S * window), not O(S^2). Each query
    chunk (chunk size C divides the window) attends the previous
    ``window // C`` key chunks plus its own.

    ``q`` holds positions ``[q_offset, q_offset + S)`` of a row whose keys
    ``k`` / ``v`` hold positions ``[0, T)`` (T >= q_offset + S; a
    sequence-parallel block against the gathered row). The chunks are the
    row's, from position 0, so every query takes the keys and the score
    row one device gives it: a block whose offset is not a multiple of C
    is padded in front to its chunk's start."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q_offset + s > t:
        raise ValueError(f"queries at [{q_offset}, {q_offset + s}) past the "
                         f"{t} keys: a self-attention prefill path")
    g = hq // hkv
    c = min(window, 1024)
    if window % c:
        raise ValueError(f"window {window} is not a multiple of {c}")
    n_prev = window // c
    lead = q_offset % c
    c0 = (q_offset - lead) // c           # the row's chunk of the first query
    n = -(-(lead + s) // c)
    q = torch.cat([q.new_zeros((b, lead) + tuple(q.shape[2:])), q,
                   q.new_zeros((b, n * c - lead - s) + tuple(q.shape[2:]))],
                  dim=1)
    qb = q.reshape(b, n, c, hkv, g, d)

    def key_chunks(x):
        # the row's key chunks c0 - n_prev .. c0 + n - 1 (zeros outside
        # [0, t)), as (b, n + n_prev, c, h, d)
        lo, hi = (c0 - n_prev) * c, (c0 + n) * c
        sl = x[:, max(lo, 0):min(hi, t)]
        z = x.new_zeros((b, max(-lo, 0)) + tuple(x.shape[2:]))
        e = x.new_zeros((b, hi - lo - z.shape[1] - sl.shape[1])
                        + tuple(x.shape[2:]))
        return torch.cat([z, sl, e], dim=1).reshape(
            b, n + n_prev, c, hkv, d)

    kc, vc = key_chunks(k), key_chunks(v)
    k_ext = torch.cat([kc[:, p:p + n] for p in range(n_prev + 1)],
                      dim=2)                       # (b, n, (n_prev+1)c, h, d)
    v_ext = torch.cat([vc[:, p:p + n] for p in range(n_prev + 1)], dim=2)
    scores = torch.einsum("bnchgd,bnkhd->bnhgck", qb.float(),
                          k_ext.float()) * (d ** -0.5)
    dev = q.device
    ci = c0 + torch.arange(n, device=dev)[:, None, None]
    a = torch.arange(c, device=dev)[None, :, None]
    bcol = torch.arange((n_prev + 1) * c, device=dev)[None, None, :]
    qpos = ci * c + a
    kpos = (ci - n_prev) * c + bcol
    ok = (kpos >= 0) & (kpos <= qpos) & (qpos - kpos < window) & (kpos < t)
    scores = torch.where(ok[None, :, None, None], scores,
                         _neg_inf_like(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnhgck,bnkhd->bnchgd", p.to(v_ext.dtype), v_ext)
    return out.reshape(b, n * c, hq, d)[:, lead:lead + s]


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *, window=0):
    """One-step decode, the plain composition: q (B,1,Hq,D) vs caches
    (B,T,Hkv,D). ``kv_positions`` holds the absolute position stored in
    each cache slot (-1 = empty), (T,) shared or (B,T) per slot; ``pos`` a
    scalar or ragged (B,) vector. Probabilities are cast to the cache dtype
    for the value product, as the reference does."""
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, d)
    scores = torch.einsum("bqhgd,bthd->bhgqt", qg.float(),
                          k_cache.float()) * (d ** -0.5)
    kvp = kv_positions if kv_positions.dim() == 2 else kv_positions[None, :]
    posv = torch.as_tensor(pos, device=q.device).to(torch.int32)
    posv = posv[:, None] if posv.dim() else posv.reshape(1, 1)
    ok = (kvp >= 0) & (kvp <= posv)
    if window > 0:
        ok = ok & (kvp > posv - window)
    scores = torch.where(ok[:, None, None, None, :], scores,
                         _neg_inf_like(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, hq, d)


def masked_attention(q, k, v, ok):
    """Materialized-scores attention under an explicit boolean mask ``ok``
    (B, S, T): q (B,S,Hq,D) vs k/v (B,T,Hkv,D)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * (d ** -0.5)
    scores = torch.where(ok[:, None, None], scores, _neg_inf_like(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype), v)
    return out.reshape(b, s, hq, d)


def paged_suffix_positions(pos_map_len, start, length, device=None):
    """pos_map row after a suffix prefill of ``length`` real tokens starting
    at absolute position ``start`` on a slot whose shared-prefix pages
    already cover positions 0..start-1."""
    ar = torch.arange(pos_map_len, device=device, dtype=torch.int32)
    return torch.where(ar < int(start) + int(length), ar,
                       torch.full_like(ar, -1))


# ---------------------------------------------------------------------------
# the GQA attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

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


def init_cache_attn(cfg, batch, cache_len, window=0, dtype=None, paged=None,
                    device=None):
    """Linear cache for global layers, ring cache (len = window) for local.
    ``pos_map`` is (batch, T): each request slot tracks its own occupancy.

    ``paged`` (a ``models.common.PagedLayout``) switches GLOBAL layers to
    the pooled layout: K/V live in (n_pages, page_size, Hkv, D) page pools
    addressed through a per-slot ``page_table`` (batch, T // page_size)
    (-1 = unmapped); ``pos_map`` keeps its dense (batch, T) form. Ring
    caches (window > 0) stay slot-dense. With ``cfg.kv_cache_quant`` K/V
    are int8 with bf16 scales ``k_scale`` / ``v_scale`` (batch, T, Hkv)."""
    t = min(cache_len, window) if window > 0 else cache_len
    dtype = dtype or cfg.tdtype
    i32 = torch.int32
    if paged is not None and window == 0:
        if cfg.kv_cache_quant:
            raise NotImplementedError(
                "kv_layout='paged' does not compose with kv_cache_quant yet"
                " (int8 page pools + per-page scales are future work)")
        npg = paged.table_width(cache_len)
        pshape = (paged.n_pages, paged.page_size, cfg.n_kv_heads,
                  cfg.head_dim)
        return {"k_pages": torch.zeros(pshape, dtype=dtype, device=device),
                "v_pages": torch.zeros(pshape, dtype=dtype, device=device),
                "page_table": torch.full((batch, npg), -1, dtype=i32,
                                         device=device),
                "pos_map": torch.full((batch, t), -1, dtype=i32,
                                      device=device)}
    shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device),
                "pos_map": torch.full((batch, t), -1, dtype=i32,
                                      device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos_map": torch.full((batch, t), -1, dtype=i32, device=device)}


def _quantize_kv(x):
    """(B, S, H, D) -> int8 values + per-(B, S, H) bf16 scales: symmetric
    absmax over D, each step the reference's IEEE fp32 operation (division
    by a tensor, round half to even, clip), the scale rounded to bf16 only
    after the values are quantized."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its rounded reciprocal, which is not the reference's IEEE quotient
    q_max = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(amax, 1e-6) / q_max
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None].float()).to(dtype)


def _write_prefill_kv(cache, k, v, length):
    """One-pass prompt prefill, in place: replace the slot cache's contents
    with the K/V of positions 0..length-1 (k/v: (B, S>=length, Hkv, D)),
    quantized first for an int8 cache. Ring caches keep the window-latest
    positions; every other slot becomes empty (zeros, position -1), so a
    reused cache keeps nothing of its previous prompt."""
    b, s = k.shape[0], k.shape[1]
    t = cache["k"].shape[1]
    src, slot_pos = prefill_slot_sources(t, length, s, device=k.device)
    if "k_scale" in cache:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        vals = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        vals = {"k": k, "v": v}
    for name, x in vals.items():
        buf = cache[name]
        keep = (slot_pos >= 0).reshape((1, t) + (1,) * (buf.dim() - 2))
        zero = torch.zeros((), dtype=buf.dtype, device=k.device)
        buf.copy_(torch.where(keep, x[:, src].to(buf.dtype), zero))
    cache["pos_map"].copy_(slot_pos[None].expand(b, t))
    return cache


def _suffix_prefill_dense(q, k, v, cache, *, window, length, slot, start):
    """Dense chunk prefill: one slot's next prompt slice (q/k/v of S
    positions from ``start``, the first ``length`` real) against the
    batched slot cache. Attention runs before the cache write, over the
    slot's ring content concatenated with the fresh chunk K/V: writing
    first would let the chunk's tail overwrite ring slots (slot = pos % T)
    that its earlier queries still attend. Then the chunk is written
    latest-wins: ``prefill_slot_sources``' plan shifted to absolute
    positions start..start+length-1; ring slots whose latest congruent
    position predates the chunk keep their content. Returns the attention
    output (1, S, Hq, D); the cache is written in place."""
    if q.shape[0] != 1:
        raise ValueError("a chunk prefill takes one slot's tokens")
    if "k_scale" in cache:
        raise NotImplementedError(
            "chunked prefill does not compose with kv_cache_quant: the "
            "one-shot path attends unquantized chunk K/V, so a chunked run "
            "could not be token-exact against it")
    s, dev = q.shape[1], q.device
    t = cache["k"].shape[1]
    ck_row, cv_row = cache["k"][slot], cache["v"][slot]          # (T,H,D)
    pm_row = cache["pos_map"][slot]                              # (T,)
    pos_i = start + torch.arange(s, device=dev, dtype=torch.int32)
    validw = torch.arange(s, device=dev) < length
    k_eff = torch.cat([ck_row[None], k.to(ck_row.dtype)], dim=1)  # (1,T+S,..)
    v_eff = torch.cat([cv_row[None], v.to(cv_row.dtype)], dim=1)
    kvpos = torch.cat([pm_row, torch.where(validw, pos_i,
                                           torch.full_like(pos_i, -1))])
    qpos = pos_i[None, :, None]                                  # (1,S,1)
    ok = (kvpos[None, None, :] >= 0) & (kvpos[None, None, :] <= qpos)
    if window > 0:
        ok = ok & ((qpos - kvpos[None, None, :]) < window)
    out = masked_attention(q, k_eff, v_eff, ok)
    j = torch.arange(t, device=dev, dtype=torch.int64)
    last = start + length - 1
    src_abs = j + t * torch.div(last - j, t, rounding_mode="floor")
    okw = (src_abs >= start) & (src_abs <= last)
    src_rel = (src_abs - start).clamp(0, s - 1)
    keep = okw.reshape(t, 1, 1)
    ck_row.copy_(torch.where(keep, k[0][src_rel].to(ck_row.dtype), ck_row))
    cv_row.copy_(torch.where(keep, v[0][src_rel].to(cv_row.dtype), cv_row))
    pm_row.copy_(torch.where(okw, src_abs.to(pm_row.dtype), pm_row))
    return out


def _suffix_prefill_paged(q, k, v, cache, *, length, page_slot,
                          page_start):
    """Paged suffix prefill: one slot's new prompt tokens at absolute
    positions page_start.. are written into its installed pages (valid
    rows only) and attend over the page view, whose low pages hold a shared
    prefix that was never re-prefilled. Returns the attention output
    (1, S, Hq, D)."""
    b, s = q.shape[0], q.shape[1]
    if b != 1:
        raise ValueError("a paged suffix prefill takes one slot's tokens")
    kp, vp = cache["k_pages"], cache["v_pages"]
    n, ps = kp.shape[0], kp.shape[1]
    npg = cache["page_table"].shape[1]
    slot, start = int(page_slot), int(page_start)
    dev = q.device
    pt_row = cache["page_table"][slot]                          # (NP,)
    pos_i = start + torch.arange(s, device=dev)
    pp = pt_row[(pos_i // ps).clamp(0, npg - 1)].long()
    valid = (torch.arange(s, device=dev) < int(length)) & (pp >= 0)
    dest = (pp * ps + pos_i % ps)[valid]
    kp.view((n * ps,) + tuple(kp.shape[2:]))[dest] = k[0][valid].to(kp.dtype)
    vp.view((n * ps,) + tuple(vp.shape[2:]))[dest] = v[0][valid].to(vp.dtype)
    pm_row = paged_suffix_positions(npg * ps, start, length, device=dev)
    cache["pos_map"][slot] = pm_row
    k_view = paged_view(kp, pt_row[None], pm_row[None])          # (1,T,H,D)
    v_view = paged_view(vp, pt_row[None], pm_row[None])
    qpos = pos_i[None, :, None]                                  # (1,S,1)
    ok = (pm_row[None, None, :] >= 0) & (pm_row[None, None, :] <= qpos)
    return masked_attention(q, k_view, v_view, ok)


def apply_attention(p, x, cfg, *, positions=None, window=0, cache=None,
                    pos=None, packs=None, causal=True, kv_override=None,
                    prefill_len=None, page_slot=None, page_start=None,
                    seq=None):
    """x: (B,S,d) -> (out, cache). No cache: the train/encoder path (BERT
    calls it with ``causal=False``). With a cache and S > 1, a prompt
    prefill: causal attention over the S tokens plus an in-place bulk write
    of positions 0..prefill_len-1 (tokens past it are bucket padding and
    leave no trace). With S == 1, one decode step at ragged ``pos``: the new
    K/V rows are written in place and attention runs through K2/K3 or the
    plain composition (``resolved_decode_kernel``).

    A paged cache (``k_pages``/``v_pages``/``page_table``) decodes straight
    off its pools and, with ``page_slot``/``page_start`` and S > 1, runs
    the shared-prefix suffix prefill. Whole-cache prefill on a paged layout
    is not defined: the engine prefills a dense batch-1 sub-cache and
    page-writes it (``lm.write_slot_paged``). A dense cache with
    ``page_slot``/``page_start`` and S > 1 is the same contract on slot
    storage, the chunk prefill of the SLO scheduler
    (``_suffix_prefill_dense``; not for int8 caches).

    When the sparse export fused the q/k/v projections (``packs['wqkv']``),
    one block-sparse matmul produces all three and the output is split at
    the (Hq*D, Hkv*D, Hkv*D) boundaries.

    On a mesh whose cache shards the KV heads (``packs['heads']``, a
    ``common.HeadShard``), the projections come out whole on every rank,
    attention (and every cache write) runs over this rank's KV heads and
    their query heads, and the output is gathered before ``wo``; the
    mesh Trainer's forward runs the same code with grad on.

    ``kv_override`` (k, v) (B, T, Hkv, D) is cross-attention over encoder
    K/V: only q is projected (and normalized), nothing is rotated; without
    a cache it attends every position (``causal=False``), with a cache
    (the audio decoder passes ``{}``) and S == 1 it is the plain decode
    composition over all T positions and writes nothing.

    ``seq`` (a ``common.SeqShard``; no cache): ``x`` is this rank's block
    of S of a sequence-parallel row. Q, K and V are projected, normed,
    rotated and head-cut for the block, K and V are all-gathered along S
    over the dp axes, and the block's queries attend the whole row at
    their offset, through the path one device takes for the row's length
    (a window's band crosses the blocks' edges)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    fused = packs.get("wqkv") if packs else None
    if fused is not None:
        if kv_override is not None:
            raise ValueError("a fused QKV pack is self-attention only")
        qkv = linear(p["wqkv"], x, fused)
        dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q = _split_heads(qkv[..., :dq], cfg.n_heads, hd)
        k = _split_heads(qkv[..., dq:dq + dkv], cfg.n_kv_heads, hd)
        v = _split_heads(qkv[..., dq + dkv:], cfg.n_kv_heads, hd)
    else:
        x = tp_copy(x, *(packs.get(n) for n in ("wq", "wk", "wv"))) \
            if packs else x
        q = _split_heads(linear(p["wq"], x, packs and packs.get("wq")),
                         cfg.n_heads, hd)
        if kv_override is None:
            k = _split_heads(linear(p["wk"], x, packs and packs.get("wk")),
                             cfg.n_kv_heads, hd)
            v = _split_heads(linear(p["wv"], x, packs and packs.get("wv")),
                             cfg.n_kv_heads, hd)
        else:
            k, v = kv_override
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["scale"])
        if kv_override is None:
            k = rms_norm(k, p["k_norm"]["scale"])
    if cfg.rotary_fraction > 0 and positions is not None \
            and kv_override is None:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       rotary_fraction=cfg.rotary_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       rotary_fraction=cfg.rotary_fraction)
    heads = packs.get("heads") if packs else None
    if heads is not None:
        # a mesh: this rank's KV heads only, cut after the per-head norms
        # and RoPE (both act head by head), so a replicated norm scale
        # sees every head's gradient
        q, k, v = heads.local(q, k, v)
    s_all, q_offset = s, 0
    if seq is not None:
        if cache is not None or kv_override is not None:
            raise ValueError("a sequence-parallel block is the train / "
                             "prefill path: no cache, no cross-attention")
        k, v = seq.gather(k), seq.gather(v)
        s_all, q_offset = seq.length, seq.offset

    paged = cache is not None and "k_pages" in cache
    if kv_override is not None and cache is not None:
        if s != 1:
            raise ValueError("cross-attention with a cache is a decode step")
        # every encoder position is visible; the plain composition, not K2
        t = k.shape[1]
        out = decode_attention(q, k, v, torch.arange(t, device=x.device),
                               t - 1)
    elif cache is not None and s > 1 and page_slot is not None:
        length = s if prefill_len is None else int(prefill_len)
        if paged:
            out = _suffix_prefill_paged(
                q, k, v, cache, page_slot=page_slot, page_start=page_start,
                length=length)
        else:
            out = _suffix_prefill_dense(q, k, v, cache, window=window,
                                        length=length, slot=int(page_slot),
                                        start=int(page_start))
    elif paged and s > 1:
        raise NotImplementedError(
            "whole-cache prompt prefill is undefined for a paged KV layout; "
            "prefill a dense batch-1 sub-cache and insert it with "
            "write_slot_paged, or pass page_slot/page_start for a "
            "shared-prefix suffix prefill")
    elif cache is None or s > 1:
        # the path is the one device's for the whole row (s_all)
        if not causal and s_all <= 2048:
            out = full_attention(q, k, v, causal=False, q_offset=q_offset)
        elif not causal:
            out = flash_attention(q, k, v, causal=False, q_offset=q_offset,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        elif window > 0 and s_all > window:
            out = local_attention(q, k, v, window=window, q_offset=q_offset)
        elif s_all <= 1024:
            out = full_attention(q, k, v, causal=True, window=window,
                                 q_offset=q_offset)
        else:
            out = flash_attention(q, k, v, causal=True, window=window,
                                  q_offset=q_offset, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk,
                                  softcap=cfg.attn_logit_softcap)
        if cache is not None:       # prompt prefill: bulk-write the KV
            _write_prefill_kv(cache, k, v,
                              s if prefill_len is None else prefill_len)
    else:
        if pos is None:
            raise ValueError("a decode step (S == 1) needs pos")
        posv = as_slot_positions(pos, b, x.device)
        active = posv >= 0
        rows = torch.arange(b, device=x.device)
        kind = resolved_decode_kernel(q.device)
        pm = cache["pos_map"]
        if paged:
            kp, vp, pt = cache["k_pages"], cache["v_pages"], \
                cache["page_table"]
            paged_row_write(kp, pt, posv, k[:, 0], active)
            paged_row_write(vp, pt, posv, v[:, 0], active)
            slot = posv.long().clamp_min(0)
            _masked_row_write(pm, rows, slot, posv.clamp_min(0), active)
            if kind == "flash":
                # K3 reads the pages in place through the table
                out = paged_flash_decode(q, kp, vp, pt, pm, posv,
                                         window=window)
            else:
                out = decode_attention(q, paged_view(kp, pt, pm),
                                       paged_view(vp, pt, pm), pm, posv,
                                       window=window)
        else:
            ck, cv = cache["k"], cache["v"]
            t = ck.shape[1]
            slot = posv.long().clamp_min(0) % t              # ring slots
            _masked_row_write(pm, rows, slot, posv.clamp_min(0), active)
            if "k_scale" in cache:
                # int8 cache: quantize the new rows, then attend over the
                # dequantized cache with the plain composition (K2/K3 take
                # bf16 / fp32 caches only, as in the reference)
                (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
                _masked_row_write(ck, rows, slot, kq[:, 0], active)
                _masked_row_write(cv, rows, slot, vq[:, 0], active)
                _masked_row_write(cache["k_scale"], rows, slot, ks[:, 0],
                                  active)
                _masked_row_write(cache["v_scale"], rows, slot, vs[:, 0],
                                  active)
                out = decode_attention(
                    q, _dequantize_kv(ck, cache["k_scale"], q.dtype),
                    _dequantize_kv(cv, cache["v_scale"], q.dtype), pm, posv,
                    window=window)
            else:
                _masked_row_write(ck, rows, slot, k[:, 0], active)
                _masked_row_write(cv, rows, slot, v[:, 0], active)
                if kind == "flash":
                    out = flash_decode(q, ck, cv, pm, posv, window=window)
                else:
                    out = decode_attention(q, ck, cv, pm, posv,
                                           window=window)
    if heads is not None:
        out = heads.gather(out)
    out = linear(p["wo"], _merge_heads(out), packs and packs.get("wo"))
    return out, cache
