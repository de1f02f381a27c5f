"""Mamba-2 SSD (state-space duality) mixer, chunked, attention-free.

Counterpart of ``repro/models/ssm.py``. Train / prefill: the chunked SSD
algorithm -- an intra-chunk quadratic term plus an inter-chunk state
recurrence, O(S * chunk * (P + N)) instead of O(S^2); the reference's
inter-chunk ``lax.scan`` is an ordered loop over the chunks here. Decode:
the O(1) recurrent state update.

Layout: heads H of head dim P, state size N, one B/C group broadcast to
every head, a scalar decay A per head, a depthwise causal conv (width 4) on
the x/B/C stream, a z-gated output with a D skip -- the mamba2 block.

Caches are written **in place** (the reference returns updated copies):
``{'state': (B, H, P, N) fp32, 'conv': (B, W-1, C)}``. A decode step leaves
the rows of inactive slots (pos < 0) bitwise untouched. On a mesh a rank
holds H/m heads of ``state`` and C/m channels of ``conv``
(:func:`apply_ssm`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import as_slot_positions
from repro_torch.models.common import (init_linear, linear,
                                       linear_from_block, normal_init,
                                       prefill_conv_history, rms_norm,
                                       softplus)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(gen, cfg, device=None):
    d = cfg.d_model
    d_inner, h, _, n = _dims(cfg)
    conv_dim = d_inner + 2 * n                     # x stream + B + C
    dt = cfg.tdtype
    f32 = torch.float32
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": init_linear(gen, d, 2 * d_inner + 2 * n + h, dt,
                               device=device),
        "conv_w": normal_init(gen, (cfg.conv_width, conv_dim), 0.1, dt,
                              device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.zeros((h,), dtype=f32, device=device),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "norm": {"scale": torch.zeros((d_inner,), dtype=dt, device=device)},
        "out_proj": init_linear(gen, d_inner, d, dt, device=device),
    }


def init_cache_ssm(cfg, batch, dtype=None, device=None):
    d_inner, h, p_dim, n = _dims(cfg)
    dtype = dtype or cfg.tdtype
    return {"state": torch.zeros((batch, h, p_dim, n), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * n),
                                dtype=dtype, device=device)}


def _causal_conv(x, w, b):
    """Depthwise causal conv by shifts, fp32 sums, then silu. x: (B,S,C),
    w: (W,C)."""
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    width = w.shape[0]
    for i in range(width):
        sh = width - 1 - i
        xi = F.pad(x, (0, 0, sh, 0))[:, :s]
        out = out + xi.float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def _segsum(x):
    """(..., q) log-decays -> (..., q, q) lower-triangular segment sums
    cs[i] - cs[j] (-inf above the diagonal)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, torch.full((), float("-inf"),
                                            device=x.device))


def _split_proj(zxbcdt, cfg):
    d_inner, h, _, n = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)


def apply_ssm(p, xin, cfg, *, cache=None, pos=None, packs=None,
              prefill_len=None, page_slot=None, **_):
    """xin: (B,S,d) -> (out, cache). No cache: the whole-sequence forward.
    A cache with S > 1: a one-pass prompt prefill (padding steps past
    ``prefill_len`` are identities: dt = 0), rewriting the cache; with
    ``page_slot`` too, the next chunk of one slot's prompt, continued from
    that slot's state and conv history. S == 1: the O(1) decode step.

    On a mesh (``packs['conv']``, a ``common.ChannelShard``;
    ``packs['heads']``, a ``common.SSDHeadShard``): ``in_proj``'s output
    is whole on every rank (its fused rows cross the segments); the
    whole-sequence forward and a step that continues a history convolve
    the rank's channel block and gather the output (a one-pass prefill,
    whose history is zeros, convolves the whole stream where it is and
    keeps its block); the SSD runs over the rank's heads with B and C
    whole, the gated norm over the whole ``d_inner`` (the heads' blocks
    gathered: one device's norm), and the block feeds ``out_proj``'s
    row-parallel shard. Every cut and gather there is differentiable (the
    mesh Trainer's forward, ``launch.steps.MeshPlan``)."""
    b, s, _ = xin.shape
    d_inner, h, p_dim, n = _dims(cfg)
    packs = packs or {}
    chan, heads = packs.get("conv"), packs.get("heads")

    def block(x):
        return x if chan is None else chan.block(x)

    def gather(x):
        return x if chan is None else chan.gather(x)

    def hcut(x, dim=-1):
        return x if heads is None else heads.heads(x, dim)
    zxbcdt = linear(p["in_proj"], xin, packs.get("in_proj"))
    z, x, bmat, cmat, dt = _split_proj(zxbcdt, cfg)

    prefill = cache is not None and s > 1
    chunked = prefill and page_slot is not None
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    w1 = cfg.conv_width - 1
    if chunked:
        if b != 1:
            raise ValueError("a chunk prefill takes one slot's tokens")
        hist_row = cache["conv"][page_slot].to(conv_in.dtype)     # (W-1,C)
        hist_stream = torch.cat([hist_row[None], block(conv_in)], dim=1)
        conv_out = gather(_causal_conv(hist_stream, block(p["conv_w"]),
                                       block(p["conv_b"]))[:, w1:])
    elif cache is None and chan is not None:
        conv_out = gather(_causal_conv(block(conv_in), block(p["conv_w"]),
                                       block(p["conv_b"])))
    elif cache is None or prefill:
        conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    else:
        hist = torch.cat([cache["conv"].to(conv_in.dtype), block(conv_in)],
                         dim=1)
        conv_out = gather(_causal_conv(hist, block(p["conv_w"]),
                                       block(p["conv_b"]))[:, -1:])
        new_conv = hist[:, 1:]
    x, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    xh = hcut(x.reshape(b, -1, h, p_dim), 2).float()
    h_loc = xh.shape[2]
    dt = softplus(hcut(dt).float() + hcut(p["dt_bias"])[None, None, :])
    a_neg = -torch.exp(hcut(p["A_log"]))                          # (h,)
    if prefill:
        # padding tokens (>= prefill_len) are identity steps: dt = 0 zeroes
        # their decay (exp(0) = 1) and their state contribution
        length = s if prefill_len is None else int(prefill_len)
        valid = (torch.arange(s, device=xin.device) < length)[None, :, None]
        dt = torch.where(valid, dt, torch.zeros((), device=xin.device))
    da = dt * a_neg[None, None, :]                                # (b,s,h)
    bmat = bmat.float()
    cmat = cmat.float()
    if heads is not None:
        bmat, cmat = heads.shared(bmat), heads.shared(cmat)

    if cache is None or prefill:
        init_state = cache["state"][page_slot][None] if chunked else None
        y, state = _ssd_chunked(xh, dt, da, bmat, cmat, cfg.ssm_chunk,
                                initial_state=init_state)
        if chunked:
            validp = torch.cat(
                [torch.ones((1, w1, 1), dtype=torch.bool, device=xin.device),
                 valid.expand(1, s, 1)], dim=1)
            new_hist = prefill_conv_history(hist_stream, validp, w1 + length,
                                            w1, cache["conv"].dtype)
            cache["state"][page_slot].copy_(state[0])
            cache["conv"][page_slot].copy_(new_hist[0])
        elif prefill:
            cache["state"].copy_(state)
            cache["conv"].copy_(prefill_conv_history(
                block(conv_in), valid, length, w1, cache["conv"].dtype))
    else:
        # the O(1) step; inactive slots (pos < 0) keep their recurrent and
        # conv state bitwise
        if pos is not None:
            active = as_slot_positions(pos, b, xin.device) >= 0
        else:
            active = torch.ones((b,), dtype=torch.bool, device=xin.device)
        old = cache["state"]                                      # (b,h,p,n)
        decay = torch.exp(da[:, 0, :])[..., None, None]           # (b,h,1,1)
        upd = (dt[:, 0, :, None, None] * xh[:, 0, :, :, None]
               * bmat[:, 0, None, None, :])
        state = torch.where(active[:, None, None, None], old * decay + upd,
                            old)
        conv = torch.where(active[:, None, None],
                           new_conv.to(cache["conv"].dtype), cache["conv"])
        old.copy_(state)
        cache["conv"].copy_(conv)
        y = torch.einsum("bhpn,bn->bhp", state, cmat[:, 0])
        y = y.reshape(b, 1, h_loc, p_dim)

    y = y + xh * hcut(p["D"])[None, None, :, None]
    y = y.reshape(b, -1, h_loc * p_dim).to(cfg.tdtype)
    if heads is None:
        y = rms_norm(y, p["norm"]["scale"])
    else:
        y = heads.rms_norm(y, p["norm"]["scale"])
        z = hcut(z.reshape(b, -1, h, p_dim), 2).reshape(b, -1, h_loc * p_dim)
    y = y * F.silu(z.float()).to(y.dtype)
    out = linear_from_block(p["out_proj"], y, packs.get("out_proj"), heads)
    return out, cache


def _ssd_chunked(x, dt, da, bmat, cmat, chunk, initial_state=None):
    """Chunked SSD. x: (b,s,h,p) fp32, dt / da: (b,s,h), B / C: (b,s,n).
    Returns (y (b,s,h,p), the final recurrent state (b,h,p,n)) -- the carry
    a one-pass prompt prefill hands to the decode path. ``initial_state``
    (b,h,p,n) seeds the inter-chunk recurrence: a chunk prefill passes the
    slot's current state, so a prompt split across windows matches the
    one-pass result."""
    b, s, h, p_dim = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = x.reshape(b, nc, q, h, p_dim)
    dtc = dt.reshape(b, nc, q, h)
    dac = da.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)

    da_cum = torch.cumsum(dac, dim=2)                             # (b,nc,q,h)
    # intra-chunk (diagonal) term
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))       # (b,nc,h,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)              # (b,nc,q,k)
    xdt = xc * dtc[..., None]                                # (b,nc,q,h,p)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * lmat,
                          xdt)

    # per-chunk final states
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)       # (b,nc,q,h)
    states = torch.einsum("bckn,bckhp->bchpn", bc,
                          xdt * decay_to_end[..., None])

    # inter-chunk recurrence, chunk by chunk in order
    chunk_decay = torch.exp(da_cum[:, :, -1, :])                  # (b,nc,h)
    carry = (torch.zeros((b, h, p_dim, n), dtype=torch.float32,
                         device=x.device) if initial_state is None
             else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    # off-diagonal (cross-chunk) contribution
    decay_from_start = torch.exp(da_cum)                          # (b,nc,q,h)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) * \
        decay_from_start[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p_dim)
    return y[:, :s], carry
