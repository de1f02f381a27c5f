"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Counterpart of ``repro/models/rglru.py``. The Real-Gated Linear Recurrent
Unit:

    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in the Griffin recipe: two linear branches (a gelu gate), a
depthwise causal conv of width 4 on the recurrent branch. Train / prefill
runs the linear recurrence as the reference's ``jax.lax.associative_scan``
does -- the same odd/even recursion (:func:`associative_scan`), so the fp32
products and sums happen in the same order; decode carries h.

Caches are written **in place**: ``{'h': (B, W) fp32, 'conv': (B, 3, W)}``;
a decode step leaves inactive rows (pos < 0) bitwise untouched. On a mesh
a rank holds W/m of both (:func:`apply_rglru`).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import as_slot_positions
from repro_torch.models.common import (column_block, gelu, init_linear,
                                       linear_from_block, normal_init,
                                       prefill_conv_history, softplus,
                                       tp_copy)

_C = 8.0


def init_rglru(gen, cfg, device=None):
    d = cfg.d_model
    w = cfg.rnn_width or d
    dt = cfg.tdtype
    return {
        "in_x": init_linear(gen, d, w, dt, device=device),
        "in_gate": init_linear(gen, d, w, dt, device=device),
        "conv_w": normal_init(gen, (cfg.conv_width, w), 0.1, dt, device),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "w_a": init_linear(gen, w, w, dt, device=device),
        "w_i": init_linear(gen, w, w, dt, device=device),
        # Lambda so that a^c lies in (0.9, 0.999) at r = 0.5, griffin-style
        "lam": normal_init(gen, (w,), 0.5, torch.float32, device) + 4.0,
        "out": init_linear(gen, w, d, dt, device=device),
    }


def init_cache_rglru(cfg, batch, dtype=None, device=None):
    w = cfg.rnn_width or cfg.d_model
    dtype = dtype or cfg.tdtype
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def _conv(x, w, b):
    """Depthwise causal conv by shifts (fp32 sums, no activation)."""
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    width = w.shape[0]
    for i in range(width):
        sh = width - 1 - i
        xi = torch.nn.functional.pad(x, (0, 0, sh, 0))[:, :s]
        out = out + xi.float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _lru_gates(p, xr, width=None, packs=None):
    """(a, gated input) of the conv output ``xr``; on a mesh (``width``, a
    ``common.ChannelShard``) ``xr`` is this rank's width block, the gates'
    whole input is gathered and each gate is the block of its rows."""
    packs = packs or {}
    lo, hi = (0, xr.shape[-1]) if width is None else width.range
    mesh = None if width is None else width.mesh
    xw = xr if width is None else width.gather(xr)
    xw = tp_copy(xw, packs.get("w_a"), packs.get("w_i"))
    r = torch.sigmoid(column_block(p["w_a"], xw, packs.get("w_a"), lo,
                                   hi, mesh).float())
    i = torch.sigmoid(column_block(p["w_i"], xw, packs.get("w_i"), lo,
                                   hi, mesh).float())
    lam = p["lam"] if width is None else width.block(p["lam"])
    log_a = -_C * softplus(lam)[None] * r              # over (b, s, w)
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * \
        (i * xr.float())
    return a, gated_in


def _combine(a1, u1, a2, u2):
    return a1 * a2, u1 * a2 + u2


def _interleave(even, odd):
    """(B, ceil(n/2), ...) and (B, floor(n/2), ...) -> (B, n, ...) with the
    even positions from ``even``."""
    ne, no = even.shape[1], odd.shape[1]
    out = even.new_empty((even.shape[0], ne + no) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, u):
    """Inclusive scan of h_t = a_t h_{t-1} + u_t along axis 1: returns
    (prod a_1..t, h_t with h_0 = 0). The recursion of
    ``jax.lax.associative_scan`` (pairwise reduce the odd positions, scan
    them, fill the even ones), so every element is combined in the
    reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, u
    ra, ru = _combine(a[:, 0:-1:2], u[:, 0:-1:2], a[:, 1::2], u[:, 1::2])
    oa, ou = associative_scan(ra, ru)
    if n % 2 == 0:
        ea, eu = _combine(oa[:, :-1], ou[:, :-1], a[:, 2::2], u[:, 2::2])
    else:
        ea, eu = _combine(oa, ou, a[:, 2::2], u[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eu = torch.cat([u[:, :1], eu], dim=1)
    return _interleave(ea, oa), _interleave(eu, ou)


def apply_rglru(p, x, cfg, *, cache=None, pos=None, packs=None,
                prefill_len=None, page_slot=None, **_):
    """x: (B,S,d) -> (out, cache), in the modes of ``ssm.apply_ssm``: the
    whole-sequence forward, a one-pass prompt prefill (padding steps are
    identities: a = 1, u = 0), a chunk continued from one slot's h and conv
    history (``page_slot``), and the O(1) decode step.

    On a mesh (``packs['width']``, a ``common.ChannelShard`` over W) a
    rank holds its width block of ``h`` and of the conv history: ``in_x``
    and ``in_gate`` give that block of their outputs (their column shards'
    own rows, no collective), the conv runs on it and its output is
    gathered (``w_a`` / ``w_i`` take the whole of it), the gates are their
    rows' block, the scan and the decode update run over the block, and
    the gated block feeds ``out``'s row-parallel shard. Every cut and
    gather there is differentiable (the mesh Trainer's forward): a
    replicated per-channel leaf (``conv_w``, ``conv_b``, ``lam``) is cut
    by ``scatter_to``, so its gradient is whole on every model rank."""
    b, s, _ = x.shape
    packs = packs or {}
    width = packs.get("width")
    lo, hi = (0, cfg.rnn_width or cfg.d_model) if width is None \
        else width.range

    def block(t):
        return t if width is None else width.block(t)
    mesh = None if width is None else width.mesh
    x = tp_copy(x, packs.get("in_gate"), packs.get("in_x"))
    gate = gelu(column_block(p["in_gate"], x, packs.get("in_gate"), lo,
                             hi, mesh).float())
    xr = column_block(p["in_x"], x, packs.get("in_x"), lo, hi, mesh)
    conv_w, conv_b = block(p["conv_w"]), block(p["conv_b"])

    prefill = cache is not None and s > 1
    chunked = prefill and page_slot is not None
    if cache is None or prefill:
        w1 = cfg.conv_width - 1
        xr_raw = xr
        if chunked:
            if b != 1:
                raise ValueError("a chunk prefill takes one slot's tokens")
            hist_row = cache["conv"][page_slot].to(xr.dtype)      # (W-1,w)
            hist_stream = torch.cat([hist_row[None], xr], dim=1)
            xr = _conv(hist_stream, conv_w, conv_b)[:, w1:]
        else:
            xr = _conv(xr, conv_w, conv_b)
        a, u = _lru_gates(p, xr, width, packs)
        if prefill:
            # padding steps (>= prefill_len) are identities: a = 1, u = 0,
            # so the scan's value at length-1 persists to the last step
            length = s if prefill_len is None else int(prefill_len)
            valid = (torch.arange(s, device=x.device) < length)[None, :,
                                                                  None]
            a = torch.where(valid, a, torch.ones((), device=x.device))
            u = torch.where(valid, u, torch.zeros((), device=x.device))
        aa, hh = associative_scan(a, u)
        h = hh
        if chunked:
            # inject the carried state: h_t = (prod a_1..t) h_prev + hh_t
            h = aa * cache["h"][page_slot][None, None] + hh
            validp = torch.cat(
                [torch.ones((1, w1, 1), dtype=torch.bool, device=x.device),
                 valid.expand(1, s, 1)], dim=1)
            hist_in = torch.cat([hist_row[None], xr_raw], dim=1)
            new_hist = prefill_conv_history(hist_in, validp, w1 + length, w1,
                                            cache["conv"].dtype)
            cache["h"][page_slot].copy_(h[0, -1])
            cache["conv"][page_slot].copy_(new_hist[0])
        elif prefill:
            cache["h"].copy_(hh[:, -1])      # padding holds h at length-1
            cache["conv"].copy_(prefill_conv_history(
                xr_raw, valid, length, w1, cache["conv"].dtype))
    else:
        # inactive slots (pos < 0) keep h and the conv history bitwise
        if pos is not None:
            active = as_slot_positions(pos, b, x.device) >= 0
        else:
            active = torch.ones((b,), dtype=torch.bool, device=x.device)
        hist = torch.cat([cache["conv"].to(xr.dtype), xr], dim=1)
        xr = _conv(hist, conv_w, conv_b)[:, -1:]
        a, u = _lru_gates(p, xr, width, packs)
        old = cache["h"]
        h = torch.where(active[:, None], a[:, 0] * old + u[:, 0], old)
        conv = torch.where(active[:, None, None],
                           hist[:, 1:].to(cache["conv"].dtype),
                           cache["conv"])
        old.copy_(h)
        cache["conv"].copy_(conv)
        h = h[:, None]

    y = (h * gate).to(x.dtype)
    return linear_from_block(p["out"], y, packs.get("out"), width), cache
