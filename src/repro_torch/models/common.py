"""Shared layer primitives: norms, activations, RoPE, linear init/apply,
gated MLPs and the paged-KV primitives.

Counterpart of ``repro/models/common.py`` (without the tensor-parallel
hook).
Parameters are plain dicts of tensors, laid out as in the reference: a
linear weight is stored (d_out, d_in) and applied as ``y = x @ w.T`` (the
BSR layout).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, scale=0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen``, cast to ``dtype``."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (scale * w).to(dtype)


# -- norms -------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-6):
    """LayerNorm in fp32 with the reference's eps (1e-6, not torch's
    1e-5), cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(d, kind="rms", dtype=torch.float32, device=None):
    if kind == "rms":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p, x, kind="rms"):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# -- activations --------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name):
    return {"gelu": gelu, "silu": F.silu, "relu": F.relu}[name]


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), NaN passed through. (``F.softplus`` returns x itself
    above its threshold and rounds otherwise.)"""
    out = x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim, rotary_fraction=1.0, theta=10000.0, device=None):
    """Inverse frequencies of the rotated dims and their count (even)."""
    rot = int(head_dim * rotary_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (theta ** exps)
    return inv, rot


def apply_rope(x, positions, *, theta=10000.0, rotary_fraction=1.0):
    """x: (..., S, H, D); positions: (..., S) int. Pairs (x_i, x_{i+rot/2})
    rotated in fp32; trailing (1-fraction) dims pass through (chatglm-style
    partial rotary)."""
    d = x.shape[-1]
    inv, rot = rope_freqs(d, rotary_fraction, theta, device=x.device)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv               # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x_pass.float()], dim=-1).to(x.dtype)


# -- linear (dense or block-sparse) -------------------------------------------

def init_linear(gen, d_in, d_out, dtype=torch.float32, scale=0.02,
                device=None):
    """Weight stored (d_out, d_in): y = x @ w.T -- matches the BSR layout."""
    return {"w": normal_init(gen, (d_out, d_in), scale, dtype, device)}


def linear(p, x, pack=None, backend=None):
    """Dense or block-sparse projection.

    ``pack`` is static pattern metadata from ``serving.export``:
      * a ``RowPackPlan`` -- ``p['w']`` holds row-grouped values
        (V, P, bn, bk) served by the plain plan composition ('plan');
      * a ``PlanChoice`` -- the same layout pinned to a backend through
        ``ops.plan_dispatch`` ('plan_pallas' = kernel K1);
      * a ``QuantPlan`` -- ``p['w']`` holds int8/fp8 row-grouped values and
        ``p['scale']`` their fp32 scales; ``ops.plan_q_dispatch`` runs the
        dequant-fused product ('plan_pallas' = kernel K6);
      * a ``KernelBSR`` -- ``p['w']`` holds packed tile values
        (nnzt, bn, bk) and the product goes through ``ops.bsr_matmul``'s
        backends (``backend``; by default kernel K4 on a CUDA tensor);
      * an ``autotune.BackendChoice`` -- a KernelBSR pattern pinned to the
        backend the autotuner measured fastest for it;
      * an ``autotune.MaskedPack`` -- ``p['w']`` stays a DENSE (N, K) weight
        and kernel K7 (``masked_matmul``) skips the masked tiles;
      * None -- a dense weight, ``x @ w.T``.
    Every fp plan and pack route is differentiable; the quantized plain
    route in ``x`` only, K6 and K7 are forward-only.
    """
    if pack is not None:
        from repro_torch.kernels.autotune import BackendChoice, MaskedPack
        from repro_torch.kernels.bsr_matmul import KernelBSR
        from repro_torch.kernels.exec_plan import (PlanChoice, QuantPlan,
                                                   RowPackPlan, plan_matmul)
        if isinstance(pack, QuantPlan):
            from repro_torch.kernels.ops import plan_q_dispatch
            return plan_q_dispatch(x, p["w"], p["scale"], pack.plan,
                                   backend=pack.backend)
        if isinstance(pack, PlanChoice):
            from repro_torch.kernels.ops import plan_dispatch
            return plan_dispatch(x, p["w"], pack.plan, backend=pack.backend)
        if isinstance(pack, RowPackPlan):
            return plan_matmul(x, p["w"], pack)
        if isinstance(pack, MaskedPack):
            from repro_torch.kernels.bsr_matmul import masked_matmul
            lead = tuple(x.shape[:-1])
            y = masked_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                              p["w"], pack.mask_on(x.device), tile=pack.tile)
            return y.reshape(lead + (pack.shape[0],))
        if isinstance(pack, BackendChoice):
            backend, pack = pack.backend, pack.pack
        if isinstance(pack, KernelBSR):
            import dataclasses as _dc
            from repro_torch.kernels.ops import bsr_matmul
            return bsr_matmul(x, _dc.replace(pack, data=p["w"]), backend)
        raise TypeError(f"unknown pack kind {type(pack).__name__}")
    return torch.matmul(x, p["w"].t())


def prefill_conv_history(x, valid, length, width, dtype):
    """Conv-cache state after a one-pass prompt prefill: the last ``width``
    pre-conv inputs of the real prompt. ``x``: (B, S, C) bucket-padded
    inputs, ``valid``: (1, S, 1) real-token mask, ``length`` the prompt
    length. Masking then left-padding ``width`` zeros makes prompts shorter
    than the conv window zero-fill exactly like a fresh decode cache.
    Shared by the SSM and RG-LRU prefill paths."""
    b = x.shape[0]
    zeros = torch.zeros((b, width) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
    masked = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    padded = torch.cat([zeros, masked], dim=1)
    # the reference's dynamic slice clamps its start into range
    start = min(max(int(length), 0), padded.shape[1] - width)
    return padded[:, start:start + width].to(dtype)


def init_mlp(gen, d_model, d_ff, act="gelu", dtype=torch.float32,
             device=None):
    """``wi``/``wg``/``wo`` for the gated MLPs (swiglu, geglu), ``wi``/``wo``
    otherwise; drawn in the reference's key order (wi, wg, wo)."""
    p = {"wi": init_linear(gen, d_model, d_ff, dtype, device=device)}
    if act in ("swiglu", "geglu"):
        p["wg"] = init_linear(gen, d_model, d_ff, dtype, device=device)
    p["wo"] = init_linear(gen, d_ff, d_model, dtype, device=device)
    return p


def apply_mlp(p, x, act="gelu", packs=None):
    """Gated: ``wo(g(wg x) * wi x)`` with g = silu (swiglu) or tanh-gelu
    (geglu); otherwise ``wo(act(wi x))``."""
    packs = packs or {}
    if act in ("swiglu", "geglu"):
        g = F.silu if act == "swiglu" else gelu
        h = g(linear(p["wg"], x, packs.get("wg"))) * \
            linear(p["wi"], x, packs.get("wi"))
    else:
        h = act_fn(act)(linear(p["wi"], x, packs.get("wi")))
    return linear(p["wo"], h, packs.get("wo"))


# -- paged KV primitives ------------------------------------------------------
#
# A paged cache replaces per-slot contiguous KV storage (B, T, ...) with a
# pool of fixed-size pages (n_pages, page_size, ...) plus a per-slot page
# table (B, T // page_size) of physical page ids (-1 = unmapped). The
# serving engine owns allocation (serving/paging.py); the model layer only
# needs the three device ops below. The reference's scatters send invalid
# rows out of bounds, where JAX drops them; a CUDA scatter out of bounds is
# a device fault, so here invalid rows are never written: the writes below
# select the valid rows explicitly, in place.


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static paging geometry threaded into ``init_cache``: a pool of
    ``n_pages`` pages of ``page_size`` positions each, addressed through
    per-slot page tables covering ``cache_len // page_size`` entries."""

    page_size: int
    n_pages: int

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 1:
            raise ValueError(f"bad paged layout: page_size={self.page_size} "
                             f"n_pages={self.n_pages}")

    def table_width(self, cache_len: int) -> int:
        if cache_len % self.page_size:
            raise ValueError(
                f"cache_len={cache_len} not divisible by "
                f"page_size={self.page_size}")
        return cache_len // self.page_size


def paged_view(pages, page_table, pos_map):
    """Gather a slot-contiguous (B, T, ...) view out of a page pool.

    ``pages``: (N, ps, ...); ``page_table``: (B, NP) int page ids (-1 =
    unmapped); ``pos_map``: (B, T = NP*ps) absolute positions (-1 = empty).
    Unmapped/unwritten positions read as exact zeros -- the view is then
    elementwise identical to the dense slot cache the same writes would
    have produced."""
    b, npg = page_table.shape
    n, ps = pages.shape[0], pages.shape[1]
    safe = page_table.long().clamp(0, n - 1)        # gather: clip, mask below
    view = pages[safe].reshape((b, npg * ps) + tuple(pages.shape[2:]))
    keep = (pos_map >= 0).reshape((b, npg * ps) + (1,) * (pages.dim() - 2))
    return torch.where(keep, view, torch.zeros((), dtype=view.dtype,
                                               device=view.device))


def paged_row_write(pages, page_table, positions, val, active):
    """Write one new position per batch row into the pool, in place: row
    ``i``'s value lands in page ``page_table[i, positions[i] // ps]`` at
    offset ``positions[i] % ps``. Inactive or unmapped rows write nothing.

    Without a host sync (this runs inside fused decode windows): every
    invalid row is given the destination and value of the first valid row,
    so all writers of a location store the same value; when no row is
    valid, every row stores page 0 row 0's own content back."""
    n, ps = pages.shape[0], pages.shape[1]
    npg = page_table.shape[1]
    flat = pages.view((n * ps,) + tuple(pages.shape[2:]))
    posv = positions.long().clamp_min(0)
    rows = torch.arange(page_table.shape[0], device=pages.device)
    pp = page_table[rows, (posv // ps).clamp(0, npg - 1)].long()
    valid = active & (pp >= 0)
    dest = pp.clamp_min(0) * ps + posv % ps
    # first valid row (or row 0), kept 1-D: a 0-d index is read on the host
    donor = torch.argmax(valid.int()).reshape(1)
    any_valid = valid.any()
    dest = torch.where(valid, dest, dest[donor])
    dest = torch.where(any_valid, dest, torch.zeros_like(dest))
    keep = valid.reshape((-1,) + (1,) * (val.dim() - 1))
    val = torch.where(keep, val.to(pages.dtype), val[donor].to(pages.dtype))
    val = torch.where(any_valid, val, flat[0].expand_as(val))
    flat[dest] = val
    return pages


def paged_bulk_write(pages, page_row, vals):
    """Write a slot-contiguous tensor into the pool pages of ONE slot, in
    place: ``vals`` (NP*ps, ...) reshaped to (NP, ps, ...) lands page-wise
    at the ids in ``page_row`` (NP,); entries < 0 (unallocated table slots)
    are skipped. Every allocated page is fully (re)written, so recycled
    pages cannot leak stale state. (An admission-time op: selecting the
    valid pages syncs with the host.)"""
    ps = pages.shape[1]
    npg = page_row.shape[0]
    chunks = vals.reshape((npg, ps) + tuple(pages.shape[2:]))
    row = page_row.to(pages.device).long()
    valid = row >= 0
    pages[row[valid]] = chunks[valid].to(pages.dtype)
    return pages
