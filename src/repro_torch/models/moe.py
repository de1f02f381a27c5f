"""Mixture-of-Experts FFN with capacity-based sort dispatch.

Counterpart of ``repro/models/moe.py``. The router is fp32; each token takes
its top-k experts (ties to the lower expert index, as ``lax.top_k``), the
(token, expert) assignments are stably sorted by expert, positioned within
their expert's segment and scattered into an (E, capacity, d) buffer.
Assignments past an expert's capacity are dropped, as the reference's
``mode="drop"`` scatter drops them. The expert products are plain batched
matmuls (the reference computes them outside any Pallas kernel).

Every shape is static and no device value is read on the host, so a fused
decode window runs it without a sync: the dispatch scatters into an
(E, capacity + 1, d) buffer whose last row takes the overflow and is cut
off. The combine sums each token's k weighted expert outputs in ascending
expert order with plain adds -- the order of the reference's scatter-add
over the expert-sorted assignments -- and no atomics, so it is bitwise
repeatable on the card.

On a mesh (``common.ExpertShard``) the router is replicated, so routing,
capacity and the dispatch buffer are the same on every rank; a rank runs
the expert products of its E/m experts and all-gathers the (E/m, cap, d)
outputs over "model" before the unchanged combine, so the output is what
one device computes from the same expert outputs. A decode step whose
rows shard over the dp axes ("data", and "pod" on a multi-pod mesh)
gathers them first, in global row order, and routes the whole batch.
The mesh Trainer's shard (``ExpertShard(train=True)``) does the same
through differentiable collectives, so a training step on a data mesh
routes, drops and takes its aux over the global batch, as one device;
there each dp rank runs the products for its block of the capacity
slots and the blocks are gathered over the dp axes before the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import dp_axes
from repro_torch.models.common import apply_mlp, gelu, init_mlp, normal_init


def init_moe(gen, cfg, device=None):
    """fp32 router (d, E); experts ``wi`` / ``wg`` (E, d, f) and ``wo``
    (E, f, d) in the model dtype; a ``shared`` gated MLP of width
    f * n_shared_experts when the config has shared experts."""
    d, f, e = cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts
    dt = cfg.tdtype
    p = {"router": normal_init(gen, (d, e), 0.02, torch.float32, device),
         "wi": normal_init(gen, (e, d, f), 0.02, dt, device),
         "wg": normal_init(gen, (e, d, f), 0.02, dt, device),
         "wo": normal_init(gen, (e, f, d), 0.02, dt, device)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared_experts, cfg.act, dt,
                               device)
    return p


def capacity(t: int, cfg) -> int:
    """Slots per expert for ``t`` tokens (padding and inactive decode slots
    included, as in the reference)."""
    return max(1, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def route(router, x2, cfg):
    """Router probabilities and the sort dispatch of (T, d) tokens:
    ``probs`` (T, E), ``gate`` / ``idx`` (T, k) (gates renormalized over
    the top k), ``sorted_e`` / ``order`` (the assignments t * k + j stably
    sorted by expert) and ``pos_in_seg`` (each sorted assignment's slot in
    its expert; >= capacity is dropped)."""
    t, k, e = x2.shape[0], cfg.top_k, cfg.n_experts
    probs = torch.softmax(torch.matmul(x2.float(), router), dim=-1)
    # a stable descending sort: ties keep the lower expert index first
    top, arg = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], arg[:, :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    sorted_e, order = torch.sort(idx.reshape(-1), stable=True)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x2.device, dtype=sorted_e.dtype))
    pos_in_seg = torch.arange(t * k, device=x2.device) - seg_start[sorted_e]
    return probs, gate, idx, sorted_e, order, pos_in_seg


def apply_moe(p, x, cfg, shard=None, shared_packs=None):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, fp32 aux loss). On a
    mesh ``shard`` is the layer's ``common.ExpertShard`` (``p``'s
    routed-expert tensors then hold this rank's experts only) and
    ``shared_packs`` the shared experts' (``{'wi': DenseShard, ...}``)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    rows = None
    if shard is not None and shard.gather_rows:
        # the rows shard over the dp axes: route the whole batch, so
        # capacity, drops and the aux are the batch's, as on one device
        c, n = shard.mesh.coord(dp_axes(shard.mesh)), x2.shape[0]
        rows = (c * n, (c + 1) * n)
        x2 = shard.rows(x2)
    t, k, e = x2.shape[0], cfg.top_k, cfg.n_experts
    cap = capacity(t, cfg)
    probs, gate, idx, sorted_e, order, pos_in_seg = route(p["router"], x2,
                                                          cfg)
    token_src = order // k
    slot = pos_in_seg.clamp_max(cap)            # cap = the overflow row

    xe = x2 if shard is None else shard.expert_input(x2)
    buf = torch.zeros((e, cap + 1, d), dtype=x2.dtype, device=x2.device)
    buf[sorted_e, slot] = xe[token_src]
    buf = buf[:, :cap]

    act = F.silu if cfg.act == "swiglu" else gelu
    w = {n: p[n] if shard is None else shard.weight(n, p[n])
         for n in ("wi", "wg", "wo")}
    if shard is not None:
        buf = shard.slots(shard.local(buf))  # this rank's experts and slots
    hdn = act(torch.bmm(buf, w["wg"])) * torch.bmm(buf, w["wi"])
    out = torch.bmm(hdn, w["wo"])                               # (E, cap, d)
    if shard is not None:
        out = shard.gather_slots(out, cap)
        if shard.sharded:
            out = shard.gather(out)

    # combine: a dropped assignment reads the zero overflow row
    out = F.pad(out, (0, 0, 0, 1))
    contrib = out[sorted_e, slot].float() * gate.reshape(-1)[order][:, None]
    # back to (token, j) order, then each token's k terms by ascending expert
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib
    by_expert = torch.argsort(idx, dim=-1)                       # (T, k)
    terms = torch.gather(unsorted.reshape(t, k, d), 1,
                         by_expert[:, :, None].expand(t, k, d))
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]

    if "shared" in p:
        y = y + apply_mlp(p["shared"], x2, cfg.act,
                          packs=shared_packs).float()

    # Switch-style aux loss: E * sum(frac_tokens_e * mean_prob_e)
    frac = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0)) * cfg.router_aux_coef
    if rows is not None:
        y = y[rows[0]:rows[1]]
    return y.reshape(b, s, d).to(x.dtype), aux
