"""AdamW + schedules + global-norm clipping + group-lasso proximal step.

Counterpart of ``repro/optim/adamw.py``. The optimizer state is a plain tree
``{m, v, step}`` parallel to the params, checkpointed like them; the update
is functional (new tensors, as the reference returns new arrays) unless
asked to donate: then it writes into the given tensors, as the reference
Trainer's ``donate_argnums`` lets XLA do. The
schedule and the bias corrections are computed in fp32 tensors on the
params' device, as the reference computes them in fp32 under ``jit``, so no
step reads a value back to the host. The proximal step (blockwise soft
threshold, ``core.regularizer.group_prox``) realizes the paper's Eq. 1
group-l1 term exactly; it applies to targeted 2-D and layer-stacked 3-D
weights, so packed 4-D values are skipped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.regularizer import group_prox
from repro_torch.core.sparsity import (SparsityConfig, block_partials,
                                       local_of_grid)
from repro_torch.core.tree import (flatten_with_path, leaves, map_with_path,
                                   path_name, unflatten)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"    # bf16 halves optimizer memory at scale

    @property
    def tdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.state_dtype == "bfloat16"
                else torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up then cosine decay, in fp32; ``step`` is an int or a
    0-d tensor (the result lies on its device)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = cfg.peak_lr * (s + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: AdamWConfig):
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=cfg.tdtype, device=p.device)
    dev = next((p.device for p in leaves(params)), None)
    return {"m": map_with_path(zeros, params),
            "v": map_with_path(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32. With ``shards``
    (path -> ``launch.sharding.LeafShard``; the mesh Trainer) a leaf held
    as a rank's shard adds its local squares summed over the axes that cut
    it, a replicated leaf counts once: every rank gets one device's norm
    (up to the order of the sums)."""
    if not shards:
        sq = [leaf.float().square().sum() for leaf in leaves(tree)]
        return torch.stack(sq).sum().sqrt()
    groups = {}
    for path, leaf in flatten_with_path(tree):
        sh = shards.get(path)
        groups.setdefault(sh.axes if sh is not None else (), (sh, []))[
            1].append(leaf.float().square().sum())
    total = []
    for axes, (sh, sq) in groups.items():
        part = torch.stack(sq).sum()
        total.append(sh.sum(part) if axes else part)
    return torch.stack(total).sum().sqrt()


#: leaves above this many elements are updated in chunks (of the flat leaf,
#: or along axis 0 under the prox), so the update's fp32 temporaries stay
#: near a chunk's size (a 2**24-element chunk: 64 MiB a temporary) --
#: gemma3_4b's 671 M-element embedding would otherwise take ~13 GB of them,
#: and four ranks sharing one card a period of stacked experts' ~6 GB each
CHUNK_ELEMS = 1 << 24


def _chunks(p, prox_rows: int, row0: int = 0) -> list:
    """The pieces of a leaf the update takes one at a time: the whole leaf
    up to CHUNK_ELEMS elements, else slices of axis 0 with as many rows as
    fit, a multiple of ``prox_rows`` (the prox's block height on a 2-D
    weight; 1 elsewhere) and at least one block row, so the prox sees whole
    blocks. A rank's shard whose axis 0 starts at whole-leaf row ``row0``
    is cut on the whole leaf's block-row boundaries (its first and last
    pieces may hold part of a block row)."""
    if p.numel() <= CHUNK_ELEMS:
        return [Ellipsis]
    rows = max(1, CHUNK_ELEMS // (p.numel() // p.shape[0]))
    rows = max(prox_rows, rows // prox_rows * prox_rows)
    cuts = list(range((-row0) % prox_rows or rows, p.shape[0], rows))
    edges = [0] + [c for c in cuts if c > 0] + [p.shape[0]]
    return [slice(lo, hi) for lo, hi in zip(edges, edges[1:]) if hi > lo]


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 sparsity: Optional[SparsityConfig] = None,
                 donate: bool = False, shards=None):
    """One AdamW step (+ the group-lasso prox on targeted 2-D / 3-D weights
    when ``sparsity.lambda_reg > 0``). Returns (new_params, new_state,
    metrics) with metrics ``grad_norm`` and ``lr`` as 0-d tensors.

    ``donate=True`` writes the new params, ``m``, ``v`` and ``step`` into
    the given tensors (the counterpart of the reference Trainer's
    ``donate_argnums``) and returns the same trees; the numbers are those of
    ``donate=False`` bit for bit. Either way a leaf above CHUNK_ELEMS
    elements is updated chunk by chunk: pieces of the flat leaf, or under
    the prox slices of axis 0 holding whole block rows (the update is
    elementwise, or blockwise for the prox, and the global norm is taken
    first, so the chunks change no number).

    ``shards`` (path -> ``LeafShard``; the mesh Trainer): the params,
    grads and moments are this rank's shards. The global norm sums over
    the ranks (:func:`global_norm`), and the prox of a cut leaf takes its
    block norms from partial sums over the whole leaf's block grid,
    reduced over the axes that cut it -- a block may straddle two shards
    -- in two passes over the chunks (norms, then the update)."""
    shards = shards or {}
    step = state["step"]
    gnorm = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=t.device), t)
    lr = lr_at(cfg, step)
    prox = (sparsity is not None and sparsity.lambda_reg > 0)
    thresh = lr * sparsity.lambda_reg if prox else None

    def moments(p, g, m, v):
        g = g.float() * scale
        mm = (b1 * m.float() + (1 - b1) * g).to(cfg.tdtype)
        vv = (b2 * v.float() + (1 - b2) * g * g).to(cfg.tdtype)
        mhat = mm.float() / c1
        vhat = vv.float() / c2
        p32 = p.float()
        newp = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * p32)
        return newp, mm, vv

    def update(p, g, m, v, blocks):
        newp, mm, vv = moments(p, g, m, v)
        if blocks is not None:
            if newp.ndim == 3:     # layer-stacked
                newp = torch.stack([group_prox(layer, blocks, thresh)
                                    for layer in newp])
            else:
                newp = group_prox(newp, blocks, thresh)
        return newp.to(p.dtype), mm, vv

    g_leaves = leaves(grads)
    m_leaves, v_leaves = leaves(state["m"]), leaves(state["v"])
    new_p, new_m, new_v = [], [], []
    for i, (path, p) in enumerate(flatten_with_path(params)):
        blocks = None
        sh = shards.get(path)
        whole = sh.shape if sh is not None else tuple(p.shape)
        if (prox and sparsity.applies_to(path_name(path))
                and p.ndim in (2, 3)):
            bh, bw = sparsity.block_shape
            if whole[-2] % bh == 0 and whole[-1] % bw == 0:
                blocks = (bh, bw)
        g, m, v = g_leaves[i], m_leaves[i], v_leaves[i]
        out = (p, m, v) if donate else (
            torch.empty_like(p),
            torch.empty(m.shape, dtype=cfg.tdtype, device=m.device),
            torch.empty(v.shape, dtype=cfg.tdtype, device=v.device))
        args = (p, g, m, v)
        if blocks is None and all(x.is_contiguous() for x in args + out):
            # elementwise: CHUNK_ELEMS pieces of the flat leaf
            args, out = ([x.view(-1) for x in a] for a in (args, out))
        chunks = _chunks(args[0], blocks[0] if blocks and p.ndim == 2
                         else 1, sh.offsets[0] if sh is not None else 0)
        if blocks is not None and sh is not None:
            _sharded_prox_update(out, args, chunks, moments, sh, blocks,
                                 thresh)
        else:
            for sl in chunks:
                for dst, x in zip(out, update(*(a[sl] for a in args),
                                              blocks)):
                    dst[sl].copy_(x)
        new_p.append(out[0].view(p.shape))
        new_m.append(out[1].view(m.shape))
        new_v.append(out[2].view(v.shape))
    if donate:
        step.add_(1)
        return params, state, {"grad_norm": gnorm, "lr": lr}
    new_state = {"m": unflatten(state["m"], new_m),
                 "v": unflatten(state["v"], new_v), "step": step + 1}
    return (unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "lr": lr})


def _sharded_prox_update(out, args, chunks, moments, shard, blocks, thresh):
    """The update of a rank's shard of a prox leaf: pass 1 sums each
    chunk's updated values into partial block sums over the whole leaf's
    grid, reduced over the axes that cut the leaf; pass 2 recomputes each
    chunk (one chunk: reuses it) and writes it scaled by the blockwise soft
    threshold read at its elements."""
    p = args[0]
    first = None

    def at(sl):
        """The offsets in the whole leaf of chunk ``sl``'s first element
        (chunks slice axis 0)."""
        off = list(shard.offsets)
        if sl is not Ellipsis:
            off[0] += sl.start
        return tuple(off)

    parts = []
    for sl in chunks:
        res = moments(*(a[sl] for a in args))
        if len(chunks) == 1:
            first = res
        parts.append(block_partials(res[0], blocks, 2, at(sl), shard.shape))
    norms = shard.sum(torch.stack(parts).sum(dim=0)).sqrt()
    scale = torch.clamp_min(1.0 - thresh / torch.clamp_min(norms, 1e-30),
                            0.0)
    for sl in chunks:
        newp, mm, vv = first if first is not None else moments(
            *(a[sl] for a in args))
        newp = newp * local_of_grid(scale, blocks, at(sl),
                                    tuple(newp.shape)).to(newp.dtype)
        for dst, x in zip(out, (newp.to(p.dtype), mm, vv)):
            dst[sl].copy_(x)
