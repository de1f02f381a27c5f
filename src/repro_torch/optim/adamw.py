"""AdamW + schedules + global-norm clipping + group-lasso proximal step.

Counterpart of ``repro/optim/adamw.py``. The optimizer state is a plain tree
``{m, v, step}`` parallel to the params, checkpointed like them; the update
is functional (new tensors, as the reference returns new arrays). The
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
from repro_torch.core.sparsity import SparsityConfig
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


def global_norm(tree) -> torch.Tensor:
    sq = [leaf.float().square().sum() for leaf in leaves(tree)]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 sparsity: Optional[SparsityConfig] = None):
    """One AdamW step (+ the group-lasso prox on targeted 2-D / 3-D weights
    when ``sparsity.lambda_reg > 0``). Returns (new_params, new_state,
    metrics) with metrics ``grad_norm`` and ``lr`` as 0-d tensors."""
    step = state["step"]
    gnorm = global_norm(grads)
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

    g_leaves = leaves(grads)
    m_leaves, v_leaves = leaves(state["m"]), leaves(state["v"])
    new_p, new_m, new_v = [], [], []
    for i, (path, p) in enumerate(flatten_with_path(params)):
        g = g_leaves[i].float() * scale
        mm = (b1 * m_leaves[i].float() + (1 - b1) * g).to(cfg.tdtype)
        vv = (b2 * v_leaves[i].float() + (1 - b2) * g * g).to(cfg.tdtype)
        mhat = mm.float() / c1
        vhat = vv.float() / c2
        p32 = p.float()
        newp = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * p32)
        if (prox and sparsity.applies_to(path_name(path))
                and newp.ndim in (2, 3)):
            bh, bw = sparsity.block_shape
            if newp.shape[-2] % bh == 0 and newp.shape[-1] % bw == 0:
                if newp.ndim == 3:     # layer-stacked
                    newp = torch.stack([group_prox(layer, (bh, bw), thresh)
                                        for layer in newp])
                else:
                    newp = group_prox(newp, (bh, bw), thresh)
        new_p.append(newp.to(p.dtype))
        new_m.append(mm)
        new_v.append(vv)
    new_state = {"m": unflatten(state["m"], new_m),
                 "v": unflatten(state["v"], new_v), "step": step + 1}
    return (unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
