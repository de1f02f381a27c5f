"""Step builders: the train step (CE + aux + reported group-l1, AdamW, prox)
and the serving steps (prefill, decode).

Counterpart of ``repro/launch/steps.py``. A train step is a
plain function of ``(params, opt_state, batch)`` returning new params, a new
optimizer state and metrics (0-d tensors on the params' device); gradients
come from ``torch.autograd.grad`` over the param leaves, the counterpart of
``jax.value_and_grad``. With ``packs`` the packed projections run through
the layouts ``serving.export`` produced -- with ``PlanChoice`` packs the
plan kernels: K1 forward, K4 for dX and K5 for the values' gradient.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regularizer import tree_group_penalty
from repro_torch.core.tree import leaves, unflatten
from repro_torch.models.api import decode_step as model_decode_step
from repro_torch.models.api import model_forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) fp32, labels (B, S) int; mean over all tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def make_loss_fn(cfg: ModelConfig, packs=None):
    def loss_fn(params, batch):
        logits, aux = model_forward(params, cfg, batch, packs=packs)
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + aux
        if cfg.sparsity is not None and cfg.sparsity.lambda_reg > 0:
            # proximal gradient: the group-lasso term is handled exactly by
            # the blockwise soft-threshold in adamw_update; the penalty is
            # reported in the loss but carries no gradient (d||w||/dw is
            # NaN at the zero blocks the prox creates)
            with torch.no_grad():
                reg = tree_group_penalty(params, cfg.sparsity.block_shape, 2,
                                         cfg.sparsity.applies_to)
            loss = loss + cfg.sparsity.lambda_reg * reg
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over the param leaves:
    (loss, metrics, grads) with grads a tree like ``params``; a leaf the
    loss does not reach gets zeros (as JAX gives)."""
    ps = leaves(params)
    live = [p.detach().requires_grad_(True) for p in ps]
    loss, metrics = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1, packs=None, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``grad_accum`` splits the batch into that many microbatches
    and averages their fp32 gradients. ``donate=True`` updates the given
    params and optimizer state in place and returns them (``adamw_update``'s
    ``donate``): the caller must not expect the old values after the step."""
    loss_fn = make_loss_fn(cfg, packs)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            gsum, lsum = None, None
            for a in range(grad_accum):
                mb = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                   + tuple(v.shape[1:]))[a]
                      for k, v in batch.items()}
                loss_a, _, g = value_and_grad(loss_fn, params, mb)
                g = [x.float() for x in leaves(g)]
                gsum = g if gsum is None else [s + x for s, x in zip(gsum, g)]
                lsum = loss_a if lsum is None else lsum + loss_a
            grads = unflatten(params, [s / grad_accum for s in gsum])
            loss = lsum / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        new_params, new_opt, om = adamw_update(grads, opt_state, params,
                                               opt_cfg, cfg.sparsity,
                                               donate=donate)
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    return train_step



def make_prefill_step(cfg: ModelConfig, packs=None):
    """``prefill_step(params, batch) -> (B,)`` greedy next token after the
    last position of ``batch['tokens']``."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model_forward(params, cfg, batch, packs=packs)
        return torch.argmax(logits[:, -1], dim=-1)
    return prefill_step


def make_serve_step(cfg: ModelConfig, packs=None):
    """``serve_step(params, cache, token (B, 1), pos) -> (next token (B, 1)
    int32, cache)``: one greedy decode step, the cache written in place."""
    def serve_step(params, cache, token, pos):
        with torch.no_grad():
            logits, cache = model_decode_step(params, cache, cfg, token, pos,
                                              packs=packs)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return serve_step
