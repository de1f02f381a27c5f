"""Shared layer primitives: norms, activations, linear init/apply.

Counterpart of the BERT-path part of ``repro/models/common.py``. Parameters
are plain dicts of tensors, laid out as in the reference: a linear weight is
stored (d_out, d_in) and applied as ``y = x @ w.T`` (the BSR layout).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ITEM_BSR = "ROADMAP.md Queue 1 item 4 (bsr_linear backends)"
_ITEM_LM = "ROADMAP.md Queue 1 item 9 (the LM model path)"


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


# -- linear (dense or block-sparse) -------------------------------------------

def init_linear(gen, d_in, d_out, dtype=torch.float32, scale=0.02,
                device=None):
    """Weight stored (d_out, d_in): y = x @ w.T -- matches the BSR layout."""
    return {"w": normal_init(gen, (d_out, d_in), scale, dtype, device)}


def linear(p, x, pack=None):
    """Dense or block-sparse projection.

    ``pack`` is static pattern metadata from ``serving.export``:
      * a ``RowPackPlan`` -- ``p['w']`` holds row-grouped values
        (V, P, bn, bk) served by the plain plan composition ('plan');
      * a ``PlanChoice`` -- the same layout pinned to a backend through
        ``ops.plan_dispatch`` ('plan_pallas' = kernel K1);
      * None -- a dense weight, ``x @ w.T``.
    """
    if pack is not None:
        from repro_torch.kernels.exec_plan import (PlanChoice, RowPackPlan,
                                                   plan_matmul)
        if isinstance(pack, PlanChoice):
            from repro_torch.kernels.ops import plan_dispatch
            return plan_dispatch(x, p["w"], pack.plan, backend=pack.backend)
        if isinstance(pack, RowPackPlan):
            return plan_matmul(x, p["w"], pack)
        raise NotImplementedError(
            f"pack kind {type(pack).__name__} is not ported yet; it comes "
            f"with {_ITEM_BSR}")
    return torch.matmul(x, p["w"].t())


def _ungated(act):
    if act in ("swiglu", "geglu"):
        raise NotImplementedError(f"gated MLPs come with {_ITEM_LM}")


def init_mlp(gen, d_model, d_ff, act="gelu", dtype=torch.float32,
             device=None):
    _ungated(act)
    return {"wi": init_linear(gen, d_model, d_ff, dtype, device=device),
            "wo": init_linear(gen, d_ff, d_model, dtype, device=device)}


def apply_mlp(p, x, act="gelu", packs=None):
    _ungated(act)
    packs = packs or {}
    h = act_fn(act)(linear(p["wi"], x, packs.get("wi")))
    return linear(p["wo"], h, packs.get("wo"))
