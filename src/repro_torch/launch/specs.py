"""Meta-device input specs for every (arch x shape) cell: the dry-run's
stand-ins (shape and dtype, no storage, nothing drawn).

Counterpart of ``repro/launch/specs.py``. Where the reference builds
``jax.ShapeDtypeStruct`` stand-ins with ``jax.eval_shape``, the port builds
tensors on the meta device: the param tree is ``models.api.param_shapes``
and a decode cache is ``models.api.init_cache`` run on meta params (the
audio family's encoder runs over meta frames). Every function takes a
shape name of ``configs.base.SHAPES`` or a ``ShapeSpec`` itself, so tests
can pass small shapes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models import api


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def shape_spec(shape) -> ShapeSpec:
    """``shape`` as a ``ShapeSpec`` (a name of ``SHAPES`` or one itself)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def batch_specs(cfg: ModelConfig, shape, with_labels: bool):
    shape = shape_spec(shape)
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": sds((b, s), torch.int32)}
    if with_labels:
        out["labels"] = sds((b, s), torch.int32)
    if cfg.family == "audio":
        out["frames"] = sds((b, cfg.n_audio_ctx, cfg.d_model), cfg.tdtype)
    if cfg.family == "vlm":
        out["mm_embeds"] = sds((b, cfg.n_patches, cfg.d_model), cfg.tdtype)
    return out


def params_specs(cfg: ModelConfig):
    return api.param_shapes(cfg)


def cache_specs(cfg: ModelConfig, shape, params_shapes):
    shape = shape_spec(shape)
    b, s = shape.global_batch, shape.seq_len
    frames = (sds((b, cfg.n_audio_ctx, cfg.d_model), cfg.tdtype)
              if cfg.family == "audio" else None)
    with torch.no_grad():
        return api.init_cache(params_shapes, cfg, b, s, frames=frames)


def input_specs(cfg: ModelConfig, shape):
    """Returns a dict describing every input of the cell's step fn."""
    shape = shape_spec(shape)
    p = params_specs(cfg)
    if shape.kind == "train":
        return {"params": p, "batch": batch_specs(cfg, shape, True)}
    if shape.kind == "prefill":
        return {"params": p, "batch": batch_specs(cfg, shape, False)}
    # decode
    b = shape.global_batch
    return {"params": p,
            "cache": cache_specs(cfg, shape, p),
            "token": sds((b, 1), torch.int32),
            "pos": sds((), torch.int32)}


def cell_is_supported(cfg: ModelConfig, shape):
    """(supported, reason). long_500k only for bounded-state archs; decode
    shapes skipped for encoder-only families."""
    shape = shape_spec(shape)
    if cfg.family == "bert" and shape.kind in ("decode",):
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, "full-attention arch: 500k ctx needs sub-quadratic attention"
    return True, ""
