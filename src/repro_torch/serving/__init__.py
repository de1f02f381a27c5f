"""Spec-driven serving API of the port (docs/API.md describes the reference).

    from repro_torch.serving import ServingSpec, prepare_servable, load_servable

    servable = prepare_servable(params, cfg, ServingSpec(backend="plan_pallas"))
    logits = servable.forward(tokens)
    servable.save("ckpt/")
    servable = load_servable("ckpt/")
"""
from repro_torch.serving.export import (export_bert_sparse, export_params,
                                        pack_single, pack_stacked)
from repro_torch.serving.serialize import ServableLoadError
from repro_torch.serving.servable import (SERVABLE_STEP, Servable,
                                          load_servable, prepare_servable)
from repro_torch.serving.spec import DEFAULT_TARGETS, SchedSpec, ServingSpec

__all__ = [n for n in dir() if not n.startswith("_")]
