"""Spec-driven serving API of the port (docs/API.md describes the reference).

    from repro_torch.serving import ServingSpec, prepare_servable, load_servable

    servable = prepare_servable(params, cfg, ServingSpec(backend="plan_pallas"))
    logits = servable.forward(tokens)
    servable.save("ckpt/")
    servable = load_servable("ckpt/")

    engine = servable.engine(max_slots=4, cache_len=1280)   # continuous
    h = engine.submit(prompt_tokens, max_new_tokens=32)     # batching
    engine.run(); print(h.tokens)

On a mesh (``ServingSpec(mesh_shape=(data, model), partition=...)``) every
rank -- one process per mesh position, ``torch.distributed`` initialised
with ``launch.mesh.init_distributed`` -- makes the same calls:
``prepare_servable`` (or ``load_servable`` of an artifact, or
``place_servable`` of a whole export prepared with ``place=False``), then
the same engine submissions.
"""
from repro_torch.serving.engine import (EngineRequest, EngineStats,
                                        FailureReason, ServingEngine,
                                        TERMINAL_STATES)
from repro_torch.serving.export import (export_bert_sparse, export_lm_sparse,
                                        export_params, pack_single,
                                        pack_stacked)
from repro_torch.serving.serialize import ServableLoadError
from repro_torch.serving.servable import (SERVABLE_STEP, Servable,
                                          load_servable, make_serving_mesh,
                                          place_servable, prepare_servable)
from repro_torch.serving.spec import (DEFAULT_TARGETS, OVERFLOW_POLICIES,
                                      SchedSpec, ServingSpec)

__all__ = [n for n in dir() if not n.startswith("_")]
