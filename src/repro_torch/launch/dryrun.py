"""Dry-run: trace one rank's step of every (arch x shape) cell on the
production mesh on the meta device, and record its memory, cost and
collectives and the H100 roofline.

Counterpart of ``repro/launch/dryrun.py``. The reference AOT-lowers and
compiles each cell's jitted step with 512 fake host devices and reads
XLA's analyses. The port runs explicit SPMD, one process a mesh position,
so the dry-run runs rank 0's own program: the cell's step on rank 0's
shards of meta-device inputs (``launch/specs.py``), over a dry
``ProcessMesh`` (``ProcessMesh.dry``) at rank 0's coordinate of
``make_production_mesh()`` -- (16, 16) over ("data", "model"), or with
``--multipod`` (2, 16, 16) over ("pod", "data", "model") --, whose
collectives return meta tensors of their output shapes and are counted as
a real run counts them (over the dp axes ("pod", "data") one count an
axis), under ``launch/op_cost.OpCost``. Nothing is allocated on any device, as the
reference compiles on the host; this is not a CPU fallback.

Three cell kinds, each through the step a user would call:

  * train: ``make_train_step(cfg, AdamWConfig(), donate=True, mesh=dry)``
    on rank 0's param, optimizer and batch shards (FSDP + TP + EP);
  * prefill: ``make_prefill_step`` on rank 0's rows of the batch, with the
    mesh servable's TP-only inference shards and shard objects
    (``servable.serving_param_shardings`` / ``_exec_packs``);
  * decode: ``make_serve_step`` on rank 0's slots and cache shard, with
    the same shards (MoE layers gather the step's rows where the dp axes
    cut the slots, as the servable's ``_decode_packs``).

A train or prefill cell given as a ``ShapeSpec`` of one row whose S
divides over the dp axes takes the sequence-parallel branch, as the
reference's batch shardings do: the rank's block of S and the step's
``packs['seq']`` (``steps.sequence_shard``), attention's K / V gathers
counted as a real run counts them. No ``SHAPES`` entry has one row but
``long_500k``, a decode cell.

The meta device runs no CUDA kernel: where the card would run K2 / K3, the
dry-run counts the plain ``decode_attention`` composition, and a decode
cell's JSON says so (``counted``). The reference's ``XLA_FLAGS`` /
``DRYRUN_DEVICES`` lines have no counterpart, and neither does its
``xla_cost_raw`` (XLA's loop-unaware count); ``trace_s`` takes the place of
``lower_s`` / ``compile_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_4b \\
      --shape train_4k [--multipod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.core.tree import at_path, map_with_path
from repro_torch.launch import analysis as ha
from repro_torch.launch.mesh import ProcessMesh, make_production_mesh
from repro_torch.launch.op_cost import OpCost, collective_bytes
from repro_torch.launch.sharding import (batch_shardings, cache_shardings,
                                          shard_shape)
from repro_torch.launch.specs import (cell_is_supported, input_specs,
                                       shape_spec)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                       make_train_step, sequence_shard)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

OUT_DIR = "results/dryrun_torch"


def dry_mesh(mesh) -> ProcessMesh:
    """Rank 0 of ``mesh`` as a dry ``ProcessMesh`` (``mesh`` itself when it
    is one: any rank). A multi-pod mesh's "pod" axis is data parallelism
    with "data" (``launch.mesh.dp_axes``): batches, caches and the
    gradients' means run over both, weights are cut over "data" alone."""
    if isinstance(mesh, ProcessMesh) and mesh.is_dry:
        return mesh
    return ProcessMesh.dry(mesh)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _shards(tree, specs, mesh, make=_meta):
    """``make(shape, dtype)`` for this rank's shard of every leaf."""
    return map_with_path(lambda path, x: make(
        shard_shape(tuple(x.shape), at_path(specs, path), mesh), x.dtype),
        tree)


def _has_decode_attention(cfg) -> bool:
    kinds = list(cfg.prefix) + list(cfg.pattern)
    return cfg.family == "audio" or any(k.mixer in ("attn", "local")
                                        for k in kinds)


def cell_step(cfg, shape, mesh, make=_meta):
    """(step, args, counted) of rank ``mesh.coordinate``'s part of a cell
    on the process mesh ``mesh`` (dry or real): the step function a user
    would call and its arguments, each leaf ``make(shape, dtype)`` at the
    rank's shard shape (meta tensors by default). ``counted``: which path
    a decode attention takes on the meta device."""
    from repro_torch.serving.servable import (_decode_packs, _exec_packs,
                                              serving_param_shardings)
    shape = shape_spec(shape)
    specs = input_specs(cfg, shape)
    counted = {}
    # a one-row batch whose S divides: the sequence-parallel branch
    seq = sequence_shard(cfg, specs["batch"], mesh) \
        if shape.kind != "decode" else None
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        step = make_train_step(cfg, opt_cfg, donate=True, mesh=mesh,
                               packs=None if seq is None else {"seq": seq})
        params = _shards(specs["params"], step.plan.specs, mesh, make)
        opt = init_opt_state(params, opt_cfg)
        batch = _shards(specs["batch"],
                        batch_shardings(specs["batch"], mesh), mesh, make)
        return step, (params, opt, batch), counted
    # inference: TP-only params and the mesh servable's shard objects
    p_specs = serving_param_shardings(specs["params"], {}, mesh)
    params = _shards(specs["params"], p_specs, mesh, make)
    packs = _exec_packs({}, params, p_specs, cfg, mesh)
    if shape.kind == "prefill":
        batch = _shards(specs["batch"],
                        batch_shardings(specs["batch"], mesh), mesh, make)
        if seq is not None:
            packs = dict(packs, seq=seq)
        return make_prefill_step(cfg, packs), (params, batch), counted
    cache = _shards(specs["cache"], cache_shardings(specs["cache"], mesh),
                    mesh, make)
    tok = batch_shardings({"t": specs["token"]}, mesh)["t"]
    if tok[0] is not None:                  # slots cut over the dp axes
        packs = _decode_packs(packs)
    if _has_decode_attention(cfg):
        counted["decode_attention"] = (
            "plain decode_attention (the card runs K2 flash_decode)")
    args = (params, cache, _shards({"t": specs["token"]}, {"t": tok}, mesh,
                                   make)["t"],
            make((), specs["pos"].dtype))
    return make_serve_step(cfg, packs), args, counted


def trace_cell(cfg, shape, mesh) -> dict:
    """Runs a rank's step of the cell (``shape``: a ``SHAPES`` name or a
    ``ShapeSpec``) on meta shards under ``OpCost``: rank 0 of ``mesh``, or
    ``mesh``'s own rank when it is a dry ``ProcessMesh``;
    returns the counts: flops, bytes, ops, trace seconds, the memory dict,
    the mesh's collective ``stats`` (calls and bytes per ``op:axis``),
    ``counted`` (which path a decode attention took) and ``by_op`` (aten
    op name -> [calls, flops, bytes])."""
    dry = dry_mesh(mesh)
    dry.reset_stats()
    step, args, counted = cell_step(cfg, shape, dry)
    with OpCost(dry=True) as cost:
        cost.hold(args)
        out = step(*args)
        output_bytes = OpCost.storage_bytes(out)
        del out, args
    return {"flops": cost.flops, "bytes": cost.bytes, "ops": cost.ops,
            "trace_s": cost.seconds, "memory": {
                "argument_bytes": cost.argument_bytes,
                "output_bytes": output_bytes,
                "temp_bytes": cost.peak - cost.argument_bytes,
                "peak_bytes": cost.peak},
            "stats": {k: {"calls": v["calls"], "bytes": v["bytes"]}
                      for k, v in sorted(dry.stats.items())},
            "counted": counted, "by_op": dict(cost.by_op)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "n_devices": n_dev}

    ok, reason = cell_is_supported(cfg, shape)
    if not ok:
        cell.update(status="SKIP", reason=reason)
        return cell

    try:
        res = trace_cell(cfg, shape, mesh)
        coll = collective_bytes(res["stats"])
        p_specs = input_specs(cfg, shape)["params"]
        n_params = ha.count_params(p_specs)
        n_expert = ha.count_expert_params(p_specs)
        model_fl = ha.model_flops_estimate(cfg, shape, n_params, n_expert,
                                           shape.kind)
        roof = ha.Roofline(flops=res["flops"], hbm_bytes=res["bytes"],
                           coll_bytes=coll["total"], n_devices=n_dev,
                           model_flops=model_fl)
        cell.update(
            status="OK", trace_s=round(res["trace_s"], 1), ops=res["ops"],
            n_params=n_params, n_expert_params=n_expert,
            memory=res["memory"],
            collectives={k: int(v) for k, v in coll.items()},
            collective_calls=res["stats"], counted=res["counted"],
            roofline=roof.to_dict(),
        )
    except Exception as e:  # noqa: BLE001 -- a cell's failure is its record
        cell.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                    trace=traceback.format_exc()[-2000:])
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = ([(a, s) for a in ASSIGNED for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    t_all = time.perf_counter()
    for arch, shape in cells:
        tag = "multipod" if args.multipod else "pod"
        res = run_cell(arch, shape, args.multipod, args.out)
        path = os.path.join(args.out,
                            f"{arch.replace('-', '_')}__{shape}__{tag}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps({k: res[k] for k in
                          ("arch", "shape", "mesh", "status")}
                         | ({"bottleneck": res["roofline"]["bottleneck"],
                             "trace_s": res["trace_s"]}
                            if res["status"] == "OK" else
                            {"why": res.get("reason", res.get("error", ""))}),
                         ), flush=True)
    print(json.dumps({"cells": len(cells),
                      "seconds": round(time.perf_counter() - t_all, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
