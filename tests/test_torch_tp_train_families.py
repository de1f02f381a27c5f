"""The mesh Trainer on the vlm and MoE families, on the CPU: pixtral_12b,
deepseek_v2_lite_16b (MLA + MoE) and qwen3_moe (GQA + MoE) smoke configs
(fp32) trained over ``torch.distributed`` (explicit SPMD, one process per
mesh position) against the JAX reference's train step on one device and
against the port's single-device Trainer.

The module starts world 4 ONCE (four processes, gloo, ``file://`` init
under the test's temporary directory, 60 s collective timeouts, one torch
thread each, a join deadline; they import no JAX) and runs every case there
over (4, 1), (1, 4) and (2, 2); the parent computes the JAX side and the
single-device runs meanwhile, then the parametrised tests assert on the
results, so each case still counts:

  * one train step on weights drawn by JAX and brought over by
    ``bridge.py`` (pixtral with ``mm_embeds`` through
    ``make_train_step(mesh=)``): every gathered gradient within 1e-5 of its
    leaf's max|g| of ``jax.value_and_grad`` of the reference's loss, the
    loss and ``grad_norm`` within 1e-5 relative, the aux within 1e-6 of the
    reference's global aux, each rank's expert shard of ``shard_shape`` and
    no routed-expert leaf gathered whole, the gradients of leaves
    replicated over "model" bitwise equal on every model rank;
  * the capacity-binding case (``capacity_factor`` 0.5: assignments are
    dropped): the mesh's capacity and dispatch ``(sorted_e, slot)`` equal
    one device's, and routing only a rank's own rows -- what the mesh
    would do without the rows' gather -- keeps other assignments;
  * deepseek_v2_lite's MLA projections pruned at 32 x 32 on shards of 24
    or 16 rows / columns (blocks straddle shards): each step's masks equal
    one device's except at printed near-ties;
  * a (2, 2) checkpoint restored bitwise at (1, 4), (4, 1) and on one
    device; ``Trainer.fit`` of each family on each mesh against one
    device's Trainer;
  * deepseek_v2_lite's packed step (MLA and FFN projections through the
    plan packs) over dp (4, 1) in the capacity-binding case, against one
    device's packed step on the whole batch.
"""
import dataclasses
import os
import pickle
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_tp_train import (STEP_OPT, TRAIN_OPT, _collect,  # noqa: E402
                                 _launch, _one_device_trainer,
                                 _quantile_margin)

MESHES = ((4, 1), (1, 4), (2, 2))
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
ARCHS = ("pixtral_12b", "deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")
MOE_ARCHS = ARCHS[1:]
#: the capacity-binding case: half the slots an even split would need,
#: and an aux coefficient large enough that the aux's gradient (through
#: the router and every data rank's rows) weighs as much as the CE's
TIGHT = dict(capacity_factor=0.5, router_aux_coef=10.0)
#: deepseek_v2_lite smoke's MLA projections pruned: wq (96, 64) cut in 24
#: rows over (1, 4), wo (64, 64) in 16 columns -- 32 x 32 blocks straddle
PRUNE = dict(block_shape=(32, 32), sparsity=0.5,
             targets=("attn/wq", "attn/wo", "attn/w_uk", "attn/w_uv",
                      "attn/w_dkv"),
             lambda_reg=1e-2, start_step=1, end_step=4)
PRUNE_STEPS = 5
PRUNE_MESHES = ((1, 4), (2, 2))
FIT_STEPS = 2
PACK_SPEC = dict(tile=(16, 16), sparsity=0.5, prune="tied", fuse_qkv=True,
                 cross_layer_union=True, backend="plan_pallas")
PACKED_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
PACKED_STEPS = 2
NEAR_TIE = 1e-4
DEADLINE_S = 300

RANK_PROGRAM = textwrap.dedent('''
    import dataclasses, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.store import CheckpointStore, spec_at
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import (at_path, flatten_with_path,
                                       norm_path, path_name, unflatten)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.sharding import (local_rows, local_shard,
                                             shard_shape, whole_leaf)
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import ExpertShard
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    from repro_torch.serving.servable import _routed_expert

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    ROUTES = None
    _route = moe_mod.route

    def recording_route(router, x2, cfg):
        """moe.route, recording each call's dispatch and, on a data mesh,
        the dispatch of this rank's own rows routed alone."""
        out = _route(router, x2, cfg)
        if ROUTES is not None:
            rec = {"t": x2.shape[0], "sorted_e": out[3].numpy().copy(),
                   "pos": out[5].numpy().copy(),
                   "order": out[4].numpy().copy()}
            if MESH.shape["data"] > 1:
                n = x2.shape[0] // MESH.shape["data"]
                lo = MESH.coord("data") * n
                own = _route(router, x2[lo:lo + n].detach(), cfg)
                rec["own"] = {"t": n, "lo": lo,
                              "sorted_e": own[3].numpy().copy(),
                              "pos": own[5].numpy().copy(),
                              "order": own[4].numpy().copy()}
            ROUTES.append(rec)
        return out
    moe_mod.route = recording_route
    MESH = None
    SLOTS = None
    _slots = ExpertShard.slots

    def recording_slots(self, buf):
        """ExpertShard.slots, recording the capacity and the slot rows of
        the buffer the rank's expert products take."""
        out = _slots(self, buf)
        if SLOTS is not None:
            SLOTS.append((buf.shape[1], tuple(out.shape)))
        return out
    ExpertShard.slots = recording_slots

    def key(shape):
        return "x".join(map(str, shape))

    def whole(tree, specs, mesh):
        with torch.no_grad():
            return {path_name(p): whole_leaf(x, at_path(specs, p),
                                             mesh).numpy()
                    for p, x in flatten_with_path(tree)}

    def one_step(arch, mesh, over=None, update=True):
        """One step's loss, aux, gathered gradients, shard facts and
        routing on this rank; with ``update`` also the whole train step's
        metrics."""
        global ROUTES, SLOTS
        cfg = dataclasses.replace(get_config(arch, smoke=True), **(over or {}))
        whole_p = params_from_numpy(IN["params"][arch])
        opt = AdamWConfig(**IN["step_opt"])
        step = make_train_step(cfg, opt, mesh=mesh)
        plan = step.plan
        coord = {a: mesh.coord(a) for a in mesh.axis_names}
        local = [(p, local_shard(x, at_path(plan.specs, p), mesh,
                                 coord).clone())
                 for p, x in flatten_with_path(whole_p)]
        params = unflatten(whole_p, [x for _, x in local])
        shapes = {path_name(p): (tuple(x.shape), shard_shape(
            tuple(at_path(plan.shapes, p).shape), at_path(plan.specs, p),
            mesh)) for p, x in local}
        experts = [path_name(p) for p, x in local
                   if _routed_expert(norm_path(path_name(p)), x.dim())]
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in local_rows(IN["batch"][arch], mesh).items()}
        ROUTES, SLOTS = [], []
        mesh.reset_stats()
        loss, metrics, grads = value_and_grad(
            make_loss_fn(cfg, None, plan), params, batch)
        routes, ROUTES = ROUTES, None
        slots, SLOTS = SLOTS, None
        stats = {k: v["calls"] for k, v in mesh.stats.items()}
        grads = plan.sync_grads(grads)
        rep = {path_name(p): g.numpy().copy()
               for p, g in flatten_with_path(grads)
               if "model" not in at_path(plan.specs, p)}
        gwhole = whole(grads, plan.specs, mesh)
        m = step(params, init_opt_state(params, opt), batch)[2] \
            if update else {}
        return {"loss": float(plan.mean(loss)),
                "aux": float(plan.mean(metrics["aux"])),
                "grads": gwhole, "replicated_grads": rep,
                "metrics": {k: float(v) for k, v in m.items()},
                "shapes": shapes, "experts": experts, "routes": routes,
                "slots": slots, "stats": stats,
                "whole_paths": sorted(path_name(p) for p in
                                      plan.whole_paths),
                "packs": {k: (type(v).__name__,
                              getattr(v, "sharded", None),
                              getattr(v, "fsdp", None),
                              getattr(v, "gather_rows", None))
                          for k, v in plan.packs.items()}}

    def trainer(arch, mesh, tmp, n_steps, prune=None):
        sp = SparsityConfig(**prune) if prune else None
        cfg = get_config(arch, smoke=True)
        if sp is not None:
            cfg = dataclasses.replace(cfg, sparsity=sp)
        tcfg = TrainConfig(n_steps=n_steps, ckpt_dir=tmp, seed=1,
                           log_every=1, prune=sp is not None,
                           opt=AdamWConfig(**IN["train_opt"]))
        dcfg = DataConfig(seq_len=32, global_batch=4,
                          vocab_size=cfg.vocab_size)
        return Trainer(cfg, tcfg, "cpu", dcfg, mesh=mesh)

    def fit(arch, mesh, tmp, n_steps, prune=None):
        tr = trainer(arch, mesh, tmp, n_steps, prune)
        masks = []
        one = tr._one_step

        def recorded(state, step):
            state, metrics = one(state, step)
            if state["masks"] is not None:
                masks.append((step, {path_name(p): m.numpy().copy()
                                     for p, m in flatten_with_path(
                                         state["masks"])}))
            return state, metrics
        tr._one_step = recorded
        state, hist = tr.fit(resume=False)
        return tr, state, {"hist": hist, "masks": masks,
                           "params": whole(state["params"], tr.plan.specs,
                                           mesh)}

    def gathered(tr, state):
        specs = tr.specs()
        with torch.no_grad():
            return {path_name(p): (whole_leaf(x, spec_at(specs, p), tr.mesh)
                                   if spec_at(specs, p) else x).numpy()
                    for p, x in flatten_with_path(state)}

    def mismatches(tr, state, whole_state):
        specs = tr.specs()
        coord = {a: tr.mesh.coord(a) for a in tr.mesh.axis_names}
        bad, n = [], 0
        for p, x in flatten_with_path(state):
            n += 1
            want = local_shard(whole_state[path_name(p)],
                               spec_at(specs, p) or (), tr.mesh, coord)
            if x.dtype != torch.from_numpy(np.asarray(want)).dtype or \\
                    not np.array_equal(x.numpy(), want):
                bad.append(path_name(p))
        return bad, n

    def packed(mesh):
        """deepseek_v2_lite's packed step over dp (4, 1), capacity binding:
        every rank the whole packs and params, its rows, the MoE routing
        the whole batch (the replicated plan's ExpertShards)."""
        cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b",
                                             smoke=True), **IN["tight"])
        sv = prepare_servable(params_from_numpy(IN["packed_params"]), cfg,
                              ServingSpec(**IN["pack_spec"]), device="cpu")
        opt = AdamWConfig(**IN["packed_opt"])
        step = make_train_step(cfg, opt, packs=sv.packs, mesh=mesh)
        params, ost, hist = sv.params, init_opt_state(sv.params, opt), []
        for b in IN["packed_batches"]:
            rows = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                    for k, v in local_rows(b, mesh).items()}
            params, ost, m = step(params, ost, rows)
            hist.append({k: float(v) for k, v in m.items()})
        return {"hist": hist, "packs": sorted(sv.packs),
                "shards": sorted(k for k, v in step.plan.packs.items()
                                 if isinstance(v, ExpertShard)),
                "params": {path_name(p): x.numpy()
                           for p, x in flatten_with_path(params)}}

    def replicated_embed(mesh):
        """A bf16 table's gradient through the replicated plan's embedding
        shard (the dp packed step's), synced as the step syncs it; and,
        the control, through plain indexing (each rank its own rows)."""
        from repro_torch.launch.steps import MeshPlan
        from repro_torch.models.common import embed_lookup
        plan = MeshPlan(get_config("deepseek_v2_lite_16b", smoke=True), mesh,
                        replicated=True)
        rows = local_rows({"t": IN["emb_t"], "c": IN["emb_c"]}, mesh)
        t = torch.from_numpy(rows["t"]).long()
        c = torch.from_numpy(rows["c"]).to(torch.bfloat16)
        out = {}
        for name, shard in (("plan", plan.packs.get("embed")),
                            ("plain", None)):
            w = torch.from_numpy(IN["emb_w"]).to(torch.bfloat16)
            w.requires_grad_(True)
            g, = torch.autograd.grad(embed_lookup(w, t, shard), w, c)
            g = plan.sync_grads({"embed": {"w": g}})["embed"]["w"]
            out[name] = g.float().numpy()
        return out

    def main():
        global MESH
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for shape in IN["meshes"]:
            MESH = mesh = init_process_mesh(shape)
            k = key(shape)
            R["coord_" + k] = mesh.coordinate
            for arch in IN["archs"]:
                R[f"step_{arch}_{k}"] = one_step(arch, mesh)
            for arch in IN["moe_archs"]:
                R[f"tight_{arch}_{k}"] = one_step(arch, mesh, IN["tight"],
                                                  update=False)
            for arch in IN["archs"]:
                _, _, R[f"fit_{arch}_{k}"] = fit(
                    arch, mesh, os.path.join(workdir, f"fit_{arch}_{k}"),
                    IN["fit_steps"])
        for shape in IN["prune_meshes"]:
            MESH = mesh = init_process_mesh(shape)
            _, _, R["prune_" + key(shape)] = fit(
                "deepseek_v2_lite_16b", mesh,
                os.path.join(workdir, "prune_" + key(shape)),
                IN["prune_steps"], IN["prune"])
        # the (2, 2) checkpoint (written at the end of fit) restored on the
        # other shapes
        MESH = mesh = init_process_mesh((2, 2))
        tr, state, _ = fit("deepseek_v2_lite_16b", mesh, IN["ckpt_dir"], 2)
        wholes = gathered(tr, state)
        R["ckpt_whole"] = wholes
        MESH = mesh = init_process_mesh((4, 1))
        R["packed"] = packed(mesh)
        R["replicated_embed"] = replicated_embed(mesh)
        for shape in ((1, 4), (4, 1)):
            MESH = mesh = init_process_mesh(shape)
            tr = trainer("deepseek_v2_lite_16b", mesh,
                         os.path.join(workdir, "x"), 2)
            got = tr.restore_state(CheckpointStore(IN["ckpt_dir"]), 2,
                                   tr.init_state())
            R["ckpt_" + key(shape)] = mismatches(tr, got, wholes)
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _jax_config(arch, over=None):
    from repro.configs.registry import get_config as jax_config
    return dataclasses.replace(jax_config(arch, smoke=True), **(over or {}))


def _jax_step(arch, jp, batch, over=None):
    """The reference on one device: loss, aux, gradients and the AdamW
    update's grad_norm (clip binding)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jopt
    jcfg = _jax_config(arch, over)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    jc = jopt.AdamWConfig(**STEP_OPT)
    _, _, m = jopt.adamw_update(g, jopt.init_opt_state(jp, jc), jp, jc,
                                jcfg.sparsity)
    return {"loss": float(loss), "aux": float(metrics["aux"]),
            "grads": _named(g), "grad_norm": float(m["grad_norm"])}


def _named(tree):
    import jax
    from repro_torch.core.tree import flatten_with_path, path_name
    return {path_name(p): np.asarray(x) for p, x in
            flatten_with_path(jax.tree.map(np.asarray, tree))}


def _one_device_routes(arch, params, batch, over):
    """The port's one-device loss on the same weights and batch, recording
    every ``moe.route`` call's dispatch (forward and remat recompute)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_loss_fn, value_and_grad
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    routes, route = [], moe_mod.route

    def recording(router, x2, c):
        out = route(router, x2, c)
        routes.append({"t": x2.shape[0], "sorted_e": out[3].numpy().copy(),
                       "pos": out[5].numpy().copy(),
                       "order": out[4].numpy().copy()})
        return out
    moe_mod.route = recording
    try:
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()}
        value_and_grad(make_loss_fn(cfg), params_from_numpy(params), b)
    finally:
        moe_mod.route = route
    return routes


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the parent's results, each rank's results) of every case."""
    import jax
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JPipeline
    from repro.models import init_model as j_init
    workdir = tmp_path_factory.mktemp("tp_train_families")
    rng = np.random.RandomState(0)
    tokens = JPipeline(JDataConfig(seq_len=32, global_batch=4,
                                   vocab_size=512)).batch_at(0)
    params, jparams, batches = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg = _jax_config(arch)
        jp = j_init(jax.random.PRNGKey(10 + i), jcfg)
        jparams[arch] = jp
        params[arch] = jax.tree.map(np.asarray, jp)
        batches[arch] = {k: np.asarray(v, np.int32) for k, v in
                         tokens.items()}
        if jcfg.family == "vlm":
            batches[arch]["mm_embeds"] = rng.randn(
                4, jcfg.n_patches, jcfg.d_model).astype(np.float32)
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models.api import init_model
    pipe = DataPipeline(DataConfig(seq_len=32, global_batch=4,
                                   vocab_size=512))
    packed_batches = [pipe.batch_at(20 + i) for i in range(PACKED_STEPS)]
    pipe.close()
    IN = {"meshes": MESHES, "archs": ARCHS, "moe_archs": MOE_ARCHS,
          "packed_params": params_to_numpy(init_model(
              0, get_config("deepseek_v2_lite_16b", smoke=True),
              device="cpu")),
          "pack_spec": PACK_SPEC, "packed_opt": PACKED_OPT,
          "packed_batches": packed_batches,
          "emb_w": rng.randn(64, 8).astype(np.float32),
          "emb_t": np.where(rng.rand(4, 32) < 0.75, 3,
                            rng.randint(0, 64, (4, 32))),
          "emb_c": (0.01 * rng.randn(4, 32, 8)).astype(np.float32),
          "tight": TIGHT, "params": params, "batch": batches,
          "step_opt": STEP_OPT, "train_opt": TRAIN_OPT,
          "fit_steps": FIT_STEPS, "prune": PRUNE,
          "prune_steps": PRUNE_STEPS, "prune_meshes": PRUNE_MESHES,
          "ckpt_dir": str(workdir / "ckpt22")}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs = _launch(workdir, RANK_PROGRAM)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        parent = {"in": IN, "jax": {}, "tight": {}, "routes": {}, "fit": {}}
        for arch in ARCHS:
            parent["jax"][arch] = _jax_step(arch, jparams[arch],
                                            batches[arch])
        for arch in MOE_ARCHS:
            parent["tight"][arch] = _jax_step(arch, jparams[arch],
                                              batches[arch], TIGHT)
            parent["routes"][arch] = _one_device_routes(
                arch, params[arch], batches[arch], TIGHT)
        for arch in ARCHS:
            parent["fit"][arch] = _one_device_trainer(
                arch, workdir / f"one_{arch}", FIT_STEPS, None)
        parent["prune"] = _one_device_trainer(
            "deepseek_v2_lite_16b", workdir / "one_prune", PRUNE_STEPS,
            PRUNE)
        ranks = _collect(procs, workdir, t0, DEADLINE_S)
        parent["ckpt_one"] = _restore_one_device(IN["ckpt_dir"])
        parent["packed"] = _one_device_packed(IN)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(n)
    return parent, ranks


def _restore_one_device(ckpt_dir):
    """The (2, 2) checkpoint restored by a one-device Trainer: (whole
    state by name, meta)."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    tr = Trainer(cfg, TrainConfig(n_steps=2, ckpt_dir=ckpt_dir + "_one",
                                  seed=1, opt=AdamWConfig(**TRAIN_OPT)),
                 "cpu", DataConfig(seq_len=32, global_batch=4,
                                   vocab_size=cfg.vocab_size))
    store = CheckpointStore(ckpt_dir)
    state = tr.restore_state(store, 2, tr.init_state())
    return ({path_name(p): x.numpy() for p, x in flatten_with_path(state)},
            store.meta(2))


def _one_device_packed(IN):
    """One device's packed step (the capacity-binding config) on the whole
    batches: (metrics a step, final params by name)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                              **TIGHT)
    sv = prepare_servable(params_from_numpy(IN["packed_params"]), cfg,
                          ServingSpec(**PACK_SPEC), device="cpu")
    opt = AdamWConfig(**PACKED_OPT)
    step = make_train_step(cfg, opt, packs=sv.packs)
    params, ost, hist = sv.params, init_opt_state(sv.params, opt), []
    for b in IN["packed_batches"]:
        params, ost, m = step(params, ost, {
            k: torch.from_numpy(v).long() for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()})
    return {"hist": hist, "packs": sorted(sv.packs),
            "params": {path_name(p): x.numpy() for p, x in
                       flatten_with_path(params)}}


def _key(shape):
    return "x".join(map(str, shape))


# --------------------------------------------------------------------------
# one train step against the reference
# --------------------------------------------------------------------------

def _check_grads(got, want, r):
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(
            got["grads"][name], g, rtol=0,
            atol=1e-5 * max(np.abs(g).max(), 1e-30),
            err_msg=f"rank {r}: {name}")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_gradients_match_jax(world, arch, shape):
    """Every gradient, gathered whole, within 1e-5 of its leaf's max|g| of
    jax.value_and_grad of the reference's loss on the same weights and
    batch (pixtral's with ``mm_embeds``, cut by ``local_rows``); the loss
    within 1e-5 relative and the aux within 1e-6 of the reference's
    global aux, on every rank; every rank's shards of ``shard_shape``
    under the train-mode spec."""
    parent, ranks = world
    want = parent["jax"][arch]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert abs(got["aux"] - want["aux"]) <= 1e-6, (r, got["aux"])
        _check_grads(got, want, r)
        for name, (local, spec_shape) in got["shapes"].items():
            assert local == spec_shape, (r, name)
    if arch != "pixtral_12b":
        assert want["aux"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_metrics_match_jax(world, arch, shape):
    """The whole step with clipping binding: loss, ce, aux and grad_norm
    equal on every rank, the loss and grad_norm within 1e-5 relative of
    the reference's."""
    parent, ranks = world
    want = parent["jax"][arch]
    assert want["grad_norm"] > 100 * STEP_OPT["clip_norm"]
    first = ranks[0][f"step_{arch}_{_key(shape)}"]["metrics"]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]["metrics"]
        assert got == first, r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_experts_are_held_expert_parallel(world, arch, shape):
    """Each rank holds its E/m block of every routed-expert leaf (its ``a``
    dim cut over "data" where the rule cuts it), as ``shard_shape`` of the
    spec says; no routed-expert leaf is among the leaves gathered whole,
    and every MoE layer runs an ``ExpertShard`` whose collectives the
    step counted (the outputs' gather over "model", the rows' gather over
    "data")."""
    _, ranks = world
    e = 8
    d, m = shape
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        assert len(got["experts"]) == 3, got["experts"]
        for name in got["experts"]:
            local, want = got["shapes"][name]
            assert local == want, (r, name)
            assert local[-3] == e // m, (r, name, local)
            assert not any(name == w for w in got["whole_paths"]), name
        kinds = {k: v for k, v in got["packs"].items()
                 if k.endswith("/ffn/experts")}
        assert kinds and all(v[0] == "ExpertShard" for v in kinds.values())
        for _, sharded, fsdp, rows in kinds.values():
            assert sharded == (m > 1) and rows == (d > 1)
            assert set(fsdp) == ({"wi", "wg", "wo"} if d > 1 else set())
        stats = got["stats"]
        if m > 1:
            assert stats.get("all_gather:model", 0) > 0, stats
        if d > 1:
            assert stats.get("all_gather:data", 0) > 0, stats


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_products_split_slots_over_data(world, arch, shape):
    """On a data mesh a rank's expert products take its block of the
    capacity slots, ceil(cap / d) rows of its E/m experts, so the mesh
    runs the global batch's expert FLOPs once between its ranks, not once
    a data rank; with no data cut they take every slot."""
    _, ranks = world
    e = 8
    d, m = shape
    for r, res in enumerate(ranks):
        slots = res[f"step_{arch}_{_key(shape)}"]["slots"]
        assert slots, r
        for cap, (experts, rows, _) in slots:
            assert experts == e // m, (r, experts)
            assert rows == -(-cap // d), (r, cap, rows)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaf_gradients_equal_across_model_ranks(world, arch,
                                                            shape):
    """A leaf the spec does not cut over "model" (the router, MLA's latent
    projections, norm scales) takes no model-axis reduce: its gradient is
    whole and equal, bit for bit, on every rank of a model group."""
    _, ranks = world
    key = _key(shape)
    groups = {}
    for res in ranks:
        groups.setdefault(res["coord_" + key][0], []).append(
            res[f"step_{arch}_{key}"]["replicated_grads"])
    n_leaves = 0
    for members in groups.values():
        for name, g in members[0].items():
            n_leaves += 1
            for other in members[1:]:
                assert np.array_equal(other[name], g), name
    assert n_leaves > 0
    names = set(groups[0][0])
    if arch != "pixtral_12b":
        assert any("router" in n for n in names), sorted(names)
    if arch == "deepseek_v2_lite_16b":
        assert any("w_uk" in n for n in names), sorted(names)


def test_mla_heads_cut_on_model_mesh(world):
    """Over (1, 4) and (2, 2) each deepseek MLA layer runs over its rank's
    query heads (a ``HeadShard``: 4 heads divide both model axes);
    MLA's latent projections stay replicated (no ``DenseShard``)."""
    _, ranks = world
    for shape in ((1, 4), (2, 2)):
        packs = ranks[0][f"step_deepseek_v2_lite_16b_{_key(shape)}"]["packs"]
        heads = [k for k, v in packs.items() if k.endswith("attn/heads")]
        assert sorted(heads) == ["blocks/0/attn/heads",
                                 "prefix/0/attn/heads"], packs
        assert not any(n in k for k in packs for n in
                       ("w_dkv", "w_uk", "w_uv", "w_krope")), packs


# --------------------------------------------------------------------------
# the capacity-binding case
# --------------------------------------------------------------------------

def _kept(rec, lo=0, k=2):
    """{(token, expert)} of the assignments a dispatch keeps (slot below
    capacity), tokens numbered from ``lo``."""
    from repro_torch.models.moe import capacity

    class _C:
        top_k, n_experts = k, 8
        capacity_factor = TIGHT["capacity_factor"]
    cap = capacity(rec["t"], _C)
    keep = rec["pos"] < cap
    return {(lo + int(o) // k, int(e)) for o, e, ok in
            zip(rec["order"], rec["sorted_e"], keep) if ok}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_binding_routes_the_global_batch(world, arch, shape):
    """``capacity_factor`` 0.5: assignments are dropped on one device. On
    the mesh every MoE call routes the whole batch's tokens (capacity from
    the global count), its dispatch ``(sorted_e, slot)`` equals one
    device's, and with the aux's coefficient at 10 (its gradient as large
    as the CE's) the gradients stay within 1e-5 of JAX's and the aux
    within 1e-6 relative. On a data mesh a rank routing only its own rows
    would keep other assignments (the fault the rows' gather removes)."""
    from repro_torch.models.moe import capacity
    parent, ranks = world
    one = parent["routes"][arch]
    want = parent["tight"][arch]

    class _C:
        top_k, n_experts = 2, 8
        capacity_factor = TIGHT["capacity_factor"]
    assert one and all(rec["t"] == 128 for rec in one)
    cap = capacity(128, _C)
    assert sum(int((rec["pos"] >= cap).sum()) for rec in one) > 0
    for r, res in enumerate(ranks):
        got = res[f"tight_{arch}_{_key(shape)}"]
        assert len(got["routes"]) == len(one), r
        for a, b in zip(got["routes"], one):
            assert a["t"] == b["t"]
            assert np.array_equal(a["sorted_e"], b["sorted_e"])
            assert np.array_equal(np.minimum(a["pos"], cap),
                                  np.minimum(b["pos"], cap))
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["aux"] == pytest.approx(want["aux"], rel=1e-6)
        _check_grads(got, want, r)
        if shape[0] > 1:
            differ = 0
            for rec in got["routes"]:
                own = rec["own"]
                mine = {(t, e) for t, e in _kept(rec)
                        if own["lo"] <= t < own["lo"] + own["t"]}
                differ += mine != _kept(own, own["lo"])
            assert differ > 0, r


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_trainer_fits_like_one_device(world, arch, shape):
    """``Trainer(mesh=).fit()`` for 2 steps: the logged losses within 1e-5
    relative of one device's Trainer on the same seed and batches and
    equal on every rank; the final weights within 1e-4 but for at most one
    element in 10^4 of a leaf (and at least one), and those within 2 x the
    summed learning rate. AdamW divides each element's gradient by its own
    RMS, so an element whose gradient sits near zero moves by an amount
    the order of the fp32 sums decides (measured in a 3-step run: qwen3_moe
    (4, 1) embed/w[374, 26], gradient ~1e-7 against a leaf max of 0.35,
    off by 1.9e-4), and one device's own 2 steps from weights moved by
    1e-7 relative noise put one element of qwen3_moe's 4,096-element
    attn/wk/w 1.6e-4 off and one of its embed/w 1.2e-4 off; a leaf left
    without its update would be off by ~lr everywhere."""
    from repro_torch.optim.adamw import AdamWConfig, lr_at
    parent, ranks = world
    one = parent["fit"][arch]
    opt = AdamWConfig(**TRAIN_OPT)
    bound = 2 * sum(float(lr_at(opt, s)) for s in range(FIT_STEPS))
    first = ranks[0][f"fit_{arch}_{_key(shape)}"]["hist"]
    for r, res in enumerate(ranks):
        got = res[f"fit_{arch}_{_key(shape)}"]
        assert got["hist"] == first, r
        assert [s for s, _ in got["hist"]] == list(range(FIT_STEPS))
        np.testing.assert_allclose([x for _, x in got["hist"]],
                                   [x for _, x in one["hist"]], rtol=1e-5)
        for name, w in one["params"].items():
            diff = np.abs(got["params"][name] - w)
            off = np.argwhere(diff > 1e-4)
            for idx in off:
                print(f"rank {r} {name}{tuple(idx)}: off by "
                      f"{diff[tuple(idx)]:.3e}")
            assert len(off) <= max(1, diff.size // 10000), (name, len(off))
            assert diff.max() <= bound, (name, diff.max())


@pytest.mark.parametrize("shape", PRUNE_MESHES,
                         ids=[_key(s) for s in PRUNE_MESHES])
def test_mla_pruning_masks_equal_one_device(world, shape):
    """deepseek_v2_lite smoke, 5 steps of gradual pruning to 0.5 at 32 x 32
    with the group-lasso prox on its MLA projections (``wq`` cut in 24- or 48-row
    shards, ``wo`` in 16- or 32-column shards, the latent projections
    replicated): every step's masks equal one device's except at
    near-ties, printed with their margin; the losses within 1e-5
    relative."""
    from repro_torch.core.pruner import cubic_sparsity
    from repro_torch.core.sparsity import SparsityConfig
    parent, ranks = world
    one = parent["prune"]
    sp = SparsityConfig(**PRUNE)
    params_at = {step: p for step, p, _ in one["states"]}
    masks_at = {step: m for step, _, m in one["states"]}
    for r, res in enumerate(ranks):
        got = res["prune_" + _key(shape)]
        assert len(got["masks"]) == PRUNE_STEPS
        np.testing.assert_allclose([x for _, x in got["hist"]],
                                   [x for _, x in one["hist"]], rtol=1e-5)
        for step, masks in got["masks"]:
            assert sorted(masks) == sorted(masks_at[step]), step
            assert any("w_uk" in n for n in masks)
            for name, m in masks.items():
                diff = np.argwhere(m != masks_at[step][name])
                w = params_at[step][name]
                layers = w if w.ndim == 3 else w[None]
                for idx in diff:
                    li, bi, bj = (idx if w.ndim == 3 else (0, *idx))
                    layer = layers[li].reshape(
                        w.shape[-2] // 32, 32, w.shape[-1] // 32, 32)
                    norms = np.sqrt((layer.astype(np.float64) ** 2).sum(
                        axis=(1, 3)))
                    margin = _quantile_margin(
                        norms, cubic_sparsity(step, sp))[bi, bj]
                    print(f"near-tie: rank {r} step {step} {name} block "
                          f"{tuple(idx)} margin {margin:.3e}")
                    assert margin < NEAR_TIE, (name, step, tuple(idx),
                                               margin)


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)], ids=["1x4", "4x1"])
def test_mesh_checkpoint_restores_on_other_shapes(world, shape):
    """deepseek_v2_lite's (2, 2) checkpoint (routed experts cut over both
    axes, MLA projections, AdamW moments) restored at (1, 4) and (4, 1):
    every rank's leaf is ``local_shard`` of the whole leaf the (2, 2)
    ranks gathered, bit for bit."""
    _, ranks = world
    for r, res in enumerate(ranks):
        bad, n = res["ckpt_" + _key(shape)]
        assert n > 40 and not bad, (r, bad)


def test_mesh_checkpoint_restores_on_one_device(world):
    """The (2, 2) checkpoint restored by a one-device Trainer equals the
    whole state the ranks gathered, bit for bit; its meta records the
    mesh that wrote it."""
    parent, ranks = world
    got, meta = parent["ckpt_one"]
    want = ranks[0]["ckpt_whole"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
            name
    assert meta["mesh"]["shape"] == [2, 2]


def test_dp_packed_moe_step_matches_one_device(world):
    """deepseek_v2_lite's packed fine-tuning step over dp (4, 1) with
    capacity binding: every rank the whole packs (MLA ``wq`` / ``wo``, the
    dense layer's FFN: K1 / K4 / K5, plain on the CPU) and its rows, each
    MoE layer routing the whole batch through the replicated plan's
    ``ExpertShard``; loss and grad_norm equal on every rank and within
    1e-5 relative of one device's packed step on the whole batch, the
    weights within 1e-5 after 2 steps."""
    parent, ranks = world
    want = parent["packed"]
    assert any("/attn/" in k for k in want["packs"]) and \
        any("/ffn/" in k for k in want["packs"]), want["packs"]
    first = ranks[0]["packed"]["hist"]
    for r, res in enumerate(ranks):
        got = res["packed"]
        assert got["packs"] == want["packs"] and got["hist"] == first, r
        assert got["shards"] == ["blocks/0/ffn/experts"], got["shards"]
        for g, w in zip(got["hist"], want["hist"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["aux"] == pytest.approx(w["aux"], rel=1e-6)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0,
                                       atol=1e-5, err_msg=name)


def test_replicated_plan_embedding_gradient_adds_rows_as_one_device(world):
    """The dp packed step's plan (every leaf whole on every rank) takes a
    bf16 table's gradient over the whole batch in one device's order
    (``common._BatchRows`` through its embedding shard): after the step's
    sync (the sum over "data", divided by 4) it equals one device's
    gradient / 4 bit for bit on every rank, where plain indexing (each
    rank adding its own rows' repeats, the control) differs. Without it a
    bf16 deepseek_v2_lite packed step read 0.8% off one device's
    grad_norm on the H100: the pipeline's zipfian tokens repeat one token
    hundreds of times in a batch."""
    parent, ranks = world
    IN = parent["in"]
    w = torch.from_numpy(IN["emb_w"]).to(torch.bfloat16).requires_grad_(True)
    c = torch.from_numpy(IN["emb_c"]).to(torch.bfloat16)
    want, = torch.autograd.grad(w[torch.from_numpy(IN["emb_t"]).long()], w,
                                c)
    want = (want / 4).float().numpy()
    for r, res in enumerate(ranks):
        got = res["replicated_embed"]
        assert np.array_equal(got["plan"], want), r
        assert not np.array_equal(got["plain"], want), r


def test_donated_update_chunks_one_period_of_experts():
    """A leaf whose axis-0 rows each exceed ``adamw.CHUNK_ELEMS`` (one
    period of stacked experts, (1, E, d, f)) is updated in pieces of the
    flat leaf, so the update's fp32 temporaries stay near CHUNK_ELEMS
    elements: donated and chunked equals the functional whole-leaf update
    bit for bit (deepseek_v2_lite smoke's experts, the threshold below one
    expert's matrix)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, leaves, path_name
    from repro_torch.core.tree import unflatten
    from repro_torch.models.api import init_model
    from repro_torch.optim import adamw as topt
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                              n_layers=2)
    params = init_model(3, cfg, device="cpu")
    wi = params["blocks"][0]["ffn"]["wi"]
    assert wi.shape[0] == 1 and wi[0, 0].numel() > 3000
    tc = topt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(4)
    grads = unflatten(params, [torch.randn(p.shape, generator=gen) * 0.05
                               for p in leaves(params)])
    want_p, want_s, _ = topt.adamw_update(grads, topt.init_opt_state(
        params, tc), params, tc)
    assert len(topt._chunks(wi.view(-1), 1)) == 1
    old = topt.CHUNK_ELEMS
    topt.CHUNK_ELEMS = 3000
    try:
        pieces = topt._chunks(wi.view(-1), 1)
        assert len(pieces) > wi.shape[1] and all(
            wi.view(-1)[sl].numel() <= 3000 for sl in pieces)
        p = unflatten(params, [x.clone() for x in leaves(params)])
        s = topt.init_opt_state(params, tc)
        topt.adamw_update(grads, s, p, tc, donate=True)
    finally:
        topt.CHUNK_ELEMS = old
    for name, tree, ref in (("params", p, want_p), ("m", s["m"], want_s["m"]),
                            ("v", s["v"], want_s["v"])):
        for (path, a), b in zip(flatten_with_path(tree), leaves(ref)):
            assert torch.equal(a, b), f"{name}: {path_name(path)}"
