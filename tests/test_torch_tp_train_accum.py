"""A mesh train step with gradient accumulation against the reference's, on
the CPU.

``make_train_step(grad_accum=A)`` splits the global batch of B rows into A
microbatches, microbatch a being rows [a B/A, (a+1) B/A) (the reference
reshapes the batch to (A, B/A, ...)). On a data mesh each rank takes its
rows of every microbatch (``launch.sharding.local_rows(batch, mesh, A)``)
so the step's reshape of its rows yields the reference's microbatch a cut
to the rank; a MoE layer then routes exactly the reference's microbatch,
gathered over "data" in global row order. Cutting a rank's block of the
whole batch first would put other rows together in a microbatch: in the
capacity-binding case (``capacity_factor`` 0.5, drops) the routing, the
drops and the aux differ, so the step does.

Two worlds run at once, 4 ranks and 2 ranks (gloo, ``file://`` init under
the test's temporary directory, one torch thread a rank, no JAX), while
the parent computes the JAX steps and the port's one-device routing. With
A = 2 and a (8, 32) batch, over (2, 1), (4, 1) and (2, 2):

  * qwen3_moe smoke in the capacity-binding case and deepseek_7b smoke
    (dense): the step's loss and grad_norm within 1e-5 relative of the
    JAX package's ``make_train_step(grad_accum=2)`` on one device (same
    weights, same global batch), equal on every rank;
  * every MoE call's rows, gathered over "data", equal to one device's
    microbatch rows in order, and its dispatch equal to one device's;
  * the dp packed step (qwen3_moe's attention projections packed, the
    capacity-binding case) over (2, 1) and (4, 1) against one device's
    packed step with A = 2;
  * ``local_rows`` rows and a batch whose rows do not divide by A times
    the data ranks raising, naming both numbers.
"""
import dataclasses
import os
import pickle
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_tp_ckpt import _Mesh  # noqa: E402
from test_torch_tp_train import STEP_OPT, _collect, _launch  # noqa: E402

ACCUM = 2
BATCH, SEQ = 8, 32
MESHES = ((2, 1), (4, 1), (2, 2))
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
PACKED_MESHES = ((2, 1), (4, 1))
#: the capacity-binding case of the MoE layer (ROADMAP Queue 3)
TIGHT = dict(capacity_factor=0.5, router_aux_coef=10.0)
CASES = {"moe": ("qwen3_moe_235b_a22b", TIGHT), "dense": ("deepseek_7b", {})}
PACK_SPEC = dict(tile=(16, 16), sparsity=0.5, prune="tied", fuse_qkv=True,
                 backend="plan_pallas", targets=("attn/wq", "attn/wo"))
PACKED_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
DEADLINE_S = 300

RANK_PROGRAM = textwrap.dedent('''
    import dataclasses, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.tree import at_path, flatten_with_path, unflatten
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.sharding import local_rows, local_shard
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    ROUTES = None
    _route = moe_mod.route

    def recording_route(router, x2, cfg):
        """moe.route, recording the rows it routes and its dispatch."""
        out = _route(router, x2, cfg)
        if ROUTES is not None:
            ROUTES.append({"x": x2.detach().numpy().copy(),
                           "sorted_e": out[3].numpy().copy(),
                           "pos": out[5].numpy().copy()})
        return out
    moe_mod.route = recording_route

    def cfg_of(case):
        arch, over = IN["cases"][case]
        return dataclasses.replace(get_config(arch, smoke=True), **over)

    def rows(batch, mesh):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                for k, v in local_rows(batch, mesh, IN["accum"]).items()}

    def step_case(case, mesh):
        """The mesh step with grad_accum on this rank's rows of each
        microbatch: its metrics, its rows and the MoE calls it made."""
        global ROUTES
        cfg = cfg_of(case)
        whole = params_from_numpy(IN["params"][case])
        opt = AdamWConfig(**IN["step_opt"])
        step = make_train_step(cfg, opt, grad_accum=IN["accum"], mesh=mesh)
        coord = {a: mesh.coord(a) for a in mesh.axis_names}
        params = unflatten(whole, [
            local_shard(x, at_path(step.plan.specs, p), mesh, coord).clone()
            for p, x in flatten_with_path(whole)])
        batch = rows(IN["batch"], mesh)
        ROUTES = []
        _, _, m = step(params, init_opt_state(params, opt), batch)
        routes, ROUTES = ROUTES, None
        return {"metrics": {k: float(v) for k, v in m.items()},
                "tokens": batch["tokens"].numpy(), "routes": routes}

    def packed(mesh):
        """qwen3_moe's packed step (capacity binding) with grad_accum over
        dp: every rank the whole packs and its rows of each microbatch."""
        cfg = cfg_of("moe")
        sv = prepare_servable(params_from_numpy(IN["params"]["moe"]), cfg,
                              ServingSpec(**IN["pack_spec"]), device="cpu")
        opt = AdamWConfig(**IN["packed_opt"])
        step = make_train_step(cfg, opt, grad_accum=IN["accum"],
                               packs=sv.packs, mesh=mesh)
        _, _, m = step(sv.params, init_opt_state(sv.params, opt),
                       rows(IN["batch"], mesh))
        return {"metrics": {k: float(v) for k, v in m.items()},
                "packs": sorted(sv.packs)}

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for shape in IN["meshes"]:
            if shape[0] * shape[1] != world:
                continue
            mesh = init_process_mesh(shape)
            key = "x".join(map(str, shape))
            R["coord_" + key] = mesh.coordinate
            for case in IN["cases"]:
                R[f"{case}_{key}"] = step_case(case, mesh)
            if tuple(shape) in IN["packed_meshes"]:
                R["packed_" + key] = packed(mesh)
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _jax_accum_step(arch, jp, batch, over):
    """The JAX package's ``make_train_step(grad_accum=2)`` on one device:
    its loss and grad_norm (clipping binding)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jopt
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    jc = jopt.AdamWConfig(**STEP_OPT)
    step = jax.jit(jsteps.make_train_step(jcfg, jc, grad_accum=ACCUM))
    _, _, m = step(jp, jopt.init_opt_state(jp, jc),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _one_device(case, params, batch, packed=False):
    """The port's one-device step with grad_accum on the global batch:
    metrics and every MoE call's rows and dispatch (``packed``: the packed
    step of PACK_SPEC's servable)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    arch, over = CASES[case]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    p = params_from_numpy(params)
    packs = None
    opt = AdamWConfig(**(PACKED_OPT if packed else STEP_OPT))
    if packed:
        sv = prepare_servable(p, cfg, ServingSpec(**PACK_SPEC), device="cpu")
        p, packs = sv.params, sv.packs
    routes, route = [], moe_mod.route

    def recording(router, x2, c):
        out = route(router, x2, c)
        routes.append({"x": x2.detach().numpy().copy(),
                       "sorted_e": out[3].numpy().copy(),
                       "pos": out[5].numpy().copy()})
        return out
    moe_mod.route = recording
    try:
        step = make_train_step(cfg, opt, grad_accum=ACCUM, packs=packs)
        _, _, m = step(p, init_opt_state(p, opt), {
            k: torch.from_numpy(v).long() for k, v in batch.items()})
    finally:
        moe_mod.route = route
    return {"metrics": {k: float(v) for k, v in m.items()}, "routes": routes}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the parent's results, {world size: each rank's results})."""
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JPipeline
    from repro.models import init_model as j_init
    workdir = tmp_path_factory.mktemp("tp_train_accum")
    batch = {k: np.asarray(v, np.int32) for k, v in JPipeline(JDataConfig(
        seq_len=SEQ, global_batch=BATCH, vocab_size=512)).batch_at(0).items()}
    jparams, params = {}, {}
    for i, (case, (arch, over)) in enumerate(sorted(CASES.items())):
        jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
        jparams[case] = j_init(jax.random.PRNGKey(11 + i), jcfg)
        params[case] = jax.tree.map(np.asarray, jparams[case])
    IN = {"meshes": MESHES, "packed_meshes": PACKED_MESHES, "cases": CASES,
          "params": params, "batch": batch, "accum": ACCUM,
          "step_opt": STEP_OPT, "packed_opt": PACKED_OPT,
          "pack_spec": PACK_SPEC}
    for w in (2, 4):
        (workdir / f"w{w}").mkdir()
        with open(workdir / f"w{w}" / "inputs.pkl", "wb") as f:
            pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs4 = _launch(workdir / "w4", RANK_PROGRAM, 4)
    procs2 = _launch(workdir / "w2", RANK_PROGRAM, 2)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        parent = {"batch": batch, "jax": {}, "one": {}}
        for case, (arch, over) in CASES.items():
            parent["jax"][case] = _jax_accum_step(arch, jparams[case], batch,
                                                  over)
            parent["one"][case] = _one_device(case, params[case], batch)
        parent["packed"] = _one_device("moe", params["moe"], batch,
                                       packed=True)
        ranks = {4: _collect(procs4, workdir / "w4", t0, DEADLINE_S),
                 2: _collect(procs2, workdir / "w2", t0, DEADLINE_S)}
    except BaseException:
        for p in procs4 + procs2:
            p.kill()
        raise
    finally:
        torch.set_num_threads(n)
    return parent, ranks


def _key(shape):
    return "x".join(map(str, shape))


def _ranks(ranks, shape):
    return ranks[shape[0] * shape[1]]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_accum_step_matches_jax(world, case, shape):
    """The mesh step with grad_accum=2: loss and grad_norm within 1e-5
    relative of the JAX package's ``make_train_step(grad_accum=2)`` on one
    device (clipping binding), equal on every rank. In the MoE case the
    microbatches' routing binds capacity (assignments dropped), so a
    microbatch of other rows gives another step."""
    parent, ranks = world
    want = parent["jax"][case]
    res = _ranks(ranks, shape)
    assert want["grad_norm"] > 100 * STEP_OPT["clip_norm"]
    first = res[0][f"{case}_{_key(shape)}"]["metrics"]
    for r, rank in enumerate(res):
        got = rank[f"{case}_{_key(shape)}"]["metrics"]
        assert got == first, r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), r
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5), r


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_rank_takes_its_rows_of_each_microbatch(world, shape):
    """Data rank c of d holds, for each microbatch a, the rows
    [a B/A + c B/(A d), a B/A + (c+1) B/(A d)) of the global batch, in
    order; model ranks of one data coordinate hold the same rows."""
    parent, ranks = world
    tokens = parent["batch"]["tokens"]
    d = shape[0]
    per, sub = BATCH // ACCUM, BATCH // (ACCUM * d)
    for r, rank in enumerate(_ranks(ranks, shape)):
        c = rank["coord_" + _key(shape)][0]
        want = np.concatenate([tokens[a * per + c * sub:
                                      a * per + (c + 1) * sub]
                               for a in range(ACCUM)])
        for case in CASES:
            assert np.array_equal(rank[f"{case}_{_key(shape)}"]["tokens"],
                                  want), (r, case)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_moe_routes_the_references_microbatches(world, shape):
    """Every MoE call of the mesh step (forward and remat recompute, each
    microbatch) routes the rows one device routes for that microbatch:
    the rows gathered over "data" equal one device's microbatch rows in
    order (within 1e-5 of their max: the mesh's sums are ordered
    otherwise), and the dispatch (expert of each sorted assignment, its
    slot, capacity binding) equals one device's."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    parent, ranks = world
    cfg = dataclasses.replace(get_config(CASES["moe"][0], smoke=True),
                              **TIGHT)
    one = parent["one"]["moe"]["routes"]
    assert len(one) >= 2 * ACCUM
    t = BATCH // ACCUM * SEQ
    cap = capacity(t, cfg)
    assert all(rec["x"].shape[0] == t for rec in one)
    assert sum(int((rec["pos"] >= cap).sum()) for rec in one) > 0
    for r, rank in enumerate(_ranks(ranks, shape)):
        got = rank[f"moe_{_key(shape)}"]["routes"]
        assert len(got) == len(one), r
        for i, (a, b) in enumerate(zip(got, one)):
            np.testing.assert_allclose(
                a["x"], b["x"], rtol=0,
                atol=1e-5 * np.abs(b["x"]).max(),
                err_msg=f"rank {r} call {i}")
            assert np.array_equal(a["sorted_e"], b["sorted_e"]), (r, i)
            assert np.array_equal(np.minimum(a["pos"], cap),
                                  np.minimum(b["pos"], cap)), (r, i)


@pytest.mark.parametrize("shape", PACKED_MESHES,
                         ids=[_key(s) for s in PACKED_MESHES])
def test_dp_packed_accum_step_matches_one_device(world, shape):
    """The dp packed step with grad_accum=2 (qwen3_moe's attention
    projections packed, capacity binding): every rank its rows of each
    microbatch, the MoE routing the microbatch's global rows; loss and
    grad_norm equal on every rank and within 1e-5 relative of one
    device's packed step on the global batch."""
    parent, ranks = world
    want = parent["packed"]["metrics"]
    res = _ranks(ranks, shape)
    first = res[0]["packed_" + _key(shape)]
    assert first["packs"] and all("/attn/" in k for k in first["packs"])
    for r, rank in enumerate(res):
        got = rank["packed_" + _key(shape)]["metrics"]
        assert got == first["metrics"], r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), r
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5), r


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)],
                         ids=["2x1", "4x1", "2x2"])
def test_local_rows_with_accum_cut_each_microbatch(shape, accum):
    """``local_rows(batch, mesh, A)`` on every mesh position: data rank c
    takes its block of each microbatch's rows, every leaf alike; numpy
    arrays and tensors alike; A = 1 is the plain cut."""
    from repro_torch.launch.sharding import local_rows
    b = 16
    batch = {"tokens": np.arange(b * 3).reshape(b, 3),
             "frames": np.arange(b * 2 * 2, dtype=np.float32).reshape(
                 b, 2, 2)}
    d = shape[0]
    per, sub = b // accum, b // (accum * d)
    for c in range(d):
        for m in range(shape[1]):
            mesh = _Mesh(shape, (c, m))
            got = local_rows(batch, mesh, accum)
            tgot = local_rows({k: torch.from_numpy(v)
                               for k, v in batch.items()}, mesh, accum)
            for k, v in batch.items():
                want = np.concatenate([v[a * per + c * sub:
                                         a * per + (c + 1) * sub]
                                       for a in range(accum)])
                assert np.array_equal(got[k], want), k
                assert np.array_equal(tgot[k].numpy(), want), k
            plain = local_rows(batch, mesh, 1)
            assert np.array_equal(plain["tokens"],
                                  batch["tokens"][c * b // d:
                                                  (c + 1) * b // d])


@pytest.mark.parametrize("rows,accum,shape", [
    (6, 2, (4, 1)), (4, 4, (2, 2)), (12, 4, (2, 1)), (8, 3, (2, 1))])
def test_local_rows_raise_when_rows_do_not_divide(rows, accum, shape):
    """A batch whose B does not divide by A times the data ranks raises a
    ValueError naming B, A and their product with the data ranks (no
    rank's microbatch would be the reference's)."""
    from repro_torch.launch.sharding import local_rows
    batch = {"tokens": np.zeros((rows, 4), np.int32)}
    need = accum * shape[0]
    with pytest.raises(ValueError, match=rf"{rows} rows .*grad_accum "
                                         rf"{accum} .*\({need}\)"):
        local_rows(batch, _Mesh(shape, (0, 0)), accum)


def test_mesh_trainer_cuts_each_microbatch(tmp_path):
    """The mesh Trainer's batches (``Trainer.batch_at``) with
    ``grad_accum=2``: a rank's rows of each global microbatch, as
    ``local_rows(batch, mesh, 2)`` cuts them from one device's batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.train import TrainConfig, Trainer
    cfg = get_config("deepseek_7b", smoke=True)
    dcfg = DataConfig(seq_len=8, global_batch=8, vocab_size=cfg.vocab_size)
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path), grad_accum=2),
                 "cpu", dcfg, mesh=_Mesh((4, 1), (1, 0)))
    tr.pipeline = DataPipeline(dcfg)
    try:
        got = tr.batch_at(3)
        whole = tr.pipeline.batch_at(3)
    finally:
        tr.pipeline.close()
    for k, v in whole.items():
        want = np.concatenate([v[1:2], v[5:6]])
        assert np.array_equal(got[k].numpy(), want), k


def test_accum_sums_in_fp32_in_place_as_out_of_place():
    """One device's ``make_train_step(grad_accum=2)`` in bf16 adds each
    microbatch's bf16 gradients into fp32 sums in place (one fp32 copy of
    the gradients beside a microbatch's own): the update and metrics
    equal, bit for bit, the out-of-place fp32 sum of the microbatches'
    gradients divided by 2 and handed to ``adamw_update``."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.models.api import init_model
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_opt_state)
    cfg = dataclasses.replace(get_config("deepseek_7b", smoke=True),
                              dtype="bfloat16")
    params = init_model(5, cfg, device="cpu")
    opt = AdamWConfig(**STEP_OPT)
    rng = np.random.RandomState(7)
    batch = {k: torch.from_numpy(rng.randint(0, 512, (4, 16))).long()
             for k in ("tokens", "labels")}
    p1, _, m = make_train_step(cfg, opt, grad_accum=2)(
        params, init_opt_state(params, opt), batch)
    gs, losses = [], []
    for a in range(2):
        mb = {k: v[2 * a:2 * a + 2] for k, v in batch.items()}
        loss, _, g = value_and_grad(make_loss_fn(cfg), params, mb)
        gs.append([x.float() for x in leaves(g)])
        losses.append(loss)
    grads = unflatten(params, [(a + b) / 2 for a, b in zip(*gs)])
    want_p, _, om = adamw_update(grads, init_opt_state(params, opt), params,
                                 opt, cfg.sparsity)
    assert float(m["loss"]) == float((losses[0] + losses[1]) / 2)
    assert float(m["grad_norm"]) == float(om["grad_norm"])
    for x, y in zip(leaves(p1), leaves(want_p)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
