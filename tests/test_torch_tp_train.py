"""The mesh Trainer on the CPU: the port's training over ``torch.distributed``
(explicit SPMD, one process per mesh position) against the JAX reference's
train step on one device and against the port's single-device Trainer.

The reference cannot check its own mesh training on this host (its
``tests/test_train.py`` fails under an Explicit mesh, ROADMAP Queue 3), so
a mesh step is held against one device. The module starts world 4 ONCE
(four processes, gloo, ``file://`` init under the test's temporary
directory, 60 s collective timeouts, one torch thread each; they import no
JAX) and runs every case there over (4, 1), (1, 4) and (2, 2); the parent
computes the JAX side and the single-device runs meanwhile, then the
parametrised tests assert on the results, so each case still counts:

  * the differentiable collectives (``ProcessMesh.copy_to`` /
    ``reduce_from`` / ``gather_from`` / ``scatter_to`` / ``fsdp_gather``):
    forward and fp64 backward against their single-process equivalents;
  * one train step of the deepseek_7b, gemma3_4b and BERT smoke configs
    (fp32): every gathered gradient within 1e-5 of its leaf's max|g| of
    ``jax.value_and_grad`` of the reference's loss on the same weights,
    the loss and ``grad_norm`` within 1e-5 relative with ``clip_norm`` set
    so that clipping binds, the updated weights against the reference's
    ``adamw_update``, each rank's shards of ``shard_shape(spec)``, and the
    gradients of leaves replicated over "model" bitwise equal on every
    model rank;
  * gradual pruning with the group-lasso prox at 32 x 32 blocks where a
    rank's shard holds 16 rows (blocks straddle two shards): the mask of
    every step equal to one device's except at printed near-ties;
  * the reference's restart test on a mesh: a fault at step 7 against an
    uninterrupted run;
  * the collectives and a gemma3_4b step again through
    ``launch.staging.SharedStaging`` (the transport for ranks that share a
    card or host: buffers every rank maps; here files, in 4 KiB chunks).

A rank that fails or hangs fails the module: the collectives carry a 60 s
timeout and the parent kills the ranks after ``DEADLINE_S``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DEADLINE_S = 240
MESHES = ((4, 1), (1, 4), (2, 2))
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
ARCHS = ("deepseek_7b", "gemma3_4b", "bert_base")
FUNCTIONS = ("copy_to", "reduce_from", "gather_from", "scatter_to",
             "fsdp_gather")
#: AdamW for the one-step check: clip_norm far below the smoke grad norm
#: (~2), so the clip scale binds
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                weight_decay=0.01, clip_norm=1e-3)
#: the pruning runs: 32 x 32 blocks on 64-row weights cut 4 ways (16 rows
#: a rank over "model") or 2 ways
PRUNE = dict(block_shape=(32, 32), sparsity=0.5,
             targets=("attn/wq", "attn/wk", "attn/wv", "attn/wo"),
             lambda_reg=1e-2, start_step=1, end_step=4)
#: the same with the FFN's input projection pruned too: deepseek_7b smoke
#: stacks its 2 periods' FFN weights, and over (2, 2) the rule cuts that
#: period dim over "model", so a rank holds one period of each
PRUNE_FFN = dict(PRUNE, targets=PRUNE["targets"] + ("ffn/wi",))
PRUNE_STEPS = 6
#: (arch, mesh shape, what is pruned)
PRUNE_RUNS = (("deepseek_7b", (1, 4), "attn"), ("deepseek_7b", (2, 2), "attn"),
              ("bert_base", (1, 4), "attn"), ("deepseek_7b", (2, 2), "ffn"))
PRUNE_CFGS = {"attn": PRUNE, "ffn": PRUNE_FFN}
TRAIN_OPT = dict(peak_lr=5e-3, warmup_steps=2, total_steps=50,
                 weight_decay=0.0)
#: near-tie bar: a block whose mask differs from one device's must sit
#: within this relative margin of its leaf's quantile
NEAR_TIE = 1e-4


def _launch(workdir, program, world=WORLD):
    """``world`` rank processes running ``program`` (argv: rank, world,
    workdir), one torch thread each, the port on their path; each rank's
    output goes to ``<workdir>/log<r>.txt``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"log{r}.txt"), "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", program, str(r), str(world),
             str(workdir)], env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def _collect(procs, workdir, t0, deadline=DEADLINE_S):
    """Wait for every rank (killing them all past the deadline) and read
    their results; a rank's error fails the module with its traceback."""
    for p in procs:
        left = max(1.0, deadline - (time.perf_counter() - t0))
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            pytest.fail(f"a rank ran past {deadline} s; killed them all")
    out = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            with open(os.path.join(workdir, f"log{r}.txt"), "rb") as f:
                log = f.read().decode(errors="replace")[-4000:]
            pytest.fail(f"rank {r} exited {p.returncode} without results:\n"
                        f"{log}")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            pytest.fail(f"rank {r} failed:\n{res['error']}")
        out.append(res["ok"])
    return out


# The program each rank runs (``python -c``): the port alone, results
# pickled to <workdir>/rank<r>.pkl.
RANK_PROGRAM = textwrap.dedent('''
    import dataclasses, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import at_path, flatten_with_path, path_name
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.sharding import (local_rows, local_shard,
                                             shard_shape, whole_leaf)
    from repro_torch.launch.staging import install as install_staging
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                     FaultToleranceConfig)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    def whole(tree, specs, mesh):
        with torch.no_grad():
            return {path_name(p): whole_leaf(x, at_path(specs, p),
                                             mesh).numpy()
                    for p, x in flatten_with_path(tree)}

    def functions(mesh, axis):
        """Each differentiable collective in fp64: (output, x.grad)."""
        n, s = mesh.shape[axis], mesh.coord(axis)
        X = torch.from_numpy(IN["fn_x"])
        C = torch.from_numpy(IN["fn_c"])
        Cr = torch.from_numpy(IN["fn_cr"][s])
        Xr = torch.from_numpy(IN["fn_xr"][s])
        w1, w0 = X.shape[1] // n, X.shape[0] // n
        out = {}
        mesh.reset_stats()
        cases = {
            "copy_to": (X, lambda x: mesh.copy_to(x, axis), Cr),
            "reduce_from": (Xr, lambda x: mesh.reduce_from(x, axis), C),
            "gather_from": (X[:, s * w1:(s + 1) * w1],
                            lambda x: mesh.gather_from(x, axis, 1), C),
            "scatter_to": (X, lambda x: mesh.scatter_to(x, axis, 1),
                           Cr[:, s * w1:(s + 1) * w1]),
            "fsdp_gather": (X[s * w0:(s + 1) * w0],
                            lambda x: mesh.fsdp_gather(x, axis, 0), Cr),
        }
        for name, (x0, fn, up) in cases.items():
            x = x0.clone().requires_grad_(True)
            y = fn(x)
            (y * up).sum().backward()
            out[name] = (y.detach().numpy(), x.grad.numpy())
        out["stats"] = {k: v["calls"] for k, v in mesh.stats.items()}
        return out

    def embed_grads(mesh):
        """A bf16 table's gradient through ``embed_lookup`` on this mesh,
        gathered whole: with the Trainer's shard ('batch') and with the
        same shard marked not training ('plain': each rank adds its own
        rows' repeats, the data ranks' partials summed in fp32)."""
        from repro_torch.models.common import DenseShard, embed_lookup
        m = mesh.shape["model"]
        spec = ("model" if m > 1 else None, "data")
        coord = {a: mesh.coord(a) for a in mesh.axis_names}
        rows = local_rows({"t": IN["emb_t"], "c": IN["emb_c"]}, mesh)
        t = torch.from_numpy(rows["t"]).long()
        c = torch.from_numpy(rows["c"]).to(torch.bfloat16)
        table = torch.from_numpy(IN["emb_w"]).to(torch.bfloat16)
        out = {}
        for name, train in (("batch", True), ("plain", False)):
            shard = DenseShard("out" if m > 1 else None, mesh, -1,
                               train=train)
            w = local_shard(table, spec, mesh, coord).clone()
            w.requires_grad_(True)
            h = embed_lookup(shard.weight(w), t, shard)
            g, = torch.autograd.grad(h, w, c)
            with torch.no_grad():
                out[name] = whole_leaf(g, spec, mesh).float().numpy()
        return out

    def one_step(arch, mesh):
        cfg = get_config(arch, smoke=True)
        whole_p = params_from_numpy(IN["params"][arch])
        opt = AdamWConfig(**IN["step_opt"])
        step = make_train_step(cfg, opt, mesh=mesh)
        plan = step.plan
        coord = {a: mesh.coord(a) for a in mesh.axis_names}
        params = {}
        local = [(p, local_shard(x, at_path(plan.specs, p), mesh,
                                 coord).clone())
                 for p, x in flatten_with_path(whole_p)]
        from repro_torch.core.tree import unflatten
        params = unflatten(whole_p, [x for _, x in local])
        shapes = {path_name(p): (tuple(x.shape), shard_shape(
            tuple(at_path(plan.shapes, p).shape), at_path(plan.specs, p),
            mesh)) for p, x in local}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                 for k, v in local_rows(IN["batch"], mesh).items()}
        loss, metrics, grads = value_and_grad(make_loss_fn(cfg, None, plan),
                                              params, batch)
        grads = plan.sync_grads(grads)
        rep = {path_name(p): g.numpy().copy()
               for p, g in flatten_with_path(grads)
               if "model" not in at_path(plan.specs, p)}
        gwhole = whole(grads, plan.specs, mesh)
        p1, o1, m = step(params, init_opt_state(params, opt), batch)
        return {"loss": float(plan.mean(loss)), "grads": gwhole,
                "replicated_grads": rep, "metrics": {
                    k: float(v) for k, v in m.items()},
                "params": whole(p1, plan.specs, mesh),
                "m": whole(o1["m"], plan.specs, mesh), "shapes": shapes,
                "packs": {k: (type(v).__name__, getattr(v, "axis", None),
                              getattr(v, "data_dim", None))
                          for k, v in plan.packs.items()}}

    def trainer(arch, mesh, tmp, n_steps, prune=None, injector=None):
        sp = SparsityConfig(**prune) if prune else None
        cfg = get_config(arch, smoke=True)
        if sp is not None:
            cfg = dataclasses.replace(cfg, sparsity=sp)
        tcfg = TrainConfig(n_steps=n_steps, ckpt_dir=tmp, seed=1,
                           log_every=1, prune=sp is not None,
                           opt=AdamWConfig(**IN["train_opt"]),
                           ft=FaultToleranceConfig(checkpoint_every=4,
                                                   max_restarts=3))
        dcfg = DataConfig(seq_len=32, global_batch=4,
                          vocab_size=cfg.vocab_size)
        tr = Trainer(cfg, tcfg, "cpu", dcfg, fault_injector=injector,
                     mesh=mesh)
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
        specs = tr.plan.specs
        return {"hist": hist, "params": whole(state["params"], specs, mesh),
                "masks": masks, "restarts": tr.supervisor.restarts,
                "step": int(state["opt"]["step"])}

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for shape in IN["meshes"]:
            mesh = init_process_mesh(shape)
            key = "x".join(map(str, shape))
            R["coord_" + key] = mesh.coordinate
            if shape[1] == 1 or shape[0] == 1:
                axis = "data" if shape[1] == 1 else "model"
                R["fn_" + key] = functions(mesh, axis)
            R["emb_" + key] = embed_grads(mesh)
            for arch in IN["archs"]:
                R[f"step_{arch}_{key}"] = one_step(arch, mesh)
        for arch, shape, what in IN["prune_runs"]:
            mesh = init_process_mesh(tuple(shape))
            key = f"prune_{what}_{arch}_" + "x".join(map(str, shape))
            R[key] = trainer(arch, mesh, os.path.join(workdir, key),
                             IN["prune_steps"], IN["prune"][what])
        mesh = init_process_mesh((2, 2))
        R["clean"] = trainer("deepseek_7b", mesh,
                             os.path.join(workdir, "clean"), 10)
        R["faulted"] = trainer("deepseek_7b", mesh,
                               os.path.join(workdir, "faulted"), 10,
                               injector=FaultInjector(fail_at_steps=(7,)))
        # the same collectives through shared staging buffers (files under
        # the work dir; 4 KiB chunks, so every collective takes several)
        stage = os.path.join(workdir, "stage")
        os.makedirs(stage, exist_ok=True)
        for shape in IN["meshes"]:
            mesh = init_process_mesh(shape)
            install_staging(mesh, "host", stage, chunk_bytes=4096)
            key = "x".join(map(str, shape))
            if shape[1] == 1 or shape[0] == 1:
                axis = "data" if shape[1] == 1 else "model"
                R["staged_fn_" + key] = functions(mesh, axis)
            R["staged_step_" + key] = one_step("gemma3_4b", mesh)
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _jax_step(arch, jp, batch):
    """The reference on one device: loss, gradients, and the AdamW update
    on them (clip binding)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jopt
    jcfg = jax_config(arch, smoke=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), g = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    jc = jopt.AdamWConfig(**STEP_OPT)
    p1, o1, m = jopt.adamw_update(g, jopt.init_opt_state(jp, jc), jp, jc,
                                  jcfg.sparsity)
    return {"loss": float(loss), "grads": _named(g), "params": _named(p1),
            "m": _named(o1["m"]), "grad_norm": float(m["grad_norm"])}


def _named(tree):
    import jax
    from repro_torch.core.tree import flatten_with_path, path_name
    return {path_name(p): np.asarray(x) for p, x in
            flatten_with_path(jax.tree.map(np.asarray, tree))}


def _one_device_trainer(arch, tmp, n_steps, prune):
    """The port's single-device Trainer on the same seed and batches
    (``prune``: the SparsityConfig's fields, or None)."""
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import FaultToleranceConfig
    cfg = get_config(arch, smoke=True)
    if prune:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(**prune))
    tcfg = TrainConfig(n_steps=n_steps, ckpt_dir=str(tmp), seed=1,
                       log_every=1, prune=bool(prune),
                       opt=AdamWConfig(**TRAIN_OPT),
                       ft=FaultToleranceConfig(checkpoint_every=4))
    tr = Trainer(cfg, tcfg, "cpu", DataConfig(seq_len=32, global_batch=4,
                                              vocab_size=cfg.vocab_size))
    states, updated = [], []
    one, step_fn = tr._one_step, tr.step_fn

    def stepped(*args):
        # the weights the masks are scored on: after the update, before
        # the new masks zero their blocks
        params, opt, metrics = step_fn(*args)
        updated.append({path_name(p): x.numpy().copy() for p, x in
                        flatten_with_path(params)})
        return params, opt, metrics

    def recorded(state, step):
        state, metrics = one(state, step)
        states.append((step, updated[-1],
                       {path_name(p): m.numpy().copy() for p, m in
                        flatten_with_path(state["masks"] or {})}))
        return state, metrics
    tr.step_fn, tr._one_step = stepped, recorded
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, hist = tr.fit(resume=False)
    finally:
        torch.set_num_threads(n)
    return {"hist": hist, "states": states, "cfg": cfg,
            "params": {path_name(p): x.numpy() for p, x in
                       flatten_with_path(state["params"])}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the parent's results, each rank's results) of every case."""
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JPipeline
    from repro.models import init_model as j_init
    workdir = tmp_path_factory.mktemp("tp_train")
    rng = np.random.RandomState(0)
    params, jparams = {}, {}
    for i, arch in enumerate(ARCHS):
        jp = j_init(jax.random.PRNGKey(i), jax_config(arch, smoke=True))
        jparams[arch] = jp
        params[arch] = jax.tree.map(np.asarray, jp)
    batch = JPipeline(JDataConfig(seq_len=32, global_batch=4,
                                  vocab_size=512)).batch_at(0)
    IN = {"meshes": MESHES, "archs": ARCHS, "params": params,
          "batch": batch, "step_opt": STEP_OPT, "train_opt": TRAIN_OPT,
          "prune": PRUNE_CFGS, "prune_steps": PRUNE_STEPS,
          "prune_runs": PRUNE_RUNS,
          "emb_w": rng.randn(64, 8).astype(np.float32),
          "emb_t": np.where(rng.rand(4, 32) < 0.75, 3,
                            rng.randint(0, 64, (4, 32))),
          "emb_c": (0.01 * rng.randn(4, 32, 8)).astype(np.float32),
          "fn_x": rng.randn(8, 12), "fn_c": rng.randn(8, 12),
          "fn_cr": rng.randn(WORLD, 8, 12), "fn_xr": rng.randn(WORLD, 8, 12)}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs = _launch(workdir, RANK_PROGRAM)
    try:
        parent = {"jax": {arch: _jax_step(arch, jparams[arch], batch)
                          for arch in ARCHS}, "in": IN}
        for arch, what in sorted({(a, w) for a, _, w in PRUNE_RUNS}):
            parent[f"prune_{what}_{arch}"] = _one_device_trainer(
                arch, workdir / f"one_{what}_{arch}", PRUNE_STEPS,
                PRUNE_CFGS[what])
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return parent, _collect(procs, workdir, t0)


def _key(shape):
    return "x".join(map(str, shape))


# --------------------------------------------------------------------------
# the differentiable collectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4), (4, 1)], ids=["model", "data"])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_collective_function_matches_one_process(world, fn, shape):
    """Forward and fp64 backward of each collective over a 4-rank axis
    against what one process computes on the whole tensors: copy-to
    (identity; gradient summed), reduce-from (sum; gradient passed),
    gather-from (whole; own block of the gradient), scatter-to (own block;
    gradient gathered whole), FSDP's gather (whole; own block of the
    summed gradient)."""
    parent, ranks = world
    IN = parent["in"]
    axis = "model" if shape[0] == 1 else "data"
    X, C, Cr, Xr = IN["fn_x"], IN["fn_c"], IN["fn_cr"], IN["fn_xr"]
    csum = Cr.sum(axis=0)
    for r, res in enumerate(ranks):
        s = res["coord_" + _key(shape)][0 if axis == "data" else 1]
        y, g = res["fn_" + _key(shape)][fn]
        blk = slice(3 * s, 3 * (s + 1))
        want = {"copy_to": (X, csum),
                "reduce_from": (Xr.sum(axis=0), C),
                "gather_from": (X, C[:, blk]),
                "scatter_to": (X[:, blk],
                               np.concatenate([Cr[i][:, 3 * i:3 * (i + 1)]
                                               for i in range(4)], axis=1)),
                "fsdp_gather": (X, csum[2 * s:2 * (s + 1)])}[fn]
        np.testing.assert_allclose(y, want[0], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{fn} forward, rank {r}")
        np.testing.assert_allclose(g, want[1], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{fn} backward, rank {r}")
        stats = res["fn_" + _key(shape)]["stats"]
        op = {"copy_to": "all_reduce", "reduce_from": "all_reduce",
              "gather_from": "all_gather", "scatter_to": "all_gather",
              "fsdp_gather": "reduce_scatter"}[fn]
        assert stats.get(f"{op}:{axis}", 0) >= 1, stats


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)], ids=["model", "data"])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_staged_collective_function_matches_one_process(world, fn, shape):
    """The same checks with the mesh's collectives carried by
    ``SharedStaging`` (host files, 4 KiB chunks): the fp64 sums in group
    order, the gathers exact."""
    parent, ranks = world
    staged = [dict(r, **{"fn_" + _key(shape): r["staged_fn_" + _key(shape)]})
              for r in ranks]
    test_collective_function_matches_one_process((parent, staged), fn,
                                                 shape)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_staged_mesh_step_matches_jax(world, shape):
    """gemma3_4b smoke's step with every collective through
    ``SharedStaging`` (chunked): gradients, loss, grad_norm and the update
    against the reference as without it."""
    parent, ranks = world
    staged = [dict(r, **{f"step_gemma3_4b_{_key(shape)}":
                         r["staged_step_" + _key(shape)]}) for r in ranks]
    test_mesh_step_gradients_match_jax((parent, staged), "gemma3_4b", shape)
    test_mesh_step_update_matches_jax((parent, staged), "gemma3_4b", shape)


def test_staging_reinstalled_keeps_the_buffers_peers_read(tmp_path,
                                                           monkeypatch):
    """A rank that moves on to another mesh installs a new staging in the
    same directory and opens its buffers while a slower peer may still
    read the last collective's from the old one (no barrier between the
    two): the new staging maps files of its own, so the old buffers keep
    their bytes. Opening the old names truncated them to zeros, which read
    as one 4 KiB chunk of a staged step's gradient gone wrong under a
    loaded full test run."""
    import types

    import torch
    import torch.distributed as dist
    from repro_torch.launch.staging import SharedStaging

    def gather(out, obj, group=None):
        out[:] = [obj] * len(out)
    monkeypatch.setattr(dist, "all_gather_object", gather)
    mesh = types.SimpleNamespace(groups={"model": None}, shape={"model": 1},
                                 rank=0, coord=lambda axis: 0,
                                 transport=None)
    first = SharedStaging(mesh, "host", str(tmp_path), chunk_bytes=64)
    bufs = [first._step("model")[0] for _ in range(2)]
    for i, b in enumerate(bufs):
        b.fill_(7 + i)
    SharedStaging(mesh, "host", str(tmp_path), chunk_bytes=64)._step("model")
    assert [bool((b == 7 + i).all()) for i, b in enumerate(bufs)] == [
        True, True]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_mesh_embedding_gradient_adds_rows_as_one_device(world, shape):
    """A bf16 table whose row 3 three quarters of the tokens read: its
    gradient through the Trainer's shard on a mesh, gathered whole, equals
    one device's bit for bit (indexing's one-at-a-time bf16 adds, which the
    reference's ``jnp.take`` makes too: test_torch_tp_ckpt), on every
    rank. Where the data axis has more than one rank, the sum of each
    rank's own rows' partials ('plain') differs from it -- the case the
    whole-batch backward exists for."""
    parent, ranks = world
    IN = parent["in"]
    w = torch.from_numpy(IN["emb_w"]).to(torch.bfloat16).requires_grad_(True)
    c = torch.from_numpy(IN["emb_c"]).to(torch.bfloat16)
    want, = torch.autograd.grad(w[torch.from_numpy(IN["emb_t"]).long()], w,
                                c)
    want = want.float().numpy()
    for r, res in enumerate(ranks):
        got = res["emb_" + _key(shape)]
        assert np.array_equal(got["batch"], want), r
        if shape[0] > 1:
            assert not np.array_equal(got["plain"], want), r


# --------------------------------------------------------------------------
# one train step against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_gradients_match_jax(world, arch, shape):
    """Every gradient, gathered whole, within 1e-5 of its leaf's max|g| of
    jax.value_and_grad of the reference's loss on the same weights and
    batch (measured: <= 1e-6); the loss within 1e-5 relative; every rank's
    shards of ``shard_shape`` under the train-mode spec."""
    parent, ranks = world
    want = parent["jax"][arch]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(
                got["grads"][name], g, rtol=0,
                atol=1e-5 * max(np.abs(g).max(), 1e-30),
                err_msg=f"rank {r}: {name}")
        for name, (local, spec_shape) in got["shapes"].items():
            assert local == spec_shape, (r, name)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_update_matches_jax(world, arch, shape):
    """The whole step with clipping binding (clip_norm 1e-3 against a grad
    norm near 2): loss, ce and grad_norm equal on every rank and within
    1e-5 relative of the reference's; the updated weights and first
    moments against the reference's ``adamw_update`` on its own
    gradients: the moments within
    1e-5 relative + 1e-5 of the leaf's max, the weights within 1e-4 (a
    first Adam step moves each weight by ~lr = 1e-3 whatever its
    gradient's size; a sign taken the other way would be off by 2e-3)."""
    parent, ranks = world
    want = parent["jax"][arch]
    assert want["grad_norm"] > 100 * STEP_OPT["clip_norm"]
    first = ranks[0][f"step_{arch}_{_key(shape)}"]["metrics"]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        assert got["metrics"] == first, r
        assert got["metrics"]["loss"] == pytest.approx(want["loss"],
                                                       rel=1e-5)
        assert got["metrics"]["grad_norm"] == pytest.approx(
            want["grad_norm"], rel=1e-5)
        for name, w in want["m"].items():
            np.testing.assert_allclose(
                got["m"][name], w, rtol=1e-5,
                atol=1e-5 * max(np.abs(w).max(), 1e-30),
                err_msg=f"rank {r}: m {name}")
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0,
                                       atol=1e-4, err_msg=f"rank {r}: {name}")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaf_gradients_equal_across_model_ranks(world, arch,
                                                            shape):
    """A leaf the spec does not cut over "model" takes no model-axis
    reduce: the conjugate collectives leave its gradient whole and equal,
    bit for bit, on every rank of a model group (ranks that share a data
    coordinate). The plan's shard objects are one per cut linear weight
    or table."""
    parent, ranks = world
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
    kinds = ranks[0][f"step_{arch}_{key}"]["packs"]
    if shape[1] > 1:
        assert any(k == "DenseShard" and a == "out"
                   for k, a, _ in kinds.values()), kinds


# --------------------------------------------------------------------------
# the Trainer: pruning + prox on straddling shards, restart
# --------------------------------------------------------------------------

def _quantile_margin(norms, target):
    """|norm - q| / q of every block against its layer's quantile."""
    q = np.quantile(norms.reshape(-1).astype(np.float32), target)
    return np.abs(norms - q) / max(abs(q), 1e-30)


@pytest.mark.parametrize(
    "arch,shape,what", PRUNE_RUNS,
    ids=[f"{a}-{_key(s)}" + ("" if w == "attn" else f"-{w}")
         for a, s, w in PRUNE_RUNS])
def test_mesh_pruning_masks_equal_one_device(world, arch, shape, what):
    """Gradual pruning to 0.5 at 32 x 32 with the group-lasso prox on
    shards of 16 rows (1, 4) or 32 rows (2, 2) of 64-row weights: a block
    straddles shards, its norm is summed over them. With ``what`` 'ffn'
    the stacked FFN input projection is pruned too, which (2, 2) cuts over
    "model" along its period dim: each rank's periods sit at their offset
    in the whole leaf's grid, so no period's norms mix with another's.
    Every step's masks
    equal one device's except at near-ties -- a block whose one-device
    norm lies within NEAR_TIE of its layer's quantile, printed with its
    margin -- the per-step losses within 1e-5 relative and the final
    weights within 1e-4 (six Adam steps at lr 5e-3 move a weight ~1e-2
    whatever its gradient's size, so an element whose gradient sits near
    zero moves by amounts the order of the fp32 sums can change; measured
    up to 1.1e-5)."""
    from repro_torch.core.pruner import cubic_sparsity
    from repro_torch.core.sparsity import SparsityConfig
    parent, ranks = world
    one = parent[f"prune_{what}_{arch}"]
    sp = SparsityConfig(**PRUNE_CFGS[what])
    params_at = {step: p for step, p, _ in one["states"]}
    masks_at = {step: m for step, _, m in one["states"]}
    for r, res in enumerate(ranks):
        got = res[f"prune_{what}_{arch}_{_key(shape)}"]
        assert len(got["masks"]) == PRUNE_STEPS
        np.testing.assert_allclose([x for _, x in got["hist"]],
                                   [x for _, x in one["hist"]], rtol=1e-5)
        for step, masks in got["masks"]:
            assert sorted(masks) == sorted(masks_at[step]), step
            if what == "ffn":
                assert any("ffn/wi" in name for name in masks), sorted(masks)
            for name, m in masks.items():
                want = masks_at[step][name]
                diff = np.argwhere(m != want)
                if not len(diff):
                    continue
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
        for name, w in one["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0,
                                       atol=1e-4, err_msg=name)


def test_mesh_restart_reproduces_uninterrupted_run(world):
    """The reference's restart test on a (2, 2) mesh: deepseek_7b smoke,
    10 steps, checkpoints every 4, a fault at step 7 on every rank (all
    restore the step-4 checkpoint rank 0 wrote) against an uninterrupted
    run on the same mesh: final weights within 2e-5."""
    _, ranks = world
    for res in ranks:
        clean, faulted = res["clean"], res["faulted"]
        assert clean["restarts"] == 0 and faulted["restarts"] == 1
        assert clean["step"] == faulted["step"] == 10
        for name, w in clean["params"].items():
            np.testing.assert_allclose(faulted["params"][name], w,
                                       atol=2e-5, err_msg=name)
        assert sorted({s for s, _ in faulted["hist"]}) == list(range(10))
