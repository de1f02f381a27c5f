"""The pod axis on the CPU: data parallelism over ("pod", "data") in the
mesh runtime, against the JAX reference on one device and against the
port's one device.

The reference's rules treat "pod" as pure data parallelism: weights are
cut over "data" alone (so they are whole across pods), batch rows and
cache slots over the tuple ("pod", "data"), "pod" outermost. The module
starts ONE world of four gloo ranks (``file://`` init under the test's
temporary directory, 60 s collective timeouts, one torch thread a rank,
no JAX) and runs every case over (2, 2, 1) and (2, 1, 2) on the axes
("pod", "data", "model"); the parent computes the JAX side and the
one-device runs meanwhile, then the parametrised tests assert on the
results:

  * every collective over the tuple ("pod", "data") -- the sums, the
    max, the reduce-scatter, the gathers, the broadcast, a block, and the
    five differentiable ones -- forward and fp64 backward against one
    process on the whole tensors, the gathers bitwise in JAX's order
    (first axis outermost), once through the process group and once
    through ``launch.staging.SharedStaging`` (host files, 4 KiB chunks);
  * one fp32 train step of the deepseek_7b, gemma3_4b and BERT smoke
    configs: every gradient within 1e-5 of its leaf's max|g| of
    ``jax.value_and_grad`` of the reference's loss on one device, the
    loss and grad_norm within 1e-5 relative with clipping binding, the
    update against the reference's ``adamw_update``, the two pods'
    gradients bitwise equal;
  * qwen3_moe smoke in the capacity-binding case (capacity 0.5) with
    ``grad_accum=2`` against the reference's ``make_train_step(grad_accum
    =2)``: each rank its rows of each microbatch, every MoE call's rows
    gathered over the dp axes in the reference's order, the dispatch one
    device's;
  * the Trainer on (2, 2, 1) against one device's, its fault path against
    an uninterrupted run, and its checkpoint restored bitwise on (2, 2),
    (1, 4), (4, 1) and one device;
  * the dry-run's prefill and decode cell steps (``make_prefill_step`` /
    ``make_serve_step`` on the mesh servable's shards) against one
    device on the same weights and cache.
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
                                 _jax_step, _launch, _one_device_trainer)
from test_torch_tp_train_accum import (ACCUM, BATCH, SEQ,  # noqa: E402
                                       TIGHT, _jax_accum_step)
from test_torch_tp_train_accum import _one_device as _one_device_accum  # noqa: E402,E501

AXES = ("pod", "data", "model")
MESHES = ((2, 2, 1), (2, 1, 2))
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
ARCHS = ("deepseek_7b", "gemma3_4b", "bert_base")
#: every tuple-axis collective the tests hold against one process
FUNCTIONS = ("all_reduce", "all_max", "reduce_scatter", "all_gather",
             "broadcast", "block_of", "copy_to", "reduce_from",
             "gather_from", "scatter_to", "fsdp_gather")
#: the ProcessMesh op each function counts its transfers under
OPS = {"all_reduce": "all_reduce", "all_max": "all_max",
       "reduce_scatter": "reduce_scatter", "all_gather": "all_gather",
       "broadcast": "broadcast", "block_of": None,
       "copy_to": "all_reduce", "reduce_from": "all_reduce",
       "gather_from": "all_gather", "scatter_to": "all_gather",
       "fsdp_gather": "reduce_scatter"}
#: the Trainer runs: deepseek_7b smoke, checkpoints every 2, a fault at 3
TRAIN_STEPS, CKPT_EVERY, FAULT = 4, 2, 3
RESTORE_SHAPES = ((2, 2), (1, 4), (4, 1))
#: the serving cells: (4, 32) prompts; decode from a (4, 256) cache
#: prefilled with LEN tokens a slot
PREFILL_ARCHS = ("deepseek_7b", "gemma3_4b")
DECODE_ARCHS = ("deepseek_7b", "gemma3_4b", "qwen3_moe_235b_a22b")
SERVE_BATCH, SERVE_SEQ, CACHE_LEN, LEN = 4, 32, 256, 40
DEADLINE_S = 240

RANK_PROGRAM = textwrap.dedent('''
    import dataclasses, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.store import npz_mmap, spec_at
    from repro_torch.configs import get_config
    from repro_torch.core.tree import (at_path, flatten_with_path,
                                       map_with_path, path_name, unflatten)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import (axis_size, destroy_distributed,
                                         dp_axes, init_distributed,
                                         init_process_mesh)
    from repro_torch.launch.sharding import (batch_shardings, local_rows,
                                             local_shard, whole_leaf)
    from repro_torch.launch.staging import install as install_staging
    from repro_torch.launch.steps import (make_loss_fn, make_prefill_step,
                                          make_serve_step, make_train_step,
                                          value_and_grad)
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import api as model_api
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                     FaultToleranceConfig)
    from repro_torch.serving.servable import (_decode_packs, _exec_packs,
                                              _local_params,
                                              serving_param_shardings)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    AXES = IN["axes"]

    ROUTES = None
    _route = moe_mod.route

    def recording_route(router, x2, cfg):
        out = _route(router, x2, cfg)
        if ROUTES is not None:
            ROUTES.append({"x": x2.detach().numpy().copy(),
                           "sorted_e": out[3].numpy().copy(),
                           "pos": out[5].numpy().copy()})
        return out
    moe_mod.route = recording_route

    def coord_of(mesh):
        return {a: mesh.coord(a) for a in mesh.axis_names}

    def whole(tree, specs, mesh):
        with torch.no_grad():
            return {path_name(p): whole_leaf(x, at_path(specs, p),
                                             mesh).numpy()
                    for p, x in flatten_with_path(tree)}

    def local(whole_p, specs, mesh):
        coord = coord_of(mesh)
        return unflatten(whole_p, [
            local_shard(x, at_path(specs, p), mesh, coord).clone()
            for p, x in flatten_with_path(whole_p)])

    def functions(mesh):
        """Each collective over the dp tuple in fp64: (output, x.grad or
        None), and the stats keys it counted."""
        dp = dp_axes(mesh)
        n, s = axis_size(mesh, dp), mesh.coord(dp)
        X = torch.from_numpy(IN["fn_x"])
        C = torch.from_numpy(IN["fn_c"])
        Cr = torch.from_numpy(IN["fn_cr"][s])
        Xr = torch.from_numpy(IN["fn_xr"][s])
        w1, w0 = X.shape[1] // n, X.shape[0] // n
        cases = {
            "all_reduce": (Xr, lambda x: mesh.all_reduce(x, dp), None),
            "all_max": (Xr, lambda x: mesh.all_max(x, dp), None),
            "reduce_scatter": (Xr, lambda x: mesh.reduce_scatter(x, dp, 0),
                               None),
            "all_gather": (X[:, s * w1:(s + 1) * w1],
                           lambda x: mesh.all_gather(x, dp, dim=1), None),
            "broadcast": (Xr, lambda x: mesh.broadcast(x, dp, n - 1), None),
            "block_of": (X, lambda x: mesh.block_of(x, dp, 1), None),
            "copy_to": (X, lambda x: mesh.copy_to(x, dp), Cr),
            "reduce_from": (Xr, lambda x: mesh.reduce_from(x, dp), C),
            "gather_from": (X[:, s * w1:(s + 1) * w1],
                            lambda x: mesh.gather_from(x, dp, 1), C),
            "scatter_to": (X, lambda x: mesh.scatter_to(x, dp, 1),
                           Cr[:, s * w1:(s + 1) * w1]),
            "fsdp_gather": (X[s * w0:(s + 1) * w0],
                            lambda x: mesh.fsdp_gather(x, dp, 0), Cr),
        }
        out = {}
        for name, (x0, fn, up) in cases.items():
            mesh.reset_stats()
            x = x0.clone().requires_grad_(up is not None)
            y = fn(x)
            if up is not None:
                (y * up).sum().backward()
            out[name] = (y.detach().numpy().copy(),
                         None if up is None else x.grad.numpy(),
                         sorted(mesh.stats))
        # a bf16 sum over both axes travels as fp32 and rounds once
        b = torch.from_numpy(IN["fn_b"][s]).to(torch.bfloat16)
        out["bf16_sum"] = mesh.all_reduce(b, dp).float().numpy()
        return out

    def one_step(arch, mesh):
        cfg = get_config(arch, smoke=True)
        opt = AdamWConfig(**IN["step_opt"])
        step = make_train_step(cfg, opt, mesh=mesh)
        plan = step.plan
        params = local(params_from_numpy(IN["params"][arch]), plan.specs,
                       mesh)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                 for k, v in local_rows(IN["batch"], mesh).items()}
        loss, _, grads = value_and_grad(make_loss_fn(cfg, None, plan),
                                        params, batch)
        grads = plan.sync_grads(grads)
        local_g = {path_name(p): g.numpy().copy()
                   for p, g in flatten_with_path(grads)}
        gwhole = whole(grads, plan.specs, mesh)
        p1, o1, m = step(params, init_opt_state(params, opt), batch)
        return {"loss": float(plan.mean(loss)), "grads": gwhole,
                "local_grads": local_g, "rows": batch["tokens"].numpy(),
                "metrics": {k: float(v) for k, v in m.items()},
                "params": whole(p1, plan.specs, mesh),
                "m": whole(o1["m"], plan.specs, mesh)}

    def accum_step(mesh):
        global ROUTES
        cfg = dataclasses.replace(get_config("qwen3_moe_235b_a22b",
                                             smoke=True), **IN["tight"])
        opt = AdamWConfig(**IN["step_opt"])
        step = make_train_step(cfg, opt, grad_accum=IN["accum"], mesh=mesh)
        params = local(params_from_numpy(IN["moe_params"]), step.plan.specs,
                       mesh)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                 for k, v in local_rows(IN["accum_batch"], mesh,
                                        IN["accum"]).items()}
        ROUTES = []
        _, _, m = step(params, init_opt_state(params, opt), batch)
        routes, ROUTES = ROUTES, None
        return {"metrics": {k: float(v) for k, v in m.items()},
                "tokens": batch["tokens"].numpy(), "routes": routes}

    def serve_params(arch, mesh):
        cfg = get_config(arch, smoke=True)
        whole_p = params_from_numpy(IN["serve"][arch]["params"])
        specs = serving_param_shardings(whole_p, {}, mesh)
        params = _local_params(whole_p, specs, mesh)
        return cfg, params, _exec_packs({}, params, specs, cfg, mesh)

    def prefill(arch, mesh):
        cfg, params, packs = serve_params(arch, mesh)
        tokens = torch.from_numpy(IN["serve"][arch]["tokens"]).long()
        spec = batch_shardings({"tokens": tokens}, mesh)["tokens"]
        rows = local_shard(tokens, spec, mesh, coord_of(mesh))
        with torch.no_grad():
            logits, _ = model_api.model_forward(params, cfg,
                                                {"tokens": rows},
                                                packs=packs)
        nxt = make_prefill_step(cfg, packs)(params, {"tokens": rows})
        return {"logits": logits[:, -1].numpy(), "next": nxt.numpy(),
                "rows": rows.numpy()}

    def decode(arch, mesh):
        cfg, params, packs = serve_params(arch, mesh)
        ref = IN["serve"][arch]
        cache = model_api.init_cache(params_from_numpy(ref["params"]), cfg,
                                     IN["serve_batch"], IN["cache_len"])
        cache = map_with_path(lambda p, x: torch.from_numpy(
            ref["cache"][path_name(p)]), cache)
        cache = model_api.shard_cache(cache, cfg, mesh)
        token = torch.from_numpy(ref["token"])
        spec = batch_shardings({"t": token}, mesh)["t"]
        token = local_shard(token, spec, mesh, coord_of(mesh))
        if spec[0] is not None:
            packs = _decode_packs(packs)
        pos = torch.tensor(IN["len"], dtype=torch.int32)
        clone = map_with_path(lambda p, x: x.clone(), cache)
        with torch.no_grad():
            logits, _ = model_api.decode_step(params, clone, cfg, token, pos,
                                              packs=packs)
        nxt, cache = make_serve_step(cfg, packs)(params, cache, token, pos)
        return {"logits": logits[:, 0].numpy(), "next": nxt.numpy(),
                "cache": {path_name(p): x.numpy() for p, x in
                          flatten_with_path(cache)},
                "sharded": spec[0] is not None,
                "experts": sorted(k for k, v in packs.items()
                                  if type(v).__name__ == "ExpertShard"
                                  and v.gather_rows)}

    def trainer(mesh, ckpt_dir, injector=None, n_steps=None):
        cfg = get_config("deepseek_7b", smoke=True)
        tcfg = TrainConfig(n_steps=n_steps or IN["train_steps"],
                           ckpt_dir=ckpt_dir, seed=1, log_every=1,
                           opt=AdamWConfig(**IN["train_opt"]),
                           ft=FaultToleranceConfig(
                               checkpoint_every=IN["ckpt_every"],
                               max_restarts=3))
        dcfg = DataConfig(seq_len=32, global_batch=4,
                          vocab_size=cfg.vocab_size)
        return Trainer(cfg, tcfg, "cpu", dcfg, fault_injector=injector,
                       mesh=mesh)

    def fit(mesh, ckpt_dir, injector=None):
        tr = trainer(mesh, ckpt_dir, injector)
        state, hist = tr.fit(resume=False)
        return {"hist": hist, "restarts": tr.supervisor.restarts,
                "params": whole(state["params"], tr.plan.specs, mesh),
                "step": int(state["opt"]["step"])}

    def restored(mesh, ckpt_dir, step):
        """The checkpoint restored on this mesh: every leaf against its
        shard of the file's arrays, byte for byte."""
        tr = trainer(mesh, os.path.join(workdir, "scratch"))
        from repro_torch.checkpoint.store import CheckpointStore
        state = tr.restore_state(CheckpointStore(ckpt_dir), step,
                                 tr.init_state())
        arrays = npz_mmap(os.path.join(ckpt_dir, f"step_{step:09d}",
                                       "arrays.npz"))
        specs, coord = tr.specs(), coord_of(mesh)
        bad, n = [], 0
        for i, (p, x) in enumerate(flatten_with_path(state)):
            n += 1
            spec = spec_at(specs, p)
            arr = arrays[f"a{i}"]
            if spec:
                arr = local_shard(arr, spec, mesh, coord)
            got = x.detach().contiguous().numpy()
            if got.shape != arr.shape or got.tobytes() != \
                    np.ascontiguousarray(arr).tobytes():
                bad.append(path_name(p))
        return {"bad": bad, "n": n}

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for shape in IN["meshes"]:
            mesh = init_process_mesh(shape, AXES)
            key = "x".join(map(str, shape))
            R["coord_" + key] = mesh.coordinate
            R["fn_" + key] = functions(mesh)
            for arch in IN["archs"]:
                R[f"step_{arch}_{key}"] = one_step(arch, mesh)
            R["accum_" + key] = accum_step(mesh)
            for arch in IN["prefill_archs"]:
                R[f"prefill_{arch}_{key}"] = prefill(arch, mesh)
            for arch in IN["decode_archs"]:
                R[f"decode_{arch}_{key}"] = decode(arch, mesh)
        mesh = init_process_mesh((2, 2, 1), AXES)
        ckpt = os.path.join(workdir, "clean")
        R["clean"] = fit(mesh, ckpt)
        R["faulted"] = fit(mesh, os.path.join(workdir, "faulted"),
                           FaultInjector(fail_at_steps=(IN["fault"],)))
        R["restored_2x2x1"] = restored(mesh, ckpt, IN["train_steps"])
        for shape in IN["restore_shapes"]:
            R["restored_" + "x".join(map(str, shape))] = restored(
                init_process_mesh(shape, ("data", "model")), ckpt,
                IN["train_steps"])
        # the collectives once more through shared staging buffers (files
        # under the work dir, 4 KiB chunks)
        stage = os.path.join(workdir, "stage")
        os.makedirs(stage, exist_ok=True)
        for shape in IN["meshes"]:
            mesh = init_process_mesh(shape, AXES)
            install_staging(mesh, "host", stage, chunk_bytes=4096)
            R["staged_fn_" + "x".join(map(str, shape))] = functions(mesh)
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _serve_reference(arch, seed):
    """One device's side of the serving cells: seeded weights, the
    prompts' prefill logits, a (4, 256) cache prefilled with LEN tokens a
    slot, and the decode step from it (logits, next tokens, the cache
    after)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, map_with_path, \
        path_name
    from repro_torch.models import api
    cfg = get_config(arch, smoke=True)
    params = api.init_model(seed, cfg, device="cpu")
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ))
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (SERVE_BATCH, LEN))).long()
    token = rng.randint(0, cfg.vocab_size, (SERVE_BATCH, 1)).astype(np.int32)
    with torch.no_grad():
        logits, _ = api.model_forward(params, cfg, {
            "tokens": torch.from_numpy(tokens).long()})
        cache = api.init_cache(params, cfg, SERVE_BATCH, CACHE_LEN)
        _, cache = api.prefill_cache(params, cache, cfg, prompt)
        before = {path_name(p): x.numpy().copy()
                  for p, x in flatten_with_path(cache)}
        dlogits, cache = api.decode_step(
            params, cache, cfg, torch.from_numpy(token),
            torch.tensor(LEN, dtype=torch.int32))
    return {"params": map_with_path(lambda p, x: x.numpy(), params),
            "tokens": tokens, "prefill_logits": logits[:, -1].numpy(),
            "cache": before, "token": token,
            "decode_logits": dlogits[:, 0].numpy(),
            "cache_after": {path_name(p): x.numpy() for p, x in
                            flatten_with_path(cache)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the parent's results, each rank's results) of every case."""
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JPipeline
    from repro.models import init_model as j_init
    workdir = tmp_path_factory.mktemp("pod")
    rng = np.random.RandomState(3)
    jparams, params = {}, {}
    for i, arch in enumerate(ARCHS):
        jparams[arch] = j_init(jax.random.PRNGKey(i),
                               jax_config(arch, smoke=True))
        params[arch] = jax.tree.map(np.asarray, jparams[arch])
    jmoe = j_init(jax.random.PRNGKey(11), dataclasses.replace(
        jax_config("qwen3_moe_235b_a22b", smoke=True), **TIGHT))
    batch = JPipeline(JDataConfig(seq_len=32, global_batch=4,
                                  vocab_size=512)).batch_at(0)
    accum_batch = {k: np.asarray(v, np.int32) for k, v in JPipeline(
        JDataConfig(seq_len=SEQ, global_batch=BATCH,
                    vocab_size=512)).batch_at(0).items()}
    serve = {arch: _serve_reference(arch, 20 + i) for i, arch in
             enumerate(sorted(set(PREFILL_ARCHS) | set(DECODE_ARCHS)))}
    IN = {"axes": AXES, "meshes": MESHES, "archs": ARCHS, "params": params,
          "batch": batch, "step_opt": STEP_OPT, "train_opt": TRAIN_OPT,
          "moe_params": jax.tree.map(np.asarray, jmoe), "tight": TIGHT,
          "accum": ACCUM, "accum_batch": accum_batch,
          "prefill_archs": PREFILL_ARCHS, "decode_archs": DECODE_ARCHS,
          "serve": {a: {k: s[k] for k in ("params", "tokens", "cache",
                                          "token")}
                    for a, s in serve.items()},
          "serve_batch": SERVE_BATCH,
          "cache_len": CACHE_LEN, "len": LEN,
          "train_steps": TRAIN_STEPS, "ckpt_every": CKPT_EVERY,
          "fault": FAULT, "restore_shapes": RESTORE_SHAPES,
          "fn_x": rng.randn(8, 12), "fn_c": rng.randn(8, 12),
          "fn_cr": rng.randn(4, 8, 12), "fn_xr": rng.randn(4, 8, 12),
          "fn_b": rng.randn(4, 8, 12).astype(np.float32)}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs = _launch(workdir, RANK_PROGRAM)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        parent = {
            "in": IN, "workdir": workdir, "serve": serve,
            "jax": {arch: _jax_step(arch, jparams[arch], batch)
                    for arch in ARCHS},
            "jax_accum": _jax_accum_step("qwen3_moe_235b_a22b", jmoe,
                                         accum_batch, TIGHT),
            "one_accum": _one_device_accum(
                "moe", IN["moe_params"], accum_batch),
            "trainer": _one_device_trainer("deepseek_7b", workdir / "one",
                                           TRAIN_STEPS, None)}
        ranks = _collect(procs, workdir, t0, DEADLINE_S)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(n)
    return parent, ranks


def _key(shape):
    return "x".join(map(str, shape))


def _dp(res, shape):
    """(dp index, dp size) of a rank: pod outermost."""
    pod, data, _ = res["coord_" + _key(shape)]
    return pod * shape[1] + data, shape[0] * shape[1]


# --------------------------------------------------------------------------
# the collectives over ("pod", "data")
# --------------------------------------------------------------------------

def _want(fn, IN, s, n):
    """One process's (output, x.grad) of ``fn`` at dp index ``s`` of
    ``n``."""
    X, C, Cr, Xr = IN["fn_x"], IN["fn_c"], IN["fn_cr"], IN["fn_xr"]
    w1, w0 = 12 // n, 8 // n
    blk = slice(s * w1, (s + 1) * w1)
    xsum, csum = Xr[:n].sum(axis=0), Cr[:n].sum(axis=0)
    return {"all_reduce": (xsum, None),
            "all_max": (Xr[:n].max(axis=0), None),
            "reduce_scatter": (xsum[s * w0:(s + 1) * w0], None),
            "all_gather": (X, None),
            "broadcast": (Xr[n - 1], None),
            "block_of": (X[:, blk], None),
            "copy_to": (X, csum),
            "reduce_from": (xsum, C),
            "gather_from": (X, C[:, blk]),
            "scatter_to": (X[:, blk], np.concatenate(
                [Cr[i][:, i * w1:(i + 1) * w1] for i in range(n)], axis=1)),
            "fsdp_gather": (X, csum[s * w0:(s + 1) * w0])}[fn]


def _check_functions(world, fn, shape, prefix):
    parent, ranks = world
    IN = parent["in"]
    exact = fn in ("all_gather", "block_of", "broadcast", "gather_from",
                   "all_max")
    for r, res in enumerate(ranks):
        s, n = _dp(res, shape)
        y, g, keys = res[prefix + _key(shape)][fn]
        want_y, want_g = _want(fn, IN, s, n)
        if exact:
            assert np.array_equal(y, want_y), (fn, r)
        np.testing.assert_allclose(y, want_y, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{fn} forward, rank {r}")
        if want_g is not None:
            np.testing.assert_allclose(g, want_g, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{fn} backward, rank {r}")
        # one count an axis moved: "pod" always, "data" where it has ranks
        op = OPS[fn]
        want_keys = [] if op is None else sorted(
            f"{op}:{a}" for a in ("pod", "data")
            if dict(zip(AXES, shape))[a] > 1)
        assert set(want_keys) <= set(keys), (fn, r, keys)
        assert all(k.split(":")[1] in ("pod", "data") for k in keys), keys


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_dp_tuple_collective_matches_one_process(world, fn, shape):
    """Each collective over ("pod", "data") against one process on the
    whole tensors (fp64): the sums and the reduce-scatter within 1e-12
    (two sums, one an axis), the gathers, the block and the broadcast
    bitwise, in the tuple's row-major order (dp index = pod x data + data,
    JAX's), the backward of the differentiable ones their conjugate's
    forward. Each axis moved is counted under its own ``op:axis`` key."""
    _check_functions(world, fn, shape, "fn_")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_staged_dp_tuple_collective_matches_one_process(world, fn, shape):
    """The same through ``SharedStaging`` (host files, 4 KiB chunks): the
    tuple composes the per-axis staging buffers."""
    _check_functions(world, fn, shape, "staged_fn_")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_bf16_sum_over_both_axes_rounds_once(world, shape):
    """A bf16 all-reduce over ("pod", "data") sums in fp32 over both axes
    and rounds to bf16 once: the fp32 sum of the bf16 inputs, rounded."""
    parent, ranks = world
    b = torch.from_numpy(parent["in"]["fn_b"]).to(torch.bfloat16)
    for r, res in enumerate(ranks):
        _, n = _dp(res, shape)
        got = res["fn_" + _key(shape)]["bf16_sum"]
        want = b[:n].float().sum(0).to(torch.bfloat16).float().numpy()
        assert np.array_equal(got, want), r


# --------------------------------------------------------------------------
# one train step against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_pod_step_gradients_match_jax(world, arch, shape):
    """Every gradient, gathered whole, within 1e-5 of its leaf's max|g|
    of ``jax.value_and_grad`` of the reference's loss on one device (the
    mean over all four dp ranks, or both pods' two); the loss within 1e-5
    relative; each rank holds its dp rows of the global batch."""
    parent, ranks = world
    want = parent["jax"][arch]
    tokens = parent["in"]["batch"]["tokens"]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        s, n = _dp(res, shape)
        w = tokens.shape[0] // n
        assert np.array_equal(got["rows"], tokens[s * w:(s + 1) * w]), r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(
                got["grads"][name], g, rtol=0,
                atol=1e-5 * max(np.abs(g).max(), 1e-30),
                err_msg=f"rank {r}: {name}")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_pod_step_update_matches_jax(world, arch, shape):
    """The whole step with clipping binding: loss and grad_norm equal on
    every rank and within 1e-5 relative of the reference's; the moments
    and weights against the reference's ``adamw_update`` (as the one-pod
    mesh tests hold them)."""
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
def test_pods_hold_equal_gradients(world, arch, shape):
    """The rules cut no weight over "pod": the two ranks at the same
    (data, model) coordinate in the two pods hold the same shard of
    every gradient after ``sync_grads``, bit for bit."""
    _, ranks = world
    by_coord = {}
    for res in ranks:
        pod, data, model = res["coord_" + _key(shape)]
        by_coord.setdefault((data, model), []).append(
            res[f"step_{arch}_{_key(shape)}"]["local_grads"])
    assert all(len(v) == 2 for v in by_coord.values()), by_coord.keys()
    for a, b in by_coord.values():
        assert sorted(a) == sorted(b)
        for name, g in a.items():
            assert np.array_equal(b[name], g), name


# --------------------------------------------------------------------------
# MoE routing of the global batch with grad_accum
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_pod_accum_step_matches_jax(world, shape):
    """qwen3_moe smoke, capacity 0.5 (drops), ``grad_accum=2``: loss and
    grad_norm within 1e-5 relative of the reference's
    ``make_train_step(grad_accum=2)`` on one device, equal on every rank."""
    parent, ranks = world
    want = parent["jax_accum"]
    first = ranks[0]["accum_" + _key(shape)]["metrics"]
    for r, res in enumerate(ranks):
        got = res["accum_" + _key(shape)]["metrics"]
        assert got == first, r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), r
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5), r


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_pod_rank_takes_its_rows_of_each_microbatch(world, shape):
    """Dp rank c of d (c = pod x data + data) holds, for each microbatch
    a, the rows [a B/A + c B/(A d), a B/A + (c+1) B/(A d))."""
    parent, ranks = world
    tokens = parent["in"]["accum_batch"]["tokens"]
    for r, res in enumerate(ranks):
        c, d = _dp(res, shape)
        per, sub = BATCH // ACCUM, BATCH // (ACCUM * d)
        want = np.concatenate([tokens[a * per + c * sub:
                                      a * per + (c + 1) * sub]
                               for a in range(ACCUM)])
        assert np.array_equal(res["accum_" + _key(shape)]["tokens"],
                              want), r


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_pod_moe_routes_the_references_microbatches(world, shape):
    """Every MoE call routes the rows one device routes for that
    microbatch, gathered over ("pod", "data") in global row order (within
    1e-5 of their max), with one device's dispatch (capacity binding)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    parent, ranks = world
    cfg = dataclasses.replace(get_config("qwen3_moe_235b_a22b", smoke=True),
                              **TIGHT)
    one = parent["one_accum"]["routes"]
    t = BATCH // ACCUM * SEQ
    cap = capacity(t, cfg)
    assert len(one) >= 2 * ACCUM
    assert sum(int((rec["pos"] >= cap).sum()) for rec in one) > 0
    for r, res in enumerate(ranks):
        got = res["accum_" + _key(shape)]["routes"]
        assert len(got) == len(one), r
        for i, (a, b) in enumerate(zip(got, one)):
            assert a["x"].shape == b["x"].shape == (t, cfg.d_model)
            np.testing.assert_allclose(a["x"], b["x"], rtol=0,
                                       atol=1e-5 * np.abs(b["x"]).max(),
                                       err_msg=f"rank {r} call {i}")
            assert np.array_equal(a["sorted_e"], b["sorted_e"]), (r, i)
            assert np.array_equal(np.minimum(a["pos"], cap),
                                  np.minimum(b["pos"], cap)), (r, i)


# --------------------------------------------------------------------------
# the Trainer and its checkpoints
# --------------------------------------------------------------------------

def test_pod_trainer_matches_one_device(world):
    """``Trainer.fit`` on (2, 2, 1), deepseek_7b smoke, 4 steps: every
    step's loss within 1e-5 relative of one device's Trainer on the same
    seed and batches, the final weights within 1e-4, equal on every rank."""
    parent, ranks = world
    one = parent["trainer"]
    for r, res in enumerate(ranks):
        got = res["clean"]
        assert got["restarts"] == 0 and got["step"] == TRAIN_STEPS
        assert got["hist"] == ranks[0]["clean"]["hist"], r
        np.testing.assert_allclose([x for _, x in got["hist"]],
                                   [x for _, x in one["hist"]], rtol=1e-5)
        for name, w in one["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0,
                                       atol=1e-4, err_msg=name)


def test_pod_restart_reproduces_uninterrupted_run(world):
    """A fault at step 3 on every rank of (2, 2, 1): all restore the
    step-2 checkpoint rank 0 wrote; the final weights equal the
    uninterrupted run's."""
    _, ranks = world
    for res in ranks:
        clean, faulted = res["clean"], res["faulted"]
        assert faulted["restarts"] == 1 and faulted["step"] == TRAIN_STEPS
        for name, w in clean["params"].items():
            np.testing.assert_allclose(faulted["params"][name], w,
                                       atol=2e-5, err_msg=name)


@pytest.mark.parametrize("shape", ((2, 2, 1),) + RESTORE_SHAPES,
                         ids=["2x2x1"] + [_key(s) for s in RESTORE_SHAPES])
def test_pod_checkpoint_restores_bitwise(world, shape):
    """The (2, 2, 1) run's final checkpoint (rank 0 wrote whole leaves)
    restored on (2, 2, 1) itself, (2, 2), (1, 4) and (4, 1): every leaf of
    every rank bitwise its shard of the file; the file's meta records the
    pod mesh."""
    import json
    parent, ranks = world
    meta = json.loads((parent["workdir"] / "clean" /
                       f"step_{TRAIN_STEPS:09d}" / "meta.json").read_text())
    assert meta["mesh"]["shape"] == [2, 2, 1], meta["mesh"]
    assert meta["mesh"]["axes"] == list(AXES)
    for r, res in enumerate(ranks):
        got = res["restored_" + _key(shape)]
        assert not got["bad"] and got["n"] > 0, (r, got["bad"][:5])


def test_pod_checkpoint_restores_on_one_device(world, tmp_path):
    """The same checkpoint on one device: every leaf bitwise the file's."""
    from repro_torch.checkpoint.store import CheckpointStore, npz_mmap
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    parent, _ = world
    ckpt = parent["workdir"] / "clean"
    cfg = get_config("deepseek_7b", smoke=True)
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path), seed=1), "cpu",
                 DataConfig(seq_len=32, global_batch=4,
                            vocab_size=cfg.vocab_size))
    state = tr.restore_state(CheckpointStore(str(ckpt)), TRAIN_STEPS,
                             tr.init_state())
    arrays = npz_mmap(str(ckpt / f"step_{TRAIN_STEPS:09d}" / "arrays.npz"))
    n = 0
    for i, (p, x) in enumerate(flatten_with_path(state)):
        arr = arrays[f"a{i}"]
        got = x.contiguous().numpy()
        assert got.shape == arr.shape, p
        assert got.tobytes() == np.ascontiguousarray(arr).tobytes(), p
        n += 1
    assert n > 0


# --------------------------------------------------------------------------
# the dry-run's serving cells on a pod mesh
# --------------------------------------------------------------------------

def _rows_of(res, shape):
    s, n = _dp(res, shape)
    w = SERVE_BATCH // n
    return slice(s * w, (s + 1) * w)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_pod_prefill_cell_matches_one_device(world, arch, shape):
    """The prefill cell's step on the mesh servable's TP-only shards and
    this rank's rows (cut over ("pod", "data")): the last position's
    logits within 1e-5 of max|logits| of one device's rows, and the step's
    next tokens one device's."""
    parent, ranks = world
    ref = parent["serve"][arch]
    for r, res in enumerate(ranks):
        got = res[f"prefill_{arch}_{_key(shape)}"]
        rows = _rows_of(res, shape)
        assert np.array_equal(got["rows"], ref["tokens"][rows]), r
        want = ref["prefill_logits"][rows]
        np.testing.assert_allclose(got["logits"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {r}")
        assert np.array_equal(got["next"], want.argmax(-1)), r


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_pod_decode_cell_matches_one_device(world, arch, shape):
    """The decode cell's step on this rank's slots (cut over ("pod",
    "data")) and cache shard: logits within 1e-5 of max|logits| of one
    device's slots, the next tokens one device's, every cache leaf after
    the step within 1e-5 of one device's shard (the rank's slots, and its
    KV heads where "model" cuts them); a MoE layer gathers the step's rows
    over the dp axes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import cache_shardings, local_shard
    parent, ranks = world
    ref = parent["serve"][arch]
    cfg = get_config(arch, smoke=True)
    mesh = make_mesh(shape, AXES)
    for r, res in enumerate(ranks):
        got = res[f"decode_{arch}_{_key(shape)}"]
        assert got["sharded"], r
        if cfg.n_experts:
            assert got["experts"], r
        rows = _rows_of(res, shape)
        want = ref["decode_logits"][rows]
        np.testing.assert_allclose(got["logits"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {r}")
        assert np.array_equal(got["next"][:, 0], want.argmax(-1)), r
        coord = dict(zip(AXES, res["coord_" + _key(shape)]))
        specs = {k: cache_shardings({k: v}, mesh)[k]
                 for k, v in ref["cache_after"].items()}
        for name, whole in ref["cache_after"].items():
            shard = local_shard(whole, specs[name], mesh, coord)
            np.testing.assert_allclose(
                got["cache"][name], shard, rtol=0,
                atol=1e-5 * max(np.abs(whole).max(), 1e-30),
                err_msg=f"rank {r}: {name}")


# --------------------------------------------------------------------------
# rows over the dp tuple, without a process group
# --------------------------------------------------------------------------

class _PodMesh:
    """A (pod, data, model) mesh position without a process group."""

    def __init__(self, shape, coord):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self._coord = dict(zip(AXES, coord))

    def coord(self, axis):
        return self._coord[axis]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2), (2, 2, 2)],
                         ids=["2x2x1", "2x1x2", "2x2x2"])
def test_local_rows_cut_over_pod_then_data(shape, accum):
    """``local_rows`` on every position of a pod mesh: dp index
    pod x data + data takes its block of (each microbatch of) the rows;
    model ranks of one dp position take the same rows."""
    from repro_torch.launch.sharding import local_rows
    b = 16
    batch = {"tokens": np.arange(b * 3).reshape(b, 3)}
    p, d, m = shape
    n = p * d
    per, sub = b // accum, b // (accum * n)
    for pod in range(p):
        for data in range(d):
            for model in range(m):
                got = local_rows(batch, _PodMesh(shape, (pod, data, model)),
                                 accum)["tokens"]
                c = pod * d + data
                want = np.concatenate([batch["tokens"][a * per + c * sub:
                                                       a * per + (c + 1)
                                                       * sub]
                                       for a in range(accum)])
                assert np.array_equal(got, want), (pod, data, model)
