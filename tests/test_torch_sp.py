"""The sequence-parallel batch on the CPU: a global batch of one row whose S
the dp axes cut (the reference's ``batch_shardings`` SP branch), trained,
packed-trained and prefilled by the dense LM family and BERT on a mesh,
against the JAX package's steps on the whole (1, S) row on one device.

GSPMD keeps one device's math, so the parity target of an SP step is the
reference's own step on the whole row. The module starts ONE world of four
gloo ranks (``file://`` init under the test's temporary directory, 60 s
collective timeouts, one torch thread a rank, no JAX) and runs every case
over (4, 1) and (2, 2) on ("data", "model") and (2, 2, 1) on ("pod",
"data", "model"); the parent computes the JAX side and the one-device runs
meanwhile, then the parametrised tests assert on the results:

  * one fp32 train step of the deepseek_7b, gemma3_4b, chatglm3_6b
    (partial rotary) and BERT smoke configs on a (1, 160) row -- a rank's
    block 40 or 80 positions, so gemma3's 32-wide windows (32-position
    chunks) straddle the blocks and start off the chunk grid: the loss,
    every gradient and the moments within 1e-5 of the reference's
    ``jax.value_and_grad`` + ``adamw_update`` (clipping binding), the
    updated weights too but for AdamW's near-zero-gradient elements
    (``_close_update``), equal metrics on every rank, every attention
    call the path one device takes for the whole row, at the rank's
    offset;
  * attention alone at S 1280 (flash, and the local band) and BERT's
    non-causal attention at S 2080 (flash): a block's output and input
    gradients against one device's;
  * a bf16 table's embedding gradient through the Trainer's shard,
    bitwise one device's;
  * the prefill step: every rank returns the reference's greedy token, and
    the last rank's last-position logits are the reference's;
  * BERT's packed step (K1 / K4 / K5's plain versions on the CPU) over
    (4, 1) and (2, 2, 1) against one device's packed step on the row;
  * ``Trainer.fit`` over (2, 2) on ``DataConfig(global_batch=1)`` against
    one device's Trainer;
  * the dry-run's collective counts of an SP train and prefill cell
    against the real run, rank by rank.

One process: ``batch_shardings``' SP leaves, ``local_rows``, and the
families whose SP batch is later work (ROADMAP Queue 1 item 8 parts 6b and
6c) raising, as ``grad_accum`` > 1 on one row does.
"""
import contextlib
import pickle
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_tp_train import (TRAIN_OPT, _collect,  # noqa: E402
                                 _launch, _named)

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
MESHES = ((4, 1), (2, 2), (2, 2, 1))
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
ARCHS = ("deepseek_7b", "gemma3_4b", "chatglm3_6b", "bert_base")
#: the row: dp 4 -> blocks of 40 positions, dp 2 -> 80; gemma3 smoke's
#: local layers have a 32-wide window and 32-position chunks
SEQ = 160
#: the packed BERT step's meshes (no model axis) and steps
PACKED_MESHES = ((4, 1), (2, 2, 1))
PACK_SPEC = dict(tile=(16, 16), prune="none", fuse_qkv=True,
                 cross_layer_union=True, backend="plan_pallas")
PRUNE = dict(block_shape=(16, 16), sparsity=0.5,
             targets=("attn/wq", "attn/wk", "attn/wv", "attn/wo"))
PACKED_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
PACKED_STEPS = 2
#: the Trainer run over (2, 2)
TRAIN_STEPS = 2
#: attention alone: (name, causal, window, S)
ATTN_CASES = (("flash", True, 0, 1280), ("local", True, 32, 1280),
              ("bert_flash", False, 0, 2080))
#: the dry-run's cells: (kind, mesh)
STAT_CASES = (("train", (2, 2)), ("train", (2, 2, 1)), ("prefill", (2, 2)))
DEADLINE_S = 240
#: AdamW for the one-step check: clip_norm below the smoke grad norms
#: (~1-3), so the clip scale binds, and the clipped gradients far above
#: AdamW's eps, whose neighbourhood amplifies any rounding of a gradient
#: into its update
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                weight_decay=0.01, clip_norm=0.1)

RANK_PROGRAM = textwrap.dedent('''
    import os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.tree import (at_path, flatten_with_path,
                                       path_name, unflatten)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.dryrun import cell_step
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.sharding import (local_rows, local_shard,
                                             whole_leaf)
    from repro_torch.launch.steps import (make_loss_fn, make_prefill_step,
                                          make_train_step, sequence_shard,
                                          value_and_grad)
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import api as model_api
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.common import DenseShard, embed_lookup
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    from repro_torch.serving.servable import (_exec_packs, _local_params,
                                              serving_param_shardings)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    CALLS = None

    def recording(name, fn):
        def run(q, k, v, **kw):
            if CALLS is not None:
                CALLS.append((name, q.shape[1], k.shape[1],
                              kw.get("q_offset", 0), kw.get("window", 0)))
            return fn(q, k, v, **kw)
        return run
    for _n in ("full_attention", "local_attention", "flash_attention"):
        setattr(attn_mod, _n, recording(_n, getattr(attn_mod, _n)))

    def coord_of(mesh):
        return {a: mesh.coord(a) for a in mesh.axis_names}

    def whole(tree, specs, mesh):
        with torch.no_grad():
            return {path_name(p): whole_leaf(x, at_path(specs, p),
                                             mesh).numpy()
                    for p, x in flatten_with_path(tree)}

    def tensors(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                for k, v in batch.items()}

    def one_step(arch, mesh):
        global CALLS
        cfg = get_config(arch, smoke=True)
        whole_p = params_from_numpy(IN["params"][arch])
        seq = sequence_shard(cfg, IN["batch"], mesh)
        opt = AdamWConfig(**IN["step_opt"])
        step = make_train_step(cfg, opt, mesh=mesh, packs={"seq": seq})
        plan, coord = step.plan, coord_of(mesh)
        params = unflatten(whole_p, [
            local_shard(x, at_path(plan.specs, p), mesh, coord).clone()
            for p, x in flatten_with_path(whole_p)])
        batch = tensors(local_rows(IN["batch"], mesh))
        loss_fn, seen = make_loss_fn(cfg, {"seq": seq}, plan), []

        def recorded(p, b):
            # the forward's calls (not the backward's recompute)
            global CALLS
            CALLS = []
            try:
                return loss_fn(p, b)
            finally:
                seen.append(CALLS)
                CALLS = None
        loss, _, grads = value_and_grad(recorded, params, batch)
        calls, = seen
        grads = plan.sync_grads(grads)
        p1, o1, m = step(params, init_opt_state(params, opt), batch)
        return {"loss": float(plan.mean(loss)),
                "grads": whole(grads, plan.specs, mesh),
                "metrics": {k: float(v) for k, v in m.items()},
                "params": whole(p1, plan.specs, mesh),
                "m": whole(o1["m"], plan.specs, mesh),
                "tokens": batch["tokens"].numpy(), "calls": calls,
                "seq": (seq.offset, seq.block, seq.length, seq.axes)}

    def prefill(arch, mesh):
        cfg = get_config(arch, smoke=True)
        whole_p = params_from_numpy(IN["params"][arch])
        specs = serving_param_shardings(whole_p, {}, mesh)
        params = _local_params(whole_p, specs, mesh)
        packs = _exec_packs({}, params, specs, cfg, mesh)
        tokens = {"tokens": IN["batch"]["tokens"]}
        packs["seq"] = sequence_shard(cfg, tokens, mesh)
        rows = tensors(local_rows(tokens, mesh))
        with torch.no_grad():
            logits, _ = model_api.model_forward(params, cfg, rows,
                                                packs=packs, last_only=True)
        nxt = make_prefill_step(cfg, packs)(params, rows)
        return {"next": nxt.numpy(), "last": packs["seq"].last,
                "logits": None if logits is None else
                logits[:, -1].numpy()}

    def attention(mesh):
        """Each ATTN_CASES layer on the rank's block of the parent's x:
        the output, the gradients of x and of the projections, and the
        attention function called."""
        global CALLS
        out = {}
        for name, causal, window, s in IN["attn_cases"]:
            cfg = get_config("bert_base" if not causal else "gemma3_4b",
                             smoke=True)
            p = {k: {"w": torch.from_numpy(w).requires_grad_(True)}
                 for k, w in IN["attn_w"][name].items()}
            seq = sequence_shard(cfg, {"tokens": np.zeros((1, s))}, mesh)
            lo, hi = seq.offset, seq.offset + seq.block
            x = torch.from_numpy(IN["attn_x"][name][:, lo:hi]
                                 ).requires_grad_(True)
            pos = seq.positions(hi - lo, "cpu")[None]
            CALLS = []
            y, _ = attn_mod.apply_attention(p, x, cfg, positions=pos,
                                            window=window, causal=causal,
                                            seq=seq)
            calls, CALLS = CALLS, None
            ct = torch.from_numpy(IN["attn_ct"][name][:, lo:hi])
            gx, *gw = torch.autograd.grad(y, [x] + [p[k]["w"] for k in p],
                                          ct)
            gw = [mesh.all_reduce(g, seq.axes) for g in gw]
            out[name] = {"y": y.detach().numpy(), "gx": gx.numpy(),
                         "gw": {k: g.numpy() for k, g in zip(p, gw)},
                         "calls": calls}
        return out

    def embed_grads(mesh):
        """A bf16 table's gradient through the Trainer's shard (the rank
        its block of the row's tokens and cotangents), gathered whole."""
        m = mesh.shape["model"]
        spec = ("model" if m > 1 else None, "data")
        coord = coord_of(mesh)
        rows = local_rows({"t": IN["emb_t"], "c": IN["emb_c"]}, mesh)
        t = torch.from_numpy(rows["t"]).long()
        c = torch.from_numpy(rows["c"]).to(torch.bfloat16)
        table = torch.from_numpy(IN["emb_w"]).to(torch.bfloat16)
        shard = DenseShard("out" if m > 1 else None, mesh, -1, train=True)
        w = local_shard(table, spec, mesh, coord).clone().requires_grad_(True)
        g, = torch.autograd.grad(embed_lookup(shard.weight(w), t, shard), w,
                                 c)
        with torch.no_grad():
            # the step's sum over "pod" (the "data"-cut leaf's blocks
            # already hold their pod's sum): one value and zeros, exact
            g = mesh.all_reduce(g, tuple(a for a in mesh.axis_names
                                         if a == "pod"))
            return whole_leaf(g, spec, mesh).float().numpy()

    def packed(mesh):
        cfg = get_config("bert_base", smoke=True)
        sv = prepare_servable(params_from_numpy(IN["pruned"]), cfg,
                              ServingSpec(**IN["pack_spec"]), device="cpu")
        opt = AdamWConfig(**IN["packed_opt"])
        seq = sequence_shard(cfg, IN["packed_batches"][0], mesh)
        step = make_train_step(cfg, opt, mesh=mesh,
                               packs=dict(sv.packs, seq=seq))
        params, ost, hist = sv.params, init_opt_state(sv.params, opt), []
        for b in IN["packed_batches"]:
            b = tensors(local_rows(b, mesh))
            params, ost, m = step(params, ost, b)
            hist.append({k: float(v) for k, v in m.items()})
        return {"hist": hist, "rows": tuple(b["tokens"].shape),
                "n_packs": len(sv.packs),
                "params": {path_name(p): x.numpy()
                           for p, x in flatten_with_path(params)}}

    def trainer(mesh):
        cfg = get_config("gemma3_4b", smoke=True)
        tcfg = TrainConfig(n_steps=IN["train_steps"],
                           ckpt_dir=os.path.join(workdir, "ckpt"), seed=1,
                           log_every=1, opt=AdamWConfig(**IN["train_opt"]))
        tr = Trainer(cfg, tcfg, "cpu", DataConfig(
            seq_len=IN["seq"], global_batch=1, vocab_size=cfg.vocab_size),
            mesh=mesh)
        rows, step_fn = [], tr.step_fn

        def stepped(params, opt, batch):
            rows.append(tuple(batch["tokens"].shape))
            return step_fn(params, opt, batch)
        tr.step_fn = stepped
        state, hist = tr.fit(resume=False)
        return {"hist": hist, "params": whole(state["params"], tr.plan.specs,
                                              mesh), "rows": rows}

    gen = torch.Generator().manual_seed(rank)

    def make(shape, dtype):
        if dtype.is_floating_point:
            return (0.02 * torch.randn(shape, generator=gen)).to(dtype)
        return torch.zeros(shape, dtype=dtype)

    def stats(kind, mesh):
        cfg = get_config("gemma3_4b", smoke=True)
        step, args, _ = cell_step(cfg, ShapeSpec("sp", IN["seq"], 1, kind),
                                  mesh, make=make)
        mesh.reset_stats()
        step(*args)
        return (mesh.coordinate, {
            k: {"calls": v["calls"], "bytes": v["bytes"]}
            for k, v in sorted(mesh.stats.items())})

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for shape in IN["meshes"]:
            mesh = init_process_mesh(shape, IN["axes"][len(shape)])
            key = "x".join(map(str, shape))
            R["coord_" + key] = mesh.coordinate
            for arch in IN["archs"]:
                R[f"step_{arch}_{key}"] = one_step(arch, mesh)
                R[f"prefill_{arch}_{key}"] = prefill(arch, mesh)
            R["emb_" + key] = embed_grads(mesh)
            if shape in IN["packed_meshes"]:
                R["packed_" + key] = packed(mesh)
            if shape == (4, 1):
                R["attn"] = attention(mesh)
            if shape == (2, 2):
                R["trainer"] = trainer(mesh)
            for kind, s in IN["stat_cases"]:
                if s == shape:
                    R[f"stats_{kind}_{key}"] = stats(kind, mesh)
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
    on them (clipping binding)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jopt
    jcfg = jax_config(arch, smoke=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    jc = jopt.AdamWConfig(**STEP_OPT)
    p1, o1, m = jopt.adamw_update(g, jopt.init_opt_state(jp, jc), jp, jc,
                                  jcfg.sparsity)
    return {"loss": float(loss), "grads": _named(g), "params": _named(p1),
            "m": _named(o1["m"]), "grad_norm": float(m["grad_norm"])}


def _jax_prefill(arch, jp, tokens):
    """The reference's prefill step on the whole row, and its last
    position's logits."""
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import steps as jsteps
    from repro.models import model_forward
    jcfg = jax_config(arch, smoke=True)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, _ = model_forward(jp, jcfg, batch)
    return {"next": np.asarray(jsteps.make_prefill_step(jcfg)(jp, batch)),
            "logits": np.asarray(logits[:, -1], np.float32)}


@contextlib.contextmanager
def _recorded_calls():
    """The attention functions called meanwhile, as (function, query
    rows, keys, offset, window)."""
    from repro_torch.models import attention as attn_mod
    calls, saved = [], {}
    for n in ("full_attention", "local_attention", "flash_attention"):
        fn = saved[n] = getattr(attn_mod, n)

        def run(q, k, v, _n=n, _fn=fn, **kw):
            calls.append((_n, q.shape[1], k.shape[1], kw.get("q_offset", 0),
                          kw.get("window", 0)))
            return _fn(q, k, v, **kw)
        setattr(attn_mod, n, run)
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(attn_mod, n, fn)


def _one_device_calls(arch, params, batch):
    """The attention calls of one device's forward on the whole row."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import api
    with _recorded_calls() as calls, torch.no_grad():
        api.model_forward(params_from_numpy(params), get_config(
            arch, smoke=True), {"tokens": torch.from_numpy(
                batch["tokens"]).long()})
    return calls


def _attention_reference(rng):
    """ATTN_CASES' weights, inputs and cotangents, and one device's
    output and gradients."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    ws, xs, cts, want = {}, {}, {}, {}
    for name, causal, window, s in ATTN_CASES:
        cfg = get_config("bert_base" if not causal else "gemma3_4b",
                         smoke=True)
        hd = cfg.head_dim
        shapes = {"wq": (cfg.n_heads * hd, cfg.d_model),
                  "wk": (cfg.n_kv_heads * hd, cfg.d_model),
                  "wv": (cfg.n_kv_heads * hd, cfg.d_model),
                  "wo": (cfg.d_model, cfg.n_heads * hd)}
        ws[name] = {k: (0.3 * rng.randn(*v)).astype(np.float32)
                    for k, v in shapes.items()}
        xs[name] = rng.randn(1, s, cfg.d_model).astype(np.float32)
        cts[name] = rng.randn(1, s, cfg.d_model).astype(np.float32)
        p = {k: {"w": torch.from_numpy(w).requires_grad_(True)}
             for k, w in ws[name].items()}
        x = torch.from_numpy(xs[name]).requires_grad_(True)
        with _recorded_calls() as calls:
            y, _ = attn_mod.apply_attention(
                p, x, cfg, positions=torch.arange(s)[None], window=window,
                causal=causal)
        gx, *gw = torch.autograd.grad(y, [x] + [p[k]["w"] for k in p],
                                      torch.from_numpy(cts[name]))
        want[name] = {"y": y.detach().numpy(), "gx": gx.numpy(),
                      "gw": {k: g.numpy() for k, g in zip(p, gw)},
                      "calls": calls}
    return ws, xs, cts, want


def _packed_reference(batches):
    """BERT smoke pruned one-shot at 16 x 16, and one device's packed
    steps on the rows."""
    from repro_torch.bridge import params_to_numpy, params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import oneshot_prune
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import init_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    cfg = get_config("bert_base", smoke=True)
    pruned, _ = oneshot_prune(init_model(0, cfg, device="cpu"),
                              SparsityConfig(**PRUNE))
    pruned = params_to_numpy(pruned)
    sv = prepare_servable(params_from_numpy(pruned), cfg,
                          ServingSpec(**PACK_SPEC), device="cpu")
    opt = AdamWConfig(**PACKED_OPT)
    step = make_train_step(cfg, opt, packs=sv.packs)
    params, ost, hist = sv.params, init_opt_state(sv.params, opt), []
    for b in batches:
        params, ost, m = step(params, ost, {
            k: torch.from_numpy(v).long() for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()})
    return pruned, {"hist": hist, "n_packs": len(sv.packs),
                    "params": _named(params)}


def _one_device_trainer(tmp):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config("gemma3_4b", smoke=True)
    tcfg = TrainConfig(n_steps=TRAIN_STEPS, ckpt_dir=str(tmp), seed=1,
                       log_every=1, opt=AdamWConfig(**TRAIN_OPT))
    tr = Trainer(cfg, tcfg, "cpu", DataConfig(seq_len=SEQ, global_batch=1,
                                              vocab_size=cfg.vocab_size))
    state, hist = tr.fit(resume=False)
    return {"hist": hist, "params": _named(state["params"])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the parent's results, each rank's results) of every case."""
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JPipeline
    from repro.models import init_model as j_init
    workdir = tmp_path_factory.mktemp("sp")
    rng = np.random.RandomState(5)
    jparams, params = {}, {}
    for i, arch in enumerate(ARCHS):
        jparams[arch] = j_init(jax.random.PRNGKey(i),
                               jax_config(arch, smoke=True))
        params[arch] = jax.tree.map(np.asarray, jparams[arch])
    pipe = JPipeline(JDataConfig(seq_len=SEQ, global_batch=1,
                                 vocab_size=512))
    batch = pipe.batch_at(0)
    packed_batches = [pipe.batch_at(1 + i) for i in range(PACKED_STEPS)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pruned, one_packed = _packed_reference(packed_batches)
        attn_w, attn_x, attn_ct, attn_want = _attention_reference(rng)
    finally:
        torch.set_num_threads(n)
    IN = {"axes": AXES, "meshes": MESHES, "archs": ARCHS, "params": params,
          "batch": batch, "seq": SEQ, "step_opt": STEP_OPT,
          "train_opt": TRAIN_OPT, "train_steps": TRAIN_STEPS,
          "packed_meshes": PACKED_MESHES, "pack_spec": PACK_SPEC,
          "packed_opt": PACKED_OPT, "pruned": pruned,
          "packed_batches": packed_batches, "stat_cases": STAT_CASES,
          "attn_cases": ATTN_CASES, "attn_w": attn_w, "attn_x": attn_x,
          "attn_ct": attn_ct,
          "emb_w": rng.randn(64, 8).astype(np.float32),
          "emb_t": np.where(rng.rand(1, 128) < 0.75, 3,
                            rng.randint(0, 64, (1, 128))),
          "emb_c": (0.01 * rng.randn(1, 128, 8)).astype(np.float32)}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs = _launch(workdir, RANK_PROGRAM)
    torch.set_num_threads(1)
    try:
        parent = {
            "in": IN, "packed": one_packed, "attn": attn_want,
            "jax": {arch: _jax_step(arch, jparams[arch], batch)
                    for arch in ARCHS},
            "prefill": {arch: _jax_prefill(arch, jparams[arch],
                                           batch["tokens"])
                        for arch in ARCHS},
            "calls": {arch: _one_device_calls(arch, params[arch], batch)
                      for arch in ARCHS},
            "trainer": _one_device_trainer(workdir / "one")}
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
    """(dp index, dp size) of a rank, "pod" outermost."""
    coord = dict(zip(AXES[len(shape)], res["coord_" + _key(shape)]))
    sizes = dict(zip(AXES[len(shape)], shape))
    return (coord.get("pod", 0) * sizes["data"] + coord["data"],
            sizes.get("pod", 1) * sizes["data"])


def _close(got, want, what, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _lr_sum(opt, steps):
    from repro_torch.optim.adamw import AdamWConfig, lr_at
    return sum(float(lr_at(AdamWConfig(**opt), s)) for s in range(steps))


def _close_update(got, want, what, lr_sum):
    """Weights after AdamW steps, the mesh tests' bar
    (test_torch_tp_train_families): within 1e-4 but for at most one
    element in 10^4 of a leaf (at least one), and those within 2 x the
    summed learning rate ``lr_sum``. AdamW divides each gradient element
    by its own root mean square, so an element whose gradient is near zero
    turns a rounding of its gradient into a visible change of its update:
    the port's one device against the reference on these rows is 5.8e-5
    of a leaf's max off so (gemma3_4b smoke's norm2 scale, one element),
    where the moments agree within 1.2e-6."""
    gap = np.abs(got - want)
    off = np.argwhere(gap > 1e-4)
    assert len(off) <= max(1, gap.size // 10**4), (what, len(off))
    assert gap.max() <= 2 * lr_sum, (what, gap.max())


# --------------------------------------------------------------------------
# one train step against the reference on the whole row
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_step_gradients_match_jax(world, arch, shape):
    """Each rank holds its block of S of the row (dp index c of d:
    positions [c S/d, (c+1) S/d)); the loss (the dp ranks' mean of their
    blocks' means) within 1e-5 relative and every gradient, gathered
    whole, within 1e-5 of its leaf's max|g| of ``jax.value_and_grad`` of
    the reference's loss on the whole row on one device."""
    parent, ranks = world
    want = parent["jax"][arch]
    tokens = parent["in"]["batch"]["tokens"]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        c, d = _dp(res, shape)
        w = SEQ // d
        assert np.array_equal(got["tokens"], tokens[:, c * w:(c + 1) * w]), r
        assert got["seq"][:3] == (c * w, w, SEQ), r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), r
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            _close(got["grads"][name], g, f"rank {r}: {name}")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_step_update_matches_jax(world, arch, shape):
    """The whole step with clipping binding: loss and grad_norm equal on
    every rank and within 1e-5 relative of the reference's; the moments
    within 1e-5 of their leaf's max of the reference's ``adamw_update``
    and the updated weights as ``_close_update`` holds them."""
    parent, ranks = world
    want = parent["jax"][arch]
    assert want["grad_norm"] > 5 * STEP_OPT["clip_norm"]
    first = ranks[0][f"step_{arch}_{_key(shape)}"]["metrics"]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        assert got["metrics"] == first, r
        assert got["metrics"]["loss"] == pytest.approx(want["loss"],
                                                       rel=1e-5)
        assert got["metrics"]["grad_norm"] == pytest.approx(
            want["grad_norm"], rel=1e-5)
        for name, w in want["m"].items():
            _close(got["m"][name], w, f"rank {r}: m {name}")
        for name, w in want["params"].items():
            _close_update(got["params"][name], w, f"rank {r}: {name}",
                          _lr_sum(STEP_OPT, 1))


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_attention_takes_one_devices_path(world, arch, shape):
    """Every attention call of the forward is the function one device
    calls for that layer on the whole row (chosen by the row's length,
    not the block's), over the rank's block of queries against all S
    keys at the block's offset."""
    parent, ranks = world
    one = parent["calls"][arch]
    assert one
    for r, res in enumerate(ranks):
        calls = res[f"step_{arch}_{_key(shape)}"]["calls"]
        c, d = _dp(res, shape)
        w = SEQ // d
        want = [(n, w, SEQ, c * w, win) for n, _, _, _, win in one]
        assert calls == want, r
    if arch == "gemma3_4b":
        assert {n for n, *_ in one} == {"full_attention", "local_attention"}


@pytest.mark.parametrize("case", [c[0] for c in ATTN_CASES])
def test_sp_attention_block_matches_one_device(world, case):
    """Attention alone over (4, 1) on rows one device runs through flash
    (S 1280 causal; BERT's non-causal at S 2080) and the local band (S
    1280, window 32) -- a block of 320 / 520 rows takes that path, not
    the one its own length would choose: each block's output and the
    gradient of its input
    within 1e-5 of one device's rows, the projections' gradients summed
    over the ranks within 1e-5 of one device's (K / V's gradient comes
    back to the rank that projected it)."""
    parent, ranks = world
    want = parent["attn"][case]
    s = {c[0]: c[3] for c in ATTN_CASES}[case]
    name, = {n for n, *_ in want["calls"]}
    assert name == ("local_attention" if case == "local"
                    else "flash_attention")
    for r, res in enumerate(ranks):
        got = res["attn"][case]
        c, d = _dp(res, (4, 1))
        lo, hi = c * s // d, (c + 1) * s // d
        assert got["calls"] == [(n, hi - lo, s, lo, w)
                                for n, _, _, _, w in want["calls"]], r
        _close(got["y"], want["y"][:, lo:hi], f"rank {r} out")
        _close(got["gx"], want["gx"][:, lo:hi], f"rank {r} dx")
        for k, g in want["gw"].items():
            _close(got["gw"][k], g, f"rank {r} d{k}")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sp_embedding_gradient_adds_rows_as_one_device(world, shape):
    """A bf16 table whose row 3 three quarters of the row's tokens read:
    its gradient through the Trainer's shard, each rank holding its block
    of the row's tokens and cotangents, equals one device's bit for bit on
    every rank (the blocks gathered over the dp axes are the row's tokens
    in order)."""
    parent, ranks = world
    IN = parent["in"]
    w = torch.from_numpy(IN["emb_w"]).to(torch.bfloat16).requires_grad_(True)
    c = torch.from_numpy(IN["emb_c"]).to(torch.bfloat16)
    want, = torch.autograd.grad(w[torch.from_numpy(IN["emb_t"]).long()], w,
                                c)
    want = want.float().numpy()
    for r, res in enumerate(ranks):
        assert np.array_equal(res["emb_" + _key(shape)], want), r


# --------------------------------------------------------------------------
# the prefill step, the packed step, the Trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_prefill_token_equals_the_references(world, arch, shape):
    """The mesh servable's shards and the rank's block of the row: every
    rank returns the reference's greedy token (broadcast from the rank
    holding the last position), whose last-position logits are within
    1e-5 of the reference's; no other rank computes the head."""
    parent, ranks = world
    want = parent["prefill"][arch]
    n_last = 0
    for r, res in enumerate(ranks):
        got = res[f"prefill_{arch}_{_key(shape)}"]
        assert np.array_equal(got["next"], want["next"]), r
        c, d = _dp(res, shape)
        assert got["last"] == (c == d - 1), r
        if got["last"]:
            n_last += 1
            _close(got["logits"], want["logits"], f"rank {r} logits")
        else:
            assert got["logits"] is None, r
    assert n_last == len(ranks) // _dp(ranks[0], shape)[1]


@pytest.mark.parametrize("shape", PACKED_MESHES,
                         ids=[_key(s) for s in PACKED_MESHES])
def test_sp_packed_step_matches_one_device(world, shape):
    """BERT smoke's packed fine-tuning step (fused QKV and the FFN's
    packs through the plan kernels' plain versions) on the rank's block
    of each row: loss and grad_norm equal on every rank and within 1e-5
    relative of one device's packed step on the whole rows, the weights
    after the steps as ``_close_update`` holds them."""
    parent, ranks = world
    want = parent["packed"]
    first = ranks[0]["packed_" + _key(shape)]["hist"]
    for r, res in enumerate(ranks):
        got = res["packed_" + _key(shape)]
        _, d = _dp(res, shape)
        assert got["rows"] == (1, SEQ // d) and got["hist"] == first, r
        assert got["n_packs"] == want["n_packs"] > 0
        for g, w in zip(got["hist"], want["hist"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
        for name, w in want["params"].items():
            _close_update(got["params"][name], w, f"rank {r}: {name}",
                          _lr_sum(PACKED_OPT, PACKED_STEPS))


def test_sp_trainer_matches_one_device(world):
    """``Trainer.fit`` over (2, 2) with ``DataConfig(global_batch=1)``:
    each rank's batch is its (1, S/2) block, the losses one device's
    Trainer's within 1e-5 relative and the final weights as
    ``_close_update`` holds them."""
    parent, ranks = world
    want = parent["trainer"]
    for r, res in enumerate(ranks):
        got = res["trainer"]
        assert got["rows"] == [(1, SEQ // 2)] * TRAIN_STEPS, r
        assert [s for s, _ in got["hist"]] == [s for s, _ in want["hist"]]
        for (_, a), (_, b) in zip(got["hist"], want["hist"]):
            assert a == pytest.approx(b, rel=1e-5), r
        for name, w in want["params"].items():
            _close_update(got["params"][name], w, f"rank {r}: {name}",
                          _lr_sum(TRAIN_OPT, TRAIN_STEPS))


@pytest.mark.parametrize("kind,shape", STAT_CASES,
                         ids=[f"{k}-{_key(s)}" for k, s in STAT_CASES])
def test_sp_dry_mesh_counts_equal_a_real_run(world, kind, shape):
    """An SP cell of gemma3_4b smoke (a ``ShapeSpec`` of one row) traced
    on the dry mesh at each rank's coordinate counts every collective the
    real run makes, call for call and byte for byte, K / V's gathers over
    the dp axes among them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh, make_mesh
    _, ranks = world
    cfg = get_config("gemma3_4b", smoke=True)
    mesh = make_mesh(shape, AXES[len(shape)])
    for r, res in enumerate(ranks):
        coord, stats = res[f"stats_{kind}_{_key(shape)}"]
        got = dryrun.trace_cell(cfg, ShapeSpec("sp", SEQ, 1, kind),
                                ProcessMesh.dry(mesh, coord))["stats"]
        assert got == stats, (r, coord)
        assert stats["all_gather:data"]["calls"] >= 2 * cfg.n_layers, stats
        if len(shape) == 3:
            assert "all_gather:pod" in stats, stats


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------

#: families whose SP batch is later work, and their ROADMAP part
LATER = (("pixtral_12b", "6b"), ("qwen3_moe_235b_a22b", "6b"),
         ("deepseek_v2_lite_16b", "6b"), ("mamba2_780m", "6c"),
         ("recurrentgemma_9b", "6c"), ("whisper_base", "6c"))


def _dry(shape=(4, 1)):
    from repro_torch.launch.mesh import ProcessMesh, make_mesh
    return ProcessMesh.dry(make_mesh(shape, AXES[len(shape)]),
                           (0,) * len(shape))


@pytest.mark.parametrize("arch,part", LATER, ids=[a for a, _ in LATER])
def test_sp_batch_of_a_later_family_raises(arch, part, tmp_path):
    """An SP batch of the vlm, MoE and MLA families (part 6b) and of the
    ssm, hybrid and audio families (part 6c) raises a ValueError naming
    its part: through ``sequence_shard``, the mesh Trainer, a step given
    a ``SeqShard`` and the model's forward."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.steps import (make_prefill_step, make_train_step,
                                          sequence_shard)
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import api
    from repro_torch.models.common import SeqShard
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(arch, smoke=True)
    mesh = _dry()
    match = f"item 8 part {part}"
    with pytest.raises(ValueError, match=match):
        sequence_shard(cfg, {"tokens": np.zeros((1, 64))}, mesh)
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)), "cpu",
                DataConfig(seq_len=64, global_batch=1,
                           vocab_size=cfg.vocab_size), mesh=mesh)
    seq = SeqShard.of(mesh, 64)
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, AdamWConfig(), mesh=mesh, packs={"seq": seq})
    with pytest.raises(ValueError, match=match):
        make_prefill_step(cfg, {"seq": seq})
    with pytest.raises(ValueError, match=match):
        api.model_forward({}, cfg, {"tokens": torch.zeros((1, 16))},
                          packs={"seq": seq})


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_grad_accum_raises(arch, tmp_path):
    """``grad_accum`` 2 on a one-row batch raises, naming it: the
    reference reshapes the rows to (A, B/A), which one row cannot be."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.sharding import local_rows
    from repro_torch.launch.train import TrainConfig, Trainer
    cfg = get_config(arch, smoke=True)
    with pytest.raises(ValueError, match="grad_accum 2"):
        Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path), grad_accum=2),
                "cpu", DataConfig(seq_len=64, global_batch=1,
                                  vocab_size=cfg.vocab_size), mesh=_dry())
    with pytest.raises(ValueError, match="one row .*grad_accum 2"):
        local_rows({"tokens": np.zeros((1, 64))}, _dry(), 2)


@pytest.mark.parametrize("shape", MESHES + ((1, 4),),
                         ids=MESH_IDS + ["1x4"])
def test_sp_shard_of_a_global_batch(shape):
    """``sequence_shard`` reads the global batch: one row whose S divides
    the dp ranks is SP, at each rank's offset; B equal to the dp ranks
    (a local batch of one row too) and a mesh with one dp rank are not;
    ``local_rows`` cuts the row's S."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import ProcessMesh, make_mesh
    from repro_torch.launch.sharding import local_rows
    from repro_torch.launch.steps import sequence_shard
    cfg = get_config("deepseek_7b", smoke=True)
    mesh = make_mesh(shape, AXES[len(shape)])
    d = int(np.prod(shape[:-1]))
    row = {"tokens": np.arange(64).reshape(1, 64)}
    for r in range(mesh.size):
        coord = tuple(int(x) for x in np.unravel_index(r, shape))
        dry = ProcessMesh.dry(mesh, coord)
        seq = sequence_shard(cfg, row, dry)
        if d == 1:
            assert seq is None
            continue
        c = dry.coord(("pod", "data"))
        assert (seq.offset, seq.block, seq.length) == (c * 64 // d, 64 // d,
                                                       64)
        assert seq.last == (c == d - 1)
        assert np.array_equal(local_rows(row, dry)["tokens"],
                              row["tokens"][:, seq.offset:seq.offset
                                            + seq.block])
        assert sequence_shard(cfg, {"tokens": np.zeros((d, 64))}, dry) \
            is None
