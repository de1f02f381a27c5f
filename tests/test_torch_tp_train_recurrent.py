"""The mesh Trainer on the ssm, hybrid and audio families, on the CPU:
mamba2_780m, recurrentgemma_9b and whisper_base smoke configs (fp32)
trained over ``torch.distributed`` (explicit SPMD, one process per mesh
position) against the JAX reference's train step on one device and against
the port's single-device Trainer.

The module starts world 4 ONCE (four processes, gloo, ``file://`` init
under the test's temporary directory, 60 s collective timeouts, one torch
thread each, a join deadline; they import no JAX) and runs every case there
over (4, 1), (1, 4) and (2, 2); the parent computes the JAX side and the
single-device runs meanwhile, then the parametrised tests assert on the
results, so each case still counts:

  * one train step on weights drawn by JAX and brought over by
    ``bridge.py`` (whisper with encoder ``frames``), the per-head and
    per-channel vectors (SSD ``A_log`` / ``D`` / ``dt_bias``, conv biases,
    the gated norm's scale, the RG-LRU's ``lam``) redrawn so that they
    differ across a rank's blocks and the decays keep state: every
    gathered gradient within 1e-5 of its leaf's max|g| of
    ``jax.value_and_grad`` of the reference's loss, the loss and
    ``grad_norm`` within 1e-5 relative and equal on every rank, the
    gradients of leaves replicated over "model" bitwise equal on every
    model rank, each rank's shards of ``shard_shape``;
  * the blocks the layers compute on: SSD heads H/m, conv channels C/m,
    RG-LRU width W/m, attention heads (self and cross) H/m;
  * ``Trainer.fit`` of mamba2 and recurrentgemma against one device's
    Trainer, and two donated Trainer steps of whisper with frames (the
    data pipeline draws tokens only) against one device's;
  * recurrentgemma's dense FFN pruned at 32 x 32 over (1, 4) and (2, 2):
    every step's masks equal one device's except at near-ties;
  * each family's (2, 2) checkpoint restored bitwise at (1, 4) and on one
    device.
"""
import os
import pickle
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_tp_train import (TRAIN_OPT, _collect, _launch,  # noqa: E402
                                 _one_device_trainer, _quantile_margin)
from test_torch_tp_train_families import _jax_step  # noqa: E402

MESHES = ((4, 1), (1, 4), (2, 2))
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
ARCHS = ("mamba2_780m", "recurrentgemma_9b", "whisper_base")
FIT_ARCHS = ARCHS[:2]
FIT_STEPS = 2
BATCH, SEQ = 4, 32
#: recurrentgemma's dense FFN pruned: wi / wg (128, 64) and wo (64, 128)
#: a period; over (2, 2) the rule cuts the period axis of the stacked FFN
#: over "model" and ``a`` over "data"
PRUNE = dict(block_shape=(32, 32), sparsity=0.5,
             targets=("ffn/wi", "ffn/wg", "ffn/wo"),
             lambda_reg=1e-2, start_step=1, end_step=4)
PRUNE_STEPS = 5
PRUNE_MESHES = ((1, 4), (2, 2))
NEAR_TIE = 1e-4
DEADLINE_S = 300

RANK_PROGRAM = textwrap.dedent('''
    import os, pickle, sys, traceback
    sys.modules["jax"] = None
    import dataclasses
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.store import CheckpointStore, spec_at
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import (at_path, flatten_with_path,
                                       path_name, unflatten)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.sharding import (local_rows, local_shard,
                                             shard_shape, whole_leaf)
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.common import HeadShard
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    BLOCKS = None

    def recording(kind, fn, size):
        """``fn``, recording (kind, the size of the block it runs on)."""
        def run(*a, **kw):
            if BLOCKS is not None:
                BLOCKS.add((kind, size(*a)))
            return fn(*a, **kw)
        return run
    ssm_mod._ssd_chunked = recording("ssd heads", ssm_mod._ssd_chunked,
                                     lambda x, *a: x.shape[2])
    ssm_mod._causal_conv = recording("conv channels", ssm_mod._causal_conv,
                                     lambda x, *a: x.shape[-1])
    rglru_mod._conv = recording("rglru width", rglru_mod._conv,
                                lambda x, *a: x.shape[-1])
    rglru_mod.associative_scan = recording(
        "scan width", rglru_mod.associative_scan, lambda a, u: a.shape[-1])
    _local = HeadShard.local

    def local(self, q, k, v):
        out = _local(self, q, k, v)
        if BLOCKS is not None:
            BLOCKS.add(("heads", out[0].shape[2], out[1].shape[2]))
        return out
    HeadShard.local = local

    def key(shape):
        return "x".join(map(str, shape))

    def tensors(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            torch.float32 if k == "frames" else torch.int64)
            for k, v in batch.items()}

    def whole(tree, specs, mesh):
        with torch.no_grad():
            return {path_name(p): whole_leaf(x, at_path(specs, p),
                                             mesh).numpy()
                    for p, x in flatten_with_path(tree)}

    def one_step(arch, mesh):
        """One step's loss, gathered gradients, the replicated leaves'
        gradients, shard facts, the blocks computed on, and the whole
        train step's metrics."""
        global BLOCKS
        cfg = get_config(arch, smoke=True)
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
        batch = tensors(local_rows(IN["batch"][arch], mesh))
        BLOCKS = set()
        loss, _, grads = value_and_grad(make_loss_fn(cfg, None, plan),
                                        params, batch)
        blocks, BLOCKS = sorted(BLOCKS), None
        grads = plan.sync_grads(grads)
        rep = {path_name(p): g.numpy().copy()
               for p, g in flatten_with_path(grads)
               if "model" not in at_path(plan.specs, p)}
        gwhole = whole(grads, plan.specs, mesh)
        m = step(params, init_opt_state(params, opt), batch)[2]
        return {"loss": float(plan.mean(loss)), "grads": gwhole,
                "replicated_grads": rep, "blocks": blocks,
                "metrics": {k: float(v) for k, v in m.items()},
                "shapes": shapes,
                "packs": {k: (type(v).__name__, getattr(v, "n_heads", None),
                              getattr(v, "channels", None))
                          for k, v in plan.packs.items()
                          if type(v).__name__ != "DenseShard"}}

    def trainer(arch, mesh, tmp, n_steps, prune=None):
        sp = SparsityConfig(**prune) if prune else None
        cfg = get_config(arch, smoke=True)
        if sp is not None:
            cfg = dataclasses.replace(cfg, sparsity=sp)
        tcfg = TrainConfig(n_steps=n_steps, ckpt_dir=tmp, seed=1,
                           log_every=1, prune=sp is not None,
                           opt=AdamWConfig(**IN["train_opt"]))
        dcfg = DataConfig(seq_len=IN["seq"], global_batch=IN["batch_rows"],
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

    def audio_steps(mesh, tmp):
        """whisper's Trainer: its donated step on this rank's rows of the
        frame batches, then a checkpoint of the state."""
        tr = trainer("whisper_base", mesh, tmp, len(IN["audio_batches"]))
        state = tr.init_state()
        hist = []
        for i, b in enumerate(IN["audio_batches"]):
            p, o, m = tr.step_fn(state["params"], state["opt"],
                                 tensors(local_rows(b, mesh)))
            state = dict(state, params=p, opt=o)
            hist.append((i, float(m["loss"]), float(m["grad_norm"])))
        tr.save_state(tr.store, len(hist), state)
        tr.store.wait()
        return tr, state, {"hist": hist,
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

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for shape in IN["meshes"]:
            mesh = init_process_mesh(shape)
            k = key(shape)
            R["coord_" + k] = mesh.coordinate
            for arch in IN["archs"]:
                R[f"step_{arch}_{k}"] = one_step(arch, mesh)
            ck = os.path.join(workdir, "ckpt_" + k)
            for arch in IN["fit_archs"]:
                tr, state, R[f"fit_{arch}_{k}"] = fit(
                    arch, mesh, ck + arch, IN["fit_steps"])
                if shape == (2, 2):
                    R["ckpt_whole_" + arch] = gathered(tr, state)
            tr, state, R["fit_whisper_base_" + k] = audio_steps(
                mesh, ck + "whisper_base")
            if shape == (2, 2):
                R["ckpt_whole_whisper_base"] = gathered(tr, state)
        for shape in IN["prune_meshes"]:
            mesh = init_process_mesh(shape)
            _, _, R["prune_" + key(shape)] = fit(
                "recurrentgemma_9b", mesh,
                os.path.join(workdir, "prune_" + key(shape)),
                IN["prune_steps"], IN["prune"])
        # each family's (2, 2) checkpoint restored on (1, 4)
        mesh = init_process_mesh((1, 4))
        for arch in IN["archs"]:
            tr = trainer(arch, mesh, os.path.join(workdir, "x"), 2)
            got = tr.restore_state(
                CheckpointStore(os.path.join(workdir, "ckpt_2x2" + arch)),
                2, tr.init_state())
            R["ckpt_1x4_" + arch] = mismatches(tr, got,
                                               R["ckpt_whole_" + arch])
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _per_channel(tree, seed):
    """The recurrent mixers' per-head and per-channel vectors made to
    differ across a rank's blocks and to matter: the init's SSD ``A_log``
    / ``dt_bias`` (zeros), ``D`` (ones), the conv biases and the gated
    norm's scale (zeros) are the same for every channel, and the RG-LRU's
    ``lam`` (~4) makes a = exp(-8 softplus(lam) r) ~ 1e-7, so h forgets
    every step; drawn here so that a rank cutting another block's values,
    or a lost state, changes the loss and the gradients."""
    import jax
    rng = np.random.RandomState(seed)

    def one(path, x):
        names = [str(getattr(k, "key", "")) for k in path]
        key = names[-1]
        if key == "A_log":
            return (0.5 * rng.randn(*x.shape)).astype(x.dtype)
        if key in ("D", "dt_bias", "conv_b") or (
                key == "scale" and "mixer" in names):
            return (x + 0.5 * rng.randn(*x.shape)).astype(x.dtype)
        if key == "lam":
            return (x - 8.0).astype(x.dtype)      # a ~ 0.9 at r = 0.5
        return x
    return jax.tree_util.tree_map_with_path(one, tree)


def _audio_batches(n_ctx, d):
    """whisper's Trainer batches: pipeline tokens with seeded frames."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    pipe = DataPipeline(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                   vocab_size=512))
    rng = np.random.RandomState(5)
    out = []
    for i in range(FIT_STEPS):
        b = dict(pipe.batch_at(i))
        b["frames"] = rng.randn(BATCH, n_ctx, d).astype(np.float32)
        out.append(b)
    pipe.close()
    return out


def _one_device_audio(batches, ckpt_dir):
    """One device's whisper Trainer steps on the same batches; and the
    (2, 2) checkpoint restored by a one-device Trainer (whole state by
    name, meta) -- read after the ranks have written it."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config("whisper_base", smoke=True)
    tr = Trainer(cfg, TrainConfig(n_steps=FIT_STEPS, ckpt_dir=ckpt_dir,
                                  seed=1, opt=AdamWConfig(**TRAIN_OPT)),
                 "cpu", DataConfig(seq_len=SEQ, global_batch=BATCH,
                                   vocab_size=cfg.vocab_size))
    state, hist = tr.init_state(), []
    for i, b in enumerate(batches):
        p, o, m = tr.step_fn(state["params"], state["opt"], {
            k: torch.from_numpy(v).to(torch.float32 if k == "frames"
                                      else torch.int64)
            for k, v in b.items()})
        state = dict(state, params=p, opt=o)
        hist.append((i, float(m["loss"]), float(m["grad_norm"])))
    return {"hist": hist, "params": {path_name(p): x.numpy() for p, x in
                                     flatten_with_path(state["params"])}}


def _restore_one_device(arch, ckpt_dir, tmp):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(arch, smoke=True)
    tr = Trainer(cfg, TrainConfig(n_steps=2, ckpt_dir=str(tmp), seed=1,
                                  opt=AdamWConfig(**TRAIN_OPT)),
                 "cpu", DataConfig(seq_len=SEQ, global_batch=BATCH,
                                   vocab_size=cfg.vocab_size))
    store = CheckpointStore(ckpt_dir)
    state = tr.restore_state(store, 2, tr.init_state())
    return ({path_name(p): x.numpy() for p, x in flatten_with_path(state)},
            store.meta(2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the parent's results, each rank's results) of every case."""
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JPipeline
    from repro.models import init_model as j_init
    from test_torch_tp_train import STEP_OPT
    workdir = tmp_path_factory.mktemp("tp_train_recurrent")
    rng = np.random.RandomState(0)
    tokens = {k: np.asarray(v, np.int32) for k, v in JPipeline(JDataConfig(
        seq_len=SEQ, global_batch=BATCH, vocab_size=512)).batch_at(0).items()}
    params, jparams, batches = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_config(arch, smoke=True)
        jp = _per_channel(jax.jit(lambda key, c=jcfg: j_init(key, c))(
            jax.random.PRNGKey(20 + i)), 30 + i)
        jparams[arch] = jp
        params[arch] = jax.tree.map(np.asarray, jp)
        batches[arch] = dict(tokens)
        if jcfg.family == "audio":
            batches[arch]["frames"] = rng.randn(
                BATCH, jcfg.n_audio_ctx, jcfg.d_model).astype(np.float32)
    wcfg = jax_config("whisper_base", smoke=True)
    audio = _audio_batches(wcfg.n_audio_ctx, wcfg.d_model)
    IN = {"meshes": MESHES, "archs": ARCHS, "fit_archs": FIT_ARCHS,
          "params": params, "batch": batches, "step_opt": STEP_OPT,
          "train_opt": TRAIN_OPT, "fit_steps": FIT_STEPS, "seq": SEQ,
          "batch_rows": BATCH, "audio_batches": audio, "prune": PRUNE,
          "prune_steps": PRUNE_STEPS, "prune_meshes": PRUNE_MESHES}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs = _launch(workdir, RANK_PROGRAM)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        parent = {"jax": {}, "fit": {}}
        for arch in ARCHS:
            parent["jax"][arch] = _jax_step(arch, jparams[arch],
                                            batches[arch])
        for arch in FIT_ARCHS:
            parent["fit"][arch] = _one_device_trainer(
                arch, workdir / f"one_{arch}", FIT_STEPS, None)
        parent["fit"]["whisper_base"] = _one_device_audio(
            audio, str(workdir / "one_whisper_base"))
        parent["prune"] = _one_device_trainer(
            "recurrentgemma_9b", workdir / "one_prune", PRUNE_STEPS, PRUNE)
        ranks = _collect(procs, workdir, t0, DEADLINE_S)
        parent["ckpt_one"] = {
            arch: _restore_one_device(arch, str(workdir / ("ckpt_2x2" + arch)),
                                      workdir / f"restore_{arch}")
            for arch in ARCHS}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(n)
    return parent, ranks


def _key(shape):
    return "x".join(map(str, shape))


# --------------------------------------------------------------------------
# one train step against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_gradients_match_jax(world, arch, shape):
    """Every gradient, gathered whole, within 1e-5 of its leaf's max|g| of
    jax.value_and_grad of the reference's loss on the same weights and
    batch (whisper's with ``frames``, cut by ``local_rows``); the loss
    within 1e-5 relative on every rank; every rank's shards of
    ``shard_shape`` under the train-mode spec."""
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
def test_mesh_step_metrics_match_jax(world, arch, shape):
    """The whole step with clipping binding: loss, ce and grad_norm equal
    on every rank, the loss and grad_norm within 1e-5 relative of the
    reference's."""
    from test_torch_tp_train import STEP_OPT
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
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaf_gradients_equal_across_model_ranks(world, arch,
                                                            shape):
    """A leaf the spec does not cut over "model" (the per-head and
    per-channel vectors a rank cuts its block of, norm scales, a
    replicated projection) takes no model-axis reduce: its gradient is
    whole and equal, bit for bit, on every rank of a model group."""
    _, ranks = world
    key = _key(shape)
    groups = {}
    for res in ranks:
        groups.setdefault(res["coord_" + key][0], []).append(
            res[f"step_{arch}_{key}"]["replicated_grads"])
    for members in groups.values():
        for name, g in members[0].items():
            for other in members[1:]:
                assert np.array_equal(other[name], g), name
    names = set(groups[0][0])
    want = {"mamba2_780m": ("A_log", "D", "dt_bias", "conv_b"),
            "recurrentgemma_9b": ("lam", "conv_b"),
            "whisper_base": ("norm_x",)}[arch]
    for w in want:
        assert any(w in n for n in names), (w, sorted(names))


#: {arch: {mesh "model" size: the blocks the layers compute on}}
BLOCKS = {
    "mamba2_780m": lambda m: {("ssd heads", 8 // m),
                              ("conv channels", 160 // m)},
    "recurrentgemma_9b": lambda m: {("rglru width", 64 // m),
                                    ("scan width", 64 // m)},
    "whisper_base": lambda m: {("heads", 4 // m, 4 // m)} if m > 1
    else set(),
}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_layers_compute_on_their_blocks(world, arch, shape):
    """Over a model axis of m ranks each rank's SSD runs over H/m heads
    and its conv over C/m channels (an ``SSDHeadShard`` and a
    ``ChannelShard`` a layer), its RG-LRU conv and scan over W/m of the
    width (a ``ChannelShard``), its self- and cross-attention over H/m
    heads (one ``HeadShard`` for the decoder's two); recurrentgemma's
    local attention (one KV head) gets no head shard and runs whole."""
    _, ranks = world
    m = shape[1]
    for r, res in enumerate(ranks):
        got = res[f"step_{arch}_{_key(shape)}"]
        assert set(got["blocks"]) == BLOCKS[arch](m), (r, got["blocks"])
        kinds = {k.rsplit("/", 1)[-1]: v for k, v in got["packs"].items()}
        if m == 1:
            assert not got["packs"], got["packs"]
        elif arch == "mamba2_780m":
            assert kinds == {"heads": ("SSDHeadShard", 8, None),
                             "conv": ("ChannelShard", None, 160)}, kinds
        elif arch == "recurrentgemma_9b":
            assert kinds == {"width": ("ChannelShard", None, 64)}, kinds
        else:
            assert sorted(got["packs"]) == ["dec_layers/attn/heads",
                                            "dec_layers/xattn/heads",
                                            "enc_layers/attn/heads"]


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_trainer_trains_like_one_device(world, arch, shape):
    """``Trainer(mesh=).fit()`` for 2 steps (whisper: 2 of the Trainer's
    donated steps on frame batches): the losses within 1e-5 relative of
    one device's Trainer on the same seed and batches and equal on every
    rank; the final weights within 1e-4 but for at most one element in
    10^4 of a leaf (and at least one), and those within 2 x the summed
    learning rate (AdamW divides each element's gradient by its own RMS:
    a near-zero gradient moves by an amount the order of fp32 sums
    decides, as in the MoE families' test)."""
    from repro_torch.optim.adamw import AdamWConfig, lr_at
    parent, ranks = world
    one = parent["fit"][arch]
    opt = AdamWConfig(**TRAIN_OPT)
    bound = 2 * sum(float(lr_at(opt, s)) for s in range(FIT_STEPS))
    first = ranks[0][f"fit_{arch}_{_key(shape)}"]["hist"]
    for r, res in enumerate(ranks):
        got = res[f"fit_{arch}_{_key(shape)}"]
        assert got["hist"] == first, r
        assert [h[0] for h in got["hist"]] == list(range(FIT_STEPS))
        np.testing.assert_allclose([h[1] for h in got["hist"]],
                                   [h[1] for h in one["hist"]], rtol=1e-5)
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
def test_ffn_pruning_masks_equal_one_device(world, shape):
    """recurrentgemma smoke, 5 steps of gradual pruning to 0.5 at 32 x 32
    with the group-lasso prox on its dense FFN (geglu ``wi`` / ``wg`` /
    ``wo``, stacked a period; over (2, 2) the period axis cut over
    "model"): every step's whole masks equal one device's except at
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
            assert any("ffn/wg" in n for n in masks)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_checkpoint_restores_on_1x4(world, arch):
    """Each family's (2, 2) checkpoint (params and AdamW moments cut over
    both axes, per-channel leaves whole) restored at (1, 4): every rank's
    leaf is ``local_shard`` of the whole leaf the (2, 2) ranks gathered,
    bit for bit."""
    _, ranks = world
    for r, res in enumerate(ranks):
        bad, n = res["ckpt_1x4_" + arch]
        assert n > 20 and not bad, (r, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_checkpoint_restores_on_one_device(world, arch):
    """Each family's (2, 2) checkpoint restored by a one-device Trainer
    equals the whole state the ranks gathered, bit for bit; its meta
    records the mesh that wrote it."""
    parent, ranks = world
    got, meta = parent["ckpt_one"][arch]
    want = ranks[0]["ckpt_whole_" + arch]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
            name
    assert meta["mesh"]["shape"] == [2, 2]


@pytest.mark.parametrize("arch", __import__(
    "repro_torch.configs.registry", fromlist=["ARCHS"]).ARCHS)
def test_local_init_equals_one_device_init(arch):
    """``init_model_local`` (a mesh Trainer's init: each deferred draw
    replayed and cut) keeping every leaf whole equals ``init_model`` bit
    for bit for every registry config (smoke size): the draw order, the
    draws' scales and dtypes, and the constants an init adds to a draw
    (the RG-LRU's ``lam`` = N(0, 0.5) + 4)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.models.api import init_model, init_model_local
    cfg = get_config(arch, smoke=True)
    want = init_model(3, cfg, device="cpu")
    got = init_model_local(3, cfg, lambda path, x, period: x, device="cpu")
    pairs = list(zip(flatten_with_path(got), flatten_with_path(want)))
    assert len(pairs) == len(flatten_with_path(want))
    for (path, x), (_, y) in pairs:
        assert x.dtype == y.dtype and torch.equal(x, y), path_name(path)
