"""Mesh Trainer checkpoints across mesh shapes, the dp packed step, and the
mesh Trainer's guards, on the CPU.

A checkpoint holds whole leaves in the reference's layout whatever wrote
it, and each rank restores only its shard under the mesh it runs on. The
module writes a one-device Trainer checkpoint and a JAX ``CheckpointStore``
checkpoint, then starts world 4 ONCE (gloo, ``file://`` init under the
test's temporary directory, 60 s collective timeouts, one torch thread a
rank; the ranks import no JAX), which over (2, 2), (4, 1) and (1, 4):

  * restores the one-device checkpoint: every leaf equal, bit for bit, to
    ``local_shard`` of the saved whole leaf;
  * takes a step and saves (rank 0 writes the gathered whole leaves, the
    mesh in ``meta``), then restores each mesh shape's checkpoint on the
    two other shapes, bitwise; the parent restores each on one device;
  * restores the JAX package's checkpoint on (2, 2) as ``local_shard`` of
    each array;
  * runs the packed fine-tuning step over dp (4, 1) -- every rank the whole
    packs, its own rows through K1 forward, K4 dX and K5 dW (their plain
    versions on the CPU), the gradients averaged over "data" -- against
    one device's packed step on the whole batch.
"""
import dataclasses
import os
import pickle
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_tp_train import _collect, _launch  # noqa: E402

SHAPES = ((2, 2), (4, 1), (1, 4))
IDS = ["x".join(map(str, s)) for s in SHAPES]
PRUNE = dict(block_shape=(16, 16), sparsity=0.5,
             targets=("attn/wq", "attn/wk", "attn/wv", "attn/wo"),
             lambda_reg=1e-2, start_step=0, end_step=3)
OPT = dict(peak_lr=5e-3, warmup_steps=2, total_steps=50, weight_decay=0.0)
PACK_SPEC = dict(tile=(16, 16), prune="none", fuse_qkv=True,
                 cross_layer_union=True, backend="plan_pallas")
PACKED_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
PACKED_STEPS = 2

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
    from repro_torch.core.tree import at_path, flatten_with_path, path_name
    from repro_torch.models.api import init_model
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.sharding import (local_rows, local_shard,
                                             shard_shape, whole_leaf)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    def key(shape):
        return "x".join(map(str, shape))

    def trainer(mesh, ckpt_dir):
        cfg = dataclasses.replace(get_config("deepseek_7b", smoke=True),
                                  sparsity=SparsityConfig(**IN["prune"]))
        tcfg = TrainConfig(n_steps=4, ckpt_dir=ckpt_dir, seed=1,
                           prune=True, opt=AdamWConfig(**IN["opt"]))
        dcfg = DataConfig(seq_len=32, global_batch=4,
                          vocab_size=cfg.vocab_size)
        return Trainer(cfg, tcfg, "cpu", dcfg, mesh=mesh), dcfg

    def mismatches(tr, state, whole):
        """Names of leaves not bitwise local_shard of the whole ones."""
        specs = tr.specs()
        coord = {a: tr.mesh.coord(a) for a in tr.mesh.axis_names}
        bad, n = [], 0
        for p, x in flatten_with_path(state):
            n += 1
            want = local_shard(whole[path_name(p)],
                               spec_at(specs, p) or (), tr.mesh, coord)
            if x.dtype != torch.from_numpy(np.asarray(want)).dtype or \\
                    not np.array_equal(x.numpy(), want):
                bad.append(path_name(p))
        return bad, n

    def gathered(tr, state):
        specs = tr.specs()
        with torch.no_grad():
            return {path_name(p): (whole_leaf(x, spec_at(specs, p), tr.mesh)
                                   if spec_at(specs, p) else x).numpy()
                    for p, x in flatten_with_path(state)}

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R, wholes = {}, {}
        for shape in IN["shapes"]:
            mesh = init_process_mesh(tuple(shape))
            tr, dcfg = trainer(mesh, os.path.join(workdir, "m" + key(shape)))
            like = tr.init_state()
            # the initial state: params local_shard(init_model(seed)) bit
            # for bit, every param and AdamW leaf shard_shape of its spec
            whole0 = {path_name(p): x.numpy() for p, x in flatten_with_path(
                init_model(1, tr.cfg, device="cpu"))}
            R["init_" + key(shape)] = mismatches(
                tr, {"params": like["params"]},
                {"params/" + k: v for k, v in whole0.items()})
            specs = tr.specs()

            def whole_shape(p):
                if p[0] == "params":
                    return tuple(at_path(tr.plan.shapes, p[1:]).shape)
                return () if p[1] == "step" else tuple(
                    at_path(tr.plan.shapes, p[2:]).shape)
            R["shapes_" + key(shape)] = [
                (path_name(p), tuple(x.shape),
                 shard_shape(whole_shape(p), spec_at(specs, p), mesh))
                for p, x in flatten_with_path({"params": like["params"],
                                               "opt": like["opt"]})]
            state = tr.restore_state(CheckpointStore(IN["one_dir"]), 2, like)
            R["from_one_" + key(shape)] = mismatches(tr, state, IN["one"])
            tr.pipeline = DataPipeline(dcfg)
            state, _ = tr._one_step(state, 2)
            tr.pipeline.close()
            tr.save_state(tr.store, 3, state)
            tr.store.wait()
            wholes[key(shape)] = gathered(tr, state)
            R["local_shapes_" + key(shape)] = {
                path_name(p): tuple(x.shape)
                for p, x in flatten_with_path(state["params"])}
        R["wholes"] = wholes
        for src in IN["shapes"]:
            for dst in IN["shapes"]:
                if dst == src:
                    continue
                mesh = init_process_mesh(tuple(dst))
                tr, _ = trainer(mesh, os.path.join(workdir, "x"))
                store = CheckpointStore(os.path.join(workdir, "m" + key(src)))
                state = tr.restore_state(store, 3, tr.init_state())
                R[f"move_{key(src)}_{key(dst)}"] = mismatches(
                    tr, state, wholes[key(src)])
        # the JAX package's checkpoint on (2, 2)
        mesh = init_process_mesh((2, 2))
        tr, _ = trainer(mesh, os.path.join(workdir, "x"))
        state = tr.restore_state(CheckpointStore(IN["jax_dir"]), 4,
                                 tr.init_state())
        R["from_jax"] = mismatches(tr, state, IN["jax"])
        # the packed step over dp (4, 1)
        mesh = init_process_mesh((4, 1))
        cfg = get_config("bert_base", smoke=True)
        sv = prepare_servable(params_from_numpy(IN["pruned"]), cfg,
                              ServingSpec(**IN["pack_spec"]), device="cpu")
        opt = AdamWConfig(**IN["packed_opt"])
        step = make_train_step(cfg, opt, packs=sv.packs, mesh=mesh)
        params, ost = sv.params, init_opt_state(sv.params, opt)
        mesh.reset_stats()
        hist = []
        for i in range(IN["packed_steps"]):
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                 for k, v in local_rows(IN["packed_batches"][i],
                                        mesh).items()}
            params, ost, m = step(params, ost, b)
            hist.append({k: float(v) for k, v in m.items()})
        R["packed"] = {"hist": hist, "params": {
            path_name(p): x.numpy() for p, x in flatten_with_path(params)},
            "stats": {k: v["calls"] for k, v in mesh.stats.items()},
            "rows": int(b["tokens"].shape[0])}
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _named(tree):
    from repro_torch.core.tree import flatten_with_path, path_name
    return {path_name(p): x.numpy() for p, x in flatten_with_path(tree)}


def _one_device(tmp):
    """A one-device Trainer (deepseek_7b smoke, pruning on) run 2 steps:
    its checkpoint directory and state."""
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_config("deepseek_7b", smoke=True),
                              sparsity=SparsityConfig(**PRUNE))
    tcfg = TrainConfig(n_steps=2, ckpt_dir=str(tmp), seed=1, prune=True,
                       opt=AdamWConfig(**OPT))
    tr = Trainer(cfg, tcfg, "cpu", DataConfig(seq_len=32, global_batch=4,
                                              vocab_size=cfg.vocab_size))
    state, _ = tr.fit(resume=False)
    return tr, state


def _jax_state(tmp):
    """A JAX train state of the same structure, written by the JAX
    package's store at step 4."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.store import CheckpointStore as JStore
    from repro.configs.registry import get_config as jax_config
    from repro.core import pruner as jpr
    from repro.core.sparsity import SparsityConfig as JSp
    from repro.models import init_model as j_init
    from repro.optim import adamw as jopt
    jp = j_init(jax.random.PRNGKey(3), jax_config("deepseek_7b", smoke=True))
    jc = jopt.AdamWConfig()
    opt = dict(jopt.init_opt_state(jp, jc),
               m=jax.tree.map(lambda p: p * 0.5, jp),
               v=jax.tree.map(lambda p: p * p, jp),
               step=jnp.asarray(7, jnp.int32))
    state = {"params": jp, "opt": opt,
             "masks": jpr.init_masks(jp, JSp(**PRUNE))}
    JStore(str(tmp)).save(4, state, blocking=True)
    from repro_torch.bridge import params_from_numpy
    return _named(params_from_numpy(jax.tree.map(np.asarray, state)))


def _packed_inputs():
    """BERT smoke pruned one-shot at 16 x 16 (the port's pruner), and the
    batches of the packed steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import oneshot_prune
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models.api import init_model
    from repro_torch.bridge import params_to_numpy
    cfg = get_config("bert_base", smoke=True)
    pruned, _ = oneshot_prune(init_model(0, cfg, device="cpu"),
                              SparsityConfig(**PRUNE))
    pipe = DataPipeline(DataConfig(seq_len=32, global_batch=4,
                                   vocab_size=cfg.vocab_size))
    batches = [pipe.batch_at(i) for i in range(PACKED_STEPS)]
    pipe.close()
    return params_to_numpy(pruned), batches


def _one_device_packed(pruned, batches):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    cfg = get_config("bert_base", smoke=True)
    sv = prepare_servable(params_from_numpy(pruned), cfg,
                          ServingSpec(**PACK_SPEC), device="cpu")
    opt = AdamWConfig(**PACKED_OPT)
    step = make_train_step(cfg, opt, packs=sv.packs)
    params, ost, hist = sv.params, init_opt_state(sv.params, opt), []
    for b in batches:
        params, ost, m = step(params, ost, {
            k: torch.from_numpy(v).long() for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()})
    return {"hist": hist, "params": _named(params),
            "n_packs": len(sv.packs)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_ckpt")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr, state = _one_device(workdir / "one")
        pruned, batches = _packed_inputs()
        IN = {"shapes": SHAPES, "prune": PRUNE, "opt": OPT,
              "one_dir": str(workdir / "one"), "one": _named(state),
              "jax_dir": str(workdir / "jax"),
              "jax": _jax_state(workdir / "jax"),
              "pruned": pruned, "packed_batches": batches,
              "pack_spec": PACK_SPEC, "packed_opt": PACKED_OPT,
              "packed_steps": PACKED_STEPS}
        with open(workdir / "inputs.pkl", "wb") as f:
            pickle.dump(IN, f)
        t0 = time.perf_counter()
        procs = _launch(workdir, RANK_PROGRAM)
        try:
            packed = _one_device_packed(pruned, batches)
        except BaseException:
            for p in procs:
                p.kill()
            raise
        ranks = _collect(procs, workdir, t0)
        # each mesh shape's checkpoint restored on one device
        from repro_torch.checkpoint.store import CheckpointStore
        restored = {}
        for shape in SHAPES:
            key = "x".join(map(str, shape))
            store = CheckpointStore(str(workdir / ("m" + key)))
            restored[key] = (_named(tr.restore_state(
                store, 3, tr.init_state())), store.meta(3))
    finally:
        torch.set_num_threads(n)
    return {"in": IN, "packed": packed, "restored": restored}, ranks


def _key(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_initial_state_is_the_local_shard(world, shape):
    """A mesh Trainer's initial params equal ``local_shard`` of
    ``init_model(seed)`` bit for bit (drawn leaf by leaf, each draw cut as
    it is made), and every param and AdamW leaf (m, v; step replicated)
    has exactly ``shard_shape`` of its train-mode spec."""
    _, ranks = world
    for r, res in enumerate(ranks):
        bad, n = res["init_" + _key(shape)]
        assert n > 10 and not bad, (r, bad)
        shapes = res["shapes_" + _key(shape)]
        assert len(shapes) == 3 * n + 1
        for name, local, want in shapes:
            assert local == want, (r, name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_one_device_checkpoint_restores_on_mesh(world, shape):
    """A one-device Trainer's checkpoint (params, AdamW state, masks)
    restored by a mesh Trainer: every rank's leaf is ``local_shard`` of
    the saved leaf under the train-mode spec, bit for bit (masks whole)."""
    _, ranks = world
    for r, res in enumerate(ranks):
        bad, n = res["from_one_" + _key(shape)]
        assert n > 20 and not bad, (r, bad)


@pytest.mark.parametrize("src", SHAPES, ids=IDS)
def test_mesh_checkpoint_restores_on_other_shapes(world, src):
    """A checkpoint written on one mesh shape (rank 0 writes the gathered
    whole leaves) restored on each other shape, every rank's leaves bit
    for bit ``local_shard`` of the whole ones; the written leaves are cut
    as ``shard_shape`` says (the shapes differ between meshes)."""
    _, ranks = world
    for r, res in enumerate(ranks):
        for dst in SHAPES:
            if dst != src:
                bad, n = res[f"move_{_key(src)}_{_key(dst)}"]
                assert n > 20 and not bad, (r, src, dst, bad)
    shapes = {_key(s): ranks[0]["local_shapes_" + _key(s)] for s in SHAPES}
    assert len({tuple(sorted(v.items())) for v in shapes.values()}) == 3


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_checkpoint_restores_on_one_device(world, shape):
    """The mesh checkpoint restored by a one-device Trainer equals the
    whole state the ranks gathered, bit for bit, and its meta records the
    mesh that wrote it."""
    parent, ranks = world
    got, meta = parent["restored"][_key(shape)]
    want = ranks[0]["wholes"][_key(shape)]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
            name
    assert meta["mesh"]["shape"] == list(shape)
    assert meta["mesh"]["axes"] == ["data", "model"]


def test_jax_checkpoint_restores_on_mesh(world):
    """A train state written by the JAX package's ``CheckpointStore``,
    restored on (2, 2): every rank's leaf is ``local_shard`` of the JAX
    array, bit for bit."""
    _, ranks = world
    for r, res in enumerate(ranks):
        bad, n = res["from_jax"]
        assert n > 20 and not bad, (r, bad)


def test_dp_packed_step_matches_one_device(world):
    """Packed fine-tuning over dp (4, 1): each rank its row of the batch
    through the 8 packed projections (K1 / K4 / K5, plain on the CPU), the
    gradients averaged over "data": loss and grad_norm equal on every rank
    and within 1e-5 relative of one device's packed step on the whole
    batch, the weights within 1e-5 after the steps."""
    parent, ranks = world
    want = parent["packed"]
    assert want["n_packs"] == 8
    first = ranks[0]["packed"]["hist"]
    for r, res in enumerate(ranks):
        got = res["packed"]
        assert got["rows"] == 1 and got["hist"] == first, r
        for g, w in zip(got["hist"], want["hist"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0,
                                       atol=1e-5, err_msg=name)
        assert got["stats"].get("all_reduce:data", 0) > 0, got["stats"]


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------

def test_background_save_copies_host_tensors(tmp_path):
    """A background save of host tensors copies them in the call: a
    donated step writing into them before the write lands cannot reach
    the checkpoint (it did when ``to_host`` handed numpy views of CPU
    tensors to the writer thread)."""
    from repro_torch.checkpoint.store import CheckpointStore
    x = torch.arange(1 << 20, dtype=torch.float32)
    before = x.clone()
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"x": x}, blocking=False)
    x.add_(1.0)            # the next step's in-place update
    store.wait()
    back = store.restore({"x": "float32"}, step=1)
    assert torch.equal(back["x"], before)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embedding_row_gradient_matches_jax(dtype):
    """The one-device embedding lookup's gradient against ``jax.vjp`` of
    the reference's ``jnp.take`` on the same table, tokens (a row read
    3,000 times among 5,000) and cotangent: bf16 bitwise -- both add a
    row's repeats one at a time in bf16 (a sum in fp32 rounded once
    differs from the reference's here, asserted); fp32 within 1e-5 of
    max|g|, the mesh gradients' bar (the reference adds row 0's 3,000
    terms in another order: 1.8e-6 absolute, measured)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models.common import embed_lookup
    rng = np.random.RandomState(0)
    w = rng.randn(64, 8).astype(np.float32)
    t = np.concatenate([np.zeros(3000, np.int64),
                        rng.randint(0, 64, 2000)])
    rng.shuffle(t)
    t = t.reshape(50, 100)
    cot = (0.01 * rng.randn(50, 100, 8)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(t), axis=0),
                     jnp.asarray(w, jdt))
    want = np.asarray(vjp(jnp.asarray(cot, jdt))[0].astype(jnp.float32))
    tw = torch.tensor(w).to(tdt).requires_grad_(True)
    tc = torch.tensor(cot).to(tdt)
    got = torch.autograd.grad(embed_lookup(tw, torch.tensor(t)), tw,
                              tc)[0].float().numpy()
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
        once = torch.zeros(64, 8).index_put_(
            (torch.tensor(t),), tc.float(), accumulate=True).to(tdt)
        assert not np.array_equal(once.float().numpy(), want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


class _Mesh:
    """A mesh position without a process group (``local_rows`` reads only
    the axes and the coordinate)."""

    def __init__(self, shape, coord):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self._coord = dict(zip(self.axis_names, coord))

    def coord(self, axis):
        return self._coord[axis]


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_local_rows_are_one_devices_rows(shape):
    """The rank's rows of one device's global batch, by its data
    coordinate; model ranks of a data coordinate take the same rows; a
    batch whose rows do not divide raises."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.sharding import local_rows
    batch = DataPipeline(DataConfig(seq_len=8, global_batch=4,
                                    vocab_size=64)).batch_at(3)
    n = 4 // shape[0]
    for d in range(shape[0]):
        for m in range(shape[1]):
            got = local_rows(batch, _Mesh(shape, (d, m)))
            for k, v in batch.items():
                assert np.array_equal(got[k], v[d * n:(d + 1) * n]), k
    odd = {k: v[:3] for k, v in batch.items()}
    with pytest.raises(ValueError):
        local_rows(odd, _Mesh(shape, (0, 0)))


def test_mesh_trainer_refuses_per_host_draws(tmp_path):
    """``DataConfig(n_hosts > 1)`` seeds each host's draw by its host id,
    so the hosts' batches are not one global batch: a mesh Trainer
    refuses it."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import TrainConfig, Trainer
    cfg = get_config("deepseek_7b", smoke=True)
    with pytest.raises(ValueError, match="n_hosts=1"):
        Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)), "cpu",
                DataConfig(n_hosts=2, vocab_size=cfg.vocab_size),
                mesh=make_mesh((2, 1), ("data", "model")))
