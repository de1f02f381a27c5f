"""The port's training stack against the JAX reference, at the BERT smoke
config (2 layers, d = 64): the train step (loss and gradients, no packs,
'plan' packs and 'plan_pallas' packs), AdamW, the gradual pruner, the data
pipeline and checkpoints. Weights are initialised (and pruned) in JAX and
carried across with the bridge, optimizer state and masks included.

AdamW's first steps move every weight by about ±lr whatever the size of its
gradient (m/sqrt(v) is ±1), so two implementations whose gradients differ
in the last bits can take opposite ±lr steps where a gradient lies within
rounding of zero. The tests hold the step in two halves so that this cannot
enter: the loss and the gradients are compared directly, and the update is
compared by feeding the port's gradients (as numpy) to the reference's
``adamw_update``. The trainer tests (tests/test_torch_trainer.py) hold the
loop.
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import pruner as jpr  # noqa: E402
from repro.core.sparsity import SparsityConfig as JSp  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.serving import ServingSpec as JSpec  # noqa: E402
from repro.serving import prepare_servable as j_prepare  # noqa: E402

from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pruner as tpr  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.core.tree import (flatten_with_path, leaves,  # noqa: E402
                                   path_name)
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.serving import ServingSpec, prepare_servable  # noqa: E402
from repro_torch.serving.serialize import dtype_name  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")


def _sp(**kw):
    base = dict(block_shape=(16, 16), sparsity=0.5, targets=TARGETS,
                lambda_reg=1e-2, start_step=0, end_step=6)
    base.update(kw)
    return JSp(**base), SparsityConfig(**base)


def _cfgs(sp_pair=None):
    jcfg, tcfg = jax_config("bert_base", smoke=True), \
        get_config("bert_base", smoke=True)
    if sp_pair is not None:
        jcfg = dataclasses.replace(jcfg, sparsity=sp_pair[0])
        tcfg = dataclasses.replace(tcfg, sparsity=sp_pair[1])
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seq=32, batch=4, vocab=512, seed=0, step=0):
    b = JPipeline(JDataConfig(seq_len=seq, global_batch=batch,
                              vocab_size=vocab, seed=seed)).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


def _by_name(tree):
    return {path_name(p): leaf for p, leaf in flatten_with_path(tree)}


def _assert_trees(got, want, rtol, atol_rel, what):
    """Leaf by leaf: |got - want| <= rtol |want| + atol_rel * max|want|."""
    got = _by_name(got)
    want = {path_name(p): np.asarray(leaf)
            for p, leaf in flatten_with_path(_np_tree(want))}
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_rel * max(1e-30, np.abs(w).max()),
            err_msg=f"{what}: {name}")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bert():
    jcfg, tcfg = _cfgs()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(_np_tree(jp))


# --------------------------------------------------------------------------
# data, schedule, pruner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,hosts,host", [(0, 0, 1, 0), (0, 7, 1, 0),
                                                  (3, 11, 2, 1)])
def test_data_pipeline_batches_are_byte_identical(seed, step, hosts, host):
    kw = dict(seq_len=48, global_batch=8, vocab_size=30522, seed=seed,
              n_hosts=hosts, host_id=host)
    jp, tp = JPipeline(JDataConfig(**kw)), DataPipeline(DataConfig(**kw))
    try:
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
        assert next(iter(tp))["tokens"].tobytes() == \
            tp.batch_at(0)["tokens"].tobytes()
    finally:
        jp.close()
        tp.close()


def test_cubic_sparsity_and_lr_schedule_match():
    jsp, tsp = _sp(sparsity=0.8, start_step=2, end_step=8)
    for step in range(-1, 12):
        assert tpr.cubic_sparsity(step, tsp) == \
            float(jpr.cubic_sparsity(step, jsp)), step
    cfg = dict(peak_lr=1e-4, warmup_steps=2, total_steps=12)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for step in range(0, 15):
        a = float(jopt.lr_at(jc, jnp.asarray(step, jnp.int32)))
        b = float(topt.lr_at(tc, torch.tensor(step, dtype=torch.int32)))
        assert b == pytest.approx(a, rel=1e-6, abs=0.0), step


def test_gradual_pruner_masks_are_byte_identical(bert):
    """init_masks / update_masks / apply_masks give the reference's masks
    and weights on the same params; the report matches."""
    jcfg, tcfg, jp, tp = bert
    jsp, tsp = _sp(sparsity=0.75, start_step=1, end_step=5)
    jm, tm = jpr.init_masks(jp, jsp), tpr.init_masks(tp, tsp)
    assert len(leaves(tm)) == 8
    for step in (0, 2, 3, 5, 9):
        jm = jpr.update_masks(jp, jm, step, jsp)
        tm = tpr.update_masks(tp, tm, step, tsp)
        want = _by_name(_np_tree(jm))
        got = _by_name(params_to_numpy(tm))
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == np.bool_
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    jw = jpr.apply_masks(jp, jm, jsp)
    tw = tpr.apply_masks(tp, tm, tsp)
    _assert_trees(tw, jw, 0.0, 0.0, "apply_masks")
    jr, tr = jpr.sparsity_report(jw, jsp), tpr.sparsity_report(tw, tsp)
    assert tr == pytest.approx(jr, abs=0) and min(tr.values()) >= 0.75


# --------------------------------------------------------------------------
# AdamW on the same gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("clip,prox", [(1.0, True), (1e3, False),
                                       (1.0, False)])
def test_adamw_update_matches_jax_on_the_same_grads(bert, clip, prox):
    """Three steps of adamw_update on identical numpy gradients, with the
    global-norm clip active (clip 1.0) or not, with and without the
    blockwise group-lasso prox on the targeted weights."""
    jcfg, tcfg, jp, tp = bert
    jsp, tsp = _sp(lambda_reg=20.0 if prox else 0.0)
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=clip,
              weight_decay=0.1)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    rng = np.random.RandomState(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32)
                         * 0.05, _np_tree(jp))
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                       jc, jsp)
        tp, ts, tm = topt.adamw_update(params_from_numpy(g), ts, tp, tc, tsp)
    # fp32 sums of the norms in another order: ~1e-7 relative
    for k in ("grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    _assert_trees(tp, jp, 1e-5, 1e-6, "params")
    _assert_trees(ts["m"], js["m"], 1e-5, 1e-6, "m")
    _assert_trees(ts["v"], js["v"], 1e-5, 1e-6, "v")
    if prox:   # the prox zeroed whole blocks, as many as the reference
        blocks = tpr.sparsity_report(tp, tsp)
        assert blocks == pytest.approx(jpr.sparsity_report(jp, jsp), abs=0)
        assert max(blocks.values()) > 0


# --------------------------------------------------------------------------
# the train step: loss and gradients, then the update on the same grads
# --------------------------------------------------------------------------

def _packed(jp, jcfg, tcfg, backend):
    """Prune in JAX (one-shot 50% at 16x16), export with both packages."""
    if backend is None:
        return jp, None, params_from_numpy(_np_tree(jp)), None
    jsp, _ = _sp()
    pruned, _ = jpr.oneshot_prune(jp, jsp)
    kw = dict(tile=(16, 16), prune="none", fuse_qkv=True,
              cross_layer_union=True, backend=backend)
    js = j_prepare(pruned, jcfg, JSpec(**kw))
    ts = prepare_servable(params_from_numpy(_np_tree(pruned)), tcfg,
                          ServingSpec(**kw), device="cpu")
    assert sorted(js.packs) == sorted(ts.packs) and len(ts.packs) == 8
    return js.params, js.packs, ts.params, ts.packs


@pytest.mark.parametrize("backend", [None, "plan", "plan_pallas"])
def test_train_step_matches_jax(bert, backend):
    """make_train_step on the same weights and batch: the loss and every
    gradient against jax.value_and_grad of the reference's loss (packed
    values' padding slots exactly zero), then the update against the
    reference's adamw_update fed the port's gradients."""
    jcfg, tcfg, jp0, _ = bert
    sp = _sp(lambda_reg=1e-2)
    jcfg, tcfg = _cfgs(sp)
    jp, jpacks, tp, tpacks = _packed(jp0, jcfg, tcfg, backend)
    jb, tb = _batch()
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)

    (jl, jaux), jg = jax.value_and_grad(jsteps.make_loss_fn(jcfg, jpacks),
                                        has_aux=True)(jp, jb)
    tl, taux, tg = tsteps.value_and_grad(tsteps.make_loss_fn(tcfg, tpacks),
                                         tp, tb)
    # fp32 through two layers in another summation order (measured: the
    # loss within 2e-7 relative, every gradient within 6e-7 of its leaf's
    # largest entry)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(taux["ce"]) == pytest.approx(float(jaux["ce"]), rel=1e-5)
    _assert_trees(tg, jg, 1e-4, 1e-5, "grads")
    n_dead = 0
    for key, pk in (tpacks or {}).items():
        _, i, group, name = key.split("/")
        dead = torch.from_numpy(~getattr(pk, "plan", pk).slot_mask)
        gw = tg["layers"][int(i)][group][name]["w"]
        assert float(gw[dead].abs().sum()) == 0.0, key
        n_dead += int(dead.sum())
    assert n_dead > 0 or tpacks is None

    step = tsteps.make_train_step(tcfg, tc, packs=tpacks)
    to = topt.init_opt_state(tp, tc)
    tp1, to1, tm = step(tp, to, tb)
    assert float(tm["loss"]) == float(tl)
    jp1, jo1, jm = jopt.adamw_update(
        jax.tree.map(jnp.asarray, params_to_numpy(tg)),
        jopt.init_opt_state(jp, jc), jp, jc, jcfg.sparsity)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    _assert_trees(tp1, jp1, 1e-5, 1e-6, "params after the step")
    _assert_trees(to1["m"], jo1["m"], 1e-5, 1e-6, "m after the step")


def test_grad_accumulation_averages_microbatches(bert):
    """grad_accum=2 gives the mean of the two half-batches' gradients, as
    the reference's scan does."""
    jcfg, tcfg, jp, tp = bert
    jb, tb = _batch(batch=4)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    tp1, _, tm = tsteps.make_train_step(tcfg, tc, grad_accum=2)(
        tp, topt.init_opt_state(tp, tc), tb)
    jp1, _, jm = jax.jit(jsteps.make_train_step(jcfg, jc, grad_accum=2))(
        jp, jopt.init_opt_state(jp, jc), jb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)


# --------------------------------------------------------------------------
# checkpoints and the bridge
# --------------------------------------------------------------------------

def _jax_train_state(jp, jcfg):
    jsp, _ = _sp()
    jc = jopt.AdamWConfig()
    opt = jopt.init_opt_state(jp, jc)
    opt = dict(opt, m=jax.tree.map(lambda p: p * 0.5, jp),
               step=jnp.asarray(7, jnp.int32))
    return {"params": jp, "opt": opt, "masks": jpr.init_masks(jp, jsp)}


def _like(tree):
    from repro_torch.core.tree import map_with_path
    return map_with_path(lambda _, leaf: dtype_name(leaf.dtype), tree)


def test_checkpoint_round_trip_and_reads_the_jax_store(bert, tmp_path):
    """The bridge carries a whole train state (params, {m, v, step}, the
    masks tree with its None leaves); the port's store round-trips it
    bit-exactly, in the background or not, and reads the state the JAX
    store wrote."""
    jcfg, tcfg, jp, _ = bert
    jstate = _jax_train_state(jp, jcfg)
    tstate = params_from_numpy(_np_tree(jstate))
    assert tstate["opt"]["step"].shape == () and \
        tstate["opt"]["step"].dtype == torch.int32
    assert tstate["masks"]["embed"]["w"] is None

    store = CheckpointStore(str(tmp_path / "t"), keep=2)
    store.save(3, tstate, blocking=False)
    store.wait()
    store.save(5, tstate)
    assert store.all_steps() == [3, 5] and store.latest_step() == 5
    back = store.restore(_like(tstate))
    for (pa, a), (pb, b) in zip(flatten_with_path(tstate),
                                flatten_with_path(back)):
        assert path_name(pa) == path_name(pb)
        assert a.dtype == b.dtype and torch.equal(a, b), path_name(pa)

    JStore(str(tmp_path / "j")).save(4, jstate, blocking=True)
    from_jax = CheckpointStore(str(tmp_path / "j")).restore(
        _like(tstate), step=4)
    for (pa, a), (_, b) in zip(flatten_with_path(tstate),
                               flatten_with_path(from_jax)):
        assert torch.equal(a, b), path_name(pa)


def test_training_stack_imports_no_jax():
    """The trainer and everything it pulls in import neither jax nor the JAX
    package, and run a step on the CPU."""
    code = textwrap.dedent("""
        import sys, tempfile
        sys.modules["jax"] = None
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.launch.train import TrainConfig, Trainer
        cfg = get_config("bert_base", smoke=True)
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, TrainConfig(n_steps=2, ckpt_dir=d), "cpu",
                         DataConfig(seq_len=16, global_batch=2,
                                    vocab_size=cfg.vocab_size))
            state, _ = tr.fit(resume=False)
        assert int(state["opt"]["step"]) == 2
        bad = [m for m in sys.modules
               if m == "repro" or m.startswith("repro.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("trained", int(state["opt"]["step"]))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained 2" in out.stdout
