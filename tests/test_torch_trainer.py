"""The port's training loop (``launch/train.Trainer``, on the CPU, its step
donated) at the BERT smoke config and at the deepseek_7b smoke config, the
LM of tests/test_train.py:41-196 and examples/train_lm_sparse.py. These
mirror tests/test_train.py, which the reference cannot pass on this JAX
version (ROADMAP.md Queue 3: a ShardingTypeError under its Explicit-axis
mesh), so the loop's logic is held against a loop of the JAX step and
pruner functions called directly: the same weights (the reference's,
carried across), the same batches, a fault injected and recovered in the
port's run only.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import pruner as jpr  # noqa: E402
from repro.core.sparsity import SparsityConfig as JSp  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pruner import init_masks  # noqa: E402
from repro_torch.core.sparsity import (SparsityConfig,  # noqa: E402
                                       actual_sparsity)
from repro_torch.core.tree import (flatten_with_path, leaves,  # noqa: E402
                                   path_name)
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.runtime.fault_tolerance import (FaultInjector,  # noqa: E402
                                                 FaultToleranceConfig,
                                                 StragglerMonitor)

TARGETS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
OPT = dict(peak_lr=5e-3, warmup_steps=2, total_steps=50, weight_decay=0.0)
ARCHS = ("bert_base", "deepseek_7b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, sp=None):
    cfg = get_config(arch, smoke=True)
    return cfg if sp is None else dataclasses.replace(cfg, sparsity=sp)


def _targeted(params):
    """(name, 2-D weight) of every targeted projection, layer by layer
    (BERT's per-layer dicts, an LM's period-stacked leaves)."""
    for path, w in flatten_with_path(params):
        name = path_name(path)
        if any(t in name for t in TARGETS):
            for i, layer in enumerate(w if w.ndim == 3 else [w]):
                yield f"{name}[{i}]", layer


def _tcfg(tmp, **kw):
    return TrainConfig(
        n_steps=kw.pop("n_steps", 12), ckpt_dir=str(tmp),
        opt=AdamWConfig(**kw.pop("opt", OPT)),
        ft=FaultToleranceConfig(checkpoint_every=4, max_restarts=3),
        log_every=1, **kw)


def _dcfg(cfg):
    return DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)


def _fit(cfg, tmp, inj=None, **kw):
    tr = Trainer(cfg, _tcfg(tmp, **kw), "cpu", _dcfg(cfg), fault_injector=inj)
    state, hist = tr.fit(resume=False)
    return tr, state, hist


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases(tmp_path, arch):
    _, _, hist = _fit(_cfg(arch), tmp_path, n_steps=20)
    first = np.mean([loss for _, loss in hist[:3]])
    last = np.mean([loss for _, loss in hist[-3:]])
    assert last < first, hist


@pytest.mark.parametrize("arch", ARCHS)
def test_failure_recovery_resumes_from_checkpoint(tmp_path, arch):
    inj = FaultInjector(fail_at_steps=(6, 9))
    tr, state, hist = _fit(_cfg(arch), tmp_path, inj)
    assert inj.fired == {6, 9}
    assert tr.supervisor.restarts == 2
    assert int(state["opt"]["step"]) == 12    # completed despite failures
    # replayed from the step-4 and step-8 checkpoints
    assert [s for s, _ in hist] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 8, 9,
                                    10, 11]


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_reproduces_uninterrupted_run_bit_for_bit(tmp_path, arch):
    """Deterministic data + restore-on-failure => the same final state as a
    clean run, bit for bit on the CPU (params, optimizer state, masks)."""
    sp = SparsityConfig(block_shape=(16, 16), sparsity=0.5, targets=TARGETS,
                        lambda_reg=1e-3, start_step=0, end_step=8)
    _, s1, h1 = _fit(_cfg(arch, sp), tmp_path / "a", prune=True)
    inj = FaultInjector(fail_at_steps=(7,))
    tr, s2, h2 = _fit(_cfg(arch, sp), tmp_path / "b", inj, prune=True)
    assert tr.supervisor.restarts == 1
    assert dict(h1) == dict(h2)
    a, b = flatten_with_path(s1), flatten_with_path(s2)
    assert [path_name(p) for p, _ in a] == [path_name(p) for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path_name(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradual_pruning_during_training(tmp_path, arch):
    sp = SparsityConfig(block_shape=(8, 8), sparsity=0.75, targets=TARGETS,
                        start_step=0, end_step=8)
    _, state, _ = _fit(_cfg(arch, sp), tmp_path, prune=True)
    ws = list(_targeted(state["params"]))
    assert len(ws) == 8        # 4 projections in each of 2 layers
    for name, w in ws:
        assert float(actual_sparsity(w, (8, 8))) >= 0.75, name


@pytest.mark.parametrize("arch", ARCHS)
def test_group_lasso_prox_induces_sparsity_without_pruning(tmp_path, arch):
    """Paper Eq. 1 mechanism: the group-lasso prox ALONE (no magnitude
    pruning) drives whole blocks to exact zero during training."""
    sp = SparsityConfig(block_shape=(8, 8), sparsity=0.0, lambda_reg=3.0,
                        targets=TARGETS)
    _, state, _ = _fit(_cfg(arch, sp), tmp_path, n_steps=40)
    w = dict(_targeted(state["params"]))
    w = next(v for k, v in w.items() if "wq" in k)       # the first wq
    got = float(actual_sparsity(w, (8, 8)))
    assert got > 0.10, f"prox produced no block sparsity ({got})"


def test_straggler_monitor_rebalances():
    mon = StragglerMonitor(4, FaultToleranceConfig(straggler_threshold=1.4))
    for _ in range(5):
        mon.observe({0: 1.0, 1: 1.0, 2: 1.0, 3: 3.0})
    assert mon.stragglers() == [3]
    mb = mon.rebalance(np.array([4, 4, 4, 4]))
    assert mb.sum() == 16 and mb[3] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_loop_matches_a_loop_of_the_jax_functions(tmp_path, arch):
    """From the reference's initial weights: the port's Trainer (with a
    fault at step 5, replayed from the step-4 checkpoint) against the JAX
    train step + update_masks + apply_masks called step by step. Per-step
    losses within 1e-4 relative, the final masks equal and the final
    weights within 1e-4 (measured: 2e-6). AdamW at lr 1e-3 moves a weight
    by ~1e-3 a step whatever its gradient's size, so an element whose
    update took the other sign would be off by ~2e-3: the bar shows that
    no gradient of this run fell within rounding of zero."""
    n_steps = 8
    jsp = JSp(block_shape=(16, 16), sparsity=0.5, targets=TARGETS,
              lambda_reg=1e-2, start_step=1, end_step=6)
    tsp = SparsityConfig(**dataclasses.asdict(jsp))
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20,
               weight_decay=0.01)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), sparsity=jsp)
    jc = jopt.AdamWConfig(**opt)
    jp = j_init(jax.random.PRNGKey(1), jcfg)

    step_fn = jax.jit(jsteps.make_train_step(jcfg, jc))
    pipe = JPipeline(JDataConfig(seq_len=32, global_batch=4,
                                 vocab_size=jcfg.vocab_size))
    params, ostate, masks = jp, jopt.init_opt_state(jp, jc), \
        jpr.init_masks(jp, jsp)
    j_losses = []
    for step in range(n_steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()}
        params, ostate, m = step_fn(params, ostate, batch)
        masks = jpr.update_masks(params, masks, step, jsp)
        params = jpr.apply_masks(params, masks, jsp)
        j_losses.append(float(m["loss"]))
    pipe.close()

    cfg = _cfg(arch, tsp)
    tr = Trainer(cfg, _tcfg(tmp_path, n_steps=n_steps, opt=opt, prune=True),
                 "cpu", _dcfg(cfg),
                 fault_injector=FaultInjector(fail_at_steps=(5,)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tr.init_state = lambda: {"params": tp, "opt": init_opt_state(
        tp, tr.tcfg.opt), "masks": init_masks(tp, tsp)}
    state, hist = tr.fit(resume=False)
    assert tr.supervisor.restarts == 1
    t_losses = dict(hist)
    np.testing.assert_allclose([t_losses[s] for s in range(n_steps)],
                               j_losses, rtol=1e-4)
    jm = {path_name(p): np.asarray(m) for p, m in flatten_with_path(
        jax.tree.map(np.asarray, masks))}
    tm = {path_name(p): m.numpy() for p, m in flatten_with_path(
        state["masks"])}
    # one mask a targeted leaf: BERT's 2 x 4 per-layer weights, the LM's
    # 4 period-stacked ones
    assert sorted(jm) == sorted(tm) and len(tm) == (8 if arch == "bert_base"
                                                    else 4)
    for name in jm:
        np.testing.assert_array_equal(tm[name], jm[name], err_msg=name)
    want = [np.asarray(x) for x in jax.tree.leaves(params)]
    got = [x.numpy() for x in leaves(state["params"])]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
