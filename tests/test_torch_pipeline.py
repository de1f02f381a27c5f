"""GPipe's fill-drain schedule (``repro_torch.launch.pipeline``) over four
gloo ranks against the JAX reference (``repro.launch.pipeline``) on the
CPU, forward and backward.

The reference runs ONCE, in one subprocess with four fake CPU devices
(``--xla_force_host_platform_device_count=4``), and writes its results
under the module's temporary directory: ``pipeline_apply`` on
``tests/test_pipeline.py``'s inputs (4 stages of tanh layers, 6
microbatches) and with fewer microbatches than stages (2, and 1), each
with ``jax.grad`` of the pipeline (its vjp) under ``jax.set_mesh``; and
the gemma3_4b smoke config cut to 4 periods, its layer body
(``models/lm._apply_layer`` over a period's kinds) applied period after
period on every microbatch, with the vjp of that sequence. The weights are drawn once (the port's
seeded init), handed to both packages as numpy through ``bridge.py``.
Four gloo ranks (``file://`` init, 60 s collective timeouts, one torch
thread each; they import no JAX) run the port's ``pipeline_apply`` on a
``("pipe",)`` mesh, first through the process group, then through
``launch/staging.SharedStaging`` (host files, 4 KiB chunks).
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_tp_train import _collect, _launch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference's own bar (tests/test_pipeline.py), on the forward; the
#: gradients within it of their max|g|
TOL = 1e-5
S, MB, D = 4, 8, 16
#: (case, microbatches): the tanh layers of tests/test_pipeline.py
TANH_CASES = (("tanh_m6", 6), ("tanh_m2", 2), ("tanh_m1", 1))
#: the smoke LM: 4 periods, M microbatches of (LM_MB, LM_SEQ)
LM_M, LM_MB, LM_SEQ = 5, 2, 16
CASES = tuple(c for c, _ in TANH_CASES) + ("lm",)
SHIFTS = (1, -1, 2)

# The reference's side, run once with four fake devices.
JAX_PROGRAM = textwrap.dedent('''
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_config
    from repro.launch.pipeline import pipeline_apply
    from repro.models import lm as jlm
    workdir = sys.argv[1]
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    mesh = jax.make_mesh((4,), ("pipe",))
    out = {}

    def tanh_fn(p, x):
        return jnp.tanh(x @ p["w"])

    def pipe(w, x):
        return pipeline_apply(tanh_fn, {"w": w}, x, mesh, axis="pipe")

    @jax.jit
    def tanh_case(w, x, ct):
        """The pipeline's outputs and jax.grad of sum(y * ct) (its vjp)."""
        y, vjp = jax.vjp(pipe, w, x)
        return (y,) + vjp(ct)

    with jax.set_mesh(mesh):
        for name, _ in IN["tanh_cases"]:
            y, gw, gx = tanh_case(jnp.asarray(IN["ws"]),
                                  jnp.asarray(IN[name]["x"]),
                                  jnp.asarray(IN[name]["ct"]))
            out[name] = {"y": np.asarray(y), "x": np.asarray(gx),
                         "w": np.asarray(gw)}

    cfg = dataclasses.replace(get_config("gemma3_4b", smoke=True),
                              n_layers=IN["lm_layers"])
    prefix, pattern, n_periods, suffix = cfg.layer_plan()
    assert n_periods == 4 and not prefix and not suffix
    blocks = jax.tree.map(jnp.asarray, IN["lm_blocks"])
    positions = jnp.arange(IN["lm"]["x"].shape[2])[None, :]

    def sequence(blocks, xs):
        """The periods in order on every microbatch (the rows of all the
        microbatches at once: each row's layers see that row alone)."""
        h = xs.reshape((-1,) + xs.shape[2:])
        for per in range(n_periods):
            for i, kind in enumerate(pattern):
                p = jax.tree.map(lambda a: a[per], blocks[i])
                h, _, _ = jlm._apply_layer(p, h, cfg, kind,
                                           positions=positions)
        return h.reshape(xs.shape)

    @jax.jit
    def lm_case(blocks, xs, ct):
        y, vjp = jax.vjp(sequence, blocks, xs)
        return (y,) + vjp(ct)
    y, gb, gx = lm_case(blocks, jnp.asarray(IN["lm"]["x"]),
                        jnp.asarray(IN["lm"]["ct"]))
    out["lm"] = {"y": np.asarray(y), "x": np.asarray(gx),
                 "blocks": jax.tree.map(np.asarray, gb)}
    with open(os.path.join(workdir, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
''')

# The program each rank runs (``python -c``): the port alone.
RANK_PROGRAM = textwrap.dedent('''
    import copy, dataclasses, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.launch.staging import install as install_staging
    from repro_torch.models import lm

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    calls = [0]

    def tanh_fn(p, x):
        calls[0] += 1
        return torch.tanh(x @ p["w"])

    cfg = dataclasses.replace(get_config("gemma3_4b", smoke=True),
                              n_layers=IN["lm_layers"])
    pattern = cfg.layer_plan()[1]
    positions = torch.arange(IN["lm"]["x"].shape[2])[None, :]

    def period_fn(p, h):
        calls[0] += 1
        for i, kind in enumerate(pattern):
            h, _ = lm._apply_layer(p[i], h, cfg, kind, positions=positions)
        return h

    def run(mesh, name):
        """Forward and backward of one case; the LM hands each rank only
        its block of one, the tanh cases the whole stack."""
        s = mesh.coord("pipe")
        if name == "lm":
            fn = period_fn
            def block(t):
                if isinstance(t, dict):
                    return {k: block(v) for k, v in t.items()}
                return t[s:s + 1].clone().requires_grad_(True)
            params = tuple(block(b)
                           for b in params_from_numpy(IN["lm_blocks"]))
        else:
            fn = tanh_fn
            params = {"w": torch.from_numpy(IN["ws"]).requires_grad_(True)}
        x = torch.from_numpy(IN[name]["x"]).requires_grad_(True)
        ct = torch.from_numpy(IN[name]["ct"])
        with torch.no_grad():
            y0 = pipeline_apply(fn, params, x, mesh)
        mesh.reset_stats()
        calls[0] = 0
        y = pipeline_apply(fn, params, x, mesh)
        fwd = (calls[0], copy.deepcopy(mesh.stats))
        (y * ct).sum().backward()
        from repro_torch.core.tree import flatten_with_path, path_name
        grads = {path_name(p): t.grad.numpy()
                 for p, t in flatten_with_path(params)}
        return {"y": y.detach().numpy(), "y_nograd": y0.numpy(),
                "x": x.grad.numpy(), "grads": grads, "fwd_calls": fwd[0],
                "fwd_stats": fwd[1], "calls": calls[0],
                "stats": copy.deepcopy(mesh.stats), "stage": s}

    def shifts(mesh):
        me = torch.full((3,), float(mesh.coord("pipe")))
        return {k: mesh.ppermute(me, "pipe", k).numpy() for k in IN["shifts"]}

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        mesh = init_process_mesh((4,), ("pipe",))
        R = {"coord": mesh.coordinate, "shift": shifts(mesh)}
        for name in IN["cases"]:
            R[name] = run(mesh, name)
        stage = os.path.join(workdir, "stage")
        os.makedirs(stage, exist_ok=True)
        install_staging(mesh, "host", stage, chunk_bytes=4096)
        R["staged_shift"] = shifts(mesh)
        R["staged"] = run(mesh, "tanh_m6")
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _lm_blocks():
    """The 4-period gemma3_4b smoke config's period-stacked ``blocks``,
    from the port's seeded init, as numpy."""
    import dataclasses
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model
    cfg = dataclasses.replace(get_config("gemma3_4b", smoke=True),
                              n_layers=12)
    return cfg.n_layers, params_to_numpy(init_model(0, cfg, device="cpu")["blocks"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the inputs, the reference's results, each rank's results)."""
    workdir = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    IN = {"ws": (rng.randn(S, D, D) * 0.3).astype(np.float32),
          "tanh_cases": TANH_CASES, "cases": CASES, "shifts": SHIFTS}
    for name, m in TANH_CASES:
        IN[name] = {"x": rng.randn(m, MB, D).astype(np.float32),
                    "ct": rng.randn(m, MB, D).astype(np.float32)}
    IN["lm_layers"], IN["lm_blocks"] = _lm_blocks()
    d = IN["lm_blocks"][0]["norm1"]["scale"].shape[-1]
    IN["lm"] = {"x": rng.randn(LM_M, LM_MB, LM_SEQ, d).astype(np.float32),
                "ct": rng.randn(LM_M, LM_MB, LM_SEQ, d).astype(np.float32)}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(IN, f)
    t0 = time.perf_counter()
    procs = _launch(workdir, RANK_PROGRAM)
    try:
        env = dict(_env(), JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", JAX_PROGRAM, str(workdir)],
                           env=env, capture_output=True, text=True,
                           timeout=240)
        assert r.returncode == 0, r.stderr[-4000:]
        with open(workdir / "jax.pkl", "rb") as f:
            ref = pickle.load(f)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return IN, ref, _collect(procs, workdir, t0)


def _stage_grads(case, ranks, ref):
    """[(name, the ranks' gradient of a stage's params, the reference's)]:
    the tanh cases' ``w`` (each rank's row of the whole stack), the LM's
    every leaf (each rank's block of one)."""
    from repro_torch.core.tree import flatten_with_path, path_name
    out = []
    if case != "lm":
        got = np.stack([res[case]["grads"]["w"][res[case]["stage"]]
                        for res in ranks])
        return [("w", got, ref[case]["w"])]
    for p, want in flatten_with_path(ref["lm"]["blocks"]):
        name = path_name(p)
        got = np.concatenate([res["lm"]["grads"][name] for res in ranks])
        out.append((name, got, want))
    return out


@pytest.mark.parametrize("case", CASES)
def test_pipeline_forward_matches_jax(world, case):
    """Every microbatch's output on every rank within 1e-5 of the
    reference's pipeline (tanh) or of its layer body applied period after
    period (the LM), the ranks bitwise equal, and the no-grad forward
    bitwise the autograd one."""
    IN, ref, ranks = world
    want = ref[case]["y"]
    for r, res in enumerate(ranks):
        got = res[case]["y"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(
            1.0, float(np.abs(want).max())), err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, ranks[0][case]["y"])
        np.testing.assert_array_equal(res[case]["y_nograd"], got)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_gradients_match_jax(world, case):
    """``jax.grad`` of the reference: every stage's parameter gradient (on
    the rank that runs the stage) and dX (whole on every rank) within 1e-5
    of their max|g|; a rank holding the whole stack gets zeros outside its
    own stage."""
    IN, ref, ranks = world
    for name, got, want in _stage_grads(case, ranks, ref):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=name)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[case]["x"], ref[case]["x"], rtol=0,
                                   atol=TOL * float(np.abs(
                                       ref[case]["x"]).max()),
                                   err_msg=f"dX rank {r}")
        np.testing.assert_array_equal(res[case]["x"], ranks[0][case]["x"])
        if case != "lm":
            g = res[case]["grads"]["w"]
            others = np.delete(g, res[case]["stage"], axis=0)
            assert not others.any()


@pytest.mark.parametrize("case", CASES)
def test_pipeline_skips_bubbles_and_counts_its_collectives(world, case):
    """A stage runs ``layer_fn`` on its M microbatches only (M + M
    recomputes in the backward), shifts M + S - 2 times each way with one
    microbatch's bytes, and broadcasts twice (the output from the last
    stage, dX from stage 0)."""
    IN, _, ranks = world
    m, mb_bytes = IN[case]["x"].shape[0], IN[case]["x"][0].nbytes
    for r, res in enumerate(ranks):
        got = res[case]
        assert got["fwd_calls"] == m and got["calls"] == 2 * m
        fwd, st = got["fwd_stats"], got["stats"]
        assert fwd["ppermute:pipe"]["calls"] == m + S - 2
        assert st["ppermute:pipe"]["calls"] == 2 * (m + S - 2)
        assert st["ppermute:pipe"]["bytes"] == 2 * (m + S - 2) * mb_bytes
        assert fwd["broadcast:pipe"]["calls"] == 1
        assert st["broadcast:pipe"]["calls"] == 2
        assert set(st) == {"ppermute:pipe", "broadcast:pipe"}
        assert got["stage"] == r


@pytest.mark.parametrize("transport", ["group", "staged"])
@pytest.mark.parametrize("shift", SHIFTS)
def test_ppermute_is_the_ring_shift(world, transport, shift):
    """``ProcessMesh.ppermute``: rank i receives rank (i - shift) mod 4's
    tensor, through the process group and through shared staging."""
    _, _, ranks = world
    key = "shift" if transport == "group" else "staged_shift"
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[key][shift],
                                      np.full(3, float((r - shift) % S)))


def test_pipeline_through_shared_staging_is_bitwise(world):
    """The tanh pipeline with its shifts and broadcasts through
    ``SharedStaging`` (host files, 4 KiB chunks): outputs and gradients
    bitwise the process group's."""
    _, _, ranks = world
    for res in ranks:
        for key in ("y", "x"):
            np.testing.assert_array_equal(res["staged"][key],
                                          res["tanh_m6"][key])
        np.testing.assert_array_equal(res["staged"]["grads"]["w"],
                                      res["tanh_m6"]["grads"]["w"])


def test_stage_params_of_another_stack_raise():
    """A leaf stacked over neither the stages nor one block is refused."""
    from repro_torch.launch.pipeline import _stage_block
    ok = _stage_block({"w": torch.zeros(4, 2), "b": torch.ones(1, 3)}, 4, 2)
    assert ok["w"].shape == (2,) and ok["b"].shape == (3,)
    with pytest.raises(ValueError, match="leading dim 3"):
        _stage_block({"w": torch.zeros(3, 2)}, 4, 0)
