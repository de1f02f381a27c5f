"""Block-sparse gradient compression (``repro_torch.optim.compression``)
against the JAX reference (``repro.optim.compression``) on the CPU.

The reference runs ONCE, in one subprocess with four fake CPU devices
(``--xla_force_host_platform_device_count=4``), and writes its results
under the module's temporary directory: ``compress`` / ``decompress`` on
single tensors (fp32 and bf16 gradients, densities 0.05, 0.25 and 1.0, an
input whose block norms tie), ``compressible`` / ``init_error_buffers``
over the BERT smoke tree, and ``compressed_allreduce`` under ``shard_map``
with per-device gradients over ``data`` (4) and over ``("pod", "data")``
(2 x 2). Four gloo ranks (``file://`` init, 60 s collective timeouts, one
torch thread each; they import no JAX) run the port's
``compressed_allreduce`` over a ``ProcessMesh`` of the same shapes. Every
value, index, mean and error buffer must be bitwise the reference's.
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
WORLD = 4                               # _launch's ranks
SHAPE = (256, 1024)                     # 256 blocks of (8, 128)
DENSITIES = (0.05, 0.25, 1.0)
DTYPES = ("float32", "bfloat16")
#: the mesh runs: (name, mesh shape, axis names, reduced axes, dtype,
#: density)
MESH_RUNS = (("data_f32", (4, 1), ("data", "model"), "data", "float32",
              0.05),
             ("data_bf16", (4, 1), ("data", "model"), "data", "bfloat16",
              0.05),
             ("data_dense", (4, 1), ("data", "model"), "data", "float32",
              1.0),
             ("pod_data", (2, 2), ("pod", "data"), ("pod", "data"),
              "float32", 0.05))
#: a small config under which the BERT smoke tree has compressible leaves
SMALL = dict(block_shape=(8, 64), density=0.1, min_size=4096)

# The reference's side, run once with four fake devices.
JAX_PROGRAM = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import get_config
    from repro.models import init_model
    from repro.optim import compression as C
    from repro.runtime.compat import shard_map
    workdir = sys.argv[1]
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    def dt(name):
        return jnp.bfloat16 if name == "bfloat16" else jnp.float32

    out = {"single": {}, "ties": {}, "mesh": {}}
    for dtype in IN["dtypes"]:
        for dens in IN["densities"]:
            cfg = C.CompressionConfig(density=dens)
            g = jnp.asarray(IN["g"]).astype(dt(dtype))
            v, i, e = C.compress(g, jnp.asarray(IN["err"]), cfg)
            d = C.decompress(v, i, IN["g"].shape, cfg)
            out["single"][(dtype, dens)] = tuple(
                np.asarray(x) for x in (v, i, e, d))
    cfg = C.CompressionConfig(density=IN["tie_density"])
    v, i, e = C.compress(jnp.asarray(IN["tie_g"]),
                         jnp.zeros(IN["tie_g"].shape, jnp.float32), cfg)
    out["ties"] = tuple(np.asarray(x) for x in (v, i, e))

    params = init_model(jax.random.PRNGKey(0), get_config("bert_base",
                                                           smoke=True))
    out["bert"] = jax.tree.map(np.asarray, params)
    for name, kw in (("default", {}), ("small", IN["small"])):
        cfg = C.CompressionConfig(**kw)
        out["bert_" + name] = (
            jax.tree.map(lambda p: C.compressible(p, cfg), params),
            jax.tree.map(np.asarray, C.init_error_buffers(params, cfg)))

    for name, shape, axes, red, dtype, dens in IN["mesh_runs"]:
        mesh = jax.make_mesh(shape, axes)
        cfg = C.CompressionConfig(density=dens)
        spec = P(red)

        @partial(shard_map, mesh=mesh, in_specs=(spec, spec),
                 out_specs=(spec, spec), check_vma=False)
        def sync(g, e):
            mean, new_e = C.compressed_allreduce(g[0], e[0], cfg, red)
            return mean[None], new_e[None]

        g = jnp.asarray(IN["rank_g"]).astype(dt(dtype))
        mean, new_e = jax.jit(sync)(g, jnp.asarray(IN["rank_err"]))
        out["mesh"][name] = (np.asarray(mean.astype(jnp.float32)),
                             np.asarray(new_e))
    with open(os.path.join(workdir, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
''')

# The program each rank runs (``python -c``): the port alone.
RANK_PROGRAM = textwrap.dedent('''
    import os, pickle, sys, traceback
    sys.modules["jax"] = None
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)
    from repro_torch.optim.compression import (CompressionConfig,
                                               compressed_allreduce,
                                               make_compressed_sync)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for name, shape, axes, red, dtype, dens in IN["mesh_runs"]:
            mesh = init_process_mesh(shape, axes)
            g = torch.from_numpy(IN["rank_g"][rank]).to(getattr(torch,
                                                                 dtype))
            e = torch.from_numpy(IN["rank_err"][rank])
            cfg = CompressionConfig(density=dens)
            mesh.reset_stats()
            if name == "data_f32":
                mean, new_e = make_compressed_sync(mesh, red, cfg)(g, e)
            else:
                mean, new_e = compressed_allreduce(g, e, cfg, red, mesh)
            R[name] = {"mean": mean.float().numpy(), "dtype": str(mean.dtype),
                       "err": new_e.numpy(), "coord": mesh.coordinate,
                       "stats": {k: dict(v) for k, v in mesh.stats.items()}}
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


def _tie_input(rng):
    """(64, 512): 32 blocks of (8, 128) with exact ties in the norm: one
    block copied to three places (the largest norm) and another to two
    places at the top-8 boundary, so the order among equal norms decides
    both the indices' order and which block is kept."""
    blocks = rng.randn(32, 8, 128).astype(np.float32)
    top = 3.0 * rng.randn(8, 128).astype(np.float32)
    edge = blocks[0].copy()
    norms = (blocks ** 2).sum(axis=(1, 2))
    for j in (20, 5, 11):
        blocks[j] = top
    # seven blocks above the boundary (top x 3, four more), then the tie
    order = [j for j in np.argsort(-norms, kind="stable")
             if j not in (20, 5, 11)]
    for j in order[:4]:
        blocks[j] *= 2.0
    for j in (order[-1], order[-2]):
        blocks[j] = 1.5 * edge
    return blocks.reshape(8, 4, 8, 128).transpose(0, 2, 1, 3).reshape(64,
                                                                      512)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the inputs, the reference's results, each rank's results)."""
    workdir = tmp_path_factory.mktemp("compression")
    rng = np.random.RandomState(0)
    IN = {"g": rng.randn(*SHAPE).astype(np.float32),
          "err": (0.1 * rng.randn(*SHAPE)).astype(np.float32),
          "tie_g": _tie_input(rng), "tie_density": 0.25,
          "rank_g": rng.randn(WORLD, *SHAPE).astype(np.float32),
          "rank_err": (0.1 * rng.randn(WORLD, *SHAPE)).astype(np.float32),
          "dtypes": DTYPES, "densities": DENSITIES, "small": SMALL,
          "mesh_runs": MESH_RUNS}
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


def _tensor(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_decompress_bitwise_jax(world, dtype, density):
    """``compress`` (values, indices in top-K order, new error) and
    ``decompress`` of its output, bitwise the reference's, for an fp32 and
    a bf16 gradient at each density."""
    from repro_torch.optim.compression import (CompressionConfig, compress,
                                               decompress)
    IN, ref, _ = world
    cfg = CompressionConfig(density=density)
    v, i, e = compress(_tensor(IN["g"], dtype), torch.from_numpy(IN["err"]),
                       cfg)
    d = decompress(v, i, SHAPE, cfg)
    want = ref["single"][(dtype, density)]
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert e.dtype == torch.float32 and d.dtype == torch.float32
    for name, got, w in zip(("vals", "idx", "new_err", "decompressed"),
                            (v, i, e, d), want):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert i.numel() == max(1, int(256 * density))


def test_compress_tie_order_matches_jax(world):
    """Blocks of equal norm: ``jax.lax.top_k``'s order (the lower block
    index first), at the top and at the top-K boundary."""
    from repro_torch.optim.compression import CompressionConfig, compress
    IN, ref, _ = world
    g = torch.from_numpy(IN["tie_g"])
    v, i, e = compress(g, torch.zeros_like(g),
                       CompressionConfig(density=IN["tie_density"]))
    for name, got, w in zip(("vals", "idx", "new_err"), (v, i, e),
                            ref["ties"]):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert list(i[:3]) == [5, 11, 20]


def test_decompress_adds_repeated_blocks_in_order(world):
    """Updates that name one block several times are added in the order
    given (the reference's scatter-add): bitwise a loop of plain adds."""
    from repro_torch.optim.compression import CompressionConfig, decompress
    rng = np.random.RandomState(3)
    cfg = CompressionConfig(block_shape=(8, 128))
    vals = rng.randn(40, 8, 128).astype(np.float32)
    idx = rng.randint(0, 6, 40).astype(np.int32)
    got = decompress(torch.from_numpy(vals), torch.from_numpy(idx),
                     (16, 384), cfg)
    blocks = np.zeros((6, 8, 128), np.float32)
    for v, j in zip(vals, idx):
        blocks[j] = blocks[j] + v
    want = blocks.reshape(2, 3, 8, 128).transpose(0, 2, 1, 3).reshape(16,
                                                                      384)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cfg_name", ["default", "small"])
def test_compressible_and_error_buffers_match_jax(world, cfg_name):
    """``compressible`` and ``init_error_buffers`` over the BERT smoke tree,
    carried across by ``bridge.py``: the same leaves compressible, the same
    fp32 zero buffers (``(1,)`` elsewhere)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.optim.compression import (CompressionConfig,
                                               compressible,
                                               init_error_buffers)
    _, ref, _ = world
    params = params_from_numpy(ref["bert"])
    cfg = CompressionConfig(**({} if cfg_name == "default" else SMALL))
    want_c, want_e = ref["bert_" + cfg_name]
    got_c = {path_name(p): compressible(x, cfg)
             for p, x in flatten_with_path(params)}
    assert got_c == {path_name(p): bool(x)
                     for p, x in flatten_with_path(want_c)}
    assert any(got_c.values()) == (cfg_name == "small")
    bufs = init_error_buffers(params, cfg)
    got_e = dict((path_name(p), x) for p, x in flatten_with_path(bufs))
    for p, w in flatten_with_path(want_e):
        x = got_e[path_name(p)]
        assert x.dtype == torch.float32 and tuple(x.shape) == w.shape
        assert not x.any()


@pytest.mark.parametrize("run", [r[0] for r in MESH_RUNS])
def test_compressed_allreduce_bitwise_jax(world, run):
    """Four ranks' ``compressed_allreduce`` against the reference under
    ``shard_map`` with per-device gradients: every rank's mean (in the
    gradient's dtype) and its new error buffer bitwise; over ("pod",
    "data") the peers in JAX's order (pod major)."""
    IN, ref, ranks = world
    name, shape, axes, red, dtype, dens = next(r for r in MESH_RUNS
                                               if r[0] == run)
    mean, err = ref["mesh"][run]
    for r, res in enumerate(ranks):
        got = res[run]
        assert got["dtype"] == f"torch.{dtype}"
        np.testing.assert_array_equal(got["mean"], mean[r],
                                      err_msg=f"mean, rank {r}")
        np.testing.assert_array_equal(got["err"], err[r],
                                      err_msg=f"error, rank {r}")
        np.testing.assert_array_equal(got["mean"], ranks[0][run]["mean"])
        if run == "pod_data":
            assert got["coord"] == (r // 2, r % 2)
            assert set(got["stats"]) == {"all_gather:pod", "all_gather:data"}


def test_compressed_allreduce_at_full_density_is_the_mean(world):
    """density 1.0 keeps every block: the mean of the four ranks' g + err,
    up to the order of the fp32 sums, and no error left."""
    IN, _, ranks = world
    want = (IN["rank_g"] + IN["rank_err"]).mean(axis=0)
    for res in ranks:
        got = res["data_dense"]
        np.testing.assert_allclose(got["mean"], want, rtol=1e-6, atol=1e-6)
        assert not got["err"].any()


def test_compressed_allreduce_conserves_and_counts_bytes(world):
    """What the ranks keep and send adds up: P x the mean plus every rank's
    new error equals the sum of their g + err (within fp32 order), and each
    rank's ``stats`` count P*K*bh*bw*4 + P*K*4 all-gather bytes in two
    calls over "data"."""
    IN, _, ranks = world
    mean = ranks[0]["data_f32"]["mean"]
    kept = WORLD * mean + sum(r["data_f32"]["err"] for r in ranks)
    total = (IN["rank_g"] + IN["rank_err"]).sum(axis=0)
    np.testing.assert_allclose(kept, total, rtol=1e-6, atol=1e-5)
    k = int(256 * 0.05)
    for res in ranks:
        st = res["data_f32"]["stats"]
        assert set(st) == {"all_gather:data"}
        assert st["all_gather:data"]["calls"] == 2
        assert st["all_gather:data"]["bytes"] == (WORLD * k * 8 * 128 * 4
                                                  + WORLD * k * 4)
