"""The dry-run (``launch/dryrun.py``, ``launch/analysis.py``, the dry mesh
of ``launch/mesh.py``) against the JAX reference and against a real run.

  * ``count_params`` / ``count_expert_params`` / ``model_flops_estimate``
    equal the reference's exactly for every registry config, full and
    smoke, at every shape;
  * ``Roofline.to_dict()`` equals the reference's under the same constants
    (the reference's TPU constants handed to the port, and the port's H100
    constants patched into the reference);
  * the dry mesh's collective counts (calls and bytes per ``op:axis``)
    equal every rank's ``ProcessMesh.stats`` from a real 4-rank gloo run
    of the same step: the smoke train step of deepseek_7b and qwen3_moe
    over (2, 2), (4, 1) and (1, 4), their decode step over (2, 2), and
    their train, prefill and decode steps over the pod meshes (2, 2, 1)
    and (2, 1, 2) on ("pod", "data", "model") (world 4 started once; four
    processes, one torch thread each, no JAX);
  * a dense arch's train cell on a dry (2, 2, 2) pod mesh at B does rank
    0 of (2, 2) at B / 2's work exactly, and its collectives are (2, 2)'s
    plus the pod axis's;
  * ``run_cell`` writes the reference's keys (the reference's own
    ``run_cell`` at a smoke config, small shapes and a (1, 1) mesh);
    ``main`` writes a cell's JSON, and with ``--multipod`` a multipod
    cell's;
  * no dispatched op of a dry-run leaves the meta device.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _dryrun_reference import SMALL, small_shapes, torch_shape  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES as TORCH_SHAPES  # noqa: E402
from repro_torch.launch import analysis as ha  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import ProcessMesh, make_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DEADLINE_S = 240
TRAIN_MESHES = ((2, 2), (4, 1), (1, 4))
STAT_ARCHS = ("deepseek_7b", "qwen3_moe_235b_a22b")
POD_MESHES = ((2, 2, 1), (2, 1, 2))
#: (arch, kind, mesh) of every real-run case
STAT_CASES = [(a, "train", m) for a in STAT_ARCHS for m in TRAIN_MESHES] + \
    [(a, "decode", (2, 2)) for a in STAT_ARCHS] + \
    [(a, k, m) for a in STAT_ARCHS for m in POD_MESHES
     for k in ("train", "prefill", "decode")]
STAT_IDS = [f"{a}-{k}-{'x'.join(map(str, m))}" for a, k, m in STAT_CASES]
#: the mesh axes by the mesh's rank
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
DENSE_ARCHS = ("gemma3_4b", "deepseek_7b")
CONFIGS = [(a, s) for a in ARCHS for s in (False, True)]
CONFIG_IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS]


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=CONFIG_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch, smoke):
    jc, tc = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jp, tp = jax_specs.params_specs(jc), specs.params_specs(tc)
    n, ne = ha.count_params(tp), ha.count_expert_params(tp)
    assert n == jha.count_params(jp)
    assert ne == jha.count_expert_params(jp)
    for name in SHAPES:
        assert ha.model_flops_estimate(
            tc, TORCH_SHAPES[name], n, ne, SHAPES[name].kind) == \
            jha.model_flops_estimate(jc, SHAPES[name], n, ne,
                                     SHAPES[name].kind)


ROOF_CASES = [dict(flops=3.1e15, hbm_bytes=2.2e12, coll_bytes=4.5e10,
                   n_devices=256, model_flops=2.0e16),
              dict(flops=1.0e9, hbm_bytes=8.0e12, coll_bytes=0.0,
                   n_devices=1, model_flops=5e8),
              dict(flops=1.0e12, hbm_bytes=1.0e6, coll_bytes=9.0e12,
                   n_devices=16),
              dict(flops=0.0, hbm_bytes=0.0, coll_bytes=0.0, n_devices=4)]


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_equals_the_reference_under_the_same_constants(
        case, monkeypatch):
    kw = ROOF_CASES[case]
    tpu = dict(peak_flops=jha.PEAK_FLOPS, hbm_bw=jha.HBM_BW,
               link_bw=jha.LINK_BW)
    assert ha.Roofline(**kw, **tpu).to_dict() == \
        jha.Roofline(**kw).to_dict()
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jha, name, getattr(ha, name))
    assert ha.Roofline(**kw).to_dict() == jha.Roofline(**kw).to_dict()


def test_h100_constants():
    r = ha.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=450e9,
                    n_devices=1)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# the dry mesh against a real 4-rank run
# ---------------------------------------------------------------------------

# The program each rank runs (``python -c``): the port alone, rank r's
# ProcessMesh.stats after each case's step pickled to <workdir>/rank<r>.pkl.
RANK_PROGRAM = textwrap.dedent('''
    import os, pickle, sys, traceback
    sys.modules["jax"] = None
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import cell_step
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, init_process_mesh)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    gen = torch.Generator().manual_seed(rank)

    def make(shape, dtype):
        if dtype.is_floating_point:
            return (0.02 * torch.randn(shape, generator=gen)).to(dtype)
        return torch.zeros(shape, dtype=dtype)

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for arch, kind, shape in IN["cases"]:
            mesh = init_process_mesh(tuple(shape), IN["axes"][len(shape)])
            step, args, _ = cell_step(get_config(arch, smoke=True),
                                      ShapeSpec(*IN["shapes"][kind]), mesh,
                                      make=make)
            mesh.reset_stats()
            step(*args)
            R[(arch, kind, tuple(shape))] = (mesh.coordinate, {
                k: {"calls": v["calls"], "bytes": v["bytes"]}
                for k, v in sorted(mesh.stats.items())})
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


@pytest.fixture(scope="module")
def real_stats(tmp_path_factory):
    """[rank] -> {(arch, kind, mesh): (coordinate, stats)} of the real
    run."""
    workdir = tmp_path_factory.mktemp("dryrun_world")
    shapes = {k: (torch_shape(k).name, torch_shape(k).seq_len,
                  torch_shape(k).global_batch, k) for k in SMALL}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": STAT_CASES, "shapes": shapes, "axes": AXES},
                    f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    t0 = time.perf_counter()
    procs = []
    for r in range(WORLD):
        log = open(workdir / f"log{r}.txt", "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM, str(r), str(WORLD),
             str(workdir)], env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    for p in procs:
        try:
            p.wait(timeout=max(1.0, DEADLINE_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            pytest.fail(f"a rank ran past {DEADLINE_S} s; killed them all")
    out = []
    for r, p in enumerate(procs):
        path = workdir / f"rank{r}.pkl"
        if not path.exists():
            log = (workdir / f"log{r}.txt").read_bytes().decode(
                errors="replace")[-4000:]
            pytest.fail(f"rank {r} exited {p.returncode} without results:\n"
                        f"{log}")
        res = pickle.loads(path.read_bytes())
        if "error" in res:
            pytest.fail(f"rank {r} failed:\n{res['error']}")
        out.append(res["ok"])
    return out


@pytest.mark.parametrize("arch,kind,shape", STAT_CASES, ids=STAT_IDS)
def test_dry_mesh_counts_equal_a_real_run(arch, kind, shape, real_stats):
    """Every rank's collective calls and bytes equal the dry mesh's at
    that rank's coordinate, rank 0's the dry-run's own. On a pod mesh
    the counts come one key an axis moved (``:pod`` beside ``:data``).
    On (2, 2, 1) a prefill (its rows, or the whole batch where they do
    not divide) and a dense decode -- no model axis -- make none; a MoE
    decode gathers its rows over the dp axes."""
    cfg = get_config(arch, smoke=True)
    mesh = make_mesh(shape, AXES[len(shape)])
    for r, ranks in enumerate(real_stats):
        coord, stats = ranks[(arch, kind, shape)]
        dry = ProcessMesh.dry(mesh, coord)
        assert dry.rank == r
        got = dryrun.trace_cell(cfg, torch_shape(kind), dry)["stats"]
        assert got == stats, (r, coord)
        if kind == "train" or shape[-1] > 1 or (kind == "decode"
                                                and cfg.n_experts):
            assert stats, "the case makes no collective"
        if kind == "train" and len(shape) == 3:
            assert any(k.endswith(":pod") for k in stats), stats
    assert dryrun.trace_cell(cfg, torch_shape(kind), mesh)["stats"] == \
        real_stats[0][(arch, kind, shape)][1]


# ---------------------------------------------------------------------------
# run_cell, main and the dry run's device
# ---------------------------------------------------------------------------

def _keys(d):
    """The nested key structure of a JSON dict."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_run_cell_writes_the_reference_keys(kind, monkeypatch, tmp_path):
    name = SMALL[kind][0]
    with small_shapes() as rd:
        monkeypatch.setattr(rd, "get_config",
                            lambda a: jax_config(a, smoke=True))
        monkeypatch.setattr(rd, "make_production_mesh",
                            lambda multi_pod=False: jax.make_mesh(
                                (1, 1), ("data", "model")))
        ref = rd.run_cell("deepseek_7b", name, False, str(tmp_path))
    assert ref["status"] == "OK", ref.get("error")
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a, smoke=True))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_mesh(
                            (1, 1), ("data", "model")))
    monkeypatch.setattr(dryrun, "SHAPES", {name: torch_shape(kind)})
    got = dryrun.run_cell("deepseek_7b", name, False, str(tmp_path))
    assert got["status"] == "OK", got.get("error")
    want = _keys(ref)
    for k in ("lower_s", "compile_s", "xla_cost_raw"):
        del want[k]                     # no XLA: trace_s takes their place
    have = _keys(got)
    assert "trace_s" in have
    assert {k: have[k] for k in want} == want
    assert got["n_params"] == ref["n_params"]
    assert got["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert got["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    if kind == "decode":
        assert "decode_attention" in got["counted"]


def test_skipped_cells_say_why(tmp_path):
    got = dryrun.run_cell("bert_base", "decode_32k", False, str(tmp_path))
    assert (got["status"], got["reason"]) == (
        "SKIP", "encoder-only: no decode step")


def test_main_writes_a_cell_and_a_multipod_cell(monkeypatch, tmp_path,
                                                capsys):
    """``main`` writes a cell's JSON on the (patched) one-pod mesh and,
    with ``--multipod``, the multipod cell's on the (patched) pod mesh:
    both OK, the multipod cell's collectives over "pod" too."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a, smoke=True))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_mesh(
                            (2, 2, 2), AXES[3]) if multi_pod
                        else make_mesh((2, 2), AXES[2]))
    monkeypatch.setattr(dryrun, "SHAPES",
                        {"train_4k": torch_shape("train")})
    for flags, tag, mesh, n in (([], "pod", "2x2", 4),
                                (["--multipod"], "multipod", "2x2x2", 8)):
        dryrun.main(["--arch", "gemma3_4b", "--shape", "train_4k", "--out",
                     str(tmp_path)] + flags)
        cell = json.loads((tmp_path / f"gemma3_4b__train_4k__{tag}.json")
                          .read_text())
        assert (cell["status"], cell["mesh"], cell["n_devices"]) == (
            "OK", mesh, n), cell.get("error")
        assert cell["collectives"]["total"] > 0
        pod = [k for k in cell["collective_calls"] if k.endswith(":pod")]
        assert bool(pod) == (tag == "multipod"), cell["collective_calls"]
        assert '"status": "OK"' in capsys.readouterr().out


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_pod_cell_is_half_batch_one_pod_cell(arch):
    """A dense arch's train cell: rank 0 of a dry (2, 2, 2) pod mesh at
    B rows does exactly the flops of rank 0 of (2, 2) at B / 2 (the same
    rows a rank, the same weight shards: "pod" cuts no weight), and its
    collectives are (2, 2)'s, call for call and byte for byte, plus
    entries under ``:pod`` (the gradients' and metrics' sums over the
    second pod, the embedding rows' gather)."""
    cfg = get_config(arch, smoke=True)
    name, s, b = SMALL["train"]
    pod = dryrun.trace_cell(cfg, specs.ShapeSpec(name, s, b, "train"),
                            make_mesh((2, 2, 2), AXES[3]))
    one = dryrun.trace_cell(cfg, specs.ShapeSpec(name, s, b // 2, "train"),
                            make_mesh((2, 2), AXES[2]))
    assert pod["flops"] == one["flops"] > 0
    extra = {k: v for k, v in pod["stats"].items() if k.endswith(":pod")}
    assert extra and all(v["calls"] > 0 for v in extra.values())
    assert {k: v for k, v in pod["stats"].items()
            if not k.endswith(":pod")} == one["stats"]


class _Devices(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the device of every tensor an op puts out."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (list, tuple)) else [out]
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.seen.add((t.device.type, t.dim() == 0 or not t.numel()))
        return out


@pytest.mark.parametrize("arch", ["gemma3_4b", "qwen3_moe_235b_a22b",
                                  "whisper_base", "mamba2_780m"])
def test_no_op_leaves_the_meta_device(arch):
    cfg = get_config(arch, smoke=True)
    mesh = make_mesh((2, 2), ("data", "model"))
    for kind in SMALL:
        with _Devices() as spy:
            dryrun.trace_cell(cfg, torch_shape(kind), mesh)
        assert {d for d, scalar in spy.seen if not scalar} == {"meta"}


def test_a_dry_mesh_refuses_real_tensors():
    dry = ProcessMesh.dry(make_mesh((1, 2), ("data", "model")), (0, 1))
    assert (dry.rank, dry.coord("model"), dry.is_dry) == (1, 1, True)
    out = dry.all_gather(torch.empty(3, 2, device="meta"), "model", dim=0)
    assert out.shape == (6, 2) and out.is_meta
    assert dry.stats["all_gather:model"] == {"calls": 1, "bytes": 48,
                                             "s": dry.stats[
                                                 "all_gather:model"]["s"]}
    with pytest.raises(ValueError, match="meta tensors only"):
        dry.all_reduce(torch.ones(3), "model")
    with pytest.raises(ValueError, match="not on"):
        ProcessMesh.dry(make_mesh((1, 2), ("data", "model")), (0, 2))


def test_agree_takes_the_ranks_own_value_on_a_dry_mesh():
    from repro_torch.serving.servable import _agree_on
    dry = ProcessMesh.dry(make_mesh((2, 2), ("data", "model")), (1, 1))
    assert _agree_on(dry, 7, "cpu") == 7
    assert dry.stats["broadcast:data"]["calls"] == 1
    assert dry.stats["broadcast:model"]["calls"] == 1


def test_long_context_decode_replicates_its_one_slot():
    """long_500k's (1, 1) token does not divide over 16 data ranks, and
    neither does its one position (the sequence-parallel branch cuts a
    one-row leaf's dim 1 only where it divides): the slot replicates, as
    the reference's."""
    cfg = get_config("mamba2_780m", smoke=True)
    got = dryrun.trace_cell(cfg, specs.shape_spec("long_500k"),
                            make_mesh((16, 16), ("data", "model")))
    assert got["flops"] > 0
