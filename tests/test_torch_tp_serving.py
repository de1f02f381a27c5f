"""Mesh-first serving across ranks on the CPU: the port's mesh servables
against the JAX single-device servable on the same weights.

``tests/test_sharded_serving.py``'s contract, held by explicit SPMD: a
servable prepared with ``mesh_shape`` reproduces the single-device one --
logits within 1e-5 in fp32, greedy tokens equal -- while its packs and slot
caches partition across the ranks. The module starts world 4 ONCE (four
processes, gloo, ``file://`` init under the test's temporary directory, one
torch thread each; they import no JAX) and runs every case there; the
parent computes the JAX side meanwhile, then the parametrised tests assert
on the results, so each case still counts:

  * tp (1, 4): forward and ``decode_many``; the sharded export and its
    per-device bytes;
  * the engine over tp (1, 4), dp (4, 1) and tp+dp (2, 2), token for token
    against the JAX engine; cache leaves' local shapes follow
    ``spec_for_cache`` and never change through the slot lifecycle; slot
    recycling equals fresh engines;
  * BERT (smoke) over tp at tile 32: replicated attention packs beside
    sharded FFN packs;
  * deepseek_7b and chatglm3_6b (smoke) engines over tp: dense sharded FFN
    leaves, and chatglm3's 2 KV heads keep its cache replicated;
  * paged KV under tp; int8 ``QuantPlan(ShardedPlan)`` packs; chunked
    prefill on a data-sharded engine; ``place_servable``; a measured
    ``backend='auto'`` (stub proxy) agreed across ranks;
  * save -> load per rank (a sharded export saved by one process, and a
    mesh servable's collective save), logits within 1e-6.

A rank that fails or hangs fails the module: the collectives carry a 60 s
timeout and the parent kills the ranks after ``DEADLINE_S``.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DEADLINE_S = 420
ALL = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/wi", "ffn/wg",
       "ffn/wo")
ATTN = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
PARTITIONS = (("tp", (1, 4)), ("dp", (4, 1)), ("tp+dp", (2, 2)))
FAMILIES = ("deepseek_7b", "chatglm3_6b")

#: the spec keywords of each case (port and JAX alike)
SPECS = {
    "tp": dict(tile=(32, 32), sparsity=0.7, prune="tied", targets=ALL),
    "bert": dict(tile=(32, 32), sparsity=0.5, prune="tied",
                 cross_layer_union=True),
    "family": dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                   targets=ATTN),
}
#: chunked prefill on the dp engine (prompts of 3-13 tokens, chunks of 4)
SCHED = dict(max_chunk=4, token_budget=16)
TP_CFG = dict(arch="tp-smoke", family="dense", n_layers=4, d_model=256,
              n_heads=8, n_kv_heads=8, head_dim=32, d_ff=1024,
              vocab_size=1024, dtype="float32")


def _prompts(vocab, n, base=3, step=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (base + step * i,)).tolist()
            for i in range(n)]


# The program each rank runs (``python -c``): the port alone, results
# pickled to <workdir>/rank<r>.pkl.
RANK_PROGRAM = textwrap.dedent('''
    import copy, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerKind, ModelConfig
    from repro_torch.launch.mesh import (destroy_distributed,
                                         init_distributed, make_mesh)
    from repro_torch.launch.sharding import shard_shape, spec_for_cache
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.sharding import leaf_name
    from repro_torch.serving import (SchedSpec, ServingSpec, load_servable,
                                     place_servable, prepare_servable)

    os.environ["REPRO_AUTOTUNE_STUB"] = "1"
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
        workdir, f"autotune{rank}.json")
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    CPU = "cpu"

    def cfg_of(name):
        if name == "tp":
            return ModelConfig(pattern=(LayerKind("attn", "dense"),),
                               **IN["tp_cfg"])
        return get_config({"bert": "bert_base"}.get(name, name), smoke=True)

    def spec(case, **kw):
        return ServingSpec(**dict(IN["specs"][case], **kw))

    def params(name):
        return params_from_numpy(IN["params"][name], CPU)

    def shapes(cache):
        return {leaf_name(p): tuple(x.shape) for p, x in
                flatten_with_path(cache)}

    def run_engine(sv, prompts, slots, max_new=8, **kw):
        eng = sv.engine(max_slots=slots, cache_len=64, sync_every=4, **kw)
        before = shapes(eng.cache)
        hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run()
        eng.verify_invariants()
        assert shapes(eng.cache) == before, "a cache leaf changed shape"
        return ([(h.status, list(h.tokens)) for h in hs], before,
                eng.kv_layout)

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        cfg, p = cfg_of("tp"), params("tp")
        toks = np.asarray(IN["toks"])
        sv = prepare_servable(p, cfg, spec("tp", mesh_shape=(1, 4),
                                           partition="tp"), device=CPU)
        R["coord"] = sv.mesh.coordinate
        R["tp_forward"] = sv.forward(toks).numpy()
        cache = sv.init_cache(2, 32)
        R["tp_cache2"] = shapes(cache)
        t, v, _ = sv.decode_many(cache, toks[:, :1],
                                 np.zeros((2,), np.int32), 6)
        R["tp_decode_many"] = (t.numpy(), v.numpy())
        st = sv.stats()["sharding"]
        R["tp_stats"] = st
        R["tp_kinds"] = {k: type(pk).__name__ for k, pk in sv.packs.items()}
        R["tp_wqkv_local"] = tuple(
            sv.params["blocks"][0]["attn"]["wqkv"]["w"].shape)
        prompts = IN["prompts"]
        for part, shape in IN["partitions"]:
            s = sv if part == "tp" else prepare_servable(
                p, cfg, spec("tp", mesh_shape=tuple(shape), partition=part),
                device=CPU)
            s.mesh.reset_stats()
            got, local, _ = run_engine(s, prompts, 8)
            R["engine_" + part] = got
            R["cache_" + part] = local
            R["mesh_stats_" + part] = copy.deepcopy(s.mesh.stats)
            m = make_mesh(tuple(shape), ("data", "model"))
            R["spec_cache_" + part] = {
                n: shard_shape(sh, spec_for_cache(n, sh, m), m)
                for n, sh in IN["whole_cache"].items()}
        # slot recycling: 2 slots, 4 requests == each request on a fresh
        # 1-slot engine
        rp = IN["recycle_prompts"]
        R["recycled"] = run_engine(sv, rp, 2, max_new=6)[0]
        R["fresh"] = [run_engine(sv, [q], 1, max_new=6)[0][0] for q in rp]
        # paged KV under tp
        got, _, layout = run_engine(sv, prompts, 8, kv_layout="paged")
        R["paged"], R["paged_layout"] = got, layout
        # chunked prefill on a data-sharded engine: the rank holding the
        # slot prefills each chunk and sends the logits row
        sdp = prepare_servable(p, cfg, spec("tp", mesh_shape=(4, 1),
                                            partition="dp"), device=CPU)
        R["dp_chunked"] = run_engine(sdp, prompts, 8,
                                     sched=SchedSpec(**IN["sched"]))[0]
        # a whole export placed by each rank (place_servable)
        sw = prepare_servable(p, cfg, spec("tp", mesh_shape=(1, 4)),
                              device=CPU, place=False)
        R["placed_forward"] = place_servable(sw).forward(toks).numpy()
        # 'auto' (stub proxy) under tp: every rank takes rank 0's verdicts
        sa = prepare_servable(p, cfg, spec("tp", mesh_shape=(1, 4),
                                           backend="auto"), device=CPU)
        R["auto_forward"] = sa.forward(toks).numpy()
        R["auto_backends"] = sa.stats()["autotune"]["backends"]
        # int8 QuantPlan(ShardedPlan)
        sq = prepare_servable(p, cfg, spec("tp", mesh_shape=(1, 4),
                                           pack_quant="int8"), device=CPU)
        R["int8_kinds"] = {k: (type(pk).__name__,
                               type(pk.plan).__name__)
                           for k, pk in sq.packs.items()}
        R["int8_forward"] = sq.forward(toks).numpy()
        R["int8_engine"] = run_engine(sq, prompts, 8)[0]
        # save -> load per rank
        lv = load_servable(os.path.join(workdir, "saved"), device=CPU)
        R["loaded_forward"] = lv.forward(toks).numpy()
        R["loaded_kinds"] = {k: type(pk).__name__ for k, pk in
                             lv.packs.items()}
        R["loaded_wqkv_local"] = tuple(
            lv.params["blocks"][0]["attn"]["wqkv"]["w"].shape)
        R["own_forward"] = R["tp_forward"]
        sv.save(os.path.join(workdir, "mesh_saved"))
        lv2 = load_servable(os.path.join(workdir, "mesh_saved"), device=CPU)
        R["mesh_saved_forward"] = lv2.forward(toks).numpy()
        R["mesh_saved_meta"] = {k: (pk.n_shards, pk.shard_axis,
                                    pk.shard_fingerprints)
                                for k, pk in lv2.packs.items()}
        R["prepared_meta"] = {k: (pk.n_shards, pk.shard_axis,
                                  pk.shard_fingerprints)
                              for k, pk in sv.packs.items()}
        # the dense backend: every projection a dense leaf, sharded by
        # spec_for_param (wq / wk / wv rows, wo columns)
        sd = prepare_servable(p, cfg, spec("tp", mesh_shape=(1, 4),
                                           backend="dense"), device=CPU)
        R["dense_forward"] = sd.forward(toks).numpy()
        R["dense_shards"] = {k: v.axis for k, v in sd._run_packs.items()
                             if type(v).__name__ == "DenseShard"}
        # BERT over tp: replicated attention packs beside sharded FFN packs
        sb = prepare_servable(params("bert"), cfg_of("bert"),
                              spec("bert", mesh_shape=(1, 4)), device=CPU)
        R["bert_forward"] = sb.forward(np.asarray(IN["bert_toks"])).numpy()
        R["bert_stats"] = sb.stats()["sharding"]
        # the dense families with their replicated leaves
        for arch in IN["families"]:
            sf = prepare_servable(params(arch), cfg_of(arch),
                                  spec("family", mesh_shape=(1, 4)),
                                  device=CPU)
            got, local, _ = run_engine(sf, IN["family_prompts"], 2,
                                       max_new=6)
            R["family_" + arch] = got
            R["family_cache_" + arch] = local
            R["family_dense_shards_" + arch] = sorted(
                k for k, v in sf._run_packs.items()
                if type(v).__name__ == "DenseShard")
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _scaled(jp):
    """Attention / FFN weights x20 (``test_torch_engine.py``): at the init
    scale a smoke LM repeats its input token and greedy parity says
    nothing."""
    import jax

    def one(path, x):
        names = [str(getattr(k, "key", "")) for k in path]
        if ("attn" in names or "ffn" in names) and not any(
                "norm" in n for n in names):
            return x * 20.0
        return x
    return jax.tree_util.tree_map_with_path(one, jp)


def _jax_engine(sv, prompts, slots, max_new=8, **kw):
    eng = sv.engine(max_slots=slots, cache_len=64, sync_every=4, **kw)
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [(h.status, list(h.tokens)) for h in hs]


def _launch(workdir, program=RANK_PROGRAM, world=WORLD):
    """``world`` rank processes running ``program`` (argv: rank, world,
    workdir), one torch thread each, with the port on their path."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen([sys.executable, "-c", program, str(r),
                              str(world), str(workdir)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _collect(procs, workdir, t0):
    """Wait for every rank (killing them all past the deadline) and read
    their results; a rank's error fails the module with its traceback."""
    for p in procs:
        left = max(1.0, DEADLINE_S - (time.perf_counter() - t0))
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            pytest.fail(f"a rank ran past {DEADLINE_S} s; killed them all")
    out = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            log = p.stdout.read().decode(errors="replace")[-4000:]
            pytest.fail(f"rank {r} exited {p.returncode} without results:\n"
                        f"{log}")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            pytest.fail(f"rank {r} failed:\n{res['error']}")
        out.append(res["ok"])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX single-device results, each rank's results) of every case."""
    import jax
    from repro.configs.base import LayerKind as JLayerKind
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.registry import get_config as j_config
    from repro.models import init_model as j_init
    from repro.serving import ServingSpec as JSpec
    from repro.serving import prepare_servable as j_prepare

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.base import LayerKind, ModelConfig
    from repro_torch.models import api as tapi
    from repro_torch.serving import ServingSpec, prepare_servable

    workdir = tmp_path_factory.mktemp("tp_world")
    jcfgs = {"tp": JModelConfig(pattern=(JLayerKind("attn", "dense"),),
                                **TP_CFG),
             "bert": j_config("bert_base", smoke=True),
             **{a: j_config(a, smoke=True) for a in FAMILIES}}
    jparams = {"tp": _scaled(j_init(jax.random.PRNGKey(1), jcfgs["tp"])),
               "bert": j_init(jax.random.PRNGKey(1), jcfgs["bert"]),
               **{a: _scaled(j_init(jax.random.PRNGKey(0), jcfgs[a]))
                  for a in FAMILIES}}
    nparams = {k: jax.tree.map(np.asarray, v) for k, v in jparams.items()}
    rng = np.random.RandomState(0)
    inputs = {
        "tp_cfg": TP_CFG, "specs": SPECS, "params": nparams,
        "toks": rng.randint(0, 1024, (2, 8)),
        "bert_toks": rng.randint(0, 512, (4, 16)),
        "prompts": _prompts(1024, 6), "partitions": PARTITIONS,
        "recycle_prompts": _prompts(1024, 4, base=4, step=1, seed=3),
        "family_prompts": _prompts(512, 4), "families": FAMILIES,
        "sched": SCHED,
    }
    tcfg = ModelConfig(pattern=(LayerKind("attn", "dense"),), **TP_CFG)
    whole = tapi.init_cache(params_from_numpy(nparams["tp"]), tcfg, 8, 64)
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.sharding import leaf_name
    inputs["whole_cache"] = {leaf_name(p): tuple(x.shape)
                             for p, x in flatten_with_path(whole)}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    # the sharded export, prepared once on one process and saved for the
    # ranks to load
    saved = prepare_servable(params_from_numpy(nparams["tp"]), tcfg,
                             ServingSpec(**SPECS["tp"], mesh_shape=(1, 4)),
                             device="cpu", place=False)
    saved.save(str(workdir / "saved"))
    del saved

    t0 = time.perf_counter()
    procs = _launch(workdir)
    try:
        # the JAX single-device side, while the ranks run
        J = {}
        js = j_prepare(jparams["tp"], jcfgs["tp"], JSpec(**SPECS["tp"]))
        J["tp_forward"] = np.asarray(js.forward(inputs["toks"]))
        t, v, _ = js.decode_many(js.init_cache(2, 32),
                                 inputs["toks"][:, :1],
                                 np.zeros((2,), np.int32), 6)
        J["tp_decode_many"] = (np.asarray(t), np.asarray(v))
        J["engine"] = _jax_engine(js, inputs["prompts"], 8)
        from repro.serving.spec import SchedSpec as JSched
        J["chunked"] = _jax_engine(js, inputs["prompts"], 8,
                                   sched=JSched(**SCHED))
        jq = j_prepare(jparams["tp"], jcfgs["tp"],
                       JSpec(**SPECS["tp"], pack_quant="int8"))
        J["int8_forward"] = np.asarray(jq.forward(inputs["toks"]))
        J["int8_engine"] = _jax_engine(jq, inputs["prompts"], 8)
        jd = j_prepare(jparams["tp"], jcfgs["tp"],
                       JSpec(**SPECS["tp"], backend="dense"))
        J["dense_forward"] = np.asarray(jd.forward(inputs["toks"]))
        jb = j_prepare(jparams["bert"], jcfgs["bert"], JSpec(**SPECS["bert"]))
        J["bert_forward"] = np.asarray(jb.forward(inputs["bert_toks"]))
        for a in FAMILIES:
            jf = j_prepare(jparams[a], jcfgs[a], JSpec(**SPECS["family"]))
            J["family_" + a] = _jax_engine(jf, inputs["family_prompts"], 2,
                                           max_new=6)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = _collect(procs, workdir, t0)
    return J, ranks, inputs


def _close(a, b, tol):
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, f"max|d| {err:.3e} > {tol}"


# --------------------------------------------------------------------------
# tp (1, 4): forward, decode_many, export
# --------------------------------------------------------------------------

def test_forward_matches_jax_single_device(world):
    J, ranks, _ = world
    for r in ranks:
        _close(r["tp_forward"], J["tp_forward"], 1e-5)
        # every rank holds the same whole logits
        assert np.array_equal(r["tp_forward"], ranks[0]["tp_forward"])
    assert sorted(r["coord"] for r in ranks) == [(0, m) for m in range(4)]


def test_decode_many_matches_jax_single_device(world):
    J, ranks, _ = world
    for r in ranks:
        assert np.array_equal(r["tp_decode_many"][0], J["tp_decode_many"][0])
        assert np.array_equal(r["tp_decode_many"][1], J["tp_decode_many"][1])


def test_sharded_export_shards_packs_and_bytes(world):
    """Every projection of the divisible config exports as a ShardedPlan,
    wqkv column-parallel and wo row-parallel; each rank holds a quarter of
    the vrows and of the pack bytes; per-shard registry counts exist."""
    _, ranks, _ = world
    for r in ranks:
        assert set(r["tp_kinds"].values()) == {"ShardedPlan"}
        st = r["tp_stats"]
        axes = {k.rsplit("/", 1)[1]: a for k, a in st["axes"].items()}
        assert axes["wqkv"] == "out" and axes["wo"] == "in"
        assert st["n_shards"] == 4 and st["replicated_packs"] == 0
        assert st["pack_bytes_per_device"] * 4 == st["pack_bytes_total"]
        assert set(st["per_shard_registry"]) == {"0", "1", "2", "3"}
        assert r["tp_wqkv_local"] == r["loaded_wqkv_local"]


# --------------------------------------------------------------------------
# the engine over every partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("part", [p for p, _ in PARTITIONS])
def test_engine_matches_jax_engine(world, part):
    J, ranks, _ = world
    assert all(s == "done" for s, _ in J["engine"])
    assert len({tuple(t) for _, t in J["engine"]}) > 1     # not degenerate
    for r in ranks:
        assert r["engine_" + part] == J["engine"]


@pytest.mark.parametrize("part", [p for p, _ in PARTITIONS])
def test_cache_shards_follow_spec_for_cache(world, part):
    """Each engine cache leaf's local shape is ``spec_for_cache``'s shard
    of the whole one (slots over "data", KV heads over "model"); the ranks
    checked it never changed through the engine run."""
    _, ranks, inputs = world
    whole = inputs["whole_cache"]
    for r in ranks:
        local = r["cache_" + part]
        assert local == r["spec_cache_" + part]
        k = [n for n in local if n.endswith("mix/k")][0]
        d, m = dict(PARTITIONS)[part]
        assert local[k][1] == whole[k][1] // d      # slots (period-stacked)
        assert local[k][3] == whole[k][3] // m      # KV heads


def test_collectives_per_partition(world):
    """tp gathers and reduces over "model"; dp only gathers the window's
    tokens over "data"; tp+dp does both."""
    _, ranks, _ = world
    for r in ranks:
        tp, dp, both = (r["mesh_stats_" + p] for p, _ in PARTITIONS)
        assert {k.split(":")[1] for k in tp} == {"model"}
        assert {k.split(":")[1] for k in dp} == {"data"}
        assert {k.split(":")[1] for k in both} == {"data", "model"}
        assert tp["all_reduce:model"]["calls"] > 0


def test_slot_recycling_is_hygienic(world):
    _, ranks, _ = world
    for r in ranks:
        assert r["recycled"] == r["fresh"]
        assert all(s == "done" for s, _ in r["recycled"])


def test_paged_kv_under_tp(world):
    """Paged pools shard their KV-head dim; the page ids stay one shared
    space. Tokens equal the JAX engine's (paged is bitwise dense there)."""
    J, ranks, _ = world
    for r in ranks:
        assert r["paged_layout"] == "paged"
        assert r["paged"] == J["engine"]


def test_int8_sharded_quant_plan(world):
    J, ranks, _ = world
    for r in ranks:
        assert set(r["int8_kinds"].values()) == {("QuantPlan", "ShardedPlan")}
        _close(r["int8_forward"], J["int8_forward"], 1e-5)
        assert r["int8_engine"] == J["int8_engine"]


def test_chunked_prefill_on_a_data_sharded_engine(world):
    """dp (4, 1) with chunked prefill: the rank holding a slot prefills
    its chunks, every rank samples from the same row -- the JAX chunked
    engine's tokens."""
    J, ranks, _ = world
    for r in ranks:
        assert r["dp_chunked"] == J["chunked"]


def test_place_servable_and_agreed_auto(world):
    """A whole export placed on each rank serves as the rank-prepared one
    (bitwise); 'auto' under tp takes rank 0's verdicts on every rank and
    computes the single-device function (1e-5)."""
    J, ranks, _ = world
    for r in ranks:
        assert np.array_equal(r["placed_forward"], r["tp_forward"])
        assert r["auto_backends"] == ranks[0]["auto_backends"]
        assert set(r["auto_backends"].values()) <= {"dense", "plan"}
        _close(r["auto_forward"], J["tp_forward"], 1e-5)


@pytest.mark.parametrize("how", ["saved_unplaced", "saved_from_mesh"])
def test_save_load_per_rank(world, how):
    """An artifact of the sharded export (one process, ``place=False``) and
    a mesh servable's collective save both load on every rank to the
    prepared mesh servable's logits (1e-6) with their shard metadata."""
    _, ranks, _ = world
    key = "loaded_forward" if how == "saved_unplaced" else \
        "mesh_saved_forward"
    for r in ranks:
        _close(r[key], r["own_forward"], 1e-6)
        assert set(r["loaded_kinds"].values()) == {"ShardedPlan"}
        assert r["mesh_saved_meta"] == r["prepared_meta"]


# --------------------------------------------------------------------------
# BERT and the dense families
# --------------------------------------------------------------------------

def test_bert_forward_over_tp(world):
    """Smoke BERT at tile 32 over a 4-wide model axis: the fused QKV (6
    block rows) and attention wo (2 block columns) replicate, the FFN packs
    shard -- a replicated leaf is not reduced twice."""
    J, ranks, _ = world
    for r in ranks:
        st = r["bert_stats"]
        assert st["sharded_packs"] > 0 and st["replicated_packs"] > 0
        _close(r["bert_forward"], J["bert_forward"], 1e-5)


def test_dense_backend_over_tp(world):
    """``backend='dense'``: every projection a dense leaf sharded by
    ``spec_for_param`` -- wq / wk / wv by rows ('out'), wo by columns
    ('in'); the period-stacked FFN matches the rule's expert branch (its
    period axis over "model"), which the port keeps replicated."""
    J, ranks, _ = world
    for r in ranks:
        sh = r["dense_shards"]
        assert sh["blocks/0/attn/wq"] == "out" and \
            sh["blocks/0/attn/wo"] == "in" and sh["embed"] == "out"
        assert not any("/ffn/" in k for k in sh)
        _close(r["dense_forward"], J["dense_forward"], 1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_engine_over_tp(world, arch):
    """Attention-only packs over tp; the period-stacked dense FFN stays
    replicated (a rank computes its whole output and reduces nothing),
    the embedding and tied head shard by vocabulary rows. chatglm3's 2 KV
    heads do not divide 4 ranks: its cache replicates."""
    J, ranks, inputs = world
    for r in ranks:
        assert r["family_" + arch] == J["family_" + arch]
        shards = r["family_dense_shards_" + arch]
        assert "embed" in shards and not any("/ffn/" in k for k in shards)
        k = [n for n in r["family_cache_" + arch] if n.endswith("mix/k")][0]
        heads = r["family_cache_" + arch][k][3]
        assert heads == (2 if arch == "chatglm3_6b" else 1)
