"""The vlm, MoE and MLA families on a mesh across ranks on the CPU: the
port's mesh servables against the JAX single-device servable on the same
weights.

The reference's family matrix (``tests/test_sharded_serving.py``:
``test_family_engine_parity_moe_tp8`` and ``_mla_tp8``) held by explicit
SPMD, on the pixtral_12b, qwen3_moe_235b_a22b and deepseek_v2_lite_16b
smoke configs, the reference's MLA smoke config and a dense config whose
period-stacked norm scales hold 4096 elements. The module starts world 4
and world 2 ONCE each (gloo, ``file://`` init under the test's temporary
directory, one torch thread a rank; they import no JAX) and runs every case
there; the parent computes the JAX side meanwhile, then the parametrised
tests assert on the results, so each case still counts:

  * tp (1, 4) and (1, 2): ``forward`` (pixtral with ``mm_embeds``) within
    1e-5, ``decode_many`` and engine tokens equal;
  * deepseek_v2_lite over dp (4, 1) and tp+dp (2, 2) at capacity factors
    8.0 and 1.0: at 1.0 four decode slots give each expert one row, drops
    happen, and only routing the whole batch (the rows gathered over
    "data") gives one device's tokens;
  * paged KV under tp (qwen3_moe's K/V pools, deepseek's latent pools),
    chunked prefill under tp (the MLA config in chunks; deepseek's MoE
    gate, one-shot as the reference);
  * every cache leaf at its ``spec_for_cache`` shard through the slot
    lifecycle; routed experts E/m a rank; latent caches r/m a rank;
  * ``save`` -> ``load_servable`` per rank, forward within 1e-6;
  * the stacked norm scales of the 8-layer d_model-512 dense config stay
    whole on every rank (the mesh once cut them over "model") and its
    tokens equal the JAX servable's.

A rank that fails or hangs fails the module: the collectives carry a 60 s
timeout and the parent kills the ranks after ``test_torch_tp_serving``'s
``DEADLINE_S`` (its harness starts and collects the ranks).
"""
import os
import pickle
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_tp_serving import _collect, _launch  # noqa: E402

ATTN = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
SPEC = dict(tile=(16, 16), sparsity=0.5, prune="oneshot", targets=ATTN)
#: chunked prefill (prompts of 4-10 tokens, chunks of 4)
SCHED = dict(max_chunk=4, token_budget=16)
FAMILIES = ("pixtral_12b", "qwen3_moe_235b_a22b", "deepseek_v2_lite_16b",
            "mla")
#: the reference's MLA smoke config (``test_family_engine_parity_mla_tp8``)
MLA_CFG = dict(arch="mla-tp-smoke", family="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
               vocab_size=512, kv_lora_rank=32, qk_nope_dim=16,
               qk_rope_dim=8, v_head_dim=16, dtype="float32")
#: period-stacked norm scales of (8, 512) = 4096 elements: the generic
#: 2-D sharding rule gives their period axis "model"
NORM_CFG = dict(arch="norm-regress", family="dense", n_layers=8,
                d_model=512, n_heads=8, n_kv_heads=8, head_dim=64, d_ff=1024,
                vocab_size=512, dtype="float32")
#: deepseek_v2_lite's data-sharded partitions and capacity factors
DP_CASES = (("dp", (4, 1), 8.0), ("dp", (4, 1), 1.0),
            ("tp+dp", (2, 2), 8.0), ("tp+dp", (2, 2), 1.0))
DP_IDS = [f"{p}-cf{cf}" for p, _, cf in DP_CASES]
SLOTS = 4
MAX_NEW = 6


def _prompts(vocab, n, base=4, step=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (base + step * i,)).tolist()
            for i in range(n)]


# The program each rank runs (``python -c``): the port alone, results
# pickled to <workdir>/rank<r>.pkl.
RANK_PROGRAM = textwrap.dedent('''
    import dataclasses, os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerKind, ModelConfig
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.mesh import destroy_distributed, init_distributed
    from repro_torch.launch.sharding import (leaf_name, shard_shape,
                                             spec_for_cache)
    from repro_torch.models import lm
    from repro_torch.serving import (SchedSpec, ServingSpec, load_servable,
                                     place_servable, prepare_servable)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    CPU = "cpu"

    def cfg_of(name, cf=None):
        if name == "mla":
            cfg = ModelConfig(pattern=(LayerKind("mla", "dense"),),
                              **IN["mla_cfg"])
        elif name == "norm":
            cfg = ModelConfig(pattern=(LayerKind("attn", "dense"),),
                              **IN["norm_cfg"])
        else:
            cfg = get_config(name, smoke=True)
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        return cfg

    def shapes(cache):
        return {leaf_name(p): tuple(x.shape) for p, x in
                flatten_with_path(cache)}

    def run_engine(sv, **kw):
        eng = sv.engine(max_slots=IN["slots"], cache_len=64, sync_every=4,
                        **kw)
        before = shapes(eng.cache)
        whole = lm.init_cache(sv.cfg, IN["slots"], 64, paged=eng._layout,
                              device="meta")
        want = {n: shard_shape(sh, spec_for_cache(n, sh, sv.mesh), sv.mesh)
                for n, sh in shapes(whole).items()}
        hs = [eng.submit(p, max_new_tokens=IN["max_new"])
              for p in IN["prompts"]]
        eng.run()
        eng.verify_invariants()
        return {"tokens": [(h.status, list(h.tokens)) for h in hs],
                "layout": eng.kv_layout, "cache": before,
                "cache_follows_spec": before == want,
                "cache_kept_shapes": shapes(eng.cache) == before}

    def serve(name, shape, partition, cf=None):
        return prepare_servable(
            params_from_numpy(IN["params"][name], CPU), cfg_of(name, cf),
            ServingSpec(**IN["spec"], mesh_shape=shape,
                        partition=partition), device=CPU)

    def batch_of(name):
        b = {"tokens": np.asarray(IN["toks"])}
        if name == "pixtral_12b":
            b["mm_embeds"] = np.asarray(IN["mm_embeds"])
        return b

    def tp_cases(R, shape):
        m = shape[1]
        for name in IN["families"]:
            cf = 8.0 if name == "deepseek_v2_lite_16b" else None
            sv = serve(name, shape, "tp", cf)
            R[name, "forward"] = sv.forward(batch_of(name)).numpy()
            t, v, _ = sv.decode_many(sv.init_cache(2, 32),
                                     np.asarray(IN["toks"])[:, :1],
                                     np.zeros((2,), np.int32), 5)
            R[name, "decode_many"] = (t.numpy(), v.numpy())
            sv.mesh.reset_stats()
            R[name, "engine"] = run_engine(sv)
            R[name, "collectives"] = {k: v["calls"]
                                      for k, v in sv.mesh.stats.items()}
            R[name, "shards"] = sorted(
                f"{k}:{type(v).__name__}" for k, v in sv._run_packs.items()
                if type(v).__name__ in ("HeadShard", "LatentShard",
                                        "ExpertShard"))
            if m == 4 and name != "pixtral_12b":
                R[name, "paged"] = run_engine(sv, kv_layout="paged")
            if m == 4 and name in ("mla", "deepseek_v2_lite_16b"):
                R[name, "chunked"] = run_engine(
                    sv, sched=SchedSpec(**IN["sched"]))
            if name in ("qwen3_moe_235b_a22b", "deepseek_v2_lite_16b"):
                blk = sv.params["blocks"][0]["ffn"]
                R[name, "experts_local"] = {
                    k: tuple(blk[k].shape) for k in ("wi", "wg", "wo")}
            if name == "deepseek_v2_lite_16b":
                R[name, "prefix_ffn_local"] = tuple(
                    sv.params["prefix"][0]["ffn"]["wi"]["w"].shape)
            del sv

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        if world == 2:
            tp_cases(R, (1, 2))
            destroy_distributed()
            return R
        tp_cases(R, (1, 4))
        ds = "deepseek_v2_lite_16b"
        R["cf1_tp"] = run_engine(serve(ds, (1, 4), "tp", 1.0))
        for part, shape, cf in IN["dp_cases"]:
            sv = serve(ds, tuple(shape), part, cf)
            sv.mesh.reset_stats()
            R["dp", part, cf] = run_engine(sv)
            R["dp_collectives", part, cf] = {
                k: v["calls"] for k, v in sv.mesh.stats.items()}
            R["dp_cache", part, cf] = tuple(
                sv.init_cache(4, 64)["blocks"][0]["mix"]["c_kv"].shape)
            del sv
        # save -> load per rank: the sharded export saved by one process,
        # and this mesh servable's collective save
        sv = serve(ds, (1, 4), "tp", 8.0)
        own = sv.forward(np.asarray(IN["toks"])).numpy()
        lv = load_servable(os.path.join(workdir, "saved"), device=CPU)
        R["loaded"] = (own, lv.forward(np.asarray(IN["toks"])).numpy(),
                       tuple(lv.params["blocks"][0]["ffn"]["wi"].shape))
        sv.save(os.path.join(workdir, "mesh_saved"))
        lv2 = load_servable(os.path.join(workdir, "mesh_saved"), device=CPU)
        R["mesh_saved"] = (own, lv2.forward(np.asarray(IN["toks"])).numpy(),
                           tuple(lv2.params["blocks"][0]["ffn"]["wi"].shape))
        # a whole export placed on the rank: views of its leaves
        sw = prepare_servable(
            params_from_numpy(IN["params"][ds], CPU), cfg_of(ds, 8.0),
            ServingSpec(**IN["spec"], mesh_shape=(1, 4)), device=CPU,
            place=False)
        pv = place_servable(sw)
        whole = sw.params["blocks"][0]["ffn"]["wi"]
        view = pv.params["blocks"][0]["ffn"]["wi"]
        R["views"] = (own, pv.forward(np.asarray(IN["toks"])).numpy(),
                      tuple(view.shape),
                      view.untyped_storage().data_ptr()
                      == whole.untyped_storage().data_ptr())
        del sv, lv, lv2, sw, pv
        # the stacked norm scales of a (8, 512) dense stack stay whole
        sn = serve("norm", (1, 4), "tp")
        R["norm_engine"] = run_engine(sn)
        R["norm_scales"] = {
            k: (tuple(sn.params["blocks"][0][k]["scale"].shape),
                sn.param_specs["blocks"][0][k]["scale"])
            for k in ("norm1", "norm2")}
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _jax_engine(sv, prompts, **kw):
    eng = sv.engine(max_slots=SLOTS, cache_len=64, sync_every=4, **kw)
    hs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run()
    return [(h.status, list(h.tokens)) for h in hs]


def _j_configs():
    import dataclasses
    from repro.configs.base import LayerKind as JKind
    from repro.configs.base import ModelConfig as JConfig
    from repro.configs.registry import get_config as j_config
    cfgs = {a: j_config(a, smoke=True) for a in FAMILIES if a != "mla"}
    cfgs["mla"] = JConfig(pattern=(JKind("mla", "dense"),), **MLA_CFG)
    cfgs["norm"] = JConfig(pattern=(JKind("attn", "dense"),), **NORM_CFG)
    ds = cfgs["deepseek_v2_lite_16b"]
    cfgs["deepseek_v2_lite_16b"] = dataclasses.replace(ds,
                                                       capacity_factor=8.0)
    cfgs["deepseek_cf1"] = dataclasses.replace(ds, capacity_factor=1.0)
    return cfgs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX single-device results, world-4 ranks' results, world-2
    ranks' results, inputs)."""
    import jax
    from repro.models import init_model as j_init
    from repro.serving import ServingSpec as JSpec
    from repro.serving import prepare_servable as j_prepare
    from repro.serving.spec import SchedSpec as JSched

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingSpec, prepare_servable
    from test_torch_engine import _scaled

    workdir = tmp_path_factory.mktemp("tp_families")
    jcfgs = _j_configs()
    # jitted: one compile a config beats dispatching the init op by op
    jparams = {k: jax.jit(lambda key, c=c: _scaled(j_init(key, c)))(
        jax.random.PRNGKey(1)) for k, c in jcfgs.items()
        if k != "deepseek_cf1"}
    nparams = {k: jax.tree.map(np.asarray, v) for k, v in jparams.items()}
    rng = np.random.RandomState(0)
    n_p = jcfgs["pixtral_12b"].n_patches
    inputs = {
        "params": nparams, "spec": SPEC, "sched": SCHED, "slots": SLOTS,
        "max_new": MAX_NEW, "families": FAMILIES, "dp_cases": DP_CASES,
        "mla_cfg": MLA_CFG, "norm_cfg": NORM_CFG,
        "toks": rng.randint(0, 512, (2, 12)),
        "mm_embeds": rng.randn(2, n_p, 64).astype(np.float32),
        "prompts": _prompts(512, SLOTS),
    }
    for w in (2, 4):
        (workdir / f"w{w}").mkdir()
        with open(workdir / f"w{w}" / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
    # the sharded export of deepseek_v2_lite, prepared once on one process
    # and saved for the ranks to load
    import dataclasses
    saved = prepare_servable(
        params_from_numpy(nparams["deepseek_v2_lite_16b"]),
        dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                            capacity_factor=8.0),
        ServingSpec(**SPEC, mesh_shape=(1, 4)), device="cpu", place=False)
    saved.save(str(workdir / "w4" / "saved"))
    del saved

    t0 = time.perf_counter()
    procs4 = _launch(workdir / "w4", RANK_PROGRAM, 4)
    procs2 = _launch(workdir / "w2", RANK_PROGRAM, 2)
    try:
        J = {}
        prompts, toks = inputs["prompts"], inputs["toks"]
        for name in FAMILIES + ("norm", "deepseek_cf1"):
            key = "deepseek_v2_lite_16b" if name == "deepseek_cf1" else name
            js = j_prepare(jparams[key], jcfgs[name], JSpec(**SPEC))
            J[name, "engine"] = _jax_engine(js, prompts)
            if name in ("norm", "deepseek_cf1"):
                continue
            batch = {"tokens": toks}
            if name == "pixtral_12b":
                batch["mm_embeds"] = inputs["mm_embeds"]
            J[name, "forward"] = np.asarray(js.forward(batch))
            t, v, _ = js.decode_many(js.init_cache(2, 32), toks[:, :1],
                                     np.zeros((2,), np.int32), 5)
            J[name, "decode_many"] = (np.asarray(t), np.asarray(v))
            if name in ("mla", "deepseek_v2_lite_16b"):
                J[name, "chunked"] = _jax_engine(js, prompts,
                                                 sched=JSched(**SCHED))
    except BaseException:
        for p in procs4 + procs2:
            p.kill()
        raise
    ranks4 = _collect(procs4, workdir / "w4", t0)
    ranks2 = _collect(procs2, workdir / "w2", t0)
    return J, ranks4, ranks2, inputs


def _close(a, b, tol):
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, f"max|d| {err:.3e} > {tol}"


def _ranks(world, m):
    _, r4, r2, _ = world
    return r4 if m == 4 else r2


def _engine_ok(run, ref):
    """Every request done, tokens equal to the JAX engine's, the cache
    leaves ``spec_for_cache``'s shards kept through the run."""
    assert all(s == "done" for s, _ in ref)
    assert len({tuple(t) for _, t in ref}) > 1        # not degenerate
    assert run["tokens"] == ref
    assert run["cache_follows_spec"] and run["cache_kept_shapes"]


# --------------------------------------------------------------------------
# tp (1, 4) and (1, 2): every family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax_single_device(world, name, m):
    """``Servable.forward`` (pixtral with its patch embeddings handed to
    every rank) within 1e-5 of the JAX single-device servable; every rank
    holds the same whole logits."""
    J = world[0]
    ranks = _ranks(world, m)
    for r in ranks:
        _close(r[name, "forward"], J[name, "forward"], 1e-5)
        assert np.array_equal(r[name, "forward"], ranks[0][name, "forward"])


@pytest.mark.parametrize("m", [4, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_and_decode_many_match_jax(world, name, m):
    J = world[0]
    for r in _ranks(world, m):
        _engine_ok(r[name, "engine"], J[name, "engine"])
        assert r[name, "engine"]["layout"] == "dense"
        for got, ref in zip(r[name, "decode_many"], J[name, "decode_many"]):
            assert np.array_equal(got, ref)


@pytest.mark.parametrize("m", [4, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_shard_objects_by_layer_kind(world, name, m):
    """A shard object by each layer's kind: KV heads where they divide the
    "model" axis (qwen3_moe's and pixtral's 2 KV heads replicate at 4 and
    shard at 2), the latent rank of an MLA layer (never heads: an MLA layer
    keeps its params under ``attn`` too), the experts of a MoE FFN; and
    collectives only over "model"."""
    r = _ranks(world, m)[0]
    kinds = {s.split(":")[1] for s in r[name, "shards"]}
    want = {"pixtral_12b": {"HeadShard"} if m == 2 else set(),
            "qwen3_moe_235b_a22b": ({"HeadShard"} if m == 2 else set())
            | {"ExpertShard"},
            "deepseek_v2_lite_16b": {"LatentShard", "ExpertShard"},
            "mla": {"LatentShard"}}[name]
    assert kinds == want
    if name == "deepseek_v2_lite_16b":
        assert sorted(r[name, "shards"]) == [
            "blocks/0/attn/latent:LatentShard",
            "blocks/0/ffn/experts:ExpertShard",
            "prefix/0/attn/latent:LatentShard"]
    assert {k.split(":")[1] for k in r[name, "collectives"]} == {"model"}


@pytest.mark.parametrize("m", [4, 2])
@pytest.mark.parametrize("name", ["qwen3_moe_235b_a22b",
                                  "deepseek_v2_lite_16b"])
def test_expert_leaves_hold_their_share(world, name, m):
    """Routed-expert tensors (period-stacked (P, E, a, b)) hold E/m experts
    a rank; deepseek's dense prefix FFN is a column-parallel DenseShard."""
    for r in _ranks(world, m):
        for k, shape in r[name, "experts_local"].items():
            assert shape[1] == 8 // m, (k, shape)
        if name == "deepseek_v2_lite_16b":
            assert r[name, "prefix_ffn_local"] == (128 // m, 64)


@pytest.mark.parametrize("name", ["qwen3_moe_235b_a22b",
                                  "deepseek_v2_lite_16b", "mla"])
def test_paged_kv_under_tp(world, name):
    """Paged pools under tp (1, 4): qwen3_moe's K/V pools (2 KV heads:
    replicated), deepseek's and the MLA config's latent pools (r over
    "model"). Tokens equal the JAX engine's (paged is bitwise dense
    there)."""
    J = world[0]
    for r in _ranks(world, 4):
        run = r[name, "paged"]
        assert run["layout"] == "paged"
        _engine_ok(run, J[name, "engine"])
        if name != "qwen3_moe_235b_a22b":
            pool = [s for n, s in run["cache"].items()
                    if n.endswith("c_kv_pages")]
            assert pool and all(s[-1] == 32 // 4 for s in pool)


@pytest.mark.parametrize("name", ["mla", "deepseek_v2_lite_16b"])
def test_chunked_prefill_under_tp(world, name):
    """Chunked prefill under tp (1, 4): the MLA config prefills in chunks
    of 4 (each rank writes its latent block, the slot's view gathered);
    deepseek's MoE FFN keeps the reference's gate (one-shot). Tokens equal
    the JAX chunked engine's."""
    J = world[0]
    for r in _ranks(world, 4):
        _engine_ok(r[name, "chunked"], J[name, "chunked"])


def test_latent_cache_holds_its_block(world):
    """The MLA latent cache (``c_kv``) holds r/m a rank, its rope key
    (``k_rope``) whole."""
    for m in (4, 2):
        for r in _ranks(world, m):
            cache = r["deepseek_v2_lite_16b", "engine"]["cache"]
            assert cache["blocks/0/mix/c_kv"][-1] == 32 // m
            assert cache["blocks/0/mix/k_rope"][-1] == 8


# --------------------------------------------------------------------------
# deepseek_v2_lite over dp and tp+dp: capacity is the batch's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", DP_CASES, ids=DP_IDS)
def test_data_sharded_moe_engine_matches_jax(world, case):
    """dp (4, 1) and tp+dp (2, 2) at capacity factor 8.0 and 1.0: a rank
    decodes its own slots, its MoE layers gather the step's rows over
    "data" and route the whole batch (at 1.0 the four slots give each
    expert one row, so per-rank routing would drop fewer assignments and
    give other tokens)."""
    J = world[0]
    part, shape, cf = case
    ref = J["deepseek_v2_lite_16b" if cf == 8.0 else "deepseek_cf1",
            "engine"]
    for r in _ranks(world, 4):
        _engine_ok(r["dp", part, cf], ref)
        axes = {k.split(":")[1] for k in r["dp_collectives", part, cf]}
        assert axes == ({"data"} if part == "dp" else {"data", "model"})
        assert r["dp_cache", part, cf][1] == 4 // shape[0]     # slots
        assert r["dp_cache", part, cf][-1] == 32 // shape[1]   # latent


def test_capacity_one_drops_change_the_tokens(world):
    """The capacity-1.0 case is not vacuous: its tokens differ from the
    high-capacity engine's (drops happen), and tp (1, 4) at 1.0 gives
    one device's."""
    J, r4, _, _ = world
    assert J["deepseek_cf1", "engine"] != J["deepseek_v2_lite_16b",
                                            "engine"]
    for r in r4:
        _engine_ok(r["cf1_tp"], J["deepseek_cf1", "engine"])


# --------------------------------------------------------------------------
# save -> load, and the stacked norm scales
# --------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["saved_unplaced", "saved_from_mesh"])
def test_save_load_per_rank(world, how):
    """deepseek_v2_lite's sharded export saved by one process
    (``place=False``), and a mesh servable's collective save, load on
    every rank with the routed experts at E/4 and the prepared mesh
    servable's logits (1e-6)."""
    for r in _ranks(world, 4):
        own, got, experts = r["loaded" if how == "saved_unplaced"
                              else "mesh_saved"]
        _close(got, own, 1e-6)
        assert experts[1] == 2


def test_place_servable_views_share_the_whole_export(world):
    """``place_servable``: a rank's routed experts are a view of the whole
    export's (E/4 of them, the same storage) and it serves the prepared
    mesh servable's logits bitwise."""
    for r in _ranks(world, 4):
        own, got, shape, shared = r["views"]
        assert np.array_equal(got, own)
        assert shape[1] == 2 and shared


def test_stacked_norm_scales_stay_whole(world):
    """The 8-layer d_model-512 dense stack over (1, 4): the (8, 512) norm
    scales (4096 elements, which the generic rule gives "model" on their
    period axis) replicate, and the tokens equal the JAX servable's."""
    J = world[0]
    for r in _ranks(world, 4):
        for shape, spec in r["norm_scales"].values():
            assert shape == (8, 512) and spec == (None, None)
        _engine_ok(r["norm_engine"], J["norm", "engine"])
