"""The ssm, hybrid and audio families on a mesh across ranks on the CPU: the
port's mesh servables against the JAX single-device servable on the same
weights.

The reference's family matrix (``tests/test_sharded_serving.py``:
``test_family_engine_parity_tp8`` for mamba2_780m and recurrentgemma_9b,
``test_family_engine_parity_audio_tp8`` for whisper_base, served with
``prune="none"``) held by explicit SPMD on the same smoke configs, spec,
seed and prompt rule, with the smoke projections scaled by 20 (at the init
scale a smoke model repeats one token and greedy parity would be vacuous),
the SSD's per-head and the RG-LRU's per-channel vectors drawn so that they
differ across a rank's blocks and the recurrences keep their state
(``_per_channel``), and more requests than slots, so slots recycle. The
module starts world 4 and world 2 ONCE each (gloo, ``file://`` init under
the test's temporary directory, one torch thread a rank; they import no
JAX) and runs every case there; the parent computes the JAX side
meanwhile, then the parametrised tests assert on the results, so each
case still counts:

  * tp (1, 4) and (1, 2), dp (4, 1) and tp+dp (2, 2): engine tokens equal
    to the JAX engine's; ``decode_step`` logits (4 slots, 6 steps) and
    ``forward`` within 1e-5 (whisper: 1e-4, its fp32 floor here; ``TOL``)
    of the port's one-device servable on the same export (the partition's
    arithmetic) and of the JAX servable's, ``decode_many`` tokens equal;
  * every cache leaf at its ``spec_for_cache`` shard through the slot
    lifecycle (the engine's cache and its batch-1 sub-cache): SSD
    ``state`` H/m, ``conv`` C/m, RG-LRU ``h`` W/m, ``cross_k`` /
    ``cross_v`` Hkv/m, slots over "data";
  * the shard objects by layer kind, and mamba2's four collectives a
    layer a decode step;
  * chunked prefill under tp and tp+dp for mamba2 and recurrentgemma
    (``SchedSpec(max_chunk=4, token_budget=16)``) against the JAX chunked
    engine;
  * ``save`` -> ``load_servable`` per rank, forward within 1e-6.

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
#: the reference's family-matrix specs: LM attention packs pruned one-shot;
#: audio unpruned (no packs route)
SPECS = {"lm": dict(tile=(16, 16), sparsity=0.5, prune="oneshot",
                    targets=ATTN),
         "audio": dict(tile=(16, 16), sparsity=0.5, prune="none")}
SCHED = dict(max_chunk=4, token_budget=16)
FAMILIES = ("mamba2_780m", "recurrentgemma_9b", "whisper_base")
RECURRENT = FAMILIES[:2]
#: (partition, mesh shape) of each world: world 4 runs the first three
PARTS = (("tp", (1, 4)), ("dp", (4, 1)), ("tp+dp", (2, 2)), ("tp", (1, 2)))
PART_IDS = ["tp-1x4", "dp-4x1", "tp+dp-2x2", "tp-1x2"]
#: fp32 logits bars, against the port's one-device servable and the JAX
#: servable alike. whisper's fp32 floor on these 20x-scaled weights (the
#: encoder over 64 frames) is ~1e-5: its one-device logits are already
#: 7.7e-6 (forward) and 1.14e-5 (decode) from JAX's, so it keeps
#: ``test_torch_recurrent_families``' one-device bar
TOL = {"mamba2_780m": 1e-5, "recurrentgemma_9b": 1e-5, "whisper_base": 1e-4}
SLOTS = 4
MAX_NEW = 6
CACHE_LEN = 64
#: audio prompts: the reference's two ([1], [1, 2]) and four more
AUDIO_PROMPTS = ([1], [1, 2], [1, 2, 3], [1, 2, 3, 4], [5], [6, 7])


def _traffic(name, vocab, n_ctx, d):
    """(prompts, frames or None): six requests into four slots. LM prompts
    follow the reference's rule (3 + 2 i tokens, seed 0); audio requests
    take its seeded frames."""
    rng = np.random.RandomState(0)
    if name == "whisper_base":
        frames = [rng.randn(n_ctx, d).astype(np.float32)
                  for _ in AUDIO_PROMPTS]
        return [list(p) for p in AUDIO_PROMPTS], frames
    return [rng.randint(0, vocab, (3 + 2 * i,)).tolist()
            for i in range(6)], [None] * 6


# The program each rank runs (``python -c``): the port alone, results
# pickled to <workdir>/rank<r>.pkl.
RANK_PROGRAM = textwrap.dedent('''
    import os, pickle, sys, traceback
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.mesh import destroy_distributed, init_distributed
    from repro_torch.launch.sharding import (leaf_name, shard_shape,
                                             spec_for_cache)
    from repro_torch.models import encdec, lm
    from repro_torch.serving import (SchedSpec, ServingSpec, load_servable,
                                     prepare_servable)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        IN = pickle.load(f)
    CPU = "cpu"
    SHARDS = ("HeadShard", "SSDHeadShard", "ChannelShard")

    def shapes(cache):
        return {leaf_name(p): tuple(x.shape) for p, x in
                flatten_with_path(cache)}

    def want_shapes(sv, batch):
        cfg = sv.cfg
        if cfg.family == "audio":
            whole = encdec.cache_like(cfg, cfg.n_layers, batch,
                                       IN["cache_len"], cfg.n_audio_ctx)
        else:
            whole = lm.init_cache(cfg, batch, IN["cache_len"], device="meta")
        return {n: shard_shape(sh, spec_for_cache(n, sh, sv.mesh), sv.mesh)
                for n, sh in shapes(whole).items()}

    def run_engine(sv, name, **kw):
        eng = sv.engine(max_slots=IN["slots"], cache_len=IN["cache_len"],
                        sync_every=4, **kw)
        before = shapes(eng.cache)
        prompts, frames = IN["traffic"][name]
        hs = [eng.submit(p, max_new_tokens=IN["max_new"],
                         **({} if f is None else {"frames": f}))
              for p, f in zip(prompts, frames)]
        eng.run()
        eng.verify_invariants()
        return {"tokens": [(h.status, list(h.tokens)) for h in hs],
                "cache": before,
                "cache_follows_spec": before == want_shapes(sv, IN["slots"]),
                "cache_kept_shapes": shapes(eng.cache) == before,
                "sub_follows_spec": shapes(eng._sub) == want_shapes(sv, 1)}

    def serve(name, shape, partition):
        return prepare_servable(
            params_from_numpy(IN["params"][name], CPU),
            get_config(name, smoke=True),
            ServingSpec(**IN["specs"][name], mesh_shape=shape,
                        partition=partition), device=CPU)

    def cache4(sv, name):
        frames = IN["frames4"] if name == "whisper_base" else None
        return sv.init_cache(4, 32, frames=frames)

    def case(R, name, part, shape):
        sv = serve(name, shape, part)
        key = (name, part, tuple(shape))
        R[key, "forward"] = sv.forward(IN["batches"][name]).numpy()
        cache, steps = cache4(sv, name), []
        toks = IN["toks4"]
        for t in range(6):
            if t == 1:
                sv.mesh.reset_stats()
            logits, cache = sv.decode_step(cache, toks[:, t:t + 1], t)
            if t == 1:
                R[key, "step_collectives"] = {
                    k: v["calls"] for k, v in sv.mesh.stats.items()}
            steps.append(logits.numpy())
        R[key, "decode"] = np.stack(steps)
        R[key, "local_cache"] = shapes(cache)
        t, v, _ = sv.decode_many(cache4(sv, name), toks[:, :1],
                                 np.zeros((4,), np.int32), 5)
        R[key, "decode_many"] = (t.numpy(), v.numpy())
        R[key, "engine"] = run_engine(sv, name)
        R[key, "shards"] = sorted(
            f"{k}:{type(v).__name__}" for k, v in sv._run_packs.items()
            if type(v).__name__ in SHARDS)
        if name != "whisper_base" and part != "dp":
            R[key, "chunked"] = run_engine(sv, name,
                                           sched=SchedSpec(**IN["sched"]))
        if part == "tp" and shape[1] == 4:
            own = R[key, "forward"]
            path = os.path.join(workdir, "saved_" + name)
            sv.save(path)
            lv = load_servable(path, device=CPU)
            R[name, "loaded"] = (own, lv.forward(
                IN["batches"][name]).numpy(), lv.param_specs == sv.param_specs)
            del lv
        del sv

    def main():
        init_distributed("gloo", "file://" + os.path.join(workdir, "init"),
                         rank, world, timeout_s=60)
        R = {}
        for name in IN["families"]:
            for part, shape in IN["parts"]:
                if shape[0] * shape[1] == world:
                    case(R, name, part, shape)
        destroy_distributed()
        return R

    try:
        out = {"ok": main()}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _per_channel(tree):
    """The recurrent mixers' per-head and per-channel vectors made to
    differ across a rank's blocks and to matter: the init's SSD ``A_log``
    / ``dt_bias`` (zeros) and ``D`` (ones) are the same for every head, and
    its RG-LRU ``lam`` (~4) makes a = exp(-8 softplus(lam) r) ~ 1e-7, so
    h forgets every step; drawn here (seed 3) so that a rank cutting
    another block's values, or a lost state, changes the logits (both
    packages take the same numpy tree)."""
    rng = np.random.RandomState(3)

    def one(path, x):
        key = str(getattr(path[-1], "key", ""))
        if key == "A_log":
            return (0.5 * rng.randn(*x.shape)).astype(x.dtype)
        if key in ("D", "dt_bias"):
            return (x + 0.5 * rng.randn(*x.shape)).astype(x.dtype)
        if key == "lam":
            return (x - 8.0).astype(x.dtype)      # a ~ 0.9 at r = 0.5
        return x
    import jax
    return jax.tree_util.tree_map_with_path(one, tree)


def _jax_engine(js, prompts, frames, **kw):
    eng = js.engine(max_slots=SLOTS, cache_len=CACHE_LEN, sync_every=4, **kw)
    hs = [eng.submit(p, max_new_tokens=MAX_NEW,
                     **({} if f is None else {"frames": f}))
          for p, f in zip(prompts, frames)]
    eng.run()
    return [(h.status, list(h.tokens)) for h in hs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX single-device results, {world size: ranks' results}, inputs,
    the port's single-device results)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as j_config
    from repro.models import init_model as j_init
    from repro.serving import ServingSpec as JSpec
    from repro.serving import prepare_servable as j_prepare
    from repro.serving.spec import SchedSpec as JSched
    from test_torch_recurrent_families import _scaled

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingSpec, prepare_servable

    workdir = tmp_path_factory.mktemp("tp_recurrent")
    jcfgs = {n: j_config(n, smoke=True) for n in FAMILIES}
    # jitted: one compile a config beats dispatching the init op by op
    nparams = {n: _per_channel(jax.tree.map(np.asarray, jax.jit(
        lambda key, c=c: _scaled(j_init(key, c)))(jax.random.PRNGKey(1))))
        for n, c in jcfgs.items()}
    jparams = {n: jax.tree.map(jnp.asarray, p) for n, p in nparams.items()}
    specs = {n: SPECS["audio" if n == "whisper_base" else "lm"]
             for n in FAMILIES}
    rng = np.random.RandomState(2)
    wcfg = jcfgs["whisper_base"]
    toks2 = rng.randint(0, 512, (2, 12))
    frames2 = rng.randn(2, wcfg.n_audio_ctx, wcfg.d_model).astype(np.float32)
    inputs = {
        "params": nparams, "specs": specs, "sched": SCHED, "slots": SLOTS,
        "max_new": MAX_NEW, "cache_len": CACHE_LEN, "families": FAMILIES,
        "parts": PARTS,
        "traffic": {n: _traffic(n, c.vocab_size, c.n_audio_ctx, c.d_model)
                    for n, c in jcfgs.items()},
        "batches": {n: ({"tokens": toks2, "frames": frames2}
                        if n == "whisper_base" else {"tokens": toks2})
                    for n in FAMILIES},
        "toks4": rng.randint(0, 512, (4, 6)).astype(np.int32),
        "frames4": rng.randn(4, wcfg.n_audio_ctx,
                             wcfg.d_model).astype(np.float32),
    }
    for w in (2, 4):
        (workdir / f"w{w}").mkdir()
        with open(workdir / f"w{w}" / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)

    t0 = time.perf_counter()
    procs4 = _launch(workdir / "w4", RANK_PROGRAM, 4)
    procs2 = _launch(workdir / "w2", RANK_PROGRAM, 2)
    try:
        J, P = {}, {}
        toks4 = inputs["toks4"]
        for name in FAMILIES:
            ts = prepare_servable(params_from_numpy(nparams[name]),
                                  get_config(name, smoke=True),
                                  ServingSpec(**specs[name]), device="cpu")
            P[name, "forward"] = ts.forward(inputs["batches"][name]).numpy()
            cache, steps = ts.init_cache(4, 32, frames=(
                inputs["frames4"] if name == "whisper_base" else None)), []
            for t in range(6):
                logits, cache = ts.decode_step(cache, toks4[:, t:t + 1], t)
                steps.append(logits.numpy())
            P[name, "decode"] = np.stack(steps)
            del ts, cache
            js = j_prepare(jparams[name], jcfgs[name], JSpec(**specs[name]))
            prompts, frames = inputs["traffic"][name]
            J[name, "engine"] = _jax_engine(js, prompts, frames)
            if name in RECURRENT:
                J[name, "chunked"] = _jax_engine(js, prompts, frames,
                                                 sched=JSched(**SCHED))
            b = inputs["batches"][name]
            J[name, "forward"] = np.asarray(js.forward(
                {k: jnp.asarray(v) for k, v in b.items()}))
            fr = (jnp.asarray(inputs["frames4"]) if name == "whisper_base"
                  else None)
            cache, steps = js.init_cache(4, 32, frames=fr), []
            for t in range(6):
                logits, cache = js.decode_step(
                    cache, jnp.asarray(toks4[:, t:t + 1]), jnp.int32(t))
                steps.append(np.asarray(logits))
            J[name, "decode"] = np.stack(steps)
            t, v, _ = js.decode_many(js.init_cache(4, 32, frames=fr),
                                     jnp.asarray(toks4[:, :1]),
                                     jnp.zeros((4,), jnp.int32), 5)
            J[name, "decode_many"] = (np.asarray(t), np.asarray(v))
    except BaseException:
        for p in procs4 + procs2:
            p.kill()
        raise
    ranks = {4: _collect(procs4, workdir / "w4", t0),
             2: _collect(procs2, workdir / "w2", t0)}
    return J, ranks, inputs, P


def _ranks(world, shape):
    return world[1][shape[0] * shape[1]]


def _close(a, b, tol, what=""):
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, f"{what} max|d| {err:.3e} > {tol}"


def _engine_ok(run, ref):
    """Every request done, tokens equal to the JAX engine's, the cache
    leaves and the batch-1 sub-cache ``spec_for_cache``'s shards kept
    through the run."""
    assert all(s == "done" for s, _ in ref)
    assert len({tuple(t) for _, t in ref}) > 1        # not degenerate
    assert run["tokens"] == ref
    assert run["cache_follows_spec"] and run["cache_kept_shapes"]
    assert run["sub_follows_spec"]


@pytest.mark.parametrize("part", PARTS, ids=PART_IDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_tokens_match_jax(world, name, part):
    """Six requests into four slots (slots recycle): every rank's engine
    emits the JAX single-device engine's tokens; the cache and the batch-1
    sub-cache are ``spec_for_cache``'s shards before and after."""
    J = world[0]
    for r in _ranks(world, part[1]):
        _engine_ok(r[(name,) + part, "engine"], J[name, "engine"])


@pytest.mark.parametrize("part", PARTS, ids=PART_IDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_and_forward_match_jax(world, name, part):
    """``decode_step`` logits of 4 slots over 6 steps and ``forward``
    within ``TOL`` (1e-5; whisper 1e-4) of the port's one-device servable
    and of the JAX servable's, ``decode_many`` tokens equal to JAX's; every
    rank holds the same whole logits."""
    J, P = world[0], world[3]
    ranks = _ranks(world, part[1])
    key = (name,) + part
    for r in ranks:
        for what in ("decode", "forward"):
            _close(r[key, what], P[name, what], TOL[name], f"{what} vs port")
            _close(r[key, what], J[name, what], TOL[name], f"{what} vs JAX")
        assert np.array_equal(r[key, "decode"], ranks[0][key, "decode"])
        for got, ref in zip(r[key, "decode_many"], J[name, "decode_many"]):
            assert np.array_equal(got, ref)


#: the local cache leaf dims of a 4-slot smoke cache, by (family, mesh):
#: (leaf, dim, whole size); slots are dim 1 of stacked leaves
_LOCAL_DIMS = {
    "mamba2_780m": (("blocks/0/mix/state", 2, 8), ("blocks/0/mix/conv", 3,
                                                  160)),
    "recurrentgemma_9b": (("blocks/0/mix/h", 2, 64),
                          ("blocks/0/mix/conv", 3, 64),
                          ("blocks/2/mix/k", 3, 1)),
    "whisper_base": (("cross_k", 3, 4), ("cross_v", 3, 4), ("self/k", 3, 4)),
}


@pytest.mark.parametrize("part", PARTS, ids=PART_IDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_cache_leaves_hold_their_shard(world, name, part):
    """A 4-slot cache holds 4/data slots a rank and over "model" the SSD
    heads (8 / m), the conv channels (mamba2's C = 160, recurrentgemma's
    W = 64), the RG-LRU width, the audio K/V heads (4 / m); recurrentgemma's
    one MQA KV head stays whole."""
    d, m = part[1]
    for r in _ranks(world, part[1]):
        local = r[(name,) + part, "local_cache"]
        for leaf, dim, whole in _LOCAL_DIMS[name]:
            want = whole // m if whole % m == 0 and whole >= m else whole
            assert local[leaf][dim] == want, (leaf, local[leaf])
            assert local[leaf][1] == 4 // d, (leaf, local[leaf])


@pytest.mark.parametrize("part", PARTS, ids=PART_IDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_shard_objects_and_collectives(world, name, part):
    """The shard object by each layer's kind where "model" > 1: mamba2's
    SSD heads and conv channels, recurrentgemma's RG-LRU width (its MQA
    local attention keeps every head), whisper's encoder, decoder and
    cross-attention heads; none under dp. A mamba2 decode step takes four
    collectives a layer (``in_proj``'s gather, the conv output's gather,
    the normed ``y``'s gather, ``out_proj``'s reduce) plus the embedding's
    and the head's."""
    d, m = part[1]
    key = (name,) + part
    r = _ranks(world, part[1])[0]
    want = set() if m == 1 else {
        "mamba2_780m": {"blocks/0/mixer/heads:SSDHeadShard",
                        "blocks/0/mixer/conv:ChannelShard"},
        "recurrentgemma_9b": {"blocks/0/mixer/width:ChannelShard",
                              "blocks/1/mixer/width:ChannelShard"},
        "whisper_base": {"enc_layers/attn/heads:HeadShard",
                         "dec_layers/attn/heads:HeadShard",
                         "dec_layers/xattn/heads:HeadShard"}}[name]
    assert set(r[key, "shards"]) == want
    calls = r[key, "step_collectives"]
    if m == 1:
        assert not any(k.endswith(":model") for k in calls)
    if name == "mamba2_780m" and m > 1:
        n_layers = 2
        assert calls.get("all_gather:model", 0) \
            + calls.get("all_reduce:model", 0) == 4 * n_layers + 2


@pytest.mark.parametrize("part", [p for p in PARTS if p[0] != "dp"],
                         ids=[i for p, i in zip(PARTS, PART_IDS)
                              if p[0] != "dp"])
@pytest.mark.parametrize("name", RECURRENT)
def test_chunked_prefill_on_a_mesh(world, name, part):
    """Chunked prefill (chunks of 4) under tp and tp+dp: each chunk
    continues the slot's rank-local state and conv block; tokens equal the
    JAX chunked engine's."""
    J = world[0]
    for r in _ranks(world, part[1]):
        _engine_ok(r[(name,) + part, "chunked"], J[name, "chunked"])


@pytest.mark.parametrize("name", FAMILIES)
def test_save_load_per_rank(world, name):
    """A tp (1, 4) mesh servable's collective save loads on every rank with
    the same leaf specs and its forward within 1e-6."""
    for r in _ranks(world, (1, 4)):
        own, got, same_specs = r[name, "loaded"]
        _close(got, own, 1e-6)
        assert same_specs
