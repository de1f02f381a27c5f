"""Family-dispatching model API: the ``bert`` family, the LM families
``dense``, ``vlm``, ``moe``, ``ssm`` and ``hybrid`` (``models/lm.py``; MLA
layers in any of them) and the enc-dec ``audio`` family
(``models/encdec.py``).

Counterpart of ``repro/models/api.py``. Batch keys: ``tokens`` (B, S); for
``vlm`` also ``mm_embeds`` (B, P, d) patch embeddings; for ``audio`` also
``frames`` (B, T_audio, d) encoder frame embeddings. Decode caches are
preallocated and updated **in place** (where the reference returns updated
copies and its engine donates the old buffers): every function below that
takes a cache writes into it and returns the same tree.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import at_path, map_with_path
from repro_torch.device import resolve_device
from repro_torch.models import bert as bert_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import prng
from repro_torch.models.attention import as_slot_positions
from repro_torch.models.sampling import sample_tokens

_FAMILIES = ("bert", "dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _known(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _decoder(cfg: ModelConfig):
    _known(cfg)
    if cfg.family == "bert":
        raise ValueError("encoder-only arch has no decode step")


def _lm_only(cfg: ModelConfig, what: str):
    """The one-pass prefill and paged slot entry points: lm layouts only
    (audio prefills through its decode path and has no paged cache)."""
    _known(cfg)
    if cfg.family in ("audio", "bert"):
        raise ValueError(f"no {what} for family {cfg.family!r}")


def init_model(seed, cfg: ModelConfig, device=None):
    """Seeded random weights on ``device`` (the CUDA card by default).
    ``seed`` is an int or a ``torch.Generator`` on that device."""
    _known(cfg)
    dev = resolve_device(device)
    gen = seed
    if dev.type == "meta":                  # deferred draws: no generator
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    if cfg.family == "bert":
        return bert_mod.init_bert(gen, cfg, device=dev)
    if cfg.family == "audio":
        return encdec_mod.init_encdec(gen, cfg, device=dev)
    return lm_mod.init_lm(gen, cfg, device=dev)


def _deferred_tree(cfg: ModelConfig, device):
    """(the init tree with each draw deferred -- ``common.Draw`` /
    ``StackedDraw`` leaves beside the real zeros and ones --, the draws in
    order)."""
    from repro_torch.models.common import deferred_draws
    with deferred_draws() as draws:
        tree = init_model(0, cfg, device=device)
    return tree, draws


def param_shapes(cfg: ModelConfig):
    """The tree of ``init_model``'s leaves as meta tensors (shape and
    dtype, no storage, nothing drawn)."""
    from repro_torch.models.common import Draw, StackedDraw
    tree, _ = _deferred_tree(cfg, "meta")

    def one(_, leaf):
        if isinstance(leaf, Draw):
            return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
        if isinstance(leaf, StackedDraw):
            return torch.empty(leaf.shape, dtype=leaf.parts[0].dtype,
                               device="meta")
        return leaf
    return map_with_path(one, tree)


def init_model_local(seed: int, cfg: ModelConfig, cut, device=None):
    """This rank's part of ``init_model(seed, cfg, device)``, bitwise, with
    no whole leaf kept: the draws are replayed in ``init_model``'s order
    from the same generator, and each is cut as soon as it is drawn.
    ``cut(path, x, period)`` returns the part of ``x`` to keep -- the
    whole leaf at ``path`` (``period`` None) or period ``period`` of a
    layer-stacked leaf, or None to keep nothing of that period. At most
    one drawn leaf (one period) is whole at a time."""
    from repro_torch.models.common import Draw, StackedDraw
    dev = resolve_device(device)
    tree, draws = _deferred_tree(cfg, dev)
    # draw index -> (path, period, the constant the init adds to it: the
    # tree's Draw holds it, the recorded one predates the addition)
    owner = {}
    for path, leaf in _flat_draws(tree):
        if isinstance(leaf, Draw):
            owner[leaf.index] = (path, None, leaf.offset)
        elif isinstance(leaf, StackedDraw):
            for i, d in enumerate(leaf.parts):
                owner[d.index] = (path, i, d.offset)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    got = {}
    for d in draws:
        w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        w = (d.scale * w).to(d.dtype)
        path, per, offset = owner[d.index]
        if offset:
            w = w + offset
        part = cut(path, w, per)
        del w
        if part is not None:
            part = part.clone(memory_format=torch.contiguous_format)
        if per is None:
            got[path] = part
        else:
            got.setdefault(path, [])
            if part is not None:
                got[path].append(part)

    def one(path, leaf):
        if isinstance(leaf, Draw):
            return got[path]
        if isinstance(leaf, StackedDraw):
            return torch.stack(got[path])
        return cut(path, leaf, None).clone(
            memory_format=torch.contiguous_format)
    return map_with_path(one, tree)


def _flat_draws(tree, path=()):
    """(path, leaf) of a deferred init tree: like ``flatten_with_path``,
    with ``StackedDraw`` leaves kept whole."""
    from repro_torch.models.common import StackedDraw
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_draws(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, StackedDraw):
        return [x for i, v in enumerate(tree)
                for x in _flat_draws(v, path + (i,))]
    return [(path, tree)]


#: families whose sequence-parallel batch is later work, by their part of
#: ROADMAP Queue 1 item 8
_SP_LATER = {"vlm": "6b", "moe": "6b", "ssm": "6c", "hybrid": "6c",
             "audio": "6c"}


def check_sequence_parallel(cfg: ModelConfig):
    """Raises unless ``cfg`` trains and prefills a sequence-parallel batch
    (one row, S over the dp axes): the dense LM family and BERT, whose ops
    act token by token but for attention. The vlm family's patch rows, a
    MoE layer's capacity and aux over the global tokens and MLA (part 6b)
    and the ssm / hybrid scan and conv state and audio's frames (part 6c)
    would compute something else block by block."""
    part = _SP_LATER.get(cfg.family)
    if part is not None:
        mla = any(k.mixer == "mla" for k in cfg.prefix + cfg.pattern)
        what = cfg.family + (" (MLA)" if mla else "")
        raise ValueError(
            f"{cfg.arch}: a sequence-parallel batch (one row, S over the dp "
            f"axes) of the {what} family is not ported: ROADMAP Queue 1 "
            f"item 8 part {part}")


def model_forward(params, cfg: ModelConfig, batch, packs=None,
                  last_only: bool = False):
    """-> (logits fp32, aux). The audio family exports no packs (the
    reference's enc-dec forward has no packs route): its ``packs`` are a
    mesh servable's shard objects or nothing.

    ``packs['seq']`` (a ``common.SeqShard``): ``batch`` is this rank's
    block of a sequence-parallel row (dense and BERT families; the others
    raise, :func:`check_sequence_parallel`). ``last_only`` (not audio):
    the logits of the last position alone, (B, 1, V); on a
    sequence-parallel block only the rank holding the row's last position
    computes them, the others return None."""
    _known(cfg)
    if packs and packs.get("seq") is not None:
        check_sequence_parallel(cfg)
    if cfg.family == "bert":
        logits = bert_mod.forward(params, cfg, batch["tokens"], packs=packs,
                                  last_only=last_only)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
    if cfg.family == "audio":
        if last_only:
            raise ValueError("last_only: no such path for family 'audio'")
        return encdec_mod.forward(params, cfg, batch["frames"],
                                  batch["tokens"], packs=packs)
    if cfg.family == "vlm":
        return lm_mod.forward(params, cfg, batch["tokens"],
                              mm_embeds=batch.get("mm_embeds"), packs=packs,
                              last_only=last_only)
    return lm_mod.forward(params, cfg, batch["tokens"], packs=packs,
                          last_only=last_only)


def _device_of(params):
    return params["embed"]["w"].device


def init_cache(params, cfg: ModelConfig, batch_size, cache_len, frames=None,
               paged=None, mesh=None, packs=None):
    """A zeroed decode cache on the params' device. ``paged``
    (``models.common.PagedLayout`` or None): page-pool storage for the
    global attention and MLA layers (lm families only; ``serving/paging.py``
    hands out page ids). The audio family runs its encoder over ``frames``
    (B, T_audio, d) here and caches each decoder layer's cross K/V; its
    batch is the frames' batch. With ``mesh`` (a ``launch.mesh.
    ProcessMesh``) only this rank's shard of every leaf is allocated
    (:func:`cache_shardings`): request slots over "data", KV heads /
    recurrent state heads, conv channels and RG-LRU width over "model";
    the audio family encodes its slots' frames with the mesh servable's
    shard objects (``packs``) and keeps its heads of the cross K/V."""
    _decoder(cfg)
    if cfg.family == "audio":
        if paged is not None:
            raise ValueError("paged KV is not supported for family 'audio'")
        return encdec_mod.init_cache(params, cfg, frames, cache_len,
                                     packs=packs, mesh=mesh)
    if mesh is None:
        return lm_mod.init_cache(cfg, batch_size, cache_len, paged=paged,
                                 device=_device_of(params))
    from repro_torch.launch.sharding import shard_shape
    from repro_torch.models.attention import slot_reset_value
    whole = lm_mod.init_cache(cfg, batch_size, cache_len, paged=paged,
                              device="meta")
    specs = cache_shardings(whole, mesh)
    dev = _device_of(params)
    return map_with_path(lambda path, x: torch.full(
        shard_shape(x.shape, at_path(specs, path), mesh),
        slot_reset_value(path[-1]), dtype=x.dtype, device=dev), whole)


def cache_shardings(cache, mesh):
    """The spec of every leaf of a decode cache on ``mesh``: request slots
    (the batch dim) over "data", KV heads / recurrent state over "model"
    -- ``launch/sharding.spec_for_cache``'s divisibility-aware rules.
    ``cache`` is whole (its shapes are the global ones)."""
    from repro_torch.launch.sharding import cache_shardings as _shardings
    return _shardings(cache, mesh)


def shard_cache(cache, cfg: ModelConfig, mesh):
    """This rank's shard of a whole decode cache on ``mesh`` (``mesh``: a
    ``launch.mesh.ProcessMesh``), each leaf copied into storage of its own:
    the slot lifecycle ops then write shard-local, in place, and never
    change a leaf's shape."""
    _decoder(cfg)
    from repro_torch.launch.sharding import local_shard
    specs = cache_shardings(cache, mesh)
    coord = {a: mesh.coord(a) for a in mesh.axis_names}
    return map_with_path(lambda path, x: local_shard(
        x, at_path(specs, path), mesh, coord).clone(
        memory_format=torch.contiguous_format), cache)


def decode_step(params, cache, cfg: ModelConfig, token, pos, packs=None):
    """``pos``: scalar or int32 (B,) ragged per-slot positions; rows with
    pos < 0 are inactive slots whose cache state is left untouched. Returns
    (logits (B, 1, V) fp32, cache) with the cache written in place."""
    _decoder(cfg)
    if cfg.family == "audio":
        return encdec_mod.decode_step(params, cache, cfg, token, pos,
                                      packs=packs)
    return lm_mod.decode_step(params, cache, cfg, token, pos, packs=packs)


def decode_many(params, cache, cfg: ModelConfig, token, pos, n_steps, *,
                packs=None, remaining=None, eos_id=None, key=None,
                temperature: float = 0.0, top_k: int = 0,
                slot_offset: int = 0):
    """``n_steps`` decode steps with sampling, per-slot EOS / token budget
    handling and position bookkeeping all on the device: a Python loop that
    never reads a device value, so the host syncs once per window (when the
    caller reads the results). ``key`` / ``temperature`` / ``top_k``
    configure sampling (``models/sampling.py``; temperature 0 = greedy);
    the key is folded by (slot, position), so fused and per-step decoding
    sample alike. ``key`` None is ``PRNGKey(0)``, as in the reference.

    token (B, 1) int; pos scalar or (B,) (pos < 0 = inactive, a no-op row);
    ``remaining`` optional (B,) token budget (a slot that spends it
    deactivates); ``eos_id`` optional scalar or (B,) stop token (-1 = none;
    sampling it deactivates the slot after emitting it). A slot whose logits
    row goes non-finite is quarantined on the device: its token is not
    emitted, it deactivates and ``state['failed']`` flags it; other slots
    are untouched.

    Returns ``(tokens (K, B) int32, valid (K, B) bool, state)`` with state
    ``{'token', 'pos', 'remaining', 'failed', 'cache'}``. Row ``i`` samples
    as slot ``slot_offset + i`` (a data-parallel rank's slot range).
    """
    _decoder(cfg)
    dev = _device_of(params)
    b = token.shape[0]
    tok = torch.as_tensor(token, device=dev).to(torch.int32)
    pos = as_slot_positions(pos, b, dev)
    if remaining is None:
        rem = torch.full((b,), (2 ** 31 - 1) // 2, dtype=torch.int32,
                         device=dev)
    else:
        rem = torch.as_tensor(remaining, device=dev).to(torch.int32)
    if eos_id is None:
        eos = torch.full((b,), -1, dtype=torch.int32, device=dev)
    else:
        eos = torch.as_tensor(eos_id, device=dev).to(torch.int32).expand(b)
    if key is None:
        key = prng.PRNGKey(0, device=dev)
    bad = torch.zeros((b,), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    toks, valid = [], []
    for _ in range(int(n_steps)):
        logits, cache = decode_step(params, cache, cfg, tok, pos,
                                    packs=packs)
        rows = logits[:, 0, :]
        finite = torch.isfinite(rows).all(dim=-1)
        nxt = sample_tokens(rows, key, pos, temperature=temperature,
                            top_k=top_k, slot_offset=slot_offset)
        active = pos >= 0
        poisoned = active & ~finite
        emit = active & finite
        nxt = torch.where(emit, nxt, zero)
        rem = torch.where(emit, rem - 1, rem)
        done = emit & ((rem <= 0) | ((eos >= 0) & (nxt == eos)))
        pos = torch.where(done | poisoned, minus1,
                          torch.where(active, pos + 1, pos))
        tok = torch.where(emit, nxt, tok[:, 0])[:, None]
        bad = bad | poisoned
        toks.append(nxt)
        valid.append(emit)
    state = {"token": tok, "pos": pos, "remaining": rem, "failed": bad,
             "cache": cache}
    return torch.stack(toks), torch.stack(valid), state


def prefill_cache(params, cache, cfg: ModelConfig, tokens, length=None,
                  packs=None, last_only: bool = False):
    """One-pass prompt prefill into a decode cache: forward-path compute for
    tokens (B, S), in-place cache rewrite for positions 0..length-1. Returns
    (logits (B, S, V) fp32, cache). Audio prefills through its decode path
    instead (its decoder prompts are a few tokens). ``last_only``: the
    logits of position ``length - 1`` alone, (B, 1, V)."""
    _lm_only(cfg, "one-pass prefill")
    return lm_mod.prefill_cache(params, cache, cfg, tokens, length,
                                packs=packs, last_only=last_only)


def prefill_suffix(params, cache, cfg: ModelConfig, tokens, slot, start,
                   length=None, packs=None, last_only: bool = False):
    """Prefill only the suffix of a prompt whose first ``start`` tokens are
    already resident in slot ``slot`` of the batched engine cache: the
    paged prefix-cache hit path and the chunked prefill of the SLO
    scheduler, dense or paged, share this entry point (lm.prefill_suffix)."""
    _lm_only(cfg, "one-pass prefill")
    return lm_mod.prefill_suffix(params, cache, cfg, tokens, slot, start,
                                 length, packs=packs, last_only=last_only)


# ---------------------------------------------------------------------------
# slot lifecycle: the batch dimension of a decode cache is request slots
# ---------------------------------------------------------------------------

def _slot_mod(cfg: ModelConfig):
    _decoder(cfg)
    return encdec_mod if cfg.family == "audio" else lm_mod


def reset_slot(cache, cfg: ModelConfig, slot):
    """Empty one request slot in place (KV and recurrent state zeros,
    pos_map -1; the audio family's cross K/V zeros too)."""
    return _slot_mod(cfg).reset_slot(cache, slot)


def alloc_slot(cache, cfg: ModelConfig, slot):
    """Claim ``slot`` for a new request (a fresh slot is an empty slot)."""
    return reset_slot(cache, cfg, slot)


def free_slot(cache, cfg: ModelConfig, slot):
    """Retire ``slot`` after its request ends (recycle hygiene)."""
    return reset_slot(cache, cfg, slot)


def write_slot(cache, cfg: ModelConfig, slot, sub):
    """Copy a batch-1 cache (e.g. a prefill result) into ``slot``."""
    return _slot_mod(cfg).write_slot(cache, slot, sub)


def read_slot(cache, cfg: ModelConfig, slot):
    """``slot`` as a new batch-1 cache (write_slot's inverse; a copy)."""
    return _slot_mod(cfg).read_slot(cache, slot)


def write_slot_paged(cache, cfg: ModelConfig, slot, sub, page_row):
    """Insert a dense batch-1 prefill result into paged slot ``slot``."""
    _lm_only(cfg, "paged slots")
    return lm_mod.write_slot_paged(cache, slot, sub, page_row)


def restore_slot_paged(cache, cfg: ModelConfig, slot, page_row, resume_len):
    """Re-attach retained pages to ``slot`` (see lm.restore_slot_paged)."""
    _lm_only(cfg, "paged slots")
    return lm_mod.restore_slot_paged(cache, slot, page_row, resume_len)
