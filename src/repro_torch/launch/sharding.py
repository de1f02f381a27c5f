"""Divisibility-aware sharding rules: DP + FSDP + TP + EP (+ SP).

Counterpart of ``repro/launch/sharding.py``, rule for rule. A spec is a
tuple with one entry per dimension: an axis name, a tuple of axis names
(the dimension splits over their product, first axis outermost), or None
(replicated) -- what ``jax.sharding.PartitionSpec`` holds. Where the
reference wraps a spec in a ``NamedSharding``, the ``*_shardings``
functions here return the spec tree itself.

Conventions (single pod mesh ("data","model"); multi-pod prepends "pod"
which folds into DP):
  * column-parallel 2-D weights (out, in): out -> "model", in -> "data" (FSDP)
  * row-parallel    2-D weights (wo/out*): out -> "data",  in -> "model"
  * expert 3-D weights (E, a, b):          E   -> "model" (EP), a -> "data"
  * embeddings (V, d): V -> "model", d -> "data"
  * 1-D (norm scales, biases, gates): replicated
  * a dim is sharded over an axis only when divisible, else replicated --
    this is what lets kv_heads=1 (MQA) or tiny projections coexist with a
    16-wide model axis.

Caches/batches shard batch over DP and heads/state over "model".
Stacked (period) leaves get leading None specs automatically.

:func:`local_shard` cuts a whole tensor to one rank's shard from a spec
and the rank's coordinate; :func:`shard_shape` is that shard's shape;
:class:`LeafShard` is a rank's place in one sharded leaf (offsets, and the
sum over the axes that cut it), what the block-norm code of the pruner,
the regularizer and the optimizer needs on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.tree import map_with_path, norm_path, path_name
from repro_torch.launch.mesh import dp_axes

_ROW_PARALLEL = ("wo", "out", "out_proj")
# router: small, replicated keeps top-k local. MLA latent down/up
# projections (w_dkv/w_uk/w_uv/w_krope): rank-sized, consumed via per-head
# reshapes in the absorbed decode path -- sharding them buys little.
_REPLICATE = ("router", "w_dkv", "w_uk", "w_uv", "w_krope")


def _sizes(mesh):
    return dict(mesh.shape)


def _div(shape, dim, ax, sizes):
    return ax is not None and shape[dim] % sizes.get(ax, 1) == 0 and \
        shape[dim] >= sizes.get(ax, 1)


def leaf_name(path) -> str:
    """A tree path as the reference's ``_leaf_name`` renders it:
    'blocks/0/attn/wqkv/w'."""
    return norm_path(path_name(path))


def spec_for_param(name: str, shape, mesh, mode: str = "train") -> tuple:
    """mode="train": TP + FSDP (weights gathered per layer; optimizer state
    must fit). mode="inference": TP-only -- no data-axis weight sharding, so
    prefill/decode never pay per-layer weight all-gathers; experts use 2-D
    (E x f) sharding so 100B+ MoE weights still fit."""
    sizes = _sizes(mesh)
    toks = name.split("/")
    short = toks[-2] if toks[-1] == "w" and len(toks) >= 2 else toks[-1]
    ndim = len(shape)

    if any(t in short for t in _REPLICATE):
        return (None,) * ndim

    # expert weights: trailing 3 dims (E, a, b)
    if ndim >= 3 and short in ("wi", "wg", "wo") and "ffn" in name:
        lead = ndim - 3
        e_ax = "model" if _div(shape, lead, "model", sizes) else None
        if mode == "inference":
            # 2-D EP x TP: the f dim over data (wi/wg: dim 2; wo: dim 1)
            if short == "wo":
                f_ax = "data" if _div(shape, lead + 1, "data", sizes) else None
                return (None,) * lead + (e_ax, f_ax, None)
            f_ax = "data" if _div(shape, lead + 2, "data", sizes) else None
            return (None,) * lead + (e_ax, None, f_ax)
        a_ax = "data" if _div(shape, lead + 1, "data", sizes) else None
        return (None,) * lead + (e_ax, a_ax, None)

    if ndim == 1 or np.prod(shape) < 4096:
        return (None,) * ndim

    # generic 2-D (possibly stacked): trailing (out, in)
    lead = ndim - 2
    row = any(short.startswith(t) or short == t for t in _ROW_PARALLEL)
    fsdp = "data" if mode == "train" else None
    if row:
        out_ax = fsdp if _div(shape, lead, "data", sizes) else None
        in_ax = "model" if _div(shape, lead + 1, "model", sizes) else None
    else:
        out_ax = "model" if _div(shape, lead, "model", sizes) else None
        in_ax = fsdp if _div(shape, lead + 1, "data", sizes) else None
    return (None,) * lead + (out_ax, in_ax)


def param_shardings(shape_tree: Any, mesh, mode: str = "train"):
    """The spec of every leaf of a tree of tensors (or anything with a
    ``shape``)."""
    return map_with_path(lambda path, leaf: spec_for_param(
        leaf_name(path), tuple(leaf.shape), mesh, mode), shape_tree)


def opt_shardings(opt_shape_tree: Any, mesh):
    """``m`` / ``v`` take the spec of their param (the rule applied to the
    param's own name and shape); ``step`` is replicated."""
    return {k: (param_shardings(v, mesh) if k in ("m", "v")
                else map_with_path(lambda _, leaf: (None,) * len(
                    tuple(leaf.shape)), v))
            for k, v in opt_shape_tree.items()}


# model-axis candidate dim per cache leaf kind, relative to the unstacked
# layout (never the head_dim / time dims)
_CACHE_MODEL_DIM = {
    "k": 2, "v": 2,          # (B, T, Hkv, D) -> kv heads
    "k_scale": 2, "v_scale": 2,  # int8-cache scales (B, T, Hkv)
    "c_kv": 2, "k_rope": None,   # MLA latent (B, T, r) -> rank
    "state": 1,              # SSD (B, H, P, N) -> heads
    "conv": 2,               # (B, W, C) -> channels
    "h": 1,                  # RG-LRU (B, W) -> width
    "cross_k": 3, "cross_v": 3,  # stacked (L, B, T, Hkv, D) handled by lead
}

#: paged-KV pool leaves: axis 0 (+lead) is PHYSICAL PAGES -- one shared id
#: space across the pool, never sharded (and never the dp batch dim); only
#: the kv-head / latent-rank dim goes over "model". page_table / pos_map
#: stay replicated int32 bookkeeping.
_PAGE_POOL_MODEL_DIM = {
    "k_pages": 2, "v_pages": 2,      # (N, ps, Hkv, D) -> kv heads
    "c_kv_pages": 2,                 # (N, ps, r) -> latent rank
    "k_rope_pages": None,            # (N, ps, dr) shared rope key
}


def spec_for_cache(name: str, shape, mesh) -> tuple:
    sizes = _sizes(mesh)
    dp = dp_axes(mesh)
    dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
    ndim = len(shape)
    toks = name.split("/")
    short = toks[-1]
    if ndim <= 1:
        return (None,) * ndim
    # caches carry a leading stack dim when period-stacked: detect 'blocks'
    lead = 1 if ("blocks" in toks or short.startswith("cross")
                 or "self" in toks) else 0
    if short.startswith("cross"):
        lead = 1
    if short == "page_table":
        return (None,) * ndim
    if short.endswith("_pages"):
        spec = [None] * ndim
        mdim = _PAGE_POOL_MODEL_DIM.get(short)
        if mdim is not None:
            d = mdim + lead
            if d < ndim and _div(shape, d, "model", sizes):
                spec[d] = "model"
        return tuple(spec)
    spec = [None] * ndim
    bdim = lead
    if bdim < ndim and shape[bdim] % dp_size == 0 and shape[bdim] >= dp_size:
        spec[bdim] = dp if len(dp) > 1 else (dp[0] if dp else None)
    mdim = _CACHE_MODEL_DIM.get(short)
    if mdim is not None:
        d = mdim + (lead if not short.startswith("cross") else 0)
        if d < ndim and d > bdim and _div(shape, d, "model", sizes):
            spec[d] = "model"
    return tuple(spec)


def cache_shardings(cache_shape_tree: Any, mesh):
    return map_with_path(lambda path, leaf: spec_for_cache(
        leaf_name(path), tuple(leaf.shape), mesh), cache_shape_tree)


def batch_shardings(batch_shape_tree: Any, mesh):
    """Rows (dim 0) over the dp axes where they divide; a batch of one row
    whose dim 1 divides takes the sequence-parallel branch: S (dim 1) over
    the dp axes (a tuple on a multi-pod mesh); otherwise replicated. Leaf
    for leaf the reference's spec."""
    sizes = _sizes(mesh)
    dp = dp_axes(mesh)
    dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
    entry = dp if len(dp) > 1 else (dp[0] if dp else None)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % dp_size == 0 and \
                shape[0] >= dp_size:
            spec[0] = entry
        elif len(shape) >= 2 and shape[0] == 1 and \
                shape[1] % dp_size == 0:
            spec[1] = entry                                    # SP
        return tuple(spec)
    return map_with_path(one, batch_shape_tree)


def is_sequence_parallel(spec) -> bool:
    """True for a batch leaf's spec from the sequence-parallel branch of
    :func:`batch_shardings` (one row, S cut)."""
    return len(spec) >= 2 and spec[0] is None and spec[1] is not None


def replicated(mesh=None) -> tuple:
    """The replicated spec (``P()``)."""
    return ()


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_index(entry, mesh, coord) -> tuple:
    """(index, count) of this rank's block along a dim whose spec entry is
    ``entry``: the row-major index over the entry's axes at ``coord`` (a
    dict axis -> index) and the product of their sizes."""
    sizes = _sizes(mesh)
    idx, count = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + int(coord.get(a, 0))
        count *= sizes[a]
    return idx, count


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        _, count = shard_index(entry, mesh, {})
        out[d] //= count
    return tuple(out)


def local_shard(x, spec, mesh, coord):
    """This rank's shard of the whole tensor (or numpy array) ``x`` under
    ``spec``: along every sharded dim, the block at the rank's index
    (``coord``: a dict axis -> index, e.g. ``{'data': 0, 'model': 2}``).
    A view where slicing allows; a dim that does not divide raises."""
    for d, entry in enumerate(spec):
        idx, count = shard_index(entry, mesh, coord)
        if count == 1:
            continue
        n = x.shape[d]
        if n % count:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"into {count} shards ({entry})")
        w = n // count
        sl = [slice(None)] * x.ndim
        sl[d] = slice(idx * w, (idx + 1) * w)
        x = x[tuple(sl)]
    return x


def _coord(mesh) -> dict:
    return {a: mesh.coord(a) for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """This rank's shard of a leaf of whole shape ``shape`` under ``spec``
    on the process mesh ``mesh``."""

    mesh: object
    spec: tuple
    shape: tuple

    @property
    def axes(self) -> tuple:
        """The mesh axes that cut the leaf, in mesh order."""
        used = {a for e in self.spec for a in _axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    @property
    def offsets(self) -> tuple:
        """The whole-leaf index of the shard's first element, per dim."""
        coord = _coord(self.mesh)
        out = []
        for d, entry in enumerate(self.spec):
            idx, count = shard_index(entry, self.mesh, coord)
            out.append(idx * (self.shape[d] // count))
        return tuple(out)

    def sum(self, x):
        """``x`` summed over the ranks of every axis that cuts the leaf
        (fp32 on the wire): partial sums of the shard's elements become
        the whole leaf's."""
        for a in self.axes:
            x = self.mesh.all_reduce(x, a)
        return x


def leaf_shards(local_tree: Any, spec_tree: Any, mesh) -> dict:
    """{path: :class:`LeafShard`} for every leaf of a rank's ``local_tree``
    that its spec cuts (a replicated leaf has no entry; the whole shape is
    the local shape times the shard counts)."""
    from repro_torch.core.tree import at_path, flatten_with_path
    out = {}
    for path, leaf in flatten_with_path(local_tree):
        spec = at_path(spec_tree, path)
        counts = [shard_index(e, mesh, {})[1] for e in spec]
        if any(c > 1 for c in counts):
            out[path] = LeafShard(mesh, tuple(spec), tuple(
                n * c for n, c in zip(leaf.shape, counts)))
    return out


def whole_leaf(x, spec, mesh):
    """The whole leaf from this rank's shard ``x``: each cut dim gathered
    over its axes, innermost axis first. Under autograd a "data" gather is
    FSDP's (gradient reduce-scattered: the data ranks' rows add up) and a
    "model" gather keeps the rank's block of a gradient that every model
    rank holds whole (the leaf's use is replicated over "model")."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if mesh.shape.get(a, 1) == 1:
                continue
            if a == "model":
                x = mesh.gather_from(x, a, dim=d)
            else:
                x = mesh.fsdp_gather(x, a, dim=d)
    return x


def local_rows(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors),
    cut by :func:`batch_shardings` at the rank's data coordinate: its
    rows, or of a one-row batch on the sequence-parallel branch its block
    of S. A batch that the dp axes cut neither way raises: every data
    rank must take its own part.

    ``grad_accum`` = A > 1 (a step that splits its rows into A
    microbatches, ``launch.steps.make_train_step``): the reference's
    microbatch a is global rows [a B/A, (a+1) B/A), so the rank takes its
    block of each microbatch's rows, microbatch by microbatch, and the
    step's reshape of them to (A, B/(A d), ...) gives each microbatch's
    rows of this rank in global order. B must divide by A times the
    data ranks; one row cannot split into microbatches at all."""
    dp = dp_axes(mesh)
    n_data = int(np.prod([mesh.shape[a] for a in dp]))
    if grad_accum > 1:
        for k, v in batch.items():
            if v.shape[0] == 1:
                raise ValueError(
                    f"batch leaf {k!r} {tuple(v.shape)}: a batch of one row "
                    f"cannot split into grad_accum {grad_accum} "
                    f"microbatches (the reference reshapes its rows to "
                    f"(A, B/A))")
    if grad_accum > 1 and n_data > 1:
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % (grad_accum * n_data):
                raise ValueError(
                    f"batch leaf {k!r} {tuple(v.shape)}: {b} rows do not "
                    f"divide into grad_accum {grad_accum} microbatches of "
                    f"{n_data} data ranks' rows ({grad_accum * n_data})")
            micro = v.reshape((grad_accum, b // grad_accum)
                              + tuple(v.shape[1:]))
            parts = [local_rows({k: micro[a]}, mesh)[k]
                     for a in range(grad_accum)]
            if isinstance(v, np.ndarray):
                out[k] = np.concatenate(parts)
            else:
                import torch
                out[k] = torch.cat(parts)
        return out
    specs = batch_shardings(batch, mesh)
    coord = _coord(mesh)
    out = {}
    for k, v in batch.items():
        if n_data > 1 and specs[k][0] is None and \
                not is_sequence_parallel(specs[k]):
            raise ValueError(f"batch leaf {k!r} {tuple(v.shape)}: its rows "
                             f"do not divide over the data axes {dp}, nor "
                             f"does its one row's S")
        out[k] = local_shard(v, specs[k], mesh, coord)
    return out
