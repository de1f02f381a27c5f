"""Step builders: the train step (CE + aux + reported group-l1, AdamW, prox)
and the serving steps (prefill, decode).

Counterpart of ``repro/launch/steps.py``. A train step is a
plain function of ``(params, opt_state, batch)`` returning new params, a new
optimizer state and metrics (0-d tensors on the params' device); gradients
come from ``torch.autograd.grad`` over the param leaves, the counterpart of
``jax.value_and_grad``. With ``packs`` the packed projections run through
the layouts ``serving.export`` produced -- with ``PlanChoice`` packs the
plan kernels: K1 forward, K4 for dX and K5 for the values' gradient.

A global batch of one row on a mesh whose dp axes have more than one rank
takes the reference's sequence-parallel branch (``launch.sharding.
batch_shardings``: S over the dp axes): the steps then take the rank's
block of S and ``packs['seq']``, the ``common.SeqShard`` that
:func:`sequence_shard` builds from the global batch's shapes (the rank's
local block alone cannot tell: B 4 over 4 data ranks also gives a rank
one row). The dense LM family and BERT run it; the others raise
(``models.api.check_sequence_parallel``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regularizer import tree_group_penalty
from repro_torch.core.tree import leaves, unflatten
from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.models.api import check_sequence_parallel
from repro_torch.models.api import decode_step as model_decode_step
from repro_torch.models.api import model_forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """logits (B, S, V) fp32, labels (B, S) int; mean over all tokens.

    With ``mesh`` the logits are this rank's vocabulary block (B, S,
    V / model) -- the mesh Trainer's head never gathers them -- and the
    loss is vocabulary-parallel: the log-sum-exp from an all-reduced row
    max and an fp32 all-reduce of the blocks' sums of exp, the gold logit
    from the block that holds it (an all-reduce of one value and zeros);
    the reference's loss up to the order of the sums."""
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean()
    v = logits.shape[-1]
    with torch.no_grad():
        top = mesh.all_max(logits.max(dim=-1).values, "model")
    total = mesh.reduce_from(torch.exp(logits - top[..., None]).sum(-1),
                             "model")
    lse = top + torch.log(total)
    t = labels.long() - mesh.coord("model") * v
    mine = (t >= 0) & (t < v)
    gold = torch.gather(logits, -1, t.clamp(0, v - 1)[..., None])[..., 0]
    gold = mesh.reduce_from(torch.where(mine, gold, torch.zeros_like(gold)),
                            "model")
    return (lse - gold).mean()


def sequence_shard(cfg: ModelConfig, batch, mesh):
    """The ``common.SeqShard`` of this rank for the global batch ``batch``
    (a dict of leaves with ``.shape``: arrays, tensors or meta tensors) on
    ``mesh``, or None where ``launch.sharding.batch_shardings`` cuts no
    leaf's S (rows over the dp axes, or nothing to cut). A batch it does
    cut raises for a family that cannot run it
    (``models.api.check_sequence_parallel``). Pass it to a step as
    ``packs={'seq': ...}`` (merged with a servable's or an export's
    packs)."""
    from repro_torch.launch.sharding import (batch_shardings,
                                             is_sequence_parallel)
    from repro_torch.models.common import SeqShard
    if mesh is None:
        return None
    specs = batch_shardings(batch, mesh)
    if not any(is_sequence_parallel(sp) for sp in specs.values()):
        return None
    check_sequence_parallel(cfg)
    if not is_sequence_parallel(specs["tokens"]):
        raise ValueError(f"a sequence-parallel batch whose tokens "
                         f"{tuple(batch['tokens'].shape)} are not cut")
    return SeqShard.of(mesh, int(batch["tokens"].shape[1]))


def _split_seq(packs):
    """(the packs without 'seq', the ``SeqShard`` or None)."""
    if not packs or "seq" not in packs:
        return packs, None
    rest = {k: v for k, v in packs.items() if k != "seq"}
    return rest or None, packs["seq"]


def make_loss_fn(cfg: ModelConfig, packs=None, mesh_plan=None):
    """``loss_fn(params, batch) -> (loss, {ce, aux})``. ``mesh_plan`` (a
    :class:`MeshPlan`) runs this rank's part on a mesh: the leaves no
    shard object consumes are gathered whole first, the loss is
    vocabulary-parallel where the head is cut, and the reported penalty
    is the whole model's."""
    run_packs = dict(packs or {}, **(mesh_plan.packs if mesh_plan else {})
                     ) or None

    def loss_fn(params, batch):
        local = params
        if mesh_plan is not None:
            params = mesh_plan.whole(params)
        logits, aux = model_forward(params, cfg, batch, packs=run_packs)
        ce = cross_entropy(logits, batch["labels"],
                           mesh_plan.vocab_mesh if mesh_plan else None)
        loss = ce + aux
        if cfg.sparsity is not None and cfg.sparsity.lambda_reg > 0:
            # proximal gradient: the group-lasso term is handled exactly by
            # the blockwise soft-threshold in adamw_update; the penalty is
            # reported in the loss but carries no gradient (d||w||/dw is
            # NaN at the zero blocks the prox creates)
            with torch.no_grad():
                reg = tree_group_penalty(
                    local, cfg.sparsity.block_shape, 2,
                    cfg.sparsity.applies_to,
                    mesh_plan.shards(local) if mesh_plan else None)
            loss = loss + cfg.sparsity.lambda_reg * reg
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


class MeshPlan:
    """How a train step runs this rank's part of the model on a
    ``launch.mesh.ProcessMesh``: the spec of every param leaf
    (``spec_for_param`` in train mode: TP over "model" + FSDP over
    "data" + EP), the shard objects the layers run with (``packs``:
    ``common.DenseShard(train=True)`` for every cut linear weight and
    table, ``common.HeadShard`` where the KV heads -- an MLA layer's
    query heads -- divide "model" (the audio decoder's cross-attention
    too), ``common.SSDHeadShard`` / ``common.ChannelShard`` where an SSM
    layer's heads / conv channels or an RG-LRU layer's width divide it,
    as the mesh servable's (``servable._mixer_shards``),
    ``common.ExpertShard(train=True)`` for a MoE layer whose experts
    "model" cuts or whose rows the dp axes cut) and the leaves no shard
    object consumes (e.g. a layer-stacked norm scale or a conv's taps
    the rule cuts), gathered whole before the forward (``whole``). A
    routed-expert leaf is never gathered whole: a rank holds its E/m
    experts, whole along ``a`` only while its layer runs.

    ``replicated``: every leaf whole on every rank (``specs`` None) -- the
    dp packed step, whose params and packs every rank holds whole. Where
    the dp axes have more than one rank its only shard objects are the embedding's (a
    ``DenseShard(None, train=True)``: the table's gradient accumulates the
    whole batch's rows in one device's order, ``common._BatchRows``) and
    each MoE layer's row gather (the global batch's routing)."""

    def __init__(self, cfg: ModelConfig, mesh, replicated: bool = False):
        from repro_torch.launch.sharding import param_shardings
        from repro_torch.models.api import param_shapes
        self.mesh = mesh
        self.packs, self.whole_paths, self.vocab_mesh = {}, set(), None
        self.shapes = self.specs = None
        if replicated:
            from repro_torch.models.common import DenseShard
            if axis_size(mesh, dp_axes(mesh)) > 1:
                self.packs["embed"] = DenseShard(None, mesh, train=True)
            self._experts(cfg, {})
            return
        self.shapes = param_shapes(cfg)
        self.specs = param_shardings(self.shapes, mesh, "train")
        self._build(cfg, self.shapes)

    def _build(self, cfg, shapes):
        from repro_torch.core.tree import (at_path, flatten_with_path,
                                           norm_path, path_name)
        from repro_torch.models.common import DenseShard, HeadShard
        from repro_torch.serving.servable import (_layer_scopes,
                                                  _mixer_shards,
                                                  _routed_expert)
        mesh, m = self.mesh, self.mesh.shape.get("model", 1)
        sizes = dict(mesh.shape)
        experts = {}
        for path, leaf in flatten_with_path(shapes):
            spec = at_path(self.specs, path)
            name = norm_path(path_name(path))
            if _routed_expert(name, leaf.dim()):
                experts[name] = spec
                continue
            cut = [e for e in spec if e is not None and sizes[e] > 1]
            if not cut:
                continue
            linear = (name.endswith("/w") and leaf.dim() >= 2) \
                or name == "pos"
            if not linear or any(e is not None for e in spec[:-2]):
                self.whole_paths.add(path)
                continue
            axis = ("out" if m > 1 and spec[-2] == "model" else
                    "in" if m > 1 and spec[-1] == "model" else None)
            data = (-2 if spec[-2] == "data" else
                    -1 if spec[-1] == "data" else None)
            key = name[:-2] if name.endswith("/w") else name
            self.packs[key] = DenseShard(axis, mesh, data, train=True)
        for scope, kind in _layer_scopes(cfg):
            self.packs.update(_mixer_shards(cfg, scope, kind, mesh))
            wq, wo = (self.packs.get(f"{scope}/attn/{n}") for n in
                      ("wq", "wo"))
            if kind.mixer == "mla" and m > 1 and cfg.n_heads % m == 0 \
                    and getattr(wq, "axis", None) == "out" \
                    and getattr(wo, "axis", None) == "in":
                self.packs[f"{scope}/attn/heads"] = HeadShard(
                    mesh, cfg.n_heads)
        self._experts(cfg, experts)
        head = self.packs.get("embed" if cfg.tie_embeddings
                              or cfg.family in ("bert", "audio")
                              else "lm_head")
        if head is not None and head.axis == "out":
            self.vocab_mesh = mesh

    def _experts(self, cfg, specs):
        """An ``ExpertShard(train=True)`` for every MoE layer whose experts
        "model" cuts (``specs``: {name: spec} of the routed-expert leaves;
        empty when every leaf is whole) or whose rows the dp axes cut."""
        from repro_torch.models.common import ExpertShard
        from repro_torch.serving.servable import _layer_scopes
        m, d = self.mesh.shape.get("model", 1), self.mesh.shape.get("data", 1)
        dp = axis_size(self.mesh, dp_axes(self.mesh))
        for scope, kind in _layer_scopes(cfg):
            if kind.ffn != "moe":
                continue
            wi = specs.get(f"{scope}/ffn/wi")
            sharded = m > 1 and wi is not None and wi[-3] == "model"
            if not (sharded or dp > 1):
                continue
            fsdp = tuple(n for n in ("wi", "wg", "wo") if d > 1
                         and specs[f"{scope}/ffn/{n}"][-2] == "data") \
                if wi is not None else ()
            self.packs[f"{scope}/ffn/experts"] = ExpertShard(
                self.mesh, cfg.n_experts, sharded, gather_rows=dp > 1,
                train=True, fsdp=fsdp)

    def cut(self, path, x, period=None):
        """This rank's part of the whole leaf ``x`` at ``path`` or, with
        ``period``, of that period of a layer-stacked leaf (None when the
        rank's block of the period axis does not hold it):
        ``models.api.init_model_local``'s ``cut``."""
        from repro_torch.core.tree import at_path
        from repro_torch.launch.sharding import local_shard, shard_index
        coord = {a: self.mesh.coord(a) for a in self.mesh.axis_names}
        spec = at_path(self.specs, path)
        if period is None:
            return local_shard(x, spec, self.mesh, coord)
        idx, count = shard_index(spec[0], self.mesh, coord)
        w = at_path(self.shapes, path).shape[0] // count
        if not idx * w <= period < (idx + 1) * w:
            return None
        return local_shard(x, spec[1:], self.mesh, coord)

    def whole(self, params):
        """``params`` with every leaf in ``whole_paths`` gathered whole
        (differentiable)."""
        if not self.whole_paths:
            return params
        from repro_torch.core.tree import at_path, map_with_path
        from repro_torch.launch.sharding import whole_leaf
        return map_with_path(
            lambda path, x: whole_leaf(x, at_path(self.specs, path),
                                       self.mesh)
            if path in self.whole_paths else x, params)

    def shards(self, params) -> dict:
        """{path: LeafShard} of this rank's ``params``."""
        from repro_torch.launch.sharding import leaf_shards
        if self.specs is None:
            return {}
        return leaf_shards(params, self.specs, self.mesh)

    def sync_grads(self, grads):
        """Each rank's gradient of its own rows' mean loss -> the mean over
        the dp ranks (every rank of the dp axes ("pod", "data")), in tree
        order: a leaf cut over "data" already holds its block's sum over
        its pod's data ranks (FSDP's reduce-scatter) and is summed over
        the remaining dp axes ("pod"); every other leaf is all-reduced
        over all of them; then divided by the dp size. Leaves replicated
        over "model" need nothing over "model": the conjugate collectives
        leave their gradient whole and equal on every model rank."""
        from repro_torch.core.tree import at_path, map_with_path
        from repro_torch.launch.sharding import _axes
        dp = dp_axes(self.mesh)
        n = axis_size(self.mesh, dp)
        if n == 1:
            return grads

        def one(path, g):
            spec = () if self.specs is None else at_path(self.specs, path)
            cut = {a for e in spec for a in _axes(e)}
            return self.mesh.all_reduce(
                g, tuple(a for a in dp if a not in cut)) / n
        return map_with_path(one, grads)

    def mean(self, x):
        """A rank's metric -> its mean over the dp ranks."""
        dp = dp_axes(self.mesh)
        n = axis_size(self.mesh, dp)
        return x if n == 1 else self.mesh.all_reduce(x, dp) / n


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over the param leaves:
    (loss, metrics, grads) with grads a tree like ``params``; a leaf the
    loss does not reach gets zeros (as JAX gives)."""
    ps = leaves(params)
    live = [p.detach().requires_grad_(True) for p in ps]
    loss, metrics = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1, packs=None, donate: bool = False,
                    mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``grad_accum`` splits the batch into that many microbatches
    and averages their fp32 gradients. ``donate=True`` updates the given
    params and optimizer state in place and returns them (``adamw_update``'s
    ``donate``): the caller must not expect the old values after the step.

    ``mesh`` (a ``launch.mesh.ProcessMesh``): every rank calls the step on
    its shards of the params and optimizer state (``step.plan.specs``, the
    reference's ``param_shardings`` / ``opt_shardings`` in train mode) and
    its rows of the batch (``launch.sharding.local_rows(batch, mesh,
    grad_accum)``: its rows of each of the reference's microbatches, which
    the reshape below takes apart again); the gradients
    are the dp ranks' mean (over "data", and "pod" where the mesh has
    one), the global norm and the prox are the whole model's, and the
    metrics are equal on every rank. With ``packs`` (the packed
    fine-tuning step) the mesh has no model axis (a (data, 1) or
    (pod, data, 1) mesh): params and packs are whole on every rank, each
    runs its own rows and the gradients are all-reduced as a mean over the
    dp axes.

    ``packs['seq']`` (a ``common.SeqShard``, :func:`sequence_shard`): a
    sequence-parallel step, the batch a rank's (1, S/d) block of one
    global row. Its loss is the mean over the block's tokens, so the dp
    ranks' mean is the row's (the blocks are equal); attention gathers
    K / V over the dp axes. It takes no ``grad_accum`` (one row has no
    microbatches)."""
    packs, seq = _split_seq(packs)
    if seq is not None:
        check_sequence_parallel(cfg)
        if mesh is None or seq.mesh is not mesh:
            raise ValueError("a sequence-parallel step runs on the mesh its "
                             "SeqShard cuts S over: pass it as mesh=")
        if grad_accum > 1:
            raise ValueError(
                f"grad_accum {grad_accum} on a sequence-parallel batch: one "
                f"row cannot split into microbatches (the reference "
                f"reshapes its rows to (A, B/A))")
    plan = None
    if mesh is not None:
        if packs is not None:
            if mesh.shape.get("model", 1) != 1:
                raise ValueError(
                    f"a packed train step runs over data parallelism only: "
                    f"mesh {dict(mesh.shape)} has a model axis")
        plan = MeshPlan(cfg, mesh, replicated=packs is not None)
    if seq is not None:
        packs = dict(packs or {}, seq=seq)
    loss_fn = make_loss_fn(cfg, packs, plan)

    def train_step(params, opt_state, batch):
        metrics, loss, grads = _grads(params, batch)
        shards = None
        if plan is not None:
            grads = plan.sync_grads(grads)
            loss = plan.mean(loss)
            metrics = {k: plan.mean(v) for k, v in metrics.items()}
            shards = plan.shards(params)
        new_params, new_opt, om = adamw_update(grads, opt_state, params,
                                               opt_cfg, cfg.sparsity,
                                               donate=donate, shards=shards)
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    def _grads(params, batch):
        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            # fp32 sums of the microbatches' gradients, added in place (one
            # fp32 copy of the gradients beside a microbatch's own)
            gsum, lsum = None, None
            for a in range(grad_accum):
                mb = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                   + tuple(v.shape[1:]))[a]
                      for k, v in batch.items()}
                loss_a, _, g = value_and_grad(loss_fn, params, mb)
                if gsum is None:
                    gsum = [x.float() for x in leaves(g)]
                else:
                    for s, x in zip(gsum, leaves(g)):
                        s.add_(x)
                del g
                lsum = loss_a if lsum is None else lsum + loss_a
            grads = unflatten(params, [s.div_(grad_accum) for s in gsum])
            loss = lsum / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        return metrics, loss, grads

    train_step.plan = plan
    return train_step



def make_prefill_step(cfg: ModelConfig, packs=None):
    """``prefill_step(params, batch) -> (B,)`` greedy next token after the
    last position of ``batch['tokens']``.

    ``packs['seq']`` (a ``common.SeqShard``): ``batch`` is the rank's
    block of a sequence-parallel row. The rank holding the row's last
    position computes the head on that position alone and the token is
    broadcast from it over the dp axes: every rank returns one device's
    token."""
    _, seq = _split_seq(packs)
    if seq is not None:
        check_sequence_parallel(cfg)

    def prefill_step(params, batch):
        with torch.no_grad():
            if seq is None:
                logits, _ = model_forward(params, cfg, batch, packs=packs)
                return torch.argmax(logits[:, -1], dim=-1)
            logits, _ = model_forward(params, cfg, batch, packs=packs,
                                      last_only=True)
            b = batch["tokens"].shape[0]
            tok = torch.zeros((b,), dtype=torch.int64,
                              device=batch["tokens"].device) \
                if logits is None else torch.argmax(logits[:, -1], dim=-1)
            n = axis_size(seq.mesh, seq.axes)
            return seq.mesh.broadcast(tok, seq.axes, n - 1)
    return prefill_step


def make_serve_step(cfg: ModelConfig, packs=None):
    """``serve_step(params, cache, token (B, 1), pos) -> (next token (B, 1)
    int32, cache)``: one greedy decode step, the cache written in place."""
    def serve_step(params, cache, token, pos):
        with torch.no_grad():
            logits, cache = model_decode_step(params, cache, cfg, token, pos,
                                              packs=packs)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return serve_step
