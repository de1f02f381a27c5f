"""GPipe-style pipeline parallelism over ``torch.distributed``: the
fill-drain schedule, forward and backward.

Counterpart of ``repro/launch/pipeline.py``. Stages hold contiguous layer
groups; microbatches stream through with ring-shift hand-offs; bubbles =
(S-1)/(S-1+M) as usual. The reference expresses the schedule as a
``lax.fori_loop`` over ``ppermute`` inside ``shard_map``; the port runs it
explicitly, one process a stage on a ``launch.mesh.ProcessMesh`` with a
"pipe" axis (``init_process_mesh((S,), ("pipe",))``), and takes that mesh
as an argument.

Where the port departs from the reference:

  * bubble ticks compute nothing. The reference's every stage runs
    ``layer_fn`` on every one of the M + S - 1 ticks and discards the
    bubbles' results; here a stage runs it only on the M ticks that carry
    a microbatch (M ``layer_fn`` calls a stage a forward, and M recomputes
    in a backward) and hands on zeros from a bubble tick;
  * the hand-off is ``ProcessMesh.ppermute`` (counted in ``stats`` under
    ``ppermute:<axis>``), through the mesh's transport: the process
    group's point-to-point send / recv (gloo takes host tensors only, so a
    CUDA tensor there goes through a host copy each way) or, for ranks
    sharing one card or host, ``launch/staging.SharedStaging``'s buffers
    (each rank reads its one peer's). Ticks shift M + S - 2 times, not
    M + S - 1: the last tick's shift carries nothing used;
  * the result is made whole on every rank by ``ProcessMesh.broadcast``
    from the last stage (exact), where the reference ``psum``s zeros and
    the last stage's outputs;
  * the backward is a ``torch.autograd.Function`` around the schedule
    (``jax.grad`` differentiates the reference's loop). A stage keeps the
    input of each microbatch it ran (M tensors of one microbatch's shape)
    and recomputes its forward from it in the backward; the cotangents
    move one stage up the ring per tick, in reverse tick order. A stage's
    parameter gradient is accumulated over the microbatches in fp32, last
    microbatch first, and cast to the parameters' dtype once. The
    gradient of ``x_microbatches`` is stage 0's, broadcast to every rank
    (the reference's input is replicated, so its cotangent is the sum over
    the stages, of which only stage 0's is not zero). The output's
    cotangent is taken from the last stage, as the reference takes one
    copy of its replicated output: every rank must backpropagate through
    the result (the same loss on each), since the backward is collective.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, map_with_path, unflatten


def _stage_block(stage_params, n_stages: int, stage: int):
    """Stage ``stage``'s parameters from a tree stacked over stages on its
    leading dim: the whole stack (leading dim ``n_stages``) or this rank's
    block of one (the reference's shard, ``p[0]``)."""
    def pick(path, p):
        if p.shape[0] == n_stages:
            return p[stage]
        if p.shape[0] == 1:
            return p[0]
        raise ValueError(f"stage params {path}: leading dim {p.shape[0]} "
                         f"is neither the {n_stages} stages nor one block")
    return map_with_path(pick, stage_params)


class _Schedule:
    """The fill-drain schedule of one rank: stage ``coord(axis)`` of
    ``mesh.shape[axis]`` over ``m`` microbatches."""

    def __init__(self, layer_fn, like, mesh, axis: str, m: int):
        self.layer_fn, self.like, self.mesh, self.axis = (layer_fn, like,
                                                          mesh, axis)
        self.n, self.s, self.m = mesh.shape[axis], mesh.coord(axis), m
        self.ticks = m + self.n - 1

    def _run(self, params, inp):
        y = self.layer_fn(params, inp)
        if y.shape != inp.shape or y.dtype != inp.dtype:
            raise ValueError(f"layer_fn maps {tuple(inp.shape)} "
                             f"{inp.dtype} to {tuple(y.shape)} {y.dtype}: "
                             f"a stage must keep the activation's shape "
                             f"and dtype")
        return y

    def forward(self, xs, param_leaves, keep: bool):
        """-> (outputs (M, mb, ...) whole on every rank, the stage inputs
        of each microbatch when ``keep``)."""
        params = unflatten(self.like, param_leaves)
        zero = torch.zeros_like(xs[0])
        buf, outs, inputs = None, [None] * self.m, [None] * self.m
        for t in range(self.ticks):
            mb, y = t - self.s, zero
            if 0 <= mb < self.m:
                inp = xs[mb] if self.s == 0 else buf
                if keep:
                    inputs[mb] = inp
                y = self._run(params, inp)
                if self.s == self.n - 1:
                    outs[mb] = y
            if t < self.ticks - 1:
                buf = self.mesh.ppermute(y, self.axis, 1)
        last = (torch.stack(outs) if self.s == self.n - 1
                else torch.zeros_like(xs))
        return self.mesh.broadcast(last, self.axis, src=self.n - 1), inputs

    def backward(self, g_out, inputs, param_leaves, need_x: bool,
                 need_p):
        """-> (dX whole on every rank or None, each leaf's gradient or
        None)."""
        live = [p.detach().requires_grad_(need)
                for p, need in zip(param_leaves, need_p)]
        params = unflatten(self.like, live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               if need else None for p, need in zip(param_leaves, need_p)]
        need_inp = need_x or self.s > 0
        zero = torch.zeros_like(g_out[0])
        dxs, g_buf = [None] * self.m, None
        for t in reversed(range(self.ticks)):
            mb, send = t - self.s, zero
            if 0 <= mb < self.m:
                gy = g_out[mb] if self.s == self.n - 1 else g_buf
                inp = inputs[mb].detach().requires_grad_(need_inp)
                want = [p for p in live if p.requires_grad]
                with torch.enable_grad():
                    y = self._run(params, inp)
                    grads = list(torch.autograd.grad(
                        y, ([inp] if need_inp else []) + want, gy,
                        allow_unused=True))
                if need_inp:
                    send = grads.pop(0)
                    if self.s == 0:
                        dxs[mb] = send
                got = iter(grads)
                for a in acc:
                    if a is not None:
                        g = next(got)
                        if g is not None:
                            a += g.float()
            if t > 0:
                g_buf = self.mesh.ppermute(send, self.axis, -1)
        dx = None
        if need_x:
            first = (torch.stack(dxs) if self.s == 0
                     else torch.zeros_like(g_out))
            dx = self.mesh.broadcast(first, self.axis, src=0)
        return dx, [None if a is None else a.to(p.dtype)
                    for a, p in zip(acc, param_leaves)]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, xs, *param_leaves):
        out, inputs = sched.forward(xs, param_leaves, keep=True)
        ctx.sched, ctx.inputs = sched, inputs
        ctx.save_for_backward(*param_leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        param_leaves = ctx.saved_tensors
        dx, dps = ctx.sched.backward(g.contiguous(), ctx.inputs,
                                     param_leaves, ctx.needs_input_grad[1],
                                     ctx.needs_input_grad[2:])
        ctx.inputs = None
        return (None, dx, *dps)


def pipeline_apply(layer_fn, stage_params, x_microbatches, mesh,
                   axis: str = "pipe"):
    """Run ``layer_fn(stage_params, x)`` across pipeline stages.

    stage_params: a tree stacked over stages on its leading dim -- the
    whole stack, or this rank's block of one; rank ``mesh.coord(axis)``
    runs its stage. x_microbatches: (M, mb, ...) microbatched inputs (read
    on stage 0). ``layer_fn`` keeps the activation's shape and dtype.
    Returns outputs (M, mb, ...) whole on every rank of ``axis``.
    Collective: every rank of the axis calls it with the same shapes and,
    under autograd, with the same inputs requiring grad.
    """
    n = mesh.shape[axis]
    m = x_microbatches.shape[0]
    local = _stage_block(stage_params, n, mesh.coord(axis))
    param_leaves = leaves(local)
    sched = _Schedule(layer_fn, local, mesh, axis, m)
    if torch.is_grad_enabled() and (x_microbatches.requires_grad or any(
            p.requires_grad for p in param_leaves)):
        return _Pipeline.apply(sched, x_microbatches, *param_leaves)
    return sched.forward(x_microbatches, param_leaves, keep=False)[0]
