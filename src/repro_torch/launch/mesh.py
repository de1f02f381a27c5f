"""Meshes: the named device axes a sharded run is laid out on, and the
process groups that realise them.

Counterpart of ``repro/launch/mesh.py``. The reference builds a
``jax.sharding.Mesh`` and lets GSPMD partition every jitted program over
it. The port runs explicit SPMD instead: one process per mesh position,
each holding and computing only its shard, with ``torch.distributed``
groups along each axis carrying the collectives. Two forms:

  * :class:`AbstractMesh` -- axis names and sizes, no process group. The
    sharding rules (``launch/sharding.py``) read only these, so the
    256-position production mesh is a value here, not a cluster;
  * :class:`ProcessMesh` -- an :class:`AbstractMesh` over an initialised
    process group (``init_device_mesh`` with the axis names): this rank's
    coordinate and one group per axis. Its collectives are thin functions
    over those groups and count their calls, bytes and host seconds
    (``stats``). The groups' transfers go through one seam, the mesh's
    ``transport`` (:class:`GroupTransport`: the process group's own);
    a harness whose ranks share one card or host may install another
    (``launch/staging.py``).

Ranks are laid out row-major over the axes (rank ``r`` of a ``(data,
model)`` mesh sits at ``(r // model, r % model)``), the order
``jax.make_mesh`` gives its devices.

The collectives work on CPU and CUDA tensors over gloo (several ranks
sharing one card: gloo takes CUDA tensors for all_reduce, broadcast and
all_gather, as ``chip_smoke.py`` lm_tp's probe records) and NCCL (one
card a rank) alike. Sums of floating tensors narrower than fp32 travel as
fp32; a gather and the ring shift ``ppermute`` (a pipeline's hand-off)
move their tensors as they are -- gloo sends point to point only from host
tensors, so there a CUDA tensor's shift goes through a host copy. Which
backend a run uses is
the caller's choice, made when it initialises the process group
(:func:`init_distributed`).

Training differentiates through the collectives: ``copy_to`` /
``reduce_from`` / ``gather_from`` / ``scatter_to`` (tensor parallelism's
conjugate pairs over "model") and ``fsdp_gather`` (a weight's "data"
blocks gathered, its gradient reduce-scattered) are autograd Functions
over the same counted collectives; without grad they are the plain
collectives.
"""
from __future__ import annotations

import datetime
import time
from typing import Dict, Sequence, Tuple

import torch

SERVING_AXES = ("data", "model")


class AbstractMesh:
    """Named mesh axes and their sizes, in order (``shape`` is a dict like
    ``jax.sharding.Mesh.shape``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or any(s < 1 for s in shape):
            raise ValueError(f"bad mesh {shape} over axes {axis_names}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, as axis names and sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_mesh(shape, axes) -> AbstractMesh:
    """An arbitrary abstract mesh (tests, sizing)."""
    return AbstractMesh(shape, axes)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh, names) -> int:
    s = 1
    sizes = dict(mesh.shape)
    for n in (names if isinstance(names, (tuple, list)) else (names,)):
        s *= sizes.get(n, 1)
    return s


# ---------------------------------------------------------------------------
# process meshes
# ---------------------------------------------------------------------------

def init_distributed(backend: str, init_method: str, rank: int,
                     world_size: int, timeout_s: float = 300.0):
    """``torch.distributed.init_process_group`` with an explicit backend
    ('gloo' or 'nccl'), address (``file://...`` or ``tcp://host:port``),
    rank, world size and collective timeout, so a rank whose peer died
    raises instead of waiting forever."""
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=init_method, rank=int(rank),
        world_size=int(world_size),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


class ProcessMesh(AbstractMesh):
    """This rank's place on a mesh of processes and the groups along each
    axis. Build it with :func:`init_process_mesh`."""

    def __init__(self, shape, axis_names, device_mesh):
        super().__init__(shape, axis_names)
        import torch.distributed as dist
        self.device_mesh = device_mesh
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.coordinate = tuple(int(c) for c in device_mesh.get_coordinate())
        self.groups = {a: device_mesh.get_group(a) for a in axis_names}
        for a, c in zip(axis_names, self.coordinate):
            # gathers concatenate in group-rank order: it must be the
            # coordinate order along the axis
            if dist.get_group_rank(self.groups[a], self.rank) != c:
                raise RuntimeError(f"axis {a!r}: group rank differs from "
                                   f"the mesh coordinate {c}")
        self.stats: Dict[str, Dict[str, int]] = {}
        self.transport = GroupTransport(self)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis it lacks)."""
        if axis not in self.shape:
            return 0
        return self.coordinate[self.axis_names.index(axis)]

    def reset_stats(self):
        self.stats = {}

    def _timed(self, op: str, axis: str, nbytes: int, fn):
        """Run the collective ``fn``, counted in ``stats['<op>:<axis>']``:
        calls, bytes of its result and host seconds."""
        st = self.stats.setdefault(f"{op}:{axis}",
                                   {"calls": 0, "bytes": 0, "s": 0.0})
        t0 = time.perf_counter()
        out = fn()
        st["s"] += time.perf_counter() - t0
        st["calls"] += 1
        st["bytes"] += nbytes
        return out

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        """The tensor a sum sends: fp32 for narrower floats, int32 for
        bool, contiguous."""
        if x.is_floating_point() and x.element_size() < 4:
            return x.float().contiguous()
        if x.dtype == torch.bool:
            return x.to(torch.int32).contiguous()
        return x.contiguous()

    def _sum(self, op: str, axis: str, buf: torch.Tensor) -> torch.Tensor:
        """The sum of ``buf`` (a fresh copy) over ``axis``, counted."""
        return self._timed(op, axis, buf.numel() * buf.element_size(),
                           lambda: self.transport.sum(buf, axis))

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks along ``axis`` (a new tensor in
        ``x``'s dtype; ``x`` itself when the axis has one rank)."""
        if self.shape.get(axis, 1) == 1:
            return x
        return self._sum("all_reduce", axis,
                         self._wire(x).clone()).to(x.dtype)

    def all_max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks along ``axis``."""
        if self.shape.get(axis, 1) == 1:
            return x
        buf = x.contiguous().clone()
        return self._timed("all_max", axis, buf.numel() * buf.element_size(),
                           lambda: self.transport.max(buf, axis))

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int = -1
                       ) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``x`` over the
        ranks along ``axis``, summed in fp32 for narrower floats."""
        if self.shape.get(axis, 1) == 1:
            return x
        buf = self._wire(x).movedim(dim, 0).contiguous()
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
        out = self._timed("reduce_scatter", axis,
                          buf.numel() * buf.element_size(),
                          lambda: self.transport.reduce_scatter(buf, axis))
        return out.movedim(0, dim).to(x.dtype).contiguous()

    # -- differentiable collectives (training) -----------------------------
    # Conjugate pairs: the backward of each is the forward of its partner,
    # so a tensor replicated over an axis keeps a gradient that is whole
    # and equal on every rank of the axis. Each backward issues its
    # collective from the Function itself, in the autograd engine's order,
    # which every rank shares (same graph).

    def copy_to(self, x, axis: str):
        """Identity forward; the gradient all-reduced over ``axis`` (the
        input of a column-parallel block or of a vocabulary block)."""
        if self.shape.get(axis, 1) == 1:
            return x
        return _CopyToAxis.apply(x, self, axis)

    def reduce_from(self, x, axis: str):
        """All-reduce forward; the gradient passed through (a row-parallel
        partial, an embedding lookup's rows)."""
        if self.shape.get(axis, 1) == 1:
            return x
        return _ReduceFromAxis.apply(x, self, axis)

    def gather_from(self, x, axis: str, dim: int = -1):
        """All-gather forward; backward keeps this rank's block of the
        gradient (a column block made whole)."""
        if self.shape.get(axis, 1) == 1:
            return x
        return _GatherFromAxis.apply(x, self, axis, dim)

    def scatter_to(self, x, axis: str, dim: int = -1):
        """This rank's block forward; the gradient all-gathered (a
        replicated tensor cut to the rank's block)."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return x
        return _ScatterToAxis.apply(x, self, axis, dim)

    def fsdp_gather(self, x, axis: str, dim: int):
        """FSDP's weight gather: all-gather forward; backward
        reduce-scatters the gradient, the sum over ``axis``'s ranks of
        this rank's block."""
        if self.shape.get(axis, 1) == 1:
            return x
        return _FsdpGather.apply(x, self, axis, dim)

    def block_of(self, x, axis: str, dim: int = -1):
        """This rank's block of ``x`` along ``dim`` (no collective)."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return x
        w = x.shape[dim] // n
        return x.narrow(dim, self.coord(axis) * w, w)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = -1
                   ) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in
        coordinate order (exact: nothing is added)."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return x
        part = x.to(torch.int32) if x.dtype == torch.bool else x
        part = part.contiguous()
        parts = self._timed("all_gather", axis,
                            n * part.numel() * part.element_size(),
                            lambda: self.transport.gather(part, axis))
        return torch.cat(parts, dim=dim).to(x.dtype)

    def ppermute(self, x: torch.Tensor, axis: str, shift: int = 1
                 ) -> torch.Tensor:
        """The ring shift along ``axis``: the rank at index i receives the
        ``x`` of the rank at index (i - shift) mod n (``jax.lax.ppermute``
        with the pairs (i, (i + shift) mod n)); exact. Counted under
        ``ppermute:<axis>`` with the bytes this rank sends."""
        n = self.shape.get(axis, 1)
        if n == 1 or shift % n == 0:
            return x
        part = x.contiguous()
        return self._timed("ppermute", axis,
                           part.numel() * part.element_size(),
                           lambda: self.transport.shift(part, axis,
                                                        shift % n))

    def broadcast(self, x: torch.Tensor, axis: str, src: int = 0
                  ) -> torch.Tensor:
        """The ``x`` of the rank at index ``src`` along ``axis``, on every
        rank of the axis group (exact: the others send zeros)."""
        if self.shape.get(axis, 1) == 1:
            return x
        buf = self._wire(x).clone()
        if self.coord(axis) != int(src):
            buf.zero_()
        return self._sum("broadcast", axis, buf).to(x.dtype)


class GroupTransport:
    """A :class:`ProcessMesh`'s transfers over its axis groups, through
    the process group's backend (gloo or NCCL). Each call is collective
    over the axis group; ``buf`` is the caller's own copy and may be
    overwritten."""

    def __init__(self, mesh: ProcessMesh):
        self.mesh = mesh

    def sum(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(buf, group=self.mesh.groups[axis])
        return buf

    def max(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(buf, op=dist.ReduceOp.MAX,
                        group=self.mesh.groups[axis])
        return buf

    def gather(self, part: torch.Tensor, axis: str) -> list:
        """Every group rank's ``part``, in group order."""
        import torch.distributed as dist
        parts = [torch.empty_like(part)
                 for _ in range(self.mesh.shape[axis])]
        dist.all_gather(parts, part, group=self.mesh.groups[axis])
        return parts

    def shift(self, part: torch.Tensor, axis: str, shift: int
              ) -> torch.Tensor:
        """The ``part`` of the group rank ``shift`` places before this one
        (mod n); this rank's goes ``shift`` places on. gloo sends only
        host tensors point to point, so a CUDA tensor on gloo goes through
        a host copy each way."""
        import torch.distributed as dist
        group = self.mesh.groups[axis]
        n, me = self.mesh.shape[axis], self.mesh.coord(axis)
        staged = part.is_cuda and self.mesh.backend == "gloo"
        send = part.cpu() if staged else part
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          dist.get_global_rank(group, (me + shift) % n),
                          group),
               dist.P2POp(dist.irecv, recv,
                          dist.get_global_rank(group, (me - shift) % n),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(part.device) if staged else recv

    def reduce_scatter(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's block along dim 0 of the sum of ``buf``. NCCL
        reduce-scatters; gloo has no reduce-scatter, so there it is an
        all-reduce and a slice."""
        import torch.distributed as dist
        n, c = self.mesh.shape[axis], self.mesh.coord(axis)
        w = buf.shape[0] // n
        if self.mesh.backend == "nccl":
            out = torch.empty((w,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                              device=buf.device)
            dist.reduce_scatter_tensor(out, buf,
                                       group=self.mesh.groups[axis])
            return out
        return self.sum(buf, axis)[c * w:(c + 1) * w]


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.block_of(g, ctx.axis, ctx.dim).contiguous(),
                None, None, None)


class _ScatterToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.block_of(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, dim=ctx.dim), None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim),
                None, None, None)


_MESHES: Dict[Tuple, ProcessMesh] = {}


def init_process_mesh(shape, axis_names=SERVING_AXES) -> ProcessMesh:
    """The :class:`ProcessMesh` of ``shape`` over the initialised default
    process group, whose world size must equal the mesh size. Creating the
    axis groups is collective (every rank calls this in the same order);
    one mesh per (shape, axes) is kept and handed out again."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    need = 1
    for s in shape:
        need *= s
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh over {axis_names} needs torch.distributed up "
            f"with {need} ranks: call launch.mesh.init_distributed(backend, "
            f"init_method, rank, world_size) in every process first")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {shape} mesh over {axis_names} needs {need} ranks, the "
            f"process group has {dist.get_world_size()}")
    key = (shape, axis_names)
    mesh = _MESHES.get(key)
    if mesh is None:
        device_type = "cuda" if str(dist.get_backend()) == "nccl" else "cpu"
        dm = init_device_mesh(device_type, shape, mesh_dim_names=axis_names)
        mesh = _MESHES[key] = ProcessMesh(shape, axis_names, dm)
    return mesh


def destroy_distributed():
    """Forget the meshes and tear down the default process group."""
    import torch.distributed as dist
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()

