"""Meshes: the named device axes a sharded run is laid out on, and the
process groups that realise them.

Counterpart of ``repro/launch/mesh.py``. The reference builds a
``jax.sharding.Mesh`` and lets GSPMD partition every jitted program over
it. The port runs explicit SPMD instead: one process per mesh position,
each holding and computing only its shard, with ``torch.distributed``
groups along each axis carrying the collectives. Three forms:

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
    (``launch/staging.py``);
  * a dry :class:`ProcessMesh` (:meth:`ProcessMesh.dry`) -- one rank's
    place on an abstract mesh with no process group, whose transport is a
    :class:`MetaTransport`: every collective hands back a meta tensor of
    its output's shape and is counted in ``stats`` as a real one is. The
    dry-run (``launch/dryrun.py``) runs a rank's step on it.

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

Every collective takes ``axis`` as one axis name or a tuple of names --
the data-parallel axes ("pod", "data") of a multi-pod mesh -- and runs
over a tuple as one collective an axis over the groups that exist: a
gather the last axis first and a reduce-scatter the first axis first, so
either is exact and in the row-major order of the tuple (first axis
outermost, :meth:`ProcessMesh.coord`'s and ``jax.make_mesh``'s); a sum
one fp32 sum an axis, the last axis first, rounded once (its order of
additions differs from one group's over the product, which is never
built). ``stats`` counts each axis moved under its own ``op:axis`` key.

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


def axis_names_of(axis) -> tuple:
    """``axis`` -- one axis name or a tuple of them -- as a tuple."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(mesh, names) -> int:
    """The ranks along ``names`` (one axis name or a tuple: the product of
    their sizes; 1 for an axis the mesh lacks)."""
    s = 1
    sizes = dict(mesh.shape)
    for n in axis_names_of(names):
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

    @classmethod
    def dry(cls, mesh: AbstractMesh, coordinate=None) -> "ProcessMesh":
        """The rank at ``coordinate`` (rank 0 by default) of the abstract
        ``mesh`` with no process group: ``backend`` 'dry', its transport a
        :class:`MetaTransport`. Nothing above the transport changes, so
        ``stats`` counts calls and bytes as that rank of a real run would;
        the tensors must be on the meta device."""
        self = cls.__new__(cls)
        AbstractMesh.__init__(self, tuple(mesh.shape.values()),
                              mesh.axis_names)
        coordinate = tuple(int(c) for c in (
            coordinate or (0,) * len(self.axis_names)))
        if len(coordinate) != len(self.axis_names) or any(
                not 0 <= c < self.shape[a]
                for a, c in zip(self.axis_names, coordinate)):
            raise ValueError(f"coordinate {coordinate} is not on {self}")
        rank = 0
        for a, c in zip(self.axis_names, coordinate):
            rank = rank * self.shape[a] + c
        self.device_mesh, self.groups = None, {}
        self.rank, self.backend, self.coordinate = rank, "dry", coordinate
        self.stats = {}
        self.transport = MetaTransport(self)
        return self

    @property
    def is_dry(self) -> bool:
        """True on a dry mesh (:meth:`dry`): collectives move nothing."""
        return self.backend == "dry"

    def coord(self, axis) -> int:
        """This rank's index along ``axis`` (0 for an axis it lacks); for a
        tuple of axes the row-major index over them, first axis outermost
        (``launch.sharding.shard_index``'s order, and ``jax.make_mesh``'s)."""
        idx = 0
        for a in axis_names_of(axis):
            if a in self.shape:
                idx = idx * self.shape[a] + self.coordinate[
                    self.axis_names.index(a)]
        return idx

    def _moved(self, axis) -> tuple:
        """The axes of ``axis`` (a name or a tuple) with more than one
        rank: the ones a collective over it moves data along."""
        return tuple(a for a in axis_names_of(axis)
                     if self.shape.get(a, 1) > 1)

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

    def _sum(self, op: str, axis, buf: torch.Tensor) -> torch.Tensor:
        """The sum of ``buf`` (a fresh copy) over ``axis``, counted: over a
        tuple, one sum an axis, the last axis first (every rank of the
        tuple ends with the same bits)."""
        for a in reversed(self._moved(axis)):
            buf = self._timed(op, a, buf.numel() * buf.element_size(),
                              lambda: self.transport.sum(buf, a))
        return buf

    def all_reduce(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Sum of ``x`` over the ranks along ``axis`` -- one name or a
        tuple: the sums over each axis in fp32 for narrower floats, one
        rounding at the end (a new tensor in ``x``'s dtype; ``x`` itself
        when the axes have one rank)."""
        if not self._moved(axis):
            return x
        return self._sum("all_reduce", axis,
                         self._wire(x).clone()).to(x.dtype)

    def all_max(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks along ``axis``."""
        moved = self._moved(axis)
        if not moved:
            return x
        buf = x.contiguous().clone()
        for a in reversed(moved):
            buf = self._timed("all_max", a, buf.numel() * buf.element_size(),
                              lambda: self.transport.max(buf, a))
        return buf

    #: the wire copy a reduce-scatter makes at a time: a larger gradient
    #: goes in slabs of another dim (an FSDP expert gradient of GBs would
    #: otherwise take a whole fp32 copy, twice over for ``dim`` > 0)
    SLAB_BYTES = 256 << 20

    def reduce_scatter(self, x: torch.Tensor, axis, dim: int = -1
                       ) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``x`` over the
        ranks along ``axis``, summed in fp32 for narrower floats. The sum
        is elementwise, so a large ``x`` goes in slabs along another dim,
        each moved to the wire dtype in one copy (the same sums). Over a
        tuple of axes, one reduce-scatter an axis, the first axis first:
        its block is the outer one, so the rank ends with block
        ``coord(axis)`` of the row-major order; the partial stays in the
        wire dtype between them."""
        moved, dtype = self._moved(axis), x.dtype
        for i, a in enumerate(moved):
            x = self._reduce_scatter(x, a, dim, dtype if i == len(moved) - 1
                                     else None)
        return x

    def _reduce_scatter(self, x, axis: str, dim: int, dtype):
        """One axis's reduce-scatter, its block in ``dtype`` (None: the
        wire dtype, a partial another axis sums on)."""
        n = self.shape[axis]
        dim %= x.dim()
        wire = torch.float32 if x.is_floating_point() \
            and x.element_size() < 4 else x.dtype
        shape = list(x.shape)
        shape[dim] //= n
        out = torch.empty(shape, dtype=dtype or wire, device=x.device)
        others = [d for d in range(x.dim()) if d != dim]
        s = max(others, key=lambda d: x.shape[d]) if others else dim
        nbytes = x.numel() * torch.empty((), dtype=wire).element_size()
        slabs = max(1, -(-nbytes // self.SLAB_BYTES))
        k = x.shape[s] if s == dim else max(1, -(-x.shape[s] // slabs))

        def run():
            for lo in range(0, x.shape[s], k):
                piece = x.narrow(s, lo, min(k, x.shape[s] - lo))
                src = piece.movedim(dim, 0)
                buf = torch.empty(src.shape, dtype=wire, device=x.device)
                buf.copy_(src)
                part = self.transport.reduce_scatter(buf, axis)
                dst = out if s == dim else out.narrow(s, lo, piece.shape[s])
                dst.copy_(part.movedim(0, dim))
            return out
        return self._timed("reduce_scatter", axis, nbytes, run)

    # -- differentiable collectives (training) -----------------------------
    # Conjugate pairs: the backward of each is the forward of its partner,
    # so a tensor replicated over an axis keeps a gradient that is whole
    # and equal on every rank of the axis. Each backward issues its
    # collective from the Function itself, in the autograd engine's order,
    # which every rank shares (same graph). ``axis`` is one name or a
    # tuple of names (the data-parallel axes ("pod", "data")).

    def copy_to(self, x, axis):
        """Identity forward; the gradient all-reduced over ``axis`` (the
        input of a column-parallel block or of a vocabulary block)."""
        if not self._moved(axis):
            return x
        return _CopyToAxis.apply(x, self, axis)

    def reduce_from(self, x, axis):
        """All-reduce forward; the gradient passed through (a row-parallel
        partial, an embedding lookup's rows)."""
        if not self._moved(axis):
            return x
        return _ReduceFromAxis.apply(x, self, axis)

    def gather_from(self, x, axis, dim: int = -1):
        """All-gather forward; backward keeps this rank's block of the
        gradient (a column block made whole)."""
        if not self._moved(axis):
            return x
        return _GatherFromAxis.apply(x, self, axis, dim)

    def scatter_to(self, x, axis, dim: int = -1):
        """This rank's block forward; the gradient all-gathered (a
        replicated tensor cut to the rank's block)."""
        if not self._moved(axis):
            return x
        return _ScatterToAxis.apply(x, self, axis, dim)

    def fsdp_gather(self, x, axis, dim: int):
        """FSDP's weight gather: all-gather forward; backward
        reduce-scatters the gradient, the sum over ``axis``'s ranks of
        this rank's block."""
        if not self._moved(axis):
            return x
        return _FsdpGather.apply(x, self, axis, dim)

    def block_of(self, x, axis, dim: int = -1):
        """This rank's block of ``x`` along ``dim`` (no collective)."""
        n = axis_size(self, axis)
        if n == 1:
            return x
        w = x.shape[dim] // n
        return x.narrow(dim, self.coord(axis) * w, w)

    def all_gather(self, x: torch.Tensor, axis, dim: int = -1
                   ) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in
        coordinate order (exact: nothing is added). Over a tuple of axes,
        one gather an axis, the last axis first, so the first axis ends up
        major: the row-major order of ``coord(axis)``."""
        moved = self._moved(axis)
        if not moved:
            return x
        part = x.to(torch.int32) if x.dtype == torch.bool else x
        for a in reversed(moved):
            part = part.contiguous()
            n = self.shape[a]
            parts = self._timed("all_gather", a,
                                n * part.numel() * part.element_size(),
                                lambda: self.transport.gather(part, a))
            part = torch.cat(parts, dim=dim)
        return part.to(x.dtype)

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

    def broadcast(self, x: torch.Tensor, axis, src: int = 0
                  ) -> torch.Tensor:
        """The ``x`` of the rank at index ``src`` along ``axis`` (over a
        tuple: the row-major index of :meth:`coord`), on every rank of
        the axes (exact: the others send zeros)."""
        if not self._moved(axis):
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


class MetaTransport:
    """A dry mesh's transfers (:meth:`ProcessMesh.dry`): no peer, no
    process group. Each returns meta tensors of the collective's output
    shape -- what the card's NCCL run would allocate -- and refuses a
    tensor that is not on the meta device, whose values it could not
    give."""

    def __init__(self, mesh: ProcessMesh):
        self.mesh = mesh

    @staticmethod
    def _meta(x: torch.Tensor) -> torch.Tensor:
        if not x.is_meta:
            raise ValueError(f"a dry mesh moves meta tensors only, got one "
                             f"on {x.device}")
        return x

    def sum(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        return self._meta(buf)

    def max(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        return self._meta(buf)

    def gather(self, part: torch.Tensor, axis: str) -> list:
        self._meta(part)
        return [torch.empty_like(part) for _ in range(self.mesh.shape[axis])]

    def shift(self, part: torch.Tensor, axis: str, shift: int
              ) -> torch.Tensor:
        return torch.empty_like(self._meta(part))

    def reduce_scatter(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        w = self._meta(buf).shape[0] // self.mesh.shape[axis]
        return buf.new_empty((w,) + tuple(buf.shape[1:]))


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

