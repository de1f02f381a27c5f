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
    (``stats``).

Ranks are laid out row-major over the axes (rank ``r`` of a ``(data,
model)`` mesh sits at ``(r // model, r % model)``), the order
``jax.make_mesh`` gives its devices.

The collectives work on CPU and CUDA tensors over gloo (several ranks
sharing one card: gloo takes CUDA tensors for all_reduce, broadcast and
all_gather, as ``chip_smoke.py`` lm_tp's probe records) and NCCL (one
card a rank) alike. Sums of floating tensors narrower than fp32 travel as
fp32; a gather moves its tensors as they are. Which backend a run uses is
the caller's choice, made when it initialises the process group
(:func:`init_distributed`).
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
        fn()
        st["s"] += time.perf_counter() - t0
        st["calls"] += 1
        st["bytes"] += nbytes

    def _reduce(self, op: str, axis: str, buf: torch.Tensor):
        """``all_reduce`` of ``buf`` in place over ``axis``'s group."""
        import torch.distributed as dist
        self._timed(op, axis, buf.numel() * buf.element_size(),
                    lambda: dist.all_reduce(buf, group=self.groups[axis]))

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        """The tensor a sum sends: fp32 for narrower floats, int32 for
        bool, contiguous."""
        if x.is_floating_point() and x.element_size() < 4:
            return x.float().contiguous()
        if x.dtype == torch.bool:
            return x.to(torch.int32).contiguous()
        return x.contiguous()

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks along ``axis`` (a new tensor in
        ``x``'s dtype; ``x`` itself when the axis has one rank)."""
        if self.shape.get(axis, 1) == 1:
            return x
        buf = self._wire(x).clone()
        self._reduce("all_reduce", axis, buf)
        return buf.to(x.dtype)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = -1
                   ) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in
        coordinate order (exact: nothing is added)."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return x
        import torch.distributed as dist
        part = x.to(torch.int32) if x.dtype == torch.bool else x
        part = part.contiguous()
        parts = [torch.empty_like(part) for _ in range(n)]
        self._timed("all_gather", axis,
                    n * part.numel() * part.element_size(),
                    lambda: dist.all_gather(parts, part,
                                            group=self.groups[axis]))
        return torch.cat(parts, dim=dim).to(x.dtype)

    def broadcast(self, x: torch.Tensor, axis: str, src: int = 0
                  ) -> torch.Tensor:
        """The ``x`` of the rank at index ``src`` along ``axis``, on every
        rank of the axis group (exact: the others send zeros)."""
        if self.shape.get(axis, 1) == 1:
            return x
        buf = self._wire(x).clone()
        if self.coord(axis) != int(src):
            buf.zero_()
        self._reduce("broadcast", axis, buf)
        return buf.to(x.dtype)


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

