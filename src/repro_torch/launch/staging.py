"""A transport for ranks that share one card or one host: collectives
through buffers every rank of an axis group maps, in place of the process
group's.

A :class:`~repro_torch.launch.mesh.ProcessMesh` carries its collectives
over ``mesh.transport`` -- the process group's (``GroupTransport``: gloo
or NCCL) unless something installs another. Ranks that share one card
and talk through gloo send every tensor through the host and TCP (~0.35
GB/s a 92 MB all_reduce, ``chip_smoke.py`` lm_tp's probe), which makes a
data-parallel training step of a full-width model take tens of seconds.
:func:`install` gives such a mesh a :class:`SharedStaging` instead: the
smoke run's mesh training phase installs it on the card ('cuda'), the CPU
tests on files ('host'). Production meshes -- one card a rank over NCCL --
keep the process group's transport.
"""
from __future__ import annotations

import os
from typing import Dict

import torch


class SharedStaging:
    """The transport: a rank writes its part into its own buffer, the
    group meets at a barrier (the process group's, one small collective),
    then each rank reads its peers' buffers -- device to device on one card
    ('cuda', CUDA IPC), or through the page cache on one host ('host',
    files in a directory). Each axis has two buffers a rank, used in turn,
    so one barrier a step suffices: a rank passing the barrier of step k
    knows every peer has finished reading the buffers of step k - 1 (each
    synchronises its device before it arrives). A collective larger than a
    buffer goes in chunks. Sums run in group-rank order, the same on every
    rank, so every rank holds the same bits. Tensors of the other kind (a
    CPU tensor on 'cuda') go through ``fallback``, the transport it
    replaced."""

    CHUNK_BYTES = 128 << 20

    def __init__(self, mesh, kind: str, directory: str = None,
                 chunk_bytes: int = None):
        if kind not in ("cuda", "host"):
            raise ValueError(f"staging kind {kind!r}: 'cuda' or 'host'")
        if kind == "host" and directory is None:
            raise ValueError("host staging maps files: pass a directory")
        self.mesh, self.kind, self.dir = mesh, kind, directory
        self.fallback = mesh.transport
        self.chunk = int(chunk_bytes or self.CHUNK_BYTES) // 16 * 16
        self._bufs: Dict[str, list] = {}
        self._turn: Dict[str, int] = {}

    def _takes(self, x: torch.Tensor) -> bool:
        return x.is_cuda if self.kind == "cuda" else x.device.type == "cpu"

    def _open(self, axis: str, parity: int):
        """(this rank's buffer, every group rank's buffer in group order),
        uint8, ``chunk`` bytes; collective over the axis group."""
        import torch.distributed as dist
        group, n = self.mesh.groups[axis], self.mesh.shape[axis]
        me = self.mesh.coord(axis)
        if self.kind == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor
            mine = torch.empty(self.chunk, dtype=torch.uint8, device="cuda")
            rebuild, args = reduce_tensor(mine)
            handles = [None] * n
            dist.all_gather_object(handles, args, group=group)
            peers = [mine if i == me else rebuild(*a)
                     for i, a in enumerate(handles)]
        else:
            path = os.path.join(self.dir, f"stage_{self.mesh.rank}_{axis}_"
                                          f"{parity}")
            with open(path, "wb") as f:
                f.truncate(self.chunk)
            mine = torch.from_file(path, shared=True, size=self.chunk,
                                   dtype=torch.uint8)
            paths = [None] * n
            dist.all_gather_object(paths, path, group=group)
            peers = [mine if i == me else torch.from_file(
                p, shared=True, size=self.chunk, dtype=torch.uint8)
                for i, p in enumerate(paths)]
        return mine, peers

    def _step(self, axis: str):
        """The next buffer pair of ``axis`` (opened on first use)."""
        if axis not in self._bufs:
            self._bufs[axis] = [self._open(axis, p) for p in (0, 1)]
        p = self._turn.get(axis, 0)
        self._turn[axis] = 1 - p
        return self._bufs[axis][p]

    def _meet(self, axis: str):
        import torch.distributed as dist
        if self.kind == "cuda":
            torch.cuda.synchronize()
        dist.barrier(group=self.mesh.groups[axis])

    def _exchange(self, part: torch.Tensor, axis: str, sources) -> list:
        """The ``part`` (same shape and dtype on every rank) of each group
        rank in ``sources``: every rank writes its own, reads theirs."""
        flat = part.reshape(-1).view(torch.uint8)
        outs = [torch.empty_like(part) for _ in sources]
        flats = [o.reshape(-1).view(torch.uint8) for o in outs]
        for lo in range(0, flat.numel(), self.chunk):
            k = min(self.chunk, flat.numel() - lo)
            mine, peers = self._step(axis)
            mine[:k].copy_(flat[lo:lo + k])
            self._meet(axis)
            for o, src in zip(flats, sources):
                o[lo:lo + k].copy_(peers[src][:k])
        return outs

    def gather(self, part: torch.Tensor, axis: str) -> list:
        """Every group rank's ``part`` (same shape and dtype), in group
        order."""
        if not self._takes(part):
            return self.fallback.gather(part, axis)
        return self._exchange(part, axis, range(self.mesh.shape[axis]))

    def shift(self, part: torch.Tensor, axis: str, shift: int
              ) -> torch.Tensor:
        """The ``part`` of the group rank ``shift`` places before this one
        (mod n), read from that one peer's buffer: the ring shift costs
        its own bytes, not a gather's n times as many."""
        if not self._takes(part):
            return self.fallback.shift(part, axis, shift)
        src = (self.mesh.coord(axis) - shift) % self.mesh.shape[axis]
        return self._exchange(part, axis, [src])[0]

    @staticmethod
    def _combine(out, parts, op):
        out.copy_(parts[0])
        for p in parts[1:]:
            if op == "sum":
                out.add_(p)
            else:
                torch.maximum(out, p, out=out)

    def _reduce(self, buf: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        flat = buf.reshape(-1)
        out = torch.empty_like(flat)
        per = self.chunk // flat.element_size()
        for lo in range(0, flat.numel(), per):
            k = min(per, flat.numel() - lo)
            mine, peers = self._step(axis)
            mine.view(flat.dtype)[:k].copy_(flat[lo:lo + k])
            self._meet(axis)
            self._combine(out[lo:lo + k],
                          [p.view(flat.dtype)[:k] for p in peers], op)
        return out.view(buf.shape)

    def sum(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise sum of ``buf`` over the group (the mesh sends
        fp32 for narrower floats)."""
        if not self._takes(buf):
            return self.fallback.sum(buf, axis)
        return self._reduce(buf, axis, "sum")

    def max(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        if not self._takes(buf):
            return self.fallback.max(buf, axis)
        return self._reduce(buf, axis, "max")

    def reduce_scatter(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's block along dim 0 of the sum of ``buf`` over the
        group."""
        if not self._takes(buf):
            return self.fallback.reduce_scatter(buf, axis)
        n, me = self.mesh.shape[axis], self.mesh.coord(axis)
        blocks = buf.reshape(n, -1)
        width = blocks.shape[1]
        out = torch.empty(width, dtype=buf.dtype, device=buf.device)
        per = self.chunk // (n * buf.element_size())
        for lo in range(0, width, per):
            k = min(per, width - lo)
            mine, peers = self._step(axis)
            mine.view(buf.dtype)[:n * k].view(n, k).copy_(
                blocks[:, lo:lo + k])
            self._meet(axis)
            self._combine(out[lo:lo + k],
                          [p.view(buf.dtype)[me * k:(me + 1) * k]
                           for p in peers], "sum")
        return out.view((buf.shape[0] // n,) + tuple(buf.shape[1:]))


def install(mesh, kind: str, directory: str = None,
            chunk_bytes: int = None) -> SharedStaging:
    """Carry ``mesh``'s collectives on ``kind`` tensors ('cuda': every
    rank on one card; 'host': every rank on one host, buffers mapped from
    files in ``directory``) through a :class:`SharedStaging`; other
    tensors keep the mesh's transport. Collective: every rank of the mesh
    calls it. A mesh that has one keeps it."""
    if not isinstance(mesh.transport, SharedStaging):
        mesh.transport = SharedStaging(mesh, kind, directory, chunk_bytes)
    return mesh.transport
