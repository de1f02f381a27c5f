"""Atomic checkpoint store, on-disk compatible with ``repro/checkpoint/store.py``.

Layout: ``<dir>/step_<N>/`` holding ``arrays.npz`` (leaves ``a0``, ``a1``,
... as host arrays) and ``meta.json``. Writes go to ``step_<N>.tmp`` and are
renamed into place, so a crashed writer never corrupts the latest step.
With ``blocking=False`` the device-to-host copy happens in the call and the
serialization on a background thread (one save in flight at a time;
:meth:`CheckpointStore.wait` drains it), as in the reference; unlike the
reference, a save blocks unless asked not to.

Leaves are numbered in the reference's flatten order -- dicts by **sorted
key**, tuples in order, ``None`` an empty subtree -- whatever the insertion
order of the tree (:mod:`repro_torch.core.tree`). bfloat16 and
float8_e4m3fn leaves are stored as their raw 2- and 1-byte values (numpy has
neither type) under the header numpy writes for the reference's ml_dtypes
arrays (``'descr': '<V2'`` and ``'<V1'``), so each member of ``arrays.npz``
is byte-identical to the reference's; int8 leaves are plain ``int8``.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_path
from repro_torch.core.tree import leaves as tree_leaves
from repro_torch.core.tree import unflatten

_NP_DTYPES = {"float32": np.float32, "float16": np.float16,
              "float64": np.float64, "int32": np.int32, "int64": np.int64,
              "int8": np.int8, "uint8": np.uint8, "bool": np.bool_}


#: dtypes numpy lacks, stored as raw bytes: name -> (torch dtype, raw view)
_RAW_DTYPES = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
               "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8)}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 / float8_e4m3fn as raw
    2- / 1-byte values) in memory of its own: a host tensor is copied, so
    a step that later writes into it (a donated update) cannot reach a
    checkpoint still being written."""
    src = t.detach()
    t = src.cpu().contiguous()
    if t.data_ptr() == src.data_ptr():
        t = t.clone()
    for dt, raw, _ in _RAW_DTYPES.values():
        if t.dtype == dt:
            return t.view(raw).numpy().view(f"V{t.element_size()}")
    return t.numpy()


def from_host(arr: np.ndarray, dtype: str, device=None) -> torch.Tensor:
    """Inverse of :func:`to_host`: ``dtype`` is the recorded dtype name."""
    # np.ascontiguousarray makes a 0-d array 1-d: reshape back
    shape = np.shape(arr)
    if dtype in _RAW_DTYPES:
        dt, _, np_raw = _RAW_DTYPES[dtype]
        if arr.dtype.itemsize != np.dtype(np_raw).itemsize:
            raise ValueError(f"{dtype} leaf stored as {arr.dtype}")
        raw = np.ascontiguousarray(arr).view(np_raw).reshape(shape)
        return torch.from_numpy(raw).view(dt).to(device)
    arr = np.asarray(arr).astype(_NP_DTYPES[dtype], copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(shape)).to(
        device)


def _npy_bytes(arr: np.ndarray) -> bytes:
    """One ``.npy`` member as ``np.save`` writes it; a raw-byte leaf gets
    the ``<V<n>`` descr numpy writes for an ml_dtypes array of that width
    (numpy itself normalises a void dtype to ``|V<n>``)."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr, allow_pickle=False)
    out = buf.getvalue()
    if arr.dtype.kind == "V" and arr.dtype.names is None:
        old = f"'descr': '|V{arr.dtype.itemsize}'".encode()
        new = f"'descr': '<V{arr.dtype.itemsize}'".encode()
        head = out[:128].replace(old, new, 1)
        out = head + out[128:]
    return out


#: bytes a member's data is written in (zipfile checksums each piece)
_WRITE_PIECE = 64 << 20


def _savez(path: str, arrays: dict):
    """``np.savez`` (uncompressed zip of ``<name>.npy`` members) with
    :func:`_npy_bytes` members, each written as its header and then its
    data straight from the array, in pieces (no copy of the whole
    member)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = np.asanyarray(arr)
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                if arr.dtype.hasobject or not arr.size or \
                        not arr.flags.c_contiguous:
                    f.write(_npy_bytes(arr))
                    continue
                f.write(_npy_header_of(arr))
                flat = arr.reshape(-1).view(np.uint8)
                for lo in range(0, flat.size, _WRITE_PIECE):
                    f.write(memoryview(flat[lo:lo + _WRITE_PIECE]))


def _npy_header_of(arr: np.ndarray) -> bytes:
    """The ``.npy`` header :func:`_npy_bytes` writes for ``arr`` (format
    1.0 as ``np.save`` picks it, a raw-byte leaf's descr ``<V<n>``)."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    out = buf.getvalue()
    if arr.dtype.kind == "V" and arr.dtype.names is None:
        out = out.replace(f"'descr': '|V{arr.dtype.itemsize}'".encode(),
                          f"'descr': '<V{arr.dtype.itemsize}'".encode(), 1)
    return out


def npz_mmap(path: str) -> dict:
    """The members of an uncompressed ``.npz`` as read-only memory maps
    (name without ``.npy`` -> array), read lazily by whoever slices them."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: member {info.filename} is "
                                 f"compressed; it cannot be mapped")
            f.seek(info.header_offset)
            head = f.read(30)
            start = (info.header_offset + 30
                     + int.from_bytes(head[26:28], "little")
                     + int.from_bytes(head[28:30], "little"))
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if not int(np.prod(shape)):
                out[name] = np.zeros(shape, dtype)
                continue
            out[name] = np.memmap(path, dtype=dtype, mode="r",
                                  offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def spec_at(specs, path):
    """The spec of the leaf at ``path`` in a spec tree, or None where the
    tree has no entry (a None subtree: replicated)."""
    node = specs
    for k in path:
        if node is None:
            return None
        node = node[k]
    return node


class CheckpointStore:
    """On a mesh (``save(mesh=, specs=)``) every rank calls each method in
    the same order: a save gathers each leaf whole, leaf by leaf in tree
    order (so a rank's memory holds one whole leaf at a time beside its
    shards), and rank 0 alone writes, in the reference's layout, with the
    mesh in ``meta``; the other ranks' :meth:`wait` waits for the step to
    appear on the shared directory. A restore is per rank: ``select`` cuts
    each memory-mapped leaf to the rank's shard under the mesh it runs on,
    so a checkpoint moves between mesh shapes and to or from one device."""

    #: how long a rank other than 0 waits for rank 0's write to land
    WAIT_S = 1800.0

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[tuple] = None
        self._saves = 0

    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: Optional[dict] = None, mesh=None, specs=None):
        """Write ``tree``'s leaves and ``extra`` meta as step ``step``: the
        host copy now, the files now or (``blocking=False``) on a background
        thread. ``mesh`` (a ``launch.mesh.ProcessMesh``) and ``specs`` (the
        leaves' spec tree; None entries replicated): ``tree`` holds this
        rank's shards, which are gathered whole, and rank 0 writes."""
        extra = dict(extra or {})
        if mesh is None:
            host = [to_host(leaf) for leaf in tree_leaves(tree)]
        else:
            host = self._gathered(tree, mesh, specs)
            self._saves += 1        # every rank counts the same saves
            extra["mesh"] = {"shape": [mesh.shape[a]
                                       for a in mesh.axis_names],
                             "axes": list(mesh.axis_names),
                             "save": self._saves}
            if mesh.rank != 0:
                self._pending = (step, self._saves)
                if blocking:
                    self.wait()
                return
        self.wait()   # one in-flight save at a time
        if blocking:  # in this thread, so a failed write raises here
            self._write(step, host, extra)
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra), daemon=True)
        self._thread.start()

    @staticmethod
    def _gathered(tree, mesh, specs):
        """Rank 0's host copies of ``tree``'s whole leaves (other ranks:
        None), each gathered from the ranks' shards in tree order."""
        from repro_torch.launch.sharding import whole_leaf
        host = []
        with torch.no_grad():
            for path, leaf in flatten_with_path(tree):
                spec = spec_at(specs, path)
                x = leaf.detach()
                if spec and any(e is not None for e in spec):
                    x = whole_leaf(x, spec, mesh)
                host.append(to_host(x) if mesh.rank == 0 else None)
                del x
        return host

    def _write(self, step: int, host, extra: dict):
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        _savez(os.path.join(tmp, "arrays.npz"),
               {f"a{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_arrays": len(host),
                       "time": time.time(), **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        """Block until the in-flight save (if any) is on disk; on a mesh
        rank other than 0, until rank 0's last save is."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._pending is not None:
            step, n = self._pending
            final = os.path.join(self.dir, f"step_{step:09d}")
            deadline = time.time() + self.WAIT_S
            while self._mesh_save(final) != n:
                if time.time() > deadline:
                    raise TimeoutError(f"save {n} of {final} did not "
                                       f"appear in {self.WAIT_S} s")
                time.sleep(0.05)
            self._pending = None

    @staticmethod
    def _mesh_save(final: str):
        """The mesh save count in ``final``'s meta (None if not there)."""
        try:
            with open(os.path.join(final, "meta.json")) as f:
                return json.load(f).get("mesh", {}).get("save")
        except (OSError, ValueError):
            return None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, select=None) -> Any:
        """Restore step ``step`` (default: the latest) into the structure of
        ``like``, whose leaves are dtype names
        (``serving.serialize.build_like``), onto ``device``. The arrays
        are memory-mapped (a compressed archive is read whole), and
        ``select(path, array) -> array`` picks the part of each leaf to
        load (e.g. a rank's shard), so only that part is read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}", "arrays.npz")
        try:
            members = npz_mmap(path)
        except ValueError:              # a compressed archive
            members = None
        if members is None:
            with np.load(path) as data:
                new = [from_host(data[f"a{i}"], dtype, device)
                       for i, dtype in enumerate(tree_leaves(like))]
            return unflatten(like, new)
        select = select or (lambda _, arr: arr)
        # np.array: the selected part read into memory of its own
        new = [from_host(np.array(select(p, members[f"a{i}"])), dtype,
                         device)
               for i, (p, dtype) in enumerate(flatten_with_path(like))]
        return unflatten(like, new)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:09d}",
                               "meta.json")) as f:
            return json.load(f)
