"""Atomic checkpoint store, on-disk compatible with ``repro/checkpoint/store.py``.

Layout: ``<dir>/step_<N>/`` holding ``arrays.npz`` (leaves ``a0``, ``a1``,
... as host arrays) and ``meta.json``. Writes go to ``step_<N>.tmp`` and are
renamed into place, so a crashed writer never corrupts the latest step.

Leaves are numbered in the reference's flatten order -- dicts by **sorted
key**, tuples in order, ``None`` an empty subtree -- whatever the insertion
order of the tree (:mod:`repro_torch.core.tree`). bfloat16 leaves are stored
as the raw 2-byte values (numpy has no bfloat16), which is what numpy writes
for the reference's bfloat16 arrays too.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import leaves as tree_leaves
from repro_torch.core.tree import unflatten

_NP_DTYPES = {"float32": np.float32, "float16": np.float16,
              "float64": np.float64, "int32": np.int32, "int64": np.int64,
              "int8": np.int8, "uint8": np.uint8, "bool": np.bool_}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 as raw 2-byte values)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_host(arr: np.ndarray, dtype: str, device=None) -> torch.Tensor:
    """Inverse of :func:`to_host`: ``dtype`` is the recorded dtype name."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        raw = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16).to(device)
    arr = np.asarray(arr).astype(_NP_DTYPES[dtype], copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Write ``tree``'s leaves and ``extra`` meta as step ``step``."""
        host = [to_host(leaf) for leaf in tree_leaves(tree)]
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_arrays": len(host),
                       "time": time.time(), **(extra or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

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

    def restore(self, like: Any, step: int, device=None) -> Any:
        """Restore step ``step`` into the structure of ``like``, whose leaves
        are dtype names (``serving.serialize.build_like``), onto
        ``device``."""
        path = os.path.join(self.dir, f"step_{step:09d}", "arrays.npz")
        with np.load(path) as data:
            new = [from_host(data[f"a{i}"], dtype, device)
                   for i, dtype in enumerate(tree_leaves(like))]
        return unflatten(like, new)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:09d}",
                               "meta.json")) as f:
            return json.load(f)
