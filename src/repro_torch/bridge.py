"""Parameter trees between numpy and the port's tensors.

The reference initializes weights with ``jax.random``, which torch cannot
reproduce. To run both packages on the same weights, the reference's tree
is handed over as numpy (``jax.tree.map(np.asarray, params)``: nested
dicts and tuples of arrays) and converted here; the structure -- and so the
path names and the checkpoint leaf order -- is kept as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import map_with_path


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":  # ml_dtypes fp8 (quantized packs)
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts / tuples / lists of numpy arrays -> the same structure
    of tensors on ``device``."""
    return map_with_path(lambda _, a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors -> host numpy arrays.
    bfloat16 and float8_e4m3fn leaves become float32 (numpy has neither;
    the widening is exact)."""
    def one(_, t):
        t = t.detach().cpu()
        wide = t.dtype in (torch.bfloat16, torch.float8_e4m3fn)
        return (t.float() if wide else t).numpy()
    return map_with_path(one, tree)
