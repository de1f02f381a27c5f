"""Backend dispatch for the row-grouped plan layout.

Counterpart of the plan part of ``repro/kernels/ops.py``. ``'plan'`` is the
plain tensor composition (:func:`exec_plan.plan_matmul`), ``'plan_pallas'``
the plan's schedule driving kernel K1 (:func:`exec_plan.plan_matmul_pallas`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import exec_plan as xp


def default_plan_backend(x: torch.Tensor) -> str:
    """Kernel K1 for CUDA tensors, the plain composition for CPU tensors
    (as the reference picks its kernel on a TPU and XLA elsewhere)."""
    return "plan_pallas" if x.device.type == "cuda" else "plan"


def plan_dispatch(x, data_rp, plan, backend: str | None = None):
    """Plan-layout matmul behind a backend switch; both backends take the
    same row-grouped (V, P, bn, bk) values."""
    backend = backend or default_plan_backend(x)
    if backend == "plan_pallas":
        return xp.plan_matmul_pallas(x, data_rp, plan)
    if backend == "plan":
        return xp.plan_matmul(x, data_rp, plan)
    raise ValueError(f"unknown plan backend {backend}")
