"""Architecture registry: ``get_config(arch, smoke=False)``.

Each arch module exposes ``full()`` (the assigned published config) and
``smoke()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen3_moe_235b_a22b",
    "deepseek_v2_lite_16b",
    "gemma3_4b",
    "internlm2_20b",
    "deepseek_7b",
    "chatglm3_6b",
    "whisper_base",
    "mamba2_780m",
    "recurrentgemma_9b",
    "pixtral_12b",
    "bert_base",            # the paper's own model (not in the 40-cell grid)
)

ASSIGNED = ARCHS[:10]


def canon(arch: str) -> str:
    return arch.replace("-", "_")


def get_config(arch: str, smoke: bool = False):
    name = canon(arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.full()
