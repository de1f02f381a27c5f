"""Machine-readable benchmark persistence for the port.

A copy of ``repro/runtime/bench_io.py`` (framework-free): producers merge
their sections into one JSON file at the repo root, replacing their own
section wholesale and keeping the others. The port's default file is
``BENCH_torch.json``, so nothing it writes lands in the reference's
``BENCH_*.json`` files.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


def repo_root() -> str:
    """Repo root inferred from this file's location
    (src/repro_torch/runtime/..)."""
    return os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))


def default_bench_path() -> str:
    return os.path.join(repo_root(), "BENCH_torch.json")


def update_bench_json(section: str, payload: Any,
                      path: str | None = None) -> str:
    """Merge ``{section: payload}`` into the bench JSON file; returns path."""
    path = path or default_bench_path()
    data: Dict[str, Any] = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                data = loaded
        except (json.JSONDecodeError, OSError):
            data = {}
    data[section] = payload
    meta = data.setdefault("meta", {})
    meta["updated"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    meta.setdefault("schema", 1)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return path
