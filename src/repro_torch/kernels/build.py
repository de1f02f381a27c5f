"""Build and load the port's hand-written CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``.
Libraries land in ``<repo>/build/repro_torch/`` (``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time: the first kernel launch builds what it needs, and
:func:`build_all` builds every library in parallel (one ``nvcc`` a source).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_CSRC)))

#: library name -> its CUDA source under csrc/
SOURCES = {"plan_dds": "plan_dds.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"path", "seconds", "log"} of builds made in this process
BUILD_LOG: Dict[str, dict] = {}


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_BUILD_DIR",
                          os.path.join(_REPO, "build", "repro_torch"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> str:
    src = os.path.join(_CSRC, SOURCES[name])
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None,
              force: bool = False) -> Dict[str, dict]:
    """Compile the named libraries (all by default), every ``nvcc`` started
    at once. Returns name -> {"path", "seconds", "log"}; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out) and not force:
            BUILD_LOG.setdefault(name, {"path": out, "seconds": 0.0,
                                        "log": "cached"})
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"path": out,
                           "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib
