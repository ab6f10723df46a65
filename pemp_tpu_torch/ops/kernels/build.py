"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/pemp_tpu_torch/`` at the root of the checkout,
named after a hash of its source and flags, so it is rebuilt only when
the source changes. Several sources build in parallel, one ``nvcc``
each. Nothing here runs at import time: the first kernel call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pemp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("mpm", "mpm_bwd", "minplus")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together; returns each library's path, build
    seconds and compiler log (``-Xptxas -v``: registers, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            info[name] = {"path": path, "seconds": 0.0, "log": "",
                          "cached": True}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, path)     # atomic: a reader never sees half a file
        info[name] = {"path": path, "seconds": seconds, "log": log,
                      "cached": False}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return info


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        path = build([name])[name]["path"]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
