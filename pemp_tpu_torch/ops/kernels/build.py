"""Build and load the port's CUDA kernels.

Each library is a ``csrc/<source>.cu`` compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The mpm sources hold an instance of each kernel per p and
feature type, so each is compiled twice, once per feature type
(``-DPEMP_FEATURE_BF16=1`` or ``0``: ``mpm_bf16``, ``mpm_f32``,
``mpm_bwd_bf16``, ``mpm_bwd_f32``), and a library takes only its own
type. The library lands in ``build/pemp_tpu_torch/`` at the root of the
checkout, named after a hash of its source and flags, so it is rebuilt
only when the source changes. The libraries build in parallel, one
``nvcc`` each. Nothing here runs at import time: the first kernel call
builds.
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
# library -> (source, extra nvcc flags)
LIBRARIES = {
    **{f"{src}_{tag}": (src, (f"-DPEMP_FEATURE_BF16={flag}",))
       for src in ("mpm", "mpm_bwd")
       for tag, flag in (("bf16", 1), ("f32", 0))},
    "minplus": ("minplus", ()),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return nvcc


def _lib_path(name: str) -> Path:
    src, flags = LIBRARIES[name]
    h = hashlib.sha256((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, dict]:
    """Compile every named library that is missing, all ``nvcc``
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
        src, flags = LIBRARIES[name]
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
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
    """The loaded library ``name`` (``LIBRARIES``), built on first use."""
    if name not in _loaded:
        path = build([name])[name]["path"]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
