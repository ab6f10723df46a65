"""Wrapper of the min-plus CUDA kernel (``csrc/minplus.cu``).

Replaces the TPU kernel ``_kernel`` of ``pemp_tpu/ops/pallas/minplus.py``
(``minplus_matmul``, the two phases of ``edt2_pallas``, K5):

    out[z, m, n] = min_k a[z, m, k] + b[z, k, n]

``minplus(a, b)`` takes ``a`` [M, K] or [Z, M, K] and ``b`` [K, N] or
[Z, K, N]; a 2-D operand is shared by every ``z`` (batch stride 0 in the
kernel). For tensors on the CPU it runs ``plain_minplus``; for CUDA
tensors it launches the kernel or raises. ``launches["minplus"]`` counts
each launch on CUDA, at the launch.

The inputs of the EDT are integer-valued float32 below 2^24 or the 1e12
sentinel, so every ``a + b`` rounds the same way in any order and ``min``
is exact: the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from pemp_tpu_torch.ops.kernels.build import load_library

TILE = 64                   # csrc/minplus.cu kTm (output rows per block)
PLAIN_CHUNK = 1 << 24       # elements of the plain version's temporary

launches: Dict[str, int] = {"minplus": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_bound = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("minplus")
        lib.pemp_minplus.argtypes = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _P]
        lib.pemp_minplus.restype = _I
        lib.pemp_minplus_error_string.argtypes = [_I]
        lib.pemp_minplus_error_string.restype = ctypes.c_char_p
        lib.pemp_minplus_tile.restype = _I
        if lib.pemp_minplus_tile() != TILE:
            raise RuntimeError(f"pemp_minplus_tile() = "
                               f"{lib.pemp_minplus_tile()} != {TILE}: the "
                               "wrapper and csrc/minplus.cu disagree")
        _bound = lib
    return _bound


def _shapes(a: torch.Tensor, b: torch.Tensor):
    """(Z, M, K, N) of a min-plus product, checking ranks and sizes."""
    if a.ndim not in (2, 3) or b.ndim not in (2, 3):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "[M, K] / [Z, M, K] and [K, N] / [Z, K, N]")
    za = a.shape[0] if a.ndim == 3 else 1
    zb = b.shape[0] if b.ndim == 3 else 1
    if a.ndim == 3 and b.ndim == 3 and za != zb:
        raise ValueError(f"batch of a ({za}) != batch of b ({zb})")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)}: "
                         "inner sizes differ")
    if min(za, zb, m, k, n) < 1:
        raise ValueError("empty min-plus operand")
    return max(za, zb), m, k, n


def _minplus_launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    z, m, k, n = _shapes(a, b)
    for name, x in (("a", a), ("b", b)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} on {x.device}, expected cuda")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} dtype {x.dtype}: the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if z > 65535:
        raise ValueError(f"batch {z} exceeds the grid's z limit 65535")
    out = torch.empty((z, m, n), dtype=torch.float32, device=a.device)
    sa = m * k if a.ndim == 3 else 0
    sb = k * n if b.ndim == 3 else 0
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.pemp_minplus(a.data_ptr(), b.data_ptr(), out.data_ptr(), z, m, k,
                          n, sa, sb, stream)
    if rc != 0:
        raise RuntimeError(f"minplus: CUDA error {rc} "
                           f"({lib.pemp_minplus_error_string(rc).decode()})")
    launches["minplus"] += 1
    return out if a.ndim == 3 or b.ndim == 3 else out[0]


def plain_minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a[:, :, None] + b[None]).amin(1)`` per batch item, over row chunks
    so the [rows, K, N] temporary stays under PLAIN_CHUNK elements."""
    z, m, k, n = _shapes(a, b)
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if b.ndim == 3 else b[None]
    out = torch.empty((z, m, n), dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    rows = max(1, PLAIN_CHUNK // (k * n))
    for i in range(z):
        ai = a3[i if a3.shape[0] > 1 else 0]
        bi = b3[i if b3.shape[0] > 1 else 0]
        for s in range(0, m, rows):
            out[i, s:s + rows] = (ai[s:s + rows, :, None] + bi[None]).amin(1)
    return out if a.ndim == 3 or b.ndim == 3 else out[0]


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-plus product ``min_k a[.., m, k] + b[.., k, n]``: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_minplus(a, b)
    return _minplus_launch(a, b)
