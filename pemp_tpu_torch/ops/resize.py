"""Exact PyTorch-reference image resizing on channels-last tensors.

Counterpart of ``pemp_tpu/ops/resize.py``. The reference upsamples logits
with ``F.interpolate(mode='bilinear', align_corners=True)`` and
downsamples masks with ``mode='nearest'``; both are written here on the
channels-last layout ``[..., H, W, C]`` that the public functions of the
port keep:

- bilinear align_corners=True: ``src = dst * (in - 1) / (out - 1)``
  (src = 0 when out == 1), as two dense matmuls with [out, in]
  interpolation matrices (2 nonzeros per row);
- nearest: ``src = floor(dst * in / out)``.

The matrices and index vectors are made on the host and copied to the
device once per (sizes, device, dtype): a copy from pageable host memory
waits for the stream, and a CUDA graph cannot capture it
(``parallel/step.py``'s fused train step). The cache keeps the
``CACHE_SIZE`` most recent; one that a captured graph reads is never
dropped. Under a trace (``torch.export``, ``torch.compile``) the
constant is made afresh and never cached: the tensor made there is a
fake one, and an eager call that read it back would compute on it.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from pemp_tpu_torch.ops.dtypes import f32up

CACHE_SIZE = 256
_recent: Dict[tuple, torch.Tensor] = {}     # least recently used first
_held: Dict[tuple, torch.Tensor] = {}       # read by a captured CUDA graph


def _nearest_coords(in_size: int, out_size: int) -> np.ndarray:
    src = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] interpolation matrix (2 nonzeros per row)."""
    if out_size == 1:
        src = np.zeros((1,), np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    mat[rows, i0] += 1.0 - w1
    mat[rows, i1] += w1
    return mat


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def device_constant(key: tuple, device: torch.device,
                    make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The cached device tensor ``key`` names, made by ``make`` on a miss
    (the resize constants here, ``ops/s2b.py``'s phase index).
    A miss under CUDA-graph capture raises: the host copy cannot be
    captured, so the sizes must have run once before the capture. Under
    a trace ``make()`` alone, so that the trace holds the constant and
    the cache keeps no fake tensor."""
    if torch.compiler.is_compiling():
        return make()
    t = _held.get(key)
    if t is not None:
        return t
    t = _recent.pop(key, None)
    if t is None:
        if _capturing(device):
            raise RuntimeError(f"device constant {key} was not made before "
                               "CUDA-graph capture (run the step eagerly "
                               "first)")
        t = make()
    if _capturing(device):
        _held[key] = t
        return t
    _recent[key] = t
    while len(_recent) > CACHE_SIZE:
        del _recent[next(iter(_recent))]
    return t


def interp_matrix(in_size: int, out_size: int, device,
                  dtype: torch.dtype) -> torch.Tensor:
    """``_interp_matrix`` as a cached ``dtype`` tensor on ``device``."""
    device = torch.device(device)
    return device_constant(("bilinear", in_size, out_size, device, dtype),
                           device, lambda: torch.from_numpy(
                               _interp_matrix(in_size, out_size)).to(
                                   device, dtype))


def nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    """``_nearest_coords`` as a cached int64 tensor on ``device``."""
    device = torch.device(device)
    return device_constant(("nearest", in_size, out_size, device), device,
                           lambda: torch.from_numpy(
                               _nearest_coords(in_size, out_size)).to(device))


def resize_bilinear_align_corners(x: torch.Tensor, out_hw,
                                  spatial_axes=(-3, -2)) -> torch.Tensor:
    """Bilinear resize with torch ``align_corners=True`` semantics as two
    matmuls (``W_h @ x @ W_w^T``), computed in at least float32 and
    returned in ``x``'s dtype.

    x: [..., H, W, C] (or any layout -- give ``spatial_axes``)
    out_hw: (out_h, out_w)
    """
    ah, aw = [a % x.ndim for a in spatial_axes]
    in_h, in_w = x.shape[ah], x.shape[aw]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (in_h, in_w) == (out_h, out_w):
        return x
    dtype = x.dtype
    xf = f32up(x)
    if in_h != out_h:
        wh = interp_matrix(in_h, out_h, xf.device, xf.dtype)
        xf = torch.movedim(torch.tensordot(
            wh, torch.movedim(xf, ah, 0), dims=([1], [0])), 0, ah)
    if in_w != out_w:
        ww = interp_matrix(in_w, out_w, xf.device, xf.dtype)
        xf = torch.movedim(torch.tensordot(
            ww, torch.movedim(xf, aw, 0), dims=([1], [0])), 0, aw)
    return xf.to(dtype)


def resize_nearest(x: torch.Tensor, out_hw,
                   spatial_axes=(-3, -2)) -> torch.Tensor:
    """Nearest-neighbor resize with torch ``mode='nearest'`` semantics."""
    ah, aw = [a % x.ndim for a in spatial_axes]
    in_h, in_w = x.shape[ah], x.shape[aw]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (in_h, in_w) == (out_h, out_w):
        return x
    ih = nearest_index(in_h, out_h, x.device)
    iw = nearest_index(in_w, out_w, x.device)
    return x.index_select(ah, ih).index_select(aw, iw)


def resize_bilinear_align_corners_np(x: np.ndarray, out_hw,
                                     spatial_axes=(-3, -2)) -> np.ndarray:
    """Numpy twin of :func:`resize_bilinear_align_corners` (gather form),
    for host-side resizing of single episodes."""
    ah, aw = [a % x.ndim for a in spatial_axes]
    in_h, in_w = x.shape[ah], x.shape[aw]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (in_h, in_w) == (out_h, out_w):
        return x
    xf = x.astype(np.float32)

    def coords(in_size, out_size):
        if out_size == 1:
            src = np.zeros((1,), np.float64)
        else:
            src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
        i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        w1 = (src - i0).astype(np.float32)
        return i0, i1, 1.0 - w1, w1

    i0, i1, w0, w1 = coords(in_h, out_h)
    shape = [1] * x.ndim
    shape[ah] = out_h
    xf = (np.take(xf, i0, axis=ah) * w0.reshape(shape)
          + np.take(xf, i1, axis=ah) * w1.reshape(shape))
    j0, j1, v0, v1 = coords(in_w, out_w)
    shape = [1] * x.ndim
    shape[aw] = out_w
    xf = (np.take(xf, j0, axis=aw) * v0.reshape(shape)
          + np.take(xf, j1, axis=aw) * v1.reshape(shape))
    return xf
