"""COCO mask operations: a ctypes bridge to the port's C++ rasterizer.

Counterpart of ``pemp_tpu/data/mask_ops.py``, in place of the
pycocotools ``_mask`` extension (reference data_kits/coco.py:261 calls
``coco.annToMask``). The library is the port's own copy of the source,
``data/native/coco_mask.cpp``, compiled with ``g++`` at first use into
``build/pemp_tpu_torch/libcoco_mask_<hash of source and flags>.so`` at
the root of the checkout (a temporary file, then an atomic rename; a
lock for the loader's threads). A failed build raises: the numpy
versions below (the plain versions, same semantics, slower) run only
where a caller asks for them with ``native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "coco_mask.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pemp_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()    # the loader's threads race the first build
# calls that went through the C++ library (decode_rle, polys_to_mask)
native_calls = 0


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcoco_mask_{h.hexdigest()[:16]}.so"


def _build_lib() -> ctypes.CDLL:
    so = lib_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a temporary path, then rename: an interrupted build
        # never leaves a half-written library under the final name
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.rle_from_string.restype = ctypes.c_int
    lib.rle_from_string.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.polys_to_mask.restype = ctypes.c_int
    lib.polys_to_mask.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def get_lib() -> ctypes.CDLL:
    """The C++ library, built at the first call; raises when ``g++``
    fails (and again at the next call: nothing falls back)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _build_lib()
    return _LIB


def loaded() -> bool:
    """Whether the C++ library has been built and loaded."""
    return _LIB is not None


# ---------------------------------------------------------------------------
# numpy versions (the plain versions of the C++ functions)
# ---------------------------------------------------------------------------

def rle_from_string_np(s: bytes) -> np.ndarray:
    """COCO's compressed count string -> uint32 run lengths."""
    counts: List[int] = []
    p, n = 0, len(s)
    while p < n:
        x, k, more = 0, 0, 1
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = c & 0x20
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def rle_decode_np(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Alternating 0- and 1-runs, column-major -> row-major uint8 [h, w]."""
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        run = int(run)
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val = 1 - val
    return flat.reshape(w, h).T


def rle_from_poly_np(xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """The official polygon rasterization (pycocotools ``rleFrPoly``):
    vertices scaled 5x and rounded, a dense integer walk along every edge
    in its original direction, the column transitions brought back to
    pixel-grid crossings, then sort and parity -> alternating
    column-major run lengths."""
    k = len(xy) // 2
    scale = 5.0
    x = [int(scale * xy[2 * j] + 0.5) for j in range(k)]
    y = [int(scale * xy[2 * j + 1] + 0.5) for j in range(k)]
    x.append(x[0])
    y.append(y[0])

    u: List[int] = []
    v: List[int] = []
    for j in range(k):
        xs, xe, ys, ye = x[j], x[j + 1], y[j], y[j + 1]
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            for d in range(dx + 1):
                t = dx - d if flip else d
                u.append(t + xs)
                v.append(int(ys + s * t + 0.5))
        else:
            s = (xe - xs) / dy if dy else 0.0
            for d in range(dy + 1):
                t = dy - d if flip else d
                v.append(t + ys)
                u.append(int(xs + s * t + 0.5))

    pos: List[int] = []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if math.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0.0), float(h))
        pos.append(int(xd) * h + int(math.ceil(yd)))

    a = sorted(pos)
    a.append(h * w)
    deltas = []
    p = 0
    for t in a:
        deltas.append(t - p)
        p = t
    b = [deltas[0]]
    j = 1
    while j < len(deltas):
        if deltas[j] > 0:
            b.append(deltas[j])
            j += 1
        else:
            j += 1
            if j < len(deltas):
                b[-1] += deltas[j]
                j += 1
    return np.asarray(b, np.uint32)


def polys_to_mask_np(polys: List, h: int, w: int) -> np.ndarray:
    """The union of each ring's rasterization (rings of fewer than three
    vertices are left out, as in ``polys_to_mask``)."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        xy = np.asarray(poly, np.float64).ravel()
        if len(xy) >= 6:
            mask |= rle_decode_np(rle_from_poly_np(xy, h, w), h, w)
    return mask


# ---------------------------------------------------------------------------
# public functions: the C++ library, or the numpy versions when asked
# ---------------------------------------------------------------------------

def decode_rle(rle: dict, native: bool = True) -> np.ndarray:
    """A COCO RLE ``{'size': [h, w], 'counts': str | list}`` -> uint8
    [h, w]."""
    global native_calls
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if not native:
        if isinstance(counts, bytes):
            counts = rle_from_string_np(counts)
        return rle_decode_np(np.asarray(counts, np.uint32), h, w)
    lib = get_lib()
    if isinstance(counts, bytes):
        buf = (ctypes.c_uint32 * (len(counts) + 1))()
        n = lib.rle_from_string(counts, buf, len(counts) + 1)
        counts = np.ctypeslib.as_array(buf)[:n].copy()
    counts = np.ascontiguousarray(counts, np.uint32)
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                   len(counts), h, w,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    native_calls += 1
    return out


def polys_to_mask(polys: List, h: int, w: int,
                  native: bool = True) -> np.ndarray:
    """A segmentation (a list of flat ``[x0, y0, x1, y1, ...]`` rings) ->
    the union of its rings as uint8 [h, w]."""
    global native_calls
    polys = [np.asarray(p, np.float64).ravel() for p in polys]
    polys = [p for p in polys if len(p) >= 6]
    if not native:
        return polys_to_mask_np(polys, h, w)
    out = np.zeros((h, w), np.uint8)
    if not polys:
        return out
    lib = get_lib()
    xy = np.ascontiguousarray(np.concatenate(polys))
    sizes = np.asarray([len(p) for p in polys], np.int32)
    ret = lib.polys_to_mask(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(polys), h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if ret != 0:
        raise RuntimeError(f"polys_to_mask failed ({ret}) on {len(polys)} "
                           f"rings at {h}x{w}")
    native_calls += 1
    return out


def ann_to_mask(ann: dict, h: int, w: int, native: bool = True) -> np.ndarray:
    """pycocotools' ``annToMask``: an annotation's segmentation -> uint8
    [h, w] (polygons or an uncompressed or compressed RLE)."""
    seg = ann.get("segmentation")
    if isinstance(seg, list):
        return polys_to_mask(seg, h, w, native)
    if isinstance(seg, dict):
        return decode_rle(seg, native)
    return np.zeros((h, w), np.uint8)
