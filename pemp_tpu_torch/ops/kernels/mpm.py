"""Wrappers of the meta-prototype CUDA kernels (``csrc/mpm.cu``).

Replaces the TPU kernels of ``pemp_tpu/ops/pallas/mpm.py``:

- ``mpm_assign``  <- ``_assign_kernel`` / ``meta_prototype_assign_pallas``
  (K1): soft assignment of the support pixels to the learned centers and
  the per-episode adaptive prototypes (two launches: per-tile partial
  sums, then a fixed-order reduction over tiles);
- ``mpm_match``   <- ``_match_kernel`` / ``prototype_match_pallas`` (K2):
  cosine matching against the prototypes, per-class max and
  first-occurrence argmax;
- ``mpm_chain_packed`` <- ``mpm_chain_packed_pallas`` (K3): K1 then K2 on
  the un-split purifier output ``[B, S+Q, n, c]``; the kernels pick the
  support rows ``(i//S)(S+Q)+i%S`` and query rows ``(i//Q)(S+Q)+S+i%Q``
  themselves, so no split copy is made.

For a tensor on the CPU each wrapper runs the plain version
(``pemp_tpu_torch.ops.prototypes``); for a CUDA tensor it launches its
kernels or raises. ``launches`` counts each ``__global__`` kernel's
launches on CUDA, one at the site that launches it: ``assign_partial``
and ``assign_reduce`` (K1's two launches) and ``match`` (K2). The chain
launches nothing of its own. ``plain_assign_partial`` and
``plain_assign_reduce`` are the plain versions of K1's two launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.kernels.build import load_library
from pemp_tpu_torch.ops.prototypes import (
    ASSIGN_EPS, COS_EPS, meta_prototype_assign, prototype_predictions,
    soft_assignment,
)

MAX_PROTOS = 8           # csrc/mpm.cu kMaxProtos
TILE = 64                # csrc/mpm.cu kTile (pixel rows per block)
SMEM_LIMIT = 232448      # dynamic shared memory a block may use on sm_90

launches: Dict[str, int] = {"assign_partial": 0, "assign_reduce": 0,
                            "match": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_bound = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("mpm")
        lib.pemp_mpm_assign_partial.argtypes = [_P, _I, _P, _P, _P, _P, _I,
                                                _I, _I, _I, _I, _I, _P]
        lib.pemp_mpm_assign_partial.restype = _I
        lib.pemp_mpm_assign_reduce.argtypes = [_P, _P, _I, _I, _I, _I, _I, _F,
                                               _P]
        lib.pemp_mpm_assign_reduce.restype = _I
        lib.pemp_mpm_match.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _F, _F, _P]
        lib.pemp_mpm_match.restype = _I
        lib.pemp_mpm_assign_smem.argtypes = [_I, _I, _I]
        lib.pemp_mpm_assign_smem.restype = ctypes.c_size_t
        lib.pemp_mpm_match_smem.argtypes = [_I, _I]
        lib.pemp_mpm_match_smem.restype = ctypes.c_size_t
        lib.pemp_cuda_error_string.argtypes = [_I]
        lib.pemp_cuda_error_string.restype = ctypes.c_char_p
        for name, want in (("pemp_mpm_max_protos", MAX_PROTOS),
                           ("pemp_mpm_tile", TILE)):
            fn = getattr(lib, name)
            fn.restype = _I
            if fn() != want:
                raise RuntimeError(f"{name}() = {fn()} != {want}: the "
                                   "wrapper and csrc/mpm.cu disagree")
        _bound = lib
    return _bound


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.pemp_cuda_error_string(rc).decode()})")


def _check_features(fts: torch.Tensor, protos: int) -> None:
    if fts.device.type != "cuda":
        raise ValueError(f"features on {fts.device}, expected cuda")
    if fts.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features dtype {fts.dtype}: the kernels take "
                        "float32 or bfloat16")
    if fts.ndim != 4:
        raise ValueError(f"features must be [B, S+Q, n, c], got "
                         f"{tuple(fts.shape)}")
    if not fts.is_contiguous():
        raise ValueError("features must be contiguous")
    if fts.shape[-1] % 8 or fts.data_ptr() % 16:
        raise ValueError("the channel count must be a multiple of 8 and "
                         "the features 16-byte aligned (vector loads)")
    if not 1 <= protos <= MAX_PROTOS:
        raise ValueError(f"protos={protos} outside [1, {MAX_PROTOS}]")


def _f32_on(x: torch.Tensor, device, shape, what: str) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"{what} on {x.device}, features on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    return x.to(torch.float32).contiguous()


def _assign_partial_launch(fts, sup_fg, sup_bg, ctr, protos: int):
    """K1 launch 1 on CUDA -> per-tile partial sums [B*S, tiles, 2p, c+1]
    (``num`` in [..., :c], ``den`` in [..., c])."""
    _check_features(fts, protos)
    b, sq, n, c = fts.shape
    s = sup_fg.shape[1]
    if not 1 <= s <= sq:
        raise ValueError(f"{s} support images in a packed axis of {sq}")
    fg = _f32_on(sup_fg, fts.device, (b, s, n), "sup_fg")
    bg = _f32_on(sup_bg, fts.device, (b, s, n), "sup_bg")
    ctr = _f32_on(ctr, fts.device, (c, 2 * protos), "ctr")
    lib = _lib()
    is_bf16 = int(fts.dtype == torch.bfloat16)
    smem = lib.pemp_mpm_assign_smem(c, protos, is_bf16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"c={c}, p={protos} needs {smem} bytes of shared "
                         f"memory per block (limit {SMEM_LIMIT})")
    part = torch.empty((b * s, -(-n // TILE), 2 * protos, c + 1),
                       dtype=torch.float32, device=fts.device)
    stream = torch.cuda.current_stream(fts.device).cuda_stream
    rc = lib.pemp_mpm_assign_partial(fts.data_ptr(), is_bf16, fg.data_ptr(),
                                     bg.data_ptr(), ctr.data_ptr(),
                                     part.data_ptr(), b, s, sq - s, n, c,
                                     protos, stream)
    _check_rc(lib, rc, "assign_partial")
    launches["assign_partial"] += 1
    return part


def _assign_reduce_launch(part, b: int, s: int, eps: float):
    """K1 launch 2 on CUDA: partial sums [B*S, tiles, 2p, c+1] -> packed
    prototypes [B, 2p, c] (fg first, then bg)."""
    if (part.device.type != "cuda" or part.dtype != torch.float32
            or part.ndim != 4 or part.shape[0] != b * s
            or not part.is_contiguous()):
        raise ValueError(f"partial sums {part.dtype} {tuple(part.shape)} on "
                         f"{part.device}: expected contiguous float32 "
                         f"[{b * s}, tiles, 2p, c+1] on cuda")
    _, tiles, k2, c1 = part.shape
    out = torch.empty((b, k2, c1 - 1), dtype=torch.float32,
                      device=part.device)
    lib = _lib()
    stream = torch.cuda.current_stream(part.device).cuda_stream
    rc = lib.pemp_mpm_assign_reduce(part.data_ptr(), out.data_ptr(), b, s,
                                    tiles, c1 - 1, k2 // 2, float(eps),
                                    stream)
    _check_rc(lib, rc, "assign_reduce")
    launches["assign_reduce"] += 1
    return out


def _assign_launch(fts, sup_fg, sup_bg, ctr, protos: int, eps: float):
    """K1 on CUDA (both launches) -> packed prototypes [B, 2p, c]."""
    part = _assign_partial_launch(fts, sup_fg, sup_bg, ctr, protos)
    return _assign_reduce_launch(part, fts.shape[0], sup_fg.shape[1], eps)


def plain_assign_partial(fts, sup_fg, sup_bg, ctr, protos: int):
    """Plain version of K1's first launch: for each support image and
    TILE-row pixel tile, ``num = a^T f`` [2p, c] and ``den = sum a`` [2p]
    of the soft assignment ``a``. Returns [B*S, tiles, 2p, c+1] float32."""
    s = sup_fg.shape[1]
    f = fts[:, :s].float()
    b, _, n, c = f.shape
    a = soft_assignment(f, sup_fg, sup_bg, ctr, protos)
    pad = -(-n // TILE) * TILE - n
    f = F.pad(f.reshape(b * s, n, c), (0, 0, 0, pad))
    a = F.pad(a.reshape(b * s, n, 2 * protos), (0, 0, 0, pad))
    f = f.reshape(b * s, -1, TILE, c)
    a = a.reshape(b * s, -1, TILE, 2 * protos)
    num = torch.einsum("itrk,itrc->itkc", a, f)
    return torch.cat([num, a.sum(dim=2)[..., None]], dim=-1)


def plain_assign_reduce(part, b: int, s: int, eps: float = ASSIGN_EPS):
    """Plain version of K1's second launch: sum the partials over tiles,
    ``num / (den + eps)``, mean over the S shots -> [B, 2p, c]."""
    tot = part.sum(dim=1)                                   # [B*S, 2p, c+1]
    proto = tot[..., :-1] / (tot[..., -1:] + eps)
    return proto.reshape(b, s, *proto.shape[1:]).mean(dim=1)


def _match_launch(fts, s: int, packed, protos: int, dist_scalar: float,
                  return_indices: bool):
    """K2 on CUDA: query rows fts[:, s:] against packed [B, 2p, c]."""
    _check_features(fts, protos)
    b, sq, n, c = fts.shape
    q = sq - s
    if q < 1:
        raise ValueError(f"no query images: S={s} of a packed axis of {sq}")
    packed = _f32_on(packed, fts.device, (b, 2 * protos, c), "prototypes")
    lib = _lib()
    smem = lib.pemp_mpm_match_smem(c, protos)
    if smem > SMEM_LIMIT:
        raise ValueError(f"c={c}, p={protos} needs {smem} bytes of shared "
                         f"memory per block (limit {SMEM_LIMIT})")
    logits = torch.empty((b, q, n, 2), dtype=torch.float32, device=fts.device)
    inds = (torch.empty((b, q, n, 2), dtype=torch.int32, device=fts.device)
            if return_indices else None)
    stream = torch.cuda.current_stream(fts.device).cuda_stream
    rc = lib.pemp_mpm_match(fts.data_ptr(), int(fts.dtype == torch.bfloat16),
                            packed.data_ptr(), logits.data_ptr(),
                            inds.data_ptr() if inds is not None else None,
                            b, s, q, n, c, protos, float(dist_scalar),
                            COS_EPS, stream)
    _check_rc(lib, rc, "match")
    launches["match"] += 1
    return (logits, inds) if return_indices else logits


def mpm_assign(fts: torch.Tensor, sup_fg: torch.Tensor, sup_bg: torch.Tensor,
               ctr: torch.Tensor, protos: int, eps: float = ASSIGN_EPS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adaptive prototypes from the support rows of packed features.

    fts [B, S+Q, n, c] (Q may be 0); the first S = ``sup_fg.shape[1]``
    images of each episode are the support. sup_fg / sup_bg [B, S, n],
    ctr [c, 2p]. Returns (fg_proto, bg_proto), each [B, p, c] float32.
    """
    s = sup_fg.shape[1]
    if fts.device.type == "cpu":
        return meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr,
                                     protos, eps)
    out = _assign_launch(fts, sup_fg, sup_bg, ctr, protos, eps)
    return out[:, :protos], out[:, protos:]


def mpm_match(fts: torch.Tensor, s: int, fg_proto: torch.Tensor,
              bg_proto: torch.Tensor, dist_scalar: float = 20.0,
              return_indices: bool = False):
    """Cosine logits of the query rows ``fts[:, s:]`` against per-class
    prototypes fg_proto / bg_proto [B, p, c]. Returns logits [B, Q, n, 2]
    ([bg, fg]) and, if asked, int32 argmax indices [B, Q, n, 2]."""
    if fts.device.type == "cpu":
        return prototype_predictions(fts[:, s:], fg_proto, bg_proto,
                                     dist_scalar, return_indices)
    packed = torch.cat([fg_proto, bg_proto], dim=1)
    return _match_launch(fts, s, packed, fg_proto.shape[1], dist_scalar,
                         return_indices)


def mpm_chain_packed(fts: torch.Tensor, sup_fg: torch.Tensor,
                     sup_bg: torch.Tensor, ctr: torch.Tensor, protos: int,
                     dist_scalar: float = 20.0, return_indices: bool = False,
                     eps: float = ASSIGN_EPS):
    """Assign then match on the packed purifier output fts [B, S+Q, n, c]
    (S = ``sup_fg.shape[1]``). Returns logits [B, Q, n, 2] and, if asked,
    the argmax indices [B, Q, n, 2]."""
    s = sup_fg.shape[1]
    if fts.device.type == "cpu":
        fg, bg = meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr,
                                       protos, eps)
        return prototype_predictions(fts[:, s:], fg, bg, dist_scalar,
                                     return_indices)
    packed = _assign_launch(fts, sup_fg, sup_bg, ctr, protos, eps)
    return _match_launch(fts, s, packed, protos, dist_scalar, return_indices)
