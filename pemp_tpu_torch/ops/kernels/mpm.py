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
  themselves, so no split copy is made;
- ``MPMChainPacked`` <- the custom VJPs of ``pemp_tpu/ops/pallas/mpm_vjp.py``
  (K4): K1 and K2 forward, the analytic backward in PyTorch ops.

For a tensor on the CPU each wrapper runs the plain version
(``pemp_tpu_torch.ops.prototypes``); for a CUDA tensor it launches its
kernels or raises. ``launches`` counts each ``__global__`` kernel's
launches on CUDA, one at the site that launches it: ``assign_partial``
and ``assign_reduce`` (K1's two launches) and ``match`` (K2). The chain
launches nothing of its own. ``plain_assign_partial`` and
``plain_assign_reduce`` are the plain versions of K1's two launches.
``backward_calls`` counts ``MPMChainPacked`` backward passes (torch ops,
no kernel of their own).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.dtypes import f32up
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
backward_calls: Dict[str, int] = {"mpm_backward": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_bound = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    backward_calls["mpm_backward"] = 0


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


def _norm_and_guard(x: torch.Tensor):
    """``_safe_norm``'s value and the ``sq >= 1e-30`` gate its gradient
    implies."""
    sq = (x * x).sum(dim=-1)
    return torch.sqrt(torch.clamp(sq, min=1e-30)), sq >= 1e-30


def _assign_backward(sup_fts, sup_fg, sup_bg, ctr, g_proto, protos: int,
                     eps: float):
    """Cotangents of (sup_fts, sup_fg, sup_bg, ctr) from the packed
    prototype cotangent g_proto [B, 2p, c] (``_assign_bwd``,
    ``pemp_tpu/ops/pallas/mpm_vjp.py:63-112``). The softmax assignment is
    recomputed from the four inputs, not saved."""
    f = f32up(sup_fts)
    c32 = ctr.to(f.dtype)
    b, s, n, c = f.shape
    k = protos
    f_sq = (f * f).sum(dim=-1, keepdim=True)                      # [B,S,n,1]
    c_sq = (c32 * c32).sum(dim=0)                                 # [2k]
    dist = -(f_sq - 2.0 * torch.einsum("bsnc,ck->bsnk", f, c32) + c_sq)
    sm5 = torch.softmax(dist.reshape(b, s, n, 2, k), dim=-1)      # [B,S,n,2,k]
    mask2 = torch.stack([sup_fg, sup_bg], dim=-1).to(f.dtype)     # [B,S,n,2]
    a = (sm5 * mask2[..., None]).reshape(b, s, n, 2 * k)
    num = torch.einsum("bsnc,bsnk->bskc", f, a)                   # [B,S,2k,c]
    den = a.sum(dim=2)[..., None] + eps                           # [B,S,2k,1]

    # proto = mean_s(num / den)
    gq = g_proto.to(f.dtype)[:, None] / s                         # [B,1,2k,c]
    g_num = gq / den
    g_den = -(gq * num).sum(dim=-1, keepdim=True) / (den * den)
    g_a = (torch.einsum("bsnc,bskc->bsnk", f, g_num)
           + g_den[..., 0][:, :, None, :])                        # [B,S,n,2k]
    g_f = torch.einsum("bsnk,bskc->bsnc", a, g_num)

    # a = softmax(dist | class) * mask
    g_a5 = g_a.reshape(b, s, n, 2, k)
    g_mask2 = (sm5 * g_a5).sum(dim=-1)                            # [B,S,n,2]
    g_sm5 = g_a5 * mask2[..., None]
    g_d5 = sm5 * (g_sm5 - (sm5 * g_sm5).sum(dim=-1, keepdim=True))
    g_dist = g_d5.reshape(b, s, n, 2 * k)

    # dist = -(f_sq - 2 f.ctr + c_sq)
    g_fc = 2.0 * g_dist
    g_row = g_dist.sum(dim=-1, keepdim=True)
    g_f = g_f - 2.0 * f * g_row + torch.einsum("bsnk,ck->bsnc", g_fc, c32)
    g_ctr = (torch.einsum("bsnc,bsnk->ck", f, g_fc)
             - 2.0 * c32 * g_dist.sum(dim=(0, 1, 2))[None, :])
    return g_f, g_mask2[..., 0], g_mask2[..., 1], g_ctr


def _match_backward(qry_fts, packed, inds, g, protos: int,
                    dist_scalar: float, cos_eps: float = COS_EPS):
    """Cotangents of (qry_fts, packed prototypes [B, 2p, c]) from the
    logit cotangent g [B, Q, n, 2] (``_match_bwd``, ``mpm_vjp.py:146-186``).
    The max over p sends each row's gradient only to its argmax prototype
    (``inds``, written by the forward), as a one-hot mask."""
    q = f32up(qry_fts)
    qn, q_live = _norm_and_guard(q)                               # [B,Q,n]
    col = torch.arange(protos, device=q.device)

    def class_backward(proto, idx, g_cls):
        p = proto.to(q.dtype)
        pn, p_live = _norm_and_guard(p)                           # [B,k]
        dot = torch.einsum("bqnc,bkc->bqnk", q, p)
        d_raw = qn[..., None] * pn[:, None, None, :]              # [B,Q,n,k]
        d_cl = torch.clamp(d_raw, min=cos_eps)
        g_cos = ((idx[..., None] == col).to(q.dtype)
                 * g_cls[..., None].to(q.dtype) * dist_scalar)
        g_dot = g_cos / d_cl
        g_d = torch.where(d_raw >= cos_eps, -g_cos * dot / (d_cl * d_cl),
                          torch.zeros_like(dot))
        g_qn = (g_d * pn[:, None, None, :]).sum(dim=-1)           # [B,Q,n]
        g_pn = (g_d * qn[..., None]).sum(dim=(1, 2))              # [B,k]
        g_q = (torch.einsum("bqnk,bkc->bqnc", g_dot, p)
               + torch.where(q_live, g_qn / qn, torch.zeros_like(qn))[..., None]
               * q)
        g_p = (torch.einsum("bqnk,bqnc->bkc", g_dot, q)
               + torch.where(p_live, g_pn / pn, torch.zeros_like(pn))[..., None]
               * p)
        return g_q, g_p

    # class order of the logits is [bg, fg]; packed holds fg then bg
    g_q_bg, g_bg = class_backward(packed[:, protos:], inds[..., 0], g[..., 0])
    g_q_fg, g_fg = class_backward(packed[:, :protos], inds[..., 1], g[..., 1])
    return g_q_bg + g_q_fg, torch.cat([g_fg, g_bg], dim=1)


class MPMChainPacked(torch.autograd.Function):
    """Differentiable assign-then-match on the packed features (K4; the
    custom VJP ``mpm_packed_fused``, ``pemp_tpu/ops/pallas/mpm_vjp.py:197-230``).

    Forward: on CUDA, K1 then K2 with the argmax indices; on the CPU the
    plain composition. The packed prototypes [B, 2p, c] and the int32
    indices are kept for the backward. Backward: PyTorch tensor ops in
    (at least) float32, the same on both devices, as the JAX package's is
    jnp outside any kernel; its contractions need TF32 off on the card.
    Ties of the max over p send the gradient to the first occurrence
    (autodiff of the plain version splits it; measure zero for real
    features). ``backward_calls["mpm_backward"]`` counts backward passes.
    """

    @staticmethod
    def forward(ctx, fts, sup_fg, sup_bg, ctr, protos: int,
                dist_scalar: float, eps: float):
        s = sup_fg.shape[1]
        if fts.device.type == "cpu":
            fg, bg = meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr,
                                           protos, eps)
            packed = torch.cat([fg, bg], dim=1)
            logits, inds = prototype_predictions(fts[:, s:], fg, bg,
                                                 dist_scalar, True)
        else:
            packed = _assign_launch(fts, sup_fg, sup_bg, ctr, protos, eps)
            logits, inds = _match_launch(fts, s, packed, protos, dist_scalar,
                                         True)
        ctx.save_for_backward(fts, sup_fg, sup_bg, ctr, packed, inds)
        ctx.protos, ctx.dist_scalar, ctx.eps = protos, dist_scalar, eps
        return logits

    @staticmethod
    def backward(ctx, g):
        fts, sup_fg, sup_bg, ctr, packed, inds = ctx.saved_tensors
        backward_calls["mpm_backward"] += 1
        s = sup_fg.shape[1]
        g_qry, g_packed = _match_backward(fts[:, s:], packed, inds, g,
                                          ctx.protos, ctx.dist_scalar)
        g_sup, g_fg, g_bg, g_ctr = _assign_backward(
            fts[:, :s], sup_fg, sup_bg, ctr, g_packed, ctx.protos, ctx.eps)
        need = ctx.needs_input_grad
        g_fts = torch.cat([g_sup, g_qry], dim=1).to(fts.dtype)
        return (g_fts if need[0] else None,
                g_fg.to(sup_fg.dtype) if need[1] else None,
                g_bg.to(sup_bg.dtype) if need[2] else None,
                g_ctr.to(ctr.dtype) if need[3] else None,
                None, None, None)


def mpm_chain_packed(fts: torch.Tensor, sup_fg: torch.Tensor,
                     sup_bg: torch.Tensor, ctr: torch.Tensor, protos: int,
                     dist_scalar: float = 20.0, return_indices: bool = False,
                     eps: float = ASSIGN_EPS):
    """Assign then match on the packed purifier output fts [B, S+Q, n, c]
    (S = ``sup_fg.shape[1]``). Returns logits [B, Q, n, 2] and, if asked,
    the argmax indices [B, Q, n, 2]. With grad enabled and an input that
    requires it, the logits come from ``MPMChainPacked`` (same kernels
    forward, analytic backward)."""
    s = sup_fg.shape[1]
    if (not return_indices and torch.is_grad_enabled()
            and any(t.requires_grad for t in (fts, sup_fg, sup_bg, ctr))):
        return MPMChainPacked.apply(fts, sup_fg, sup_bg, ctr, protos,
                                    dist_scalar, eps)
    if fts.device.type == "cpu":
        fg, bg = meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr,
                                       protos, eps)
        return prototype_predictions(fts[:, s:], fg, bg, dist_scalar,
                                     return_indices)
    packed = _assign_launch(fts, sup_fg, sup_bg, ctr, protos, eps)
    return _match_launch(fts, s, packed, protos, dist_scalar, return_indices)
