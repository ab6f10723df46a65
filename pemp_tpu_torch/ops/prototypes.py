"""Prototype extraction and dense cosine matching in plain PyTorch.

Counterpart of ``pemp_tpu/ops/prototypes.py``, and the plain version of
the CUDA kernels in ``pemp_tpu_torch/ops/kernels``: the CPU path runs
these functions, and on the card the kernels are held against them.
Everything computes in (at least) float32; the JAX package pins these
contractions at full f32 precision because lower precision flips argmax
near ties, so on the card they must run with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

Layout is channels-last with flattened spatial ``[B, S, n, c]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pemp_tpu_torch.ops.dtypes import f32up
from pemp_tpu_torch.ops.resize import interp_matrix

COS_EPS = 1e-8      # torch F.cosine_similarity default
POOL_EPS = 1e-5     # reference masked-average denominators
ASSIGN_EPS = 1e-6   # reference meta-prototype denominator


def masked_average_pooling(fts: torch.Tensor, mask: torch.Tensor,
                           eps: float = POOL_EPS) -> torch.Tensor:
    """Masked mean over the pixel axis: fts [..., n, c], mask [..., n]
    -> [..., c]."""
    fts = f32up(fts)
    mask = f32up(mask)
    num = torch.einsum("...nc,...n->...c", fts, mask)
    den = mask.sum(dim=-1, keepdim=True) + eps
    return num / den


def masked_average_pooling_adjoint(fts: torch.Tensor, mask: torch.Tensor,
                                   eps: float = POOL_EPS) -> torch.Tensor:
    """``masked_average_pooling`` of the features bilinearly upsampled
    (align_corners) to the mask's size, without the upsampled tensor: the
    resize is linear, so the pooled numerator contracts the original
    features with the mask projected down by the adjoint ``R_h^T m R_w``
    (the Baseline/PANet prototypes, reference baseline.py:100-110). The
    denominator is the full-resolution mask sum, as the reference's.

    fts [B, S, h, w, c] at feature resolution, mask [B, S, H, W] at full
    resolution -> [B, S, c].
    """
    b, s, h, w, c = fts.shape
    big_h, big_w = mask.shape[-2:]
    m = f32up(mask)
    rh = interp_matrix(h, big_h, m.device, m.dtype)               # [H, h]
    rw = interp_matrix(w, big_w, m.device, m.dtype)               # [W, w]
    mdown = torch.einsum("Hh,bsHW,Ww->bshw", rh, m, rw)
    num = torch.einsum("bshwc,bshw->bsc", f32up(fts), mdown)
    den = m.sum(dim=(-1, -2))[..., None] + eps
    return num / den


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with the squared sum clamped at 1e-30
    (the JAX package's gradient guard; the forward value is the plain
    norm for any real vector)."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=-1), min=1e-30))


def cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                      eps: float = COS_EPS) -> torch.Tensor:
    """Cosine similarity over the channel axis with torch semantics
    (``x.y / max(|x||y|, eps)``). x [..., n, c], y [..., k, c] ->
    [..., n, k]."""
    x = f32up(x)
    y = f32up(y)
    dot = torch.einsum("...nc,...kc->...nk", x, y)
    xn = _safe_norm(x)[..., :, None]
    yn = _safe_norm(y)[..., None, :]
    return dot / torch.clamp(xn * yn, min=eps)


def prototype_predictions(qry_fts: torch.Tensor, fg_proto: torch.Tensor,
                          bg_proto: torch.Tensor, dist_scalar: float = 20.0,
                          return_indices: bool = False):
    """Dense 2-class logits from per-class prototypes.

    qry_fts [B, Q, n, c]; fg_proto / bg_proto [B, c] (one prototype) or
    [B, p, c] (max over p per class). Returns logits [B, Q, n, 2] in
    class order [bg, fg] and, if asked, the first-occurrence argmax
    prototype indices [B, Q, n, 2].
    """
    if fg_proto.ndim == 2:
        fg_proto = fg_proto[:, None, :]
        bg_proto = bg_proto[:, None, :]
    fg_sim = cosine_similarity(qry_fts, fg_proto[:, None]) * dist_scalar
    bg_sim = cosine_similarity(qry_fts, bg_proto[:, None]) * dist_scalar
    sims = torch.stack([bg_sim, fg_sim], dim=3)         # [B, Q, n, 2, p]
    logits = sims.amax(dim=-1)
    if return_indices:
        # argmax returns the first of equal maxima, like the TPU kernel
        return logits, sims.argmax(dim=-1).to(torch.int32)
    return logits


def soft_assignment(sup_fts: torch.Tensor, sup_fg: torch.Tensor,
                    sup_bg: torch.Tensor, ctr: torch.Tensor,
                    protos: int) -> torch.Tensor:
    """Masked soft assignment of the support pixels to the centers.

    sup_fts [B, S, n, c]; sup_fg / sup_bg [B, S, n]; ctr [c, 2p] with
    columns [0, p) foreground and [p, 2p) background. ``D = -|f - ctr|^2``,
    a softmax over the p centers within each class, times the class mask.
    Returns [B, S, n, 2p] float32.
    """
    f = f32up(sup_fts)
    ctr = f32up(ctr)
    b, s, n, c = f.shape
    f_sq = (f * f).sum(dim=-1, keepdim=True)                   # [B,S,n,1]
    c_sq = (ctr * ctr).sum(dim=0)                              # [2p]
    f_dot_c = torch.einsum("bsnc,ck->bsnk", f, ctr)            # [B,S,n,2p]
    dist = -(f_sq - 2.0 * f_dot_c + c_sq)
    assign = torch.softmax(dist.reshape(b, s, n, 2, protos), dim=-1)
    mask = f32up(torch.stack([sup_fg, sup_bg], dim=-1))        # [B,S,n,2]
    return (assign * mask[..., None]).reshape(b, s, n, 2 * protos)


def meta_prototype_assign(sup_fts: torch.Tensor, sup_fg: torch.Tensor,
                          sup_bg: torch.Tensor, ctr: torch.Tensor,
                          protos: int, eps: float = ASSIGN_EPS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Meta-prototype soft assignment -> per-episode adaptive prototypes:
    ``soft_assignment``-weighted feature averages, then a mean over shots.
    Returns (fg_proto, bg_proto), each [B, p, c].
    """
    f = f32up(sup_fts)
    assign = soft_assignment(sup_fts, sup_fg, sup_bg, ctr, protos)
    num = torch.einsum("bsnc,bsnk->bskc", f, assign)           # [B,S,2p,c]
    den = assign.sum(dim=2)[..., None] + eps                   # [B,S,2p,1]
    proto = (num / den).mean(dim=1)                            # [B,2p,c]
    return proto[:, :protos], proto[:, protos:]
