"""Segmentation losses on the device.

Counterpart of ``pemp_tpu/core/losses.py`` (reference core/losses.py):

- ``cross_entropy``: mean CE with ignore index 255 (reference :10);
- ``per_episode_cross_entropy``: the eval CE per episode;
- ``cross_entropy_no_ignore``: plain mean CE, every pixel counted (PANet's
  alignment loss);
- ``rpmms_loss``, ``pfenet_aux_loss``: RPMMs' three-term CE and PFENet's
  auxiliary CE over its pyramid's bins;
- ``cedt``: boundary-weighted CE, per-pixel CE times
  ``exp(-EDT(boundary)/sigma^2) + 1``, divided by the *total* weight,
  ignored pixels included (the reference divides by ``weight.sum()``,
  :43). The EDT runs on the device (``ops/edt.py``, the min-plus kernel
  on CUDA); the weight is a function of the labels and carries no
  gradient.

Logits are channels-last ``[..., 2]``; labels are integer maps of the
same leading shape.
"""

from __future__ import annotations

import torch

from pemp_tpu_torch.ops.dtypes import f32up
from pemp_tpu_torch.ops.edt import edt_boundary_weight

IGNORE = 255


def _pixel_ce(logits: torch.Tensor, labels: torch.Tensor):
    """Per-pixel CE, 0 at ignored pixels. logits [..., C], labels [...]."""
    logits = f32up(logits)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, logz - ll, torch.zeros_like(logz)), valid


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-ignored pixels (torch CrossEntropyLoss(ignore=255))."""
    pix, valid = _pixel_ce(logits, labels)
    return pix.sum() / valid.sum().clamp(min=1)


def per_episode_cross_entropy(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-episode eval CE: logits [B, Q, ..., C], labels [B, Q, ...] ->
    [B]. Each query's CE is normalized by its own valid count, then
    averaged over Q."""
    pix, valid = _pixel_ce(logits, labels)
    b, q = pix.shape[:2]
    per_query = (pix.reshape(b, q, -1).sum(dim=2)
                 / valid.reshape(b, q, -1).sum(dim=2).clamp(min=1))
    return per_query.mean(dim=1)


def cross_entropy_no_ignore(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over every pixel, no ignore index (torch
    ``F.cross_entropy`` defaults; reference PANet alignLoss)."""
    logits = f32up(logits)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()


def cedt(logits: torch.Tensor, labels: torch.Tensor,
         sigma: float = 5.0) -> torch.Tensor:
    """Boundary-distance-weighted CE (reference CELossDT :33-43).
    logits [B, H, W, 2] (query axis folded), labels [B, H, W]."""
    pix, _ = _pixel_ce(logits, labels)
    weight = edt_boundary_weight(labels, sigma, dtype=pix.dtype)
    return (pix * weight).sum() / weight.sum()


def rpmms_loss(outs, labels: torch.Tensor) -> torch.Tensor:
    """RPMMs' loss (reference rpmms.py:289-311): the CE without ignore of
    each pyramid output, summed. outs: [B, Q, H, W, 2] logits at the
    label size; labels [B*Q, H, W]."""
    return sum(cross_entropy_no_ignore(o.reshape(-1, *o.shape[2:]), labels)
               for o in outs)


def pfenet_aux_loss(aux_outs, labels: torch.Tensor) -> torch.Tensor:
    """PFENet's auxiliary loss (reference pfenet.py:276-284): the mean over
    the pyramid's bins of the CE with ignore 255. aux_outs: [B, Q, H, W, 2]
    logits at the label size; labels [B*Q, H, W]."""
    losses = [cross_entropy(a.reshape(-1, *a.shape[2:]), labels)
              for a in aux_outs]
    return sum(losses) / len(losses)


def get(cfg):
    """The loss ``cfg.loss`` names (reference core/losses.py:8-14)."""
    if cfg.loss == "ce":
        return cross_entropy
    if cfg.loss == "cedt":
        sigma = cfg.sigma
        return lambda logits, labels: cedt(logits, labels, sigma)
    raise ValueError(f"Unsupported loss type, got {cfg.loss}. "
                     "Please choose from [ce, cedt]")
