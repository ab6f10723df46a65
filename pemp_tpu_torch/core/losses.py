"""Eval losses on the device.

Counterpart of ``cross_entropy`` and ``per_episode_cross_entropy`` in
``pemp_tpu/core/losses.py`` (reference core/losses.py:10): mean
cross-entropy with ignore index 255. Logits are channels-last
``[..., 2]``; labels are integer maps of the same leading shape. The
boundary-weighted ``cedt`` loss and its EDT come with the training slice.
"""

from __future__ import annotations

import torch

from pemp_tpu_torch.ops.dtypes import f32up

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
