"""Shared model plumbing: purifier head, mask downsampling, output resize.

Counterpart of ``pemp_tpu/models/common.py`` (``PurifierV1``,
``PurifierV2``, ``downsample_masks``, ``output_resize``,
``RESNET_LAYERS``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.layers import (
    ASPP, ASPPV2, Conv, DropBlock, Dropout2d,
)
from pemp_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest

RESNET_LAYERS = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23)}


class PurifierV2(nn.Sequential):
    """Stage-1 purifier: 1x1 conv -> DropBlock -> 3x3 conv -> DropBlock ->
    ASPPV2 (reference networks/pemp_stage1.py:73-80). Indices follow the
    reference ``state_dict``: ``0`` conv1, ``3`` conv2, ``6`` ASPPV2."""

    def __init__(self, in_channels: int = 1024, out_channels: int = 512,
                 drop_rate: float = 0.1, block_size: int = 4):
        super().__init__(
            Conv(in_channels, 256, 1), nn.ReLU(),
            DropBlock(drop_rate, block_size),
            Conv(256, 256, 3, padding=1), nn.ReLU(),
            DropBlock(drop_rate, block_size),
            ASPPV2(256, 256, out_channels, drop_rate, block_size))


class PurifierV1(nn.Sequential):
    """Stage-2 purifier: 1x1 conv -> Dropout2d -> 3x3 conv -> Dropout2d ->
    ASPP (reference networks/pemp_stage2.py:65-72). Indices follow the
    reference ``state_dict``: ``0`` conv1, ``3`` conv2, ``6`` ASPP."""

    def __init__(self, in_channels: int = 1024, out_channels: int = 512,
                 drop_rate: float = 0.5):
        super().__init__(
            Conv(in_channels, 256, 1), nn.ReLU(), Dropout2d(drop_rate),
            Conv(256, 256, 3, padding=1), nn.ReLU(), Dropout2d(drop_rate),
            ASPP(256, 256, out_channels, drop_rate))


def downsample_masks(sup_mask: torch.Tensor, hw: Tuple[int, int]):
    """Nearest-downsample [B,S,H,W,2] support masks to feature resolution,
    returning flattened fg/bg [B,S,n] (reference pemp_stage1.py:147-148)."""
    b, s, H, W, _ = sup_mask.shape
    m = resize_nearest(sup_mask.reshape(b * s, H, W, 2), hw)
    m = m.reshape(b, s, hw[0] * hw[1], 2)
    return m[..., 0], m[..., 1]


def output_resize(logits: torch.Tensor, out_hw: Optional[Tuple[int, int]]):
    """Upsample [B,Q,h,w,2] logits bilinearly (align_corners) to ``out_hw``;
    ``None`` keeps feature resolution."""
    if out_hw is None:
        return logits
    b, q, h, w, c = logits.shape
    out = resize_bilinear_align_corners(logits.reshape(b * q, h, w, c), out_hw)
    return out.reshape(b, q, out_hw[0], out_hw[1], c)
