"""Dilated ResNet backbone (output stride 8).

Counterpart of ``BottleNeck`` and ``ResNet`` in
``pemp_tpu/models/backbones.py:30-100`` (reference networks/backbones.py
:42-157): caffe-style bottleneck with the stride on the first 1x1 conv,
layer3 at stride 1 with dilation 2. Module names follow the torchvision /
reference ``state_dict`` keys (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0`` ...), so a reference checkpoint loads as is.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pemp_tpu_torch.models.layers import BatchNorm, Conv, max_pool_torch


class BottleNeck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = Conv(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, padding=d, dilation=d, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = None
        if use_downsample:
            self.downsample = nn.Sequential(
                Conv(inplanes, planes * 4, 1, stride=stride, bias=False),
                BatchNorm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


def _stage_plan(layers: Sequence[int]):
    """(planes, stride, dilation) per stage (reference :97-101)."""
    plan = [(64, 1, 1), (128, 2, 1), (256, 1, 2)]
    if len(layers) > 3:
        plan.append((512, 1, 4))
    return plan


class ResNet(nn.Module):
    """Dilated ResNet: ``layers=(3,4,6)`` is the 3-stage ResNet-50 trunk,
    ``(3,4,23)`` ResNet-101 (tests build ``(1,1,1)``)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 init_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(init_channels, 64, 7, stride=2, padding=3,
                          bias=False)
        self.bn1 = BatchNorm(64)
        self.relu = nn.ReLU()
        self.maxpool = max_pool_torch()
        inplanes = 64
        for si, (planes, stride, dilation) in enumerate(_stage_plan(layers), 1):
            blocks = []
            for bi in range(layers[si - 1]):
                use_ds = bi == 0 and (stride != 1 or inplanes != planes * 4
                                      or dilation in (2, 4))
                blocks.append(BottleNeck(inplanes, planes,
                                         stride if bi == 0 else 1, dilation,
                                         use_downsample=use_ds))
                inplanes = planes * 4
            setattr(self, f"layer{si}", nn.Sequential(*blocks))
        self.num_stages = len(_stage_plan(layers))
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for si in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{si}")(x)
        return x
