"""Dilated ResNet backbones (output stride 8).

Counterpart of ``BottleNeck``, ``ResNet``, ``CommModule`` and ``ResNetCM``
in ``pemp_tpu/models/backbones.py:30-187`` (reference
networks/backbones.py:42-247): caffe-style bottleneck with the stride on
the first 1x1 conv, layer3 at stride 1 with dilation 2; the stage-2
variant adds an episode communication module before each stage. Module
names follow the torchvision / reference ``state_dict`` keys (``conv1``,
``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, ``linear1`` ...),
so a reference checkpoint loads as is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
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


class CommModule(nn.Linear):
    """Episode communication (reference ResNetCM.comm :208-222): the prior
    mask max-pooled (3, ``mask_stride``, 1, floor mode) to the features'
    size, the masked features' mean and max over pixels, each averaged
    over the ``spq`` images of an episode, a linear map from 2c to ``n``,
    broadcast to every pixel. It is the ``nn.Linear`` itself, so its keys
    are the reference's ``linear{i}.weight`` / ``.bias`` and its init is
    ``nn.Linear``'s (the JAX package's ``torch_conv_default_init`` and
    ``torch_bias_init``)."""

    def __init__(self, channels: int, mask_stride: int, n: int = 2):
        super().__init__(2 * channels, n)
        self.mask_stride = mask_stride

    def forward(self, x: torch.Tensor, mask: torch.Tensor, spq: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B*spq, c, h, w], mask [B*spq, 1, H, W] at the previous scale
        -> (the [B*spq, n, h, w] broadcast, the pooled mask)."""
        mask = F.max_pool2d(mask, 3, self.mask_stride, 1)
        nimg, c, h, w = x.shape
        masked = (x * mask.to(x.dtype)).flatten(2)             # [nimg, c, hw]
        mean = masked.mean(dim=2).reshape(-1, spq, c).mean(dim=1)
        mx = masked.amax(dim=2).reshape(-1, spq, c).mean(dim=1)
        feat = super().forward(torch.cat([mean, mx], dim=1))   # [B, n]
        # NHWC memory viewed as NCHW: channels_last, like the features
        feat = feat[:, None, None, None, :].expand(-1, spq, h, w, -1)
        return feat.reshape(nimg, h, w, -1).permute(0, 3, 1, 2), mask


class ResNetCM(nn.Module):
    """3-stage dilated ResNet with a communication module before each
    stage (reference :160-247; ``pemp_tpu/models/backbones.py:133-187``).
    ``conv1`` takes RGB plus the prior; the prior, pooled by (3, 2, 1),
    is also the CMs' mask (strides 2, 1, 2). The first block of each stage
    takes the ``n`` extra channels and always has a downsample."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6), n: int = 2):
        super().__init__()
        self.conv1 = Conv(4, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.relu = nn.ReLU()
        self.maxpool = max_pool_torch()
        inplanes = 64
        plan = _stage_plan(layers[:3])
        for si, ((planes, stride, dilation), mstride) in enumerate(
                zip(plan, (2, 1, 2)), 1):
            setattr(self, f"linear{si}", CommModule(inplanes, mstride, n))
            blocks = [BottleNeck(inplanes + n, planes, stride, dilation,
                                 use_downsample=True)]
            blocks += [BottleNeck(planes * 4, planes, 1, dilation)
                       for _ in range(1, layers[si - 1])]
            setattr(self, f"layer{si}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor, prior: torch.Tensor, spq: int
                ) -> torch.Tensor:
        """x [B*spq, 4, H, W] (RGB + prior), prior [B*spq, 1, H, W]."""
        mask = F.max_pool2d(prior, 3, 2, 1)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for si in (1, 2, 3):
            ci, mask = getattr(self, f"linear{si}")(x, mask, spq)
            x = getattr(self, f"layer{si}")(torch.cat([x, ci], dim=1))
        return x
