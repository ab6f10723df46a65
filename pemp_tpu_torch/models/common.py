"""Shared model plumbing: the models' base class, purifier heads, mask
downsampling, output resize.

Counterpart of ``pemp_tpu/models/common.py`` (``PurifierV1``,
``PurifierV2``, ``downsample_masks``, ``output_resize``,
``RESNET_LAYERS``), plus ``FewShotModel``: the init, the frozen trunk
and the dropout generator every model of the port shares, and the
layout and autocast helpers of CaNet, RPMMs and PFENet.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.layers import (
    ASPP, ASPPV2, Conv, DropBlock, Dropout2d, KaimingConv, NormalConv,
)
from pemp_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest

RESNET_LAYERS = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23)}


class FewShotModel(nn.Module):
    """What every model of the port shares: the init, the frozen trunk
    and the dropout generator. Subclasses set ``encoder`` (with a
    ``backbone``) or override ``trunk``, and, the PEMP stages, ``ctr``."""

    # module types under the trunk whose parameters do not train (every
    # ResNet's BNs; VGG16 has none, so nothing of it is frozen).
    # The JAX package's regex ``backbone/.*bn`` also matches its
    # ``downsample_bn``; here that module is ``layerK.0.downsample.1``, so
    # the rule goes by module type, not by name. ``(nn.Module,)`` freezes
    # the whole trunk (CaNet, PFENet).
    FROZEN = (nn.BatchNorm2d,)

    def trunk(self) -> List[nn.Module]:
        """The modules ``FROZEN`` applies under: ``encoder.backbone``
        (CaNet's trunk is ``encoder``, RPMMs' ``model_res``, PFENet's
        ``layer0``-``layer4``, as in the reference checkpoints)."""
        return [self.encoder.backbone]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Re-draw every weight from ``generator`` with the JAX package's
        inits: torch's defaults for convs and linears (kaiming-uniform
        a=sqrt(5)), kaiming-normal (relu gain, fan_in) for the VGG convs
        (``KaimingConv``), normal(0, 0.01) for CaNet's head
        (``NormalConv``), U(+-1/sqrt(fan_in)) biases, BN ones/zeros with
        fresh running stats, and ``ctr`` from U[0,1) like ``torch.rand``
        (reference pemp_stage1.py:105)."""
        for m in self.modules():
            if isinstance(m, KaimingConv):
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, NormalConv):
                nn.init.normal_(m.weight, 0.0, NormalConv.STD,
                                generator=generator)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.bias.uniform_(-bound, bound, generator=generator)
        if getattr(self, "ctr", None) is not None:
            self.ctr.uniform_(0.0, 1.0, generator=generator)

    def freeze(self) -> List[nn.Parameter]:
        """``requires_grad=False`` on the parameters of every ``FROZEN``
        module under the trunk (its BNs stay in train mode, so they still
        use and update batch statistics); returns the parameters that
        train."""
        for part in self.trunk():
            for m in part.modules():
                if isinstance(m, self.FROZEN):
                    for p in m.parameters(recurse=False):
                        p.requires_grad_(False)
        return [p for p in self.parameters() if p.requires_grad]

    def set_dropout_generator(self, generator: Optional[torch.Generator],
                              shard=None) -> None:
        """The generator every DropBlock and Dropout2d draws from in train
        mode, and the rows of the global batch this process holds
        (``shard``, a ``parallel.mesh.RowShard``; None for one process)."""
        for m in self.modules():
            if isinstance(m, (DropBlock, Dropout2d)):
                m.generator = generator
                m.shard = shard


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


def autocast(x: torch.Tensor, dtype: torch.dtype):
    """bf16 autocast on ``x``'s device when ``dtype`` is bf16."""
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """A channels_last NCHW tensor viewed as NHWC."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor viewed as NCHW (channels_last)."""
    return x.permute(0, 3, 1, 2)


def output_resize(logits: torch.Tensor, out_hw: Optional[Tuple[int, int]]):
    """Upsample [B,Q,h,w,2] logits bilinearly (align_corners) to ``out_hw``;
    ``None`` keeps feature resolution."""
    if out_hw is None:
        return logits
    b, q, h, w, c = logits.shape
    out = resize_bilinear_align_corners(logits.reshape(b * q, h, w, c), out_hw)
    return out.reshape(b, q, out_hw[0], out_hw[1], c)
