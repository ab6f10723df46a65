"""CaNet: dense comparison and iterative refinement with history masks.

Counterpart of ``pemp_tpu/models/canet.py`` (reference networks/canet.py):

- a 3-stage dilated ResNet-50 trunk (``encoder``, frozen whole with
  ``freeze_backbone``) over the support and query images in one call;
  ``concat(layer2, layer3)`` (512 + 1024 channels) goes through
  ``layer5``;
- the support prototype, the masked average of the support features
  against the nearest-downsampled fg mask, tiled over the query and
  concatenated with it into ``layer55``;
- three residual blocks, the first also seeing the query's 2-channel
  history (its previous softmax at 1/8 resolution) when ``use_history``,
  an ASPP-like head (``aspp_0..4``, each followed by channel dropout) and
  ``layer6``;
- ``layer7`` gives the logits at 1/8 resolution, ``(H-1)//8 + 1`` (41 at
  321x321); ``out_hw=None`` keeps that resolution (the entry writes its
  softmax back into the history store).

The convolutions run under bf16 autocast when ``compute_dtype`` is bf16;
the prototype and the resizes run in float32. The head convs draw
normal(0, 0.01) kernels (``NormalConv``). Keys follow the reference
checkpoint: ``encoder.*``, ``layer5.0``, ``layer55.0``, ``aspp_{k}.0``,
``layer6.0``, ``residual_{i}.{1,3}``, ``layer7``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.backbones import ResNet
from pemp_tpu_torch.models.common import (
    RESNET_LAYERS, FewShotModel, autocast, nchw, nhwc, output_resize,
)
from pemp_tpu_torch.models.layers import Dropout2d, NormalConv
from pemp_tpu_torch.ops.prototypes import masked_average_pooling
from pemp_tpu_torch.ops.resize import resize_nearest


@dataclass
class NetConfig:
    """Scope ``net`` (reference networks/canet.py:16-22)."""
    init_channels: int = 3
    drop_rate: float = 0.5
    history: bool = True
    freeze_backbone: bool = True


def feat_size(size: int) -> int:
    """The trunk's output size (output stride 8): 41 at 321."""
    return (size - 1) // 8 + 1


class ConvReluDrop(nn.Sequential):
    """conv (normal(0, 0.01)) -> ReLU -> Dropout2d; key ``.0``."""

    def __init__(self, inc: int, outc: int, kernel: int = 3,
                 padding: int = 0, dilation: int = 1, drop_rate: float = 0.5):
        super().__init__(
            NormalConv(inc, outc, kernel, padding=padding, dilation=dilation),
            nn.ReLU(), Dropout2d(drop_rate))


class ResidualBlock(nn.Sequential):
    """ReLU -> conv3x3 -> ReLU -> conv3x3 to 256 channels (reference
    :103-120); keys ``.1`` and ``.3``. RPMMs shares it."""

    def __init__(self, inc: int = 256):
        super().__init__(nn.ReLU(), NormalConv(inc, 256, 3, padding=1),
                         nn.ReLU(), NormalConv(256, 256, 3, padding=1))


class CaNet(FewShotModel):
    """``layers`` overrides the ResNet-50 depth (tests build
    ``(1, 1, 1)``)."""

    def __init__(self, drop_rate: float = 0.5, use_history: bool = True,
                 freeze_backbone: bool = True, num_classes: int = 2,
                 compute_dtype: torch.dtype = torch.float32,
                 layers: Optional[Sequence[int]] = None):
        super().__init__()
        # the whole trunk, or its BNs only (reference :219-231)
        self.FROZEN = (nn.Module,) if freeze_backbone else (nn.BatchNorm2d,)
        self.use_history = use_history
        self.compute_dtype = compute_dtype
        self.encoder = ResNet(layers or RESNET_LAYERS["resnet50"],
                              ret_features=True)
        self.layer5 = ConvReluDrop(512 + 1024, 256, 3, 2, 2, drop_rate)
        self.layer55 = ConvReluDrop(512, 256, 3, 2, 2, drop_rate)
        self.residual_1 = ResidualBlock(256 + 2 * use_history)
        self.residual_2 = ResidualBlock()
        self.residual_3 = ResidualBlock()
        self.aspp_0 = ConvReluDrop(256, 256, 1, drop_rate=drop_rate)
        self.aspp_1 = ConvReluDrop(256, 256, 1, drop_rate=drop_rate)
        for k, dil in ((2, 6), (3, 12), (4, 18)):
            setattr(self, f"aspp_{k}",
                    ConvReluDrop(256, 256, 3, dil, dil, drop_rate))
        self.layer6 = ConvReluDrop(5 * 256, 256, 1, drop_rate=drop_rate)
        self.layer7 = NormalConv(256, num_classes, 1)

    def trunk(self) -> List[nn.Module]:
        return [self.encoder]

    def forward(self, sup_img, sup_mask, qry_img, history,
                out_hw: Optional[Tuple[int, int]] = "input"):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg), qry_img
        [B,Q,H,W,3], history [B,Q,h8,w8,2] (the previous softmax, zeros at
        first) -> logits [B,Q,*out_hw,2] ([bg, fg]); ``out_hw=None`` keeps
        the 1/8 resolution."""
        b, s, H, W, _ = sup_img.shape
        q = qry_img.shape[1]
        if out_hw == "input":
            out_hw = (H, W)
        imgs = torch.cat([sup_img, qry_img], dim=1)
        # NHWC memory viewed as NCHW: already channels_last, no copy
        imgs = nchw(imgs.reshape(b * (s + q), H, W, -1))
        with autocast(imgs, self.compute_dtype):
            _, f2, f3 = self.encoder(imgs)
            feat = self.layer5(torch.cat([f2, f3], dim=1))
        c, h, w = feat.shape[1:]
        feat = nhwc(feat).reshape(b, s + q, h, w, c)
        sup_fts = feat[:, :s].reshape(b, s, h * w, c)
        qry_fts = nchw(feat[:, s:].reshape(b * q, h, w, c))

        # the support prototype from the nearest-downsampled fg mask
        m = resize_nearest(sup_mask[..., :1].reshape(b * s, H, W, 1), (h, w))
        z = masked_average_pooling(sup_fts, m.reshape(b, s, h * w))
        z = z.mean(dim=1)                                       # [b, c]
        z = z[:, None, :, None, None].expand(b, q, c, h, w)
        out = torch.cat([qry_fts, z.reshape(b * q, c, h, w)], dim=1)
        with autocast(imgs, self.compute_dtype):
            out = self.layer55(out)
            if self.use_history:
                hist = nchw(history.reshape(b * q, h, w, 2)).to(out.dtype)
                inp = torch.cat([out, hist], dim=1)
            else:
                inp = out
            out = out + self.residual_1(inp)
            out = out + self.residual_2(out)
            out = out + self.residual_3(out)
            g = self.aspp_0(out.mean(dim=(2, 3), keepdim=True))
            cat = torch.cat([g.expand(-1, -1, h, w), self.aspp_1(out),
                             self.aspp_2(out), self.aspp_3(out),
                             self.aspp_4(out)], dim=1)
            logits = self.layer7(self.layer6(cat))
        logits = nhwc(logits).reshape(b, q, h, w, -1)
        return output_resize(logits, out_hw)
