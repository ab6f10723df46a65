"""Baseline few-shot segmenter: masked-average prototypes + cosine matching.

Counterpart of ``pemp_tpu/models/baseline.py`` (reference
networks/baseline.py): one encoder over the support and query images
(VGG16, or ResNet-50 plus a 1x1 ``projection`` to ``out_channels``) under
bf16 autocast when ``compute_dtype`` is bf16; the support features pooled
against the full-resolution masks (``masked_average_pooling_adjoint``,
the reference's upsample-then-pool without the upsampled tensor), the mean
over shots, dense cosine x ``dist_scalar`` against the one fg and one bg
prototype in class order [bg, fg], and an align-corners upsample of the
logits. Plain PyTorch throughout: the JAX package runs no kernel of its
own here. With ``resnet50`` the backbone BNs are frozen by type.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.backbones import VGG16, ResNet
from pemp_tpu_torch.models.common import (
    RESNET_LAYERS, FewShotModel, output_resize,
)
from pemp_tpu_torch.models.layers import Conv
from pemp_tpu_torch.ops.prototypes import (
    masked_average_pooling_adjoint, prototype_predictions,
)

BACKBONES = ("vgg16", "resnet50")


@dataclass
class NetConfig:
    """Scope ``net`` (reference networks/baseline.py:19-24)."""
    dist_scalar: float = 20.0
    init_channels: int = 3
    backbone: str = "vgg16"         # vgg16 | resnet50
    out_channels: int = 512


class Encoder(nn.Module):
    """VGG16 (512 out), or ResNet-50 and a 1x1 ``projection`` conv to
    ``out_channels``; keys ``encoder.backbone.*`` and
    ``encoder.projection``."""

    def __init__(self, backbone: str, out_channels: int):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"Not supported backbone '{backbone}'. "
                             f"[{', '.join(BACKBONES)}]")
        if backbone == "vgg16":
            self.backbone = VGG16(last_relu=False)
            self.projection = None
        else:
            self.backbone = ResNet(RESNET_LAYERS[backbone])
            self.projection = Conv(self.backbone.out_channels, out_channels, 1)

    def forward(self, x):
        x = self.backbone(x)
        return x if self.projection is None else self.projection(x)


class Baseline(FewShotModel):
    """``state_dict`` keys are the reference's (``encoder.backbone.*``,
    ``encoder.projection``)."""

    def __init__(self, backbone: str = "vgg16", out_channels: int = 512,
                 dist_scalar: float = 20.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = Encoder(backbone, out_channels)
        self.dist_scalar = dist_scalar
        self.compute_dtype = compute_dtype

    def features(self, sup_img, qry_img):
        """[B,S,H,W,3], [B,Q,H,W,3] -> (support [B,S,h,w,c], query
        [B,Q,h*w,c]) in the encoder's dtype."""
        b, s, H, W, _ = sup_img.shape
        imgs = torch.cat([sup_img, qry_img], dim=1)
        # NHWC memory viewed as NCHW: already channels_last, no copy
        imgs = imgs.reshape(-1, H, W, imgs.shape[-1]).permute(0, 3, 1, 2)
        with torch.autocast(imgs.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            fts = self.encoder(imgs)
        # channels_last NCHW -> NHWC is a view; so are the reshape and split
        c, h, w = fts.shape[1:]
        fts = fts.permute(0, 2, 3, 1).reshape(b, -1, h, w, c)
        return fts[:, :s], fts[:, s:].reshape(b, -1, h * w, c)

    def predict(self, sup_fts, qry_fts, sup_mask):
        """Logits [B,Q,h*w,2] of the query from the support's fg/bg
        prototypes, pooled against the full-resolution masks and averaged
        over the shots."""
        fg = masked_average_pooling_adjoint(sup_fts, sup_mask[..., 0])
        bg = masked_average_pooling_adjoint(sup_fts, sup_mask[..., 1])
        return prototype_predictions(qry_fts, fg.mean(dim=1), bg.mean(dim=1),
                                     self.dist_scalar)

    def forward(self, sup_img, sup_mask, qry_img,
                out_hw: Optional[Tuple[int, int]] = "input"):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg), qry_img
        [B,Q,H,W,3] -> logits [B,Q,*out_hw,2] ([bg, fg]); ``out_hw=None``
        keeps feature resolution."""
        b, q = qry_img.shape[:2]
        if out_hw == "input":
            out_hw = tuple(qry_img.shape[2:4])
        sup_fts, qry_fts = self.features(sup_img, qry_img)
        h, w = sup_fts.shape[2:4]
        logits = self.predict(sup_fts, qry_fts, sup_mask)
        return output_resize(logits.reshape(b, q, h, w, 2), out_hw)
