"""PFENet: a training-free prior and a feature enrichment pyramid.

Counterpart of ``pemp_tpu/models/pfenet.py`` (reference networks/pfenet.py
and pfe_resent.py):

- a deep-base ResNet-50 v2 trunk (``ResNet50V2Trunk``): three 3x3 stem
  convs (64 stride 2, 64, 128) and a floor-mode max pool (3, 2, 1) in
  ``layer0``; torchvision bottlenecks with the stride and dilation on
  conv2 (``BottleNeckV2``); layer3 and layer4 at stride 1 with dilation 2
  and 4. It runs without gradient and, in training, in train mode, in the
  JAX package's order (each call updates the BN running stats): the
  query through four stages, then per shot the support through three,
  then ``layer4`` alone on the masked support layer3;
- the prior (reference :201-231): the cosine of every query layer-4
  pixel with every masked support layer-4 pixel, ``sim / (|s| |q| +
  1e-7)`` (the eps added, not a max), the max over the support pixels,
  min-max normalised; float32 with TF32 off;
- the enrichment pyramid over ``ppm_scales`` (60, 30, 15, 8) with
  ``alpha_conv`` from the second bin on and an auxiliary head per bin
  (reference :242-265), then ``res1``, ``res2`` and the ``cls`` head.

``forward`` returns the logits and the per-bin auxiliary logits, at
``out_hw`` (the input size by default; None keeps feature resolution).
The convolutions run under bf16 autocast when ``compute_dtype`` is bf16;
the prior, the prototypes, the pools and the resizes in float32. PFENet
is its trunk plus the head, so the trunk's modules sit at the top of its
``state_dict`` as in the reference checkpoint: ``layer0.{0,1,3,4,6,7}``,
``layer{1..4}.{i}.*``, ``down_query.0``, ``down_supp.0``,
``init_merge.{i}.0``, ``alpha_conv.{i}.0``, ``beta_conv.{i}.{0,2}``,
``inner_cls.{i}.{0,3}``, ``res1.0``, ``res2.{0,2}``, ``cls.{0,3}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.models.common import FewShotModel, autocast, nchw, nhwc
from pemp_tpu_torch.models.layers import BatchNorm, Conv, Dropout2d
from pemp_tpu_torch.ops.dtypes import f32up
from pemp_tpu_torch.ops.prototypes import masked_average_pooling
from pemp_tpu_torch.ops.resize import resize_bilinear_align_corners

# (planes, stride, dilation) of layer1-layer4 (reference pfenet.py:68-77)
V2_PLAN = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
V2_LAYERS = (3, 4, 6, 3)
PRIOR_EPS = 1e-7
GAP_EPS = 0.0005


@dataclass
class NetConfig:
    """PFENet has no reference net ingredient; kept for CLI uniformity."""
    init_channels: int = 3
    backbone: str = "resnet50v2"


class BottleNeckV2(nn.Module):
    """torchvision bottleneck: the stride and dilation on conv2."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = Conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=d,
                          dilation=d, bias=False)
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


class ResNet50V2Trunk(nn.Module):
    """The deep-base ResNet-50 v2: ``layer0`` (the stem and its pool) and
    ``layer1``-``layer4``; ``layers`` blocks per stage (tests build
    ``(1, 1, 1, 1)``)."""

    def __init__(self, layers: Sequence[int] = V2_LAYERS):
        super().__init__()
        self.layer0 = nn.Sequential(
            Conv(3, 64, 3, stride=2, padding=1, bias=False), BatchNorm(64),
            nn.ReLU(),
            Conv(64, 64, 3, padding=1, bias=False), BatchNorm(64), nn.ReLU(),
            Conv(64, 128, 3, padding=1, bias=False), BatchNorm(128),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1))           # floor mode (reference :118)
        inplanes = 128
        for si, ((planes, stride, dil), blocks) in enumerate(
                zip(V2_PLAN, layers), 1):
            stage = []
            for bi in range(blocks):
                use_ds = bi == 0 and (stride != 1 or inplanes != planes * 4
                                      or dil in (2, 4))
                stage.append(BottleNeckV2(inplanes, planes,
                                          stride if bi == 0 else 1, dil,
                                          use_downsample=use_ds))
                inplanes = planes * 4
            setattr(self, f"layer{si}", nn.Sequential(*stage))

    def trunk(self) -> List[nn.Module]:
        return [self.layer0, self.layer1, self.layer2, self.layer3,
                self.layer4]

    def features(self, x: torch.Tensor, stages: int = 4
                 ) -> List[torch.Tensor]:
        """NCHW images -> the outputs of layer1..layer``stages``."""
        x = self.layer0(x)
        feats = []
        for layer in self.trunk()[1:stages + 1]:
            x = layer(x)
            feats.append(x)
        return feats


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d(out_size)`` of NCHW ``x`` in (at least)
    float32; the identity at the same size (the JAX package's
    integral-image emulation of that pool)."""
    if tuple(x.shape[-2:]) == (out_size, out_size):
        return x
    return F.adaptive_avg_pool2d(f32up(x), out_size)


def weighted_gap(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked global average (reference Weighted_GAP :15-20):
    sum(x m) / (sum(m) + 0.0005). feat [N,h,w,c], mask [N,h,w,1] ->
    [N, c]."""
    n, h, w, c = feat.shape
    feat = f32up(feat)
    return masked_average_pooling(feat.reshape(n, h * w, c),
                                  mask.reshape(n, h * w).to(feat.dtype),
                                  eps=GAP_EPS)


def prior_mask(q4: torch.Tensor, s4_masked: torch.Tensor,
               mask4: torch.Tensor) -> torch.Tensor:
    """The training-free prior [B, h, w, 1] of query layer-4 features q4
    [B, h, w, ch] against the masked support layer-4 s4_masked, masked
    again by mask4 [B, h, w, 1] (reference :201-231)."""
    b, hh, ww, ch = q4.shape
    qf = q4.reshape(b, hh * ww, ch)
    sf = (s4_masked * mask4).reshape(b, hh * ww, ch)
    qn = torch.linalg.vector_norm(qf, dim=-1)[:, None, :]      # [B,1,nq]
    sn = torch.linalg.vector_norm(sf, dim=-1)[:, :, None]      # [B,ns,1]
    sim = torch.bmm(sf, qf.transpose(1, 2)) / (sn * qn + PRIOR_EPS)
    sim = sim.amax(dim=1)                                       # [B, nq]
    mn = sim.amin(dim=1, keepdim=True)
    mx = sim.amax(dim=1, keepdim=True)
    sim = (sim - mn) / (mx - mn + PRIOR_EPS)
    return sim.reshape(b, hh, ww, 1)


def _relu_conv(inc: int, outc: int, kernel: int = 1) -> List[nn.Module]:
    return [Conv(inc, outc, kernel, padding=kernel // 2, bias=False),
            nn.ReLU()]


class ConvReluDropHead(nn.Sequential):
    """conv3x3 -> ReLU -> Dropout2d -> conv1x1 to the classes (the ``cls``
    and ``inner_cls`` heads, reference :82-87, :124-129); keys ``.0`` and
    ``.3``."""

    def __init__(self, classes: int = 2, drop_rate: float = 0.1):
        super().__init__(*_relu_conv(256, 256, 3), Dropout2d(drop_rate),
                         Conv(256, classes, 1))


class PFENet(ResNet50V2Trunk, FewShotModel):
    """``layers`` overrides the trunk's blocks per stage; ``drop_rates``
    are the heads' rate and ``down_query``/``down_supp``'s. ``trunk()``
    is ``ResNet50V2Trunk``'s: ``layer0``-``layer4``."""

    FROZEN = (nn.Module,)           # the whole trunk (reference :169-174)

    def __init__(self, shot: int = 1,
                 ppm_scales: Tuple[int, ...] = (60, 30, 15, 8),
                 drop_rates: Tuple[float, float] = (0.1, 0.5),
                 compute_dtype: torch.dtype = torch.float32,
                 layers: Sequence[int] = V2_LAYERS):
        super().__init__(layers)
        self.shot = shot
        self.ppm_scales = tuple(ppm_scales)
        self.compute_dtype = compute_dtype
        c = 1024 + 512
        self.down_query = nn.Sequential(*_relu_conv(c, 256),
                                        Dropout2d(drop_rates[1]))
        self.down_supp = nn.Sequential(*_relu_conv(c, 256),
                                       Dropout2d(drop_rates[1]))
        n = len(self.ppm_scales)
        self.init_merge = nn.ModuleList(
            nn.Sequential(*_relu_conv(256 * 2 + 1, 256)) for _ in range(n))
        self.alpha_conv = nn.ModuleList(
            nn.Sequential(*_relu_conv(512, 256)) for _ in range(n - 1))
        self.beta_conv = nn.ModuleList(
            nn.Sequential(*_relu_conv(256, 256, 3), *_relu_conv(256, 256, 3))
            for _ in range(n))
        self.inner_cls = nn.ModuleList(
            ConvReluDropHead(drop_rate=drop_rates[0]) for _ in range(n))
        self.res1 = nn.Sequential(*_relu_conv(256 * n, 256))
        self.res2 = nn.Sequential(*_relu_conv(256, 256, 3),
                                  *_relu_conv(256, 256, 3))
        self.cls = ConvReluDropHead(drop_rate=drop_rates[0])

    def _trunk(self, x: torch.Tensor, stages: int) -> List[torch.Tensor]:
        with torch.no_grad(), autocast(x, self.compute_dtype):
            return [f32up(f) for f in self.features(x, stages)]

    def _layer4(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), autocast(x, self.compute_dtype):
            return f32up(self.layer4(x))

    def forward(self, sup_img, sup_mask, qry_img,
                out_hw: Optional[Tuple[int, int]] = "input"):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg), qry_img
        [B,1,H,W,3] -> (logits [B,1,*out_hw,2], the per-bin auxiliary
        logits, a tuple of the same shape); ``(H - 1) % 8 == 0``."""
        b, s, H, W, _ = sup_img.shape
        q = qry_img.shape[1]
        assert q == 1, "PFENet protocol uses a single query image"
        assert (H - 1) % 8 == 0 and (W - 1) % 8 == 0
        if out_hw == "input":
            out_hw = (H, W)
        dt = self.compute_dtype

        # the query through four stages (no gradient)
        _, q2, q3, q4 = self._trunk(nchw(qry_img.reshape(b, H, W, -1)), 4)
        with autocast(q3, dt):
            query_feat = self.down_query(torch.cat([q3, q2], dim=1))
        h, w = query_feat.shape[-2:]
        h4, w4 = q4.shape[-2:]
        q4 = nhwc(q4)

        supp_feats, corr_masks = [], []
        for i in range(self.shot):
            # float32 whatever the features' dtype, as the JAX package's
            mask = (sup_mask[:, i, :, :, :1] == 1.0).float()
            _, s2, s3 = self._trunk(nchw(sup_img[:, i]), 3)
            mask_f = resize_bilinear_align_corners(mask, s3.shape[-2:])
            # layer4 on the masked layer3, the same weights (reference :193)
            s4 = self._layer4(s3 * nchw(mask_f))
            with autocast(s3, dt):
                feat = self.down_supp(torch.cat([s3, s2], dim=1))
            supp_feats.append(weighted_gap(nhwc(feat), mask_f))
            corr_masks.append(prior_mask(
                q4, nhwc(s4), resize_bilinear_align_corners(mask, (h4, w4))))
        corr = torch.stack(corr_masks, dim=1).mean(dim=1)       # [B,h4,w4,1]
        corr = nchw(resize_bilinear_align_corners(corr, (h, w)))
        supp_feat = sum(supp_feats) / len(supp_feats)           # [B, 256]

        pyramid, aux_outs = [], []
        for idx, bin_ in enumerate(self.ppm_scales):
            qf_bin = adaptive_avg_pool(query_feat, bin_)
            sf_bin = supp_feat[:, :, None, None].expand(b, -1, bin_, bin_)
            cm_bin = resize_bilinear_align_corners(corr, (bin_, bin_),
                                                   spatial_axes=(-2, -1))
            pre = (resize_bilinear_align_corners(
                pyramid[idx - 1], (bin_, bin_), spatial_axes=(-2, -1))
                if idx else None)
            with autocast(query_feat, dt):
                merge = self.init_merge[idx](torch.cat(
                    [qf_bin, sf_bin.to(qf_bin.dtype),
                     cm_bin.to(qf_bin.dtype)], dim=1))
                if idx:
                    merge = self.alpha_conv[idx - 1](torch.cat(
                        [merge, pre.to(merge.dtype)], dim=1)) + merge
                merge = self.beta_conv[idx](merge) + merge
                aux_outs.append(self.inner_cls[idx](merge))
            pyramid.append(resize_bilinear_align_corners(
                merge, (h, w), spatial_axes=(-2, -1)))
        with autocast(query_feat, dt):
            feat = self.res1(torch.cat(
                [p.to(pyramid[0].dtype) for p in pyramid], dim=1))
            feat = self.res2(feat) + feat
            out = self.cls(feat)

        def finish(o):
            o = nhwc(o)[:, None]
            if out_hw is None:
                return o
            o = resize_bilinear_align_corners(o[:, 0], out_hw)
            return o.reshape(b, 1, *out_hw, -1)

        return finish(out), tuple(finish(a) for a in aux_outs)
