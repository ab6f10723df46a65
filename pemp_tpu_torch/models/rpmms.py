"""RPMMs: residual prototype mixture models.

Counterpart of ``pemp_tpu/models/rpmms.py`` (reference networks/rpmms.py):

- PMMs (reference :28-141): EM (10 iterations, kappa 20, no gradient,
  float32) clusters the masked support features into k prototypes per
  class (``pmm_em``), starting from a random ``mu0`` (``pmm_mu_init``)
  that the fg and the bg EM share; the query's probability map is a
  softmax over its inner products with the 2k prototypes, summed per
  class in the order [bg, fg] (``pmm_prob_map``);
- a residual pyramid over k in {1, 3, 6} (reference :144-287): the sum of
  ``layer55`` over the k fg prototypes tiled over the query, the
  probability map, ``layer56``, three residual blocks (the first also
  sees the previous stage's softmax, zeros at first), an ASPP without its
  tail (1280 channels), ``layer7`` and the classifier ``layer9``. It
  returns the three stages' logits at feature resolution (61x61 at
  481x481).

The support and the query go through separate trunk calls, support first
(reference :222-225), so train-mode BN statistics are per group and the
running stats update in that order. ``mu0`` is drawn from an explicit
CPU ``torch.Generator`` (the JAX package's ``pmm`` rng stream) and moved
to the device, or given per scale as ``mu_init``. The convolutions run
under bf16 autocast when ``compute_dtype`` is bf16; the EM, the
probability map and the resizes in float32. Keys follow the reference
checkpoint: ``model_res.*``, ``layer5.{0,1}``, ``layer55.0``,
``layer56.0``, ``layer6.aspp_{k}.0``, ``layer7.0``, ``layer9``,
``residule{i}.{1,3}`` (the reference's spelling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.backbones import ResNet
from pemp_tpu_torch.models.canet import ResidualBlock
from pemp_tpu_torch.models.common import (
    RESNET_LAYERS, FewShotModel, autocast, nchw, nhwc, output_resize,
)
from pemp_tpu_torch.models.layers import ASPP, BatchNorm, Conv, Dropout2d
from pemp_tpu_torch.ops.dtypes import f32up
from pemp_tpu_torch.ops.resize import resize_bilinear_align_corners

EM_STAGES = 10
KAPPA = 20.0


@dataclass
class NetConfig:
    """Scope ``net`` (reference networks/rpmms.py:18-25)."""
    dist_scalar: float = 20.0
    init_channels: int = 3
    out_channels: int = 512
    backbone: str = "resnet50"
    protos: int = 3
    drop_rate: float = 0.5


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / (1e-6 + torch.linalg.vector_norm(x, dim=dim, keepdim=True))


def pmm_mu_init(generator: Optional[torch.Generator], c: int, k: int,
                device=None) -> torch.Tensor:
    """``mu0`` [1, c, k]: normal(0, sqrt(2/k)) drawn on the CPU from
    ``generator``, l2-normalised over the channels (reference :41-44),
    then moved to ``device``."""
    mu0 = torch.randn((1, c, k), generator=generator) * math.sqrt(2.0 / k)
    return _l2norm(mu0, 1).to(device)


@torch.no_grad()
def pmm_em(x: torch.Tensor, mu0: torch.Tensor, stage_num: int = EM_STAGES,
           kappa: float = KAPPA) -> torch.Tensor:
    """EM prototypes of ``x`` [B, n, c] from ``mu0`` [1, c, k] -> [B, k, c],
    in (at least) float32."""
    x = f32up(x)
    mu = mu0.to(x.dtype).expand(x.shape[0], -1, -1)
    xt = x.transpose(1, 2)
    for _ in range(stage_num):
        z = torch.softmax(kappa * torch.bmm(x, mu), dim=2)      # E step
        z = z / (1e-6 + z.sum(dim=1, keepdim=True))
        mu = _l2norm(torch.bmm(xt, z), 1)                       # M step
    return mu.transpose(1, 2)


@torch.no_grad()
def pmm_prob_map(query_feature: torch.Tensor, mu_f: torch.Tensor,
                 mu_b: torch.Tensor) -> torch.Tensor:
    """The query's probability map [B, h, w, 2] ([bg, fg]) from
    query_feature [B, h, w, c] and the prototypes mu_f, mu_b [B, k, c]
    (reference :119-141)."""
    b, h, w, c = query_feature.shape
    k = mu_f.shape[1]
    mu = torch.cat([mu_f, mu_b], dim=1)                         # [B, 2k, c]
    x = query_feature.reshape(b, h * w, c)
    p = torch.softmax(torch.bmm(x, mu.transpose(1, 2)), dim=2)
    prob = torch.stack([p[..., k:].sum(dim=-1), p[..., :k].sum(dim=-1)], -1)
    return prob.reshape(b, h, w, 2)


class RPMMs(FewShotModel):
    """``layers`` overrides the ResNet-50 depth (tests build
    ``(1, 1, 1)``)."""

    def __init__(self, drop_rate: float = 0.5,
                 num_pro_list: Tuple[int, ...] = (1, 3, 6),
                 compute_dtype: torch.dtype = torch.float32,
                 layers: Optional[Sequence[int]] = None):
        super().__init__()
        self.num_pro_list = tuple(num_pro_list)
        self.compute_dtype = compute_dtype
        self.model_res = ResNet(layers or RESNET_LAYERS["resnet50"],
                                ret_features=True)
        self.layer5 = nn.Sequential(
            Conv(512 + 1024, 256, 3, padding=2, dilation=2), BatchNorm(256),
            nn.ReLU())
        self.layer55 = nn.Sequential(
            Conv(512, 256, 3, padding=2, dilation=2), nn.ReLU(),
            Dropout2d(drop_rate))
        self.layer56 = nn.Sequential(
            Conv(256 + 2, 256, 3, padding=1), nn.ReLU(), Dropout2d(drop_rate))
        self.residule1 = ResidualBlock(256 + 2)
        self.residule2 = ResidualBlock()
        self.residule3 = ResidualBlock()
        self.layer6 = ASPP(256, 256, 512, drop_rate, tail=False)
        self.layer7 = nn.Sequential(Conv(5 * 256, 256, 1), nn.ReLU(),
                                    Dropout2d(drop_rate))
        self.layer9 = Conv(256, 2, 1)

    def trunk(self) -> List[nn.Module]:
        return [self.model_res]

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] -> relu(BN(conv(concat(layer2, layer3)))) NCHW
        (reference extract_feature_res :256-263), in float32."""
        x = nchw(imgs)
        with autocast(x, self.compute_dtype):
            _, f2, f3 = self.model_res(x)
            return f32up(self.layer5(torch.cat([f2, f3], dim=1)))

    def forward(self, sup_img, sup_mask, qry_img,
                out_hw: Optional[Tuple[int, int]] = None,
                mu_init: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg), qry_img
        [B,1,H,W,3] -> three logits [B,1,h,w,2] (``out_hw`` resizes them).
        ``mu_init``: one [1, c, k] init per scale; otherwise each scale
        draws its own from ``generator`` (a CPU generator; None draws
        from PyTorch's default)."""
        b, s, H, W, _ = sup_img.shape
        q = qry_img.shape[1]
        assert q == 1, "RPMMs protocol uses a single query image"
        # separate calls, support first: per-group BN statistics
        sup_feat = self.encode(sup_img.reshape(b * s, H, W, -1))
        qry_feat = self.encode(qry_img.reshape(b * q, H, W, -1))
        c, h, w = qry_feat.shape[1:]
        sup_flat = nhwc(sup_feat).reshape(b, s * h * w, c)
        qry_nhwc = nhwc(qry_feat).reshape(b, h, w, c)
        # the fg mask resized (align_corners) to feature resolution
        m = resize_bilinear_align_corners(
            sup_mask[..., :1].reshape(b * s, H, W, 1), (h, w))
        m = m.reshape(b, s * h * w, 1).to(sup_flat.dtype)

        pseudo = torch.zeros((b, 2, h, w), dtype=qry_feat.dtype,
                             device=qry_feat.device)
        outs = []
        for idx, k in enumerate(self.num_pro_list):
            # one init per scale, shared by the fg and the bg EM
            mu0 = (mu_init[idx] if mu_init is not None
                   else pmm_mu_init(generator, c, k, qry_feat.device))
            mu_f = pmm_em(sup_flat * m, mu0)
            mu_b = pmm_em(sup_flat * (1.0 - m), mu0)
            prob = nchw(pmm_prob_map(qry_nhwc, mu_f, mu_b))
            with autocast(qry_feat, self.compute_dtype):
                acc = None
                for i in range(k):
                    vec = mu_f[:, i, :, None, None].expand(b, c, h, w)
                    x = self.layer55(torch.cat([qry_feat, vec], dim=1))
                    acc = x if acc is None else acc + x
                x = self.layer56(torch.cat([acc, prob.to(acc.dtype)], dim=1))
                x = x + self.residule1(
                    torch.cat([x, pseudo.to(x.dtype)], dim=1))
                x = x + self.residule2(x)
                x = x + self.residule3(x)
                out = self.layer9(self.layer7(self.layer6(x)))
            pseudo = torch.softmax(f32up(out), dim=1)
            outs.append(nhwc(out).reshape(b, q, h, w, 2))
        if out_hw is not None:
            outs = [output_resize(o, out_hw) for o in outs]
        return tuple(outs)
