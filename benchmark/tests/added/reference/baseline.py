"""Plain reference of the Baseline family (Jarvis73/PEMP
``networks/baseline.py``, ResNet-50): the three-stage dilated trunk and
a 1x1 projection, each support's fg and bg prototype pooled from its
features upsampled (bilinear, aligned corners) to the mask's size, their
mean over the shots, and the cosine times ``dist_scalar`` of every
query pixel to each. The trunk, the metrics, the optimizer and the
dropout hook are the PEMP reference's."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark import weights
from benchmark.reference import pemp
from benchmark.reference.pemp import (  # noqa: F401  (the interface)
    answers, exact_f32, logits, optimizer, set_generator, state_keys,
    train_step,
)
from benchmark.traffic import sub_seed

POOL_EPS = 1e-5


class Baseline(nn.Module):
    def __init__(self, layers, out_channels=512, dist_scalar=20.0):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.backbone = pemp.ResNet(layers)
        self.encoder.projection = pemp.Conv(1024, out_channels, 1)
        self.scalar = dist_scalar

    def forward(self, sup_img, sup_mask, qry_img, out_hw="input"):
        b, s, big_h, big_w, _ = sup_img.shape
        x = torch.cat([sup_img, qry_img], 1).reshape(-1, big_h, big_w, 3)
        fts = self.encoder.projection(self.encoder.backbone(
            x.permute(0, 3, 1, 2).contiguous()))
        c, h, w = fts.shape[1:]
        fts = fts.reshape(b, -1, c, h, w)
        up = F.interpolate(fts[:, :s].reshape(b * s, c, h, w),
                           (big_h, big_w), mode="bilinear",
                           align_corners=True).reshape(b, s, c, big_h, big_w)

        def pool(m):                                    # [B,S,H,W] -> [B,c]
            num = (up * m[:, :, None]).sum((-1, -2))
            return (num / (m.sum((-1, -2))[..., None] + POOL_EPS)).mean(1)
        protos = torch.stack([pool(sup_mask[..., 1]), pool(sup_mask[..., 0])],
                             1)                         # [B, 2, c]: bg, fg
        qry = fts[:, s:].permute(0, 1, 3, 4, 2).reshape(b, -1, h * w, c)
        out = (pemp.cosine(qry, protos[:, None]) * self.scalar).reshape(
            b, -1, h, w, 2)
        if out_hw is None:
            return out
        return pemp.upsample(out, (big_h, big_w) if out_hw == "input"
                             else out_hw)

    def trainable(self) -> Dict[str, nn.Parameter]:
        return dict(self.named_parameters())


def build(cfg: Dict, device=None, precision: str = "f32") -> nn.Module:
    m = cfg["model"]
    model = Baseline(tuple(m["resnet_layers"]), m["out_channels"],
                     m["dist_scalar"])
    if device is not None:
        model = model.to(device)
    return pemp.set_precision(model, precision)


def seeded_state(cfg: Dict, seed: int, episodes: Dict, device
                 ) -> Dict[str, torch.Tensor]:
    """Drawn as the PEMP reference draws, without its calibration."""
    with torch.device("meta"):
        layout = state_keys(build(cfg))
    return weights.draw(layout, sub_seed(seed, 0), device,
                        norm_gain=lambda module: pemp.RESIDUAL_GAIN
                        if module.endswith(".bn3") else 1.0)
