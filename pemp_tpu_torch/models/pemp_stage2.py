"""PEMP stage 2: prior-enhanced refinement with communication modules.

Counterpart of ``pemp_tpu/models/pemp_stage2.py`` (reference
networks/pemp_stage2.py) and of the cascade in ``entry/pemp_stage2.py``:

- ``PEMPStage2``: a 4-channel input, RGB plus a prior (the support's GT fg
  mask, the query's stage-1 prediction), through a ``ResNetCM`` whose
  communication modules pool the prior-masked features of each episode,
  then ``PurifierV1`` (Dropout2d, ASPP), or through a ``VGG16CM`` alone
  (no purifier), under bf16 autocast when ``compute_dtype`` is bf16, then
  the same mpm as stage 1 with its own centers (``protos2``): the CUDA
  kernels for features on the card, the plain version on the CPU,
  ``MPMChainPacked`` with grad;
- ``PEMPCascade``: a frozen ``PEMPStage1`` gives the query prior (its
  argmax at input size, under ``no_grad``), and ``PEMPStage2`` refines.
  In train mode stage 1 runs as the JAX package runs it in training:
  batch-statistics BN and DropBlock, with its BN running-stat updates
  discarded. In eval mode it runs in eval mode. (The reference leaves
  stage 1 in train mode at test time; the JAX package documents why it
  does not, ``entry/pemp_stage2.py:10-14``.)
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.backbones import VGG16CM, ResNetCM
from pemp_tpu_torch.models.common import (
    RESNET_LAYERS, FewShotModel, PurifierV1,
)
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1, predict
from pemp_tpu_torch.utils.profiling import span


class EncoderCM(nn.Module):
    """A ``ResNetCM`` + ``PurifierV1`` (``out_channels`` out), or a
    ``VGG16CM`` alone (512 out)."""

    def __init__(self, backbone: str, out_channels: int, drop_rate: float,
                 layers=None):
        super().__init__()
        if backbone == "vgg16":
            self.backbone = VGG16CM(last_relu=False)
            self.purifier = None
            self.out_channels = self.backbone.out_channels
            return
        if backbone not in RESNET_LAYERS:
            raise ValueError(f"Not supported backbone '{backbone}' "
                             f"[vgg16, {', '.join(RESNET_LAYERS)}]")
        self.backbone = ResNetCM(layers or RESNET_LAYERS[backbone])
        self.purifier = PurifierV1(self.backbone.out_channels, out_channels,
                                   drop_rate)
        self.out_channels = out_channels

    def forward(self, x, prior, spq):
        with span("model.backbone"):
            x = self.backbone(x, prior, spq)
        if self.purifier is None:
            return x
        with span("model.purifier"):
            return self.purifier(x)


class PEMPStage2(FewShotModel):
    """``state_dict`` keys are the reference's (``encoder.backbone.*`` with
    ``linear{1,2,3}``, ``encoder.purifier.{0,3,6}``, ``ctr``; with
    ``vgg16``, ``encoder.backbone.features.*`` and ``linear{1..4}``, the
    layout ``utils/convert.py`` sets out). ``layers`` overrides the ResNet
    depth (tests build ``(1, 1, 1)``)."""

    def __init__(self, backbone: str = "resnet50", out_channels: int = 512,
                 protos: int = 3, drop_rate: float = 0.5,
                 dist_scalar: float = 20.0,
                 compute_dtype: torch.dtype = torch.float32, layers=None):
        super().__init__()
        self.encoder = EncoderCM(backbone, out_channels, drop_rate, layers)
        self.protos = protos
        self.dist_scalar = dist_scalar
        self.compute_dtype = compute_dtype
        self.ctr = (nn.Parameter(torch.rand(self.encoder.out_channels,
                                            2 * protos))
                    if protos > 0 else None)

    def forward(self, sup_img, sup_mask, qry_img, qry_prior,
                out_hw: Optional[Tuple[int, int]] = "input",
                ret_ind: bool = False):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg), qry_img
        [B,Q,H,W,3], qry_prior [B,Q,H,W] float (the stage-1 fg mask) ->
        logits [B,Q,*out_hw,2] ([bg, fg]); with ``ret_ind`` also the
        response map. ``out_hw=None`` keeps feature resolution."""
        b, s, H, W, _ = sup_img.shape
        q = qry_img.shape[1]
        if out_hw == "input":
            out_hw = (H, W)
        prior = torch.cat([sup_mask[..., :1], qry_prior[..., None].float()],
                          dim=1)                              # [B,S+Q,H,W,1]
        x = torch.cat([torch.cat([sup_img, qry_img], dim=1), prior], dim=-1)
        # NHWC memory viewed as NCHW: channels_last, no copy
        x = x.reshape(b * (s + q), H, W, 4).permute(0, 3, 1, 2)
        prior = prior.reshape(b * (s + q), H, W, 1).permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            fts = self.encoder(x, prior, s + q)
        return predict(fts, sup_mask, q, self.ctr, self.protos,
                       self.dist_scalar, out_hw, ret_ind)


@contextmanager
def _batch_stats_discarded(model: nn.Module):
    """BatchNorms in train mode use batch statistics but leave their
    running statistics (and ``num_batches_tracked``) as they are: the JAX
    package's ``mutable=["batch_stats"]`` with the mutations dropped."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.track_running_stats = True


class PEMPCascade(nn.Module):
    """Frozen stage 1 -> argmax -> the query prior of stage 2. Called with
    (sup_img, sup_mask, qry_img) like ``PEMPStage1``. Only ``stage2``
    trains and only its ``state_dict`` is the run's checkpoint."""

    def __init__(self, stage1: PEMPStage1, stage2: PEMPStage2):
        super().__init__()
        self.stage1 = stage1.requires_grad_(False)      # trains nothing
        self.stage2 = stage2

    def freeze(self) -> List[nn.Parameter]:
        """Stage 2's ``freeze()``: its parameters that train."""
        return self.stage2.freeze()

    def set_dropout_generator(self, generator: Optional[torch.Generator],
                              shard=None) -> None:
        """Both stages' dropouts draw from ``generator`` in train mode
        (stage 1 first, each step), over the rows ``shard`` names."""
        self.stage1.set_dropout_generator(generator, shard)
        self.stage2.set_dropout_generator(generator, shard)

    @torch.no_grad()
    def prior(self, sup_img, sup_mask, qry_img) -> torch.Tensor:
        """Stage 1's argmax at input size, float32 [B,Q,H,W]."""
        with span("cascade.prior"):
            if self.stage1.training:
                with _batch_stats_discarded(self.stage1):
                    logits = self.stage1(sup_img, sup_mask, qry_img)
            else:
                logits = self.stage1(sup_img, sup_mask, qry_img)
            return logits.argmax(dim=-1).float()

    def forward(self, sup_img, sup_mask, qry_img,
                out_hw: Optional[Tuple[int, int]] = "input",
                ret_ind: bool = False):
        prior = self.prior(sup_img, sup_mask, qry_img)
        return self.stage2(sup_img, sup_mask, qry_img, prior, out_hw=out_hw,
                           ret_ind=ret_ind)
