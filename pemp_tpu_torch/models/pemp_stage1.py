"""PEMP stage 1: meta-prototype few-shot segmenter.

Counterpart of ``pemp_tpu/models/pemp_stage1.py`` (reference
networks/pemp_stage1.py): a 3-stage dilated ResNet-50/101 + ``PurifierV2``
encoder, then the meta-prototype module (mpm) -- soft assignment of the
support pixels to learned centers ``ctr`` [c, 2p], adaptive prototypes,
max-over-p cosine matching -- and an align-corners upsample.

The encoder runs under bf16 autocast when ``compute_dtype`` is bf16 (the
JAX package's ``tpu.precision=bf16``); the mpm and everything after it
run in float32 outside autocast. The mpm goes through the CUDA kernels
(``ops/kernels/mpm.py``) for features on a CUDA device and through the
plain PyTorch version for features on the CPU; with grad enabled it is
the ``MPMChainPacked`` autograd Function.

Training is ``model.train()``: BatchNorms use batch statistics and update
their running stats, DropBlocks drop. ``freeze()`` applies ``FROZEN``:
the backbone BatchNorms keep batch statistics but their affine
parameters do not train (reference backbones.py:56-62). ``PEMPModel``
holds what stage 2 (``models/pemp_stage2.py``) shares with stage 1, and
``predict`` the path from the encoder's features to the logits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.backbones import ResNet
from pemp_tpu_torch.models.common import (
    RESNET_LAYERS, PurifierV2, downsample_masks, output_resize,
)
from pemp_tpu_torch.models.layers import DropBlock, Dropout2d
from pemp_tpu_torch.ops.kernels.mpm import mpm_chain_packed
from pemp_tpu_torch.ops.prototypes import (
    masked_average_pooling, meta_prototype_assign, prototype_predictions,
)
from pemp_tpu_torch.ops.resize import resize_nearest


@dataclass
class NetConfig:
    """Scope ``net`` (reference networks/pemp_stage1.py:21-29 and
    pemp_stage2.py:14-19)."""
    dist_scalar: float = 20.0
    init_channels: int = 3
    out_channels: int = 512
    backbone: str = "resnet50"      # resnet50 | resnet101 (vgg16 not ported)
    protos: int = 3
    drop_rate: float = 0.1
    block_size: int = 4
    # stage 2 (``models/pemp_stage2.py``) reads these; both stages share
    # the scope, as the JAX package's and the reference's do
    backbone2: str = "resnet50"     # resnet50 | resnet101
    protos2: int = 3
    drop_rate2: float = 0.5
    cm: bool = True                 # the JAX package reads it nowhere


def mpm_predict(sup_fts, qry_fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                ret_ind=False):
    """Meta-prototype module + prediction on split features, plain
    PyTorch (reference :165-230). ``ctr`` None (protos == 0) takes plain
    masked-average prototypes (reference :223-228)."""
    if ctr is not None:
        fg_proto, bg_proto = meta_prototype_assign(
            sup_fts, sup_fg, sup_bg, ctr, protos)
        return prototype_predictions(qry_fts, fg_proto, bg_proto,
                                     dist_scalar, return_indices=ret_ind)
    fg_proto = masked_average_pooling(sup_fts, sup_fg).mean(dim=1)
    bg_proto = masked_average_pooling(sup_fts, sup_bg).mean(dim=1)
    logits = prototype_predictions(qry_fts, fg_proto, bg_proto, dist_scalar)
    if ret_ind:
        return logits, torch.zeros(logits.shape, dtype=torch.int32,
                                   device=logits.device)
    return logits


def mpm_predict_packed(fts, s, sup_fg, sup_bg, ctr, protos, dist_scalar,
                       ret_ind=False):
    """``mpm_predict`` on the packed features [B,S+Q,n,c]. With centers
    the support/query split happens inside ``mpm_chain_packed``; without
    (protos == 0) the features are split here."""
    if ctr is not None:
        return mpm_chain_packed(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                                return_indices=ret_ind)
    return mpm_predict(fts[:, :s], fts[:, s:], sup_fg, sup_bg, ctr, protos,
                       dist_scalar, ret_ind=ret_ind)


def response_map(logits, indices, protos):
    """argmax-prototype response map: the bg index where bg wins, the fg
    index + p where fg wins (reference :217-222)."""
    fg_wins = logits.argmax(dim=-1) == 1
    return torch.where(fg_wins, indices[..., 1] + protos, indices[..., 0])


def predict(fts, sup_mask, q, ctr, protos, dist_scalar, out_hw, ret_ind):
    """The encoder's channels_last features [B*(S+Q), c, h, w] -> the mpm
    -> logits [B,Q,*out_hw,2] (and with ``ret_ind`` the response map
    [B,Q,*out_hw]); ``out_hw=None`` keeps feature resolution."""
    b, s = sup_mask.shape[:2]
    c, h, w = fts.shape[1:]
    # channels_last NCHW -> NHWC is a view; so is the reshape
    fts = fts.permute(0, 2, 3, 1).reshape(b, s + q, h * w, c)
    sup_fg, sup_bg = downsample_masks(sup_mask, (h, w))
    out = mpm_predict_packed(fts.contiguous(), s, sup_fg, sup_bg, ctr,
                             protos, dist_scalar, ret_ind=ret_ind)
    if ret_ind:
        logits, indices = out
        logits = logits.reshape(b, q, h, w, 2)
        resp = response_map(logits, indices.reshape(b, q, h, w, 2), protos)
        if out_hw is not None:
            resp = resize_nearest(resp.reshape(b * q, h, w, 1), out_hw)
            resp = resp.reshape(b, q, *out_hw)
        return output_resize(logits, out_hw), resp
    return output_resize(out.reshape(b, q, h, w, 2), out_hw)


class Encoder(nn.Module):
    def __init__(self, backbone: str, out_channels: int, drop_rate: float,
                 block_size: int, init_channels: int = 3, layers=None):
        super().__init__()
        if backbone not in RESNET_LAYERS:
            raise ValueError(f"Not supported backbone '{backbone}' "
                             f"[{', '.join(RESNET_LAYERS)}] (vgg16 is not "
                             "ported yet)")
        self.backbone = ResNet(layers or RESNET_LAYERS[backbone],
                               init_channels)
        self.purifier = PurifierV2(self.backbone.out_channels, out_channels,
                                   drop_rate, block_size)

    def forward(self, x):
        return self.purifier(self.backbone(x))


class PEMPModel(nn.Module):
    """What both PEMP stages share: ``state_dict`` keys in the reference
    checkpoint layout (``encoder.backbone.*``, ``encoder.purifier.*``,
    ``ctr``), the frozen backbone BNs, the init and the dropout
    generator. Subclasses set ``encoder`` and ``ctr``."""

    # module types under ``encoder.backbone`` whose parameters do not
    # train (every ResNet). The JAX package's regex ``backbone/.*bn`` also
    # matches its ``downsample_bn``; here that module is
    # ``layerK.0.downsample.1``, so the rule goes by module type, not by
    # name.
    FROZEN = (nn.BatchNorm2d,)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Re-draw every weight from ``generator`` with torch's default
        inits (conv and linear kaiming-uniform a=sqrt(5) and
        U(+-1/sqrt(fan_in)) bias, BN ones/zeros with fresh running stats)
        and ``ctr`` from U[0,1) like ``torch.rand`` (reference :105)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        if self.ctr is not None:
            self.ctr.uniform_(0.0, 1.0, generator=generator)

    def freeze(self) -> List[nn.Parameter]:
        """``requires_grad=False`` on the parameters of every ``FROZEN``
        module under the backbone (those BNs stay in train mode, so they
        still use and update batch statistics); returns the parameters
        that train."""
        for m in self.encoder.backbone.modules():
            if isinstance(m, self.FROZEN):
                for p in m.parameters(recurse=False):
                    p.requires_grad_(False)
        return [p for p in self.parameters() if p.requires_grad]

    def set_dropout_generator(self, generator: Optional[torch.Generator]
                              ) -> None:
        """The generator every DropBlock and Dropout2d draws from in train
        mode."""
        for m in self.modules():
            if isinstance(m, (DropBlock, Dropout2d)):
                m.generator = generator


class PEMPStage1(PEMPModel):
    """``layers`` overrides the ResNet depth (tests build ``(1, 1, 1)``)."""

    def __init__(self, backbone: str = "resnet50", out_channels: int = 512,
                 protos: int = 3, drop_rate: float = 0.1, block_size: int = 4,
                 dist_scalar: float = 20.0, init_channels: int = 3,
                 compute_dtype: torch.dtype = torch.float32, layers=None):
        super().__init__()
        self.encoder = Encoder(backbone, out_channels, drop_rate, block_size,
                               init_channels, layers)
        self.protos = protos
        self.dist_scalar = dist_scalar
        self.compute_dtype = compute_dtype
        self.ctr = (nn.Parameter(torch.rand(out_channels, 2 * protos))
                    if protos > 0 else None)

    def forward(self, sup_img, sup_mask, qry_img,
                out_hw: Optional[Tuple[int, int]] = "input",
                ret_ind: bool = False):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg),
        qry_img [B,Q,H,W,3] -> logits [B,Q,*out_hw,2] ([bg, fg]); with
        ``ret_ind`` also the response map [B,Q,*out_hw]. ``out_hw=None``
        keeps feature resolution."""
        b, s, H, W, _ = sup_img.shape
        q = qry_img.shape[1]
        if out_hw == "input":
            out_hw = (H, W)
        imgs = torch.cat([sup_img, qry_img], dim=1)
        # NHWC memory viewed as NCHW: already channels_last, no copy
        imgs = imgs.reshape(b * (s + q), H, W, -1).permute(0, 3, 1, 2)
        with torch.autocast(imgs.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            fts = self.encoder(imgs)
        return predict(fts, sup_mask, q, self.ctr, self.protos,
                       self.dist_scalar, out_hw, ret_ind)
