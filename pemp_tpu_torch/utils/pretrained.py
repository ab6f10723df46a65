"""ImageNet-pretrained trunks from torchvision's checkpoint files.

Counterpart of ``pemp_tpu/utils/torch_convert.py`` (reference
networks/backbones.py:138-157, :249-276, :407-421): the file of the
trunk's name under ``data/`` (``PRETRAINED_FILES``, relative to the
working directory) is written into the model's trunk with the reference
surgery, and a model whose file is absent keeps its seeded weights.

- ResNet-50/101: the stem and stages 1-3 (``stages=3``); the stage-2
  trunk (``ResNetCM``) gets a zero 4th input channel on ``conv1`` (the
  prior) and ``+2`` zero input channels (the CMs' output) on block 0's
  ``conv1`` and ``downsample.0`` in each of layers 1-3;
- VGG16: the 13 convs ``features.{0,2,5,...,28}`` with their biases;
  ``VGG16CM`` gets the zero prior channel on ``features.0`` and ``+2``
  zero channels on the first conv of blocks 2-5;
- the deep-base ResNet-50 v2 (PFENet): the 3-conv stem at
  ``layer0.{0,1,3,4,6,7}`` and all four stages.

The port's modules carry torchvision's key layout, so the surgery is key
selection and zero padding of input channels; every tensor written is
the file's, bit for bit. A BN takes its weight, bias and running
statistics. Keys the trunk does not read (``fc.*``, ``layer4`` of the
ResNets) are ignored.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from pemp_tpu_torch.models.backbones import VGG_TORCH_IDX

PRETRAINED_FILES = {
    "vgg16": "data/vgg16-397923af.pth",
    "resnet50": "data/resnet50-19c8e357.pth",
    "resnet101": "data/resnet101-5d3b4d8f.pth",
    "resnet50v2": "data/resnet50_v2.pth",
}

# the trunk's prefix in each family's state_dict (the reference layouts)
TRUNK_PREFIX = {"canet": "encoder.", "rpmms": "model_res.", "pfenet": ""}
BN_TENSORS = ("weight", "bias", "running_mean", "running_var")
# VGG16's first conv of blocks 2-5 in the flat numbering (conv2, 4, 7, 10)
VGG_BLOCK_FIRSTS = (2, 4, 7, 10)

# (key in the model, key in the file, zero input channels appended)
Plan = Iterator[Tuple[str, str, int]]


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """A torchvision checkpoint on the CPU (a ``"state_dict"`` entry
    unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def _bn(key: str, src: str = "") -> Plan:
    for t in BN_TENSORS:
        yield f"{key}.{t}", f"{src or key}.{t}", 0


def _blocks(trunk: nn.Module, stage: int, sd, cm: int = 0) -> Plan:
    """Block ``layer{stage}.{i}``'s three convs and BNs, and its
    downsample where both the trunk and the file have one; ``cm`` zero
    channels on block 0's ``conv1`` and ``downsample.0``."""
    for bi, block in enumerate(getattr(trunk, f"layer{stage}")):
        key = f"layer{stage}.{bi}"
        for ci in (1, 2, 3):
            yield (f"{key}.conv{ci}.weight", f"{key}.conv{ci}.weight",
                   cm if ci == 1 and bi == 0 else 0)
            yield from _bn(f"{key}.bn{ci}")
        if (block.downsample is not None
                and f"{key}.downsample.0.weight" in sd):
            yield (f"{key}.downsample.0.weight", f"{key}.downsample.0.weight",
                   cm if bi == 0 else 0)
            yield from _bn(f"{key}.downsample.1")


def resnet_plan(trunk: nn.Module, sd, stages: int = 3, cm: int = 0,
                in_channels: int = 3) -> Plan:
    """torchvision ResNet -> the dilated ``ResNet`` / ``ResNetCM``
    (``torch_convert.convert_resnet``)."""
    yield "conv1.weight", "conv1.weight", in_channels - 3
    yield from _bn("bn1")
    for si in range(1, stages + 1):
        yield from _blocks(trunk, si, sd, cm)


def vgg16_plan(cm: int = 0, in_channels: int = 3) -> Plan:
    """torchvision VGG16 ``features`` -> ``VGG16`` / ``VGG16CM``
    (``torch_convert.convert_vgg16``)."""
    for i, ti in enumerate(VGG_TORCH_IDX):
        extra = in_channels - 3 if i == 0 else (
            cm if i in VGG_BLOCK_FIRSTS else 0)
        yield f"features.{ti}.weight", f"features.{ti}.weight", extra
        yield f"features.{ti}.bias", f"features.{ti}.bias", 0


def resnet50v2_plan(trunk: nn.Module, sd) -> Plan:
    """The deep-base ResNet-50 v2 file -> PFENet's ``layer0``-``layer4``
    (``torch_convert.convert_resnet50v2``)."""
    for i in (1, 2, 3):
        yield f"layer0.{3 * i - 3}.weight", f"conv{i}.weight", 0
        yield from _bn(f"layer0.{3 * i - 2}", f"bn{i}")
    for si in (1, 2, 3, 4):
        yield from _blocks(trunk, si, sd)


@torch.no_grad()
def load_into(module: nn.Module, sd: Dict[str, torch.Tensor], plan: Plan,
              prefix: str = "") -> None:
    """Write each planned file tensor, zero-padded on its input channels
    (dim 1), into ``module``'s tensor ``prefix + key``. A shape that does
    not match raises ``ValueError``."""
    own = module.state_dict()
    for key, src_key, extra in plan:
        src = sd[src_key]
        if extra > 0:
            src = torch.cat([src, src.new_zeros(
                src.shape[0], extra, *src.shape[2:])], dim=1)
        dst = own[prefix + key]
        if dst.shape != src.shape:
            raise ValueError(f"shape mismatch at {prefix + key}: "
                             f"{tuple(dst.shape)} vs file {src_key} "
                             f"{tuple(src.shape)}")
        dst.copy_(src)


def trunk_backbone(model_name: str, net) -> str:
    """The trunk whose file a family starts from
    (``torch_convert.try_load_backbone:172-181``)."""
    if model_name == "pemp_stage2":
        return getattr(net, "backbone2", "") or net.backbone
    if model_name == "pfenet":
        return "resnet50v2"
    if model_name in ("canet", "rpmms"):
        return "resnet50"
    return net.backbone


def try_load_backbone(model_name: str, cfg, model: nn.Module,
                      logger: logging.Logger) -> bool:
    """Pretrained init of ``model``'s trunk when its file is on disk;
    otherwise the trunk keeps its seeded weights and a notice is logged.
    Returns whether the file was loaded."""
    backbone = trunk_backbone(model_name, cfg.net)
    path = Path(PRETRAINED_FILES.get(backbone, ""))
    if not path.is_file():
        logger.info(f"[pretrained] {path} not found - backbone "
                    f"'{backbone}' keeps random init")
        return False
    sd = load_state_dict(path)
    prefix = TRUNK_PREFIX.get(model_name, "encoder.backbone.")
    trunk = model.get_submodule(prefix[:-1]) if prefix else model
    stage2 = model_name == "pemp_stage2"
    cm, in_c = (2, 4) if stage2 else (0, 3)
    if backbone in ("resnet50", "resnet101"):
        plan = resnet_plan(trunk, sd, stages=3, cm=cm, in_channels=in_c)
    elif backbone == "vgg16":
        plan = vgg16_plan(cm=cm, in_channels=in_c)
    else:
        plan = resnet50v2_plan(trunk, sd)
    load_into(model, sd, plan, prefix)
    logger.info(f"[pretrained] backbone '{backbone}' initialized from {path}")
    return True
