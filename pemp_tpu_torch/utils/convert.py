"""Carry the JAX package's weights into the port.

``state_dict_from_jax(params, batch_stats)`` takes the nested numpy trees
of a ``pemp_tpu`` PEMP stage-1, PEMP stage-2, Baseline, PANet, CaNet,
RPMMs or PFENet model (``variables["params"]`` and
``variables["batch_stats"]``) and returns the port's ``state_dict``:

- Flax convs live under ``.../<name>/Conv_0/{kernel,bias}``; kernels go
  from HWIO to OIHW;
- a VGG16 trunk (a tree with ``backbone/conv0``) has its 13 convs
  ``backbone/conv{i}`` at torchvision's ``encoder.backbone.features.{j}``,
  j = 0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28
  (``tools/export_reference_ckpt.py:81-86``); Baseline's and PANet's
  ResNet-50 ``projection`` becomes ``encoder.projection``
  (``export_reference_ckpt.py:165-169``);
- Flax BatchNorms live under ``.../<name>/BatchNorm_0/{scale,bias}`` and
  ``batch_stats .../BatchNorm_0/{mean,var}``; they become
  ``weight/bias/running_mean/running_var`` (plus ``num_batches_tracked``);
- stage 2's communication modules' ``backbone/cm{i}/linear/{kernel,bias}``
  become ``encoder.backbone.linear{i}.{weight (kernel transposed), bias}``
  (``tools/export_reference_ckpt.py:195-200``), its purifier's
  ``aspp/aspp_k`` convs ``encoder.purifier.6.aspp_k.0``;
- ``ctr`` is copied as is;
- CaNet (a tree with ``residual_1``): the trunk at ``encoder.*`` (not
  ``encoder.backbone.*``), ``layer5``, ``layer55``, ``aspp_{k}`` and
  ``layer6``'s ``conv`` at ``<name>.0``, ``residual_{i}/conv{1,2}`` at
  ``residual_{i}.{1,3}``, ``layer7`` as is;
- RPMMs (a tree with ``residule1``): the trunk at ``model_res.*``,
  ``layer5_conv``/``layer5_bn`` at ``layer5.{0,1}``,
  ``layer{55,56,7}_conv`` at ``layer{55,56,7}.0``, ``layer6/aspp_{k}`` at
  ``layer6.aspp_{k}.0``, ``residule{i}/conv{1,2}`` at
  ``residule{i}.{1,3}``, ``layer9`` as is;
- PFENet (a tree with ``down_query_conv``): ``backbone/stem_convs_{j}`` and
  ``stem_bns_{j}`` at ``layer0.{3j}`` and ``layer0.{3j+1}``,
  ``backbone/layer{s}_{b}`` at ``layer{s}.{b}``, ``down_{query,supp}_conv``
  at ``down_{query,supp}.0``, ``init_merge_{i}`` and ``alpha_conv_{i}`` at
  ``<name>.{i}.0``, ``beta_conv_{i}_{j}`` at ``beta_conv.{i}.{2j}``,
  ``res1`` at ``res1.0``, ``res2_{j}`` at ``res2.{2j}``, the heads
  ``inner_cls_{i}`` and ``cls`` (``conv``, ``cls``) at
  ``inner_cls.{i}.{0,3}`` and ``cls.{0,3}``
  (``tools/export_reference_ckpt.py:94-160``).

The port's keys are the reference checkpoint's (``encoder.backbone.*``,
``encoder.purifier.*``, ``encoder.projection``, ``ctr`` and the three
layouts above), so a reference ``.pth`` loads too. An unknown path
raises ``KeyError``. Stage 2 with ``vgg16`` (``VGG16CM``) has no reference
layout (the JAX exporter refuses it); the port's is VGG16's and
ResNetCM's together: the convs ``backbone/conv{i}`` at
``encoder.backbone.features.{j}`` as above (``conv0`` takes 4 channels,
``conv{2,4,7,10}`` 2 more than VGG16's), the CMs ``backbone/cm{k}/linear``
at ``encoder.backbone.linear{k}``, k = 1..4, and ``ctr``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from pemp_tpu_torch.models.backbones import VGG_TORCH_IDX


# the trunk's prefix in the port's state_dict, per tree layout
TRUNK = {"vgg16": "encoder.backbone", "resnet": "encoder.backbone",
         "canet": "encoder", "rpmms": "model_res", "pfenet": ""}
BLOCK_NAMES = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
               "bn1": "bn1", "bn2": "bn2", "bn3": "bn3",
               "downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}


def layout(params: Mapping) -> str:
    """The tree's layout, told apart by a top-level key only that family
    has: ``canet``, ``rpmms``, ``pfenet``, ``vgg16`` (a VGG16 trunk), else
    ``resnet`` (the PEMP stages, Baseline and PANet)."""
    if "residual_1" in params or "layer55" in params:
        return "canet"
    if "residule1" in params:
        return "rpmms"
    if "down_query_conv" in params:
        return "pfenet"
    return "vgg16" if "conv0" in params.get("backbone", {}) else "resnet"


def _backbone_key(path: Tuple[str, ...], kind: str) -> str:
    """Flax ``backbone/...`` path -> the port's module name."""
    rest, pre = path[1:], TRUNK[kind]
    if kind == "vgg16":
        m = re.fullmatch(r"conv(\d+)", rest[0]) if len(rest) == 1 else None
        if m is None or int(m[1]) >= len(VGG_TORCH_IDX):
            raise KeyError(f"unexpected backbone path {'/'.join(path)}")
        return f"{pre}.features.{VGG_TORCH_IDX[int(m[1])]}"
    if kind == "pfenet":                                # the deep-base stem
        m = re.fullmatch(r"stem_(convs|bns)_([012])", rest[0])
        if m is not None and len(rest) == 1:
            return f"layer0.{3 * int(m[2]) + (m[1] == 'bns')}"
    elif rest in (("conv1",), ("bn1",)):                # the stem
        return f"{pre}.{rest[0]}"
    m = re.fullmatch(r"layer(\d+)_(\d+)", rest[0])
    if m is None or len(rest) != 2 or rest[1] not in BLOCK_NAMES:
        raise KeyError(f"unexpected backbone path {'/'.join(path)}")
    key = f"layer{m[1]}.{m[2]}.{BLOCK_NAMES[rest[1]]}"
    return f"{pre}.{key}" if pre else key


def _head_key(path: Tuple[str, ...], kind: str) -> str:
    """Flax head path of CaNet, RPMMs or PFENet -> the port's module
    name (``tools/export_reference_ckpt.py:94-160``)."""
    p = "/".join(path)
    if kind == "canet":
        m = re.fullmatch(r"(layer5|layer55|aspp_[0-4]|layer6)/conv", p)
        if m is not None:
            return f"{m[1]}.0"
        m = re.fullmatch(r"(residual_[123])/conv([12])", p)
        if m is not None:
            return f"{m[1]}.{2 * int(m[2]) - 1}"
        if p == "layer7":
            return p
    elif kind == "rpmms":
        m = re.fullmatch(r"(layer5|layer55|layer56|layer7)_(conv|bn)", p)
        if m is not None and (m[2] == "conv" or m[1] == "layer5"):
            return f"{m[1]}.{int(m[2] == 'bn')}"
        m = re.fullmatch(r"layer6/(aspp_[0-4])", p)
        if m is not None:
            return f"layer6.{m[1]}.0"
        m = re.fullmatch(r"(residule[123])/conv([12])", p)
        if m is not None:
            return f"{m[1]}.{2 * int(m[2]) - 1}"
        if p == "layer9":
            return p
    elif kind == "pfenet":
        m = re.fullmatch(r"(down_query|down_supp)_conv", p)
        if m is not None:
            return f"{m[1]}.0"
        m = re.fullmatch(r"(init_merge|alpha_conv)_(\d+)|res1", p)
        if m is not None:
            return f"{m[1]}.{m[2]}.0" if m[1] else "res1.0"
        m = re.fullmatch(r"beta_conv_(\d+)_([01])|res2_([01])", p)
        if m is not None:
            return (f"beta_conv.{m[1]}.{2 * int(m[2])}" if m[1]
                    else f"res2.{2 * int(m[3])}")
        m = re.fullmatch(r"(?:inner_cls_(\d+)|cls)/(conv|cls)", p)
        if m is not None:
            idx = "0" if m[2] == "conv" else "3"
            return f"inner_cls.{m[1]}.{idx}" if m[1] else f"cls.{idx}"
    raise KeyError(f"unexpected parameter path {p}")


def _module_key(path: Tuple[str, ...], kind: str = "resnet") -> str:
    """Flax module path -> the port's module name in layout ``kind``."""
    top, rest = path[0], path[1:]
    if top == "backbone":
        return _backbone_key(path, kind)
    if kind in ("canet", "rpmms", "pfenet"):
        return _head_key(path, kind)
    if top == "projection" and not rest:
        return "encoder.projection"
    if top == "purifier":
        if rest in (("conv1",), ("conv2",)):
            return f"encoder.purifier.{'0' if rest[0] == 'conv1' else '3'}"
        if len(rest) == 2 and rest[0] == "aspp":
            if rest[1] == "layer6":
                return "encoder.purifier.6.layer6"
            if re.fullmatch(r"aspp_\d", rest[1]):               # stage 2
                return f"encoder.purifier.6.{rest[1]}.0"
            m = re.fullmatch(r"(aspp_\d)_(bn|conv)", rest[1])
            if m is not None:
                idx = "0" if m[2] == "bn" else "2"
                return f"encoder.purifier.6.{m[1]}.{idx}"
    raise KeyError(f"unexpected parameter path {'/'.join(path)}")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for name, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(node)


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """JAX PEMP stage-1, stage-2, Baseline, PANet, CaNet, RPMMs or PFENet
    ``params`` / ``batch_stats`` trees -> the port's ``state_dict``
    (float32 tensors; ``num_batches_tracked`` 0)."""
    sd: Dict[str, torch.Tensor] = {}
    kind = layout(params)

    def put(key, value):
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    for path, leaf in _leaves(params):
        if path == ("ctr",):
            put("ctr", leaf)
            continue
        layer, name = path[-2], path[-1]
        cm = re.fullmatch(r"backbone/cm(\d)/linear/(kernel|bias)",
                          "/".join(path))
        if cm is not None:
            key = f"encoder.backbone.linear{cm[1]}"
            if cm[2] == "kernel":
                put(f"{key}.weight", leaf.T)
            else:
                put(f"{key}.bias", leaf)
            continue
        key = _module_key(path[:-2], kind)
        if layer == "Conv_0":
            put(f"{key}.{'weight' if name == 'kernel' else 'bias'}",
                leaf.transpose(3, 2, 0, 1) if name == "kernel" else leaf)
        elif layer == "BatchNorm_0":
            put(f"{key}.{'weight' if name == 'scale' else 'bias'}", leaf)
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"unexpected parameter path {'/'.join(path)}")
    for path, leaf in _leaves(batch_stats):
        if path[-2] != "BatchNorm_0":
            raise KeyError(f"unexpected batch_stats path {'/'.join(path)}")
        key = _module_key(path[:-2], kind)
        put(f"{key}.{'running_mean' if path[-1] == 'mean' else 'running_var'}",
            leaf)
    return sd
