"""Carry the JAX package's weights into the port.

``state_dict_from_jax(params, batch_stats)`` takes the nested numpy trees
of a ``pemp_tpu`` PEMP stage-1, PEMP stage-2, Baseline or PANet model
(``variables["params"]`` and ``variables["batch_stats"]``) and returns the
port's ``state_dict``:

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
- ``ctr`` is copied as is.

The port's keys are the reference checkpoint's (``encoder.backbone.*``,
``encoder.purifier.*``, ``encoder.projection``, ``ctr``), so a reference
``.pth`` loads too. Stage 2 with ``vgg16`` (``VGG16CM``) has no reference
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


def _module_key(path: Tuple[str, ...], vgg: bool = False) -> str:
    """Flax module path -> the port's module name (``vgg``: the backbone
    is a VGG16 trunk)."""
    top, rest = path[0], path[1:]
    if top == "projection" and not rest:
        return "encoder.projection"
    if top == "backbone" and vgg:
        m = re.fullmatch(r"conv(\d+)", rest[0]) if len(rest) == 1 else None
        if m is None or int(m[1]) >= len(VGG_TORCH_IDX):
            raise KeyError(f"unexpected backbone path {'/'.join(path)}")
        return f"encoder.backbone.features.{VGG_TORCH_IDX[int(m[1])]}"
    if top == "backbone":
        if rest in (("conv1",), ("bn1",)):                   # the stem
            return f"encoder.backbone.{rest[0]}"
        m = re.fullmatch(r"layer(\d+)_(\d+)", rest[0])
        names = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
                 "bn1": "bn1", "bn2": "bn2", "bn3": "bn3",
                 "downsample_conv": "downsample.0",
                 "downsample_bn": "downsample.1"}
        if m is None or len(rest) != 2 or rest[1] not in names:
            raise KeyError(f"unexpected backbone path {'/'.join(path)}")
        return f"encoder.backbone.layer{m[1]}.{m[2]}.{names[rest[1]]}"
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
    """JAX PEMP stage-1, stage-2, Baseline or PANet ``params`` /
    ``batch_stats`` trees -> the port's ``state_dict`` (float32 tensors;
    ``num_batches_tracked`` 0)."""
    sd: Dict[str, torch.Tensor] = {}
    vgg = "conv0" in params.get("backbone", {})

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
        key = _module_key(path[:-2], vgg)
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
        key = _module_key(path[:-2], vgg)
        put(f"{key}.{'running_mean' if path[-1] == 'mean' else 'running_var'}",
            leaf)
    return sd
