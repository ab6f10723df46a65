"""Model registry: name -> (``net`` config dataclass, builder).

Counterpart of ``pemp_tpu/models/registry.py``. A builder turns a
top-level ``Config`` (its ``net`` scope installed) into the model on the
CPU, in the ``dev.precision`` compute dtype, with the init of its
constructor (the entries re-draw it from ``seed`` or load a checkpoint).
The frozen parameters are each model's ``FROZEN`` module types, so no
pattern list comes back. ``pemp_stage2`` builds stage 2 alone: the
cascade's frozen stage 1 is the stage-2 entry's to load.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from pemp_tpu_torch.models import baseline as _baseline
from pemp_tpu_torch.models import canet as _canet
from pemp_tpu_torch.models import panet as _panet
from pemp_tpu_torch.models import pemp_stage1 as _s1
from pemp_tpu_torch.models import pemp_stage2 as _s2
from pemp_tpu_torch.models import pfenet as _pfenet
from pemp_tpu_torch.models import rpmms as _rpmms

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
NOT_PORTED = ()


def _dtype(cfg) -> torch.dtype:
    if cfg.dev.precision not in DTYPES:
        raise ValueError(f"dev.precision={cfg.dev.precision!r} (bf16 | f32)")
    return DTYPES[cfg.dev.precision]


def build_baseline(cfg):
    net = cfg.net
    return _baseline.Baseline(
        backbone=net.backbone, out_channels=net.out_channels,
        dist_scalar=net.dist_scalar, compute_dtype=_dtype(cfg))


def build_panet(cfg):
    net = cfg.net
    return _panet.PANet(
        backbone=net.backbone, out_channels=net.out_channels,
        dist_scalar=net.dist_scalar, compute_dtype=_dtype(cfg))


def build_pemp_stage1(cfg):
    net = cfg.net
    return _s1.PEMPStage1(
        backbone=net.backbone, out_channels=net.out_channels,
        protos=net.protos, drop_rate=net.drop_rate,
        block_size=net.block_size, dist_scalar=net.dist_scalar,
        init_channels=net.init_channels, compute_dtype=_dtype(cfg))


def build_pemp_stage2(cfg):
    net = cfg.net
    return _s2.PEMPStage2(
        backbone=net.backbone2 or net.backbone, out_channels=net.out_channels,
        protos=net.protos2, drop_rate=net.drop_rate2,
        dist_scalar=net.dist_scalar, compute_dtype=_dtype(cfg))


def build_canet(cfg):
    net = cfg.net
    return _canet.CaNet(
        drop_rate=net.drop_rate, use_history=net.history,
        freeze_backbone=net.freeze_backbone, compute_dtype=_dtype(cfg))


def build_rpmms(cfg):
    return _rpmms.RPMMs(drop_rate=cfg.net.drop_rate,
                        compute_dtype=_dtype(cfg))


def build_pfenet(cfg):
    return _pfenet.PFENet(shot=cfg.shot, compute_dtype=_dtype(cfg))


REGISTRY: Dict[str, Tuple[Any, Callable]] = {
    "baseline": (_baseline.NetConfig, build_baseline),
    "panet": (_panet.NetConfig, build_panet),
    "pemp_stage1": (_s1.NetConfig, build_pemp_stage1),
    "pemp_stage2": (_s1.NetConfig, build_pemp_stage2),
    "canet": (_canet.NetConfig, build_canet),
    "rpmms": (_rpmms.NetConfig, build_rpmms),
    "pfenet": (_pfenet.NetConfig, build_pfenet),
}


def _entry(name: str) -> Tuple[Any, Callable]:
    if name in NOT_PORTED:
        raise NotImplementedError(f"model '{name}' is not ported yet")
    if name not in REGISTRY:
        raise KeyError(f"unknown model '{name}' "
                       f"[{', '.join(sorted(REGISTRY) + list(NOT_PORTED))}]")
    return REGISTRY[name]


def net_config(name: str):
    """A fresh ``net`` scope of model ``name``."""
    return _entry(name)[0]()


def build(name: str, cfg) -> torch.nn.Module:
    """Model ``name`` as ``cfg`` configures it, on the CPU."""
    return _entry(name)[1](cfg)
