"""PEMP stage-2 entry: the prior-enhanced cascade.

Counterpart of ``entry/pemp_stage2.py`` of the JAX package:

    python -m pemp_tpu_torch.entry.pemp_stage2 train with split=0 \
        data.dataset=SYNTH loss=cedt tr.lr=0.0035 s1.id=<stage-1 run id> \
        [s1.ckpt=<file>] [dev.device=cpu] [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.pemp_stage2 test with split=0 \
        data.dataset=SYNTH s1.id=<id> [ckpt=weights.pt] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``. Every step runs the frozen
stage 1 (``net.backbone``, ``net.protos``, ``net.drop_rate``) first; its
argmax is stage 2's query prior (``models/pemp_stage2.py``). Stage 1 comes
from ``s1.ckpt`` as a path, else from
``g.model_dir/<s1.tag or pemp_stage1>/<s1.id>/<s1.ckpt or bestckpt.pt,
ckpt.pt>``, and a missing one raises: it is never drawn from a seed.
Stage 2 (``net.backbone2``, ``net.protos2``, ``net.drop_rate2``) is
initialised from ``seed`` or loaded from ``ckpt``, as in stage 1's entry;
``train`` trains it (SGD, its backbone BNs frozen, no gradient clip: the
JAX entry clips only ``vgg16``, which is not ported), records
``ckpt.pt``/``bestckpt.pt`` holding stage 2's weights only, and chains
into ``test``. ``visualize`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.entry import pemp_stage1 as s1_entry
from pemp_tpu_torch.models.pemp_stage1 import NetConfig, PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade, PEMPStage2

NAME = "pemp_stage2"

base_cfg = Config(tag=NAME)
base_cfg.net = NetConfig()
ex = Experiment(NAME, base_cfg)


def build_model(cfg, device: torch.device) -> PEMPCascade:
    """The eval-mode cascade on ``device`` (channels_last): the frozen
    stage 1 loaded from its snapshot, stage 2 from ``cfg.ckpt`` or
    ``cfg.seed``. Both run at ``dev.precision``."""
    net = cfg.net
    dtype = s1_entry.set_precision(cfg.dev.precision)
    stage1 = PEMPStage1(
        backbone=net.backbone, out_channels=net.out_channels,
        protos=net.protos, drop_rate=net.drop_rate,
        block_size=net.block_size, dist_scalar=net.dist_scalar,
        init_channels=net.init_channels, compute_dtype=dtype)
    path = ckpt_lib.find_snapshot(cfg.g.model_dir, cfg.s1.tag or "pemp_stage1",
                                  cfg.s1.id, cfg.s1.ckpt)
    s1_entry.load_weights(stage1, path)
    s1_entry.get_logger(cfg.tag).info(
        f"Stage-1 (frozen) initialized from {path}")
    stage2 = PEMPStage2(
        backbone=net.backbone2 or net.backbone, out_channels=net.out_channels,
        protos=net.protos2, drop_rate=net.drop_rate2,
        dist_scalar=net.dist_scalar, compute_dtype=dtype)
    s1_entry.init_weights(stage2, cfg)
    model = PEMPCascade(stage1, stage2)
    return model.to(device, memory_format=torch.channels_last).eval()


def _stage2(model: PEMPCascade) -> PEMPStage2:
    return model.stage2


@ex.command
def test(cfg, run):
    return s1_entry.run_test(cfg, build_model)


@ex.command
def train(cfg, run):
    return s1_entry.run_train(cfg, run, build_model, _stage2)


@ex.command
def visualize(cfg, run):
    raise SystemExit(f"{NAME} visualize is not yet ported to pemp_tpu_torch")


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
