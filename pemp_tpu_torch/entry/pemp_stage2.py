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
``train`` trains it (SGD, its backbone BNs frozen), records
``ckpt.pt``/``bestckpt.pt`` holding stage 2's weights only, and chains
into ``test``. The gradient clip is 1.1 when ``net.backbone2`` (or, when
empty, ``net.backbone``) is ``vgg16``, and off otherwise (reference
:80-82). ``visualize`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core.experiment import (
    EntryRuntime, get_logger, init_weights, load_weights, set_precision,
)
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade

NAME = "pemp_stage2"

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
ex = Experiment(NAME, base_cfg)


class Stage2Runtime(EntryRuntime):
    name = NAME

    def __init__(self, cfg, run=None, build=None):
        if (cfg.net.backbone2 or cfg.net.backbone) == "vgg16":
            cfg.tr.grad_clip = 1.1      # reference :80-82
        super().__init__(cfg, run, build)

    @classmethod
    def build_model(cls, cfg, device: torch.device) -> PEMPCascade:
        """The eval-mode cascade on ``device`` (channels_last): the frozen
        stage 1 loaded from its snapshot, stage 2 from ``cfg.ckpt`` or
        ``cfg.seed``. Both run at ``dev.precision``."""
        set_precision(cfg.dev.precision)
        stage1 = registry.build("pemp_stage1", cfg)
        path = ckpt_lib.find_snapshot(cfg.g.model_dir,
                                      cfg.s1.tag or "pemp_stage1",
                                      cfg.s1.id, cfg.s1.ckpt)
        load_weights(stage1, path)
        get_logger(cfg.tag).info(f"Stage-1 (frozen) initialized from {path}")
        stage2 = registry.build(NAME, cfg)
        init_weights(stage2, cfg)
        model = PEMPCascade(stage1, stage2)
        return model.to(device, memory_format=torch.channels_last).eval()

    def weights(self, model: PEMPCascade):
        return model.stage2


build_model = Stage2Runtime.build_model


@ex.command
def test(cfg, run):
    return Stage2Runtime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return Stage2Runtime(cfg, run, build_model).train()


@ex.command
def visualize(cfg, run):
    raise SystemExit(f"{NAME} visualize is not yet ported to pemp_tpu_torch")


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
