"""PEMP stage-1 entry.

Counterpart of ``entry/pemp_stage1.py`` of the JAX package:

    python -m pemp_tpu_torch.entry.pemp_stage1 test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

``test`` builds the model on the device (CUDA unless ``dev.device=cpu``),
initialises it from ``seed`` or loads a ``.pt`` state_dict (for example
one written from ``pemp_tpu_torch.utils.convert.state_dict_from_jax``),
and runs the 5-round evaluator. ``train`` and ``visualize`` are not
ported yet.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.evaluator import Evaluator, make_fast_eval_step
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.models.pemp_stage1 import NetConfig, PEMPStage1

NAME = "pemp_stage1"
PRECISIONS = {"bf16": torch.bfloat16, "f32": torch.float32}

base_cfg = Config(tag=NAME)
base_cfg.net = NetConfig()
ex = Experiment(NAME, base_cfg)


def _logger() -> logging.Logger:
    logger = logging.getLogger(f"pemp_tpu_torch.{NAME}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_precision(precision: str) -> torch.dtype:
    """Backbone compute dtype for ``dev.precision``. The prototype math
    runs in full float32 either way (TF32 off for matmuls); ``f32`` also
    turns TF32 off for the cuDNN convolutions."""
    if precision not in PRECISIONS:
        raise ValueError(f"dev.precision={precision!r} (bf16 | f32)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "f32":
        torch.backends.cudnn.allow_tf32 = False
    return PRECISIONS[precision]


def build_model(cfg, device: torch.device) -> PEMPStage1:
    """The eval-mode model on ``device`` (channels_last), initialised from
    ``cfg.seed`` or loaded from the checkpoint ``cfg.ckpt`` names."""
    net = cfg.net
    model = PEMPStage1(
        backbone=net.backbone, out_channels=net.out_channels,
        protos=net.protos, drop_rate=net.drop_rate,
        block_size=net.block_size, dist_scalar=net.dist_scalar,
        init_channels=net.init_channels,
        compute_dtype=set_precision(cfg.dev.precision))
    path = find_checkpoint(cfg)
    if path is None:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    elif path.suffix == ".msgpack":
        raise NotImplementedError(
            "reading the JAX package's .msgpack checkpoints is not ported "
            "yet; convert with state_dict_from_jax and torch.save a .pt")
    else:
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
    return model.to(device, memory_format=torch.channels_last).eval()


def find_checkpoint(cfg) -> Optional[Path]:
    """``ckpt`` as a path, else ``g.model_dir/<tag>/<exp_id>/<ckpt>``;
    None when no checkpoint is asked for (init from ``seed``)."""
    if not cfg.ckpt:
        return None
    path = Path(cfg.ckpt)
    if not path.exists() and cfg.exp_id >= 0:
        path = Path(cfg.g.model_dir) / str(cfg.tag) / str(cfg.exp_id) / cfg.ckpt
    if not path.exists():
        raise FileNotFoundError(f"checkpoint '{cfg.ckpt}' not found")
    return path


def run_test(cfg) -> Dict[str, float]:
    """The ``test`` command: returns loss, mIoU, bIoU (fractions), the
    episodes/s of the eval steps and the device the run used."""
    logger = _logger()
    device = resolve_device(cfg.dev.device)
    test_ds, test_loader, num_classes = datasets.load(cfg)
    model = build_model(cfg, device)
    evaluator = Evaluator(cfg, make_fast_eval_step(model, device),
                          datasets.get_val_labels(cfg, cfg.split), logger)
    logger.info(f"Start testing on {device}.")
    loss, miou, biou = evaluator.start_eval_loop(test_ds, test_loader,
                                                 num_classes)
    result = {"loss": float(loss), "miou": float(np.mean(miou)),
              "biou": float(np.mean(biou)), "fps": evaluator.fps,
              "device": str(device)}
    logger.info(f"Loss: {result['loss']:.4f}, mIoU: {result['miou'] * 100:.2f}"
                f", bIoU: {result['biou'] * 100:.2f}")
    return result


@ex.command
def test(cfg):
    return run_test(cfg)


@ex.command
def train(cfg):
    raise SystemExit(f"{NAME} train is not yet ported to pemp_tpu_torch")


@ex.command
def visualize(cfg):
    raise SystemExit(f"{NAME} visualize is not yet ported to pemp_tpu_torch")


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
