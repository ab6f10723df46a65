"""PEMP stage-1 entry.

Counterpart of ``entry/pemp_stage1.py`` of the JAX package:

    python -m pemp_tpu_torch.entry.pemp_stage1 train with split=0 \
        data.dataset=SYNTH loss=cedt [dev.device=cpu] [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.pemp_stage1 test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``. ``train`` initialises the
model from ``seed``, trains it (SGD, gradient clip 1.1, the backbone BNs
frozen), records the run into ``g.model_dir/<tag>/<id>/`` and, when the
run is recorded, chains into ``test`` with ``exp_id=<id>
ckpt=bestckpt.pt``. ``test`` initialises the model from ``seed`` or loads
a ``.pt`` checkpoint (the trainer's, or a bare state_dict such as one
written from ``pemp_tpu_torch.utils.convert.state_dict_from_jax``) and
runs the 5-round evaluator. ``visualize`` is not ported yet.
"""

from __future__ import annotations

import logging
import random
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core import losses as loss_lib
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.evaluator import Evaluator, make_fast_eval_step
from pemp_tpu_torch.core.trainer import Trainer
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.models.pemp_stage1 import NetConfig, PEMPStage1

NAME = "pemp_stage1"
PRECISIONS = {"bf16": torch.bfloat16, "f32": torch.float32}

base_cfg = Config(tag=NAME)
base_cfg.net = NetConfig()
base_cfg.tr.grad_clip = 1.1     # reference entry/pemp_stage1.py:63
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
    ``cfg.seed`` or loaded from the checkpoint ``cfg.ckpt`` names (the
    trainer's ``{"model": ...}`` dict or a bare state_dict)."""
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
        model.load_state_dict(ckpt_lib.model_state(ckpt_lib.load(path)))
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


def _train(cfg, run) -> Dict:
    """Train on the device; returns the run id, every step's loss, the
    best online-eval mIoU and its epoch, and whether a signal stopped it."""
    logger = _logger()
    device = resolve_device(cfg.dev.device)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    train_ds, train_loader, _ = datasets.load(cfg, "train")
    val_ds, val_loader, num_classes = datasets.load(cfg, "eval_online")
    model = build_model(cfg, device).train()
    params = model.freeze()
    optimizer = solver.make_optimizer(cfg.tr, params)
    lr_policy = solver.LRPolicy(cfg.tr, cfg.tr.total_epochs
                                * len(train_loader))
    trainer = Trainer(cfg, run, model, optimizer, params, loss_lib.get(cfg),
                      lr_policy, device, logger)
    evaluator = Evaluator(cfg, make_fast_eval_step(model, device),
                          datasets.get_val_labels(cfg, cfg.split), logger,
                          mode="EVAL_ONLINE")
    logger.info(f"Start training on {device}.")
    trainer.start_training_loop(train_ds, train_loader, evaluator, val_ds,
                                val_loader, num_classes, resume=cfg.resume)
    what = "Training preempted" if trainer.preempted else "Ending training"
    logger.info(f"========== {what} with id {run._id} ==========")
    return {"run_id": run._id, "losses": trainer.step_losses,
            "best_iou": trainer.best_iou, "best_epoch": trainer.best_epoch,
            "preempted": trainer.preempted, "device": str(device)}


def run_train(cfg, run) -> Dict:
    """The ``train`` command: ``{"train": <_train's summary>}`` plus, for a
    recorded run that was not stopped, ``"test"``: the chained ``test``
    of ``bestckpt.pt``."""
    result = {"train": _train(cfg, run)}
    if run._id is not None and not result["train"]["preempted"]:
        cfg.exp_id, cfg.ckpt = run._id, ckpt_lib.BEST
        result["test"] = run_test(cfg)
    return result


@ex.command
def test(cfg, run):
    return run_test(cfg)


@ex.command
def train(cfg, run):
    return run_train(cfg, run)


@ex.command
def visualize(cfg, run):
    raise SystemExit(f"{NAME} visualize is not yet ported to pemp_tpu_torch")


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
