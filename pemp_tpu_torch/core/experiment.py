"""Entry runtime: wires a model family into the ``train`` and ``test``
commands.

Counterpart of ``pemp_tpu/core/experiment.py``'s ``EntryRuntime``:
datasets, the model (from ``models/registry.py``, initialised from
``seed`` or loaded from a checkpoint), the solver, the trainer and the
evaluator, checkpoint discovery and the train -> test chain. What differs
between families goes through the hooks:

- ``build_model(cfg, device)``: the eval-mode model on the device;
- ``weights(model)``: the module whose ``state_dict`` the checkpoints hold;
- ``apply_train(model, batch)``: the train-mode forward, returning the
  logits and a dict of auxiliary losses;
- ``compute_loss(logits, batch, aux)``: the loss the step minimises;
- ``apply_eval(model, batch)``: the eval forward, returning the logits
  (at the query's size or at feature resolution: the eval step resizes);
- ``device_keys``: the batch arrays the steps move to the device;
- ``wrap_data(ds, loader, train)``: wraps the train, online-eval and test
  data (CaNet's history adapter);
- ``post_step(logits, batch)``: optional, after every train step (CaNet's
  history write-back).

The entries under ``pemp_tpu_torch/entry/`` subclass it. The JAX
runtime's mesh, fused-step and pretrained-backbone hooks are not ported.
"""

from __future__ import annotations

import logging
import random
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core import losses as loss_lib
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.evaluator import (
    ARRAY_KEYS, Evaluator, make_fast_eval_step,
)
from pemp_tpu_torch.core.trainer import Trainer
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.models import registry


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"pemp_tpu_torch.{name}")
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
    if precision not in registry.DTYPES:
        raise ValueError(f"dev.precision={precision!r} (bf16 | f32)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "f32":
        torch.backends.cudnn.allow_tf32 = False
    return registry.DTYPES[precision]


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


def load_weights(model, path: Path) -> None:
    """Load a ``.pt`` checkpoint (the trainer's ``{"model": ...}`` dict or a
    bare state_dict) into ``model``, every key present."""
    if path.suffix == ".msgpack":
        raise NotImplementedError(
            "reading the JAX package's .msgpack checkpoints is not ported "
            "yet; convert with state_dict_from_jax and torch.save a .pt")
    model.load_state_dict(ckpt_lib.model_state(ckpt_lib.load(path)))


def init_weights(model, cfg) -> None:
    """``model``'s weights from the checkpoint ``cfg.ckpt`` names, or drawn
    from ``cfg.seed`` when it names none."""
    path = find_checkpoint(cfg)
    if path is None:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    else:
        load_weights(model, path)


class EntryRuntime:
    """The ``train`` and ``test`` commands of the registry's model
    ``name``. ``build`` replaces ``build_model`` (an entry module passes
    its own, so that it can be swapped)."""

    name: str = "baseline"
    device_keys = ARRAY_KEYS
    post_step: Optional[Callable] = None

    def __init__(self, cfg, run=None, build: Optional[Callable] = None):
        self.cfg = cfg
        self.run = run
        self.logger = get_logger(cfg.tag)
        self.loss_fn = loss_lib.get(cfg)
        if build is not None:
            self.build_model = build

    # --- hooks (override per family) -----------------------------------
    @classmethod
    def build_model(cls, cfg, device: torch.device) -> torch.nn.Module:
        """The eval-mode model on ``device`` (channels_last), initialised
        from ``cfg.seed`` or loaded from the checkpoint ``cfg.ckpt`` names
        (the trainer's ``{"model": ...}`` dict or a bare state_dict)."""
        set_precision(cfg.dev.precision)
        model = registry.build(cls.name, cfg)
        init_weights(model, cfg)
        return model.to(device, memory_format=torch.channels_last).eval()

    def weights(self, model: torch.nn.Module) -> torch.nn.Module:
        """The module whose ``state_dict`` the checkpoints hold."""
        return model

    def apply_train(self, model, batch) -> tuple:
        """Train-mode forward on device tensors: (logits [B,Q,H,W,2], a dict
        of auxiliary losses)."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"]), {}

    def compute_loss(self, logits, batch, aux: Dict) -> torch.Tensor:
        """The configured loss (``loss``) of the query logits."""
        labels = batch["qry_msk"]
        return self.loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                            labels.reshape(-1, *labels.shape[-2:]))

    def apply_eval(self, model, batch) -> torch.Tensor:
        """Eval forward on device tensors: logits [B,Q,H,W,2] (or [B,Q,h,w,2]
        at feature resolution)."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"])

    def wrap_data(self, ds, loader, train: bool):
        """The (dataset, loader) the runtime reads from ``ds``, ``loader``."""
        return ds, loader

    # --- commands --------------------------------------------------------
    def test(self) -> Dict[str, float]:
        """The ``test`` command: returns loss, mIoU, bIoU (fractions), the
        episodes/s of the eval steps and the device the run used."""
        cfg, logger = self.cfg, self.logger
        device = resolve_device(cfg.dev.device)
        test_ds, test_loader, num_classes = datasets.load(cfg)
        test_ds, test_loader = self.wrap_data(test_ds, test_loader, False)
        model = self.build_model(cfg, device)
        evaluator = Evaluator(cfg, self.eval_step(model, device),
                              datasets.get_val_labels(cfg, cfg.split), logger)
        logger.info(f"Start testing on {device}.")
        loss, miou, biou = evaluator.start_eval_loop(test_ds, test_loader,
                                                     num_classes)
        result = {"loss": float(loss), "miou": float(np.mean(miou)),
                  "biou": float(np.mean(biou)), "fps": evaluator.fps,
                  "device": str(device)}
        logger.info(f"Loss: {result['loss']:.4f}, mIoU: "
                    f"{result['miou'] * 100:.2f}, bIoU: "
                    f"{result['biou'] * 100:.2f}")
        return result

    def train(self) -> Dict:
        """The ``train`` command: ``{"train": <the training summary>}`` plus,
        for a recorded run that was not stopped, ``"test"``: the chained
        ``test`` of ``bestckpt.pt``."""
        result = {"train": self._train()}
        if self.run._id is not None and not result["train"]["preempted"]:
            self.cfg.exp_id, self.cfg.ckpt = self.run._id, ckpt_lib.BEST
            result["test"] = self.test()
        return result

    def eval_step(self, model, device: torch.device) -> Callable:
        return make_fast_eval_step(model, device, self.apply_eval,
                                   self.device_keys)

    def _train(self) -> Dict:
        """Train on the device, with checkpoints of ``weights(model)``;
        returns the run id, every step's loss, the best online-eval mIoU
        and its epoch, and whether a signal stopped it."""
        cfg, run, logger = self.cfg, self.run, self.logger
        device = resolve_device(cfg.dev.device)
        random.seed(cfg.seed)
        np.random.seed(cfg.seed)
        train_ds, train_loader, _ = datasets.load(cfg, "train")
        val_ds, val_loader, num_classes = datasets.load(cfg, "eval_online")
        train_ds, train_loader = self.wrap_data(train_ds, train_loader, True)
        val_ds, val_loader = self.wrap_data(val_ds, val_loader, False)
        model = self.build_model(cfg, device).train()
        params = model.freeze()
        optimizer = solver.make_optimizer(cfg.tr, params)
        lr_policy = solver.LRPolicy(cfg.tr, cfg.tr.total_epochs
                                    * len(train_loader))
        trainer = Trainer(cfg, run, model, optimizer, params, self,
                          lr_policy, device, logger,
                          weights=self.weights(model))
        evaluator = Evaluator(cfg, self.eval_step(model, device),
                              datasets.get_val_labels(cfg, cfg.split), logger,
                              mode="EVAL_ONLINE")
        logger.info(f"Start training on {device}.")
        trainer.start_training_loop(train_ds, train_loader, evaluator, val_ds,
                                    val_loader, num_classes,
                                    resume=cfg.resume)
        what = "Training preempted" if trainer.preempted else "Ending training"
        logger.info(f"========== {what} with id {run._id} ==========")
        return {"run_id": run._id, "losses": trainer.step_losses,
                "best_iou": trainer.best_iou, "best_epoch": trainer.best_epoch,
                "preempted": trainer.preempted, "device": str(device)}
