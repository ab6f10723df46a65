"""The training loop (single process).

Counterpart of ``Trainer`` in ``pemp_tpu/core/trainer.py:227-583``
(reference core/base_trainer.py:183-308):

- the epoch loop: fresh tasks each epoch, one optimizer step per batch,
  the LR schedule advanced per step (cosine, poly) or per epoch;
- ``ckpt.pt`` every ``tr.ckpt_epoch`` epochs and ``bestckpt.pt`` on the
  best online-eval mIoU; a final ``ckpt.pt`` records the reached epoch;
- ``resume`` restores weights, optimizer state (momentum), the epoch and
  the LR schedule from the run's ``ckpt.pt``;
- ``GracefulStop``: SIGTERM/SIGUSR1 stop the loop at a step boundary
  through a final snapshot of the last completed epoch;
- DropBlock draws from a generator seeded ``seed + epoch`` on the device,
  so a resumed epoch replays its masks.

The online eval is the evaluator's fast step under ``model.eval()`` and
``no_grad``; the model returns to ``model.train()`` after it. The JAX
package's ``tpu.fuse_steps``, ``PEMP_PROFILE_DIR`` and multi-host
branches are not ported.
"""

from __future__ import annotations

import logging
import signal
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.evaluator import to_device
from pemp_tpu_torch.utils.timer import Timer


class GracefulStop:
    """Preemption-safe stop request: ``install()`` hooks SIGTERM and
    SIGUSR1 to set ``requested``, which the loop polls at step
    boundaries; ``restore()`` puts the previous handlers back. Off the
    main thread (where Python forbids handlers) it stays a manual flag."""

    SIGNALS = ("SIGTERM", "SIGUSR1")

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def install(self):
        for name in self.SIGNALS:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:      # not the main thread
                break
        return self

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()


class Trainer:
    """Trains ``model`` (already in train mode, frozen parameters marked)
    with ``optimizer`` over ``params``, the parameters that train, through
    the hooks of ``runtime`` (``core/experiment.py``): ``apply_train``
    gives the logits and auxiliary losses on the device arrays
    ``device_keys``, ``compute_loss`` the loss, ``post_step`` (optional)
    sees each step's logits. The checkpoints hold the ``state_dict`` of
    ``weights`` (default ``model``; the stage-2 cascade's is its stage
    2)."""

    def __init__(self, cfg, run, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 params: List[torch.nn.Parameter], runtime,
                 lr_policy: solver.LRPolicy, device: torch.device,
                 logger: Optional[logging.Logger] = None,
                 weights: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.model = model
        self.weights = model if weights is None else weights
        self.optimizer = optimizer
        self.params = params
        self.runtime = runtime
        self.lr_policy = lr_policy
        self.device = device
        self.logger = logger or logging.getLogger(__name__)
        self.do_ckpt = run._id is not None
        root = Path(cfg.g.model_dir)
        self.model_dir = (root / str(cfg.tag) / str(run._id) if self.do_ckpt
                          else root / "None")
        self.best_iou = -1.0
        self.best_epoch = -1
        self.preempted = False
        self.step_losses: List[float] = []     # every step's loss, in order
        nd = len(str(cfg.tr.total_epochs))
        self.template = (f"Epoch: {{:{nd}d}}/{{:{nd}d}}"
                         " | LR: {:.2e} | Train {:7.5f} | Val {:7.5f}"
                         " | mIoU {:5.2f} | bIoU {:5.2f} | Speed: {:.2f}it/s")

    # --- one step -------------------------------------------------------
    def train_step(self, batch) -> torch.Tensor:
        """Forward, loss, backward, clip, optimizer step at the schedule's
        LR, then the runtime's ``post_step`` (if any) with the detached
        logits and the host batch; returns the detached loss (still on
        the device)."""
        t = to_device(batch, self.runtime.device_keys, self.device)
        logits, aux = self.runtime.apply_train(self.model, t)
        loss = self.runtime.compute_loss(logits, t, aux)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        solver.clip_gradients(self.params, self.cfg.tr.grad_clip)
        solver.set_lr(self.optimizer, self.lr_policy.lr)
        self.optimizer.step()
        if self.runtime.post_step is not None:
            self.runtime.post_step(logits.detach(), batch)
        return loss.detach()

    # --- snapshots ------------------------------------------------------
    def _resume_extra(self, lr_state=None):
        """What a resume needs besides weights and optimizer: without it
        a resumed run restarts the schedule and lets a worse epoch
        overwrite bestckpt.pt. ``lr_state`` overrides the live schedule
        (a preemption snapshot records the epoch-boundary state)."""
        return {"best_iou": self.best_iou, "best_epoch": self.best_epoch,
                "lr_policy": (self.lr_policy.state_dict()
                              if lr_state is None else lr_state)}

    def try_snapshot(self, epoch=-1, final=False, lr_state=None):
        if final:
            if self.do_ckpt:
                path = self.model_dir / ckpt_lib.CKPT
            else:
                postfix = time.strftime("%y%m%d-%H%M%S")
                path = self.model_dir / f"ckpt-{postfix}.pt"
        elif (self.do_ckpt and self.cfg.tr.ckpt_epoch > 0
              and epoch % self.cfg.tr.ckpt_epoch == 0):
            path = self.model_dir / ckpt_lib.CKPT
        else:
            return None
        ckpt_lib.save(path, self.weights, self.optimizer, epoch,
                      extra=self._resume_extra(lr_state))
        if final:
            self.logger.info(f" \\_/ Save checkpoint to {path}")
        return path

    def maybe_resume(self) -> int:
        """Restore from this run's ``ckpt.pt`` if present; returns the
        epoch it records (0 without a checkpoint)."""
        path = self.model_dir / ckpt_lib.CKPT
        if not path.exists():
            return 0
        payload = ckpt_lib.load(path)
        self.weights.load_state_dict(payload["model"])
        if payload.get("optimizer"):
            self.optimizer.load_state_dict(payload["optimizer"])
        extra = payload.get("extra", {})
        self.best_iou = float(extra.get("best_iou", self.best_iou))
        self.best_epoch = int(extra.get("best_epoch", self.best_epoch))
        if "lr_policy" in extra:
            self.lr_policy.load_state_dict(extra["lr_policy"])
        epoch = int(payload["epoch"])
        self.logger.info(f"Resumed from {path} at epoch {epoch} "
                         f"(lr {self.lr_policy.lr:.2e}, "
                         f"best mIoU {self.best_iou:.4f})")
        return epoch

    # --- loop -----------------------------------------------------------
    def start_training_loop(self, train_ds, train_loader, evaluator,
                            val_ds, val_loader, num_classes,
                            resume: bool = False):
        timer = Timer()
        if self.do_ckpt:
            self.model_dir.mkdir(parents=True, exist_ok=True)
        start_epoch = self.maybe_resume() if resume else 0
        # keep the epoch task stream aligned with the resumed position
        for _ in range(start_epoch):
            train_ds.sample_tasks()

        stop = GracefulStop().install()
        try:
            for epoch in range(start_epoch + 1, self.cfg.tr.total_epochs + 1):
                # the interrupted epoch replays in full on resume, so a
                # preemption snapshot carries the epoch-boundary LR state
                boundary_lr = self.lr_policy.state_dict()
                train_ds.sample_tasks()
                self.model.set_dropout_generator(torch.Generator(
                    device=self.device).manual_seed(self.cfg.seed + epoch))
                losses = []
                for batch in train_loader:
                    with timer.start():
                        losses.append(self.train_step(batch))
                    self.lr_policy.step_step()
                    self.preempted = stop.requested
                    if self.preempted:
                        break
                # a signal during the epoch tail must not wait an epoch
                self.preempted = self.preempted or stop.requested
                if self.preempted:
                    self.try_snapshot(epoch - 1, final=True,
                                      lr_state=boundary_lr)
                    self.logger.info(
                        f"Graceful stop inside epoch {epoch} - snapshot "
                        f"records completed epoch {epoch - 1}; resume with "
                        "`train with resume=True exp_id=<id>`")
                    return
                # one host fetch of the epoch's losses
                host = torch.stack(losses).double().cpu().tolist() \
                    if losses else []
                self.step_losses.extend(host)
                train_loss = float(np.mean(host)) if host else 0.0
                speed = len(host) / timer.total if timer.total else 0.0
                self.try_snapshot(epoch)
                mloss, miou, biou, best = self.evaluation(
                    epoch, evaluator, val_ds, val_loader, num_classes)
                self.lr_policy.step_epoch(monitor_value=mloss)
                self.log_result(epoch, train_loss, mloss, miou, biou, best,
                                speed)
                timer = Timer()
        finally:
            stop.restore()
        # record the reached epoch: a later resume with a larger
        # total_epochs continues from here
        self.try_snapshot(self.cfg.tr.total_epochs, final=True)

    def evaluation(self, epoch, evaluator, val_ds, val_loader, num_classes):
        self.model.eval()
        try:
            mloss, miou, biou = evaluator.start_eval_loop(val_ds, val_loader,
                                                          num_classes)
        finally:
            self.model.train()
        miou, biou = float(np.mean(miou)), float(np.mean(biou))
        best = False
        if miou > self.best_iou:
            self.best_iou, self.best_epoch = miou, epoch
            if self.do_ckpt:
                ckpt_lib.save(self.model_dir / ckpt_lib.BEST, self.weights,
                              self.optimizer, epoch)
                best = True
        return float(mloss), miou, biou, best

    def log_result(self, epoch, train_loss, val_loss, val_miou, val_biou,
                   best, speed):
        msg = self.template.format(
            epoch, self.cfg.tr.total_epochs, self.lr_policy.lr, train_loss,
            val_loss, val_miou * 100, val_biou * 100, speed)
        self.logger.info(msg + " (best)" * best)
