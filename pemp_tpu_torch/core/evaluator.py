"""Few-shot evaluation: the on-device eval step and the 5-round loop.

Counterpart of ``Evaluator`` (``pemp_tpu/core/trainer.py:112-224``,
reference core/base_trainer.py:59-102) with the fixed-size-GT fast step
of ``pemp_tpu/core/experiment.py:181-223``: the batch goes to the device,
and logits, align-corners resize (of feature-resolution logits), argmax,
TP/FP/FN counts and the per-episode CE all stay there; one host fetch per
batch brings back the counts and losses. Query GT of another size than
the input (PASCAL's test protocol) is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from pemp_tpu_torch.core.losses import per_episode_cross_entropy
from pemp_tpu_torch.core.metrics import Accumulator, FewShotMetric, tp_fp_fn
from pemp_tpu_torch.models.common import output_resize
from pemp_tpu_torch.utils.timer import Timer

ARRAY_KEYS = ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")


def _forward(model, t):
    return model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])


def to_device(batch, keys, device: torch.device):
    """The arrays ``keys`` of a numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keys}


def make_fast_eval_step(model: torch.nn.Module, device: torch.device,
                        apply: Callable = _forward, keys=ARRAY_KEYS,
                        with_logits: bool = False) -> Callable:
    """batch (numpy) -> (counts [B, 2, 3] int64, losses [B] float64);
    ``apply(model, tensors)`` is the eval forward (default: the model
    called on the support images, masks and query images) on the arrays
    ``keys``. Logits at another size than the query's (feature
    resolution) are resized to it (align_corners) first; ``with_logits``
    also returns ``apply``'s logits as float32 numpy (CaNet's history
    write-back)."""

    @torch.no_grad()
    def step(batch):
        t = to_device(batch, keys, device)
        feat = apply(model, t)                          # [B,Q,h,w,2]
        out_hw = tuple(t["qry_rgb"].shape[2:4])
        logits = (feat if tuple(feat.shape[2:4]) == out_hw
                  else output_resize(feat, out_hw))     # [B,Q,H,W,2]
        labels = t["qry_msk"]                           # [B,Q,H,W]
        b, nq = logits.shape[:2]
        losses = per_episode_cross_entropy(logits.reshape(b, nq, -1, 2),
                                           labels.reshape(b, nq, -1))
        # all Q queries share the episode's fg class: counts add over Q
        counts = tp_fp_fn(logits.argmax(dim=-1), labels).sum(dim=1)
        # one fetch: counts (< 2^53, exact in f64) beside the losses
        host = torch.cat([counts.reshape(b, 6).double(),
                          losses.double()[:, None]], dim=1).cpu().numpy()
        out = host[:, :6].reshape(b, 2, 3).astype(np.int64), host[:, 6]
        if with_logits:
            return (*out, feat.float().cpu().numpy())
        return out

    return step


class Evaluator:
    """The ``te.epochs``-round eval: ``EVAL`` (the final eval, which logs
    the 5-round summary) or ``EVAL_ONLINE`` (the eval after each training
    epoch)."""

    def __init__(self, cfg, step: Callable, val_labels,
                 logger: logging.Logger = None, mode: str = "EVAL"):
        if mode not in ("EVAL_ONLINE", "EVAL"):
            raise ValueError(f"Not supported evaluation mode {mode}")
        self.cfg = cfg
        self.mode = mode
        self.step = step
        self.val_labels = list(val_labels)
        self.logger = logger or logging.getLogger(__name__)
        self.fps = 0.0          # episodes/s over the timed steps

    @staticmethod
    def fmt(array):
        array = np.asarray(array)
        if array.ndim == 0:
            return f"{float(array):5.2f}"
        return "[" + ", ".join(f"{x:5.2f}" for x in array) + "]"

    def start_eval_loop(self, dataset, loader, num_classes: int):
        """``te.epochs`` rounds over freshly drawn episode sets; returns the
        round means (loss, mIoU per val class, bIoU per class)."""
        dataset.reset_sampler()
        timer = Timer()
        accum = Accumulator(loss=[], miou=[], biou=[])
        n_episodes = 0
        for round_i in range(1, self.cfg.te.epochs + 1):
            fs_metric = FewShotMetric(num_classes)
            inner = Accumulator(loss=[])
            dataset.sample_tasks()
            for batch in loader:
                if batch["qry_msk"].shape[-2:] != batch["qry_rgb"].shape[2:4]:
                    raise NotImplementedError(
                        "query GT of another size than the input is not "
                        "ported yet")
                n_episodes += len(batch["cls"])
                with timer.start():
                    counts, losses = self.step(batch)
                fs_metric.update_counts(counts, batch["cls"])
                inner.update(loss=float(np.mean(losses)))
            miou, miou_mean = fs_metric.mIoU(self.val_labels)
            biou, biou_mean = fs_metric.mIoU(self.val_labels, binary=True)
            self.logger.info(
                f"[round {round_i}/{self.cfg.te.epochs}] "
                f"mIoU: {self.fmt(miou * 100)} -> {self.fmt(miou_mean * 100)}"
                f"  |  bIoU: {self.fmt(biou * 100)} -> "
                f"{self.fmt(biou_mean * 100)}")
            accum.update(loss=inner.mean("loss"), miou=miou, biou=biou)

        self.fps = n_episodes / timer.total if timer.total else 0.0
        if self.mode == "EVAL_ONLINE":
            return accum.mean(["loss", "miou", "biou"])
        miou_r, biou_r = accum.mean(["miou", "biou"], axis=0)
        miou_avg, biou_avg = accum.mean(["miou", "biou"])
        self.logger.info("-" * 21 + " Final Results " + "-" * 21)
        self.logger.info(f"| mIoU mean: {self.fmt(miou_r * 100)} ==> "
                         f"{self.fmt(miou_avg * 100)}")
        self.logger.info(f"| bIoU mean: {self.fmt(biou_r * 100)} ==> "
                         f"{self.fmt(biou_avg * 100)}")
        self.logger.info(f"| speed: {self.fps:5.2f} FPS")
        self.logger.info("-" * 57)
        return accum.mean(["loss", "miou", "biou"])
