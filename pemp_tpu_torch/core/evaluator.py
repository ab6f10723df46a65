"""Few-shot evaluation: the on-device eval step and the 5-round loop.

Counterpart of ``Evaluator`` (``pemp_tpu/core/trainer.py:112-224``,
reference core/base_trainer.py:59-102) with the on-device eval steps of
``pemp_tpu/core/experiment.py:181-300``: the batch goes to the device,
and the feature-resolution logits' align-corners resize, argmax, TP/FP/FN
counts and per-episode CE all stay there; one host fetch per batch
brings back the counts and losses. Query GT at the input's size resizes
the whole batch at once; GT at other sizes (PASCAL's and COCO's test
protocol: each query GT at its original resolution, a list of arrays
from the loader) resizes each episode's logits to its own GT size, with
the metrics of the JAX package's host-exact path
(``Evaluator._episode_metrics``).

The batch reaches the device through ``parallel.step.device_batch`` (the
wire format when asked); a prefetched batch's tensors pass through. In a
world of several processes a batch whose size the world divides is split
into one block a process, and the per-episode counts and losses (and
CaNet's logits) are gathered back into the batch's order, so every
process ends with the same metrics; any other batch is computed whole by
every process, as the JAX mesh replicates it.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from pemp_tpu_torch.core.losses import per_episode_cross_entropy
from pemp_tpu_torch.core.metrics import Accumulator, FewShotMetric, tp_fp_fn
from pemp_tpu_torch.models.common import output_resize
from pemp_tpu_torch.parallel import mesh
from pemp_tpu_torch.parallel.step import device_batch, take_rows, unpack_batch
from pemp_tpu_torch.utils.timer import Timer

ARRAY_KEYS = ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")


def _forward(model, t):
    return model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])


def make_fast_eval_step(model: torch.nn.Module, device: torch.device,
                        apply: Callable = _forward, keys=ARRAY_KEYS,
                        with_logits: bool = False, *,
                        compact_wire: bool) -> Callable:
    """batch (numpy, or the prefetcher's) -> (counts [B, 2, 3] int64,
    losses [B] float64); ``apply(model, tensors)`` is the eval forward
    (default: the model called on the support images, masks and query
    images) on the arrays ``keys``, sent in the wire format when
    ``compact_wire``. Its logits (feature resolution, or the query's size)
    are resized (align_corners) to each query GT's size, which may differ
    between episodes (``qry_msk`` a list of [Q, H', W'] arrays);
    ``with_logits`` also returns ``apply``'s logits as float32 numpy
    (CaNet's history write-back). In a world the processes split a batch
    their count divides and gather the results."""

    def metrics(logits, labels):
        """logits [B,Q,H',W',2], labels [B,Q,H',W'] -> ([B, 6], [B])."""
        b, nq = logits.shape[:2]
        losses = per_episode_cross_entropy(logits.reshape(b, nq, -1, 2),
                                           labels.reshape(b, nq, -1))
        # all Q queries share the episode's fg class: counts add over Q
        counts = tp_fp_fn(logits.argmax(dim=-1), labels).sum(dim=1)
        return counts.reshape(b, 6), losses

    @torch.no_grad()
    def step(batch):
        world = mesh.process_count()
        split = world > 1 and len(batch["cls"]) % world == 0
        if split:
            per = len(batch["cls"]) // world
            rank = mesh.process_index()
            batch = take_rows(batch, slice(rank * per, (rank + 1) * per))
        t = unpack_batch(device_batch(batch, device, compact_wire, keys))
        feat = apply(model, t)                          # [B,Q,h,w,2]
        gt = t.get("qry_msk", batch["qry_msk"])
        if isinstance(gt, torch.Tensor):
            labels, logits = [gt], [feat]
        elif isinstance(gt, np.ndarray):        # stacked, not the input's size
            labels, logits = [torch.from_numpy(gt).to(device)], [feat]
        else:                   # one GT size an episode
            labels = [torch.from_numpy(np.ascontiguousarray(g)).to(device)
                      [None] for g in gt]
            logits = [feat[i:i + 1] for i in range(len(gt))]
        parts = [metrics(output_resize(lg, tuple(lb.shape[-2:])),
                         lb.reshape(lg.shape[:2] + lb.shape[-2:]))
                 for lg, lb in zip(logits, labels)]
        counts = torch.cat([c for c, _ in parts])
        losses = torch.cat([lo for _, lo in parts])
        # one fetch: counts (< 2^53, exact in f64) beside the losses
        host = torch.cat([counts.double(), losses.double()[:, None]], dim=1)
        if split:
            host = mesh.gather_rows(host)
            feat = mesh.gather_rows(feat.float()) if with_logits else feat
        host = host.cpu().numpy()
        b = host.shape[0]
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
