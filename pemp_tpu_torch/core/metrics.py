"""Few-shot segmentation metrics.

Counterpart of ``pemp_tpu/core/metrics.py`` (reference core/metrics.py):
``tp_fp_fn`` counts on the device tensor; ``FewShotMetric`` accumulates
those per-class TP/FP/FN counts on the host and reports the class-mean
IoU over the split's val labels and the binary IoU; ``Accumulator``
mirrors reference core/metrics.py:38-72.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def tp_fp_fn(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-map counts for classes [bg, fg].

    pred / ref: integer maps [..., H, W] of identical shape; ref==255 is
    ignored. Returns [..., 2, 3] int32: rows (bg, fg) x cols (tp, fp, fn).
    """
    valid = ref != 255
    rows = []
    for j in (0, 1):
        p = (pred == j) & valid
        r = (ref == j) & valid
        rows.append(torch.stack([(p & r).sum(dim=(-2, -1)),
                                 (p & ~r).sum(dim=(-2, -1)),
                                 (~p & r).sum(dim=(-2, -1))], dim=-1))
    return torch.stack(rows, dim=-2).to(torch.int32)


class FewShotMetric:
    def __init__(self, classes: int):
        self.classes = classes
        self.stat = np.zeros((classes + 1, 3), np.int64)   # +1 for bg

    def update_counts(self, counts, cls):
        """Accumulate device-computed [B, 2, 3] counts from ``tp_fp_fn``."""
        counts = np.asarray(counts, np.int64)
        for i, ci in enumerate(np.atleast_1d(np.asarray(cls))):
            self.stat[0] += counts[i, 0]
            self.stat[int(ci)] += counts[i, 1]

    def mIoU(self, labels: Sequence[int], binary: bool = False):
        if binary:
            stat = np.stack([self.stat[0], self.stat[1:].sum(axis=0)])  # [2,3]
        else:
            stat = self.stat[np.asarray(labels)]                        # [N,3]
        tp, fp, fn = stat.T.astype(np.float64)
        iou = tp / np.maximum(tp + fp + fn, 1e-12)
        return iou, iou.mean()


class Accumulator:
    def __init__(self, **kwargs):
        self.values = kwargs
        self.counter = {k: 0 for k in kwargs}

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(self.values[k], list):
                self.values[k].append(v)
            else:
                self.values[k] = self.values[k] + v
            self.counter[k] += 1

    def mean(self, key, axis=None):
        if isinstance(key, str):
            if isinstance(self.values[key], list):
                return np.array(self.values[key]).mean(axis)
            return self.values[key] / max(self.counter[key], 1)
        return [self.mean(k, axis) for k in key]
