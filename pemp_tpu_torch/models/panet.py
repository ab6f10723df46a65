"""PANet: Baseline prototypes plus the prototype-alignment loss.

Counterpart of ``pemp_tpu/models/panet.py`` (reference networks/panet.py):
the forward is ``Baseline``'s; with ``align=True`` it also returns the
alignment loss (reference alignLoss :158-194): the query's own prediction
at feature resolution (first-occurrence argmax, no gradient) masks the
query features into fg/bg prototypes (``masked_average_pooling``, with
gradient into the features), which must segment the support images; the
support logits are upsampled to the mask size and scored with
``cross_entropy_no_ignore`` against the support fg mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pemp_tpu_torch.core.losses import cross_entropy_no_ignore
from pemp_tpu_torch.models.baseline import Baseline, NetConfig  # noqa: F401
from pemp_tpu_torch.models.common import output_resize
from pemp_tpu_torch.ops.prototypes import (
    masked_average_pooling, prototype_predictions,
)


class PANet(Baseline):
    """``state_dict`` keys are Baseline's (reference panet.py:48-61)."""

    def forward(self, sup_img, sup_mask, qry_img,
                out_hw: Optional[Tuple[int, int]] = "input",
                align: bool = True):
        """As ``Baseline.forward``; with ``align`` returns (logits,
        align_loss), the loss a float32 scalar."""
        b, q = qry_img.shape[:2]
        if out_hw == "input":
            out_hw = tuple(qry_img.shape[2:4])
        sup_fts, qry_fts = self.features(sup_img, qry_img)
        h, w = sup_fts.shape[2:4]
        pred = self.predict(sup_fts, qry_fts, sup_mask)          # [B,Q,n,2]
        logits = output_resize(pred.reshape(b, q, h, w, 2), out_hw)
        if not align:
            return logits
        return logits, self.align_loss(qry_fts, pred, sup_fts,
                                       sup_mask[..., 0])

    def align_loss(self, qry_fts, pred, sup_fts, sup_fg):
        """qry_fts [B,Q,n,c], pred [B,Q,n,2] (feature resolution), sup_fts
        [B,S,h,w,c], sup_fg [B,S,H,W] -> the alignment CE."""
        b, s, h, w, c = sup_fts.shape
        pred_cls = pred.detach().argmax(dim=-1)                 # [B,Q,n]
        fg = masked_average_pooling(qry_fts, (pred_cls == 1).to(pred.dtype))
        bg = masked_average_pooling(qry_fts, (pred_cls == 0).to(pred.dtype))
        sup_pred = prototype_predictions(
            sup_fts.reshape(b, s, h * w, c), fg.mean(dim=1), bg.mean(dim=1),
            self.dist_scalar)                                   # [B,S,n,2]
        sup_logits = output_resize(sup_pred.reshape(b, s, h, w, 2),
                                   tuple(sup_fg.shape[-2:]))
        return cross_entropy_no_ignore(sup_logits, sup_fg)
