"""Optimizers and learning-rate policies.

Counterpart of ``pemp_tpu/core/solver.py`` (reference core/solver.py):

- ``make_optimizer``: ``torch.optim.SGD`` (momentum, nesterov, weight
  decay added to the gradient before the momentum trace) or
  ``torch.optim.Adam``, over the parameters that train (``requires_grad``;
  the frozen ones are left out, as the JAX package's optax mask zeroes
  them);
- ``clip_gradients``: ``torch.nn.utils.clip_grad_norm_``, whose
  ``max_norm / (norm + 1e-6)`` clamped to 1 is exactly
  ``clip_by_global_norm_torch``. Clipping runs before ``step()``, so the
  order clip -> weight decay -> momentum is optax's chain;
- ``LRPolicy``: a copy of the host-side schedule (period_step,
  custom_step, plateau, cosine, poly; cosine and poly advance per step,
  the others per epoch) that writes each param group's ``lr``.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import torch


def make_optimizer(tr_cfg, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """SGD or Adam over ``params`` at the base rate ``tr_cfg.lr``."""
    params: List[torch.nn.Parameter] = list(params)
    if tr_cfg.opt == "sgd":
        return torch.optim.SGD(params, lr=tr_cfg.lr,
                               momentum=tr_cfg.sgd_momentum,
                               weight_decay=tr_cfg.weight_decay,
                               nesterov=tr_cfg.sgd_nesterov)
    if tr_cfg.opt == "adam":
        return torch.optim.Adam(params, lr=tr_cfg.lr,
                                betas=(tr_cfg.adam_beta1, tr_cfg.adam_beta2),
                                eps=tr_cfg.adam_epsilon,
                                weight_decay=tr_cfg.weight_decay)
    raise ValueError("Not supported optimizer: " + tr_cfg.opt)


def clip_gradients(params: Iterable[torch.nn.Parameter],
                   max_norm: float) -> None:
    """torch-semantics global-norm clip; ``max_norm <= 0`` disables it."""
    if max_norm > 0:
        torch.nn.utils.clip_grad_norm_(params, max_norm)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class LRPolicy:
    """Host-side LR schedule state machine (reference policies)."""

    STATE_KEYS = ("_epoch", "_step", "_lr", "_best", "_bad", "_cooldown")

    def __init__(self, tr_cfg, max_steps: int):
        self.cfg = tr_cfg
        self.base = tr_cfg.lr
        self.max_steps = max(max_steps, 1)
        self.policy = tr_cfg.lrp
        self.per_step = self.policy in ("cosine", "poly")
        self._epoch = 0
        self._step = 0
        self._lr = self.base
        # plateau state
        self._best = math.inf
        self._bad = 0
        self._cooldown = 0
        if self.policy == "poly":
            # reference PolyLR calls step() at construction (:62)
            self._step = 1
        self._recompute()

    @property
    def lr(self) -> float:
        return self._lr

    def _recompute(self):
        cfg = self.cfg
        if self.policy == "period_step":
            self._lr = self.base * cfg.lr_rate ** (self._epoch // cfg.lr_step)
        elif self.policy == "custom_step":
            n = sum(1 for b in cfg.lr_boundaries if b <= self._epoch)
            self._lr = self.base * cfg.lr_rate ** n
        elif self.policy == "cosine":
            t = min(self._step, self.max_steps)
            self._lr = cfg.lr_end + (self.base - cfg.lr_end) * (
                1 + math.cos(math.pi * t / self.max_steps)) / 2
        elif self.policy == "poly":
            # clamped like cosine: step_step() runs once more after the
            # last step, and a negative base with a fractional power
            # would be complex
            t = min(self._step, self.max_steps)
            self._lr = (self.base - cfg.lr_end) * (
                1 - t / self.max_steps) ** cfg.power + cfg.lr_end
        # plateau: handled in step_epoch

    def state_dict(self):
        """Schedule position for checkpoints (plateau state included: it
        cannot be replayed from the epoch count alone)."""
        return {k: getattr(self, k) for k in self.STATE_KEYS}

    def load_state_dict(self, state):
        for k in self.STATE_KEYS:
            if k in state:
                setattr(self, k, state[k])

    def step_step(self):
        """Advance per training step (cosine/poly only)."""
        if self.per_step:
            self._step += 1
            self._recompute()

    def step_epoch(self, monitor_value: Optional[float] = None):
        """Advance per epoch (all other policies)."""
        if self.per_step:
            return
        self._epoch += 1
        if self.policy == "plateau":
            cfg = self.cfg
            value = math.inf if monitor_value is None else monitor_value
            if self._cooldown > 0:
                self._cooldown -= 1
                self._bad = 0
            if value < self._best - cfg.lr_min_delta:
                self._best = value
                self._bad = 0
            elif self._cooldown == 0:
                self._bad += 1
                if self._bad > cfg.lr_patience:
                    self._lr = max(self._lr * cfg.lr_rate, cfg.lr_end)
                    self._cooldown = cfg.cool_down
                    self._bad = 0
        else:
            self._recompute()
