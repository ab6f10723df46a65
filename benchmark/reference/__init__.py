"""The plain references the benchmark holds the program against.

A configuration names its reference (``"reference": "<name>"``), the
module ``benchmark/reference/<name>.py``; a new family is a new file.
It imports nothing of the program, and it gives:

- ``build(cfg, device=None, precision="f32")``: the model of the
  configuration's ``model`` section, its ``state_dict`` keys the
  program's; ``precision="fp8"`` is the control. The model's
  ``trainable()`` names the parameters that training moves.
- ``exact_f32()``: float32 products without TF32.
- ``state_keys(model)``: [(key, shape)] in state-dict order.
- ``seeded_state(cfg, seed, episodes, device)``: the weights drawn from
  ``seed`` and calibrated on ``episodes`` (``traffic.episodes``).
- ``set_generator(model, generator)``: the generator dropout draws from.
- ``optimizer(cfg, params)``: the configuration's optimizer; its
  ``buf`` holds each leaf's momentum.
- ``train_step(model, opt, batch, cfg)``: one step, its loss.
- ``logits(model, batch)``: the forward at feature resolution.
- ``answers(model, batch, gts)``: each episode's (counts [2, 3] as
  numpy, loss) at its GT's size.
"""

from __future__ import annotations

import importlib
from typing import Dict


def of(cfg: Dict):
    """The configuration's reference module."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")
