"""RPMMs entry: residual prototype mixture models.

Counterpart of ``entry/rpmms.py`` of the JAX package (reference
entry/rpmms.py):

    python -m pemp_tpu_torch.entry.rpmms train with split=0 \
        data.dataset=SYNTH [dev.device=cpu] [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.rpmms test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``. The train loss is RPMMs' own:
the CE without ignore of its three pyramid outputs upsampled to the label
size, summed (``core/losses.py:rpmms_loss``); the prediction comes from
the last output. The EM's random ``mu0`` is drawn on the CPU: in training
from one generator seeded ``seed + 1`` that every step advances, in eval
from a generator seeded 0 afresh for every batch, so eval is
deterministic (the JAX package's ``pmm`` rng stream: folded per step, a
fixed key in eval).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.core.losses import rpmms_loss
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.common import output_resize

NAME = "rpmms"
EVAL_SEED = 0

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
ex = Experiment(NAME, base_cfg)


class RPMMsRuntime(EntryRuntime):
    name = NAME

    def __init__(self, cfg, run=None, build=None):
        super().__init__(cfg, run, build)
        self.pmm_generator = torch.Generator().manual_seed(cfg.seed + 1)

    def apply_train(self, model, batch):
        """The three feature-resolution outputs (the loss upsamples them)."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     generator=self.pmm_generator), {}

    def compute_loss(self, outs, batch, aux):
        out_hw = tuple(batch["qry_msk"].shape[-2:])
        labels = batch["qry_msk"].reshape(-1, *out_hw)
        return rpmms_loss([output_resize(o, out_hw) for o in outs], labels)

    def apply_eval(self, model, batch):
        outs = model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     generator=torch.Generator().manual_seed(EVAL_SEED))
        return outs[-1]         # the last pyramid output predicts


build_model = RPMMsRuntime.build_model


@ex.command
def test(cfg, run):
    return RPMMsRuntime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return RPMMsRuntime(cfg, run, build_model).train()


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
