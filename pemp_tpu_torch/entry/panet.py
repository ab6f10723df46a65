"""PANet entry: prototype alignment regularisation.

Counterpart of ``entry/panet.py`` of the JAX package (reference
entry/panet.py):

    python -m pemp_tpu_torch.entry.panet train with split=0 \
        data.dataset=SYNTH [loss_coef=1.0] [net.backbone=vgg16|resnet50] \
        [dev.device=cpu] [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.panet test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

As the Baseline entry, with the train loss ``loss + loss_coef *
align_loss`` (reference :112); the eval uses the logits only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.models import registry

NAME = "panet"

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
ex = Experiment(NAME, base_cfg)


class PANetRuntime(EntryRuntime):
    name = NAME

    def apply_train(self, model, batch):
        logits, align = model(batch["sup_rgb"], batch["sup_mask"],
                              batch["qry_rgb"], align=True)
        return logits, {"align_loss": align}

    def compute_loss(self, logits, batch, aux: Dict):
        base = super().compute_loss(logits, batch, aux)
        return base + self.cfg.loss_coef * aux["align_loss"]

    def apply_eval(self, model, batch):
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     align=False)


build_model = PANetRuntime.build_model


@ex.command
def test(cfg, run):
    return PANetRuntime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return PANetRuntime(cfg, run, build_model).train()


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
