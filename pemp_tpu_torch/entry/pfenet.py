"""PFENet entry: training-free prior and feature enrichment.

Counterpart of ``entry/pfenet.py`` of the JAX package (reference
entry/pfenet.py):

    python -m pemp_tpu_torch.entry.pfenet train with split=0 \
        data.dataset=SYNTH [loss_coef=1.0] [dev.device=cpu] [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.pfenet test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``; the input size must satisfy
``(H - 1) % 8 == 0`` (473, or 33 on the CPU). The train logits are at the
input size and the loss is ``loss`` of them plus ``loss_coef`` times the
mean CE of the pyramid's auxiliary heads (reference :66-72); the eval
logits are at feature resolution, and the eval step resizes them.
"""

from __future__ import annotations

from typing import List, Optional

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.core.losses import pfenet_aux_loss
from pemp_tpu_torch.models import registry

NAME = "pfenet"

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
ex = Experiment(NAME, base_cfg)


class PFENetRuntime(EntryRuntime):
    name = NAME

    def apply_train(self, model, batch):
        """Logits at the input size and ``{"aux_loss": ...}``, the mean CE
        of the auxiliary heads' logits against the query labels."""
        out, aux_outs = model(batch["sup_rgb"], batch["sup_mask"],
                              batch["qry_rgb"])
        labels = batch["qry_msk"]
        return out, {"aux_loss": pfenet_aux_loss(
            aux_outs, labels.reshape(-1, *labels.shape[-2:]))}

    def compute_loss(self, logits, batch, aux):
        main = super().compute_loss(logits, batch, aux)
        return main + self.cfg.loss_coef * aux["aux_loss"]

    def apply_eval(self, model, batch):
        out, _ = model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                       out_hw=None)
        return out


build_model = PFENetRuntime.build_model


@ex.command
def test(cfg, run):
    return PFENetRuntime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return PFENetRuntime(cfg, run, build_model).train()


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
