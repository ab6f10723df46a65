"""Baseline entry: masked-average-prototype few-shot segmentation.

Counterpart of ``entry/baseline.py`` of the JAX package (reference
entry/baseline.py):

    python -m pemp_tpu_torch.entry.baseline train with split=0 \
        data.dataset=SYNTH [net.backbone=vgg16|resnet50] [dev.device=cpu] \
        [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.baseline test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``. ``train`` initialises the
model from ``seed``, trains it (SGD, no gradient clip; with ``resnet50``
the backbone BNs frozen), records the run into ``g.model_dir/baseline/
<id>/`` and chains into ``test``, as the other entries
(``core/experiment.py``).
"""

from __future__ import annotations

from typing import List, Optional

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.models import registry

NAME = "baseline"

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
ex = Experiment(NAME, base_cfg)


class BaselineRuntime(EntryRuntime):
    name = NAME


build_model = BaselineRuntime.build_model


@ex.command
def test(cfg, run):
    return BaselineRuntime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return BaselineRuntime(cfg, run, build_model).train()


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
