"""PEMP stage-1 entry.

Counterpart of ``entry/pemp_stage1.py`` of the JAX package:

    python -m pemp_tpu_torch.entry.pemp_stage1 train with split=0 \
        data.dataset=SYNTH loss=cedt [net.backbone=vgg16] \
        [dev.device=cpu] [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.pemp_stage1 test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``. ``train`` initialises the
model from ``seed``, trains it (SGD, gradient clip 1.1, the backbone BNs
frozen), records the run into ``g.model_dir/<tag>/<id>/`` and, when the
run is recorded, chains into ``test`` with ``exp_id=<id>
ckpt=bestckpt.pt``. ``test`` initialises the model from ``seed`` or loads
a ``.pt`` checkpoint (the trainer's, or a bare state_dict such as one
written from ``pemp_tpu_torch.utils.convert.state_dict_from_jax``) and
runs the 5-round evaluator (``core/experiment.py``). ``net.backbone``:
resnet50 (default), resnet101 or vgg16. ``visualize`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.models import registry

NAME = "pemp_stage1"

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
base_cfg.tr.grad_clip = 1.1     # reference entry/pemp_stage1.py:63
ex = Experiment(NAME, base_cfg)


class Stage1Runtime(EntryRuntime):
    name = NAME


build_model = Stage1Runtime.build_model


@ex.command
def test(cfg, run):
    return Stage1Runtime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return Stage1Runtime(cfg, run, build_model).train()


@ex.command
def visualize(cfg, run):
    raise SystemExit(f"{NAME} visualize is not yet ported to pemp_tpu_torch")


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
