"""CaNet entry: dense comparison and history-mask refinement.

Counterpart of ``entry/canet.py`` of the JAX package (reference
entry/canet.py):

    python -m pemp_tpu_torch.entry.canet train with split=0 \
        data.dataset=SYNTH [net.history=False] [dev.device=cpu] \
        [k=v ...] [-u]
    python -m pemp_tpu_torch.entry.canet test with split=0 \
        data.dataset=SYNTH [ckpt=weights.pt] [dev.device=cpu] [k=v ...]

Both run on CUDA unless ``dev.device=cpu``. Every episode carries its
query's previous softmax at 1/8 resolution (``history``, zeros at first)
from a ``HistoryStore`` (``data/history.py``) shared by the train and
online-eval data; after every train step and eval batch the new softmax
is written back. That copies the [B, Q, h8, w8, 2] logits to the host
each step, which waits for the step (the JAX package's design). The
train loss is ``loss`` on the logits upsampled to the label size
(reference :109-112); ``test`` starts from an empty store.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pemp_tpu_torch.config import Config, Experiment
from pemp_tpu_torch.core.evaluator import ARRAY_KEYS, make_fast_eval_step
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.data.history import CaNetDataAdapter, HistoryStore
from pemp_tpu_torch.data.loader import EpisodeLoader
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.canet import feat_size
from pemp_tpu_torch.models.common import output_resize

NAME = "canet"

base_cfg = Config(tag=NAME)
base_cfg.net = registry.net_config(NAME)
ex = Experiment(NAME, base_cfg)


def softmax_np(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class CaNetRuntime(EntryRuntime):
    name = NAME
    device_keys = ARRAY_KEYS + ("history",)

    def __init__(self, cfg, run=None, build=None):
        super().__init__(cfg, run, build)
        self.store = HistoryStore(feat_size(cfg.data.height),
                                  feat_size(cfg.data.width), seed=cfg.seed)

    def wrap_data(self, ds, loader, train: bool):
        adapter = CaNetDataAdapter(ds, self.store, train)
        return adapter, EpisodeLoader(adapter, loader.batch_size,
                                      loader.num_workers, loader.prefetch,
                                      loader.drop_last)

    def apply_train(self, model, batch):
        """Feature-resolution logits (the loss upsamples them)."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     batch["history"], out_hw=None), {}

    def compute_loss(self, logits, batch, aux):
        up = output_resize(logits, tuple(batch["qry_msk"].shape[-2:]))
        return super().compute_loss(up, batch, aux)

    def apply_eval(self, model, batch):
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     batch["history"], out_hw=None)

    def write_history(self, feat_logits: np.ndarray, batch) -> None:
        """The softmax of each query's [h8, w8, 2] logits into the store."""
        soft = softmax_np(np.asarray(feat_logits, np.float32))
        for i, names in enumerate(batch["qry_names"]):
            for j, name in enumerate(names):
                self.store.put(batch["cls"][i], name, soft[i, j])

    def post_step(self, logits: torch.Tensor, batch) -> None:
        self.write_history(logits.float().cpu().numpy(), batch)

    def eval_step(self, model, device: torch.device):
        raw = make_fast_eval_step(model, device, self.apply_eval,
                                  self.device_keys, with_logits=True)

        def step(batch):
            counts, losses, feat = raw(batch)
            self.write_history(feat, batch)
            return counts, losses
        return step

    def test(self):
        # a chained test starts from an empty store, as a standalone one
        self.store.clear()
        return super().test()


build_model = CaNetRuntime.build_model


@ex.command
def test(cfg, run):
    return CaNetRuntime(cfg, run, build_model).test()


@ex.command
def train(cfg, run):
    return CaNetRuntime(cfg, run, build_model).train()


def main(argv: Optional[List[str]] = None):
    return ex.run_commandline(argv)


if __name__ == "__main__":
    main()
