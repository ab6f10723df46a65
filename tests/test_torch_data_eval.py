"""The port's eval on query GT at its original resolution
(``pemp_tpu_torch/core/evaluator.py``) against the JAX package's
host-exact path (``pemp_tpu/core/trainer.py``'s ``Evaluator`` without a
fast or bucketed step: each episode's feature-resolution logits resized
on the host to its own GT size, argmax, host CE, TP/FP/FN).

PEMP stage 1 (ResNet-50 cut to one bottleneck a stage, c=512, p=3) in
float64 on both sides, the weights drawn from numpy and carried into the
port by ``state_dict_from_jax``, runs two rounds over SYNTH episodes with
``data.var_gt`` and over a miniature PASCAL tree of varied original
sizes, at test batch 3 (and the port also at batch 1): the TP/FP/FN
counts of every round identical, mIoU and bIoU identical, the loss within
1e-6 relative (the JAX path resizes in float32).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.config import Config as JaxConfig
from pemp_tpu.config.base import apply_overrides as jax_overrides
from pemp_tpu.core import trainer as jax_trainer
from pemp_tpu.data import datasets as jax_datasets
from pemp_tpu.models import common as jax_common
from pemp_tpu.models import registry as jax_registry
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu_torch.core import evaluator as evaluator_mod
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.entry import pemp_stage1 as entry
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.fixtures import make_fake_voc
from tests.test_torch_parity_helpers import (  # noqa: F401
    draw_variables, one_torch_thread, tree64,
)

LAYERS = (1, 1, 1)
H = W = 33
LOSS_RTOL = 1e-6


class Recorded:
    """Wraps a package's ``FewShotMetric`` to keep every round's counts."""

    def __init__(self, metric_cls):
        self.rounds = []
        recorder = self

        class Metric(metric_cls):
            def __init__(self, classes):
                super().__init__(classes)
                recorder.rounds.append(self)

        self.cls = Metric

    def stats(self):
        return [m.stat.copy() for m in self.rounds]


@pytest.fixture(scope="module")
def carried():
    """The JAX model and its float64 variables, and the port's model
    with the same weights in float64."""
    jax.config.update("jax_enable_x64", True)
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_common.RESNET_LAYERS, "resnet50", LAYERS)
    model = JaxPEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                          dtype=jnp.float64)
    x, m = jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H, W, 2))
    params, stats = draw_variables(model, (x, m, x), 5)
    port = PEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                      layers=LAYERS)
    port.load_state_dict(state_dict_from_jax(params, stats))
    variables = {"params": tree64(params), "batch_stats": tree64(stats)}
    yield model, variables, port.double().eval()
    mp.undo()
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_eval")
    make_fake_voc(root, per_class=3, classes=range(1, 6), seed=3,
                  size=lambda c, i: (40 + 7 * c + i, 52 + 3 * i))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def configs(overrides):
    cfg = entry.ex.assemble("test", overrides)
    jcfg = JaxConfig()
    jcfg.net = jax_registry.net_config("pemp_stage1")
    jax_overrides(jcfg, overrides)
    return cfg, jcfg


def jax_eval(model, variables, jcfg, monkeypatch):
    """The JAX ``Evaluator``'s host-exact path: (loss, miou, biou, counts
    of every round)."""
    apply = jax.jit(lambda v, b: model.apply(
        v, b["sup_rgb"], b["sup_mask"], b["qry_rgb"], out_hw=None,
        train=False))

    def eval_step(batch):
        b = {k: jnp.asarray(batch[k], jnp.float64)
             for k in ("sup_rgb", "sup_mask", "qry_rgb")}
        with jax.default_matmul_precision("highest"):
            return apply(variables, b)

    rec = Recorded(jax_trainer.FewShotMetric)
    monkeypatch.setattr(jax_trainer, "FewShotMetric", rec.cls)
    ds, loader, n = jax_datasets.load(jcfg, "test")
    ev = jax_trainer.Evaluator(jcfg, eval_step,
                               jax_datasets.get_val_labels(jcfg, jcfg.split))
    assert ev.fast_step is None and ev.bucket_step is None
    loss, miou, biou = ev.start_eval_loop(ds, loader, n)
    return float(loss), np.asarray(miou), np.asarray(biou), rec.stats()


def port_eval(port, cfg, monkeypatch):
    def apply(model, t):
        return model(t["sup_rgb"].double(), t["sup_mask"].double(),
                     t["qry_rgb"].double(), out_hw=None)

    rec = Recorded(evaluator_mod.FewShotMetric)
    monkeypatch.setattr(evaluator_mod, "FewShotMetric", rec.cls)
    ds, loader, n = datasets.load(cfg, "test")
    ev = evaluator_mod.Evaluator(
        cfg, evaluator_mod.make_fast_eval_step(port, torch.device("cpu"),
                                               apply, compact_wire=False),
        datasets.get_val_labels(cfg, cfg.split))
    loss, miou, biou = ev.start_eval_loop(ds, loader, n)
    return float(loss), np.asarray(miou), np.asarray(biou), rec.stats()


@pytest.mark.parametrize("data", ["synth_var_gt", "pascal"])
def test_counts_and_loss_equal_the_jax_host_path(carried, voc_root, data,
                                                 monkeypatch):
    model, variables, port = carried
    overrides = {"split": "0", "data.height": str(H), "data.width": str(W),
                 "data.test_bs": "3", "data.test_n": "6", "te.epochs": "2",
                 "data.num_workers": "2"}
    if data == "pascal":
        overrides.update({"data.dataset": "PASCAL",
                          "data.base_dir": str(voc_root)})
    else:
        overrides.update({"data.dataset": "SYNTH", "data.var_gt": "True"})
    cfg, jcfg = configs(overrides)
    # the batches hold query GT of several sizes, none the input's
    ds, loader, _ = datasets.load(cfg, "test")
    ds.sample_tasks()
    gts = [g for batch in loader for g in batch["qry_msk"]]
    assert len({g.shape for g in gts}) > 1
    assert all(g.shape[-2:] != (H, W) for g in gts)

    want = jax_eval(model, variables, jcfg, monkeypatch)
    got = port_eval(port, cfg, monkeypatch)
    assert len(got[3]) == len(want[3]) == 2
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)
    assert got[3][0].sum() > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)

    # one episode a batch gives the same counts
    cfg1, _ = configs({**overrides, "data.test_bs": "1"})
    one = port_eval(port, cfg1, monkeypatch)
    for a, b in zip(one[3], got[3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(one[0], got[0], rtol=1e-12)


def test_fixed_and_variable_gt_batches_take_one_step(carried):
    """A batch whose GT has the input's size resizes the batch at once; a
    list of GTs resizes each episode: on GT at the input's size both give
    the same counts and losses."""
    _, _, port = carried

    def apply(model, t):
        return model(t["sup_rgb"].double(), t["sup_mask"].double(),
                     t["qry_rgb"].double(), out_hw=None)

    cfg, _ = configs({"split": "1", "data.dataset": "SYNTH",
                      "data.height": str(H), "data.width": str(W),
                      "data.test_bs": "3", "data.test_n": "3"})
    ds, loader, _ = datasets.load(cfg, "test")
    ds.sample_tasks()
    batch = next(iter(loader))
    assert isinstance(batch["qry_msk"], np.ndarray)
    step = evaluator_mod.make_fast_eval_step(port, torch.device("cpu"),
                                             apply, with_logits=True,
                                             compact_wire=False)
    counts, losses, feat = step(batch)
    split = dict(batch, qry_msk=list(batch["qry_msk"]))
    counts2, losses2, feat2 = step(split)
    np.testing.assert_array_equal(counts, counts2)
    np.testing.assert_allclose(losses, losses2, rtol=1e-12)
    assert feat.shape == (3, 1, 5, 5, 2) and np.array_equal(feat, feat2)
