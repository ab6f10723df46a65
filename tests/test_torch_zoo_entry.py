"""The port's CaNet, RPMMs and PFENet entries on the CPU at 33x33 (SYNTH,
ce, f32), and their runtimes' hooks.

``train`` (two steps) records ``g.model_dir/<name>/<id>/{ckpt.pt,
bestckpt.pt}`` and chains into a finite ``test`` of ``bestckpt.pt``;
without ``dev.device=cpu`` and with no CUDA each entry raises. CaNet
writes every train query's softmax into its history store after each
step and every eval query's after each eval batch, and ``test`` starts
from an empty store; RPMMs' eval draws the same ``mu0`` for every batch
while its train draws advance; PFENet's loss adds ``loss_coef`` times its
auxiliary CE. Each test removes what it wrote when it ends.
"""

import math
import shutil

import numpy as np
import pytest
import torch

from pemp_tpu_torch.config import Run
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core.losses import cross_entropy
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.entry import canet as canet_entry
from pemp_tpu_torch.entry import pfenet as pfenet_entry
from pemp_tpu_torch.entry import rpmms as rpmms_entry
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.canet import CaNet
from pemp_tpu_torch.models.pfenet import PFENet
from pemp_tpu_torch.models.rpmms import RPMMs
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.train_n=4", "data.test_bs=2", "data.test_n=4",
         "te.epochs=1", "tr.total_epochs=1", "data.num_workers=2",
         "dev.precision=f32"]
ENTRIES = {"canet": (canet_entry, CaNet), "rpmms": (rpmms_entry, RPMMs),
           "pfenet": (pfenet_entry, PFENet)}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints the test wrote
    into it once the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(entry, *extra):
    return entry.ex.assemble("train", dict(
        a.split("=", 1) for a in SMALL + ["dev.device=cpu", *extra]))


@pytest.mark.parametrize("name", list(ENTRIES))
def test_train_records_a_run_and_chains_into_test(tmp_path, name):
    entry, cls = ENTRIES[name]
    result = entry.main(["train", "with", *SMALL, "dev.device=cpu",
                         f"g.model_dir={tmp_path}"])
    train = result["train"]
    assert train["run_id"] == 1 and train["device"] == "cpu"
    assert len(train["losses"]) == 2
    assert all(math.isfinite(x) for x in train["losses"])
    run_dir = tmp_path / name / "1"
    assert {p.name for p in run_dir.iterdir()} == {ckpt_lib.CKPT,
                                                   ckpt_lib.BEST}
    got = ckpt_lib.load(run_dir / ckpt_lib.BEST)["model"]
    assert set(got) == set(cls().state_dict())
    assert math.isfinite(result["test"]["miou"])
    assert result["test"]["miou"] == pytest.approx(train["best_iou"])


@pytest.mark.parametrize("name", list(ENTRIES))
@pytest.mark.parametrize("command", ["train", "test"])
def test_entry_without_cpu_request_needs_cuda(tmp_path, name, command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRIES[name][0].main([command, "with", *SMALL,
                               f"g.model_dir={tmp_path}"])


def test_registry_builds_every_family():
    assert registry.NOT_PORTED == ()
    for name, (entry, cls) in ENTRIES.items():
        cfg = entry.ex.assemble("test", {"split": "0"})
        assert isinstance(registry.build(name, cfg), cls)
    cfg = canet_entry.ex.assemble("test", {"split": "0",
                                           "net.freeze_backbone": "False",
                                           "net.history": "False"})
    model = registry.build("canet", cfg)
    trained = {id(p) for p in model.freeze()}
    # without freeze_backbone only the trunk's BNs are frozen
    assert id(model.encoder.conv1.weight) in trained
    assert id(model.encoder.bn1.weight) not in trained
    assert not model.use_history and model.residual_1[1].in_channels == 256
    cfg = pfenet_entry.ex.assemble("test", {"split": "0", "shot": "2"})
    assert registry.build("pfenet", cfg).shot == 2


def test_canet_writes_history_and_test_starts_empty(tmp_path):
    cfg = _cfg(canet_entry, f"g.model_dir={tmp_path}")
    runtime = canet_entry.CaNetRuntime(cfg, Run(None, None),
                                       canet_entry.build_model)
    train = runtime._train()
    assert len(train["losses"]) == 2
    train_ds, _, _ = datasets.load(cfg, "train")
    val_ds, _, _ = datasets.load(cfg, "eval_online")
    keys = set()
    for ds in (train_ds, val_ds):
        ds.sample_tasks()
        keys |= {(cls, n) for cls, names in ds.sampler.tasks
                 for n in names[cfg.shot:]}
    # one entry per distinct query of the train epoch and the eval round
    assert runtime.store.keys() == keys
    for key in keys:
        hist = runtime.store._store[key]
        assert hist.shape == (5, 5, 2)
        np.testing.assert_allclose(hist.sum(-1), 1.0, rtol=1e-6)
    seen = []
    get = runtime.store.get

    def spy(*args, **kwargs):
        out = get(*args, **kwargs)
        seen.append(bool(out.any()))
        return out

    runtime.store.get = spy
    cfg.ckpt = ""
    result = runtime.test()
    assert math.isfinite(result["miou"])
    # the test round read zeros only: its store started empty
    assert seen and not any(seen)
    assert len(runtime.store) > 0


def _batch(cfg, mode):
    ds, loader, _ = datasets.load(cfg, mode)
    ds.sample_tasks()
    return {k: torch.from_numpy(v) for k, v in next(iter(loader)).items()
            if k != "cls"}


def test_rpmms_eval_is_deterministic_and_train_draws_advance():
    cfg = _cfg(rpmms_entry)
    runtime = rpmms_entry.RPMMsRuntime(cfg)
    model = RPMMs(layers=(1, 1, 1)).eval()      # the hooks at any depth
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = _batch(cfg, "test")
    state = runtime.pmm_generator.get_state()
    with torch.no_grad():
        a = runtime.apply_eval(model, batch)
        b = runtime.apply_eval(model, batch)
        assert torch.equal(state, runtime.pmm_generator.get_state())
        outs, _ = runtime.apply_train(model.train(), batch)
    assert torch.equal(a, b) and a.shape == (2, 1, 5, 5, 2)
    # the train draws come from the seed + 1 generator, which advanced
    assert not torch.equal(state, runtime.pmm_generator.get_state())
    assert len(outs) == 3
    loss = runtime.compute_loss(outs, batch, {})
    assert math.isfinite(float(loss))


@pytest.mark.parametrize("coef", [0.0, 2.0])
def test_pfenet_loss_adds_loss_coef_times_aux(coef):
    cfg = _cfg(pfenet_entry, f"loss_coef={coef}")
    runtime = pfenet_entry.PFENetRuntime(cfg)
    model = PFENet(ppm_scales=(6, 3, 2, 1), layers=(1, 1, 1, 1)).train()
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = _batch(cfg, "train")
    with torch.no_grad():
        logits, aux = runtime.apply_train(model, batch)
        loss = runtime.compute_loss(logits, batch, aux)
    base = cross_entropy(logits.reshape(-1, 33, 33, 2),
                         batch["qry_msk"].reshape(-1, 33, 33))
    assert logits.shape == (2, 1, 33, 33, 2)
    assert 0.0 < float(aux["aux_loss"]) < math.inf
    assert float(loss) == pytest.approx(float(base)
                                        + coef * float(aux["aux_loss"]))
