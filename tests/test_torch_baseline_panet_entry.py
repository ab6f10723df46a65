"""The port's Baseline and PANet entries on the CPU at 33x33 (SYNTH, ce,
f32, VGG16: the entries' default backbone), and the model registry.

``train`` records ``g.model_dir/<baseline|panet>/<id>/{ckpt.pt,
bestckpt.pt}`` and chains into a finite ``test`` of ``bestckpt.pt``;
``-u`` records nothing; without ``dev.device=cpu`` and with no CUDA both
entries raise; PANet's loss adds ``loss_coef`` times its alignment loss.
Each test removes what it wrote when it ends.
"""

import math
import shutil

import pytest
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.entry import baseline as baseline_entry
from pemp_tpu_torch.entry import panet as panet_entry
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.baseline import Baseline
from pemp_tpu_torch.models.common import output_resize
from pemp_tpu_torch.models.panet import PANet

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.train_n=4", "data.test_bs=2", "data.test_n=4",
         "te.epochs=1", "tr.total_epochs=1", "data.num_workers=2",
         "dev.precision=f32"]
ENTRIES = {"baseline": (baseline_entry, Baseline),
           "panet": (panet_entry, PANet)}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints the test wrote
    into it once the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("name", ["baseline", "panet"])
def test_train_records_a_run_and_chains_into_test(tmp_path, name):
    entry, cls = ENTRIES[name]
    result = entry.main(["train", "with", *SMALL, "dev.device=cpu",
                         f"g.model_dir={tmp_path}"])
    train = result["train"]
    assert train["run_id"] == 1 and train["device"] == "cpu"
    assert len(train["losses"]) == 2
    assert all(math.isfinite(x) for x in train["losses"])
    run_dir = tmp_path / name / "1"
    # the checkpoints and the run's records (REVISION only in a checkout)
    assert {p.name for p in run_dir.iterdir()} - {"REVISION"} == {
        ckpt_lib.CKPT, ckpt_lib.BEST, "config.json", "metrics.json",
        "sources"}
    want = cls(backbone="vgg16").state_dict()
    got = ckpt_lib.load(run_dir / ckpt_lib.BEST)["model"]
    assert set(got) == set(want)
    assert math.isfinite(result["test"]["miou"])
    assert result["test"]["miou"] == pytest.approx(train["best_iou"])


def test_unobserved_run_records_nothing(tmp_path):
    result = baseline_entry.main(["train", "with", *SMALL, "dev.device=cpu",
                                  f"g.model_dir={tmp_path}", "-u"])
    assert result["train"]["run_id"] is None and "test" not in result
    assert [p.name for p in tmp_path.iterdir()] == ["None"]


@pytest.mark.parametrize("name", ["baseline", "panet"])
@pytest.mark.parametrize("command", ["train", "test"])
def test_entry_without_cpu_request_needs_cuda(tmp_path, name, command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRIES[name][0].main([command, "with", *SMALL,
                               f"g.model_dir={tmp_path}"])


@pytest.mark.parametrize("coef", [0.0, 2.0])
def test_panet_loss_adds_loss_coef_times_align(coef):
    cfg = panet_entry.ex.assemble("train", {"split": "0",
                                            "loss_coef": str(coef)})
    assert (cfg.net.backbone, cfg.tr.grad_clip) == ("vgg16", 0.0)
    runtime = panet_entry.PANetRuntime(cfg)
    model = PANet(backbone="vgg16")
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    fg = (torch.rand(1, 1, 33, 33, 1, generator=g) > 0.5).float()
    batch = {"sup_rgb": torch.randn(1, 1, 33, 33, 3, generator=g),
             "sup_mask": torch.cat([fg, 1 - fg], -1),
             "qry_rgb": torch.randn(1, 1, 33, 33, 3, generator=g),
             "qry_msk": torch.randint(0, 2, (1, 1, 33, 33), generator=g)}
    with torch.no_grad():
        logits, aux = runtime.apply_train(model, batch)
        base = runtime.loss_fn(logits.reshape(-1, 33, 33, 2),
                               batch["qry_msk"].reshape(-1, 33, 33))
        loss = runtime.compute_loss(logits, batch, aux)
        eval_logits = runtime.apply_eval(model, batch)
    assert float(aux["align_loss"]) > 0
    assert float(loss) == pytest.approx(float(base)
                                        + coef * float(aux["align_loss"]))
    # eval keeps feature resolution; the eval step resizes it
    assert torch.equal(output_resize(eval_logits, (33, 33)), logits)


def test_registry_builds_the_ported_families_only():
    cfg = baseline_entry.ex.assemble("test", {"split": "0"})
    assert isinstance(registry.build("baseline", cfg), Baseline)
    assert type(registry.net_config("panet")) is type(cfg.net)
    # every family is ported (tests/test_torch_zoo_entry.py builds them)
    assert registry.NOT_PORTED == ()
    assert set(registry.REGISTRY) == {
        "baseline", "panet", "pemp_stage1", "pemp_stage2", "canet", "rpmms",
        "pfenet"}
    with pytest.raises(KeyError):
        registry.net_config("bogus")
    cfg.dev.precision = "f16"
    with pytest.raises(ValueError):
        registry.build("baseline", cfg)
