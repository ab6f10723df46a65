"""The port's stage-2 entry on the CPU at 33x33 (SYNTH, cedt, f32).

Stage 1's ``train`` writes a checkpoint; stage 2's ``train`` with
``s1.id=<id>`` (or ``s1.ckpt=<file>``) trains the cascade, records
``ckpt.pt`` and ``bestckpt.pt`` holding stage 2's weights only (the
reference keys) and chains into ``test``; the frozen stage 1's weights and
BN buffers are bit-equal after training. Without a stage-1 checkpoint
``test`` raises ``FileNotFoundError``; without ``dev.device=cpu`` and with
no CUDA the entry raises; ``visualize`` is not ported.
"""

import math
import shutil

import pytest
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.entry import pemp_stage1 as entry1
from pemp_tpu_torch.entry import pemp_stage2 as entry2
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.train_n=4", "data.test_bs=2", "data.test_n=4",
         "te.epochs=1", "loss=cedt", "data.num_workers=2", "tr.total_epochs=1",
         "dev.precision=f32"]


@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    """A model dir holding one trained stage-1 run (id 1); removed, with
    the stage-2 runs the tests add to it, after the module's last test."""
    root = tmp_path_factory.mktemp("model_dir")
    result = entry1.main(["train", "with", *SMALL, "dev.device=cpu",
                          f"g.model_dir={root}"])
    assert result["train"]["run_id"] == 1
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_stage2_trains_records_stage2_keys_and_chains_into_test(
        stage1_run, monkeypatch):
    built = []
    build = entry2.build_model

    def keep(cfg, device):
        built.append(build(cfg, device))
        return built[-1]

    monkeypatch.setattr(entry2, "build_model", keep)
    result = entry2.main(["train", "with", *SMALL, "dev.device=cpu",
                          f"g.model_dir={stage1_run}", "s1.id=1",
                          "tr.lr=0.0035"])
    train = result["train"]
    assert train["run_id"] == 1 and train["device"] == "cpu"
    assert len(train["losses"]) == 2
    assert all(math.isfinite(x) for x in train["losses"])
    assert math.isfinite(result["test"]["miou"])
    assert result["test"]["miou"] == pytest.approx(train["best_iou"])

    run_dir = stage1_run / "pemp_stage2" / "1"
    assert {p.name for p in run_dir.iterdir()} == {ckpt_lib.CKPT,
                                                   ckpt_lib.BEST}
    want = PEMPStage2().state_dict()
    for name in (ckpt_lib.CKPT, ckpt_lib.BEST):
        got = ckpt_lib.load(run_dir / name)["model"]
        assert set(got) == set(want), name
        assert all(got[k].shape == want[k].shape for k in want), name

    # the train run's cascade: stage 1 as loaded, bit for bit (weights and
    # BN buffers); stage 2 trained, its backbone BN affine frozen
    snapshot = ckpt_lib.load(stage1_run / "pemp_stage1" / "1"
                             / ckpt_lib.BEST)["model"]
    cascade = built[0]
    after = cascade.stage1.state_dict()
    assert set(after) == set(snapshot)
    assert all(torch.equal(after[k], v) for k, v in snapshot.items())
    assert len(built) == 2          # train, then the chained test
    trained = ckpt_lib.load(run_dir / ckpt_lib.CKPT)["model"]
    fresh = entry2.ex.assemble("train", dict(
        a.split("=", 1) for a in SMALL + ["s1.id=1"]))
    fresh.g.model_dir = str(stage1_run)
    seeded = build(fresh, torch.device("cpu")).stage2.state_dict()
    for key in ("encoder.backbone.bn1.weight",
                "encoder.backbone.layer1.0.downsample.1.bias"):
        assert torch.equal(seeded[key], trained[key]), key
    for key in ("ctr", "encoder.backbone.linear1.weight",
                "encoder.purifier.6.layer6.weight"):
        assert not torch.equal(seeded[key], trained[key]), key


def test_stage2_test_takes_s1_ckpt_as_a_path(stage1_run):
    path = stage1_run / "pemp_stage1" / "1" / ckpt_lib.CKPT
    result = entry2.main(["test", "with", *SMALL, "dev.device=cpu",
                          f"s1.ckpt={path}"])
    assert math.isfinite(result["miou"]) and result["device"] == "cpu"


def test_stage2_without_a_stage1_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        entry2.main(["test", "with", *SMALL, "dev.device=cpu",
                     f"g.model_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError):
        entry2.main(["test", "with", *SMALL, "dev.device=cpu",
                     f"g.model_dir={tmp_path}", "s1.id=3"])


def test_stage2_entry_needs_cuda_unless_asked_for_the_cpu(stage1_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry2.main(["test", "with", *SMALL, f"g.model_dir={stage1_run}",
                     "s1.id=1"])


def test_stage2_visualize_is_not_ported():
    with pytest.raises(SystemExit, match="not yet ported"):
        entry2.main(["visualize", "with", *SMALL, "dev.device=cpu"])


def test_stage2_config_has_no_grad_clip_and_the_s1_scope():
    cfg = entry2.ex.assemble("train", {"split": "0", "s1.id": "4",
                                       "s1.tag": "mine"})
    assert cfg.tr.grad_clip == 0.0 and cfg.tag == "pemp_stage2"
    assert (cfg.s1.id, cfg.s1.ckpt, cfg.s1.tag) == (4, "", "mine")
    assert (cfg.net.backbone2, cfg.net.protos2, cfg.net.drop_rate2,
            cfg.net.cm) == ("resnet50", 3, 0.5, True)
