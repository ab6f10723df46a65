"""``net.backbone=vgg16`` through both PEMP entries on the CPU at 33x33
(SYNTH, cedt, f32): stage 1 trains a VGG16 (no purifier, nothing frozen,
clip 1.1) and chains into ``test``; stage 2 trains the VGG16CM cascade
behind it (``net.backbone2=vgg16``: the entry sets clip 1.1), records
stage 2's keys only, leaves stage 1 bit-equal and chains into ``test``.
The module's model dir is removed after its last test.
"""

import math
import shutil

import pytest
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.entry import pemp_stage1 as entry1
from pemp_tpu_torch.entry import pemp_stage2 as entry2
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.train_n=4", "data.test_bs=2", "data.test_n=4",
         "te.epochs=1", "loss=cedt", "data.num_workers=2", "tr.total_epochs=1",
         "dev.precision=f32", "net.backbone=vgg16"]


@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    """A model dir holding one trained PEMP-VGG16 stage-1 run (id 1) and
    its result; removed, with what the tests add, after the last test."""
    root = tmp_path_factory.mktemp("model_dir")
    result = entry1.main(["train", "with", *SMALL, "dev.device=cpu",
                          f"g.model_dir={root}"])
    yield root, result
    shutil.rmtree(root, ignore_errors=True)


def test_stage1_vgg16_trains_and_chains_into_test(stage1_run):
    root, result = stage1_run
    train = result["train"]
    assert train["run_id"] == 1 and len(train["losses"]) == 2
    assert all(math.isfinite(x) for x in train["losses"])
    assert math.isfinite(result["test"]["miou"])
    got = ckpt_lib.load(root / "pemp_stage1" / "1" / ckpt_lib.BEST)["model"]
    want = PEMPStage1(backbone="vgg16").state_dict()
    assert set(got) == set(want)
    assert got["ctr"].shape == (512, 6)
    assert not any("purifier" in k for k in got)


def test_stage2_vgg16_cascade_trains_and_chains_into_test(stage1_run,
                                                          monkeypatch):
    root, _ = stage1_run
    built, clips = [], []
    build = entry2.build_model

    def keep(cfg, device):
        built.append(build(cfg, device))
        clips.append(cfg.tr.grad_clip)
        return built[-1]

    monkeypatch.setattr(entry2, "build_model", keep)
    result = entry2.main(["train", "with", *SMALL, "net.backbone2=vgg16",
                          "dev.device=cpu", f"g.model_dir={root}", "s1.id=1",
                          "tr.lr=0.0035"])
    train = result["train"]
    assert train["run_id"] == 1 and len(train["losses"]) == 2
    assert all(math.isfinite(x) for x in train["losses"])
    assert math.isfinite(result["test"]["miou"])
    assert clips == [1.1, 1.1]
    want = PEMPStage2(backbone="vgg16").state_dict()
    for name in (ckpt_lib.CKPT, ckpt_lib.BEST):
        got = ckpt_lib.load(root / "pemp_stage2" / "1" / name)["model"]
        assert set(got) == set(want), name
        assert all(got[k].shape == want[k].shape for k in want), name
    snapshot = ckpt_lib.load(root / "pemp_stage1" / "1" / ckpt_lib.BEST)
    after = built[0].stage1.state_dict()
    assert all(torch.equal(after[k], v) for k, v in snapshot["model"].items())


@pytest.mark.parametrize("backbone,backbone2,clip", [
    ("vgg16", "vgg16", 1.1), ("resnet50", "vgg16", 1.1),
    ("vgg16", "", 1.1), ("vgg16", "resnet50", 0.0),
    ("resnet50", "resnet50", 0.0)])
def test_stage2_clips_vgg16_only(backbone, backbone2, clip):
    cfg = entry2.ex.assemble("train", {"split": "0", "net.backbone": backbone,
                                       "net.backbone2": backbone2})
    assert cfg.tr.grad_clip == 0.0
    assert entry2.Stage2Runtime(cfg).cfg.tr.grad_clip == clip
