"""The port's entries on the PASCAL-5i and COCO-20i loaders (miniature
trees from ``tests/fixtures.py``, varied original sizes), as
``tests/test_entry_{pascal,coco}_e2e.py`` drive the JAX package's:
PEMP stage 1 ``train`` (cedt) with its online eval and chained ``test``
on PASCAL, stage 2's ``test`` behind it, then ``visualize`` of that run
on the variable-size GT (and of one chosen episode of class 20, whose
name holds a ``/``); ``test`` and a short ``train`` on COCO (the file
lists generated on the first load); the other five families' ``test``
on PASCAL through the same ``datasets.load``; and
a missing root raising ``FileNotFoundError`` through the entry. ResNet-50
is cut to one bottleneck a stage (``RESNET_LAYERS``) to keep the CPU run
short; every tree and run folder is removed when its test ends.
"""

import importlib
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pemp_tpu_torch.data.coco import CV_SPLIT
from pemp_tpu_torch.entry import pemp_stage1 as entry
from pemp_tpu_torch.entry import pemp_stage2 as entry2
from pemp_tpu_torch.models import common as port_common
from tests.fixtures import make_fake_coco, make_fake_voc
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401

SMALL = ["split=0", "data.height=41", "data.width=41", "data.bs=2",
         "data.train_n=4", "data.test_bs=2", "data.test_n=3",
         "data.num_workers=2", "te.epochs=1", "tr.total_epochs=1",
         "dev.device=cpu", "dev.precision=f32"]


@pytest.fixture(autouse=True)
def cut_resnet(monkeypatch):
    monkeypatch.setitem(port_common.RESNET_LAYERS, "resnet50", (1, 1, 1))


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with what the test wrote."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_entry")
    make_fake_voc(root, seed=7,
                  size=lambda c, i: (48 + c + 3 * i, 64 + 2 * i))
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_entry")
    # every category: the entry samples over the split's whole class list
    make_fake_coco(root, cats=[c for s in CV_SPLIT for c in s], per_cat=2,
                   seed=3, size=lambda cat, i: (56 + 2 * i, 72 + 4 * i))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_pascal_train_chained_test_and_visualize(voc_root, tmp_path,
                                                 monkeypatch):
    data = ["data.dataset=PASCAL", f"data.base_dir={voc_root}"]
    result = entry.main(["train", "with", *SMALL, *data, "loss=cedt",
                         f"g.model_dir={tmp_path}"])
    losses = result["train"]["losses"]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    for key in ("loss", "miou", "biou"):
        assert math.isfinite(result["test"][key]), result["test"]
    run = tmp_path / "pemp_stage1" / "1"
    metrics = json.loads((run / "metrics.json").read_text())
    assert set(metrics) == {"train_loss", "val_loss", "val_mIoU", "val_bIoU"}
    assert np.all(np.isfinite([v for _, v in metrics["val_mIoU"]]))

    # the stage-2 cascade behind that run, on the same tree
    result = entry2.main(["test", "with", *SMALL, *data, "s1.id=1", "-u",
                          f"g.model_dir={tmp_path}"])
    assert math.isfinite(result["miou"])

    monkeypatch.setenv("PEMP_HTTP_STATIC", str(tmp_path / "static"))
    folder = entry.main(["visualize", "with", *SMALL, *data, "exp_id=1",
                         "data.test_bs=1", f"g.model_dir={tmp_path}"])
    episodes = sorted(p for p in (tmp_path / "static").glob("*/*")
                      if p.is_dir())
    assert folder.endswith("1_pascal_1shot_pemp_stage1_s0")
    assert len(episodes) == 3
    for ep in episodes:
        info = json.loads((ep / "data.json").read_text())
        cname = info["cls_name"].replace("/", "_")
        qry = info["qry"]
        gt = np.array(Image.open(ep / f"{cname}_qry_msk_{qry}.png"))
        pred = np.array(Image.open(ep / f"{cname}_qry_pred_{qry}.png"))
        src = np.array(Image.open(voc_root / "Binary_map_aug" / "val"
                                  / str(info["cls_id"]) / f"{qry}.png"))
        # drawn at the query GT's original resolution
        np.testing.assert_array_equal(gt, src)
        assert pred.shape == gt.shape and set(np.unique(pred)) <= {0, 255}
        assert (ep / f"{cname}_sup_img_{info['sup']}.jpg").exists()

    # one chosen episode of class 20: "tv/monitor" becomes "tv_monitor"
    folder = entry.main(["visualize", "with", *SMALL, *data, "exp_id=1",
                         "split=3", "p.cls=20", "p.sup=val_20_0",
                         "p.qry=val_20_1", f"g.model_dir={tmp_path}"])
    (ep,) = [p for p in (tmp_path / "static" / Path(folder).name).iterdir()]
    assert json.loads((ep / "data.json").read_text())["cls_name"] == \
        "tv/monitor"
    assert (ep / "tv_monitor_qry_pred_val_20_1.png").exists()


def test_coco_test_and_train(coco_root, tmp_path):
    data = ["data.dataset=COCO", f"data.base_dir={coco_root}"]
    result = entry.main(["test", "with", *SMALL, *data, "-u"])
    for key in ("loss", "miou", "biou"):
        assert math.isfinite(result[key]), result
    assert (coco_root / "val2014_list_0.json").exists()
    # unobserved, the trainer still writes a final ckpt-<time>.pt there
    result = entry.main(["train", "with", *SMALL, *data, "-u",
                         f"g.model_dir={tmp_path}"])
    assert len(result["train"]["losses"]) == 2
    assert (coco_root / "train2014_list_16.json").exists()


@pytest.mark.parametrize("family", ["baseline", "panet", "canet", "rpmms",
                                    "pfenet"])
def test_the_other_families_test_on_pascal(voc_root, family):
    module = importlib.import_module(f"pemp_tpu_torch.entry.{family}")
    result = module.main(["test", "with", *SMALL, "data.dataset=PASCAL",
                          f"data.base_dir={voc_root}", "-u"])
    assert math.isfinite(result["miou"]) and result["device"] == "cpu"


@pytest.mark.parametrize("dataset", ["PASCAL", "COCO"])
def test_a_missing_root_raises(tmp_path, dataset):
    with pytest.raises(FileNotFoundError, match="data.base_dir"):
        entry.main(["test", "with", *SMALL, f"data.dataset={dataset}",
                    f"data.base_dir={tmp_path / 'missing'}", "-u"])
