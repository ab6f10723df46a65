"""The port's COCO-20i loader (``pemp_tpu_torch/data/coco.py``) against
the JAX package's (``pemp_tpu/data/coco.py``) on a miniature COCO tree
(``tests/fixtures.py::make_fake_coco``, two categories a split, varied
original sizes) with more annotations written into it: a multi-ring
polygon with fractional vertices, an uncompressed and a compressed RLE,
another category's instance in the same image, and an image whose
instance has no area. Test episodes bit for bit, every key and the
integer names; train episodes bit for bit after seeding ``random``; the
file list JSON equal to the JAX package's and read across packages; the
corrupt-label fallback.
"""

import json
import random
import shutil

import numpy as np
import pytest

from pemp_tpu.config import Config as JaxConfig
from pemp_tpu.config.base import apply_overrides as jax_overrides
from pemp_tpu.data.coco import COCO20i as JaxCOCO
from pemp_tpu.models import registry as jax_registry
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.data.coco import CV_SPLIT, NEW_INDEX, COCO20i
from pemp_tpu_torch.entry import pemp_stage1 as entry
from tests.fixtures import make_fake_coco
from tests.test_torch_data_mask_ops import encode_counts, encode_rle
from tests.test_torch_data_pascal import assert_episodes_equal

CATS = [CV_SPLIT[s][j] for s in range(4) for j in range(2)]
EMPTY_ID = 999          # an image whose only instance has no area


def enrich(root):
    """More annotation kinds in both subsets of the tree under ``root``."""
    for subset in ("train2014", "val2014"):
        path = root / "annotations" / f"instances_{subset}.json"
        blob = json.loads(path.read_text())
        images = {im["id"]: im for im in blob["images"]}
        anns = blob["annotations"]
        next_id = max(a["id"] for a in anns) + 1
        by_cat = {}
        for a in list(anns):
            by_cat.setdefault(a["category_id"], []).append(a["image_id"])
        for k, (cat, ids) in enumerate(sorted(by_cat.items())):
            h, w = images[ids[0]]["height"], images[ids[0]]["width"]
            rings = [[3.5, 30.25, 20.75, 28, 18.2, h - 4.6, 2.6, h - 6],
                     [w - 20.4, 4.5, w - 3.3, 6.75, w - 8.5, 20.25]]
            rles = []
            for img_id in ids[1:3]:
                mask = np.zeros((images[img_id]["height"],
                                 images[img_id]["width"]), np.uint8)
                mask[2 + k:20, 40:55 + k] = 1
                rles.append({"size": list(mask.shape),
                             "counts": encode_rle(mask).tolist()})
            rles[1]["counts"] = encode_counts(rles[1]["counts"])
            other = CATS[(k + 1) % len(CATS)]
            new = [(ids[0], cat, rings), (ids[1], cat, rles[0]),
                   (ids[2], cat, rles[1]),
                   (ids[0], other, [[40, 40, 50, 40, 50, 50, 40, 50]])]
            for img_id, c, seg in new:
                anns.append({"id": next_id, "image_id": img_id,
                             "category_id": c, "segmentation": seg})
                next_id += 1
        first = blob["images"][0]
        blob["images"].append({**first, "id": EMPTY_ID})
        anns.append({"id": next_id, "image_id": EMPTY_ID,
                     "category_id": CATS[0],
                     "segmentation": [[5, 5, 9, 5, 14, 5]]})
        path.write_text(json.dumps(blob))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_fake_coco(root, cats=CATS, per_cat=3,
                   size=lambda cat, i: (58 + 3 * i + cat % 5, 80 + cat % 7))
    enrich(root)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def configs(root, **extra):
    overrides = {"split": "1", "data.dataset": "COCO",
                 "data.base_dir": str(root), "data.height": "41",
                 "data.width": "41", "data.train_n": "6", "data.test_n": "6",
                 "data.cache": "False", **extra}
    cfg = entry.ex.assemble("test", overrides)
    jcfg = JaxConfig()
    jcfg.net = jax_registry.net_config("pemp_stage1")
    jax_overrides(jcfg, overrides)
    return cfg, jcfg


def pinned(root, cls, **extra):
    return configs(root, **{"data.one_cls": str(cls), **extra})


@pytest.mark.parametrize("split", [1, 3])
def test_test_episodes_equal_the_jax_package(coco_root, split):
    cfg, jcfg = pinned(coco_root, CV_SPLIT[split][0])
    ours = COCO20i(cfg, False, split, 1, 1, ret_name=True)
    ref = JaxCOCO(jcfg, False, split, 1, 1, ret_name=True)
    assert ours.classes == ref.classes == CV_SPLIT[split]
    for ds in (ours, ref):
        ds.reset_sampler()
        ds.sample_tasks()
    sizes = set()
    for i in range(len(ours)):
        a, b = ours.get_episode(i), ref.get_episode(i)
        assert_episodes_equal(a, b)
        assert a["cls"] == NEW_INDEX[CV_SPLIT[split][0]]
        assert all(type(n) is int for n in a["qry_names"] + a["sup_names"])
        sizes.add(a["qry_msk"].shape)
    assert len(sizes) > 1           # the GT at its original resolution


@pytest.mark.parametrize("cache", ["False", "True"])
def test_train_episodes_equal_after_seeding(coco_root, cache):
    cfg, jcfg = pinned(coco_root, CV_SPLIT[2][1], **{"data.cache": cache})
    ours = COCO20i(cfg, True, 1, 1, 1)
    ref = JaxCOCO(jcfg, True, 1, 1, 1)
    assert ours.classes == ref.classes and CV_SPLIT[1][0] not in ours.classes
    for ds in (ours, ref):
        ds.sample_tasks()
    for i in range(len(ours)):
        random.seed(7 * i)
        a = ours.get_episode(i)
        random.seed(7 * i)
        b = ref.get_episode(i)
        assert_episodes_equal(a, b)
        assert a["qry_msk"].shape == (1, 41, 41)


def test_masks_are_the_union_of_the_class_instances(coco_root):
    cfg, jcfg = configs(coco_root)
    ours = COCO20i(cfg, False, 0, 1, 1)
    ref = JaxCOCO(jcfg, False, 0, 1, 1)
    for cat in CATS:
        for img_id in ours.coco.getImgIds(catIds=cat):
            a = np.array(ours.get_label(cat, img_id))
            np.testing.assert_array_equal(a, np.array(
                ref.get_label(cat, img_id)))
            assert set(np.unique(a)) <= {0, 255}
    # a contiguous id names the same mask as its original id
    np.testing.assert_array_equal(
        np.array(ours.get_label(NEW_INDEX[CATS[3]], 1, new_label=True)),
        np.array(ours.get_label(CATS[3], 1)))


def test_file_list_equals_the_jax_package_and_is_read_across(coco_root,
                                                             tmp_path,
                                                             capsys):
    root = tmp_path / "coco"
    shutil.copytree(coco_root, root)
    for f in root.glob("*_list_*.json"):
        f.unlink()
    cfg, jcfg = configs(root)
    lists = {}
    for train, subset in ((True, "train2014_list_16"),
                          (False, "val2014_list_0")):
        path = root / f"{subset}.json"
        COCO20i(cfg, train, 1, 1, 1)
        ours = path.read_text()
        path.unlink()
        JaxCOCO(jcfg, train, 1, 1, 1)
        assert path.read_text() == ours
        lists[train] = json.loads(ours)
        capsys.readouterr()
        # either package reads the other's list without generating one
        a, b = COCO20i(cfg, train, 1, 1, 1), JaxCOCO(jcfg, train, 1, 1, 1)
        assert "Generating" not in capsys.readouterr().out
        assert a.samples_by_class == b.samples_by_class
    assert set(lists[True]) == {str(c) for s in CV_SPLIT for c in s}
    # the empty instance is dropped at threshold 16, kept at 0
    assert EMPTY_ID not in lists[True][str(CATS[0])]
    assert EMPTY_ID in lists[False][str(CATS[0])]
    shutil.rmtree(root, ignore_errors=True)


def test_corrupt_label_falls_back_to_a_box(coco_root, tmp_path, capsys):
    """A list that names an image whose mask is empty (written by hand:
    generation leaves it out) gives both packages the centred box."""
    root = tmp_path / "coco"
    shutil.copytree(coco_root, root)
    cat = CATS[0]
    cfg, jcfg = pinned(root, cat, **{"split": "2"})
    listing = {str(c): [] for s in CV_SPLIT for c in s}
    listing[str(cat)] = [EMPTY_ID, 1, 2]
    (root / "train2014_list_16.json").write_text(json.dumps(listing))
    ours, ref = COCO20i(cfg, True, 2, 1, 1), JaxCOCO(jcfg, True, 2, 1, 1)
    for ds in (ours, ref):
        ds.sample_tasks()
    hit = 0
    for i in range(len(ours)):
        random.seed(i)
        a = ours.get_episode(i)
        printed = capsys.readouterr().out
        random.seed(i)
        b = ref.get_episode(i)
        assert_episodes_equal(a, b)
        if EMPTY_ID == ours.sampler.tasks[i][1][0]:
            hit += 1
            assert f"error pic name {EMPTY_ID}" in printed
    assert hit > 0
    shutil.rmtree(root, ignore_errors=True)


def test_datasets_load_coco(coco_root, tmp_path):
    cfg, _ = configs(coco_root)
    ds, loader, n = datasets.load(cfg, "test")
    assert isinstance(ds, COCO20i) and n == 80
    assert datasets.get_val_labels(cfg, 1) == list(range(21, 41))
    assert datasets.get_class_name(NEW_INDEX[CV_SPLIT[1][0]],
                                   "COCO") == "bicycle"
    cfg.data.base_dir = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        datasets.load(cfg, "test")
