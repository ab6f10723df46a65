"""The port's PASCAL-5i loader (``pemp_tpu_torch/data/pascal.py``) against
the JAX package's (``pemp_tpu/data/pascal.py``) on a miniature VOC tree
with varied original sizes (``tests/fixtures.py::make_fake_voc``): test
episodes bit for bit, every key and the names; train episodes bit for
bit after ``random.seed(k)`` before each package's draw; the batches of
both loaders, the query GT of different sizes kept as a list; the
dataset root and the class names through ``datasets``.
"""

import random
import shutil

import numpy as np
import pytest

from pemp_tpu.config import Config as JaxConfig
from pemp_tpu.config.base import apply_overrides as jax_overrides
from pemp_tpu.data.loader import EpisodeLoader as JaxLoader
from pemp_tpu.data.pascal import PascalVOC as JaxPascal
from pemp_tpu.models import registry as jax_registry
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.data.loader import EpisodeLoader
from pemp_tpu_torch.data.pascal import PascalVOC
from pemp_tpu_torch.entry import pemp_stage1 as entry
from tests.fixtures import make_fake_voc


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    # all 20 classes, both subsets, a size of its own per (class, sample)
    make_fake_voc(root, per_class=4, size=lambda c, i: (46 + c, 60 + 5 * i))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def configs(root, **extra):
    """The port's config and the JAX package's, from the same overrides."""
    overrides = {"split": "2", "data.dataset": "PASCAL",
                 "data.base_dir": str(root), "data.height": "41",
                 "data.width": "37", "data.train_n": "6", "data.test_n": "6",
                 "data.cache": "False", **extra}
    cfg = entry.ex.assemble("test", overrides)
    jcfg = JaxConfig()
    jcfg.net = jax_registry.net_config("pemp_stage1")
    jax_overrides(jcfg, overrides)
    return cfg, jcfg


def assert_episodes_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key] and type(a[key]) is type(b[key]), key


@pytest.mark.parametrize("shot", [1, 2])
def test_test_episodes_equal_the_jax_package(voc_root, shot):
    cfg, jcfg = configs(voc_root)
    ours = PascalVOC(cfg, False, 2, shot, 1, ret_name=True)
    ref = JaxPascal(jcfg, False, 2, shot, 1, ret_name=True)
    assert ours.classes == ref.classes == [11, 12, 13, 14, 15]
    sizes = set()
    for ds in (ours, ref):
        ds.reset_sampler()
        ds.sample_tasks()
    for i in range(len(ours)):
        a, b = ours.get_episode(i), ref.get_episode(i)
        assert_episodes_equal(a, b)
        # the query GT at its original resolution (reference :229)
        sizes.add(a["qry_msk"].shape)
        assert a["sup_rgb"].shape == (shot, 41, 37, 3)
    assert len(sizes) > 1


@pytest.mark.parametrize("cache", ["False", "True"])
def test_train_episodes_equal_after_seeding(voc_root, cache):
    cfg, jcfg = configs(voc_root, **{"data.cache": cache})
    ours = PascalVOC(cfg, True, 2, 1, 1, ret_name=True)
    ref = JaxPascal(jcfg, True, 2, 1, 1, ret_name=True)
    assert ours.classes == ref.classes
    for ds in (ours, ref):
        ds.sample_tasks()
    assert ours.sampler.tasks == ref.sampler.tasks
    for i in range(len(ours)):
        random.seed(100 + i)
        a = ours.get_episode(i)
        random.seed(100 + i)
        b = ref.get_episode(i)
        assert_episodes_equal(a, b)
        assert a["qry_msk"].shape == (1, 41, 37)
        assert a["sup_mask"][..., 0].sum() > 0      # the smart crop


def test_test_batches_keep_variable_gt_as_a_list(voc_root):
    cfg, jcfg = configs(voc_root)
    ours = PascalVOC(cfg, False, 2, 1, 1)
    ref = JaxPascal(jcfg, False, 2, 1, 1)
    for ds in (ours, ref):
        ds.sample_tasks()
    got = list(EpisodeLoader(ours, 4, num_workers=2))
    want = list(JaxLoader(ref, 4, num_workers=2))
    assert [len(b["cls"]) for b in got] == [4, 2]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert isinstance(a["qry_msk"], list) and isinstance(b["qry_msk"],
                                                             list)
        for x, y in zip(a["qry_msk"], b["qry_msk"]):
            np.testing.assert_array_equal(x, y)
        for key in ("sup_rgb", "sup_mask", "qry_rgb", "cls"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_cached_images_and_labels_are_decoded(voc_root):
    cfg, _ = configs(voc_root, **{"data.cache": "True"})
    ds = PascalVOC(cfg, True, 0, 1, 1)
    cls = ds.classes[0]
    name = ds.samples_by_class[cls][0]
    assert getattr(ds.get_label(cls, name), "im", None) is not None
    assert getattr(ds.get_image(name), "im", None) is not None


def test_datasets_load_resolves_the_root(voc_root, tmp_path):
    cfg, _ = configs(voc_root)
    ds, loader, n = datasets.load(cfg, "visualize")
    assert isinstance(ds, PascalVOC) and n == 20 and ds.ret_name
    assert loader.batch_size == cfg.data.test_bs
    assert datasets.get_class_name(20, "PASCAL") == "tv/monitor"
    assert datasets.get_val_labels(cfg, 2) == [11, 12, 13, 14, 15]
    cfg.data.base_dir = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError, match="data.base_dir"):
        datasets.load(cfg, "train")
