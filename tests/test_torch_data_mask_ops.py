"""The port's COCO rasterizer (``pemp_tpu_torch/data/mask_ops.py``): its
C++ library, built with ``g++`` from the port's own copy of the source,
and its numpy versions against the frozen fixtures of
``tests/test_coco_rasterizer_golden.py`` (imported), the pure-Python
oracle ``tests/pycoco_oracle.py`` on randomised polygons, and the JAX
package's ``decode_rle`` on compressed-string and uncompressed RLEs.
Both versions must agree bit for bit. A failed build raises, with no
numpy fallback.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from pemp_tpu.data import mask_ops as jax_mask_ops
from pemp_tpu.data.coco_index import COCOIndex as JaxIndex
from pemp_tpu_torch.data import mask_ops
from pemp_tpu_torch.data.coco_index import COCOIndex
from tests.pycoco_oracle import polys_to_mask as oracle_mask
from tests.test_coco_rasterizer_golden import FIXTURES

ROOT = Path(__file__).resolve().parents[1]
VERSIONS = [True, False]
VERSION_IDS = ["native", "numpy"]


def encode_counts(counts) -> str:
    """COCO's compressed count string (pycocotools ``rleToString``)."""
    s = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = x != (-1 if ch & 0x10 else 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


def encode_rle(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths of a {0, 1} mask, starting with a 0-run."""
    flat = mask.T.ravel()
    counts, val, run = [], 0, 0
    for px in flat:
        if px == val:
            run += 1
        else:
            counts.append(run)
            run, val = 1, px
    counts.append(run)
    return np.asarray(counts, np.uint32)


def test_the_library_is_built_from_the_port_source():
    assert mask_ops.SOURCE == (ROOT / "pemp_tpu_torch" / "data" / "native"
                               / "coco_mask.cpp")
    mask_ops.get_lib()
    assert mask_ops.loaded()
    path = mask_ops.lib_path()
    assert path.exists() and path.parent == ROOT / "build" / "pemp_tpu_torch"


def test_a_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    broken = tmp_path / "coco_mask.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(mask_ops, "SOURCE", broken)
    monkeypatch.setattr(mask_ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(mask_ops, "_LIB", None)
    poly = [[2, 2, 10, 2, 10, 8, 2, 8]]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        mask_ops.polys_to_mask(poly, 12, 14)
    with pytest.raises(RuntimeError):
        mask_ops.decode_rle({"size": [4, 4], "counts": [3, 5, 8]})
    assert not mask_ops.loaded()
    # the numpy version runs when asked for by name
    assert mask_ops.polys_to_mask(poly, 12, 14, native=False).sum() == 48


@pytest.mark.parametrize("native", VERSIONS, ids=VERSION_IDS)
@pytest.mark.parametrize("name,polys,h,w,n_fg,digest", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_frozen_fixture(name, polys, h, w, n_fg, digest, native):
    mask = mask_ops.polys_to_mask(polys, h, w, native=native)
    assert mask.shape == (h, w) and mask.dtype == np.uint8
    assert int(mask.sum()) == n_fg
    assert hashlib.sha256(mask.tobytes()).hexdigest()[:16] == digest


def test_both_versions_equal_the_oracle_on_random_polygons():
    rng = np.random.RandomState(3)
    for _ in range(60):
        h, w = rng.randint(8, 48), rng.randint(8, 48)
        k = rng.randint(3, 10)
        poly = (rng.rand(k * 2) * np.array([w, h] * k) * 1.2 - 2).tolist()
        want = oracle_mask([poly], h, w)
        for native in VERSIONS:
            np.testing.assert_array_equal(
                mask_ops.polys_to_mask([poly], h, w, native=native), want)
    for _ in range(20):         # unions of rings
        h, w = rng.randint(12, 40), rng.randint(12, 40)
        polys = [(rng.rand(rng.randint(3, 7) * 2) * min(h, w)).tolist()
                 for _ in range(rng.randint(2, 4))]
        want = oracle_mask(polys, h, w)
        for native in VERSIONS:
            np.testing.assert_array_equal(
                mask_ops.polys_to_mask(polys, h, w, native=native), want)


def _rle_cases():
    counts = np.asarray([3, 5, 2, 7, 11, 1], np.uint32)
    rng = np.random.RandomState(0)
    mask = (rng.rand(23, 31) > 0.6).astype(np.uint8)
    blob = np.zeros((40, 50), np.uint8)
    blob[5:30, 8:41] = 1
    blob[12:20, 15:25] = 0
    return [
        # tests/test_mask_ops.py's string case: one column of its length
        {"size": [int(counts.sum()), 1], "counts": encode_counts(counts)},
        {"size": [23, 31], "counts": encode_counts(encode_rle(mask))},
        {"size": [40, 50], "counts": encode_counts(encode_rle(blob))},
        {"size": [23, 31], "counts": encode_rle(mask).tolist()},
        {"size": [5, 5], "counts": [3, 5, 2, 7, 4]},    # odd tail
    ]


@pytest.mark.parametrize("native", VERSIONS, ids=VERSION_IDS)
@pytest.mark.parametrize("case", range(5))
def test_rle_decode_equals_the_jax_package(case, native):
    rle = _rle_cases()[case]
    want = jax_mask_ops.decode_rle(dict(rle))
    got = mask_ops.decode_rle(dict(rle), native=native)
    assert got.dtype == np.uint8 and got.shape == tuple(rle["size"])
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(mask_ops.rle_from_string_np(
        encode_counts([3, 5, 2, 7, 11, 1]).encode()), [3, 5, 2, 7, 11, 1])


def test_coco_index_masks_equal_the_jax_package(tmp_path):
    ring = [2.5, 2.25, 18.75, 3, 17, 14.5, 3.2, 12]
    data = {
        "images": [{"id": 7, "height": 20, "width": 24, "file_name": "a"}],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 5,
             "segmentation": [ring, [10, 10, 22, 10, 22, 19, 10, 19]]},
            {"id": 2, "image_id": 7, "category_id": 5,
             "segmentation": {"size": [20, 24], "counts": [30, 12, 400, 38]}},
            {"id": 3, "image_id": 7, "category_id": 9, "bbox": [1, 1, 2, 2]},
        ],
    }
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(data))
    jax_index = JaxIndex(path)
    for native in VERSIONS:
        index = COCOIndex(path, native=native)
        assert index.getImgIds(catIds=5) == [7] == jax_index.getImgIds(5)
        for ann in index.loadAnns(index.getAnnIds(imgIds=7)):
            np.testing.assert_array_equal(index.annToMask(ann),
                                          jax_index.annToMask(ann))
