"""PASCAL-5i episodic dataset.

Counterpart of ``pemp_tpu/data/pascal.py`` (reference
data_kits/pascal_voc.py):

- the 4x5 class split (``CV_SPLIT``, reference :13-16): split s holds out
  classes 5s+1..5s+5 for testing and trains on the other 15;
- class sample lists from ``Binary_map_aug/{train,val}/<cls>.txt``
  (reference :151), images from ``JPEGImages/<name>.jpg``, masks in
  {0, 255} from ``Binary_map_aug/{train,val}/<cls>/<name>.png``;
- seeded episodes from ``data/sampler.py``;
- the augmentation and the original-resolution test query GT of
  ``data/episodic.py``.

With ``data.cache`` the decoded images and labels stay in host RAM,
keyed by (directory, name): bare names collide across dataset roots and
subsets. A label is decoded before it goes into the cache, because
``Image.open`` is lazy and two loader threads racing the first decode of
one shared image crash inside PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

from PIL import Image

from pemp_tpu_torch.data.episodic import EpisodicDataset

CV_SPLIT = [[1, 2, 3, 4, 5],
            [6, 7, 8, 9, 10],
            [11, 12, 13, 14, 15],
            [16, 17, 18, 19, 20]]
CLASS_NAMES = [
    ["aeroplane", "bicycle", "bird", "boat", "bottle"],
    ["bus", "car", "cat", "chair", "cow"],
    ["diningtable", "dog", "horse", "motorbike", "person"],
    ["potted plant", "sheep", "sofa", "train", "tv/monitor"],
]

_image_cache: Dict[tuple, Image.Image] = {}
_label_cache: Dict[tuple, Image.Image] = {}


def class_name(cls: int) -> str:
    return CLASS_NAMES[(cls - 1) // 5][(cls - 1) % 5]


class PascalVOC(EpisodicDataset):
    def __init__(self, cfg, train: bool, split: int, shot: int, query: int,
                 ret_name: bool = False):
        super().__init__(cfg, train, split, shot, query, ret_name)
        base = Path(cfg.data.base_dir)
        self.img_dir = base / "JPEGImages"
        self.lab_dir = base / "Binary_map_aug" / ("train" if train else "val")
        classes = (sorted(set(range(1, 21)) - set(CV_SPLIT[split])) if train
                   else list(CV_SPLIT[split]))
        self._make_sampler(classes, {
            c: (self.lab_dir / f"{c}.txt").read_text().strip().splitlines()
            for c in classes})

    @property
    def num_classes(self):
        return 20

    def get_image(self, name: str) -> Image.Image:
        key = (str(self.img_dir), name)
        if self.cache and key in _image_cache:
            return _image_cache[key]
        img = Image.open(self.img_dir / f"{name}.jpg").convert("RGB")
        if self.cache:
            _image_cache[key] = img
        return img

    def get_label(self, cls: int, name: str) -> Image.Image:
        key = (str(self.lab_dir), cls, name)
        if self.cache and key in _label_cache:
            return _label_cache[key]
        img = Image.open(self.lab_dir / str(cls) / f"{name}.png")
        if self.cache:
            img.load()          # decoded before another thread can see it
            _label_cache[key] = img
        return img
