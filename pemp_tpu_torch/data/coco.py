"""COCO-20i episodic dataset.

Counterpart of ``pemp_tpu/data/coco.py`` (reference data_kits/coco.py):

- the interleaved 4x20 split of the 80 categories (``CV_SPLIT``,
  reference :16-19); the sampler draws ORIGINAL category ids, and an
  episode reports the contiguous id ``NEW_INDEX[cls]`` in 1..80
  (reference :35-38, :352) and, with ``ret_name``, integer image ids;
- the file list, generated once: images whose class mask has fewer than
  16 foreground (or background) pixels are left out of training (0 for
  testing), and the list is kept in the dataset root as
  ``<subset>_list_<threshold>.json`` (``{"<category id>": [image ids]}``,
  the JAX package's name and format, so either package reads the
  other's; reference :124, :131-172, :369);
- class masks rasterised from the polygon and RLE annotations, the union
  of the class's instances in {0, 255} (reference :240-270), through
  ``data/coco_index.py`` and the port's C++ rasterizer
  (``data/mask_ops.py``);
- a corrupt label (no foreground to crop around) becomes a centred box,
  so training goes on (reference :307-319);
- the augmentation and the original-resolution test query GT of
  ``data/episodic.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
from PIL import Image

from pemp_tpu_torch.data import transforms as T
from pemp_tpu_torch.data.coco_index import COCOIndex
from pemp_tpu_torch.data.episodic import EpisodicDataset

CV_SPLIT = [
    [1, 5, 9, 14, 18, 22, 27, 33, 37, 41, 46, 50, 54, 58, 62, 67, 74, 78, 82, 87],
    [2, 6, 10, 15, 19, 23, 28, 34, 38, 42, 47, 51, 55, 59, 63, 70, 75, 79, 84, 88],
    [3, 7, 11, 16, 20, 24, 31, 35, 39, 43, 48, 52, 56, 60, 64, 72, 76, 80, 85, 89],
    [4, 8, 13, 17, 21, 25, 32, 36, 40, 44, 49, 53, 57, 61, 65, 73, 77, 81, 86, 90],
]
CLASS_NAMES = [
    ["person", "airplane", "boat", "parking meter", "dog", "elephant",
     "backpack", "suitcase", "sports ball", "skateboard", "wine glass",
     "spoon", "sandwich", "hot dog", "chair", "dining table", "mouse",
     "microwave", "refrigerator", "scissors"],
    ["bicycle", "bus", "traffic light", "bench", "horse", "bear",
     "umbrella", "frisbee", "kite", "surfboard", "cup", "bowl", "orange",
     "pizza", "couch", "toilet", "remote", "oven", "book", "teddy bear"],
    ["car", "train", "fire hydrant", "bird", "sheep", "zebra", "handbag",
     "skis", "baseball bat", "tennis racket", "fork", "banana", "broccoli",
     "donut", "potted plant", "tv", "keyboard", "toaster", "clock",
     "hair drier"],
    ["motorcycle", "truck", "stop sign", "cat", "cow", "giraffe", "tie",
     "snowboard", "baseball glove", "bottle", "knife", "apple", "carrot",
     "cake", "bed", "laptop", "cell phone", "sink", "vase", "toothbrush"],
]

# original category id -> contiguous 1..80 (reference :35-38)
NEW_INDEX = {CV_SPLIT[i][j]: i * 20 + j + 1
             for i in range(4) for j in range(20)}

# keyed by (image dir, id): ids collide across roots and subsets
_image_cache: Dict[tuple, Image.Image] = {}
_label_cache: Dict[tuple, np.ndarray] = {}


def class_name(new_cls: int) -> str:
    return CLASS_NAMES[(new_cls - 1) // 20][(new_cls - 1) % 20]


class COCO20i(EpisodicDataset):
    def __init__(self, cfg, train: bool, split: int, shot: int, query: int,
                 ret_name: bool = False):
        super().__init__(cfg, train, split, shot, query, ret_name)
        base = Path(cfg.data.base_dir)
        subset = "train2014" if train else "val2014"
        self.img_dir = base / subset
        self.coco = COCOIndex(
            base / "annotations" / f"instances_{subset}.json")
        self.threshold = 16 if train else 0
        self.list_path = base / f"{subset}_list_{self.threshold}.json"
        if train:
            others = sorted({0, 1, 2, 3} - {split})
            classes = sum((CV_SPLIT[s] for s in others), [])
        else:
            classes = list(CV_SPLIT[split])
        sample_list = self.load_file_list()
        self._make_sampler(classes, {c: sample_list[str(c)] for c in classes})

    @property
    def num_classes(self):
        return 80

    # --- file list --------------------------------------------------------
    def load_file_list(self) -> Dict[str, list]:
        """``{"<category id>": [image ids]}`` of all 80 categories, read
        from ``list_path`` or generated and written there."""
        if self.list_path.exists():
            return json.loads(self.list_path.read_text())
        print(f"No sample list found. Generating now "
              f"(threshold={self.threshold}) ...")
        sample_by_class, removed = {}, 0
        for cls in (c for split in CV_SPLIT for c in split):
            keep = []
            for img_id in self.coco.getImgIds(catIds=cls):
                label = self.rasterize(cls, img_id)
                if (np.count_nonzero(255 - label) < self.threshold
                        or np.count_nonzero(label) < self.threshold):
                    removed += 1    # too little background or foreground
                else:
                    keep.append(img_id)
            sample_by_class[str(cls)] = keep
        print(f"{removed} samples are removed.")
        tmp = self.list_path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(sample_by_class))
        os.replace(tmp, self.list_path)
        return sample_by_class

    # --- IO ---------------------------------------------------------------
    def get_image(self, img_id) -> Image.Image:
        key = (str(self.img_dir), int(img_id))
        if self.cache and key in _image_cache:
            return _image_cache[key]
        meta = self.coco.loadImgs(int(img_id))[0]
        img = Image.open(self.img_dir / meta["file_name"]).convert("RGB")
        if self.cache:
            _image_cache[key] = img
        return img

    def rasterize(self, cls: int, img_id: int) -> np.ndarray:
        """The union of the image's instance masks of ``cls`` as {0, 255}
        uint8 (reference :240-270)."""
        meta = self.coco.loadImgs(img_id)[0]
        sem = np.zeros((meta["height"], meta["width"]), np.uint8)
        for ann in self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id)):
            if ann["category_id"] == cls:
                sem[self.coco.annToMask(ann) == 1] = 255
        return sem

    def get_label(self, cls, img_id, new_label: bool = False) -> Image.Image:
        """The class mask; ``new_label``: ``cls`` is a contiguous id."""
        cls, img_id = int(cls), int(img_id)
        if new_label:
            cls = CV_SPLIT[(cls - 1) // 20][(cls - 1) % 20]
        key = (str(self.img_dir), cls, img_id)
        if self.cache and key in _label_cache:
            return Image.fromarray(_label_cache[key])
        sem = self.rasterize(cls, img_id)
        if self.cache:
            _label_cache[key] = sem
        return Image.fromarray(sem)

    # --- episode hooks ----------------------------------------------------
    def crop(self, arr, msk, cls, img_id, scaled):
        try:
            return T.smart_crop(arr, msk, self.height, self.width)
        except (ValueError, IndexError):
            # corrupt label: a centred box (reference :307-319)
            meta = self.coco.loadImgs(int(img_id))[0]
            print(f"error pic name {img_id}, class is {cls}, "
                  f"({meta.get('coco_url', '')})")
            msk = np.zeros(scaled, np.uint8)
            h_, w_ = msk.shape
            msk[h_ // 2 - h_ // 8:h_ // 2 + h_ // 8,
                w_ // 2 - w_ // 8:w_ // 2 + w_ // 8] = 1
            return T.smart_crop(arr, msk, self.height, self.width)

    def episode_cls(self, cls: int) -> int:
        return NEW_INDEX[cls]

    def sample_name(self, name) -> int:
        return int(name)
