"""Minimal COCO annotation index, without pycocotools.

Copy of ``pemp_tpu/data/coco_index.py``: the part of the
``pycocotools.coco.COCO`` API the reference uses (data_kits/coco.py:122,
:163, :219, :233, :254-261), image and annotation lookup from the
annotation JSON, and ``annToMask`` through the port's rasterizer
(``data/mask_ops.py``; ``native=False`` takes its numpy versions).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from pemp_tpu_torch.data import mask_ops


class COCOIndex:
    def __init__(self, annotation_file, native: bool = True):
        self.native = native
        with open(annotation_file) as f:
            data = json.load(f)
        self.imgs: Dict[int, dict] = {im["id"]: im for im in data["images"]}
        self.anns: Dict[int, dict] = {a["id"]: a
                                      for a in data.get("annotations", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, set] = defaultdict(set)
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.cat_to_imgs[ann["category_id"]].add(ann["image_id"])

    # --- pycocotools-compatible subset ---------------------------------
    def getImgIds(self, catIds=None) -> List[int]:
        if catIds is None:
            return sorted(self.imgs)
        if isinstance(catIds, int):
            catIds = [catIds]
        ids = None
        for c in catIds:
            s = self.cat_to_imgs.get(c, set())
            ids = s if ids is None else ids & s
        return sorted(ids or [])

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, (int, np.integer)):
            ids = [int(ids)]
        return [self.imgs[int(i)] for i in ids]

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return sorted(self.anns)
        if isinstance(imgIds, (int, np.integer)):
            imgIds = [int(imgIds)]
        out = []
        for i in imgIds:
            out.extend(a["id"] for a in self.img_to_anns.get(int(i), []))
        return out

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, (int, np.integer)):
            ids = [int(ids)]
        return [self.anns[int(i)] for i in ids]

    def annToMask(self, ann: dict) -> np.ndarray:
        meta = self.imgs[ann["image_id"]]
        return mask_ops.ann_to_mask(ann, meta["height"], meta["width"],
                                    self.native)
