"""Episode assembly shared by the PASCAL-5i and COCO-20i datasets.

The part that ``pemp_tpu/data/pascal.py`` and ``pemp_tpu/data/coco.py``
each spell out (reference data_kits/pascal_voc.py:184-240): a subclass
provides ``get_image(name)`` and ``get_label(cls, name)`` (PIL images,
the label in {0, 255}), and this class turns a sampled task into an
episode, with the JAX package's draws from Python's ``random`` in its
order:

- train support: a random 1-1.5x scale, ColorJitter, a flip shared by
  image and mask, the smart crop (before normalising: normalising is
  elementwise, so the crop is bit-identical and the scaled border is
  never normalised);
- train query: resize to the input, jitter, shared flip;
- test: deterministic resize; the query GT stays at its ORIGINAL
  resolution (reference :229).

Episode contract (channels-last), as ``data/synthetic.py``'s, with
``qry_msk`` [Q, H', W'] at test time.
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np

from pemp_tpu_torch.data import transforms as T
from pemp_tpu_torch.data.sampler import EpisodeSampler


class EpisodicDataset:
    """Training episodes (``train``: the classes ``train_classes``,
    ``data.train_n`` an epoch from ``data.seed``) or test episodes (the
    split's ``test_classes``, ``data.test_n`` a round from
    ``data.test_seed``); ``ret_name`` adds the sample names."""

    def __init__(self, cfg, train: bool, split: int, shot: int, query: int,
                 ret_name: bool = False):
        self.cfg = cfg
        self.train = train
        self.split = split
        self.shot = shot
        self.query = query
        self.ret_name = ret_name
        self.cache = cfg.data.cache
        self.height = cfg.data.height
        self.width = cfg.data.width

    def _make_sampler(self, classes, samples_by_class) -> None:
        self.classes = list(classes)
        self.samples_by_class = samples_by_class
        n, seed = ((self.cfg.data.train_n, self.cfg.data.seed) if self.train
                   else (self.cfg.data.test_n, self.cfg.data.test_seed))
        self.sampler = EpisodeSampler(
            self.classes, samples_by_class, n, self.shot, self.query, seed,
            one_cls=self.cfg.data.one_cls)

    # --- the dataset surface the loops use ---------------------------------
    def reset_sampler(self):
        self.sampler.reset()

    def sample_tasks(self):
        self.sampler.sample_tasks()

    def __len__(self):
        return len(self.sampler)

    # --- hooks ---------------------------------------------------------------
    def get_image(self, name):
        raise NotImplementedError

    def get_label(self, cls: int, name):
        raise NotImplementedError

    def crop(self, arr: np.ndarray, msk: np.ndarray, cls: int, name,
             scaled) -> tuple:
        """The train support's crop (COCO replaces a corrupt label)."""
        return T.smart_crop(arr, msk, self.height, self.width)

    def episode_cls(self, cls: int) -> int:
        """The class id an episode reports."""
        return cls

    def sample_name(self, name):
        """A sample name as an episode reports it."""
        return name

    # --- episode assembly ----------------------------------------------------
    def _normalize(self, img):
        return T.normalize(img, self.cfg.data.mean, self.cfg.data.std)

    def _support(self, cls: int, name):
        hw = (self.height, self.width)
        if self.train:
            factor = random.uniform(1, 1.5)
            scaled = (int(self.height * factor), int(self.width * factor))
            flip = random.random() >= 0.5
            img = T.color_jitter(T.resize_image(self.get_image(name), scaled))
            if flip:
                img = T.hflip_image(img)
            msk = T.resize_mask(self.get_label(cls, name), scaled)
            if flip:
                msk = T.hflip_image(msk)
            arr, msk = self.crop(np.asarray(img.convert("RGB")),
                                 np.array(msk, np.uint8), cls, name, scaled)
            rgb = self._normalize(arr)
        else:
            rgb = self._normalize(T.resize_image(self.get_image(name), hw))
            msk = np.array(T.resize_mask(self.get_label(cls, name), hw),
                           np.uint8)
        fg = (msk // 255).astype(np.float32)
        return rgb, np.stack([fg, 1.0 - fg], axis=-1)

    def _query(self, cls: int, name):
        hw = (self.height, self.width)
        if self.train:
            flip = random.random() >= 0.5
            img = T.color_jitter(T.resize_image(self.get_image(name), hw))
            if flip:
                img = T.hflip_image(img)
            rgb = self._normalize(img)
            msk = T.resize_mask(self.get_label(cls, name), hw)
            if flip:
                msk = T.hflip_image(msk)
            msk = np.array(msk, np.uint8)
        else:
            rgb = self._normalize(T.resize_image(self.get_image(name), hw))
            # the query GT stays at its ORIGINAL resolution (reference :229)
            msk = np.array(self.get_label(cls, name), np.uint8)
        return rgb, (msk // 255).astype(np.int32)

    def get_episode(self, idx: int) -> Dict:
        cls, names = self.sampler.tasks[idx]
        sup_names, qry_names = names[:self.shot], names[self.shot:]
        sup = [self._support(cls, n) for n in sup_names]
        qry = [self._query(cls, n) for n in qry_names]
        ep = {
            "sup_rgb": np.stack([s[0] for s in sup]).astype(np.float32),
            "sup_mask": np.stack([s[1] for s in sup]).astype(np.float32),
            "qry_rgb": np.stack([q[0] for q in qry]).astype(np.float32),
            "qry_msk": np.stack([q[1] for q in qry]),
            "cls": self.episode_cls(cls),
        }
        if self.ret_name:
            ep["sup_names"] = [self.sample_name(n) for n in sup_names]
            ep["qry_names"] = [self.sample_name(n) for n in qry_names]
        return ep
