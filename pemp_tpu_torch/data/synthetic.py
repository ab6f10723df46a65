"""Synthetic episodic dataset (dataset name ``SYNTH``).

Copy of ``pemp_tpu/data/synthetic.py`` without its variable-size-GT
emulation (``data.var_gt``): procedurally generated
images and blob masks keyed by sample name, with the same episode
contract and sampler semantics as the real PASCAL-5i / COCO-20i loaders,
so equal seeds give the JAX package's episodes.

Episode contract (channels-last):
  sup_rgb  [S, H, W, 3] f32    sup_mask [S, H, W, 2] f32 (fg, bg)
  qry_rgb  [Q, H, W, 3] f32    qry_msk  [Q, H, W]    i32
  cls      int
  sup_names, qry_names  lists of sample names (``ret_name``; CaNet's
                        history store keys on them)
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

from pemp_tpu_torch.data.sampler import EpisodeSampler

N_CLASSES = 20           # PASCAL-like
SAMPLES_PER_CLASS = 40


class SyntheticDataset:
    """Training episodes (``train``: every class but the split's 5,
    ``data.train_n`` episodes an epoch from ``data.seed``) or test
    episodes (the split's 5 val classes, ``data.test_n`` a round from
    ``data.test_seed``). ``ret_name`` adds the sample names to each
    episode."""

    def __init__(self, cfg, train: bool, split: int, shot: int, query: int,
                 ret_name: bool = False):
        self.cfg = cfg
        self.train = train
        self.split = split
        self.shot = shot
        self.query = query
        self.ret_name = ret_name
        self.height = cfg.data.height
        self.width = cfg.data.width
        val = list(range(split * 5 + 1, split * 5 + 6))
        if train:
            self.classes = sorted(set(range(1, N_CLASSES + 1)) - set(val))
            n, seed = cfg.data.train_n, cfg.data.seed
        else:
            self.classes = val
            n, seed = cfg.data.test_n, cfg.data.test_seed
        self.samples_by_class = {
            c: [f"synth_{c:02d}_{i:03d}" for i in range(SAMPLES_PER_CLASS)]
            for c in self.classes}
        self.sampler = EpisodeSampler(
            self.classes, self.samples_by_class, n, shot, query, seed,
            one_cls=cfg.data.one_cls)
        self._render_cache = {}

    def reset_sampler(self):
        self.sampler.reset()

    def sample_tasks(self):
        self.sampler.sample_tasks()

    def __len__(self):
        return len(self.sampler)

    @property
    def num_classes(self):
        return N_CLASSES

    def _render(self, name: str):
        """Deterministic image + blob mask for a sample name (cached when
        ``data.cache``: the render is a pure function of the name)."""
        if self.cfg.data.cache and name in self._render_cache:
            return self._render_cache[name]
        out = self._render_uncached(name, self.height, self.width)
        if self.cfg.data.cache:
            self._render_cache[name] = out
        return out

    @staticmethod
    def _render_uncached(name: str, h: int, w: int):
        # zlib.crc32 is stable across processes (python str hash is salted)
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        img = rng.rand(h, w, 3).astype(np.float32)
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
        ry, rx = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
        yy, xx = np.ogrid[:h, :w]
        mask = ((yy - cy) ** 2 / ry ** 2 + (xx - cx) ** 2 / rx ** 2 <= 1.0)
        img[mask] += 0.5   # make fg statistically separable
        return img, mask.astype(np.float32)

    def get_episode(self, idx: int) -> Dict:
        cls, names = self.sampler.tasks[idx]
        sup_names, qry_names = names[:self.shot], names[self.shot:]
        sup_rgb, sup_mask = [], []
        for n in sup_names:
            img, m = self._render(n)
            sup_rgb.append(img)
            sup_mask.append(np.stack([m, 1.0 - m], axis=-1))
        qry_rgb, qry_msk = [], []
        for n in qry_names:
            img, m = self._render(n)
            qry_rgb.append(img)
            qry_msk.append(m.astype(np.int32))
        ep = {
            "sup_rgb": np.stack(sup_rgb),
            "sup_mask": np.stack(sup_mask),
            "qry_rgb": np.stack(qry_rgb),
            "qry_msk": np.stack(qry_msk),
            "cls": cls,
        }
        if self.ret_name:
            ep["sup_names"] = sup_names
            ep["qry_names"] = qry_names
        return ep
