"""Episodic task sampler with reference-identical draw semantics.

Copy of ``pemp_tpu/data/sampler.py``: all episodes of a round are drawn
up front from a seeded ``np.random.RandomState`` stream (reference
data_kits/pascal_voc.py:118-135) -- per episode ``choice(classes)``, then
``choice(len(class_list), size=shot+query, replace=False)`` -- so equal
seeds give the JAX package's episode streams.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class EpisodeSampler:
    def __init__(self,
                 classes: Sequence[int],
                 samples_by_class: Dict[int, List],
                 n_episodes: int,
                 shot: int,
                 query: int,
                 seed: int,
                 one_cls: int = 0):
        self.classes = list(classes)
        self.samples_by_class = samples_by_class
        self.n_episodes = n_episodes
        self.shot = shot
        self.query = query
        self.seed = seed
        self.one_cls = one_cls
        self.tasks: List[Tuple[int, List]] = []
        self.reset()

    def reset(self):
        """Reset the RNG stream (reference ``reset_sampler`` :118-122)."""
        self.rng = np.random.RandomState(self.seed)

    def sample_tasks(self):
        """Draw the next ``n_episodes`` (class, names) tasks from the
        stream (reference ``sample_tasks`` :124-135)."""
        self.tasks = []
        k = self.shot + self.query
        if self.one_cls <= 0:
            for _ in range(self.n_episodes):
                cls = int(self.rng.choice(self.classes))
                names = self.samples_by_class[cls]
                indices = self.rng.choice(len(names), size=k, replace=False)
                self.tasks.append((cls, [names[j] for j in indices]))
        else:
            cls = self.one_cls
            names = self.samples_by_class[cls]
            for _ in range(self.n_episodes):
                indices = self.rng.choice(len(names), size=k, replace=False)
                self.tasks.append((cls, [names[j] for j in indices]))
        return self.tasks

    def __len__(self):
        return self.n_episodes
