"""Host-side episodic batch loader with background prefetch.

Copy of ``pemp_tpu/data/loader.py``: a thread pool renders the episodes
of each batch and a bounded queue keeps ``prefetch`` batches ready; with
``shard_by_process`` (the train loader) each process of a world reads its
equal-length, rank-strided shard of the episode list
(``parallel.mesh.process_episode_indices``). Batches are plain numpy
dicts; the steps move them to the device (``parallel/step.py``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from pemp_tpu_torch.parallel.mesh import process_episode_indices


def _collate(episodes) -> Dict:
    """Stacks each array key; ``cls`` becomes an int32 vector and the
    sample names stay lists (one list per episode). Query GT of sizes
    that differ between episodes (the test GT at its original
    resolution) stays a list of per-episode arrays."""
    batch = {}
    for key in episodes[0]:
        vals = [ep[key] for ep in episodes]
        if key in ("sup_names", "qry_names"):
            batch[key] = [list(v) for v in vals]
        elif key == "cls":
            batch[key] = np.asarray(vals, np.int32)
        elif any(v.shape != vals[0].shape for v in vals):
            batch[key] = vals
        else:
            batch[key] = np.stack(vals)
    return batch


class EpisodeLoader:
    """Iterates batches over the dataset's pre-sampled tasks, in order;
    ``drop_last`` (training) leaves out a short last batch;
    ``shard_by_process`` reads this process's shard of them (the seeded
    task list is the same on every process)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = False,
                 shard_by_process: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.shard_by_process = shard_by_process

    def _indices(self):
        n = len(self.dataset)
        return process_episode_indices(n) if self.shard_by_process \
            else list(range(n))

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _batches(self):
        idx = self._indices()
        stop = len(self) * self.batch_size if self.drop_last else len(idx)
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in self._batches():
                        if stop.is_set():
                            return
                        eps = list(pool.map(self.dataset.get_episode, chunk))
                        if not put(_collate(eps)):
                            return
            except BaseException as e:  # surface worker errors to consumer
                put(e)
                return
            put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=5.0)
