"""CaNet's history-mask store and the dataset adapter that reads it.

Copy of ``pemp_tpu/data/history.py``. Every query carries its previous
1/8-resolution softmax prediction (zeros at first); after each train step
and eval batch the new softmax is written back, keyed by (class, sample
name). Two semantics make what an episode sees a pure function of the
episode stream:

1. **Epoch-snapshot reads.** ``next_epoch()`` (called whenever the task
   stream is resampled: a train epoch or an eval round) copies the live
   store; reads come from that copy and writes go to the live store. So
   the loader's threads and prefetch depth never change what an episode
   reads.
2. **Reset draws.** In training a sample's history is reset to zeros
   with probability 0.3 when it is loaded (reference pascal_voc.py
   :420-431): ``crc32(f"{seed}/{epoch}/{idx}/{cls}/{name}") / 2**32 < 0.3``.
   The epoch is the ADAPTER's count of its own resamples, not the
   store's: the store is shared by the train and eval adapters, and a
   resumed run replays exactly its train resamples
   (``core/trainer.py``).
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Tuple

import numpy as np

RESET_P = 0.3


class HistoryStore:
    """Per-sample history [h8, w8, 2] keyed by (class, name); thread-safe
    (the loader reads on its threads while the trainer writes)."""

    def __init__(self, h8: int, w8: int, seed: int = 1234):
        self.h8 = h8
        self.w8 = w8
        self.seed = int(seed)
        self._store: Dict[Tuple[int, str], np.ndarray] = {}
        self._snapshot: Dict[Tuple[int, str], np.ndarray] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def next_epoch(self) -> None:
        """A new epoch or eval round: the write-backs so far become
        visible to reads."""
        with self._lock:
            self._snapshot = dict(self._store)

    def get(self, cls: int, name, train: bool, idx: int = 0,
            epoch: int = 0) -> np.ndarray:
        """History of one query load; ``(epoch, idx)`` name the load for
        the reset draw, which only ``train`` takes."""
        key = (int(cls), name)
        with self._lock:
            hist = self._snapshot.get(key)
        if hist is None or (train and self.reset_draw(key, epoch, idx)):
            return np.zeros((self.h8, self.w8, 2), np.float32)
        return hist

    def reset_draw(self, key: Tuple[int, str], epoch: int, idx: int) -> bool:
        h = zlib.crc32(
            f"{self.seed}/{epoch}/{idx}/{key[0]}/{key[1]}".encode())
        return h / 2 ** 32 < RESET_P

    def put(self, cls: int, name, softmax: np.ndarray) -> None:
        with self._lock:
            self._store[(int(cls), name)] = np.asarray(softmax, np.float32)

    def keys(self):
        with self._lock:
            return set(self._store)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._snapshot.clear()


class CaNetDataAdapter:
    """Wraps an episodic dataset: adds ``history`` [Q, h8, w8, 2] to every
    episode and advances the store's snapshot whenever the task stream is
    resampled. The wrapped dataset returns sample names (``ret_name``)."""

    def __init__(self, dataset, store: HistoryStore, train: bool):
        self.dataset = dataset
        self.store = store
        self.train = train
        self.epoch = 0          # this adapter's resamples only
        self.dataset.ret_name = True

    def __getattr__(self, item):
        return getattr(self.dataset, item)

    def __len__(self):
        return len(self.dataset)

    def sample_tasks(self):
        self.epoch += 1
        self.store.next_epoch()
        return self.dataset.sample_tasks()

    def get_episode(self, idx: int):
        ep = self.dataset.get_episode(idx)
        hist = [self.store.get(ep["cls"], n, self.train, idx, self.epoch)
                for n in ep["qry_names"]]
        ep["history"] = np.stack(hist)
        return ep
