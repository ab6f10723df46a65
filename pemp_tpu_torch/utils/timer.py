"""Wall-clock step timer (copy of ``pemp_tpu/utils/timer.py``; reference
utils/timer.py): total seconds inside ``start()`` blocks."""

from __future__ import annotations

import time
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self.total = 0.0

    @contextmanager
    def start(self):
        tic = time.perf_counter()
        try:
            yield self
        finally:
            self.total += time.perf_counter() - tic
