"""Host -> device batches: the wire format and the device prefetcher.

Counterpart of ``pemp_tpu/parallel/step.py``'s ``WIRE_DTYPES``,
``device_batch``, ``unpack_batch`` and ``DevicePrefetcher``. The JAX
package's jitted train step and its sharding become the port's
``Trainer.train_step`` under ``DistributedDataParallel``
(``core/experiment.py``); its fused step (``tpu.fuse_steps``) is not
ported.

- Images and history travel as float16, masks and the prior as uint8,
  ``cls`` as int32 (``dev.compact_wire``, 2.4x fewer bytes than float32);
  ``unpack_batch`` restores the compute dtypes on the device.
- On a CUDA device the host arrays are converted straight into pinned
  buffers, on the calling thread alone, and copied with
  ``non_blocking=True``; a CPU build cannot pin, so the CPU path copies
  plainly.
- ``DevicePrefetcher`` makes the next batches' copies on a side CUDA
  stream while the current step computes. Only copies run there: the
  kernels take ``torch.cuda.current_stream()`` and keep their tickets per
  stream (``ops/kernels/mpm.py``), so all compute stays on the consumer's
  stream, which waits on an event recorded after each batch's copies.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable

import numpy as np
import torch

from pemp_tpu_torch.parallel import mesh

ARRAY_KEYS = ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk",
              "history", "qry_prior")   # 'cls' stays on the host (metrics)

JOIN_S = 30.0           # how long an abandoned prefetcher waits for its thread

WIRE_DTYPES = {
    "sup_rgb": np.float16, "qry_rgb": np.float16,
    "sup_mask": np.uint8, "qry_msk": np.uint8,
    "history": np.float16, "qry_prior": np.uint8,
    "cls": np.int32,
}
UNPACK_DTYPES = {
    "sup_rgb": torch.float32, "qry_rgb": torch.float32,
    "sup_mask": torch.float32, "qry_msk": torch.int32,
    "history": torch.float32, "qry_prior": torch.float32,
    "cls": torch.int32,
}
_TORCH_WIRE_DTYPES = {k: torch.from_numpy(np.empty(0, v)).dtype
                      for k, v in WIRE_DTYPES.items()}


def gt_mismatch(batch: Dict) -> bool:
    """Query GT stacked at another size than the query images (the test
    GT at its original resolution): it stays on the host, where the eval
    step resizes each episode to it."""
    q, r = batch.get("qry_msk"), batch.get("qry_rgb")
    return (isinstance(q, np.ndarray) and isinstance(r, np.ndarray)
            and tuple(q.shape[-2:]) != tuple(r.shape[2:4]))


@contextmanager
def _calling_thread_only():
    """torch's CPU ops on the calling thread alone. A cast or copy of more
    than torch's grain of elements runs on all its intra-op threads, and
    waits for the slowest: on cores that the loader's threads share, the
    serial path's train step took 50-53 ms that way against 37-43 ms with
    the casts on the calling thread (``input_times.py`` on an H100 host)."""
    n = torch.get_num_threads()
    if n == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _to_device(v: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """One host array as a ``dtype`` tensor on ``device``: on CUDA through
    a pinned buffer that the cast writes into on the calling thread,
    copied without blocking. The cast is torch's (vectorised; numpy's
    float16 cast is not, and takes ~15x longer), rounding to nearest even
    as numpy's does."""
    torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    src = torch.from_numpy(np.ascontiguousarray(v))
    if device.type != "cuda":
        return src.to(torch_dtype).to(device)
    buf = torch.empty(v.shape, dtype=torch_dtype, pin_memory=True)
    with _calling_thread_only():
        buf.copy_(src)
    return buf.to(device, non_blocking=True)


def device_batch(batch: Dict, device: torch.device, compact_wire: bool = True,
                 keys: Iterable[str] = ARRAY_KEYS) -> Dict:
    """The numpy arrays ``keys`` of a host batch as tensors on ``device``,
    in the wire format when ``compact_wire``; tensors pass through
    untouched, and query GT whose size differs from the query images
    stays on the host (``gt_mismatch``)."""
    mismatch = gt_mismatch(batch)
    out = {}
    for k in keys:
        v = batch.get(k)
        if k == "qry_msk" and mismatch:
            continue
        if isinstance(v, np.ndarray):
            dtype = WIRE_DTYPES[k] if compact_wire and k in WIRE_DTYPES \
                else v.dtype
            out[k] = _to_device(v, dtype, device)
        elif isinstance(v, torch.Tensor):
            out[k] = v
    return out


def unpack_batch(batch: Dict) -> Dict:
    """The compute dtypes of a device batch (on its device): a tensor that
    travelled on the compact wire (its key's wire dtype) is restored; any
    other keeps the dtype its loader gave it, as on the plain wire (a
    float64 batch stays float64)."""
    return {k: (v.to(UNPACK_DTYPES[k]) if isinstance(v, torch.Tensor)
                and k in WIRE_DTYPES
                and v.dtype == _TORCH_WIRE_DTYPES[k] else v)
            for k, v in batch.items()}


def broadcast_batch(batch: Dict) -> Dict:
    """Rank 0's device tensors on every process: a loader whose every
    process reads the whole stream augments through Python's global
    ``random``, so the processes' pixels differ (the JAX package's
    ``divergent_hosts``)."""
    if mesh.process_count() == 1:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            v = v.contiguous()
            torch.distributed.broadcast(v, 0)
            out[k] = v
    return out


def take_rows(batch: Dict, rows: slice) -> Dict:
    """The rows ``rows`` of every array of a batch: tensors, numpy arrays
    and per-episode lists; ``cls`` and the sample names too."""
    return {k: v[rows] for k, v in batch.items()}


class DevicePrefetcher:
    """Wraps a host batch iterator: a thread converts and copies the next
    ``depth`` batches to ``device`` while the current step computes. Each
    yielded batch holds the host keys beside the device ones (a runtime's
    ``post_step`` and the metrics read the host's ``cls`` and names).

    On CUDA the copies run on a side stream; the consumer's stream waits
    on an event recorded after each batch's copies, and every tensor is
    ``record_stream``-ed on the consumer's stream, so that its memory is
    not reused before the consumer's work on it ends. A producer's
    exception is raised in the consumer; when the consumer stops early,
    the thread stops, the queue is emptied and no batch is left held."""

    def __init__(self, loader, device: torch.device, depth: int = 2,
                 compact_wire: bool = True, keys: Iterable[str] = ARRAY_KEYS):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self.compact_wire = compact_wire
        self.keys = tuple(keys)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        device = self.device
        if cuda:
            # the thread's current card is not the consumer's: name it
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            consumer = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)

        def safe_put(item):
            # stop-aware: a blocking put would leave the thread waiting
            # forever, holding device batches, once the consumer is gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def copy(host_batch):
            dev = dict(host_batch)
            if not cuda:
                dev.update(device_batch(host_batch, device,
                                        self.compact_wire, self.keys))
                return dev, None
            with torch.cuda.device(device), torch.cuda.stream(side):
                moved = device_batch(host_batch, device,
                                     self.compact_wire, self.keys)
                done = torch.cuda.Event()
                done.record(side)
            dev.update(moved)
            return dev, done

        def produce():
            try:
                for host_batch in self.loader:
                    if stop.is_set():
                        return
                    safe_put(copy(host_batch))
            except BaseException as e:
                safe_put(e)
                return
            safe_put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                dev, done = item
                if done is not None:
                    consumer.wait_event(done)
                    for v in dev.values():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(consumer)
                yield dev
        finally:
            stop.set()
            # drop what is queued, so that no batch stays held; the thread
            # ends at its next batch boundary
            deadline = time.monotonic() + JOIN_S
            while thread.is_alive() and time.monotonic() < deadline:
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            while not q.empty():
                q.get_nowait()
