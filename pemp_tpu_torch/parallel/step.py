"""Host -> device batches (the wire format and the device prefetcher)
and the fused multi-step train launch.

Counterpart of ``pemp_tpu/parallel/step.py``'s ``WIRE_DTYPES``,
``device_batch``, ``unpack_batch``, ``DevicePrefetcher`` and
``make_train_step_fused`` (:166). The JAX package's jitted train step and
its sharding become the port's ``Trainer.train_step`` under
``DistributedDataParallel`` (``core/experiment.py``); its fused step
(``tpu.fuse_steps``, k steps as one ``lax.scan`` launch) becomes
``FusedTrainStep`` (``dev.fuse_steps``): k train steps captured in one
CUDA graph and replayed once a chunk of k batches.

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
- ``FusedTrainStep``: see the class.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from pemp_tpu_torch.core import solver
from pemp_tpu_torch.ops.kernels import minplus, mpm
from pemp_tpu_torch.parallel import mesh
from pemp_tpu_torch.utils.profiling import span

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


# eager steps of each batch signature before its capture: PyTorch's recipe
# warms a whole network up for 3 iterations on the capture stream;
# DistributedDataParallel rebuilds its buckets during its first 10
WARMUP_STEPS = 3
DDP_WARMUP_STEPS = 11
_KERNEL_MODULES = (mpm, minplus)


class _Graph:
    """One captured chunk: its graph, static inputs (the k batches in
    their wire dtypes), the [k] LR slot, the [k] losses and the stacked
    aux, and the K1-K5 launches recorded at its capture (by kernel)."""

    def __init__(self, inputs: List[Dict[str, torch.Tensor]],
                 lr: torch.Tensor):
        self.graph = torch.cuda.CUDAGraph()
        self.inputs = inputs
        self.lr = lr
        self.losses: Optional[torch.Tensor] = None
        self.aux: Optional[torch.Tensor] = None
        self.recorded: Dict[str, int] = {}


class FusedTrainStep:
    """``fused(batches, lrs) -> (losses [k], auxes [k, ...] or None)``:
    ``k = fuse_steps`` train steps of ``step(t, lr) -> (loss, aux)`` on
    the k batches (host or prefetched; ``device_batch`` of each), step j
    at the LR ``lrs[j]`` (``solver.lr_tensor``'s 0-dim view). ``step``
    takes a device batch in its wire dtypes and does one whole train
    step: unpack, forward, loss, ``zero_grad(set_to_none=True)``,
    backward, clip, ``solver.step``. The losses and, with ``with_aux``,
    the auxes (CaNet's feature-resolution logits) come back stacked on a
    leading [k] axis and stay on the device.

    On the CPU (asked for by name, as the tests do) it is the plain
    version: the k eager steps in a loop. On CUDA it is the counterpart
    of the JAX package's ``lax.scan`` of k steps, after PyTorch's
    whole-network capture recipe:

    - the first ``warmup_steps`` steps of each batch signature (shapes
      and dtypes of the k batches) run eagerly on a side stream, in whole
      chunks. They are real steps of the run, and they make what a
      capture may not: the cuBLAS and cuDNN state, the momentum buffers,
      the kernels' plans and tickets, the resize matrices;
    - then ``optimizer.zero_grad(set_to_none=True)`` and one capture of
      the k steps on that stream into a graph of its own: k static input
      slots, the [k] LR slot, the [k] losses and aux; ``generators`` (the
      trainer's dropout generator) are registered with it, so a replay
      draws at the generator's live seed and offset, as the eager steps
      would. Each capture is logged, and a failure raises;
    - each later chunk of that signature is device-to-device copies into
      the slots (the wire format is unpacked inside the graph), one
      pinned copy of the k LRs and one replay. ``replays`` counts them,
      and ``replayed`` the K1-K5 launches they made (each adds what its
      capture recorded: a replay leaves the kernels' ``launches``
      counts as they were).

    A chunk takes exactly k batches: the epoch tail runs through the
    serial step (``Trainer._run_epoch``).

    Under a profiler a call is the span ``fused.launch``, and inside it
    ``fused.wire`` (the k ``device_batch`` calls), then ``fused.warm_up``,
    ``fused.capture``, or ``fused.slots`` (the slot and LR copies),
    ``fused.replay`` and ``fused.outputs`` (the clones)
    (``utils/profiling.py::span``). A replay runs no Python: the kernels
    it launches have no span of the model's."""

    def __init__(self, step: Callable, fuse_steps: int, device,
                 optimizer: torch.optim.Optimizer, compact_wire: bool = True,
                 keys: Iterable[str] = ARRAY_KEYS, with_aux: bool = False,
                 generators: Sequence[torch.Generator] = (),
                 warmup_steps: int = WARMUP_STEPS, logger=None):
        if fuse_steps < 2:
            raise ValueError(f"fuse_steps={fuse_steps}: a fused launch takes "
                             "at least 2 steps (1 is the serial loop)")
        self.step = step
        self.fuse_steps = fuse_steps
        self.device = torch.device(device)
        self.optimizer = optimizer
        self.compact_wire = compact_wire
        self.keys = tuple(keys)
        self.with_aux = with_aux
        self.generators = tuple(generators)
        self.warmup_steps = warmup_steps
        self.logger = logger
        self.graphs: Dict[tuple, _Graph] = {}
        self.warm: Dict[tuple, int] = {}
        self.captures = 0
        self.replays = 0
        self.replayed: Dict[str, int] = {}
        self.eager_steps = 0
        self.side = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)

    def __call__(self, batches: Sequence, lrs: Sequence[float]):
        k = self.fuse_steps
        if len(batches) != k or len(lrs) != k:
            raise ValueError(
                f"the fused step takes {k} batches and LRs, got "
                f"{len(batches)} and {len(lrs)}: run epoch tails through "
                "the serial step")
        with span("fused.launch"):
            with span("fused.wire"):
                dev = [device_batch(b, self.device, self.compact_wire,
                                    self.keys) for b in batches]
            if self.device.type != "cuda":
                return self._eager(dev, lrs)
            sig = tuple(tuple((key, tuple(v.shape), v.dtype)
                              for key, v in sorted(t.items())) for t in dev)
            graph = self.graphs.get(sig)
            if graph is None:
                if self.warm.get(sig, 0) < self.warmup_steps:
                    self.warm[sig] = self.warm.get(sig, 0) + k
                    return self._warm_up(dev, lrs)
                with span("fused.capture"):
                    graph = self.graphs[sig] = self._capture(sig, dev)
            return self._replay(graph, dev, lrs)

    def _host_lrs(self, lrs) -> torch.Tensor:
        """The k LRs in ``solver.lr_tensor``'s dtype on the host (pinned
        for a CUDA device, whose copy then does not wait)."""
        dtype = solver.lr_tensor(self.device, (0,)).dtype
        host = torch.tensor(list(lrs), dtype=dtype)
        return host.pin_memory() if self.device.type == "cuda" else host

    def _eager(self, dev, lrs):
        lr = self._host_lrs(lrs).to(self.device, non_blocking=True)
        outs = [self.step(t, lr[j]) for j, t in enumerate(dev)]
        self.eager_steps += len(outs)
        losses = torch.stack([o[0] for o in outs])
        aux = torch.stack([o[1] for o in outs]) if self.with_aux else None
        return losses, aux

    def _warm_up(self, dev, lrs):
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        with span("fused.warm_up"), torch.cuda.stream(self.side):
            losses, aux = self._eager(dev, lrs)
        current.wait_stream(self.side)
        for t in (losses, aux):
            if t is not None:
                t.record_stream(current)
        return losses, aux

    def _capture(self, sig, dev) -> _Graph:
        k = self.fuse_steps
        g = _Graph([{key: torch.empty_like(v) for key, v in t.items()}
                    for t in dev], solver.lr_tensor(self.device, (k,)))
        for gen in self.generators:
            g.graph.register_generator_state(gen)
        # backward makes the grads anew in the graph's pool
        self.optimizer.zero_grad(set_to_none=True)
        before = [dict(m.launches) for m in _KERNEL_MODULES]
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        # thread-local capture: the DevicePrefetcher's thread keeps copying
        # the next batches (device allocations, pinned buffers) while this
        # thread captures; under the default global mode its first such
        # call invalidates the capture
        with torch.cuda.graph(g.graph, stream=self.side,
                              capture_error_mode="thread_local"):
            outs = [self.step(g.inputs[j], g.lr[j]) for j in range(k)]
            g.losses = torch.stack([o[0] for o in outs])
            if self.with_aux:
                g.aux = torch.stack([o[1] for o in outs])
        current.wait_stream(self.side)
        g.recorded = {key: n - b[key] for m, b in zip(_KERNEL_MODULES, before)
                      for key, n in m.launches.items()}
        self.captures += 1
        if self.logger is not None:
            shapes = {key: tuple(shape) for key, shape, _ in sig[0]}
            self.logger.info(
                f"Captured a CUDA graph of {k} train steps for batches of "
                f"{shapes} (graph {len(self.graphs) + 1}; kernel launches "
                f"recorded: {g.recorded})")
        return g

    def _replay(self, g: _Graph, dev, lrs):
        with span("fused.slots"):
            for slot, t in zip(g.inputs, dev):
                for key, v in slot.items():
                    v.copy_(t[key])
            g.lr.copy_(self._host_lrs(lrs), non_blocking=True)
        with span("fused.replay"):
            g.graph.replay()
        self.replays += 1
        for key, n in g.recorded.items():
            self.replayed[key] = self.replayed.get(key, 0) + n
        # the next replay overwrites the outputs: the caller keeps copies
        with span("fused.outputs"):
            return g.losses.clone(), (g.aux.clone() if self.with_aux
                                      else None)
