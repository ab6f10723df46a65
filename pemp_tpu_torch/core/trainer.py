"""The training loop, in one process or in each process of a world.

Counterpart of ``Trainer`` in ``pemp_tpu/core/trainer.py:227-583``
(reference core/base_trainer.py:183-308):

- the epoch loop: fresh tasks each epoch, one optimizer step per batch,
  the LR schedule advanced per step (cosine, poly) or per epoch;
- ``ckpt.pt`` every ``tr.ckpt_epoch`` epochs and ``bestckpt.pt`` on the
  best online-eval mIoU; a final ``ckpt.pt`` records the reached epoch;
- ``resume`` restores weights, optimizer state (momentum), the epoch and
  the LR schedule from the run's ``ckpt.pt``;
- ``GracefulStop``: SIGTERM/SIGUSR1 stop the loop at a step boundary
  through a final snapshot of the last completed epoch;
- DropBlock draws from one generator on the device for the trainer's
  whole life, re-seeded ``seed + epoch`` each epoch, so a resumed epoch
  replays its masks (and a captured graph, which keeps its generator,
  draws them too);
- one epoch loop, ``_run_epoch`` (the counterpart of ``_run_epoch_fused``,
  ``pemp_tpu/core/trainer.py:466-550``), in chunks of ``dev.fuse_steps``
  batches; with ``k > 1`` full chunks of k batches go
  through ``train_step_fused`` (``parallel/step.py``'s
  ``FusedTrainStep``: on CUDA one replay of a captured graph, on the CPU
  k eager steps), with the chunk's per-step LRs drawn from the live
  schedule before the launch; the epoch tail (fewer than k batches) runs
  through the serial ``train_step``; a runtime's ``post_chunk(auxes,
  batches)`` is flushed one chunk late, in step order; the stop flag is
  polled at chunk boundaries; it/s counts optimizer steps. The numbers
  are the serial loop's: the same LRs, batches, dropout masks and
  update;
- ``PEMP_PROFILE_DIR``: a ``torch.profiler`` trace (CPU and, on the
  card, CUDA activity) of the second epoch this run trains, written as
  ``epoch<N>_rank<r>.pt.trace.json`` into that directory; nothing when
  the variable is unset.

In a world of several processes (``parallel/mesh.py``) only rank 0
writes checkpoints; ``maybe_resume`` reads on rank 0 and broadcasts the
bytes (a read error on rank 0 raises on every rank); a stop signal is
agreed by a world-OR every ``STOP_SYNC_STEPS`` steps (fused: whenever
the step count crosses a multiple of it) and at each epoch boundary, so
every rank stops at the same step; the logged loss is the global
batch's, the same on every rank.

The online eval is the evaluator's fast step under ``model.eval()`` and
``no_grad``; the model returns to ``model.train()`` after it.
"""

from __future__ import annotations

import io
import itertools
import logging
import os
import signal
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.parallel import mesh
from pemp_tpu_torch.parallel.step import (
    DDP_WARMUP_STEPS, WARMUP_STEPS, FusedTrainStep, broadcast_batch,
    device_batch, take_rows, unpack_batch,
)
from pemp_tpu_torch.utils.timer import Timer

# a world agrees on a stop request every this many steps (a synchronous
# world-OR), and once more at each epoch boundary
STOP_SYNC_STEPS = 50


class GracefulStop:
    """Preemption-safe stop request: ``install()`` hooks SIGTERM and
    SIGUSR1 to set ``requested``, which the loop polls at step
    boundaries; ``restore()`` puts the previous handlers back. Off the
    main thread (where Python forbids handlers) it stays a manual flag."""

    SIGNALS = ("SIGTERM", "SIGUSR1")

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def install(self):
        for name in self.SIGNALS:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:      # not the main thread
                break
        return self

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()


class Trainer:
    """Trains ``model`` (already in train mode, frozen parameters marked)
    with ``optimizer`` over ``params``, the parameters that train, through
    the hooks of ``runtime`` (``core/experiment.py``): ``apply_train``
    gives the logits and auxiliary losses on the device arrays
    ``device_keys``, ``compute_loss`` the loss, ``post_step`` (optional)
    sees each step's logits, ``post_chunk`` (optional) a fused chunk's.
    The checkpoints hold the ``state_dict`` of ``weights`` (default
    ``model``; the stage-2 cascade's is its stage 2). ``fuse_steps > 1``
    trains through ``train_step_fused`` (``parallel/step.py``).

    ``forward(tensors)`` is the train forward (default ``apply_train`` on
    ``model``; in a world, the ``DistributedDataParallel`` module that
    wraps it). ``shard`` names this process's rows of the global batch
    (the dropout masks keep them); with ``split_batch`` every process reads
    the whole batch (a loader not sharded by process), takes rank 0's
    bytes and computes its rows of it."""

    def __init__(self, cfg, run, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 params: List[torch.nn.Parameter], runtime,
                 lr_policy: solver.LRPolicy, device: torch.device,
                 logger: Optional[logging.Logger] = None,
                 weights: Optional[torch.nn.Module] = None,
                 forward: Optional[Callable] = None,
                 shard: Optional[mesh.RowShard] = None,
                 split_batch: bool = False, fuse_steps: int = 1):
        self.cfg = cfg
        self.run = run
        self.model = model
        self.weights = model if weights is None else weights
        self.forward = forward or (
            lambda t: runtime.apply_train(model, t))
        self.shard = shard
        self.rows = (slice(shard.rank, None, shard.world)
                     if split_batch and shard is not None else None)
        self.rank0 = mesh.process_index() == 0
        self.optimizer = optimizer
        self.params = params
        self.runtime = runtime
        self.lr_policy = lr_policy
        self.device = device
        self.logger = logger or logging.getLogger(__name__)
        self.do_ckpt = run._id is not None
        root = Path(cfg.g.model_dir)
        self.model_dir = (root / str(cfg.tag) / str(run._id) if self.do_ckpt
                          else root / "None")
        self.best_iou = -1.0
        self.best_epoch = -1
        self.preempted = False
        self.step_losses: List[float] = []     # every step's loss, in order
        nd = len(str(cfg.tr.total_epochs))
        self.template = (f"Epoch: {{:{nd}d}}/{{:{nd}d}}"
                         " | LR: {:.2e} | Train {:7.5f} | Val {:7.5f}"
                         " | mIoU {:5.2f} | bIoU {:5.2f} | Speed: {:.2f}it/s")
        self.dropout_generator = torch.Generator(device=device)
        self._lr = solver.lr_tensor(device)
        self.fuse_steps = fuse_steps
        self.train_step_fused = None
        if fuse_steps > 1:
            self.train_step_fused = FusedTrainStep(
                self.device_step, fuse_steps, device, optimizer,
                compact_wire=cfg.dev.compact_wire,
                keys=runtime.device_keys,
                with_aux=self.post_chunk is not None,
                generators=[self.dropout_generator],
                warmup_steps=(DDP_WARMUP_STEPS if isinstance(
                    self.forward, torch.nn.parallel.DistributedDataParallel)
                    else WARMUP_STEPS), logger=self.logger)

    @property
    def post_step(self) -> Optional[Callable]:
        return self.runtime.post_step

    @property
    def post_chunk(self) -> Optional[Callable]:
        return getattr(self.runtime, "post_chunk", None)

    # --- one step -------------------------------------------------------
    def train_step(self, batch) -> torch.Tensor:
        """One step at the schedule's LR, then the runtime's ``post_step``
        (if any) with the detached logits and the host batch; returns the
        detached loss of the global batch (still on the device).
        ``batch`` is a host batch or the prefetcher's, whose device
        tensors pass through."""
        t = device_batch(batch, self.device, self.cfg.dev.compact_wire,
                         self.runtime.device_keys)
        solver.set_lr(self.optimizer, self.lr_policy.lr)
        self._lr.fill_(self.lr_policy.lr)
        loss, logits = self.device_step(t, self._lr)
        if self.post_step is not None:
            self.post_step(logits, batch)
        return loss

    def device_step(self, t, lr: torch.Tensor):
        """Forward, loss, backward, clip and the optimizer step at the LR
        tensor ``lr`` on the device batch ``t`` (wire dtypes): (the
        detached loss of the global batch, the logits, detached where
        they are one tensor; RPMMs' are a tuple of three). Nothing in it
        waits for the device, so a CUDA graph captures it whole
        (``FusedTrainStep``)."""
        if self.rows is not None:
            t = take_rows(broadcast_batch(t), self.rows)
        t = unpack_batch(t)
        logits, aux = self.forward(t)
        loss = self.runtime.compute_loss(logits, t, aux)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        solver.clip_gradients(self.params, self.cfg.tr.grad_clip)
        solver.step(self.optimizer, lr)
        if isinstance(logits, torch.Tensor):
            logits = logits.detach()
        return mesh.world_mean(loss.detach()), logits

    # --- snapshots ------------------------------------------------------
    def _resume_extra(self, lr_state=None):
        """What a resume needs besides weights and optimizer: without it
        a resumed run restarts the schedule and lets a worse epoch
        overwrite bestckpt.pt. ``lr_state`` overrides the live schedule
        (a preemption snapshot records the epoch-boundary state)."""
        return {"best_iou": self.best_iou, "best_epoch": self.best_epoch,
                "lr_policy": (self.lr_policy.state_dict()
                              if lr_state is None else lr_state)}

    def try_snapshot(self, epoch=-1, final=False, lr_state=None):
        if not self.rank0:      # rank 0 alone records
            return None
        if final:
            if self.do_ckpt:
                path = self.model_dir / ckpt_lib.CKPT
            else:
                postfix = time.strftime("%y%m%d-%H%M%S")
                path = self.model_dir / f"ckpt-{postfix}.pt"
        elif (self.do_ckpt and self.cfg.tr.ckpt_epoch > 0
              and epoch % self.cfg.tr.ckpt_epoch == 0):
            path = self.model_dir / ckpt_lib.CKPT
        else:
            return None
        ckpt_lib.save(path, self.weights, self.optimizer, epoch,
                      extra=self._resume_extra(lr_state))
        if final:
            self.logger.info(f" \\_/ Save checkpoint to {path}")
        return path

    def maybe_resume(self) -> int:
        """Restore from this run's ``ckpt.pt`` if present; returns the
        epoch it records (0 without a checkpoint). A JAX ``.msgpack``
        (``ckpt``, or the run's only ``ckpt``) raises ``ValueError``.

        In a world, rank 0's run folder decides for every rank: rank 0
        reads the file and broadcasts its bytes, so every rank restores
        the same state and epoch, and a read error or a JAX checkpoint on
        rank 0 raises on every rank (an empty broadcast alone would
        restart the world from scratch)."""
        path = self.model_dir / ckpt_lib.CKPT
        data, failure, err = None, 0, ""    # failure: 1 unreadable, 2 JAX
        if self.rank0:
            jax_ckpt = path.with_suffix(".msgpack")
            if Path(self.cfg.ckpt).suffix == ".msgpack" or (
                    not path.exists() and jax_ckpt.exists()):
                failure = 2
            elif path.exists():
                try:
                    data = path.read_bytes()
                except OSError as e:
                    failure, err = 1, f": {e}"
        failure = mesh.broadcast_scalar_from_rank0(failure)
        if failure == 2:
            raise ValueError(
                "resume needs the port's ckpt.pt: a JAX .msgpack checkpoint "
                "holds optax optimizer state, which the port's optimizer "
                "cannot take; start a new run with ckpt=<file.msgpack> to "
                "load its weights only")
        if failure == 1:
            raise RuntimeError("rank 0 found a resume checkpoint but could "
                               "not read it" + err)
        data = mesh.broadcast_bytes_from_rank0(data)
        if not data:
            return 0
        payload = ckpt_lib.load(io.BytesIO(data))
        self.weights.load_state_dict(payload["model"])
        if payload.get("optimizer"):
            self.optimizer.load_state_dict(payload["optimizer"])
        extra = payload.get("extra", {})
        self.best_iou = float(extra.get("best_iou", self.best_iou))
        self.best_epoch = int(extra.get("best_epoch", self.best_epoch))
        if "lr_policy" in extra:
            self.lr_policy.load_state_dict(extra["lr_policy"])
        epoch = int(payload["epoch"])
        src = path if self.rank0 else "rank 0's broadcast checkpoint"
        self.logger.info(f"Resumed from {src} at epoch {epoch} "
                         f"(lr {self.lr_policy.lr:.2e}, "
                         f"best mIoU {self.best_iou:.4f})")
        return epoch

    # --- loop -----------------------------------------------------------
    def start_training_loop(self, train_ds, train_loader, evaluator,
                            val_ds, val_loader, num_classes,
                            resume: bool = False):
        timer = Timer()
        if self.do_ckpt:
            self.model_dir.mkdir(parents=True, exist_ok=True)
        start_epoch = self.maybe_resume() if resume else 0
        # keep the epoch task stream aligned with the resumed position
        for _ in range(start_epoch):
            train_ds.sample_tasks()

        profile_dir = os.environ.get("PEMP_PROFILE_DIR")
        stop = GracefulStop().install()
        world = mesh.process_count()
        try:
            for epoch in range(start_epoch + 1, self.cfg.tr.total_epochs + 1):
                # the interrupted epoch replays in full on resume, so a
                # preemption snapshot carries the epoch-boundary LR state
                boundary_lr = self.lr_policy.state_dict()
                train_ds.sample_tasks()
                self.dropout_generator.manual_seed(self.cfg.seed + epoch)
                self.model.set_dropout_generator(self.dropout_generator,
                                                 self.shard)
                losses = []
                # the second epoch: the first builds, warms and captures
                prof = (self._start_profile()
                        if profile_dir and epoch == start_epoch + 2 else None)
                try:
                    n_steps = self._run_epoch(train_loader, losses, timer,
                                              stop, world)
                finally:
                    if prof is not None:
                        self._stop_profile(prof, Path(profile_dir), epoch)
                # a signal during the epoch tail must not wait an epoch:
                # every rank takes this world-OR once an epoch
                if not self.preempted:
                    self.preempted = mesh.any_process_flag(stop.requested)
                if self.preempted:
                    self.try_snapshot(epoch - 1, final=True,
                                      lr_state=boundary_lr)
                    self.logger.info(
                        f"Graceful stop inside epoch {epoch} after "
                        f"{n_steps} steps (fuse_steps {self.fuse_steps}) - "
                        f"snapshot records completed epoch {epoch - 1}; "
                        "resume with "
                        "`train with resume=True exp_id=<id>`")
                    return
                # one host fetch of the epoch's losses (a fused chunk's
                # are a [k] vector, a serial step's a scalar)
                host = torch.cat([x.reshape(-1) for x in losses]).double() \
                    .cpu().tolist() if losses else []
                self.step_losses.extend(host)
                train_loss = float(np.mean(host)) if host else 0.0
                speed = n_steps / timer.total if timer.total else 0.0
                self.try_snapshot(epoch)
                mloss, miou, biou, best = self.evaluation(
                    epoch, evaluator, val_ds, val_loader, num_classes)
                self.lr_policy.step_epoch(monitor_value=mloss)
                self.log_result(epoch, train_loss, mloss, miou, biou, best,
                                speed)
                timer = Timer()
        finally:
            stop.restore()
        # record the reached epoch: a later resume with a larger
        # total_epochs continues from here
        self.try_snapshot(self.cfg.tr.total_epochs, final=True)

    def _run_epoch(self, train_loader, losses, timer, stop, world) -> int:
        """One epoch in chunks of ``fuse_steps`` batches (1 without a
        fused step): with a fused step each full chunk is one
        ``train_step_fused`` call at the chunk's LRs, drawn from the live
        schedule before the launch; otherwise, and for the epoch tail
        (fewer than ``fuse_steps`` batches, so one graph is captured a
        batch shape), serial steps. Returns the optimizer steps taken.
        The stop flag is polled at chunk boundaries; a world takes its
        world-OR whenever the step count crosses a multiple of
        ``STOP_SYNC_STEPS`` (every rank counts alike: equal loaders,
        equal ``fuse_steps``).

        ``post_chunk(auxes, batches)`` of chunk i runs after chunk i+1 is
        launched (its host fetch would otherwise wait for launch i before
        the next is queued); the flushes keep step order (a serial tail
        first flushes the pending chunk), and the write-backs reach the
        store before its ``next_epoch()``. A runtime with ``post_step``
        and no ``post_chunk`` cannot run here."""
        fused = self.train_step_fused
        if (fused is not None and self.post_step is not None
                and self.post_chunk is None):
            raise RuntimeError(
                "fused multi-step launches cannot run a per-step host hook "
                "(post_step): provide post_chunk(auxes, batches) for a "
                "chunk-boundary flush")
        k = self.fuse_steps
        n_steps, last_sync, pending = 0, 0, None
        it = iter(train_loader)
        while True:
            chunk = list(itertools.islice(it, k))
            if not chunk:
                break
            with timer.start():
                if fused is not None and len(chunk) == k:
                    lrs = []
                    for _ in chunk:
                        lrs.append(self.lr_policy.lr)
                        self.lr_policy.step_step()
                    solver.set_lr(self.optimizer, lrs[-1])
                    chunk_losses, auxes = fused(chunk, lrs)
                    losses.append(chunk_losses)
                    if self.post_chunk is not None:
                        if pending is not None:
                            self.post_chunk(*pending)
                        pending = (auxes, chunk)
                else:           # serial steps (or the epoch tail)
                    if pending is not None:
                        self.post_chunk(*pending)
                        pending = None
                    for batch in chunk:
                        losses.append(self.train_step(batch))
                        self.lr_policy.step_step()
            n_steps += len(chunk)
            if world == 1:
                self.preempted = stop.requested
            elif n_steps // STOP_SYNC_STEPS > last_sync // STOP_SYNC_STEPS:
                self.preempted = mesh.any_process_flag(stop.requested)
                last_sync = n_steps
            if self.preempted:
                break
        if pending is not None:     # the epoch's end (or a stop)
            self.post_chunk(*pending)
        return n_steps

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir: Path, epoch: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        profile_dir.mkdir(parents=True, exist_ok=True)
        path = profile_dir / (f"epoch{epoch}_rank{mesh.process_index()}"
                              ".pt.trace.json")
        prof.export_chrome_trace(str(path))
        self.logger.info(f"Profile of epoch {epoch} written to {path}")

    def evaluation(self, epoch, evaluator, val_ds, val_loader, num_classes):
        self.model.eval()
        try:
            mloss, miou, biou = evaluator.start_eval_loop(val_ds, val_loader,
                                                          num_classes)
        finally:
            self.model.train()
        miou, biou = float(np.mean(miou)), float(np.mean(biou))
        best = False
        if miou > self.best_iou:
            self.best_iou, self.best_epoch = miou, epoch
            if self.do_ckpt and self.rank0:
                ckpt_lib.save(self.model_dir / ckpt_lib.BEST, self.weights,
                              self.optimizer, epoch)
                best = True
        return float(mloss), miou, biou, best

    def log_result(self, epoch, train_loss, val_loss, val_miou, val_biou,
                   best, speed, **extra):
        """The epoch's line in the log, and its scalars in the run's
        records under the JAX package's names (``train_loss``,
        ``val_loss``, ``val_mIoU``, ``val_bIoU``, then ``extra``)."""
        msg = self.template.format(
            epoch, self.cfg.tr.total_epochs, self.lr_policy.lr, train_loss,
            val_loss, val_miou * 100, val_biou * 100, speed)
        self.logger.info(msg + " (best)" * best)
        for name, value in (("train_loss", train_loss), ("val_loss", val_loss),
                            ("val_mIoU", val_miou), ("val_bIoU", val_biou),
                            *extra.items()):
            self.run.log_scalar(name, float(value), epoch)
