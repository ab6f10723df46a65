"""Entry runtime: wires a model family into the ``train`` and ``test``
commands.

Counterpart of ``pemp_tpu/core/experiment.py``'s ``EntryRuntime``:
datasets, the model (from ``models/registry.py``, initialised from
``seed`` or loaded from a checkpoint), the solver, the trainer and the
evaluator, checkpoint discovery and the train -> test chain. What differs
between families goes through the hooks:

- ``build_model(cfg, device)``: the eval-mode model on the device;
- ``weights(model)``: the module whose ``state_dict`` the checkpoints hold;
- ``apply_train(model, batch)``: the train-mode forward, returning the
  logits and a dict of auxiliary losses;
- ``compute_loss(logits, batch, aux)``: the loss the step minimises;
- ``apply_eval(model, batch)``: the eval forward, returning the logits
  at feature resolution (the eval step resizes them to each query GT's
  size, which may differ from the input's);
- ``device_keys``: the batch arrays the steps move to the device;
- ``wrap_data(ds, loader, train)``: wraps the train, online-eval and test
  data (CaNet's history adapter);
- ``apply_visualize(model, batch)``: the forward with the response map
  (the PEMP entries' ``visualize``, ``core/visualize.py``);
- ``post_step(logits, batch)``: optional, after every train step (CaNet's
  history write-back);
- ``post_chunk(auxes, batches)``: optional, after a fused chunk of
  ``dev.fuse_steps`` steps, with the chunk's logits stacked on a leading
  [k] axis (CaNet's write-back, in step order); a runtime with
  ``post_step`` and no ``post_chunk`` trains serially;
- ``shard_train_loader``: True when each process of a world reads its
  own shard of the train episodes; CaNet sets it False (its history
  store spans the episodes), and then every process reads the whole
  stream, takes rank 0's batch and computes its rows of it.

The entries under ``pemp_tpu_torch/entry/`` subclass it. A model not
loaded from a checkpoint starts from ``seed`` and, when its ImageNet file
is in ``data/``, takes its trunk from it (``utils/pretrained.py``, the
JAX runtime's ``maybe_load_pretrained``).

Data parallel over episodes (``parallel/``): under a launch of several
processes, one a card, ``train`` wraps the model in
``DistributedDataParallel`` after ``freeze()`` and gives it
``GlobalBatchNorm``s; the loss denominators, dropout masks and eval
metrics are the global batch's (``core/losses.py``, ``models/layers.py``,
``core/evaluator.py``); rank 0 reads every snapshot and broadcasts its
bytes (``load_snapshot``); the chained ``test`` runs on every rank, which
learn the run id from rank 0. The train loader and both eval loaders go
through the ``DevicePrefetcher`` (``dev.prefetch``; 0 keeps the serial
path).

``dev.fuse_steps = k > 1`` (the JAX runtime's ``tpu.fuse_steps``,
``pemp_tpu/core/experiment.py:355-390``) trains k steps a launch
(``Trainer._run_epoch_fused``; on CUDA one replay of a captured CUDA
graph): the prefetcher is ``max(dev.prefetch, k)`` batches deep, so that
a chunk never waits on it; Adam is built capturable; a world over gloo
on CUDA raises (a graph cannot hold its collectives), and under
``DistributedDataParallel`` (built on a side stream, as a capture needs)
the first 11 steps warm up eagerly.
"""

from __future__ import annotations

import io
import logging
import random
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core import losses as loss_lib
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.evaluator import (
    ARRAY_KEYS, Evaluator, make_fast_eval_step,
)
from pemp_tpu_torch.core.trainer import Trainer
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.layers import global_batchnorm
from pemp_tpu_torch.ops import kernels
from pemp_tpu_torch.parallel import mesh
from pemp_tpu_torch.parallel.step import DevicePrefetcher
from pemp_tpu_torch.utils import pretrained
from pemp_tpu_torch.utils.convert import state_dict_from_jax


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"pemp_tpu_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_precision(precision: str) -> torch.dtype:
    """Backbone compute dtype for ``dev.precision``. The prototype math
    runs in full float32 either way (TF32 off for matmuls); ``f32`` also
    turns TF32 off for the cuDNN convolutions."""
    if precision not in registry.DTYPES:
        raise ValueError(f"dev.precision={precision!r} (bf16 | f32)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "f32":
        torch.backends.cudnn.allow_tf32 = False
    return registry.DTYPES[precision]


def find_checkpoint(cfg) -> Optional[Path]:
    """The checkpoint ``ckpt`` names, by ``find_snapshot``'s lookup (a
    path, else a file of run ``exp_id`` or, failing that, of the newest
    run of ``tag``); None when ``ckpt`` is empty (init from ``seed``)."""
    if not cfg.ckpt:
        return None
    return ckpt_lib.find_snapshot(cfg.g.model_dir, cfg.tag, cfg.exp_id,
                                  cfg.ckpt)


def load_weights(model, path: Path) -> None:
    """Load a checkpoint into ``model``, every key present: a ``.pt`` (the
    trainer's ``{"model": ...}`` dict or a bare state_dict) or the JAX
    package's ``.msgpack`` (its variables through ``state_dict_from_jax``;
    a weights-only restore)."""
    path = Path(path)
    load_weights_bytes(model, path.suffix, path.read_bytes())


def load_weights_bytes(model, suffix: str, data: bytes) -> None:
    """``load_weights`` of a checkpoint file's bytes, its format by the
    file's ``suffix``."""
    if suffix == ".msgpack":
        tree = ckpt_lib.jax_checkpoint(data)
        sd = state_dict_from_jax(_numpy(tree["params"]),
                                 _numpy(tree["batch_stats"]))
    else:
        sd = ckpt_lib.model_state(ckpt_lib.load(io.BytesIO(data)))
    model.load_state_dict(sd, strict=True)


def load_snapshot(model, find: Callable[[], Path], logger: logging.Logger,
                  what: str = "Model") -> None:
    """Load the checkpoint ``find()`` names into ``model``. In a world
    rank 0 alone owns the run folders (which other hosts may not share):
    it finds and reads the file and broadcasts its bytes, so every rank
    loads the same weights; any failure on rank 0 broadcasts an empty
    payload first, and every rank raises."""
    if mesh.process_count() == 1:
        path = find()
        load_weights(model, path)
        logger.info(f"{what} initialized from {path}")
        return
    data, err = None, ""
    if mesh.process_index() == 0:
        try:
            path = find()
            data = path.suffix.encode() + b"\0" + path.read_bytes()
            logger.info(f"{what} initialized from {path} (broadcast to "
                        "every rank)")
        except (OSError, ValueError) as e:
            err = f": {e}"
    data = mesh.broadcast_bytes_from_rank0(data)
    if not data:
        raise FileNotFoundError(
            f"rank 0 could not load a {what.lower()} snapshot" + err)
    suffix, _, body = data.partition(b"\0")
    load_weights_bytes(model, suffix.decode(), body)


def _numpy(tree):
    """A checkpoint tree with its bfloat16 tensors as float32 numpy
    (exact), which ``state_dict_from_jax`` takes."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy() if torch.is_tensor(tree) else tree


def init_weights(model, cfg, name: str) -> None:
    """``model``'s weights from the checkpoint ``cfg.ckpt`` names or, when
    it names none, drawn from ``cfg.seed``, the trunk of the registry's
    model ``name`` then taken from its ImageNet file when that is on disk
    (``utils/pretrained.py``)."""
    if not cfg.ckpt:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        pretrained.try_load_backbone(name, cfg, model, get_logger(cfg.tag))
    else:
        load_snapshot(model, lambda: find_checkpoint(cfg),
                      get_logger(cfg.tag))


class EntryRuntime:
    """The ``train`` and ``test`` commands of the registry's model
    ``name``. ``build`` replaces ``build_model`` (an entry module passes
    its own, so that it can be swapped)."""

    name: str = "baseline"
    device_keys = ARRAY_KEYS
    post_step: Optional[Callable] = None
    post_chunk: Optional[Callable] = None
    shard_train_loader = True

    def __init__(self, cfg, run=None, build: Optional[Callable] = None):
        self.cfg = cfg
        self.run = run
        self.logger = get_logger(cfg.tag)
        self.loss_fn = loss_lib.get(cfg)
        if build is not None:
            self.build_model = build

    # --- hooks (override per family) -----------------------------------
    @classmethod
    def build_model(cls, cfg, device: torch.device) -> torch.nn.Module:
        """The eval-mode model on ``device`` (channels_last), initialised
        from ``cfg.seed`` or loaded from the checkpoint ``cfg.ckpt`` names
        (the trainer's ``{"model": ...}`` dict or a bare state_dict)."""
        set_precision(cfg.dev.precision)
        model = registry.build(cls.name, cfg)
        init_weights(model, cfg, cls.name)
        return model.to(device, memory_format=torch.channels_last).eval()

    def weights(self, model: torch.nn.Module) -> torch.nn.Module:
        """The module whose ``state_dict`` the checkpoints hold."""
        return model

    def apply_train(self, model, batch) -> tuple:
        """Train-mode forward on device tensors: (logits [B,Q,H,W,2], a dict
        of auxiliary losses)."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"]), {}

    def compute_loss(self, logits, batch, aux: Dict) -> torch.Tensor:
        """The configured loss (``loss``) of the query logits."""
        labels = batch["qry_msk"]
        return self.loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                            labels.reshape(-1, *labels.shape[-2:]))

    def apply_eval(self, model, batch) -> torch.Tensor:
        """Eval forward on device tensors: logits [B,Q,h,w,2] at feature
        resolution."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     out_hw=None)

    def wrap_data(self, ds, loader, train: bool):
        """The (dataset, loader) the runtime reads from ``ds``, ``loader``."""
        return ds, loader

    def apply_visualize(self, model, batch) -> tuple:
        """``visualize``'s forward (the PEMP stages): feature-resolution
        logits [B,Q,h,w,2] and the response map [B,Q,h,w]."""
        return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                     out_hw=None, ret_ind=True)

    # --- commands --------------------------------------------------------
    def test(self) -> Dict[str, float]:
        """The ``test`` command (of run ``exp_id``'s snapshot when it names
        no ``ckpt``): returns loss, mIoU, bIoU (fractions), the episodes/s
        of the eval steps and the device the run used."""
        with self.kernels():
            return self._test()

    def kernels(self):
        """The block in which the commands run: the kernels, or their plain
        versions on the card with ``dev.use_kernels=False``."""
        return kernels.use_kernels(self.cfg.dev.use_kernels)

    def _test(self) -> Dict[str, float]:
        cfg, logger = self.cfg, self.logger
        device = resolve_device(cfg.dev.device)
        mesh.resolve_mesh(cfg.dev.mesh)
        self.resolve_snapshot()
        test_ds, test_loader, num_classes = datasets.load(cfg)
        test_ds, test_loader = self.wrap_data(test_ds, test_loader, False)
        test_loader = self.prefetch(test_loader, device)
        model = self.build_model(cfg, device)
        evaluator = Evaluator(cfg, self.eval_step(model, device),
                              datasets.get_val_labels(cfg, cfg.split), logger)
        logger.info(f"Start testing on {device}.")
        loss, miou, biou = evaluator.start_eval_loop(test_ds, test_loader,
                                                     num_classes)
        result = {"loss": float(loss), "miou": float(np.mean(miou)),
                  "biou": float(np.mean(biou)), "fps": evaluator.fps,
                  "device": str(device)}
        logger.info(f"Loss: {result['loss']:.4f}, mIoU: "
                    f"{result['miou'] * 100:.2f}, bIoU: "
                    f"{result['biou'] * 100:.2f}")
        return result

    def resolve_snapshot(self, required: bool = False) -> None:
        """``ckpt`` becomes the path of the snapshot ``find_snapshot``
        finds: when ``exp_id`` names a run and ``ckpt`` is empty (that
        run's ``bestckpt``, else ``ckpt``, ``.pt`` or the JAX package's
        ``.msgpack``), or always when ``required`` (``visualize``; then
        without either, the newest run's of ``tag``)."""
        cfg = self.cfg
        if required or (not cfg.ckpt and cfg.exp_id >= 0):
            # in a world rank 0 finds it and sends it (``load_snapshot``)
            cfg.ckpt = (str(ckpt_lib.find_snapshot(
                cfg.g.model_dir, cfg.tag, cfg.exp_id, cfg.ckpt))
                if mesh.process_index() == 0 else "<rank 0's snapshot>")

    def train(self) -> Dict:
        """The ``train`` command: ``{"train": <the training summary>}`` plus,
        for a recorded run that was not stopped, ``"test"``: the chained
        ``test`` of ``bestckpt.pt``."""
        with self.kernels():
            return self._train_and_test()

    def _train_and_test(self) -> Dict:
        result = {"train": self._train()}
        # rank 0 alone records, but every rank takes the chained test (its
        # eval gathers are collectives): rank 0 says which run it tests;
        # the stop flag is the same on every rank
        rid = mesh.broadcast_scalar_from_rank0(
            -1 if self.run._id is None else self.run._id)
        if rid >= 0 and not result["train"]["preempted"]:
            self.cfg.exp_id, self.cfg.ckpt = rid, ckpt_lib.BEST
            result["test"] = self.test()
        return result

    def eval_step(self, model, device: torch.device) -> Callable:
        return make_fast_eval_step(model, device, self.apply_eval,
                                   self.device_keys,
                                   compact_wire=self.cfg.dev.compact_wire)

    def prefetch(self, loader, device: torch.device,
                 depth: Optional[int] = None):
        """``loader`` behind the ``DevicePrefetcher`` (``depth`` batches
        deep, default ``dev.prefetch``; ``dev.prefetch=0`` keeps the serial
        loader)."""
        if self.cfg.dev.prefetch <= 0:
            return loader
        return DevicePrefetcher(loader, device, depth or self.cfg.dev.prefetch,
                                self.cfg.dev.compact_wire, self.device_keys)

    def fuse_steps(self, device: torch.device) -> int:
        """The effective ``dev.fuse_steps``: 1 (with a log line) for a
        runtime whose per-step host hook has no chunk flush; on CUDA a
        world whose collectives a graph cannot hold raises."""
        fuse = int(self.cfg.dev.fuse_steps)
        if fuse > 1 and self.post_step is not None and self.post_chunk is None:
            self.logger.info("dev.fuse_steps ignored: this runtime runs a "
                             "per-step host hook (post_step) without a "
                             "chunk-boundary flush (post_chunk)")
            return 1
        if fuse > 1 and device.type == "cuda":
            mesh.require_graph_collectives(fuse)
        return max(fuse, 1)

    def _train(self) -> Dict:
        """Train on the device, with checkpoints of ``weights(model)``;
        returns the run id, every step's loss, the best online-eval mIoU
        and its epoch, and whether a signal stopped it."""
        cfg, run, logger = self.cfg, self.run, self.logger
        device = resolve_device(cfg.dev.device)
        world = mesh.resolve_mesh(cfg.dev.mesh)
        fuse = self.fuse_steps(device)
        graphs = fuse > 1 and device.type == "cuda"
        random.seed(cfg.seed)
        np.random.seed(cfg.seed)
        train_ds, train_loader, _ = datasets.load(cfg, "train")
        val_ds, val_loader, num_classes = datasets.load(cfg, "eval_online")
        train_ds, train_loader = self.wrap_data(train_ds, train_loader, True)
        val_ds, val_loader = self.wrap_data(val_ds, val_loader, False)
        split_batch = world > 1 and not self.shard_train_loader
        train_loader.shard_by_process = self.shard_train_loader
        if split_batch and cfg.data.bs % world:
            raise ValueError(
                f"data.bs={cfg.data.bs}: {self.name} reads every batch on "
                f"every process and splits it, so the {world} processes "
                "must divide it")
        shard = (mesh.RowShard(mesh.process_index(), world,
                               cfg.data.bs // world if split_batch
                               else cfg.data.bs) if world > 1 else None)
        model = self.build_model(cfg, device).train()
        params = model.freeze()
        forward = None
        if mesh.dist.is_initialized():
            forward = self.distributed(model, device, side_stream=graphs)
        optimizer = solver.make_optimizer(cfg.tr, params, capturable=graphs)
        # optimizer steps per process: the train loader is sharded
        lr_policy = solver.LRPolicy(cfg.tr, cfg.tr.total_epochs
                                    * len(train_loader))
        trainer = Trainer(cfg, run, model, optimizer, params, self,
                          lr_policy, device, logger,
                          weights=self.weights(model), forward=forward,
                          shard=shard, split_batch=split_batch,
                          fuse_steps=fuse)
        evaluator = Evaluator(cfg, self.eval_step(model, device),
                              datasets.get_val_labels(cfg, cfg.split), logger,
                              mode="EVAL_ONLINE")
        # a split batch is rank 0's, broadcast on the main thread in loop
        # order: no collective may run on the prefetcher's thread
        if not split_batch:
            # a fused chunk takes k batches at once
            train_loader = self.prefetch(train_loader, device,
                                         max(cfg.dev.prefetch, fuse))
        val_loader = self.prefetch(val_loader, device)
        logger.info(f"Start training on {device} (rank "
                    f"{mesh.process_index()} of {world}).")
        trainer.start_training_loop(train_ds, train_loader, evaluator, val_ds,
                                    val_loader, num_classes,
                                    resume=cfg.resume)
        what = "Training preempted" if trainer.preempted else "Ending training"
        logger.info(f"========== {what} with id {run._id} ==========")
        return {"run_id": run._id, "losses": trainer.step_losses,
                "best_iou": trainer.best_iou, "best_epoch": trainer.best_epoch,
                "preempted": trainer.preempted, "device": str(device)}

    def distributed(self, model: torch.nn.Module, device: torch.device,
                    side_stream: bool = False):
        """The train forward of a world: ``model``'s batch norms made
        global when several processes share the batch, and
        ``apply_train`` behind ``DistributedDataParallel`` (the gradient
        mean). Parameters that do not train (``freeze()``, PFENet's trunk,
        stage 2's stage 1) are not DDP's: it registers only those with
        ``requires_grad``. ``side_stream``: built on a side stream, as
        PyTorch's recipe asks of a DDP whose backward a graph captures."""
        if mesh.process_count() > 1:
            global_batchnorm(model)
        ids = None if device.type == "cpu" else [torch.cuda.current_device()]

        def wrap():
            return torch.nn.parallel.DistributedDataParallel(
                _TrainForward(model, self.apply_train), device_ids=ids)
        if not side_stream:
            return wrap()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            ddp = wrap()
        torch.cuda.current_stream(device).wait_stream(side)
        return ddp


class _TrainForward(torch.nn.Module):
    """``apply(model, tensors)`` as a module, for
    ``DistributedDataParallel`` to wrap: some families' train forward is
    not ``model.__call__`` alone."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, batch):
        return self.fn(self.model, batch)
