"""One process of a ``torch.distributed`` world of the port, for
``tests/test_torch_parallel_*.py`` (gloo on the CPU).

    python tests/torch_parallel_worker.py <mode> <out file> [args ...]

The world comes from the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``PEMP_DIST_TIMEOUT_S``), as under
``torchrun``. Modes:

- ``collectives``: the global batch norm (forward, backward, running
  statistics), the global loss denominators, ``gather_rows`` and the
  host broadcasts of ``parallel/mesh.py``, each against one process's
  result on the whole (seeded) batch, computed here too; writes the
  largest errors as JSON;
- ``train64 <bs> [steps] [fuse]``: ``train64`` below in the world,
  written with ``torch.save``;
- ``entry <module> <argv ...>``: ``pemp_tpu_torch.entry.<module>.main``;
  writes the result and the world as JSON, with the train steps this
  rank ran (``PEMP_TEST_SIGTERM=1``: rank 1 signals itself after its
  first train step, which is inside a chunk under ``dev.fuse_steps``,
  with a stop agreed at every step or chunk boundary);
- ``families <stage-1 snapshot> <model dir>``: ``train`` (chained into
  ``test``) of each entry of ``FAMILIES`` in one world at float64 with
  one-block stages, two steps of ``data.bs=2`` a process; writes each
  one's result as JSON;
- ``fail``: rank 1 raises once the world is up; rank 0 waits in a
  collective, which must raise too.

The functions also run in a single process (the tests' references);
``run_world`` starts a world of them, each process with a timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pemp_tpu_torch.parallel import mesh  # noqa: E402

WORKER = Path(__file__).resolve()
PROC_TIMEOUT_S = 240    # each process of a test world
DIST_TIMEOUT_S = 60     # each collective (PEMP_DIST_TIMEOUT_S)

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.test_bs=2", "data.test_n=4", "te.epochs=1",
         "data.num_workers=1", "dev.device=cpu", "dev.precision=f32"]


def _rel(a, b):
    """Largest |a - b| over the largest |b|."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(mode: str, outs, args=(), env=None, cwd=None):
    """Start ``len(outs)`` processes of this script in ``mode`` as one gloo
    world (rank r writes ``outs[r]``); wait for each at most
    ``PROC_TIMEOUT_S`` and kill what is left. Returns (exit codes, logs)."""
    port = free_port()
    procs = []
    for rank in range(len(outs)):
        penv = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(len(outs)),
                    LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                    MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                    PEMP_DIST_TIMEOUT_S=str(DIST_TIMEOUT_S), **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(outs[rank]), *args],
            env=penv, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n[killed: timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def collectives():
    from pemp_tpu_torch.core import losses
    from pemp_tpu_torch.models.layers import BatchNorm, global_batchnorm

    world, rank = mesh.process_count(), mesh.process_index()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 5, 5) * 2.0 + 0.5)
    g = torch.from_numpy(rng.randn(4, 3, 5, 5))
    rows = slice(rank, None, world)
    out = {"world": world, "rank": rank}

    # batch norm: the world's module on its rows against one module on
    # the whole batch
    def bn_module():
        m = BatchNorm(3).double()
        with torch.no_grad():
            m.weight.copy_(torch.tensor([0.5, 1.5, 2.0]))
            m.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
        return m
    ref, ours = bn_module(), global_batchnorm(bn_module())
    xr = x.clone().requires_grad_(True)
    y_ref = ref(xr)
    (y_ref * g).sum().backward()
    xl = x[rows].clone().requires_grad_(True)
    y = ours(xl)
    (y * g[rows]).sum().backward()
    out["bn_y"] = _rel(y.detach(), y_ref.detach()[rows])
    out["bn_dx"] = _rel(xl.grad, xr.grad[rows])
    out["bn_dw"] = _rel(mesh.all_reduce_sum(ours.weight.grad),
                        ref.weight.grad)
    out["bn_db"] = _rel(mesh.all_reduce_sum(ours.bias.grad), ref.bias.grad)
    out["bn_mean"] = _rel(ours.running_mean, ref.running_mean)
    out["bn_var"] = _rel(ours.running_var, ref.running_var)
    out["bn_tracked"] = int(ours.num_batches_tracked)

    # loss denominators: each rank's share; their mean is the global loss
    # and the mean of their gradients the global gradient
    logits = torch.from_numpy(rng.randn(4, 9, 9, 2))
    labels = torch.from_numpy(rng.randint(0, 2, (4, 9, 9)))
    labels[0, :4] = 255                 # ignored pixels, in rank 0's rows
    for name, fn in (("ce", losses.cross_entropy), ("cedt", losses.cedt)):
        lr = logits.clone().requires_grad_(True)
        want = _one_process(fn, lr, labels)
        want.backward()
        ll = logits[rows].clone().requires_grad_(True)
        share = fn(ll, labels[rows])
        share.backward()
        out[f"{name}_loss"] = _rel(mesh.world_mean(share.detach()),
                                   want.detach())
        out[f"{name}_grad"] = _rel(ll.grad / world, lr.grad[rows])

    # gathers in global order
    t = torch.arange(8.0).reshape(4, 2)
    per = 4 // world
    out["gather_block"] = bool(torch.equal(
        mesh.gather_rows(t[rank * per:(rank + 1) * per]), t))
    out["gather_strided"] = bool(torch.equal(
        mesh.gather_rows(t[rows], strided=True), t))

    # host values: chunks, the empty payload, the scalar, the world-OR
    mesh.CHUNK = 5
    payload = bytes(range(23))
    out["bytes"] = mesh.broadcast_bytes_from_rank0(
        payload if rank == 0 else b"other") == payload
    out["bytes_empty"] = mesh.broadcast_bytes_from_rank0(
        None if rank == 0 else b"x") == b""
    out["scalar"] = mesh.broadcast_scalar_from_rank0(7 if rank == 0 else 3)
    out["flag_any"] = mesh.any_process_flag(rank == world - 1)
    out["flag_none"] = mesh.any_process_flag(False)
    return out


def _one_process(fn, logits, labels):
    """``fn`` as one process computes it, whatever the world."""
    count = mesh.process_count
    mesh.process_count = lambda: 1
    try:
        return fn(logits, labels)
    finally:
        mesh.process_count = count


def train64(bs: int, model_dir, steps: int = 2, fuse: int = 1):
    """PEMP stage 1 on a small ResNet (one block a stage), float64, 33x33,
    cedt, DropBlock on, through the entry runtime: ``steps`` train steps of
    ``bs`` episodes a process (``dev.fuse_steps=fuse``), then the online
    eval; the unrecorded run's final snapshot goes under ``model_dir``.
    Returns the global losses and the final ``state_dict``."""
    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1

    world = mesh.process_count()
    args = dict(a.split("=", 1) for a in SMALL)
    args.update({"data.bs": str(bs), "data.train_n": str(steps * bs * world),
                 "tr.total_epochs": "1", "loss": "cedt", "tr.lr": "0.01",
                 "g.model_dir": str(model_dir), "dev.fuse_steps": str(fuse)})
    cfg = entry.ex.assemble("train", args)
    kept = {}

    def build(cfg, device):
        model = PEMPStage1(layers=(1, 1, 1), drop_rate=cfg.net.drop_rate,
                           block_size=cfg.net.block_size)
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        kept["model"] = model.double().to(
            memory_format=torch.channels_last).eval()
        return kept["model"]

    class Runtime64(entry.Stage1Runtime):
        def apply_train(self, model, b):
            return model(b["sup_rgb"].double(), b["sup_mask"].double(),
                         b["qry_rgb"].double()), {}

        def apply_eval(self, model, b):
            return model(b["sup_rgb"].double(), b["sup_mask"].double(),
                         b["qry_rgb"].double(), out_hw=None)

    torch.set_num_threads(1)
    result = Runtime64(cfg, Run(None, None), build)._train()
    return {"losses": result["losses"], "world": world,
            "rank": mesh.process_index(),
            "state": {k: v.detach().clone()
                      for k, v in kept["model"].state_dict().items()}}


def entry(module: str, argv):
    """``pemp_tpu_torch.entry.<module>.main(argv)``; with
    ``PEMP_TEST_SIGTERM=1`` rank 1 sends itself SIGTERM after its first
    train step, and a stop is agreed after every step."""
    import importlib

    from pemp_tpu_torch.core import trainer as trainer_mod
    torch.set_num_threads(1)
    mod = importlib.import_module(f"pemp_tpu_torch.entry.{module}")
    out = {"steps_run": 0}
    signal_once = os.environ.get("PEMP_TEST_SIGTERM") == "1"
    if signal_once:
        trainer_mod.STOP_SYNC_STEPS = 1
    step = trainer_mod.Trainer.device_step

    def counted_step(self, t, lr):
        result = step(self, t, lr)
        out["steps_run"] += 1
        if signal_once and mesh.process_index() == 1 \
                and "signalled" not in out:
            out["signalled"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        return result
    trainer_mod.Trainer.device_step = counted_step
    out.update(_entry_main(mod, argv))
    return out


def _entry_main(mod, argv):
    """Run a command of an entry under its own world; the result with the
    world it ran in."""
    seen = {}
    init = mesh.initialize_distributed

    def spy(device="cuda"):
        joined = init(device)
        seen["world"] = mesh.process_count()
        seen["rank"] = mesh.process_index()
        return joined
    mesh.initialize_distributed = spy
    try:
        result = mod.main(argv)
    finally:
        mesh.initialize_distributed = init
    train = result.get("train", {})
    return {"world": seen.get("world", 1), "rank": seen.get("rank", 0),
            "run_id": train.get("run_id"), "losses": train.get("losses"),
            "preempted": train.get("preempted"),
            "test": result.get("test")}


# the families that no other world test trains, and their extra arguments
# (``{s1}``: a stage-1 snapshot)
FAMILIES = {"pemp_stage2": ["s1.ckpt={s1}"], "panet": [], "rpmms": [],
            "pfenet": []}


def family_args(name: str, s1, bs: int, model_dir) -> list:
    """``train`` of family ``name``: two steps of ``bs`` episodes a process
    in the live world, records under ``model_dir``, the plain wire."""
    world = mesh.process_count()
    return ["train", "with", *SMALL, "tr.total_epochs=1", f"data.bs={bs}",
            f"data.train_n={2 * bs * world}", f"g.model_dir={model_dir}",
            "dev.compact_wire=False",
            *(a.format(s1=s1) for a in FAMILIES[name])]


@contextmanager
def shallow():
    """The ResNet-50 trunks of every family with one block a stage, and
    PFENet's pyramid of two bins (8, 4) instead of four (60, 30, 15, 8)."""
    from pemp_tpu_torch.models import common, registry
    from pemp_tpu_torch.models.pfenet import PFENet

    def pfenet(cfg):
        return PFENet(shot=cfg.shot, compute_dtype=registry._dtype(cfg),
                      layers=(1, 1, 1, 1), ppm_scales=(8, 4))
    with mock.patch.dict(common.RESNET_LAYERS, {"resnet50": (1, 1, 1)}), \
            mock.patch.dict(registry.REGISTRY, {"pfenet": (
                registry.REGISTRY["pfenet"][0], pfenet)}):
        yield


@contextmanager
def float64(mod):
    """The entry ``mod``'s models (``shallow``) and device batches in
    float64. At float32 the gradients of a ResNet-50 trunk from a random
    start depend on the order of their sums, which a world changes: stage
    2's trunk gradients in a world of two differ from one process's by
    1-1.5% at float32 and by under 1e-6 at float64 (full depth, 33x33),
    but for the communication modules' biases, whose gradient is 0 in
    exact arithmetic."""
    from pemp_tpu_torch.core import evaluator, trainer

    build, unpack = mod.build_model, trainer.unpack_batch

    def unpack64(batch):
        return {k: v.double() if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v
                for k, v in unpack(batch).items()}
    def build64(cfg, device):
        return build(cfg, device).double()
    with shallow(), mock.patch.object(mod, "build_model", build64), \
            mock.patch.object(trainer, "unpack_batch", unpack64), \
            mock.patch.object(evaluator, "unpack_batch", unpack64):
        yield


def families(s1, model_dir):
    """Each family of ``FAMILIES`` trained in the live world at float64,
    one after another: {name: the result with the world it ran in}. Once
    a family's run has ended (its chained test read rank 0's snapshot and
    broadcast it), rank 0 removes the run's checkpoints, which nothing
    reads again; its run folder and records stay."""
    import importlib

    torch.set_num_threads(1)
    out = {}
    for name in FAMILIES:
        mod = importlib.import_module(f"pemp_tpu_torch.entry.{name}")
        with float64(mod):
            out[name] = _entry_main(mod, family_args(
                name, s1, 2, Path(model_dir) / name))
        out[name].update(world=mesh.process_count(),
                         rank=mesh.process_index())
        if mesh.process_index() == 0:
            for ckpt in (Path(model_dir) / name).rglob("*.pt"):
                ckpt.unlink()
    return out


def main():
    mode, out = sys.argv[1], Path(sys.argv[2])
    if mode == "entry":
        result = entry(sys.argv[3], sys.argv[4:])
        out.write_text(json.dumps(result))
        return
    assert mesh.initialize_distributed("cpu"), "no world in the environment"
    try:
        if mode == "collectives":
            out.write_text(json.dumps(collectives()))
        elif mode == "families":
            out.write_text(json.dumps(families(sys.argv[3], sys.argv[4])))
        elif mode == "train64":
            torch.save(train64(int(sys.argv[3]), out.parent / "md",
                               *map(int, sys.argv[4:])), out)
        elif mode == "fail":
            if mesh.process_index() == 1:
                raise RuntimeError("rank 1 fails on purpose")
            mesh.any_process_flag(False)        # waits for rank 1
            out.write_text("rank 0 passed a collective without rank 1")
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        mesh.dist.destroy_process_group()


if __name__ == "__main__":
    main()
