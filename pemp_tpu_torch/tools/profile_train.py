"""Profile the train step and report its device time, op by op.

Counterpart of ``tools/profile_train.py``: the stage-1 train step at
``--bs 4 --hw 401 --loss cedt`` (ResNet-50, 1-shot, bf16 on the card
and f32 on the CPU, as the JAX tool), on one SYNTH batch already on the
device (``np.random.RandomState(0)``, the JAX tool's batch), through the
port's ``Trainer`` and ``Stage1Runtime`` (forward, loss, backward, clip
1.1, SGD), weights from seed 0. ``--family <row>`` profiles a family's
train step at its script preset instead (the JAX tool's ``--family``
rows, its first SYNTH train batch); ``--fuse k`` profiles replays of a
``dev.fuse_steps=k`` chunk (a CUDA graph of k steps; on the CPU k eager
steps). Three warm-up steps (chunks) run first; then ``--steps`` steps
run under ``torch.profiler`` (CPU and CUDA activity), and
``utils/profiling.py`` reads the trace.

It prints the top kernels on stderr and one JSON line: the JAX tool's
keys (``device_ms_per_step`` is the card's busy time a step,
``dispatch_gap_ms_per_step`` the host's share of the wall time), with
``kernels`` in place of ``pallas`` (the port's CUDA kernels K1-K5 run on
the card, their plain versions on the CPU), ``launches`` (K1-K5 as their
wrappers counted them, replayed launches included), ``s2b_calls`` (the
models' space-to-batch convolutions by dilation, ``ops/s2b.py``, as the
Python called them in the window: 2 a step eager, none in a replay) and
``profiled_launches`` (as the profiler counted their kernels), the device
idle share, where the device waited (``idle_ms_per_step_by_span``: its
idle ms a step inside each of the port's spans, ``fused.slots``,
``model.backbone``, ...; on the card, else null) and the convolutions by
input shape. ``PEMP_PROFILE_DIR``
(``core/trainer.py``) profiles an entry's run instead.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.profile_train --bs 4 --steps 6 \\
      [--hw 401] [--loss cedt] [--fuse 4] [--outdir DIR]
  python -m pemp_tpu_torch.tools.profile_train --family rpmms
  python -m pemp_tpu_torch.tools.profile_train --device cpu --hw 33 \\
      --bs 2 --steps 2
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pemp_tpu_torch.config import Run
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.trainer import Trainer
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device, tool_precision
from pemp_tpu_torch.ops import s2b
from pemp_tpu_torch.ops.kernels import minplus, mpm
from pemp_tpu_torch.parallel.step import device_batch
from pemp_tpu_torch.utils import profiling

WARMUP = 3
SEED = 0            # weights and dropout (the JAX tool's PRNGKey(0))

RUNTIMES = {
    "baseline": "BaselineRuntime",
    "pemp_stage1": "Stage1Runtime",
    "pemp_stage2": "Stage2Runtime",
    "panet": "PANetRuntime",
    "canet": "CaNetRuntime",
    "rpmms": "RPMMsRuntime",
    "pfenet": "PFENetRuntime",
}

# row -> (entry family, hw, bs, extra overrides): the JAX tool's rows
# (``tools/bench_train_zoo.py``), the scripts' presets and three larger
# batches
FAMILY_ROWS = {
    "baseline": ("baseline", 401, 4, {}),
    "pemp_stage1": ("pemp_stage1", 401, 4,
                    {"loss": "cedt", "net.backbone": "resnet50"}),
    "pemp_stage2": ("pemp_stage2", 401, 4,
                    {"loss": "cedt", "net.backbone": "resnet50",
                     "net.backbone2": "resnet50", "net.cm": "True",
                     "s1.id": "1"}),
    "s1_5shot": ("pemp_stage1", 401, 4,
                 {"loss": "cedt", "net.backbone": "resnet50", "shot": "5"}),
    "s2_5shot": ("pemp_stage2", 401, 4,
                 {"loss": "cedt", "net.backbone": "resnet50",
                  "net.backbone2": "resnet50", "net.cm": "True",
                  "s1.id": "1", "shot": "5"}),
    "panet": ("panet", 401, 1, {}),
    "panet8": ("panet", 401, 8, {}),
    "canet": ("canet", 321, 4, {}),
    "canet8": ("canet", 321, 8, {}),
    "rpmms": ("rpmms", 481, 4, {}),
    "rpmms8": ("rpmms", 481, 8, {}),
    "pfenet": ("pfenet", 473, 4, {}),
}


def synthetic_batch(bs: int, hw: int) -> Dict[str, np.ndarray]:
    """The JAX tool's train batch (``bench_train.py:110-118``): one query,
    one support, ``np.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    fg = (rng.rand(bs, 1, hw, hw, 1) > 0.5).astype(np.float32)
    return {
        "sup_rgb": rng.randn(bs, 1, hw, hw, 3).astype(np.float32),
        "sup_mask": np.concatenate([fg, 1 - fg], -1),
        "qry_rgb": rng.randn(bs, 1, hw, hw, 3).astype(np.float32),
        "qry_msk": rng.randint(0, 2, (bs, 1, hw, hw)).astype(np.int32),
    }


@dataclass
class Setup:
    """A trainer over a model in train mode and its batch (array keys on
    the device, the host batch's other keys beside them)."""
    trainer: Trainer
    model: torch.nn.Module
    batch: Dict
    bs: int
    hw: int
    fuse: int

    def step(self) -> Callable[[], torch.Tensor]:
        """One call: a train step, or with ``fuse > 1`` a chunk of
        ``fuse`` steps on the same batch (and its ``post_chunk``)."""
        tr = self.trainer
        if self.fuse <= 1:
            return lambda: tr.train_step(self.batch)
        batches = [self.batch] * self.fuse
        lrs = [tr.lr_policy.lr] * self.fuse

        def chunk():
            losses, auxes = tr.train_step_fused(batches, lrs)
            if tr.post_chunk is not None:
                tr.post_chunk(auxes, batches)
            return losses
        return chunk


def build_setup(entry_name: str, overrides: Dict[str, str],
                device: torch.device, host_batch: Optional[Dict] = None,
                transform: Optional[Callable] = None) -> Setup:
    """The train step of ``entry_name``'s runtime as ``overrides``
    configure it (``dev.fuse_steps`` included), weights from ``SEED``,
    dropout from a generator seeded ``SEED``. ``host_batch`` defaults to
    the first train batch of the configured data. ``transform(model)``
    (the levers' module swaps) runs on the built model before the
    optimizer sees its parameters."""
    mod = importlib.import_module(f"pemp_tpu_torch.entry.{entry_name}")
    cfg = mod.ex.assemble("train", {**overrides, "seed": str(SEED)})
    runtime = getattr(mod, RUNTIMES[entry_name])(cfg, Run(None, None))
    fuse = runtime.fuse_steps(device)
    if host_batch is None:
        ds, loader, _ = datasets.load(cfg, "train")
        ds, loader = runtime.wrap_data(ds, loader, True)
        ds.sample_tasks()
        host_batch = next(iter(loader))
    model = runtime.build_model(cfg, device)
    if transform is not None:
        transform(model)
    model.train()
    params = model.freeze()
    trainer = Trainer(
        cfg, Run(None, None), model,
        solver.make_optimizer(cfg.tr, params, capturable=fuse > 1), params,
        runtime, solver.LRPolicy(cfg.tr, 1000), device,
        weights=runtime.weights(model), fuse_steps=fuse)
    trainer.dropout_generator.manual_seed(SEED)
    model.set_dropout_generator(trainer.dropout_generator)
    batch = {**host_batch, **device_batch(host_batch, device,
                                          cfg.dev.compact_wire,
                                          runtime.device_keys)}
    return Setup(trainer, model, batch, cfg.data.bs, cfg.data.height, fuse)


def stage1_overrides(hw: int, bs: int, loss: str, device: torch.device,
                     precision: str, fuse: int,
                     use_kernels: bool = True) -> Dict[str, str]:
    return {"split": "0", "data.dataset": "SYNTH", "data.height": str(hw),
            "data.width": str(hw), "data.bs": str(bs), "loss": loss,
            "dev.device": device.type, "dev.precision": precision,
            "dev.fuse_steps": str(fuse), "dev.use_kernels": str(use_kernels)}


def flagship_setup(hw: int, bs: int, loss: str, device: torch.device,
                   precision: str = "bf16", fuse: int = 1,
                   transform: Optional[Callable] = None,
                   use_kernels: bool = True) -> Setup:
    """The stage-1 train step on ``synthetic_batch`` (the JAX tool's
    ``make_bench_setup``); ``use_kernels=False`` sets
    ``dev.use_kernels=False`` (the JAX tools' jnp arm), which the caller
    applies with ``ops.kernels.use_kernels``."""
    return build_setup("pemp_stage1", stage1_overrides(
        hw, bs, loss, device, precision, fuse, use_kernels), device,
        synthetic_batch(bs, hw), transform)


def seed_stage1_snapshot(model_dir: Path, overrides: Dict[str, str]
                         ) -> None:
    """A stage-1 snapshot from ``SEED`` at ``<model_dir>/pemp_stage1/1/``,
    which the stage-2 rows load (``s1.id=1``), as the JAX tool seeds
    one."""
    from pemp_tpu_torch.entry import pemp_stage1 as s1
    cfg = s1.ex.assemble("train", {k: v for k, v in overrides.items()
                                   if not k.startswith("s1.")})
    cfg.seed = SEED
    model = s1.build_model(cfg, torch.device("cpu"))
    path = model_dir / "pemp_stage1" / "1"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model.state_dict()}, path / "bestckpt.pt")


def family_setup(row: str, device: torch.device, precision: str,
                 fuse: int, model_dir: Path) -> Setup:
    """A ``FAMILY_ROWS`` row's train step; on the CPU at the JAX tool's
    off-chip sizes (33x33, PFENet 41x41; batch 2, or 1 where the preset
    is 1)."""
    family, hw, bs, extra = FAMILY_ROWS[row]
    if device.type == "cpu":
        hw, bs = (41 if family == "pfenet" else 33), (1 if bs == 1 else 2)
    overrides = {"split": "0", "data.dataset": "SYNTH",
                 "data.height": str(hw), "data.width": str(hw),
                 "data.bs": str(bs), "data.train_n": str(2 * bs),
                 "data.test_n": str(bs), "g.model_dir": str(model_dir),
                 "dev.device": device.type, "dev.precision": precision,
                 "dev.fuse_steps": str(fuse), **extra}
    if family == "pemp_stage2":
        seed_stage1_snapshot(model_dir, overrides)
    return build_setup(family, overrides, device)


def counts() -> Dict[str, int]:
    """K1-K5's wrapper counts so far (the tools read differences and
    never reset them)."""
    return {**mpm.launches, **minplus.launches}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_calls(fn: Callable, calls: int, device: torch.device,
                  warmup: int = WARMUP):
    """``warmup`` calls of ``fn``, then ``calls`` calls under the profiler
    (CPU and, on the card, CUDA activity, input shapes recorded), the
    window closed by a synchronize: (profile, wall seconds, the K1-K5
    launches the wrappers counted in the window, and under
    ``s2b_calls`` the space-to-batch route's calls in it by dilation,
    ``ops/s2b.py``: none in a graph's replay)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before, routed = counts(), dict(s2b.s2b_calls)
    with profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync(device)
        wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in counts().items()}
    launched["s2b_calls"] = s2b.s2b_calls_since(routed)
    return prof, wall, launched


def profile_setup(setup: Setup, steps: int, device: torch.device):
    """``steps`` steps of ``setup`` profiled after ``WARMUP`` calls (with
    ``fuse > 1``, whole chunks: at least one): (summary, steps traced,
    K1-K5's launches in the window, the wrappers' and the fused step's
    replays', the profile)."""
    calls = max(1, steps // setup.fuse) if setup.fuse > 1 else steps
    fused = setup.trainer.train_step_fused
    fn = setup.step()
    for _ in range(WARMUP):
        fn()
    before = dict(fused.replayed) if fused is not None else {}
    prof, wall, launched = profile_calls(fn, calls, device, warmup=0)
    if fused is not None:
        for k, n in fused.replayed.items():
            launched[k] = launched.get(k, 0) + n - before.get(k, 0)
    traced = calls * max(setup.fuse, 1)
    return profiling.summarize(prof, traced, wall), traced, launched, prof


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=401)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--loss", default="cedt")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--fuse", type=int, default=1,
                    help="profile replays of a dev.fuse_steps=k chunk")
    ap.add_argument("--family", default="",
                    help=f"a family's train step at its preset: "
                         f"{', '.join(FAMILY_ROWS)}")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    ap.add_argument("--outdir", default="",
                    help="write the chrome trace there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    precision = tool_precision(device)
    if args.family and args.family not in FAMILY_ROWS:
        ap.error(f"unknown family row {args.family!r}")

    with tempfile.TemporaryDirectory() as model_dir:
        if args.family:
            setup = family_setup(args.family, device, precision,
                                 args.fuse, Path(model_dir))
            loss = "preset"
        else:
            setup = flagship_setup(args.hw, args.bs, args.loss, device,
                                   precision, args.fuse)
            loss = args.loss
        summary, traced, launched, prof = profile_setup(setup, args.steps,
                                                        device)
    trace_dir = None
    if args.outdir:
        Path(args.outdir).mkdir(parents=True, exist_ok=True)
        trace_dir = args.outdir
        prof.export_chrome_trace(str(Path(args.outdir)
                                     / "profile_train.pt.trace.json"))
    profiling.print_top(summary, "step", sys.stderr)
    dev_ms = summary["device_ms_per_step"]
    out = {
        "family": args.family or "pemp_stage1(flagship)",
        "bs": setup.bs, "hw": setup.hw, "loss": loss,
        "precision": precision, "fuse_steps": setup.fuse,
        "kernels": device.type == "cuda",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "steps_traced": traced,
        "device_eps": setup.bs / (dev_ms / 1e3) if dev_ms else None,
        **summary,
        "launches": {k: launched[k] for k in profiling.KERNEL_SYMBOLS},
        "s2b_calls": launched["s2b_calls"],
        "trace_dir": trace_dir,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
