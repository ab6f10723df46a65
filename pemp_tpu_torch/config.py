"""Dataclass configuration tree and the ``<command> with k=v`` CLI.

Counterpart of the part of ``pemp_tpu/config/base.py`` and
``pemp_tpu/config/cli.py`` that the ``train`` and ``test`` commands need:
scopes ``g`` (run directories), ``dev`` (device and precision; the JAX
package's ``tpu`` scope), ``data``, ``tr``, ``te``, ``s1`` (stage 2's
frozen stage 1) and the per-entry ``net``, plus the top-level keys;
dotted ``a.b=value`` overrides; the ``print_config`` and ``help``
commands.

``train`` and ``test`` record their run into ``<g.model_dir>/<tag>/<id>/``
(an auto-incremented integer id; ``resume=True exp_id=<id>`` reuses the
directory) unless ``-u`` / ``--unobserved`` or ``g.fileStorage=False``, as
the JAX CLI does (``pemp_tpu/config/cli.py:118-231``): ``config.json``
(the flattened config, ``repr`` values; ``config.resume.json`` on
resume), ``sources/<entry>.py`` and ``REVISION`` (best effort),
``metrics.json`` (``Run.log_scalar``: ``{name: [[step, value], ...]}``,
preloaded on resume), and with ``g.mongodb`` the Mongo documents of
``utils/observers.py``; the run ends ``COMPLETED``, ``FAILED`` or
``INTERRUPTED`` (ctrl-C, or a training run stopped by a signal).
``-p`` / ``--print-config`` prints the config, then runs the command.

Under a launch of several processes (``torchrun``, or the JAX package's
``COORDINATOR_ADDRESS`` triple; ``parallel/mesh.py``) the command first
joins the world, before any run folder is made; only rank 0 records,
and the other ranks get a run with ``_id`` None.
"""

from __future__ import annotations

import ast
import copy
import inspect
import json
import shutil
import subprocess
import sys
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from pemp_tpu_torch.parallel import mesh
from pemp_tpu_torch.utils.observers import maybe_attach


@dataclass
class GlobalConfig:
    """Scope ``g``: run directories (reference config.py:14-19)."""
    model_dir: str = "model_dir"        # model_dir/<tag>/<exp_id>/<ckpt>
    fileStorage: bool = True            # record runs into model_dir
    mongodb: bool = False               # Omniboard/Mongo documents (files)
    mongo_port: int = 7000              # reference config.py:19


@dataclass
class DeviceConfig:
    """Scope ``dev``: device, compute precision, the world and the input
    path (the JAX package's ``tpu`` scope: ``mesh``, ``prefetch``,
    ``compact_wire`` and ``fuse_steps`` keep its defaults and meanings;
    ``use_kernels`` is its ``use_pallas``)."""
    device: str = "cuda"                # cuda | cpu (cpu only when asked)
    precision: str = "bf16"             # backbone compute dtype: bf16 | f32
    mesh: int = 0                       # processes sharing a batch: 0 or
    #                                     -1 = the whole launched world
    #                                     (one process per card, torchrun)
    prefetch: int = 2                   # batches copied ahead on a side
    #                                     stream; 0 keeps the serial path
    compact_wire: bool = True           # f16/uint8 host->device wire format
    fuse_steps: int = 1                 # train steps per launch: >1 runs
    #                                     k steps as one replayed CUDA graph
    #                                     over prefetched batches (on the
    #                                     CPU, k eager steps), amortizing
    #                                     per-step dispatch (ignored by a
    #                                     runtime with a per-step host hook
    #                                     and no chunk flush)
    use_kernels: bool = True            # the hand-written CUDA kernels
    #                                     (K1-K5) for tensors on the card;
    #                                     False runs their plain PyTorch
    #                                     versions there (the JAX package's
    #                                     tpu.use_pallas)


@dataclass
class DataConfig:
    """Scope ``data`` (reference data_kits/datasets.py:13-31)."""
    dataset: str = "PASCAL"             # PASCAL | COCO | SYNTH
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    height: int = 401
    width: int = 401
    bs: int = 4                         # training episodes per step
    test_bs: int = 1
    train_n: int = 5000                 # episodes per training epoch
    test_n: int = 1000                  # episodes per eval round
    seed: int = 1234                    # training episode stream
    test_seed: int = 5678
    one_cls: int = 0                    # restrict sampling to a single class id
    cache: bool = True                  # cache decoded images in host RAM
    num_workers: int = 4                # host decode worker threads
    base_dir: str = ""                  # dataset root ("" = DEFAULT_ROOTS)
    var_gt: bool = False                # SYNTH only: emulate PASCAL's
                                        # variable-size test-time query GT


@dataclass
class TrainConfig:
    """Scope ``tr`` (reference core/solver.py:11-44)."""
    epochs: int = 0
    total_epochs: int = 3
    lr: float = 1e-3
    lrp: str = "period_step"            # custom_step|period_step|plateau|cosine|poly
    lr_boundaries: List[int] = field(default_factory=list)   # [custom_step]
    lr_step: int = 999999999            # [period_step]
    lr_rate: float = 0.1                # decay rate
    lr_end: float = 0.0                 # [plateau, cosine, poly]
    lr_patience: int = 30               # [plateau]
    lr_min_delta: float = 1e-4          # [plateau]
    cool_down: int = 0                  # [plateau]
    monitor: str = "val_loss"           # [plateau]
    power: float = 0.9                  # [poly]
    opt: str = "sgd"                    # sgd | adam
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    sgd_momentum: float = 0.9
    sgd_nesterov: bool = False
    weight_decay: float = 0.0005
    ckpt_epoch: int = 1                 # checkpoint interval (0 disables)
    grad_clip: float = 0.0              # global-norm clip (0 disables)


@dataclass
class TestConfig:
    """Scope ``te`` (reference core/solver.py:47-50)."""
    epochs: int = 5                     # number of eval rounds (5-round mean)


@dataclass
class VizConfig:
    """Scope ``p``: the single episode ``visualize`` draws when ``cls`` >
    0 (reference entry/pemp_stage1.py:35-39): support names ``sup``
    (comma-separated) and query name ``qry``."""
    cls: int = 0
    sup: str = ""
    qry: str = ""


@dataclass
class Stage1RefConfig:
    """Scope ``s1``: the frozen stage-1 checkpoint of the stage-2 cascade
    (reference entry/pemp_stage2.py:39-42): ``ckpt`` as a path, else
    ``g.model_dir/<tag or pemp_stage1>/<id>/<ckpt or bestckpt.pt,
    ckpt.pt>``."""
    id: int = -1
    ckpt: str = ""
    tag: str = ""


@dataclass
class Config:
    """Top-level experiment config (reference entry/baseline.py:24-41)."""
    tag: str = "default"
    shot: int = 1
    query: int = 1
    split: int = -1                     # REQUIRED for train/test
    seed: int = 1234                    # weight init and dropout seed
    ckpt: str = ""                      # .pt or .msgpack; "" = init from seed
    exp_id: int = -1                    # look for ckpt in model_dir/tag/exp_id
    loss: str = "ce"                    # ce | cedt
    sigma: float = 5.0                  # cedt EDT bandwidth
    loss_coef: float = 1.0              # aux weight: panet, rpmms, pfenet
    resume: bool = False                # resume run exp_id's ckpt.pt

    g: GlobalConfig = field(default_factory=GlobalConfig)
    dev: DeviceConfig = field(default_factory=DeviceConfig)
    data: DataConfig = field(default_factory=DataConfig)
    tr: TrainConfig = field(default_factory=TrainConfig)
    te: TestConfig = field(default_factory=TestConfig)
    p: VizConfig = field(default_factory=VizConfig)
    s1: Stage1RefConfig = field(default_factory=Stage1RefConfig)
    # ``net`` is installed per entry with the model's own dataclass.
    net: Any = None


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        low = text.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        return text


_BOOLS = {"true": True, "1": True, "yes": True, "on": True,
          "false": False, "0": False, "no": False, "off": False}


def apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Apply ``{"a.b": value}`` assignments onto a (nested) dataclass."""
    for key, value in overrides.items():
        parts = key.split(".")
        obj = cfg
        for part in parts[:-1]:
            if not hasattr(obj, part):
                raise KeyError(f"Unknown config scope '{part}' in '{key}'")
            obj = getattr(obj, part)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"Unknown config key '{key}'")
        current = getattr(obj, leaf)
        if isinstance(value, str):
            value = _parse_value(value)
        if current is not None and value is not None:
            if isinstance(current, bool):
                if isinstance(value, str):
                    if value.strip().lower() not in _BOOLS:
                        raise ValueError(
                            f"Cannot parse boolean for '{key}': {value!r}")
                    value = _BOOLS[value.strip().lower()]
                else:
                    value = bool(value)
            elif isinstance(current, int) and not isinstance(value, bool) \
                    and isinstance(value, (int, float)):
                value = int(value)
            elif isinstance(current, float) and isinstance(value, (int, float)):
                value = float(value)
            elif isinstance(current, str) and not isinstance(value, str):
                value = str(value)
            elif isinstance(current, list) and isinstance(value, tuple):
                value = list(value)
            elif isinstance(current, tuple) and isinstance(value, list):
                value = tuple(value)
        setattr(obj, leaf, value)
    return cfg


def flatten_config(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in fields(cfg):
        value = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if is_dataclass(value) and not isinstance(value, type):
            out.update(flatten_config(value, prefix=f"{key}."))
        else:
            out[key] = value
    return out


def format_config(cfg: Any) -> str:
    """Human-readable config dump (the ``print_config`` command)."""
    lines = ["Configuration:"]
    lines.extend(f"  {k} = {v!r}" for k, v in sorted(flatten_config(cfg).items()))
    return "\n".join(lines)


class Run:
    """One experiment run: its id, directory (None when not recorded) and
    scalar log, and the observers that see it (``utils/observers.py``)."""

    def __init__(self, run_id: Optional[int], run_dir: Optional[Path]):
        self._id = run_id
        self.run_dir = run_dir
        self._scalars: Dict[str, List] = {}
        self.observers: List = []
        metrics = None if run_dir is None else run_dir / "metrics.json"
        if metrics is not None and metrics.exists():
            # a resumed run reuses its directory: keep the history, or the
            # first log_scalar after the resume would drop it
            self._scalars = json.loads(metrics.read_text())

    def log_scalar(self, name: str, value: float, step: int) -> None:
        self._scalars.setdefault(name, []).append([step, float(value)])
        if self.run_dir is not None:
            (self.run_dir / "metrics.json").write_text(
                json.dumps(self._scalars))
        for obs in self.observers:
            obs.log_scalar(name, value, step)

    def finish(self, status: str = "COMPLETED", result=None) -> None:
        for obs in self.observers:
            obs.finish(status, result)


def _next_run_id(tag_dir: Path) -> int:
    existing = [int(p.name) for p in tag_dir.glob("*") if p.name.isdigit()]
    return max(existing, default=0) + 1


def config_record(cfg) -> Dict[str, str]:
    """The flattened config with ``repr`` values (``config.json``)."""
    return {k: repr(v) for k, v in flatten_config(cfg).items()}


def snapshot_sources(run_dir: Path, entry_file: Optional[str]) -> None:
    """Best effort: the entry's source under ``sources/`` and the git
    revision of the checkout it lies in as ``REVISION``."""
    if entry_file is None:
        return
    entry = Path(entry_file)
    try:
        (run_dir / "sources").mkdir(exist_ok=True)
        shutil.copy2(entry, run_dir / "sources" / entry.name)
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=entry.parent,
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return
    if rev.returncode == 0:
        (run_dir / "REVISION").write_text(rev.stdout)


def result_record(result):
    """A command's result as the JAX CLI records it: a test's
    ``"Loss: ..., mIoU: ..., bIoU: ..."`` line (a train run's, of its
    chained test), ``"PREEMPTED"`` for a training run stopped by a
    signal, anything else as it is."""
    if isinstance(result, dict) and result.get("train", {}).get("preempted"):
        return "PREEMPTED"
    if isinstance(result, dict):
        result = result.get("test", result)
    if isinstance(result, dict) and "miou" in result:
        return (f"Loss: {result['loss']:.4f}, mIoU: {result['miou'] * 100:.2f}"
                f", bIoU: {result['biou'] * 100:.2f}")
    return result


class Experiment:
    """Named command registry: ``<command> [with a.b=v ...] [-u] [-p]``. A
    command is called with (cfg, run)."""

    RECORDED = ("train", "test")

    def __init__(self, name: str, config):
        self.name = name
        self.base_config = config
        self.commands: Dict[str, Callable] = {
            "print_config": lambda cfg, run: print(format_config(cfg))}

    def command(self, fn: Callable) -> Callable:
        self.commands[fn.__name__] = fn
        return fn

    def assemble(self, command: str, overrides: Dict[str, Any]):
        cfg = apply_overrides(copy.deepcopy(self.base_config), overrides)
        if command in ("train", "test") and cfg.split not in (0, 1, 2, 3):
            raise ValueError(
                f"'split' must be specified in [0, 1, 2, 3], got {cfg.split}")
        if command == "train" and cfg.resume and cfg.exp_id < 0:
            # a fresh run dir would hold no checkpoint, and training would
            # restart from scratch despite the explicit resume
            raise ValueError("resume=True requires exp_id=<run id of the "
                             f"run to resume> (got exp_id={cfg.exp_id})")
        return cfg

    def open_run(self, cfg, command: str, observed: bool = True) -> Run:
        """The run of ``command``: ``train`` and ``test`` (observed,
        ``g.fileStorage``) get ``<g.model_dir>/<tag>/<id>/`` with their
        records, a new id or, on resume, the ``exp_id`` it continues, and
        the Mongo observer when ``g.mongodb``; anything else records
        nothing, and neither does any rank of a world but rank 0."""
        if not (observed and command in self.RECORDED and cfg.g.fileStorage
                and mesh.process_index() == 0):
            return Run(None, None)
        tag_dir = Path(cfg.g.model_dir) / str(cfg.tag)
        tag_dir.mkdir(parents=True, exist_ok=True)
        if command == "train" and cfg.resume:
            # the original config.json, sources and REVISION record what
            # produced the earlier epochs; the resume's config goes beside
            run_id, run_dir = cfg.exp_id, tag_dir / str(cfg.exp_id)
            run_dir.mkdir(parents=True, exist_ok=True)
            (run_dir / "config.resume.json").write_text(
                json.dumps(config_record(cfg), indent=2))
        else:
            while True:     # atomic id allocation against concurrent runs
                run_id = _next_run_id(tag_dir)
                run_dir = tag_dir / str(run_id)
                try:
                    run_dir.mkdir(parents=True, exist_ok=False)
                    break
                except FileExistsError:
                    continue
            (run_dir / "config.json").write_text(
                json.dumps(config_record(cfg), indent=2))
            snapshot_sources(run_dir, inspect.getsourcefile(
                self.commands[command]))
        run = Run(run_id, run_dir)
        maybe_attach(run, cfg, self.name, command)
        return run

    def run_commandline(self, argv: Optional[List[str]] = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        if not argv or argv[0] in ("help", "-h", "--help"):
            print(f"usage: {self.name} <command> [with k=v ...] [-u] [-p]")
            print("commands:", ", ".join(sorted(self.commands)))
            return None
        command, rest = argv[0], argv[1:]
        overrides: Dict[str, Any] = {}
        observed, print_cfg, expect_with = True, False, True
        for token in rest:
            if token in ("-u", "--unobserved"):
                observed = False
            elif token in ("-p", "--print-config"):
                print_cfg = True
            elif token == "with" and expect_with:
                expect_with = False
            elif "=" in token:
                key, _, value = token.partition("=")
                overrides[key] = value
            else:
                raise SystemExit(f"Unrecognized argument: {token}")
        if command not in self.commands:
            raise SystemExit(f"Unknown command '{command}'. "
                             f"Available: {', '.join(sorted(self.commands))}")
        cfg = self.assemble(command, overrides)
        joined = not mesh.dist.is_initialized() \
            and mesh.initialize_distributed(cfg.dev.device)
        try:
            run = self.open_run(cfg, command, observed)
            if print_cfg and command != "print_config":
                print(format_config(cfg))
            try:
                result = self.commands[command](cfg, run)
            except KeyboardInterrupt:
                run.finish("INTERRUPTED")
                raise
            except Exception:
                run.finish("FAILED")
                raise
        finally:
            if joined:
                mesh.dist.destroy_process_group()
        record = result_record(result)
        # a training run stopped by a signal is resumable, not COMPLETED
        run.finish("INTERRUPTED" if record == "PREEMPTED" else "COMPLETED",
                   record)
        return result
