"""Dataclass configuration tree and the ``<command> with k=v`` CLI.

Counterpart of the part of ``pemp_tpu/config/base.py`` and
``pemp_tpu/config/cli.py`` that the ``test`` command needs: scopes ``g``
(run directories), ``dev`` (device and precision; the JAX package's
``tpu`` scope), ``data``, ``te`` and the per-entry ``net``, plus the
top-level keys; dotted ``a.b=value`` overrides; the ``print_config`` and
``help`` commands. The port records no run directories (the JAX CLI's
``-u``/``-p`` flags are not taken).
"""

from __future__ import annotations

import ast
import copy
import sys
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class GlobalConfig:
    """Scope ``g``: where ``exp_id`` looks for checkpoints."""
    model_dir: str = "model_dir"        # model_dir/<tag>/<exp_id>/<ckpt>


@dataclass
class DeviceConfig:
    """Scope ``dev``: device and compute precision."""
    device: str = "cuda"                # cuda | cpu (cpu only when asked)
    precision: str = "bf16"             # backbone compute dtype: bf16 | f32


@dataclass
class DataConfig:
    """Scope ``data`` (reference data_kits/datasets.py:13-31)."""
    dataset: str = "PASCAL"             # SYNTH (PASCAL, COCO not ported yet)
    height: int = 401
    width: int = 401
    test_bs: int = 1
    test_n: int = 1000                  # episodes per eval round
    test_seed: int = 5678
    one_cls: int = 0                    # restrict sampling to a single class id
    cache: bool = True                  # cache rendered images in host RAM
    num_workers: int = 4                # host render worker threads


@dataclass
class TestConfig:
    """Scope ``te`` (reference core/solver.py:47-50)."""
    epochs: int = 5                     # number of eval rounds (5-round mean)


@dataclass
class Config:
    """Top-level experiment config (reference entry/baseline.py:24-41)."""
    tag: str = "default"
    shot: int = 1
    query: int = 1
    split: int = -1                     # REQUIRED for train/test
    seed: int = 1234                    # weight init seed (no checkpoint)
    ckpt: str = ""                      # .pt state_dict; "" = init from seed
    exp_id: int = -1                    # look for ckpt in model_dir/tag/exp_id

    g: GlobalConfig = field(default_factory=GlobalConfig)
    dev: DeviceConfig = field(default_factory=DeviceConfig)
    data: DataConfig = field(default_factory=DataConfig)
    te: TestConfig = field(default_factory=TestConfig)
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


class Experiment:
    """Named command registry: ``<command> [with a.b=v ...]``."""

    def __init__(self, name: str, config):
        self.name = name
        self.base_config = config
        self.commands: Dict[str, Callable] = {
            "print_config": lambda cfg: print(format_config(cfg))}

    def command(self, fn: Callable) -> Callable:
        self.commands[fn.__name__] = fn
        return fn

    def assemble(self, command: str, overrides: Dict[str, Any]):
        cfg = apply_overrides(copy.deepcopy(self.base_config), overrides)
        if command in ("train", "test") and cfg.split not in (0, 1, 2, 3):
            raise ValueError(
                f"'split' must be specified in [0, 1, 2, 3], got {cfg.split}")
        return cfg

    def run_commandline(self, argv: Optional[List[str]] = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        if not argv or argv[0] in ("help", "-h", "--help"):
            print(f"usage: {self.name} <command> [with k=v ...]")
            print("commands:", ", ".join(sorted(self.commands)))
            return None
        command, rest = argv[0], argv[1:]
        overrides: Dict[str, Any] = {}
        expect_with = True
        for token in rest:
            if token == "with" and expect_with:
                expect_with = False
            elif "=" in token:
                key, _, value = token.partition("=")
                overrides[key] = value
            else:
                raise SystemExit(f"Unrecognized argument: {token}")
        if command not in self.commands:
            raise SystemExit(f"Unknown command '{command}'. "
                             f"Available: {', '.join(sorted(self.commands))}")
        return self.commands[command](self.assemble(command, overrides))
