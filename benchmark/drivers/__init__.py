"""The system under test: the port's trainer and evaluator, driven by a
traffic mix.

A mix's ``mode`` names the driver: ``benchmark/drivers/<mode>.py``,
whose class ``Driver`` sets the cell up, runs its window and its traced
sub-window, and computes what ``correct`` is decided on
(``Driver.check``); its function ``control`` gives the readings that the
limits are set from (``control.py``). A new mode is a new file.

Everything here reaches the program through its own runtime
(``pemp_tpu_torch.entry.<entry>.<Runtime>``), its trainer and its
evaluator. The program's model is the one the configuration names
(``port.model``: registry entries, and the class that composes them),
loaded with the benchmark's seeded weights instead of a snapshot;
nothing is written to disk. The program's settings come from the
configuration's own fields (``port.from_config``: program key ->
the field's dotted path) and from the switches that have no counterpart
there (``port.set``); the mix sets the batch and the fused steps. Each
driver records what the check needs (``evidence``) and the host times
of its window; ``bench.*`` spans mark its calls in a trace.
"""

from __future__ import annotations

import functools
import importlib
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from benchmark import reference as references
from benchmark import traffic


@dataclass
class Window:
    """What a measured window did: ``calls`` host calls (train: launches
    of ``fuse_steps`` steps), ``episodes`` served or trained, ``seconds``
    from its first call to its closing fetch, each call's host seconds,
    the non-finite losses among its answers, and the episodes they
    stand for (``failed``)."""
    calls: int = 0
    episodes: int = 0
    seconds: float = 0.0
    call_s: List[float] = field(default_factory=list)
    nonfinite: int = 0
    failed: int = 0


def config_value(cfg: Dict, path: str):
    """The configuration's field at a dotted path (``train.lr``)."""
    return functools.reduce(lambda d, k: d[k], path.split("."), cfg)


def port_overrides(cfg: Dict, mix: Dict) -> Dict:
    """The program's settings of the cell."""
    port = cfg["port"]
    return {**port["set"],
            **{key: config_value(cfg, path)
               for key, path in port["from_config"].items()},
            "data.bs": mix["batch"], "data.test_bs": mix["batch"],
            "dev.fuse_steps": mix.get("fuse_steps", 1)}


def port_config(cfg: Dict, mix: Dict, command: str):
    """The program's configuration of the cell: its ``Config`` and its
    runtime."""
    port = cfg["port"]
    entry = importlib.import_module(f"pemp_tpu_torch.entry.{port['entry']}")
    pcfg = entry.ex.assemble(command, port_overrides(cfg, mix))
    from pemp_tpu_torch.config import Run
    runtime = getattr(entry, port["runtime"])(pcfg, Run(None, None))
    return pcfg, runtime


def _attr(spec: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module(module), name)


def port_model(cfg: Dict, pcfg, state: Dict[str, torch.Tensor], device):
    """The program's model that ``port.model`` names (``registry``: the
    entries built from ``pcfg``; ``compose``, where there are several: the
    class taking them in that order), with ``state`` loaded, on
    ``device`` in channels_last, in eval mode."""
    from pemp_tpu_torch.core.experiment import set_precision
    from pemp_tpu_torch.models import registry
    set_precision(pcfg.dev.precision)
    spec = cfg["port"]["model"]
    parts = [registry.build(name, pcfg) for name in spec["registry"]]
    if "compose" in spec:
        model = _attr(spec["compose"])(*parts)
    elif len(parts) == 1:
        model = parts[0]
    else:
        raise ValueError(f"port.model builds {len(parts)} models and "
                         f"names no class to compose them")
    model = model.to(device, memory_format=torch.channels_last)
    model.load_state_dict(state, strict=True)
    return model.eval()


CALIBRATION = {"pool_batches": 1, "batch": 8, "gt": "input"}


def seeded_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's weights from ``seed``, as its reference draws and
    calibrates them, on calibration episodes of their own."""
    eps = traffic.episodes(cfg, CALIBRATION, seed, device, stream=6)
    return references.of(cfg).seeded_state(cfg, seed, eps, device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    return torch.profiler.record_function(name)


class Driver:
    """Set-up, window and profiled sub-window of one cell. A mode's
    subclass adds ``setup``, ``call``, ``window``, ``check`` and
    ``flops_per_call``."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.reference = references.of(cfg)
        self.device = torch.device(device)
        self.pool = traffic.episodes(cfg, mix, seed, self.device)
        state = seeded_state(cfg, seed, self.device)
        # the reference takes the same weights after the window
        self.state = {k: v.cpu() for k, v in state.items()}
        del state
        if self.device.type == "cuda":     # the calibration's is not the
            torch.cuda.empty_cache()       # program's peak
            torch.cuda.reset_peak_memory_stats(self.device)
        self.evidence: Dict = {}
        self.stack = ExitStack()

    def close(self) -> None:
        """Frees the program's state (the pool stays for the check)."""
        self.stack.close()
        for attr in ("model", "trainer", "step_fn", "optimizer", "params"):
            if hasattr(self, attr):
                delattr(self, attr)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def profile(self) -> Dict:
        """``profile_calls`` calls under the profiler, inside the span
        ``bench.window`` closed by a synchronize: the profile and how
        many calls, steps and episodes it holds."""
        from torch.profiler import ProfilerActivity, profile
        calls = int(self.mix["profile_calls"])
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        with profile(activities=acts) as prof:
            with span("bench.window"):
                for _ in range(calls):
                    self.call()
                sync(self.device)
        steps = calls * self.mix.get("fuse_steps", 1)
        return {"prof": prof, "calls": calls, "steps": steps,
                "episodes": steps * self.mix["batch"]}


def mode(mix: Dict):
    """The module of the mix's mode (``benchmark/drivers/<mode>.py``)."""
    return importlib.import_module(f"benchmark.drivers.{mix['mode']}")


def make(cfg: Dict, mix: Dict, seed: int, device) -> Driver:
    return mode(mix).Driver(cfg, mix, seed, device)


def meta_episodes(cfg: Dict, mix: Dict) -> Dict[str, torch.Tensor]:
    """A batch of the mix's shapes on the meta device (to count FLOPs)."""
    d = cfg["data"]
    b, s, q, h, w = (mix["batch"], d["shot"], d["query"], d["height"],
                     d["width"])
    with torch.device("meta"):
        return {"sup_rgb": torch.rand(b, s, h, w, 3),
                "sup_mask": torch.rand(b, s, h, w, 2),
                "qry_rgb": torch.rand(b, q, h, w, 3),
                "qry_msk": torch.zeros(b, q, h, w, dtype=torch.int64)}
