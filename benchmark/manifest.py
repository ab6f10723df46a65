"""Finding a cell and everything it names, from ``BENCHMARK.json``.

A cell (``workloads``) names a configuration (``configs``: its ``file``)
and a traffic mix (``benchmark/traffic/<traffic>.json``); its metrics are
the entries of ``end_to_end`` and ``per_layer`` whose ``workloads`` list
it (or that have no such list), each read by
``benchmark/metrics/<name>.py`` or, failing that, by the reader of the
name's first dotted part (``mfu.train`` -> ``metrics/mfu.py``). Adding a
cell, a configuration, a mix or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
MANIFEST = ROOT.parent / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int


def load(path: Path = MANIFEST) -> Dict:
    return json.loads(Path(path).read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: Optional[Dict] = None) -> Cell:
    from benchmark import traffic
    m = manifest if manifest is not None else load()
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"[{', '.join(w['name'] for w in m['workloads'])}]")
    w = found[0]
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT.parent / conf["file"]).read_text())
    return Cell(name, config, traffic.load(w["traffic"]),
                [e for e in m["end_to_end"] if _reports(e, name)],
                [e for e in m["per_layer"] if _reports(e, name)],
                int(w["chips"]))


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(ctx)`` function of a metric's reader file."""
    for stem in (metric, metric.split(".")[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{root / 'metrics'}")
