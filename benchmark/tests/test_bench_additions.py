"""A configuration of a new family, its reference, a traffic mix of a
new mode, a cell and a per-layer metric are added by adding files
(``benchmark/tests/added/``) and BENCHMARK.json entries: a copy of the
folder with them finds them, builds the cell and runs it, and no file
that was there changed."""

from __future__ import annotations

import importlib
import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
ADDED = Path(__file__).resolve().parent / "added"
CELL = "baseline-r50.eval-b2"


def _files(folder: Path):
    return {p.relative_to(folder): p.read_bytes() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the checkout's benchmark with the added files and
    entries, imported in place of this checkout's."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(bench)
    for src in ADDED.rglob("*"):
        if src.is_file() and src.suffix != ".txt":
            dst = bench / src.relative_to(ADDED)
            assert not dst.exists(), f"{dst} is there already"
            shutil.copy(src, dst)
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "baseline-r50",
                         "source": "https://github.com/Jarvis73/PEMP",
                         "file": "benchmark/configs/baseline-r50.json",
                         "reduced": ["height", "width"], "why": "baseline"})
    m["workloads"].append({"name": CELL, "config": "baseline-r50",
                           "traffic": "eval-b2", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "calls_per_s.baseline", "unit": "calls/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "evaluator",
                           "moves": "eval_episodes_per_s",
                           "workloads": [CELL]})
    e2e = next(e for e in m["end_to_end"]
               if e["name"] == "eval_episodes_per_s")
    e2e["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    for name in [k for k in sys.modules if k.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield bench
    after = _files(bench)
    assert all(after[k] == v for k, v in before.items())    # none edited
    for name in [k for k in sys.modules if k.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)


def test_added_files_are_found(added):
    manifest = importlib.import_module("benchmark.manifest")
    check = importlib.import_module("benchmark.check")
    assert Path(manifest.__file__).parent == added
    cell = manifest.cell(CELL)
    assert cell.config["reference"] == "baseline"
    assert cell.mix["mode"] == "eval_counted" and cell.mix["batch"] == 2
    assert [e["name"] for e in cell.end_to_end] == ["eval_episodes_per_s",
                                                    "setup_s"]
    assert [e["name"] for e in cell.per_layer] == ["calls_per_s.baseline"]
    from benchmark.drivers import Window
    ctx = SimpleNamespace(window=Window(calls=5, seconds=2.0))
    assert manifest.reader("calls_per_s.baseline")(ctx) == 2.5
    assert check.limits(CELL)["loss_gap"] == 1e-4


def test_a_new_family_runs_from_added_files(added):
    """The added cell builds the program's Baseline from the registry
    entry its configuration names, drives it by the added mode, and holds
    it against the added reference: correct, on the CPU in float32."""
    manifest = importlib.import_module("benchmark.manifest")
    run = importlib.import_module("benchmark.run")
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = run.run_cell(manifest.cell(CELL), 7, 0.3, False,
                           torch.device("cpu"), time.perf_counter())
    finally:
        torch.set_num_threads(n)
    mode = sys.modules["benchmark.drivers.eval_counted"]
    ref = sys.modules["benchmark.reference.baseline"]
    assert Path(mode.__file__).parent == added / "drivers"
    assert Path(ref.__file__).parent == added / "reference"
    assert mode.Driver.calls_made > 1
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"eval_episodes_per_s", "setup_s"}
    assert out["attempted"] == 2 * (mode.Driver.calls_made - 1)
