"""Without a card the benchmark exits non-zero and prints no result: it
never falls back to the CPU. In a directory that holds only
BENCHMARK.json and the benchmark, the same."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pemp-s1-r50.serve-b1", "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_is_refused(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "the program is missing" in out.stderr


def test_the_seed_may_exceed_32_bits():
    from benchmark import traffic
    assert 0 <= traffic.sub_seed(2 ** 40 + 3, 7) < 2 ** 63
