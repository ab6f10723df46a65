"""The cuDNN flag sweep (``pemp_tpu_torch/tools/exp_cudnn_flags.py``),
the counterpart of ``tools/exp_xla_flags.py``, on the CPU: ``--smoke``
runs one arm in a subprocess and gives one row without ``error``; the
arm table sets real backend flags; the summary has the JAX tool's keys
and picks as it does.
"""

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path
from unittest import mock

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parents[1]))

from pemp_tpu_torch.tools import exp_cudnn_flags as flags  # noqa: E402
from tools import exp_xla_flags as jax_flags  # noqa: E402

SUMMARY_KEYS = {"best_arm", "best_bs", "best_eps_s", "vs_base_same_bs"}


def test_smoke_gives_one_row_without_error(monkeypatch):
    # one torch thread in the arm's process (see test_torch_tools_soak)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows, summary = flags.main(["--smoke"])
    (row,) = rows
    assert "error" not in row, row.get("error")
    assert (row["arm"], row["bs"], row["hw"]) == ("base", 2, 33)
    assert row["episodes_per_s"] > 0 and len(row["round_ms"]) >= 2
    # a CPU profile: no device metric, the dilated convs by CPU op time
    assert row["timeline"] == "cpu" and row["device_ms_per_step"] is None
    assert set(row["conv_ms_by_dilation"]) == {"12", "18"}
    assert all(v > 0 for v in row["conv_ms_by_dilation"].values())
    assert row["cudnn_flags"]["cudnn.benchmark"] is False
    assert set(summary) == SUMMARY_KEYS
    assert summary["best_arm"] == "base" and summary["vs_base_same_bs"] == 1


def test_the_arms_set_backend_flags():
    assert list(flags.ARMS) == ["base", "benchmark", "deterministic",
                                "tf32", "benchmark+tf32"]
    before = flags.set_flags({})
    try:
        for arm, want in flags.ARMS.items():
            flags.set_flags(before)
            now = flags.set_flags(want)
            assert {k: now[k] for k in want} == want, arm
            assert set(now) == set(before)
    finally:
        flags.set_flags(before)
    assert flags.set_flags({}) == before
    assert torch.backends.cudnn.benchmark == before["cudnn.benchmark"]


def _rows():
    return [
        {"arm": "base", "bs": 4, "episodes_per_s": 200.0},
        {"arm": "benchmark", "bs": 4, "episodes_per_s": 250.0},
        {"arm": "tf32", "bs": 8, "error": "timeout"},
        {"arm": "benchmark", "bs": 8, "episodes_per_s": 240.0},
    ]


def test_summary_keys_and_pick_equal_the_jax_tool():
    rows = _rows()
    it = iter(rows)
    text = io.StringIO()
    with mock.patch.object(jax_flags, "run_arm",
                           lambda name, fl, bs, budget: dict(next(it))), \
            mock.patch.object(sys, "argv", [
                "exp_xla_flags", "--bs", "4", "8", "--arms", "base",
                "vmem32m"]), redirect_stdout(text):
        jax_flags.main()
    want = json.loads(text.getvalue().splitlines()[-1])
    got = flags.summarize(rows)
    assert set(got) == set(want) == SUMMARY_KEYS
    assert got["best_arm"] == want["best_arm"] == "benchmark"
    assert got["best_bs"] == want["best_bs"] == 4
    assert got["vs_base_same_bs"] == pytest.approx(
        want["vs_base_same_bs"], abs=1e-4)
    assert flags.summarize([rows[2]]) is None


def test_conv_ms_by_dilation_sums_each_dilation():
    rows = [{"dilation": 12, "us": 1500.0}, {"dilation": 18, "us": 250.0},
            {"dilation": 12, "us": 500.0}, {"dilation": None, "us": 9.0},
            {"dilation": 6, "us": 7.0}]
    assert flags.conv_ms_by_dilation(rows) == {"12": 2.0, "18": 0.25}
