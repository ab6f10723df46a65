"""The port's best-of-rounds loop and watchdog
(``pemp_tpu_torch/utils/benchtime.py``) against the JAX package's
(``pemp_tpu/utils/benchtime.py``), on the cases of
``tests/test_benchtime.py``: the same scripted ``timed_round`` sequences,
under the same monkeypatched clock, give both the same best rate and
the same number of rounds; the watchdog fires on no progress, stays
silent on progress, and 0 disables it. The module imports no torch.
"""

import ast
import itertools
import time
from pathlib import Path

import pytest

from pemp_tpu.utils import benchtime as jax_benchtime
from pemp_tpu_torch.utils import benchtime

SOURCE = Path(benchtime.__file__)


def _both(script, monkeypatch=None, clock=None, *, on, **kw):
    """Run ``script`` (a function of the round index) through each
    module's ``best_of_rounds``, each with a fresh clock at 0 when
    ``clock`` is given: {module: (best, rounds)}."""
    out = {}
    for name, mod, on_key, off_key in (
            ("jax", jax_benchtime, "on_tpu", "off_tpu_budget_s"),
            ("torch", benchtime, "on_card", "off_card_budget_s")):
        if clock is not None:
            clock[0] = 0.0
            monkeypatch.setattr(mod, "time", type(
                "T", (), {"time": lambda: clock[0]}))
        n = itertools.count()

        def timed_round():
            return script(next(n))

        args = {k: v for k, v in kw.items() if k != "off_budget_s"}
        if "off_budget_s" in kw:
            args[off_key] = kw["off_budget_s"]
        best = mod.best_of_rounds(timed_round, **{on_key: on}, **args)
        out[name] = (best, next(n))
    return out


def test_returns_best_rate():
    rates = [(10.0, 0.1), (50.0, 0.1), (30.0, 0.1)]
    got = _both(lambda i: rates[i] if i < 3 else (1.0, 0.1), on=False,
                off_budget_s=60, max_rounds=3)
    assert got["torch"] == got["jax"] == (50.0, 3)


def test_off_card_ignores_slow_launch_extension():
    got = _both(lambda i: (5.0, 99.0), on=False, off_budget_s=0,
                slow_launch_s=0.5, max_rounds=50)
    assert got["torch"] == got["jax"] == (5.0, 1)


def test_all_slow_window_extends_then_hard_stops(monkeypatch):
    clock = [0.0]

    def script(i):
        clock[0] += 10.0
        return 5.0, 99.0

    got = _both(script, monkeypatch, clock, on=True, budget_s=15,
                extend_s=30, slow_launch_s=0.5, max_rounds=1000)
    assert got["torch"] == got["jax"] == (5.0, 5)


def test_one_fast_round_stops_at_budget(monkeypatch):
    clock = [0.0]

    def script(i):
        clock[0] += 10.0
        return (100.0, 0.1) if i == 0 else (5.0, 99.0)

    got = _both(script, monkeypatch, clock, on=True, budget_s=15,
                extend_s=30, slow_launch_s=0.5, max_rounds=1000)
    assert got["torch"] == got["jax"] == (100.0, 2)


def test_arm_watchdog_fires_on_wedge_silent_on_progress(capsys):
    progress, disarm = benchtime.arm_watchdog(
        "t", watchdog_s=0.2, exit_code=None, line='{"value": 0.0}')
    time.sleep(0.8)
    captured = capsys.readouterr()
    assert "WATCHDOG: t" in captured.err
    assert captured.out == '{"value": 0.0}\n'      # the contract line
    disarm()

    progress, disarm = benchtime.arm_watchdog("u", watchdog_s=2.0,
                                              exit_code=None)
    for _ in range(4):
        time.sleep(0.2)
        progress()
    disarm()
    time.sleep(0.3)
    assert capsys.readouterr().err == ""

    progress, disarm = benchtime.arm_watchdog("v", watchdog_s=0,
                                              exit_code=None)
    time.sleep(0.3)
    assert capsys.readouterr().err == ""
    disarm()


@pytest.mark.parametrize("env,want", [(None, 360.0), ("7.5", 7.5)])
def test_budget_from_the_environment(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PEMP_BENCH_BUDGET_S", raising=False)
    else:
        monkeypatch.setenv("PEMP_BENCH_BUDGET_S", env)
    assert benchtime.budget_s(360.0) == want


def test_the_module_imports_no_torch():
    """Armed before ``import torch``: the module imports the standard
    library only."""
    tree = ast.parse(SOURCE.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"os", "sys", "threading", "time"}
