"""A/B sweep of the cuDNN backend flags on the production train step.

Counterpart of ``tools/exp_xla_flags.py``, which sweeps XLA:TPU compiler
flags; the port has no compiler flags, and what decides how cuDNN runs
the train step's convolutions are PyTorch's backend flags:

- ``base``: the port's defaults (``core/experiment.py::set_precision``:
  ``cudnn.benchmark`` and ``cudnn.deterministic`` off, matmul TF32 off,
  cuDNN TF32 as PyTorch leaves it at bf16);
- ``benchmark``: ``cudnn.benchmark=True``, cuDNN times its algorithms
  for each new shape and keeps the fastest (the dilated ASPPV2 d=12/18
  convolutions fall back to slow engines under the heuristics, PERF.md);
- ``deterministic``: ``cudnn.deterministic=True``;
- ``tf32``: ``cudnn.allow_tf32=True`` and matmul TF32 on (the float32
  convolutions and matmuls of the step on the tensor cores);
- ``benchmark+tf32``.

Each arm runs in a subprocess, as in the JAX tool, because cuDNN's
algorithm cache lives as long as the process. The runner times the
stage-1 train step of ``profile_train.flagship_setup`` (401^2, batch
``--bs``, cedt, bf16 on the card, the batch on the device), the flags
set after the setup (the runtime's own ``set_precision`` would
overwrite them): three warm-up steps (the first ones autotune under
``benchmark``), then rounds of ``ROUND_STEPS`` steps, each ending in a
synchronize, until ``--budget`` seconds pass (at least two rounds);
``episodes_per_s`` is the best round's, as ``bench_train.py`` reports
it. One profiled step gives the device ms a step, the device idle share
and the device ms of the dilation-12 and -18 convolutions (the ASPPV2
branches, forward and backward, ``utils/profiling.py::conv_by_shape``).

Prints one JSON row per arm and batch (an arm that fails is an
``error`` row, not fatal) and the JAX tool's summary: ``best_arm``,
``best_bs``, ``best_eps_s`` and ``vs_base_same_bs``.

Usage (the card; ``--smoke`` one tiny CPU arm, a harness check)::

  python -m pemp_tpu_torch.tools.exp_cudnn_flags [--bs 4 8] [--budget 90]
      [--arms base benchmark ...]
  python -m pemp_tpu_torch.tools.exp_cudnn_flags --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]

# arm -> the flags it sets: "cudnn.<name>" or "matmul.allow_tf32"
ARMS: Dict[str, Dict[str, bool]] = {
    "base": {},
    "benchmark": {"cudnn.benchmark": True},
    "deterministic": {"cudnn.deterministic": True},
    "tf32": {"cudnn.allow_tf32": True, "matmul.allow_tf32": True},
    "benchmark+tf32": {"cudnn.benchmark": True, "cudnn.allow_tf32": True,
                       "matmul.allow_tf32": True},
}
ASPP_DILATIONS = (12, 18)
ROUND_STEPS = 10
SMOKE = {"hw": 33, "bs": 2, "budget": 0.0, "device": "cpu",
         "round_steps": 1}


def set_flags(flags: Dict[str, bool]) -> Dict[str, bool]:
    """Set ``flags``; returns every flag of the sweep as it now stands."""
    import torch
    for name, value in flags.items():
        scope, attr = name.split(".")
        setattr(torch.backends.cudnn if scope == "cudnn"
                else torch.backends.cuda.matmul, attr, value)
    cudnn = torch.backends.cudnn
    return {"cudnn.benchmark": cudnn.benchmark,
            "cudnn.deterministic": cudnn.deterministic,
            "cudnn.allow_tf32": cudnn.allow_tf32,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def conv_ms_by_dilation(rows: List[Dict], dilations=ASPP_DILATIONS
                        ) -> Dict[str, float]:
    """The summed ms of ``conv_by_shape`` rows at each dilation."""
    return {str(d): sum(r["us"] for r in rows if r["dilation"] == d) / 1e3
            for d in dilations}


def measure(arm: str, bs: int, budget: float, hw: int = 401,
            device=None, round_steps: int = ROUND_STEPS) -> Dict:
    """The runner: one arm's train step (in the process that calls it)."""
    import torch

    from pemp_tpu_torch.device import resolve_device, tool_precision
    from pemp_tpu_torch.tools.profile_train import (
        WARMUP, flagship_setup, profile_calls, sync,
    )
    from pemp_tpu_torch.utils import profiling

    device = resolve_device(device)
    precision = tool_precision(device)
    setup = flagship_setup(hw, bs, "cedt", device, precision)
    flags = set_flags(ARMS[arm])
    fn = setup.step()
    for _ in range(WARMUP):
        loss = fn()
    sync(device)
    round_ms: List[float] = []
    t_end = time.perf_counter() + budget
    while len(round_ms) < 2 or time.perf_counter() < t_end:
        t0 = time.perf_counter()
        for _ in range(round_steps):
            loss = fn()
        sync(device)
        round_ms.append((time.perf_counter() - t0) * 1e3 / round_steps)
    prof, wall, _ = profile_calls(fn, 1, device, warmup=0)
    summary = profiling.summarize(prof, 1, wall)
    convs = profiling.conv_by_shape(prof, None)
    step_ms = min(round_ms)
    return {
        "path": "kernels", "precision": precision, "hw": hw,
        "episodes_per_s": bs / step_ms * 1e3, "step_ms": step_ms,
        "round_ms": round_ms, "loss_final": float(loss),
        "cudnn_flags": flags, "timeline": summary["timeline"],
        "device_ms_per_step": summary["device_ms_per_step"],
        "device_idle_share": summary["device_idle_share"],
        "conv_ms_by_dilation": conv_ms_by_dilation(convs),
        "conv_top": convs[:6],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


_RUNNER = ("import json; from pemp_tpu_torch.tools.exp_cudnn_flags import "
           "measure; r = measure({arm!r}, {bs}, {budget}, {hw}, "
           "{device!r}, {round_steps}); print('RESULT ' + json.dumps(r))")


def run_arm(name: str, bs: int, budget: float, hw: int = 401,
            device=None, round_steps: int = ROUND_STEPS) -> Dict:
    """``measure`` of one arm in a fresh process (its own cuDNN state)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    code = _RUNNER.format(arm=name, bs=bs, budget=budget, hw=hw,
                          device=device, round_steps=round_steps)
    try:
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=budget + 420)
    except subprocess.TimeoutExpired:
        return {"arm": name, "bs": bs, "error": "timeout"}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            r = json.loads(line[len("RESULT "):])
            r.update(arm=name, bs=bs, flags=ARMS[name])
            return r
    return {"arm": name, "bs": bs, "error": out.stderr.strip()[-400:]}


def summarize(results: List[Dict]) -> Dict:
    """The JAX tool's summary of the rows that ran (None without one)."""
    ok = [r for r in results if "error" not in r]
    if not ok:
        return None
    best = max(ok, key=lambda r: r["episodes_per_s"])
    base = {r["bs"]: r for r in ok if r["arm"] == "base"}
    rel = (best["episodes_per_s"] / base[best["bs"]]["episodes_per_s"]
           if best["bs"] in base else None)
    return {"best_arm": best["arm"], "best_bs": best["bs"],
            "best_eps_s": best["episodes_per_s"], "vs_base_same_bs": rel}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--budget", type=float, default=90,
                    help="per-arm measurement budget (s)")
    ap.add_argument("--arms", nargs="+", default=list(ARMS),
                    choices=list(ARMS))
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny CPU arm (harness check)")
    args = ap.parse_args(argv)

    if args.smoke:
        r = run_arm("base", **SMOKE)
        print(json.dumps(r), flush=True)
        if "error" in r:
            sys.exit(1)
        return [r], summarize([r])

    results = []
    for bs in args.bs:
        for name in args.arms:
            r = run_arm(name, bs, args.budget)
            results.append(r)
            print(json.dumps(r), flush=True)
    summary = summarize(results)
    if summary is not None:
        print(json.dumps(summary), flush=True)
    return results, summary


if __name__ == "__main__":
    main()
