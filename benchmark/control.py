"""The readings that the limits of ``benchmark/limits/<cell>.json`` are
set from, on the card, at the cell's own size, in one process:

- the program's numbers on each seed (``run.run_cell`` with a short
  window: the same set-up, check launches, answers and reference as a
  benchmark run);
- on the first ``--control-seeds`` seeds the readings of the mix's mode
  (``control`` in ``benchmark/drivers/<mode>.py``): the reference put
  in the program's place at the precision below the configuration's
  (``precision="fp8"``: every encoder convolution's operands in float8
  e4m3, its output's cotangent in e5m2), held against the float32
  reference by the same numbers; for a training cell also the fault
  ``half_batch`` (each step's loss over half its batch) planted in that
  reference. A step that leaves the state unchanged reads 1 on
  ``change_gap`` by its definition and needs no run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 3] [--seconds 1]

One JSON line a seed on stdout. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    from benchmark import drivers, run
    out = run.run_cell(cell, seed, seconds, False, device,
                       time.perf_counter())
    rec = {"seed": seed, "correct": out["correct"],
           "program": {k: v["value"] for k, v in out["compared"].items()}}
    if control:
        rec.update(drivers.mode(cell.mix).control(cell, seed, device))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch
    from benchmark import manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = readings(cell, seed, args.seconds, i < args.control_seeds,
                       device)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
