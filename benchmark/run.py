"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The cell, its configuration, its traffic mix and its metrics come
from ``BENCHMARK.json`` and the files it names (``manifest.py``). The run:

1. set-up: the episodes and the weights from ``--seed`` on the card, the
   program's model, trainer or evaluator, the kernels' build on a
   checkout's first run (``build/`` in the checkout), every shape of the
   mix warmed, a training cell's check launches;
2. the window: ``--seconds`` of calls, closed by a fetch;
3. with ``--trace 1``, a profiled sub-window after it;
4. the program freed, the plain reference over the check's steps or a
   sample of the window's answers (``check.py``), each number printed
   beside its limit;
5. the last line of stdout: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
   per-layer ones), ``device``, ``breakdown`` (traced) and ``compared``.

Without a card, with too few, with the program missing, or with JAX or
the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "pemp_tpu")
THREADS = 1


def fixed_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = str(THREADS)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of ``cell`` (``manifest.Cell``) on ``device``: the result
    line's fields."""
    import torch
    from benchmark import check, drivers, manifest
    from benchmark import timeline as tracing
    cfg, mix = cell.config, cell.mix
    driver = drivers.make(cfg, mix, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    window = driver.window(seconds)
    ms = sorted(1e3 * t for t in window.call_s)
    print(f"window calls {window.calls} seconds {window.seconds!r} call ms "
          f"p10 {ms[len(ms) // 10]!r} p50 {ms[len(ms) // 2]!r} p90 "
          f"{ms[9 * len(ms) // 10]!r} max {ms[-1]!r}", file=sys.stderr)
    traced = driver.profile() if trace else None
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    driver.close()
    values = check.run(driver, window, sys.stderr)
    correct, compared = check.judge(values, check.limits(cell.name))
    ctx = SimpleNamespace(
        cell=cell.name, config=cfg, mix=mix, window=window, setup_s=setup_s,
        trace=None, flops_per_call=None,
        device_name=torch.cuda.get_device_name(device) if cuda else "cpu")
    out = {"correct": correct, "attempted": window.episodes,
           "failed": window.failed}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": ctx.device_name, "count": 1,
                   "memory_peak_bytes": peak}
    if trace:
        t0 = time.perf_counter()
        tl = tracing.timeline(traced["prof"])
        ctx.trace = {**traced, "timeline": tl}
        ctx.flops_per_call = driver.flops_per_call()
        device_info.update(busy_s=tl.busy_s(), window_s=tl.window_s)
        print(f"trace read in {time.perf_counter() - t0!r} s: "
              f"{len(tl.device)} device and {len(tl.host)} host events, "
              f"{ctx.flops_per_call!r} FLOPs a call", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device_info
    if trace:
        out["breakdown"] = {"device_ops": tl.device_ops(),
                            "idle_gaps": tl.idle_gaps()}
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()
    # the checkout's root, not this folder: the harness's modules are
    # imported as the package ``benchmark`` and shadow nothing
    sys.path[0] = str(ROOT)
    import torch
    from benchmark import manifest
    cell = manifest.cell(args.workload)
    try:
        import pemp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
