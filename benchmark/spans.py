"""Reading the program's own spans in a profiled sub-window: the device's
idle time inside them, and how many there are.

The program marks its layers with ``record_function`` spans while a
profiler records (``pemp_tpu_torch/utils/profiling.py::span``). They land
in the same trace as the device's kernels, on one clock, and
``timeline.Timeline.host`` keeps them. The names are copied here, so that
a change to the program cannot move the yardstick; a program that records
none (one that predates them) gives no reading.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from benchmark import arith

# each call's root span: the evaluator's step, the trainer's fused launch
EVAL_ROOT = "evaluator.step"
LAUNCH_ROOT = "fused.launch"


def count(tl, name: str) -> int:
    """How many spans named ``name`` the sub-window holds."""
    return sum(1 for n, _, _ in tl.host if n == name)


def idle_in(tl, names: Iterable[str]) -> Optional[float]:
    """The device's idle seconds inside the host intervals of the spans
    ``names``: the union of those intervals, less the part of it that the
    union of the device's kernel and copy intervals covers. Nested or
    repeated spans count their time once. None where no such span is
    in the sub-window."""
    names = set(names)
    spans = [(s, e) for n, s, e in tl.host if n in names]
    if not spans:
        return None
    host = _merged(spans)
    busy = _merged((s, e) for _, s, e in tl.device)
    return arith.union_seconds(host) - _overlap(host, busy)


def idle_ms_per(ctx, names: Iterable[str], root: str, per_root: int = 1
                ) -> Optional[float]:
    """A reader's value: the idle ms inside ``names`` over the number of
    ``root`` spans times ``per_root`` (the steps a root holds); None
    without a trace or without the program's spans."""
    if ctx.trace is None:
        return None
    tl = ctx.trace["timeline"]
    roots = count(tl, root)
    idle = idle_in(tl, names)
    if not roots or idle is None:
        return None
    return idle * 1e3 / (roots * per_root)


def _merged(intervals: Iterable[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint ones, in time order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
             ) -> float:
    """The length of the intersection of two ``_merged`` unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
