"""Reading a profiled sub-window: device intervals, their union, kernel
time by name and group, and what the host did in the device's idle gaps.

The kernel-name groups are copied from the program's
``pemp_tpu_torch/utils/profiling.py`` (``GROUPS``, ``KERNEL_SYMBOLS``),
so that a change to the program cannot move them. The profile is written
as a Chrome trace into a temporary file under ``TMPDIR``, read, and
removed; the sub-window is the span ``bench.window`` that the drivers
record around it, closed by a synchronize.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from benchmark import arith

# the program's CUDA kernels K1-K5 by the names their wrappers count
KERNEL_SYMBOLS = {"assign": "assign_kernel", "match": "match_kernel",
                  "mpm_bwd": "mpm_bwd_kernel", "minplus": "minplus_kernel"}

# (substrings of a kernel name, group), the first match wins; cuDNN's
# implicit-GEMM convolutions hold "gemm", so "conv" comes before "matmul"
GROUPS: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (tuple(KERNEL_SYMBOLS.values()), "kernels"),
    (("nccl",), "collective"),
    (("memcpy", "memset", "nchwtonhwc", "nhwctonchw", "copy", "transpose"),
     "copy"),
    (("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm",
      "implicit_convolve", "xmma_fprop"), "conv"),
    (("gemm", "gemv", "cublas", "cutlass", "matmul", "addmm", "bmm"),
     "matmul"),
    (("pool",), "pool"),
    (("scatter", "index_put", "indexing_backward", "index_add"), "scatter"),
    (("elementwise", "reduce", "norm", "softmax", "fused", "triton",
      "vectorized", "unrolled", "where", "cat", "add", "mul", "relu"),
     "fusion"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
WINDOW_SPAN = "bench.window"


def group(name: str) -> str:
    low = name.lower()
    for subs, label in GROUPS:
        if any(s in low for s in subs):
            return label
    return "other"


@dataclass
class Timeline:
    """The sub-window's device and host events (seconds)."""
    start: float
    end: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """The union of the device's kernel and copy intervals."""
        return arith.union_seconds((s, e) for _, s, e in self.device)

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        out: Dict[str, Tuple[float, int]] = {}
        for name, s, e in self.device:
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + e - s, n + 1)
        return out

    def by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            out[group(name)] += e - s
        return dict(out)

    def kernel(self, key: str) -> Tuple[float, int]:
        """(device seconds, launches) of the program's kernel ``key``."""
        sym = KERNEL_SYMBOLS[key]
        hits = [(e - s) for name, s, e in self.device if sym in name]
        return sum(hits), len(hits)

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time summed by the innermost host event
        that spans each gap's middle, longest first (one sweep: the
        shortest live event over middles in time order)."""
        out: Dict[str, float] = defaultdict(float)
        spans = sorted((s, e, name) for name, s, e in self.host)
        live: List[Tuple[float, float, str]] = []     # (length, end, name)
        i = 0
        for gs, ge in arith.gaps([(s, e) for _, s, e in self.device],
                                 self.start, self.end):
            mid = (gs + ge) / 2
            while i < len(spans) and spans[i][0] <= mid:
                s, e, name = spans[i]
                heapq.heappush(live, (e - s, e, name))
                i += 1
            while live and live[0][1] <= mid:
                heapq.heappop(live)
            out[live[0][2] if live else "(no host event)"] += ge - gs
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
                ][:top]

    def device_ops(self, top: int = 10) -> List[List]:
        ranked = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])
        return [[name, t] for name, (t, _) in ranked[:top]]


def timeline(prof) -> Timeline:
    """The events of ``prof`` (a finished ``torch.profiler.profile``)
    inside its ``bench.window`` span, clipped to it."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not spans:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} span")
    w = max(spans, key=lambda e: e["dur"])
    start, end = w["ts"] * 1e-6, (w["ts"] + w["dur"]) * 1e-6
    tl = Timeline(start, end)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = e["ts"] * 1e-6
        t = s + e["dur"] * 1e-6
        s, t = max(s, start), min(t, end)
        if t <= s:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tl.device.append((e["name"], s, t))
        elif cat in HOST_CATS and e["name"] != WINDOW_SPAN:
            tl.host.append((e["name"], s, t))
    return tl
