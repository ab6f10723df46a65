"""Device time of a profiled run, broken down by kernel, and the spans
that mark the port's layers in it.

Counterpart of ``tools/profile_train.py:44`` ``device_plane_ops`` and its
``GROUPS``: the JAX tool reads the TPU's "XLA Ops" line of an xplane;
here the input is a ``torch.profiler.profile`` run (CPU and CUDA
activity, ``record_shapes=True`` for the convolutions by shape), and the
result is computed from its events:

- ``device_times``: device self-time and calls per kernel name (CUDA
  kernels, memcpy and memset); ``kernel_times`` the same, or on a
  CPU-only profile the CPU self-time per op instead (the JAX tool's CPU
  fallback), so the same keys come out where no card ran;
- ``groups``: those times under the JAX tool's labels, with the CUDA
  kernels' names mapped onto them (``GROUPS``); ``matching``: the time
  and calls of the names that hold given substrings;
- ``conv_by_shape``: the time of the convolutions' kernels grouped by the
  convolution op that launched them, its input shapes and its dilation
  (``dilation``: the ASPPV2 branches share their shapes; the
  space-to-batch route's dense convolution, forward and backward, counts
  under the dilation it computes);
- ``summarize``: all of it per step; on the card also the device ms a
  step and the device idle share of the profiled window, 1 - busy time
  / wall time, where busy time is the union of the device events'
  intervals (kernels on several streams overlap: their sum can exceed
  the wall), which a CPU-only profile leaves None; the device idle ms a
  step inside each of the port's spans (``SPANS``); and the launches of
  the port's kernels K1-K5 as the profiler counted them
  (``KERNEL_SYMBOLS``);
- ``span``: the port's layers mark their calls with it. While a profiler
  records, a span is a ``record_function`` range that lands in the same
  trace as the device's kernels, on one clock; otherwise it is a shared
  null context, so that an unprofiled call pays one check a span.

Times are in microseconds as the profiler gives them, ms in the summary.
``chip_smoke.py``'s ``device_profile`` reads its traces with these
functions too.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# the port's CUDA kernels (K1-K5) by the counter names of their wrappers
KERNEL_SYMBOLS = {"assign": "assign_kernel", "match": "match_kernel",
                  "mpm_bwd": "mpm_bwd_kernel",
                  "minplus": "minplus_kernel"}

# (substrings of a kernel or op name, label), first match wins. The
# labels are the JAX tool's; "custom-call/kernels" holds K1-K5 (the JAX
# tool's "custom-call/pallas"). cuDNN's implicit-GEMM convolution kernels
# hold "gemm" in their names, so the convolutions come before the GEMMs.
GROUPS: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (tuple(KERNEL_SYMBOLS.values()), "custom-call/kernels"),
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


# the port's spans, dotted by layer; each call has one root span
# (``evaluator.step``, ``fused.launch``) that the others nest inside
SPANS = (
    "evaluator.step", "evaluator.wire", "evaluator.forward",
    "evaluator.labels", "evaluator.metrics", "evaluator.fetch",
    "cascade.prior",
    "model.backbone", "model.purifier", "model.mpm", "model.upsample",
    "fused.launch", "fused.wire", "fused.warm_up", "fused.capture",
    "fused.slots", "fused.replay", "fused.outputs",
    "trainer.data",
)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records and no trace (``torch.compile``, ``torch.export``)
    is running, which would record it into its graph; otherwise a shared
    null context."""
    if (torch._C._autograd._profiler_enabled()
            and not torch.compiler.is_compiling()):
        return torch.profiler.record_function(name)
    return _NO_SPAN


def label(name: str) -> str:
    """The group of a kernel (or CPU op) name: ``GROUPS``' first match,
    else ``other``."""
    low = name.lower()
    for subs, group in GROUPS:
        if any(s in low for s in subs):
            return group
    return "other"


def device_times(prof) -> Dict[str, Tuple[float, int]]:
    """{name: (device self-time us, calls)}: the device kernels (and
    memcpy / memset) of a profile with CUDA activity; empty on a CPU-only
    profile. A span's shadow on the device (the range from its first to
    its last kernel) is no kernel and is left out."""
    from torch.autograd import DeviceType
    out: Dict[str, Tuple[float, int]] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if (e.device_type == DeviceType.CUDA and us > 0
                and not e.is_user_annotation):
            t, n = out.get(e.key, (0.0, 0))
            out[e.key] = (t + float(us), n + int(e.count))
    return out


def on_device(prof) -> bool:
    """Whether the profile holds device (CUDA) time."""
    return bool(device_times(prof))


def kernel_times(prof) -> Dict[str, Tuple[float, int]]:
    """``device_times``; on a CPU-only profile every CPU op's self-time
    (spans are no ops), whose sum is at most the window's wall time."""
    times = device_times(prof)
    if times:
        return times
    return {e.key: (float(e.self_cpu_time_total), int(e.count))
            for e in prof.key_averages()
            if e.self_cpu_time_total > 0 and not e.is_user_annotation}


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
            ) -> float:
    """The length of the intersection of two ``merged`` unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_intervals(prof) -> List[Tuple[float, float]]:
    """(start, end) us of each device kernel, memcpy and memset of a
    profile, spans' shadows left out; empty on a CPU-only profile."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def idle_by_span(prof, busy: List[Tuple[float, float]]
                 ) -> Dict[str, float]:
    """{span: us of its host intervals in which the device ran nothing}
    for each of ``SPANS`` in the profile; ``busy`` is the ``merged``
    device intervals."""
    from torch.autograd import DeviceType
    found: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            found[e.name].append((e.time_range.start, e.time_range.end))
    out = {}
    for name in SPANS:
        if name in found:
            host = merged(found[name])
            out[name] = sum(e - s for s, e in host) - covered(host, busy)
    return out


def groups(times: Dict[str, Tuple[float, int]]) -> Dict[str, float]:
    """``kernel_times`` summed by ``label`` (us)."""
    out: Dict[str, float] = defaultdict(float)
    for name, (us, _) in times.items():
        out[label(name)] += us
    return dict(out)


def matching(times: Dict[str, Tuple[float, int]], subs) -> Tuple[float, int]:
    """The summed (us, calls) of the names in ``times`` that hold one of
    the substrings ``subs``."""
    hits = [v for name, v in times.items() if any(s in name for s in subs)]
    return sum(us for us, _ in hits), sum(n for _, n in hits)


def kernel_launches(times: Dict[str, Tuple[float, int]]) -> Dict[str, int]:
    """K1-K5's launches as the profiler counted them (0 for each on a CPU
    profile: the plain versions launch no kernel)."""
    return {k: matching(times, (sym,))[1] for k, sym in KERNEL_SYMBOLS.items()}


# the dilation's position among the concrete inputs of the convolution
# ops every backend's forward and backward pass through
DILATION_ARG = {"aten::conv2d": 5, "aten::convolution": 5,
                "aten::_convolution": 5, "aten::convolution_backward": 6}


# ``ops/s2b.py``'s span around a call of the space-to-batch route: its
# dense convolution computes the dilated one of the dilation in the name
S2B_SPAN = "s2b.d"
BACKWARD_NODE = "autograd::engine::evaluate_function: "


def _s2b_span(op) -> Optional[int]:
    """The dilation of the ``S2B_SPAN`` that ``op`` runs inside, if any."""
    while op is not None:
        if op.name.startswith(S2B_SPAN):
            return int(op.name[len(S2B_SPAN):])
        op = op.cpu_parent
    return None


def s2b_routes(prof) -> Dict[Tuple[int, int], int]:
    """{(thread, sequence number): dilation} of the autograd nodes made
    inside an ``S2B_SPAN``: the backward of such a node runs outside the
    span, under an event of the same sequence number and forward
    thread."""
    return {(e.thread, e.sequence_nr): d for e in prof.events()
            if getattr(e, "sequence_nr", -1) >= 0
            and (d := _s2b_span(e)) is not None}


def dilation(op, routes: Optional[Dict[Tuple[int, int], int]] = None
             ) -> Optional[int]:
    """The dilation of the convolution ``op`` belongs to (its own or its
    nearest ``DILATION_ARG`` ancestor's concrete inputs, recorded with
    ``record_shapes=True``); None where the profile has no such record.
    The space-to-batch route's dense convolution gives the dilation it
    computes: in its forward from its ``S2B_SPAN``, in its backward from
    ``routes`` (``s2b_routes``)."""
    d = _s2b_span(op)
    if d is not None:
        return d
    node = op
    while node is not None and not node.name.startswith(BACKWARD_NODE):
        node = node.cpu_parent
    if node is not None and routes:
        d = routes.get((node.fwd_thread, node.sequence_nr))
        if d is not None:
            return d
    while op is not None and op.name not in DILATION_ARG:
        op = op.cpu_parent
    if op is None:
        return None
    args = getattr(op, "concrete_inputs", None) or []
    idx = DILATION_ARG[op.name]
    value = args[idx] if idx < len(args) else None
    return int(value[0]) if value else None


def conv_by_shape(prof, top: Optional[int] = 12, kernels=("",)
                  ) -> List[Dict]:
    """The convolutions' time grouped by (kernel, conv op, input shapes,
    dilation), largest first (the ``top`` rows; all with None): each
    device kernel whose name holds one of the substrings ``kernels`` under
    the nearest op whose name holds "conv"; on a CPU-only profile, each
    conv op's own CPU time (no device kernels). Needs
    ``record_shapes=True``."""
    found: Dict[tuple, List[float]] = {}
    routes = s2b_routes(prof)
    any_kernel = False
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            any_kernel = True
            if not any(s in k.name for s in kernels):
                continue
            op = e
            while op.cpu_parent is not None and "conv" not in op.name:
                op = op.cpu_parent
            if "conv" not in op.name:
                continue
            key = (k.name[:60], op.name, str(op.input_shapes),
                   dilation(op, routes))
            acc = found.setdefault(key, [0.0, 0])
            acc[0] += k.duration
            acc[1] += 1
    if not any_kernel:
        for e in prof.events():
            parent = e.cpu_parent
            if "conv" not in e.name or (parent is not None
                                        and "conv" in parent.name):
                continue
            key = ("", e.name, str(e.input_shapes), dilation(e, routes))
            acc = found.setdefault(key, [0.0, 0])
            acc[0] += e.cpu_time_total
            acc[1] += 1
    rows = sorted(found.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"kernel": kn, "op": op, "input_shapes": shapes, "dilation": d,
             "us": us, "calls": calls}
            for (kn, op, shapes, d), (us, calls) in rows]


def summarize(prof, steps: int, wall_s: float, top: int = 20) -> Dict:
    """The profiled window of ``steps`` steps (or eval launches) that took
    ``wall_s`` on the host clock, per step: the wall ms, the busy ms
    (``busy_ms_per_step``), the groups and the top kernels, the
    convolutions by shape and K1-K5's profiled launches. ``timeline``
    says whose times they are: ``cuda`` (the card's kernels; busy is the
    union of their intervals; then also the device ms a step, the host's
    gap, the device idle share and the device idle ms a step inside each
    of the port's spans, ``idle_ms_per_step_by_span``) or ``cpu`` (a
    CPU-only profile's op self-times, summed; the device metrics are then
    None, never a CPU number)."""
    times = kernel_times(prof)
    steps = max(int(steps), 1)
    card = on_device(prof)
    wall_ms = wall_s * 1e3 / steps
    if card:
        busy = merged(device_intervals(prof))
        busy_ms = sum(e - s for s, e in busy) / 1e3 / steps
        by_span = {k: us / 1e3 / steps
                   for k, us in idle_by_span(prof, busy).items()}
    else:
        busy_ms = sum(us for us, _ in times.values()) / 1e3 / steps
        by_span = None
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])
    return {
        "timeline": "cuda" if card else "cpu",
        "wall_ms_per_step": wall_ms,
        "busy_ms_per_step": busy_ms,
        "device_ms_per_step": busy_ms if card else None,
        "dispatch_gap_ms_per_step": wall_ms - busy_ms if card else None,
        "device_idle_share": 1 - busy_ms / wall_ms if card else None,
        "idle_ms_per_step_by_span": by_span,
        "groups_ms_per_step": {
            k: v / 1e3 / steps for k, v in sorted(
                groups(times).items(), key=lambda kv: -kv[1])},
        "top": [{"kernel": name[:90], "ms_per_step": us / 1e3 / steps,
                 "calls": calls} for name, (us, calls) in ranked[:top]],
        "conv_by_shape": conv_by_shape(prof),
        "profiled_launches": kernel_launches(times),
    }


def print_top(summary: Dict, unit: str, file) -> None:
    """The top-op table of ``summarize`` (the JAX tools' stderr table),
    then on the card where the device waited: its idle ms inside each of
    the port's spans."""
    for row in summary["top"]:
        print(f"  {row['ms_per_step']:8.3f} ms/{unit}  {row['kernel']}",
              file=file)
    for name, ms in (summary["idle_ms_per_step_by_span"] or {}).items():
        print(f"  {ms:8.3f} ms/{unit} device idle inside {name}", file=file)
