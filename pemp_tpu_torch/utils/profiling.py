"""Device time of a profiled run, broken down by kernel.

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
  (``dilation``: the ASPPV2 branches share their shapes);
- ``summarize``: all of it per step; on the card also the device ms a
  step and the device idle share of the profiled window, 1 - device
  time / wall time (PERF.md §2), which a CPU-only profile leaves None;
  and the launches of the port's kernels K1-K5 as the profiler counted
  them (``KERNEL_SYMBOLS``).

Times are in microseconds as the profiler gives them, ms in the summary.
``chip_smoke.py``'s ``device_profile`` reads its traces with these
functions too.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

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
    profile."""
    from torch.autograd import DeviceType
    out: Dict[str, Tuple[float, int]] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            t, n = out.get(e.key, (0.0, 0))
            out[e.key] = (t + float(us), n + int(e.count))
    return out


def on_device(prof) -> bool:
    """Whether the profile holds device (CUDA) time."""
    return bool(device_times(prof))


def kernel_times(prof) -> Dict[str, Tuple[float, int]]:
    """``device_times``; on a CPU-only profile every CPU op's self-time,
    whose sum is at most the window's wall time."""
    times = device_times(prof)
    if times:
        return times
    return {e.key: (float(e.self_cpu_time_total), int(e.count))
            for e in prof.key_averages() if e.self_cpu_time_total > 0}


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


def dilation(op) -> Optional[int]:
    """The dilation of the convolution ``op`` belongs to (its own or its
    nearest ``DILATION_ARG`` ancestor's concrete inputs, recorded with
    ``record_shapes=True``); None where the profile has no such record."""
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
            key = (k.name[:60], op.name, str(op.input_shapes), dilation(op))
            acc = found.setdefault(key, [0.0, 0])
            acc[0] += k.duration
            acc[1] += 1
    if not any_kernel:
        for e in prof.events():
            parent = e.cpu_parent
            if "conv" not in e.name or (parent is not None
                                        and "conv" in parent.name):
                continue
            key = ("", e.name, str(e.input_shapes), dilation(e))
            acc = found.setdefault(key, [0.0, 0])
            acc[0] += e.cpu_time_total
            acc[1] += 1
    rows = sorted(found.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"kernel": kn, "op": op, "input_shapes": shapes, "dilation": d,
             "us": us, "calls": calls}
            for (kn, op, shapes, d), (us, calls) in rows]


def summarize(prof, steps: int, wall_s: float, top: int = 20) -> Dict:
    """The profiled window of ``steps`` steps (or eval launches) that took
    ``wall_s`` on the host clock, per step: the wall ms, the summed
    self-time of the timeline (``busy_ms_per_step``), the groups and the
    top kernels, the convolutions by shape and K1-K5's profiled launches.
    ``timeline`` says whose times they are: ``cuda`` (the card's kernels;
    then also the device ms a step, the host's gap and the device idle
    share) or ``cpu`` (a CPU-only profile's op self-times; the device
    metrics are then None, never a CPU number)."""
    times = kernel_times(prof)
    steps = max(int(steps), 1)
    card = on_device(prof)
    busy_ms = sum(us for us, _ in times.values()) / 1e3 / steps
    wall_ms = wall_s * 1e3 / steps
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])
    return {
        "timeline": "cuda" if card else "cpu",
        "wall_ms_per_step": wall_ms,
        "busy_ms_per_step": busy_ms,
        "device_ms_per_step": busy_ms if card else None,
        "dispatch_gap_ms_per_step": wall_ms - busy_ms if card else None,
        "device_idle_share": 1 - busy_ms / wall_ms if card else None,
        "groups_ms_per_step": {
            k: v / 1e3 / steps for k, v in sorted(
                groups(times).items(), key=lambda kv: -kv[1])},
        "top": [{"kernel": name[:90], "ms_per_step": us / 1e3 / steps,
                 "calls": calls} for name, (us, calls) in ranked[:top]],
        "conv_by_shape": conv_by_shape(prof),
        "profiled_launches": kernel_launches(times),
    }


def print_top(summary: Dict, unit: str, file) -> None:
    """The top-op table of ``summarize`` (the JAX tools' stderr table)."""
    for row in summary["top"]:
        print(f"  {row['ms_per_step']:8.3f} ms/{unit}  {row['kernel']}",
              file=file)
