"""Dilated 3x3 convolutions as one dense convolution over phase subgrids
(space to batch).

A 3x3, stride-1 convolution of dilation and zero padding d reads, for the
output pixel (i, j), the inputs (i + d u, j + d v), u, v in {-1, 0, 1}:
pixels of its own phase (i mod d, j mod d) only. Pixel (q d + a, r d + b)
is row q, column r of phase (a, b), and its dilated taps i - d, i + d are
that subgrid's neighbours q - 1, q + 1. So the convolution is one dense
padding-1 3x3 convolution with the same weight and bias over the phase
subgrids stacked as a batch, the result put back in place:

- H and W are padded with zeros up to whole subgrids: ``ceil(H / d)``
  rows a phase. The pad-up pixels are zeros that the dilated
  convolution's own zero padding would read there too, and their outputs
  are dropped. Below d only ``H`` row phases exist (each one row), so a
  map smaller than d takes no more pixels than it has;
- the copy in (pad and phase gather) is one zero fill and one
  ``index_copy``, the copy out (interleave and crop) one
  ``index_select``, both on the channels-last rows with one cached index
  (``phase_index``); the result is channels-last for a channels-last
  input (an NCHW one takes a copy in and out more);
- the sums are the dilated convolution's, in the order cuDNN (or the
  CPU's convolution) takes for the dense shape, in the input's dtype.

cuDNN runs a dilated 3x3 at dilation 12 and 18 with no fast kernel of its
own: the ASPP heads' 256 -> 256 convolutions at 51^2 took 9.6 and 8.1 ms at
B = 1 through its grouped direct fallback, and 0.081 and 0.074 ms as
this dense convolution (H100, bf16).

``s2b_calls`` counts the calls by dilation, at the Python level, as
``kernels/mpm.py``'s ``launches`` counts its launches: a CUDA graph's
replay adds nothing. While a profiler records, each call is the span
``s2b.d<d>`` (``utils/profiling.py::dilation`` reads it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.ops.resize import device_constant
from pemp_tpu_torch.utils.profiling import S2B_SPAN, span

# The least dilation the models' convolutions take this route at. Dense
# space to batch was measured faster than cuDNN's dilated kernels at 12 and
# 18 (5.5-118x, forward and backward) and slower at 2 (3.5-5.1x) and 6, on
# the H100 in bf16; the models dilate by 2, 4 and 6 (trunks, VGG block 5,
# RPMMs, the ASPPs' first branch) or by 12 and 18 (the ASPP heads), so 12
# parts the two sets.
S2B_MIN_DILATION = 12

# calls of ``s2b_conv2d`` by dilation
s2b_calls: Dict[int, int] = {}


def reset_s2b_calls() -> None:
    s2b_calls.clear()


def s2b_calls_since(before: Dict[int, int]) -> Dict[int, int]:
    """The calls by dilation since ``before``, a copy of ``s2b_calls``."""
    return {d: n - before.get(d, 0) for d, n in s2b_calls.items()
            if n != before.get(d, 0)}


def phase_dilation(conv: nn.Conv2d) -> int:
    """d where ``conv`` is a 3x3, stride-1, ungrouped, zero-padded
    convolution with ``padding == dilation = d > 1`` (one that
    ``s2b_conv2d`` computes), else 0."""
    d = conv.dilation[0]
    eligible = (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
                and conv.groups == 1 and conv.padding_mode == "zeros"
                and conv.dilation == (d, d) and conv.padding == (d, d)
                and d > 1)
    return d if eligible else 0


def _phase_index(h: int, w: int, d: int) -> np.ndarray:
    """[h w] int64: the row of pixel (i, j) (row-major) among the phase
    batch's rows, phase (i mod d, j mod d) major, then i // d, j // d."""
    hq, wq = -(-h // d), -(-w // d)
    pb = min(d, w)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    return (((i % d) * pb + j % d) * (hq * wq)
            + (i // d) * wq + j // d).reshape(-1).astype(np.int64)


def phase_index(h: int, w: int, d: int, device) -> torch.Tensor:
    """``_phase_index`` as a cached int64 tensor on ``device``."""
    device = torch.device(device)
    return device_constant(("s2b", h, w, d, device), device,
                           lambda: torch.from_numpy(
                               _phase_index(h, w, d)).to(device))


def s2b_conv2d(x: torch.Tensor, weight: torch.Tensor, bias, d: int
               ) -> torch.Tensor:
    """The 3x3 convolution of dilation and zero padding ``d`` (stride 1) of
    NCHW ``x`` as one dense padding-1 convolution over its phase
    subgrids (the module's docstring). Under autocast ``x`` is cast
    before the gather, as the convolution would cast it (float64 is
    not)."""
    s2b_calls[d] = s2b_calls.get(d, 0) + 1
    with span(f"{S2B_SPAN}{d}"):
        kind = x.device.type
        if torch.is_autocast_enabled(kind) and x.dtype != torch.float64:
            x = x.to(torch.get_autocast_dtype(kind))
        n, c, h, w = x.shape
        hq, wq = -(-h // d), -(-w // d)
        phases = min(d, h) * min(d, w)
        idx = phase_index(h, w, d, x.device)
        rows = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        xr = x.new_zeros(n, phases * hq * wq, c).index_copy(1, idx, rows)
        xr = xr.view(n * phases, hq, wq, c).permute(0, 3, 1, 2)
        y = F.conv2d(xr, weight, bias, padding=1)
        co = y.shape[1]
        y = y.permute(0, 2, 3, 1).reshape(n, phases * hq * wq, co)
        out = y.index_select(1, idx).view(n, h, w, co).permute(0, 3, 1, 2)
        if x.is_contiguous() and not out.is_contiguous():
            out = out.contiguous()      # NCHW in, NCHW out
        return out
