"""Microbenchmark: can int8 convolutions beat bf16 on this card?

Counterpart of ``tools/exp_int8_conv.py``: the model's dominant conv
shapes (the dilated 3x3 ASPP conv, a ResNet 1x1, the layer-3 3x3 d=2) at
B=64, bf16 against int8 with int32 accumulation, to decide whether a
quantized serving mode is worth building. One JSON line per case, with
the JAX tool's keys (``case``, ``flops``, ``<arm>_ms``,
``<arm>_tflops``, or ``<arm>_error`` where an arm raises).

PyTorch has no int8 cuDNN convolution, so the int8 arm is the
convolution as one int8 GEMM through ``torch._int_mm`` (cuBLASLt, int32
accumulation), channels-last (``int8_conv``):

- a 1x1 conv (subsampled for stride 2) is one GEMM, K = C_in;
- a k x k or dilated conv is one im2col GEMM: the k^2 shifted (strided)
  input windows side by side, K = k^2 C_in (the 7x7 stem's 147 padded
  with zeros to 152), rather than k^2 GEMMs summed in int32, whose
  separate window copies and int32 additions each pass over the output.

``_int_mm`` needs K and N multiples of 8: both are padded with zeros
where they are not, and each row records the padding (``k_pad``,
``n_pad``: [before, after]). The gather runs inside the timed window.
The ``bf16`` arm is ``F.conv2d`` in bf16, channels-last (cuDNN, what the
model runs); ``bf16_gemm`` is the same GEMM formulation in bf16, so that
a loss can be pinned on the formulation or on the type. ``int8_mm`` and
``bf16_mm`` time each type's GEMM alone, on its left operand already
quantized (or cast) and gathered outside the window, so that the passes
around a GEMM can be told from the GEMM itself.
Both arms start from the same float32 input, cast or quantized inside
the window as in the JAX tool. This tool quantizes with the JAX tool's
fixed scales (x * 16, w * 512, round half to even, clip +-127); the
weights are quantized once outside the window. The inputs are drawn on
the device from a seeded generator, N(0, 1) and N(0, 1) * 0.05 as the
JAX tools draw theirs on the host.

Timing (``bench``): on the card CUDA events around ``iters`` calls,
after a warm-up call, the best of ``rounds`` (the JAX tool's best of
rounds; its value fetch closed a TPU window); on the CPU the host clock.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.exp_int8_conv
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from pemp_tpu_torch.device import resolve_device

# (name, N, H, W, Cin, Cout, k, dilation): the JAX tool's cases, B=64
# images (32 episodes of S+Q=2)
CASES = [
    ("aspp_3x3_d6", 64, 51, 51, 256, 256, 3, 6),
    ("res_1x1", 64, 51, 51, 1024, 256, 1, 1),
    ("res_3x3_d2", 64, 51, 51, 256, 256, 3, 2),
]
ITERS, ROUNDS = 30, 5
X_SCALE, W_SCALE = 16.0, 512.0      # the JAX tool's fixed scales


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, round half to even
    (``jnp.round``); ``scale`` a float32 scalar or a per-channel vector
    on the last axis."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def amax_scale(x: torch.Tensor, dims=None) -> torch.Tensor:
    """The symmetric scale ``max |x| / 127 + 1e-12`` (float32), over all
    of ``x`` or per channel of the last axis (``dims`` the others)."""
    a = x.abs().amax() if dims is None else x.abs().amax(dim=dims)
    return a / 127.0 + 1e-12


def out_size(h: int, k: int, s: int, d: int) -> int:
    pad = d * (k - 1) // 2
    return (h + 2 * pad - d * (k - 1) - 1) // s + 1


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def formulation(k: int) -> str:
    """How ``int8_conv`` computes a k x k conv."""
    return "1x1" if k == 1 else "im2col"


def windows(xp: torch.Tensor, k: int, s: int, d: int, oh: int, ow: int):
    """The k^2 input windows of a k x k conv of stride ``s``, dilation
    ``d`` on the padded NHWC ``xp``, tap (i, j) in row-major order."""
    for i in range(k):
        for j in range(k):
            yield xp[:, i * d:i * d + s * (oh - 1) + 1:s,
                     j * d:j * d + s * (ow - 1) + 1:s, :]


@dataclass
class GemmConv:
    """A k x k conv (stride ``s``, dilation ``d``, zero padding
    d (k - 1) / 2) as one GEMM on NHWC input: ``weight`` is the
    [N_pad, K_pad] matrix, passed to the GEMM transposed."""
    k: int
    s: int
    d: int
    cin: int
    cout: int
    kind: str
    weight: torch.Tensor

    @property
    def k_pad(self) -> Tuple[int, int]:
        k = self.k * self.k * self.cin
        return (k, pad8(k))

    @property
    def n_pad(self) -> Tuple[int, int]:
        return (self.cout, pad8(self.cout))

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        return (out_size(h, self.k, self.s, self.d),
                out_size(w, self.k, self.s, self.d))

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """The GEMM's [M, K_pad] left operand of NHWC ``x``: its pixels
        (1x1) or its k^2 windows side by side (im2col), K padded."""
        n, h, w, c = x.shape
        oh, ow = self.out_hw(h, w)
        m = n * oh * ow
        kin, kpad = self.k_pad
        if self.kind == "1x1":
            a = x[:, ::self.s, ::self.s, :].reshape(m, c)
        else:
            p = self.d * (self.k - 1) // 2
            xp = F.pad(x, (0, 0, p, p, p, p))
            a = torch.cat(list(windows(xp, self.k, self.s, self.d, oh, ow)),
                          dim=-1).reshape(m, kin)
        if kpad != kin:
            a = F.pad(a, (0, kpad - kin))
        return a

    def __call__(self, x: torch.Tensor, mm: Callable) -> torch.Tensor:
        """The conv of NHWC ``x`` with ``mm(a [M, K], b [K, N])`` as the
        GEMM; NHWC output, ``mm``'s accumulation type."""
        n, h, w, _ = x.shape
        oh, ow = self.out_hw(h, w)
        out = mm(self.operand(x), self.weight.t())
        return out[:, :self.cout].reshape(n, oh, ow, self.cout)


def gemm_conv(w: torch.Tensor, s: int, d: int) -> GemmConv:
    """``w`` (HWIO, the JAX tool's layout) as ``GemmConv`` weights in
    ``w``'s dtype, K and N padded with zeros to multiples of 8."""
    k, _, cin, cout = w.shape
    # [Cout, k, k, Cin]: K ordered as the windows are concatenated
    mat = w.permute(3, 0, 1, 2).reshape(cout, k * k * cin)
    mat = F.pad(mat, (0, pad8(k * k * cin) - k * k * cin, 0,
                      pad8(cout) - cout)).contiguous()
    return GemmConv(k, s, d, cin, cout, formulation(k), mat)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 (cuBLASLt IMMA on the card)."""
    return torch._int_mm(a, b)


def int8_conv(xq: torch.Tensor, conv: GemmConv) -> torch.Tensor:
    """The int32 accumulation of an int8 conv: NHWC int8 ``xq``, int8
    ``conv`` weights."""
    return conv(xq, int_mm)


def exact_conv(xq: torch.Tensor, w: torch.Tensor, s: int, d: int
               ) -> torch.Tensor:
    """The exact integer conv of int8 NHWC ``xq`` and HWIO ``w`` (NHWC,
    int64): float64 ``F.conv2d``, whose integer partial sums stay far
    below 2^53 and so are exact in any order."""
    k = w.shape[0]
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 w.permute(3, 2, 0, 1).double(), stride=s,
                 padding=d * (k - 1) // 2, dilation=d)
    return y.permute(0, 2, 3, 1).round().long()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn: Callable, device: torch.device, iters: int = ITERS,
          rounds: int = ROUNDS) -> float:
    """Best-of-rounds ms a call of ``fn`` (shared with
    ``exp_int8_blend``): CUDA events around ``iters`` calls on the card,
    the host clock on the CPU, after one warm-up call."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    return best


def bf16_conv_fn(x: torch.Tensor, w: torch.Tensor, s: int, d: int
                 ) -> Callable:
    """The bf16 arm: the float32 NHWC ``x`` cast to bf16 and convolved by
    cuDNN channels-last (``F.conv2d``) with HWIO ``w``."""
    k = w.shape[0]
    wb = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    pad = d * (k - 1) // 2

    def fn():
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)    # channels-last
        return F.conv2d(xb, wb, None, s, pad, d)
    return fn


def bf16_gemm_fn(x: torch.Tensor, w: torch.Tensor, s: int, d: int
                 ) -> Callable:
    """The bf16 GEMM arm: ``GemmConv``'s formulation in bf16."""
    conv = gemm_conv(w.to(torch.bfloat16), s, d)
    return lambda: conv(x.to(torch.bfloat16), torch.mm)


def bf16_mm_fn(x: torch.Tensor, w: torch.Tensor, s: int, d: int
               ) -> Callable:
    """The ``bf16_mm`` arm: ``bf16_gemm``'s GEMM alone, its operand cast
    and gathered outside the window."""
    conv = gemm_conv(w.to(torch.bfloat16), s, d)
    a, b = conv.operand(x.to(torch.bfloat16)), conv.weight.t()
    return lambda: torch.mm(a, b)


def int8_mm_fn(xq: torch.Tensor, conv: GemmConv) -> Callable:
    """The ``int8_mm`` arm: ``int8_conv``'s GEMM alone, on the int8 NHWC
    ``xq`` gathered outside the window."""
    a, b = conv.operand(xq), conv.weight.t()
    return lambda: int_mm(a, b)


def time_arms(row: Dict, arms: Dict[str, Callable], flops: float,
              device: torch.device, iters: int, rounds: int) -> List[str]:
    """Time each arm into ``row`` (``<arm>_ms``, ``<arm>_tflops``, or
    ``<arm>_error``); returns the arms that raised."""
    failed = []
    for label, make in arms.items():
        try:
            ms = bench(make(), device, iters, rounds)
            row[label + "_ms"] = ms
            row[label + "_tflops"] = flops / (ms * 1e-3) / 1e12
        except Exception as e:      # an arm may not run on every card
            row[label + "_error"] = repr(e)[:120]
            failed.append(label)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return failed


def case_inputs(gen: torch.Generator, n: int, h: int, w: int, ci: int,
                co: int, k: int, device: torch.device):
    """The JAX tools' distributions, drawn on ``device`` from ``gen``:
    x ~ N(0, 1) NHWC, w ~ N(0, 1) * 0.05 HWIO, float32."""
    x = torch.randn(n, h, w, ci, generator=gen, device=device)
    wgt = torch.randn(k, k, ci, co, generator=gen, device=device) * 0.05
    return x, wgt


def generator(device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def run(device: torch.device) -> List[Dict]:
    """Every case of ``CASES``: one JSON line each."""
    gen = generator(device)
    rows = []
    for name, n, h, w, ci, co, k, d in CASES:
        x, wgt = case_inputs(gen, n, h, w, ci, co, k, device)
        flops = 2 * n * h * w * ci * co * k * k
        conv = gemm_conv(quantize(wgt, 1.0 / W_SCALE), 1, d)
        row = {"case": name, "flops": flops, "formulation": conv.kind,
               "k_pad": list(conv.k_pad), "n_pad": list(conv.n_pad)}

        def int8_fn(x=x, conv=conv):
            return lambda: int8_conv(quantize(x, 1.0 / X_SCALE), conv)

        time_arms(row, {
            "bf16": lambda: bf16_conv_fn(x, wgt, 1, d),
            "bf16_gemm": lambda: bf16_gemm_fn(x, wgt, 1, d),
            "int8": int8_fn,
            "bf16_mm": lambda: bf16_mm_fn(x, wgt, 1, d),
            "int8_mm": lambda: int8_mm_fn(quantize(x, 1.0 / X_SCALE),
                                          conv)},
            flops, device, ITERS, ROUNDS)
        row["device"] = device_name(device)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, wgt, conv
    return rows


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
