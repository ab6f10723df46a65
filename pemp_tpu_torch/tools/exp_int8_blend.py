"""Blended int8-vs-bf16 estimate over the flagship eval conv inventory.

Counterpart of ``tools/exp_int8_blend.py``: every conv shape of the
PEMP-s1 ResNet-50 eval path (ResNet-50 dilated to output stride 8 +
purifier + ASPPV2, 401^2 input, B=64 images = 32 episodes of S+Q=2),
each timed in bf16 against int8 with DYNAMIC activation quantization
(the amax and scale inside the timed window, what a real serving mode
would pay; the weights quantized outside with a static per-output-
channel scale, as they are static at serving time), and the same GEMM
formulation in bf16, and each type's GEMM alone (``*_mm``). The arms
and their formulations are ``exp_int8_conv``'s (``torch._int_mm`` GEMMs
for int8, cuDNN for bf16);
the int8 arm's output is dequantized to float32 inside the window, as
in the JAX tool.

Prints one JSON line per shape with the JAX tool's keys (``case``,
``count``, ``gflops``, ``<arm>_ms``, ``<arm>_tflops``), the formulation
and the padding, then the blended summary: ``blend_<arm>_ms`` (each
row's time x its count), ``total_gflops`` and ``speedup`` (bf16 / int8),
printed only when no arm errored (``errors`` lists them otherwise: a
partial blend compares mismatched inventories).

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.exp_int8_blend
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch

from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.tools.exp_int8_conv import (
    amax_scale, bf16_conv_fn, bf16_gemm_fn, bf16_mm_fn, case_inputs,
    device_name, gemm_conv, generator, int8_conv, int8_mm_fn, out_size,
    quantize, time_arms,
)

B = 64  # S+Q=2 images per episode x 32 episodes
ITERS, ROUNDS = 20, 4

# (name, count, H, W, Cin, Cout, k, stride, dilation)
# ResNet-50 dilated (output stride 8, 3 stages) at 401^2:
# stem 401->201, maxpool 201->101, layer2 downsamples 101->51,
# layer3 dilation 2 keeps 51. Then purifier + ASPPV2 at 51^2.
CASES = [
    ("stem_7x7_s2",       1, 401, 401,    3,   64, 7, 2, 1),
    ("l1_in_1x1",         1, 101, 101,   64,   64, 1, 1, 1),
    ("l1_3x3",            3, 101, 101,   64,   64, 3, 1, 1),
    ("l1_out_1x1",        3, 101, 101,   64,  256, 1, 1, 1),
    ("l1_mid_1x1",        2, 101, 101,  256,   64, 1, 1, 1),
    ("l1_down_1x1",       1, 101, 101,   64,  256, 1, 1, 1),
    ("l2_in_1x1_s2",      1, 101, 101,  256,  128, 1, 2, 1),
    ("l2_3x3",            4,  51,  51,  128,  128, 3, 1, 1),
    ("l2_out_1x1",        4,  51,  51,  128,  512, 1, 1, 1),
    ("l2_mid_1x1",        3,  51,  51,  512,  128, 1, 1, 1),
    ("l2_down_1x1_s2",    1, 101, 101,  256,  512, 1, 2, 1),
    ("l3_in0_1x1",        1,  51,  51,  512,  256, 1, 1, 1),
    ("l3_in_1x1",         5,  51,  51, 1024,  256, 1, 1, 1),
    ("l3_3x3_d2",         6,  51,  51,  256,  256, 3, 1, 2),
    ("l3_out_1x1",        6,  51,  51,  256, 1024, 1, 1, 1),
    ("l3_down_1x1",       1,  51,  51,  512, 1024, 1, 1, 1),
    ("pur_1x1",           1,  51,  51, 1024,  256, 1, 1, 1),
    ("pur_3x3",           1,  51,  51,  256,  256, 3, 1, 1),
    ("aspp_1x1",          2,  51,  51,  256,  256, 1, 1, 1),
    ("aspp_3x3_d6",       1,  51,  51,  256,  256, 3, 1, 6),
    ("aspp_3x3_d12",      1,  51,  51,  256,  256, 3, 1, 12),
    ("aspp_3x3_d18",      1,  51,  51,  256,  256, 3, 1, 18),
    ("aspp_out_1x1",      1,  51,  51, 1280,  512, 1, 1, 1),
]
ARMS = ("bf16", "bf16_gemm", "int8", "bf16_mm", "int8_mm")


def quantized_weights(wgt: torch.Tensor, s: int, d: int):
    """The static per-output-channel quantization of HWIO ``wgt`` (the
    JAX tool's ``wscale`` and ``wq``) as ``GemmConv`` weights, and the
    scale."""
    wscale = amax_scale(wgt, dims=(0, 1, 2))
    return gemm_conv(quantize(wgt, wscale), s, d), wscale


def int8_fn(x: torch.Tensor, conv, wscale: torch.Tensor):
    """The int8 arm: the activation scale from ``max |x|``, the int8 conv
    and the dequantization, all inside the window."""
    def fn():
        xscale = amax_scale(x)
        acc = int8_conv(quantize(x, xscale), conv)
        return acc.float() * (xscale * wscale)
    return fn


def shape_row(name: str, cnt: int, h: int, ci: int, co: int, k: int,
              s: int, d: int, batch: int) -> Tuple[Dict, int]:
    oh = out_size(h, k, s, d)
    flops = 2 * batch * oh * oh * ci * co * k * k
    return {"case": name, "count": cnt, "gflops": flops / 1e9}, flops


def run(device: torch.device) -> Tuple[List[Dict], Dict]:
    """Every shape of ``CASES`` at batch ``B``: a JSON line each, then the
    blend's."""
    gen = generator(device)
    tot = {arm: 0.0 for arm in ARMS}
    total_flops = 0
    errors = []
    rows = []
    for name, cnt, h, w, ci, co, k, s, d in CASES:
        x, wgt = case_inputs(gen, B, h, w, ci, co, k, device)
        row, flops = shape_row(name, cnt, h, ci, co, k, s, d, B)
        conv, wscale = quantized_weights(wgt, s, d)
        row.update(formulation=conv.kind, k_pad=list(conv.k_pad),
                   n_pad=list(conv.n_pad))
        failed = time_arms(row, {
            "bf16": lambda: bf16_conv_fn(x, wgt, s, d),
            "bf16_gemm": lambda: bf16_gemm_fn(x, wgt, s, d),
            "int8": lambda: int8_fn(x, conv, wscale),
            "bf16_mm": lambda: bf16_mm_fn(x, wgt, s, d),
            "int8_mm": lambda: int8_mm_fn(quantize(x, amax_scale(x)),
                                          conv)},
            flops, device, ITERS, ROUNDS)
        for arm in ARMS:
            if arm in failed:
                errors.append(f"{name}:{arm}")
            else:
                tot[arm] += row[arm + "_ms"] * cnt
        total_flops += flops * cnt
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, wgt, conv, wscale
    summary = {f"blend_{arm}_ms": tot[arm] for arm in ARMS}
    summary["total_gflops"] = total_flops / 1e9
    if errors:
        summary["errors"] = errors
    else:
        summary["speedup"] = tot["bf16"] / tot["int8"]
        summary["speedup_vs_bf16_gemm"] = tot["bf16_gemm"] / tot["int8"]
    summary["device"] = device_name(device)
    print(json.dumps(summary), flush=True)
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
