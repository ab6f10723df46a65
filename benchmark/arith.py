"""The benchmark's arithmetic: the card's peaks, the kernels' least times,
the busy share of a timeline, rates, percentiles, the encoder's output
size.

Copied from the program's measurement tools so that a change to the
program cannot move the yardstick: ``PEAK_BF16`` from
``pemp_tpu_torch/tools/bench_train.py``; the rates and the kernels' work
(``bound_ms``, ``minplus_bound``, ``mpm_work``, ``mpm_backward_work``)
from ``chip_smoke.py``: each input byte read once, each output byte
written once, the operations the function needs.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# dense bf16 tensor-core peaks by ``torch.cuda.get_device_name`` (FLOP/s)
PEAK_BF16 = {
    "H100 80GB HBM3": 989.4e12,     # SXM5
    "H100 SXM": 989.4e12,
    "H100 PCIe": 756.5e12,
    "H100 NVL": 835.5e12,
}
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
# a min-plus term is an add and a min, no multiply to fuse: half the rate
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2


def peak_bf16(device_name: str) -> Optional[float]:
    return next((v for k, v in PEAK_BF16.items() if k in device_name), None)


def bound_ms(nbytes: float, ops: float, rate: float = FP32_FLOPS_PER_S
             ) -> float:
    """The least time: the larger of bytes at the HBM rate and ``ops`` at
    ``rate``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3


def minplus_bound(za: int, zb: int, m: int, k: int, n: int) -> float:
    """One min-plus launch out[z] = min_k a[z] + b[z] (za, zb: 1 for a
    shared operand): a, b read and out written once in float32; an add and
    a min a term."""
    z = max(za, zb)
    nbytes = 4 * (za * m * k + zb * k * n + z * m * n)
    return bound_ms(nbytes, 2 * z * m * n * k, FP32_INSTR_PER_S)


def mpm_work(b: int, s: int, q: int, n: int, c: int, p: int, esize: int
             ) -> Dict[str, Tuple[float, float]]:
    """(bytes, flops) of K1 (assign) and K2 (match) for features of
    ``esize`` bytes: each input read once, each output written once;
    flops of |f|^2, the 2p-column products, a^T f and the finish."""
    k2 = 2 * p
    masks, ctr = 2 * b * s * n * 4, c * k2 * 4
    protos, logits = b * k2 * c * 4, b * q * n * 2 * 4
    f1 = b * s * n * (2 * c + 4 * c * k2) + 2 * b * s * k2 * c
    f2 = b * q * n * (2 * c + 2 * c * k2)
    return {"assign": (b * s * n * c * esize + masks + ctr + protos, f1),
            "match": (b * q * n * c * esize + protos + logits, f2)}


def mpm_backward_work(b: int, s: int, q: int, n: int, c: int, p: int,
                      esize: int) -> Tuple[float, float]:
    """(bytes, flops) of the mpm backward (K4) for the features and the
    centres: reads the features, masks, centres, prototypes, indices and
    the logits' cotangent once, writes both cotangents once."""
    nbytes = (2 * b * (s + q) * n * c * esize + 2 * b * s * n * 4
              + 2 * c * 2 * p * 4 + b * 2 * p * c * 4 + 2 * b * q * n * 2 * 4)
    flops = (b * s * (6 * 2 * n * c * 2 * p + 6 * n * c)
             + b * q * (2 * 3 * 2 * n * c * p + 6 * n * c))
    return nbytes, flops


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The parts of [start, end) that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def percentile(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * pct / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return work / seconds


def feature_hw(cfg: Dict) -> Tuple[int, int]:
    """The encoder's output size: the stride-2 7x7 stem, the ceil-mode
    3x3 pool, layer2's stride 2."""
    def stem(x):
        x = (x + 6 - 7) // 2 + 1
        x = -(-(x + 2 - 3) // 2) + 1
        return (x - 1) // 2 + 1
    return stem(cfg["data"]["height"]), stem(cfg["data"]["width"])
