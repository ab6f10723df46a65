"""Benchmark: PEMP stage-1 ResNet-50 1-shot eval throughput on one card.

Counterpart of ``bench.py:251-333`` (its measurement; the JAX script's
supervisor and fake-crash hooks are not carried over: on the card a hung
or crashed launch is a fault to surface, not to retry). The protocol is
the reference eval hot loop (BASELINE.md): 401x401 episodes, the forward
to input-resolution logits, the argmax and the TP/FP/FN counts, summed
on the device. Episodes are batched (``--batch``, default 256, the JAX
default), the inputs are ``np.random.RandomState(0)``'s draws in the JAX
script's order and the weights come from seed 0: the timed function is
``tools/profile_eval.py``'s ``make_inputs``, ``build_model`` and
``eval_batch``, one copy for the benchmark and its profiler. On the card
it runs bf16 with the hand-written kernels (``device.tool_precision``).

Timing: two warm-up launches, then rounds of ``LAUNCHES`` launches whose
counts add up on the device; one value fetch (``.tolist()``) closes each
round's window; the best round within the budget
(``utils/benchtime.py::best_of_rounds``).

``vs_baseline`` divides by the reference's derived V100 estimate, 25.0
episodes/s (``bench.py:1-19``, BASELINE.md): an estimate of the
reference on a V100, not a measurement of any device here.

It prints exactly ONE line on stdout, ``{"metric", "value", "unit",
"vs_baseline"}``; the round rates and K1/K2's launches go to stderr. Run
as a script, it arms a no-progress watchdog before ``import torch``
(``PEMP_BENCH_WATCHDOG_S``, default 2700 s): on no progress it prints
the line with a zero value and exits 3. ``PEMP_BENCH_BUDGET_S`` (default
``BUDGET_S``, 360) bounds the rounds on the card, ``OFF_CARD_BUDGET_S``
(30) off it.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.bench [--batch 256]
  python -m pemp_tpu_torch.tools.bench --device cpu   # 65x65, batch 2, f32
"""

import argparse
import json
import sys
import time

from pemp_tpu_torch.utils.benchtime import (
    arm_watchdog, best_of_rounds, budget_s,
)

V100_EST_EPS = 25.0     # derived reference V100 eval eps/s (BASELINE.md)
METRIC = "PEMP-s1 r50 1-shot eval episodes/sec/card"
UNIT = "episodes/s"
HW = 401
BATCH = 256
CPU_HW, CPU_BATCH, CPU_LAUNCHES = 65, 2, 2     # the JAX script's off-chip
WARMUP = 2
LAUNCHES = 3
ROUNDS = 200
BUDGET_S = 360
OFF_CARD_BUDGET_S = 30
SLOW_LAUNCH_S = 5.0
EXTEND_S = 420


def contract_line(metric: str, eps: float) -> dict:
    return {"metric": metric, "value": eps, "unit": UNIT,
            "vs_baseline": eps / V100_EST_EPS}


if __name__ == "__main__":
    _progress, _disarm = arm_watchdog(
        "bench", line=json.dumps(contract_line(
            f"{METRIC} (WATCHDOG: no completed launch within "
            "PEMP_BENCH_WATCHDOG_S)", 0.0)))
else:
    def _progress():
        pass

    _disarm = _progress

import torch  # noqa: E402  (after the watchdog: the first touch may hang)

from pemp_tpu_torch.device import resolve_device  # noqa: E402
from pemp_tpu_torch.tools import profile_eval  # noqa: E402
from pemp_tpu_torch.tools.profile_train import counts  # noqa: E402


def measure(batch: int, hw: int, device: torch.device, launches: int
            ) -> dict:
    """The best round's episodes/s of ``profile_eval.eval_batch`` at
    ``batch`` x ``hw``², with the round rates, the counts of one launch
    (the first warm-up's), the number of ``eval_batch`` calls and K1/K2's
    wrapper launches over all of them."""
    model = profile_eval.build_model(device)
    sup, msk, qry, ref = (torch.from_numpy(a).to(device) for a in
                          profile_eval.make_inputs(batch, 1, hw))
    before = counts()
    calls = [0]

    def launch():
        calls[0] += 1
        return profile_eval.eval_batch(model, sup, msk, qry, ref)

    one = None
    for _ in range(WARMUP):
        c = launch().tolist()
        one = c if one is None else one
        _progress()
    rates = []

    def timed_round():
        tic = time.perf_counter()
        total = launch()
        for _ in range(launches - 1):
            total = total + launch()
        total = total.tolist()      # one value fetch closes the window
        elapsed = time.perf_counter() - tic
        if len(total) != 2 or len(total[0]) != 3:
            raise RuntimeError(f"counts of shape {len(total)}x? {total}")
        _progress()
        rates.append(launches * batch / elapsed)
        return rates[-1], elapsed / launches

    eps = best_of_rounds(timed_round, device.type == "cuda",
                         budget_s=budget_s(BUDGET_S), extend_s=EXTEND_S,
                         slow_launch_s=SLOW_LAUNCH_S,
                         off_card_budget_s=OFF_CARD_BUDGET_S,
                         max_rounds=ROUNDS)
    after = counts()
    return {"eps": eps, "round_rates": rates, "counts": one,
            "calls": calls[0],
            "launches": {k: after[k] - before[k] for k in ("assign",
                                                           "match")}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    hw, batch, launches = ((HW, args.batch, LAUNCHES) if on_card
                           else (CPU_HW, CPU_BATCH, CPU_LAUNCHES))
    got = measure(batch, hw, device, launches)
    _disarm()
    print(f"bench: round rates {got['round_rates']} episodes/s; counts of "
          f"one launch {got['counts']}; {got['calls']} eval_batch calls; "
          f"K1/K2 launches {got['launches']}", file=sys.stderr, flush=True)
    line = contract_line(f"{METRIC} ({hw}x{hw}, B={batch}, {device.type})",
                         got["eps"])
    print(json.dumps(line), flush=True)
    return {**line, **{k: got[k] for k in ("round_rates", "counts", "calls",
                                           "launches")}}


if __name__ == "__main__":
    main()
