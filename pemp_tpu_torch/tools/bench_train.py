"""Train-step benchmark and MFU estimate: PEMP stage 1 on one card.

Counterpart of ``bench_train.py:175-262``: the stage-1 ResNet-50 1-shot
TRAINING step (forward, cedt loss, backward, clip, SGD update, BN
statistics) at ``--bs 4 --hw 401``, bf16 on the card, on one batch
already on the device (``profile_train.flagship_setup``, one copy of the
setup for the benchmark and its profiler), weights and dropout from
seed 0. The arms:

- ``plain``: ``dev.use_kernels=False``, the kernels' plain PyTorch
  versions on the card (the JAX tool's ``jnp`` arm);
- ``kernels``: the hand-written kernels K1-K5 (its ``pallas-vjp`` arm);
- with ``--fuse k``, ``kernels+fuse<k>``: ``dev.fuse_steps=k``, one
  CUDA-graph replay of k steps a launch on the same batch (its
  ``lax.scan`` arm).

Timing: ``profile_train.WARMUP`` warm-up launches (a fused arm captures
its graph there), then up to ``ROUNDS`` rounds of ``LAUNCHES`` launches
within ``BUDGET_S`` (``PEMP_BENCH_BUDGET_S`` when set), each closed by a
value fetch (``float(loss)``); the best round counts.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one eager step
(the arm's first step), times k for a fused launch. The counter sees the
convolutions and matrix products that PyTorch dispatches; it does not see
the elementwise passes, the kernels K1-K5 (launched through ctypes or as
``pemp::`` operators, which have no FLOP formula) or a graph's replay.
The JAX tool's XLA cost analysis counted every op, so the port's count
is lower; the row's ``flops_counted`` says what was counted. MFU = that
count over (the best launch time x the card's dense bf16 peak,
``PEAK_BF16`` by ``torch.cuda.get_device_name``); ``null`` for a card
not in the table, and the row says why.

On the CPU (``--device cpu``: 33x33, batch 2, f32) both arms run the
plain versions and each row says ``"kernels": false``.

It prints one JSON line an arm (the JAX tool's keys), then
``kernels_speedup`` and, with ``--fuse``, ``fused_speedup``. Run as a
script it arms a no-progress watchdog before ``import torch``
(``PEMP_BENCH_WATCHDOG_S``).

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.bench_train [--hw 401] [--bs 4] \\
      [--loss cedt] [--fuse 8]
  python -m pemp_tpu_torch.tools.bench_train --device cpu --fuse 2
"""

import argparse
import json
import time

from pemp_tpu_torch.utils.benchtime import arm_watchdog, budget_s

if __name__ == "__main__":
    _progress, _disarm = arm_watchdog("bench_train")
else:
    def _progress():
        pass

    _disarm = _progress

import torch  # noqa: E402  (after the watchdog: the first touch may hang)

from pemp_tpu_torch.device import resolve_device, tool_precision  # noqa: E402
from pemp_tpu_torch.ops import kernels  # noqa: E402
from pemp_tpu_torch.tools import profile_train  # noqa: E402

# dense bf16 tensor-core peak a card, FLOP/s, by a substring of
# torch.cuda.get_device_name (NVIDIA H100 Tensor Core GPU datasheet: half
# the sparse figure)
PEAK_BF16 = {
    "H100 80GB HBM3": 989.4e12,     # SXM5
    "H100 SXM": 989.4e12,
    "H100 PCIe": 756.5e12,
    "H100 NVL": 835.5e12,
}
FLOPS_COUNTED = (
    "torch.utils.flop_counter over one eager step (forward, backward, "
    "update): the convolutions and matrix products PyTorch dispatches; "
    "not the elementwise passes, not K1-K5, not a graph replay (a fused "
    "launch counts k eager steps)")
LAUNCHES = 10
ROUNDS = 12
BUDGET_S = 240
OFF_CARD_BUDGET_S = 20
CPU_HW, CPU_BS = 33, 2


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def peak_bf16(name: str):
    """The card's dense bf16 peak (FLOP/s), or None for a name not in
    ``PEAK_BF16``."""
    return next((v for k, v in PEAK_BF16.items() if k in name), None)


def mfu(flops_per_launch: float, launch_s: float, name: str):
    """(MFU or None, why None)."""
    peak = peak_bf16(name)
    if peak is None:
        return None, f"no dense bf16 peak for {name!r} in PEAK_BF16"
    if not launch_s or not flops_per_launch:
        return None, "no launch was timed or no FLOP was counted"
    return flops_per_launch / (launch_s * peak), None


def flop_count(fn):
    """``fn()`` under ``FlopCounterMode``: (its result, the FLOPs counted,
    {op: FLOPs})."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    by_op = {str(k): int(v)
             for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return out, int(counter.get_total_flops()), by_op


def device_launches(trainer, before_calls, before_replayed):
    """K1-K5's launches on the device since ``before_*``: the wrappers'
    counts plus what the fused step's replays launched."""
    fused = trainer.train_step_fused
    replayed = dict(fused.replayed) if fused is not None else {}
    now = profile_train.counts()
    return {k: now[k] - before_calls[k] + replayed.get(k, 0)
            - before_replayed.get(k, 0) for k in now}


def last_loss(loss: torch.Tensor) -> float:
    """The last step's loss of a launch (a fused launch gives k)."""
    return float(loss.reshape(-1)[-1])


def bench_one(use_kernels: bool, args, device: torch.device, fuse: int = 1):
    """One arm: the row of the JAX tool's keys, with K1-K5's device
    launches over the timed launches (``launches``, ``steps_timed``)."""
    on_card = device.type == "cuda"
    hw, bs = (args.hw, args.bs) if on_card else (CPU_HW, CPU_BS)
    precision = tool_precision(device)
    setup = profile_train.flagship_setup(hw, bs, args.loss, device, precision,
                                         fuse, use_kernels=use_kernels)
    trainer = setup.trainer
    fuse = setup.fuse
    per_launch = bs * fuse                      # episodes a launch
    with kernels.use_kernels(trainer.cfg.dev.use_kernels):
        loss, flops, by_op = flop_count(
            lambda: trainer.train_step(setup.batch))
        loss_first = float(loss)
        flops *= fuse
        call = setup.step()
        for _ in range(profile_train.WARMUP):
            loss = call()
        last_loss(loss)
        _progress()
        fused = trainer.train_step_fused
        before_calls = profile_train.counts()
        before_replayed = dict(fused.replayed) if fused is not None else {}
        best, rates, rounds = 0.0, [], 0
        deadline = time.time() + (budget_s(BUDGET_S) if on_card
                                  else OFF_CARD_BUDGET_S)
        for _ in range(ROUNDS):
            tic = time.perf_counter()
            for _ in range(LAUNCHES):
                loss = call()
            loss_final = last_loss(loss)    # value fetch closes the window
            dt = time.perf_counter() - tic
            _progress()
            rounds += 1
            rates.append(LAUNCHES * per_launch / dt)
            best = max(best, rates[-1])
            if time.time() > deadline:
                break
        launched = device_launches(trainer, before_calls, before_replayed)
    name = device_name(device)
    m, why = mfu(flops, per_launch / best if best else 0.0, name)
    row = {
        "path": ("kernels" if use_kernels else "plain")
                + (f"+fuse{fuse}" if fuse > 1 else ""),
        "episodes_per_s": best,
        "it_per_s": best / bs,             # optimizer steps/s
        "step_flops": flops,
        "flops_counted": FLOPS_COUNTED,
        "flops_by_op_one_step": by_op,
        "device": name,
        "mfu": m,
        "round_rates": rates,
        "loss_first": loss_first,
        "loss_final": loss_final,
        "kernels": on_card and use_kernels,
        "precision": precision, "hw": hw, "bs": bs, "fuse_steps": fuse,
        "steps_timed": rounds * LAUNCHES * fuse,
        "launches": launched,
    }
    if why is not None:
        row["mfu_note"] = why
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=401)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--loss", default="cedt")
    ap.add_argument("--fuse", type=int, default=0,
                    help="also bench k fused steps a launch "
                         "(dev.fuse_steps)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    arms = [(False, 1), (True, 1)] + ([(True, args.fuse)]
                                      if args.fuse > 1 else [])
    results = []
    for use, fuse in arms:
        results.append(bench_one(use, args, device, fuse))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    _disarm()
    lines = list(results)
    if results[0]["episodes_per_s"]:
        lines.append({"kernels_speedup": results[1]["episodes_per_s"]
                      / results[0]["episodes_per_s"]})
    if args.fuse > 1 and results[1]["episodes_per_s"]:
        lines.append({"fused_speedup": results[2]["episodes_per_s"]
                      / results[1]["episodes_per_s"]})
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
