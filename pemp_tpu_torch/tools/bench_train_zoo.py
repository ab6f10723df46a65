"""Per-family train-step throughput and MFU on one card.

Counterpart of ``tools/bench_train_zoo.py``: each row (``ROWS``, the JAX
tool's rows, ``profile_train.FAMILY_ROWS``) builds the family's entry
runtime at its script preset (resolution, batch, loss; the ``TUNED_ROWS``
at a larger batch) through ``profile_train.family_setup``, which seeds a
stage-1 snapshot for the stage-2 rows, and times the production train
step: forward, loss with its auxiliary terms, backward, clip, the
update, BN statistics, bf16 on the card with the hand-written kernels,
on the first SYNTH train batch already on the device. CaNet's per-step
history write-back (``post_step``) is part of its serial step, as in the
port's trainer. ``--fuse k`` times ``dev.fuse_steps=k`` launches (one
CUDA-graph replay of k steps on the same batch); a runtime with a
chunk flush (``post_chunk``, CaNet's history) pays it a launch, deferred
by one launch as ``core/trainer.py``'s epoch loop defers it.

Timing as the JAX tool: rounds of ``LAUNCHES`` launches, each round
closed by a value fetch, the best round within ``BUDGET_S``
(``PEMP_BENCH_BUDGET_S`` when set; ``utils/benchtime.py``), after
``profile_train.WARMUP`` warm-up launches. MFU as ``bench_train``: the
FLOPs ``FlopCounterMode`` counts over one eager step (the row's first),
over (the best step time x the card's dense bf16 peak).

Off the card (``--device cpu``) the rows run at 33² (PFENet 41²), batch
2 (1 where the preset is 1), f32, with the plain versions.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.bench_train_zoo [row ...] [--fuse k]
  python -m pemp_tpu_torch.tools.bench_train_zoo canet --device cpu

It prints one JSON line a row. Run as a script it arms a no-progress
watchdog before ``import torch`` (``PEMP_BENCH_WATCHDOG_S``).
"""

import argparse
import json
import tempfile
import time
from pathlib import Path

from pemp_tpu_torch.utils.benchtime import (
    arm_watchdog, best_of_rounds, budget_s,
)

if __name__ == "__main__":
    _progress, _disarm = arm_watchdog("bench_train_zoo")
else:
    def _progress():
        pass

    _disarm = _progress

import torch  # noqa: E402  (after the watchdog: the first touch may hang)

from pemp_tpu_torch.device import resolve_device, tool_precision  # noqa: E402
from pemp_tpu_torch.ops import kernels  # noqa: E402
from pemp_tpu_torch.tools import bench_train, profile_train  # noqa: E402

LAUNCHES = 10
BUDGET_S = 150
EXTEND_S = 240
OFF_CARD_BUDGET_S = 10
ROWS = profile_train.FAMILY_ROWS
# rows off the scripts' presets, at a larger batch
TUNED_ROWS = {"panet8", "rpmms8", "canet8"}


def launcher(setup):
    """One launch of ``setup``'s step: a train step, or with ``fuse > 1``
    one fused chunk of ``fuse`` steps on the same batch; returns (the
    losses, a ``post_chunk`` flush to run or None)."""
    tr = setup.trainer
    if setup.fuse <= 1:
        return lambda: (tr.train_step(setup.batch), None)
    batches = [setup.batch] * setup.fuse
    lrs = [tr.lr_policy.lr] * setup.fuse

    def launch():
        losses, auxes = tr.train_step_fused(batches, lrs)
        flush = None
        if tr.post_chunk is not None:
            def flush():
                tr.post_chunk(auxes, batches)
        return losses, flush
    return launch


def run_launches(launch, n):
    """``n`` launches, each one's flush run after the next is launched
    (the trainer's order), the last flushed at the end; returns the last
    launch's losses."""
    pending = None
    for _ in range(n):
        losses, flush = launch()
        if pending is not None:
            pending()
        pending = flush
    if pending is not None:
        pending()
    return losses


def bench_row(name, device, model_dir, fuse=0):
    """One row: the JAX tool's keys (``metric``, ``value``, ``unit``,
    ``step_gflops``, ``mfu``), with K1-K5's device launches over the
    ``steps_timed`` timed steps."""
    on_card = device.type == "cuda"
    setup = profile_train.family_setup(name, device, tool_precision(device),
                                       max(fuse, 1), model_dir)
    trainer = setup.trainer
    bs, hw, fuse = setup.bs, setup.hw, setup.fuse
    with kernels.use_kernels(trainer.cfg.dev.use_kernels):
        loss, flops, _ = bench_train.flop_count(
            lambda: trainer.train_step(setup.batch))
        loss_first = float(loss)
        launch = launcher(setup)
        bench_train.last_loss(run_launches(launch, profile_train.WARMUP))
        _progress()
        fused = trainer.train_step_fused
        before_calls = profile_train.counts()
        before_replayed = dict(fused.replayed) if fused is not None else {}
        rounds = [0]

        def timed_round():
            tic = time.perf_counter()
            losses = run_launches(launch, LAUNCHES)
            bench_train.last_loss(losses)   # value fetch closes the window
            dt = time.perf_counter() - tic
            rounds[0] += 1
            return LAUNCHES * fuse * bs / dt, dt / LAUNCHES

        eps = best_of_rounds(timed_round, on_card,
                             budget_s=budget_s(BUDGET_S), progress=_progress,
                             extend_s=EXTEND_S,
                             off_card_budget_s=OFF_CARD_BUDGET_S)
        launched = bench_train.device_launches(trainer, before_calls,
                                               before_replayed)
    name_dev = bench_train.device_name(device)
    m, why = bench_train.mfu(flops, bs / eps if eps else 0.0, name_dev)
    label = "tuned" if name in TUNED_ROWS else "preset"
    if fuse > 1:
        label += f", fuse={fuse}"
    row = {
        "metric": f"{name} train step eps/s/card ({hw}x{hw}, bs={bs}, "
                  f"{label})",
        "value": eps, "unit": "episodes/s",
        "step_gflops": flops / 1e9,
        "mfu": m,
        "flops_counted": bench_train.FLOPS_COUNTED,
        "device": name_dev, "kernels": on_card,
        "precision": tool_precision(device), "fuse_steps": fuse,
        "loss_first": loss_first,
        "steps_timed": rounds[0] * LAUNCHES * fuse,
        "launches": launched,
    }
    if why is not None:
        row["mfu_note"] = why
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows", nargs="*", help=f"default: {' '.join(ROWS)}")
    ap.add_argument("--fuse", type=int, default=0,
                    help="k steps a launch (dev.fuse_steps)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    rows = args.rows or list(ROWS)
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        ap.error(f"unknown row(s) {unknown}; valid: {sorted(ROWS)}")
    device = resolve_device(args.device)
    lines = []
    with tempfile.TemporaryDirectory() as model_dir:
        for r in rows:
            line = {**bench_row(r, device, Path(model_dir), args.fuse),
                    "row": r}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    _disarm()
    return lines


if __name__ == "__main__":
    main()
