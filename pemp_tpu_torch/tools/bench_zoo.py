"""Model-zoo and deployed-cascade eval throughput, and serving latency,
on one card.

Counterpart of ``tools/bench_zoo.py``, with its rows (``ROWS``), sizes
and batches, bf16 on the card with the hand-written kernels
(``device.tool_precision``), weights from seeds (stage 1 and the families
0, stage 2 1), inputs from ``np.random.RandomState(0)``:

- ``cascade1`` / ``cascade5``: the deployed PEMP path, stage 1 -> its
  argmax prior -> stage 2 (``spq = shot + 1``) -> the TP/FP/FN counts,
  at 401², B = 32 (one shot) and 12 (five); the cascade is
  ``models/pemp_stage2.py::PEMPCascade``, the module that
  ``export_serving.build_cascade_serving_fn`` exports, and the counts are
  ``profile_eval.eval_batch``'s;
- ``s1shot5``: stage 1 with five shots, B = 64, the same counts;
- ``canet321`` / ``rpmms481`` / ``pfenet473``: the argmax sum of the
  family's eval forward (``export_serving.ServingForward`` at feature
  resolution: CaNet's zero history, RPMMs' seeded EM start) at the
  presets' sizes, batches 32 / 16 / 8;
- ``latency1``: B = 1, stage 1 with its counts and the cascade: the best
  wall ms a launch (rounds of 30 launches, one fetch a round) and
  ``device_ms``, the card's busy time a launch in a ``torch.profiler``
  trace read by ``utils/profiling.py``;
- ``latency_artifact``: the cascade through ``export_serving`` ->
  ``save_serving`` -> ``load_serving`` (a batch-polymorphic artifact,
  exported once, outside every timed window) at B = 1 / 4 / 16: the p50
  and p99 wall ms over 200 (B = 1) / 100 samples, the best of 3 rounds by
  median, each launch fenced by fetching one element, and ``device_ms``
  from a trace of 10 launches.

Timing as the JAX tool: device-resident inputs, rounds of ``LAUNCHES``
launches summed on the device, one value fetch a round, the best round
within ``BUDGET_S`` (``PEMP_BENCH_BUDGET_S`` when set;
``utils/benchtime.py::best_of_rounds``). Each row also gives K1/K2's
launches (the wrappers' counts) over its ``calls``.

Off the card (``--device cpu``) every row runs at 33² and B = 2
(``latency_artifact`` at B = 1 and 2), f32, with the plain versions.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.bench_zoo [row ...]   # default: all
  python -m pemp_tpu_torch.tools.bench_zoo cascade1 --device cpu

It prints one JSON line a row (one a batch for the latency rows). Run as
a script it arms a no-progress watchdog before ``import torch``
(``PEMP_BENCH_WATCHDOG_S``).
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
    _progress, _disarm = arm_watchdog("bench_zoo")
else:
    def _progress():
        pass

    _disarm = _progress

import numpy as np  # noqa: E402
import torch  # noqa: E402  (after the watchdog: the first touch may hang)

from pemp_tpu_torch.device import resolve_device, tool_precision  # noqa: E402
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade  # noqa: E402
from pemp_tpu_torch.tools import export_serving, profile_eval  # noqa: E402
from pemp_tpu_torch.tools.profile_train import (  # noqa: E402
    counts, profile_calls, sync,
)
from pemp_tpu_torch.utils import profiling  # noqa: E402

LAUNCHES = 3
BUDGET_S = 120
EXTEND_S = 240
OFF_CARD_BUDGET_S = 10
LATENCY_LAUNCHES = 30
LATENCY_BUDGET_S = 60
LATENCY_OFF_CARD_BUDGET_S = 5
ARTIFACT_BATCHES = (1, 4, 16)
ARTIFACT_SAMPLES = {1: 200}        # samples a round by batch; else 100
ARTIFACT_ROUNDS = 3
ARTIFACT_TRACED = 10
CPU_HW, CPU_BATCH = 33, 2


def episode_arrays(rng, b, s, q, hw):
    """(sup [B,S,H,W,3], msk [B,S,H,W,2], qry [B,Q,H,W,3]) float32 numpy
    arrays, drawn as the JAX tool draws them."""
    sup = rng.randn(b, s, hw, hw, 3).astype(np.float32)
    fg = (rng.rand(b, s, hw, hw, 1) > 0.5).astype(np.float32)
    msk = np.concatenate([fg, 1 - fg], -1)
    qry = rng.randn(b, q, hw, hw, 3).astype(np.float32)
    return sup, msk, qry


def to_device(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def counted(fn):
    """``fn`` that counts its calls in ``fn.calls``."""
    def call():
        call.calls += 1
        return fn()
    call.calls = 0
    return call


def launched_since(before):
    now = counts()
    return {k: now[k] - before[k] for k in ("assign", "match")}


def bench_fn(fn, batch, device):
    """Best-of-rounds episodes/s of ``fn() -> device tensor``, after two
    warm-up calls: (episodes/s, rounds, the first call's value)."""
    first = fn().tolist()
    fn().tolist()
    rounds = [0]

    def timed_round():
        tic = time.perf_counter()
        acc = fn()
        for _ in range(LAUNCHES - 1):
            acc = acc + fn()
        acc.tolist()                        # value fetch closes the window
        dt = time.perf_counter() - tic
        rounds[0] += 1
        return LAUNCHES * batch / dt, dt / LAUNCHES

    eps = best_of_rounds(timed_round, device.type == "cuda",
                         budget_s=budget_s(BUDGET_S), progress=_progress,
                         extend_s=EXTEND_S,
                         off_card_budget_s=OFF_CARD_BUDGET_S)
    return eps, rounds[0], first


def sizes(device, hw_card, batch_card):
    return ((hw_card, batch_card) if device.type == "cuda"
            else (CPU_HW, CPU_BATCH))


def cascade(shot, device):
    """The deployed cascade: stage 1 (seed 0), stage 2 (seed 1)."""
    return PEMPCascade(
        profile_eval.build_model(device, "pemp_stage1", shot, 0),
        profile_eval.build_model(device, "pemp_stage2", shot, 1)).eval()


def counts_row(model, shot, hw, b, device, metric):
    """The eps/s row of ``profile_eval.eval_batch(model, ...)`` on
    ``b`` episodes of ``shot`` supports and one query, with the counts of
    one launch."""
    rng = np.random.RandomState(0)
    sup, msk, qry = to_device(episode_arrays(rng, b, shot, 1, hw), device)
    ref = torch.from_numpy(
        rng.randint(0, 2, (b, hw, hw)).astype(np.int32)).to(device)
    fn = counted(lambda: profile_eval.eval_batch(model, sup, msk, qry, ref))
    before = counts()
    eps, rounds, one = bench_fn(fn, b, device)
    return {"metric": metric, "value": eps, "unit": "episodes/s",
            "rounds": rounds, "counts": one, "calls": fn.calls,
            "launches": launched_since(before)}


def row_cascade(shot, device):
    hw, b = sizes(device, 401, 32 if shot == 1 else 12)
    return counts_row(cascade(shot, device), shot, hw, b, device,
                      f"pemp cascade s1+s2 {shot}-shot eval eps/s/card "
                      f"({hw}x{hw}, B={b})")


def row_s1_5shot(device):
    """Stage 1 at five shots (the packed kernels at S = 5), the counts
    protocol of ``bench``."""
    hw, b = sizes(device, 401, 64)
    model = profile_eval.build_model(device, "pemp_stage1", 5, 0)
    return counts_row(model, 5, hw, b, device,
                      f"pemp_stage1 5-shot eval eps/s/card ({hw}x{hw}, "
                      f"B={b})")


def row_model(name, hw_card, batch_card, device):
    """The argmax sum of family ``name``'s eval forward at feature
    resolution."""
    hw, b = sizes(device, hw_card, batch_card)
    rng = np.random.RandomState(0)
    sup, msk, qry = to_device(episode_arrays(rng, b, 1, 1, hw), device)
    extra = None
    if name == "canet":
        h8 = -(-hw // 8)
        extra = torch.zeros(b, 1, h8, h8, 2, device=device)
    serve = export_serving.ServingForward(
        name, profile_eval.build_model(device, name, 1, 0), None).eval()

    @torch.no_grad()
    def step():
        out = serve(sup, msk, qry, extra)
        return out.argmax(-1).to(torch.int32).sum((1, 2, 3))

    fn = counted(step)
    before = counts()
    eps, rounds, _ = bench_fn(fn, b, device)
    return {"metric": f"{name} 1-shot eval eps/s/card ({hw}x{hw}, B={b}, "
                      "preset res)",
            "value": eps, "unit": "episodes/s", "rounds": rounds,
            "calls": fn.calls, "launches": launched_since(before)}


def device_ms(fn, calls, device):
    """The card's busy ms a call over ``calls`` calls of ``fn`` under
    ``torch.profiler`` (``utils/profiling.py``); None off the card."""
    prof, wall, _ = profile_calls(fn, calls, device, warmup=0)
    return profiling.summarize(prof, calls, wall)["device_ms_per_step"]


def row_latency(device):
    """B = 1 serving latency of stage 1 (with its counts) and of the
    cascade: the best wall ms a launch and the device ms a launch."""
    hw = 401 if device.type == "cuda" else CPU_HW
    rng = np.random.RandomState(0)
    sup, msk, qry = to_device(episode_arrays(rng, 1, 1, 1, hw), device)
    ref = torch.from_numpy(
        rng.randint(0, 2, (1, hw, hw)).astype(np.int32)).to(device)
    casc = cascade(1, device)
    rows = []
    for name, model in (("pemp_stage1", casc.stage1),
                        ("cascade s1+s2", casc)):
        fn = counted(lambda m=model: profile_eval.eval_batch(
            m, sup, msk, qry, ref))
        before = counts()
        for _ in range(3):
            fn().tolist()                          # warm-up
        n = LATENCY_LAUNCHES

        def timed_round():
            tic = time.perf_counter()
            for _ in range(n):
                out = fn()
            out.tolist()                           # value fetch
            per_launch = (time.perf_counter() - tic) / n
            return 1.0 / per_launch, per_launch    # launches/s for "best"

        best_rate = best_of_rounds(
            timed_round, device.type == "cuda",
            budget_s=budget_s(LATENCY_BUDGET_S), progress=_progress,
            extend_s=EXTEND_S, off_card_budget_s=LATENCY_OFF_CARD_BUDGET_S)
        dev_ms = device_ms(fn, n, device)
        _progress()
        rows.append({
            "metric": f"{name} 1-shot B=1 serving latency ({hw}x{hw})",
            "value": 1e3 / best_rate, "unit": "ms wall/episode",
            "device_ms": dev_ms, "calls": fn.calls,
            "launches": launched_since(before)})
    return rows


def export_cascade(device, hw, tmp: Path):
    """The cascade exported with a symbolic batch, saved and loaded back
    as a serving process loads it: (the loaded module, export s, load s,
    artifact bytes)."""
    t0 = time.perf_counter()
    casc = cascade(1, device)
    serve, inputs, dyn = export_serving.build_cascade_serving_fn(
        casc.stage1, casc.stage2, "poly", 1, 1, hw, device)
    exported = export_serving.export_serving(serve, inputs, dyn)
    path = tmp / "cascade.pt2"
    size = export_serving.save_serving(
        exported, path, export_serving.artifact_manifest(
            "cascade", "resnet50", "b", 1, 1, hw, tool_precision(device),
            device))
    export_s = time.perf_counter() - t0
    del casc, serve, exported
    t0 = time.perf_counter()
    call = export_serving.load_serving(path).module()
    return call, export_s, time.perf_counter() - t0, size


def row_latency_artifact(device):
    """Serving latency of the loaded cascade artifact: p50 / p99 wall ms
    a launch at each of ``ARTIFACT_BATCHES``, each launch fenced by a
    one-element fetch, the best of ``ARTIFACT_ROUNDS`` rounds by median,
    and the device ms a launch from a trace."""
    on_card = device.type == "cuda"
    hw = 401 if on_card else CPU_HW
    batches = ARTIFACT_BATCHES if on_card else (1, CPU_BATCH)
    rng = np.random.RandomState(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        call, export_s, load_s, size = export_cascade(device, hw, Path(tmp))
        _progress()
        for b in batches:
            sup, msk, qry = to_device(episode_arrays(rng, b, 1, 1, hw),
                                      device)
            before = counts()
            calls = 0
            with torch.no_grad():
                for _ in range(3):
                    call(sup, msk, qry)[0, 0, 0, 0, 0].item()   # warm-up
                    calls += 1
                best = None
                n = ARTIFACT_SAMPLES.get(b, 100)
                for _ in range(ARTIFACT_ROUNDS):
                    samples = []
                    for _ in range(n):
                        tic = time.perf_counter()
                        out = call(sup, msk, qry)
                        out[0, 0, 0, 0, 0].item()      # completion fence
                        samples.append((time.perf_counter() - tic) * 1e3)
                    calls += n
                    _progress()
                    s = np.asarray(samples)
                    if best is None or np.median(s) < np.median(best):
                        best = s
                dev_ms = device_ms(lambda: call(sup, msk, qry),
                                   ARTIFACT_TRACED, device)
                calls += ARTIFACT_TRACED
            _progress()
            p50 = float(np.median(best))
            rows.append({
                "metric": f"restored cascade artifact B={b} serving "
                          f"latency ({hw}x{hw})",
                "value": p50, "unit": "ms wall p50/launch",
                "p99_ms": float(np.percentile(best, 99)),
                "per_episode_p50_ms": p50 / b, "samples": len(best),
                "device_ms": dev_ms, "export_s": export_s,
                "load_s": load_s, "artifact_bytes": size, "calls": calls,
                "launches": launched_since(before)})
        del call
    sync(device)
    return rows


ROWS = {
    "cascade1": lambda dev: row_cascade(1, dev),
    "cascade5": lambda dev: row_cascade(5, dev),
    "s1shot5": row_s1_5shot,
    "canet321": lambda dev: row_model("canet", 321, 32, dev),
    "rpmms481": lambda dev: row_model("rpmms", 481, 16, dev),
    "pfenet473": lambda dev: row_model("pfenet", 473, 8, dev),
    "latency1": row_latency,
    "latency_artifact": row_latency_artifact,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows", nargs="*", help=f"default: {' '.join(ROWS)}")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    rows = args.rows or list(ROWS)
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        ap.error(f"unknown row(s) {unknown}; valid: {sorted(ROWS)}")
    device = resolve_device(args.device)
    lines = []
    for r in rows:
        out = ROWS[r](device)
        for line in (out if isinstance(out, list) else [out]):
            line["row"] = r
            print(json.dumps(line), flush=True)
            lines.append(line)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    _disarm()
    return lines


if __name__ == "__main__":
    main()
