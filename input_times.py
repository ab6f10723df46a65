#!/usr/bin/env python3
"""Time the port's host -> device input path under the train loader's
threads, on one GPU.

    python3 input_times.py [--rounds N] [--out FILE]

PEMP stage 1 at ``chip_smoke.py``'s train size (ResNet-50, c=512, p=3,
401x401, batch 4, bf16, cedt, seed 1234) takes train steps fed by the
loader's background threads as the train loop runs them
(``chip_smoke.fed_steps``: the mean step over FED_STEPS steps after
LOADER_WARM, no synchronize between steps), from SYNTH and from a
miniature PASCAL tree (``chip_smoke.write_voc_tree``), through each way
of moving the batch to the card:

- ``pageable_f32``: float32 through pageable memory, the port's path
  before ``parallel/step.py`` (a copy that waits for the card);
- ``pinned_f32``: float32 through a pinned buffer (``dev.compact_wire=False``);
- ``pinned_wire``: the compact wire through a pinned buffer allocated for
  each array, torch's cast on its intra-op threads (the serial path
  before its casts moved to the calling thread);
- ``pageable_wire``: the compact wire cast into pageable memory, a waiting
  copy (no pinned allocation);
- ``pinned_wire_one_thread``: ``pinned_wire`` with one intra-op thread;
- ``pooled_wire``: ``pinned_wire`` from a pool of pinned buffers, each
  reused once its copy has ended (an event);
- ``pooled_wire_chunked``: ``pooled_wire`` with the cast in chunks of
  32768 elements, each below torch's grain for a parallel loop, so on the
  calling thread alone;
- ``serial``: ``device_batch`` as it stands (``dev.prefetch=0``: the
  casts on the calling thread);
- ``prefetched``: the ``DevicePrefetcher`` (``dev.prefetch=2``).

Each is run ``--rounds`` times in turn. Also the device time of one step
(torch.profiler) and, for each run, the device's idle share
(1 - device ms / step ms). Then, with no loader running, the steady train
step (batch 4) and eval step (``make_fast_eval_step``, test batch 8) on
one host batch each (``chip_smoke.host_ms``: median of 10 after 3, ending
in a synchronize) through ``pageable_f32``, ``pinned_f32``,
``pinned_wire``, ``serial`` and ``serial_f32`` (the calling thread's
float32 copy), ``--rounds`` times in turn. Prints one JSON line and
writes it to ``--out`` when given. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("input_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core.evaluator import make_fast_eval_step
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.ops.kernels import build
    from pemp_tpu_torch.parallel import step as pstep

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smoke.nvidia_smi()
    build.build()
    device = torch.device("cuda")
    keys = entry.Stage1Runtime.device_keys
    to_device = pstep._to_device

    def torch_dtype(dtype):
        return torch.from_numpy(np.empty(0, dtype)).dtype

    def pageable(v, dtype, dev):
        """The cast (if any) into pageable memory, then a waiting copy."""
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.to(torch_dtype(dtype)).to(dev)

    def pinned(v, dtype, dev):
        """A pinned buffer for each array, torch's cast into it."""
        buf = torch.empty(v.shape, dtype=torch_dtype(dtype), pin_memory=True)
        buf.copy_(torch.from_numpy(np.ascontiguousarray(v)))
        return buf.to(dev, non_blocking=True)

    pool = {}       # (shape, dtype) -> [(pinned buffer, event of its copy)]

    def pooled(v, dtype, dev, chunk=None):
        key = (v.shape, torch_dtype(dtype))
        free = pool.setdefault(key, [])
        buf = next((b for b, ev in free if ev.query()), None)
        if buf is None:
            buf = torch.empty(v.shape, dtype=key[1], pin_memory=True)
        else:
            free[:] = [(b, ev) for b, ev in free if b is not buf]
        src = torch.from_numpy(np.ascontiguousarray(v))
        if chunk is None:
            buf.copy_(src)
        else:
            flat, sflat = buf.view(-1), src.view(-1)
            for i in range(0, flat.numel(), chunk):
                flat[i:i + chunk].copy_(sflat[i:i + chunk])
        t = buf.to(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        free.append((buf, ev))
        return t

    def chunked(v, dtype, dev):
        return pooled(v, dtype, dev, chunk=32768)

    # (to_device, compact wire, intra-op threads, prefetch)
    variants = {
        "pageable_f32": (pageable, False, None, False),
        "pinned_f32": (pinned, False, None, False),
        "pinned_wire": (pinned, True, None, False),
        "pageable_wire": (pageable, True, None, False),
        "pinned_wire_one_thread": (pinned, True, 1, False),
        "pooled_wire": (pooled, True, None, False),
        "pooled_wire_chunked": (chunked, True, None, False),
        "serial": (to_device, True, None, False),
        "prefetched": (to_device, True, None, True),
    }
    out = {"nvidia_smi": smi, "torch": torch.__version__,
           "intra_op_threads": torch.get_num_threads(),
           "steps": smoke.FED_STEPS, "warm": smoke.LOADER_WARM}
    n = (smoke.LOADER_WARM + smoke.FED_STEPS) * 4
    overrides = dict(a.split("=", 1) for a in smoke.TRAIN_ARGS[2:])
    with tempfile.TemporaryDirectory() as tmp:
        voc = Path(tmp) / "voc"
        smoke.write_voc_tree(voc)
        feeds = {
            "synth": {**overrides, "data.train_n": str(n)},
            "pascal": {**dict(a.split("=", 1) for a in smoke.REAL_ARGS[2:]),
                       "data.base_dir": str(voc), "data.train_n": str(n),
                       "data.seed": "4321"}}
        cfg = entry.ex.assemble("train", feeds["synth"])
        model = entry.build_model(cfg, device).train()
        params = model.freeze()
        trainer = Trainer(cfg, Run(None, None), model,
                          solver.make_optimizer(cfg.tr, params), params,
                          entry.Stage1Runtime(cfg),
                          solver.LRPolicy(cfg.tr, 1000), device)
        model.set_dropout_generator(
            torch.Generator(device=device).manual_seed(0))
        threads = torch.get_num_threads()
        runs = {f"{feed}/{name}": [] for feed in feeds for name in variants}
        for _ in range(args.rounds):
            for feed, fo in feeds.items():
                fcfg = entry.ex.assemble("train", fo)
                for name, (fn, wire, nthreads, prefetch) in variants.items():
                    ds, loader, _ = datasets.load(fcfg, "train")
                    ds.sample_tasks()
                    if prefetch:
                        loader = pstep.DevicePrefetcher(loader, device, 2,
                                                        wire, keys)
                    cfg.dev.compact_wire = wire
                    pstep._to_device = fn
                    if nthreads:
                        torch.set_num_threads(nthreads)
                    try:
                        runs[f"{feed}/{name}"].append(
                            smoke.fed_steps(torch, trainer, loader))
                    finally:
                        pstep._to_device = to_device
                        torch.set_num_threads(threads)
                        cfg.dev.compact_wire = True
        cfg.dev.compact_wire = True
        ds, loader, _ = datasets.load(cfg, "train")
        ds.sample_tasks()
        batch = next(iter(loader))
        prof = smoke.device_profile(torch, lambda: trainer.train_step(batch),
                                    {"memcpy": ["Memcpy"]})

        # no loader running: one host batch, the train and the eval step
        ecfg = entry.ex.assemble("test", dict(
            a.split("=", 1) for a in smoke.MAIN_ARGS[2:]))
        ebatch = smoke.first_batch(datasets, ecfg)
        emodel = entry.build_model(ecfg, device)
        quiet_variants = {"pageable_f32": (pageable, False),
                          "pinned_f32": (pinned, False),
                          "pinned_wire": (pinned, True),
                          "serial": (to_device, True),
                          "serial_f32": (to_device, False)}
        quiet = {f"{what}/{name}": [] for what in ("train", "eval")
                 for name in quiet_variants}
        for _ in range(args.rounds):
            for name, (fn, wire) in quiet_variants.items():
                cfg.dev.compact_wire = wire
                step = make_fast_eval_step(emodel, device, compact_wire=wire)
                pstep._to_device = fn
                try:
                    quiet[f"train/{name}"].append(smoke.host_ms(
                        torch, lambda: trainer.train_step(batch)))
                    quiet[f"eval/{name}"].append(smoke.host_ms(
                        torch, lambda: step(ebatch)))
                finally:
                    pstep._to_device = to_device
                    cfg.dev.compact_wire = True
    device_ms = prof["device_us_total"] / 1e3
    out["train_step_device_ms"] = device_ms
    out["memcpy_us"] = prof["memcpy_us"]
    for key, samples in runs.items():
        steps = [s["step_ms"] for s in samples]
        out[key] = {"step_ms": steps,
                    "step_ms_median": statistics.median(steps),
                    "loader_wait_ms": [s["loader_wait_ms"] for s in samples],
                    "device_idle_share": [1 - device_ms / s for s in steps]}
    for key, samples in quiet.items():
        out[f"quiet/{key}"] = {"step_ms": samples,
                               "step_ms_median": statistics.median(samples)}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"input_times: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
