"""Profile the eval batch and report its device time, op by op.

Counterpart of ``tools/profile_eval.py``: PEMP stage 1, ResNet-50,
``--shots`` supports and one query, ``--hw`` square inputs, ``--batch``
episodes a launch, inputs from ``np.random.RandomState(0)`` as the JAX
tool draws them, weights from seed 0, bf16 on the card and f32 on the
CPU as the JAX tool. The timed function is
the eval batch on the device: logits at input resolution, their argmax,
and the TP/FP/FN counts ([bg, fg] x [tp, fp, fn]) summed over the batch.
Two warm-up launches run first; then ``--launches`` launches run under
``torch.profiler`` and ``utils/profiling.py`` reads the trace.

``--no-kernels`` (the JAX tool's ``--no-pallas``) runs the kernels' plain
versions on the card (``ops.kernels.use_kernels(False)``, what
``dev.use_kernels=False`` asks of an entry). It is for comparison only,
never a fallback.

It prints the top kernels on stderr and one JSON line: the JAX tool's
keys, with ``kernels`` in place of ``pallas``, and ``counts`` (the
summed counts of one launch), ``launches`` (K1-K5 as their wrappers
counted them in the window), ``profiled_launches`` (as the profiler
counted their kernels), the device idle share and the convolutions by
input shape.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.profile_eval --batch 256 [--hw 401] \\
      [--launches 4] [--no-kernels]
  python -m pemp_tpu_torch.tools.profile_eval --device cpu --hw 33 \\
      --batch 2 --launches 1
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from pemp_tpu_torch.config import Config
from pemp_tpu_torch.core.experiment import set_precision
from pemp_tpu_torch.core.metrics import tp_fp_fn
from pemp_tpu_torch.device import resolve_device, tool_precision
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.ops import kernels
from pemp_tpu_torch.tools.profile_train import profile_calls
from pemp_tpu_torch.utils import profiling

WARMUP = 2


def make_inputs(batch: int, shots: int, hw: int
                ) -> Tuple[np.ndarray, ...]:
    """(sup [B,S,H,W,3], msk [B,S,H,W,2], qry [B,1,H,W,3], ref [B,H,W])
    from ``np.random.RandomState(0)``, the JAX tool's draws in its
    order."""
    rng = np.random.RandomState(0)
    sup = rng.randn(batch, shots, hw, hw, 3).astype(np.float32)
    fg = (rng.rand(batch, shots, hw, hw, 1) > 0.5).astype(np.float32)
    msk = np.concatenate([fg, 1 - fg], axis=-1)
    qry = rng.randn(batch, 1, hw, hw, 3).astype(np.float32)
    ref = rng.randint(0, 2, (batch, hw, hw)).astype(np.int32)
    return sup, msk, qry, ref


def build_model(device: torch.device) -> torch.nn.Module:
    """PEMP stage 1 (ResNet-50, the registry's net scope) from seed 0,
    eval mode, channels_last on ``device``, in ``tool_precision``."""
    precision = tool_precision(device)
    cfg = Config(tag="pemp_stage1")
    cfg.net = registry.net_config("pemp_stage1")
    cfg.dev.precision = precision
    set_precision(precision)
    model = registry.build("pemp_stage1", cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device, memory_format=torch.channels_last).eval()


@torch.no_grad()
def eval_batch(model, sup, msk, qry, ref) -> torch.Tensor:
    """Logits at input resolution, argmax, and the [2, 3] TP/FP/FN counts
    summed over the batch (``tools/profile_eval.py:64-70``)."""
    hw = tuple(ref.shape[-2:])
    logits = model(sup, msk, qry, out_hw=hw)
    pred = logits.argmax(-1).to(torch.int32)
    refs = ref.repeat_interleave(pred.shape[1], dim=0)
    return tp_fp_fn(pred.reshape(-1, *hw), refs).sum(0)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=401)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--launches", type=int, default=4)
    ap.add_argument("--shots", type=int, default=1)
    ap.add_argument("--no-kernels", action="store_true",
                    help="the plain mpm in place of the kernels")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    ap.add_argument("--outdir", default="",
                    help="write the chrome trace there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(device)
    sup, msk, qry, ref = (torch.from_numpy(a).to(device) for a in
                          make_inputs(args.batch, args.shots, args.hw))

    with kernels.use_kernels(not args.no_kernels):
        total = []

        def launch():
            total.append(eval_batch(model, sup, msk, qry, ref))

        prof, wall, launched = profile_calls(launch, args.launches, device,
                                             warmup=WARMUP)
    counts = total[-1].cpu().numpy()
    summary = profiling.summarize(prof, args.launches, wall)
    trace_dir = None
    if args.outdir:
        Path(args.outdir).mkdir(parents=True, exist_ok=True)
        trace_dir = args.outdir
        prof.export_chrome_trace(str(Path(args.outdir)
                                     / "profile_eval.pt.trace.json"))
    profiling.print_top(summary, "launch", sys.stderr)
    dev_ms = summary["device_ms_per_step"]
    wall_ms = summary["wall_ms_per_step"]
    out = {
        "batch": args.batch, "hw": args.hw, "shots": args.shots,
        "precision": tool_precision(device),
        "kernels": device.type == "cuda" and not args.no_kernels,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches_traced": args.launches,
        "wall_ms_per_launch": wall_ms,
        "device_ms_per_launch": dev_ms,
        "device_eps": args.batch / (dev_ms / 1e3) if dev_ms else None,
        "wall_eps": args.batch / (wall_ms / 1e3),
        "groups_ms_per_launch": summary["groups_ms_per_step"],
        "busy_ms_per_launch": summary["busy_ms_per_step"],
        "device_idle_share": summary["device_idle_share"],
        "timeline": summary["timeline"],
        "top": summary["top"],
        "conv_by_shape": summary["conv_by_shape"],
        "counts": counts.tolist(),
        "launches": {k: launched[k] for k in profiling.KERNEL_SYMBOLS},
        "profiled_launches": summary["profiled_launches"],
        "trace_dir": trace_dir,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
