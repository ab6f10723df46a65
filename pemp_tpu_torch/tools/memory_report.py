"""Device memory of every model family, and the largest batch that fits.

Counterpart of ``tools/memory_report.py``, which compiles each row and
reads XLA's memory analysis against a v5e's 16 GiB. On the card the
allocator says it: for each row the tool runs one eval forward (logits at
input resolution and their argmax, ``export_serving.ServingForward``) or,
for ``s1_train``, one stage-1 train step (``profile_train``'s flagship
step, ce loss, SGD), at each of the row's two probe batches, each after
``torch.cuda.reset_peak_memory_stats()``, and reads
``max_memory_allocated`` and ``max_memory_reserved``. Everything but the
weights scales with the batch, so the two peaks give the bytes an episode
adds and the fixed part; ``project`` (the JAX tool's arithmetic,
``tools/memory_report.py:191-217``) turns them into the largest batch
under the budget, which here is the card's
``torch.cuda.get_device_properties(dev).total_memory``.

``params_bytes`` counts the model's floating ``state_dict`` (parameters
and BN statistics, as the JAX tool counts its variables); the
``s1_train`` row reports the optimizer's momentum apart
(``optimizer_bytes``), which the JAX row adds to its parameters.

With ``--device cpu`` a row reports its parameter bytes and
``"peak_bytes": null`` with the reason: the CPU has no allocator peak.
The models run in bf16 on the card and f32 on the CPU, as the JAX tool's.
One JSON line per row (a table on stderr).

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.memory_report [row ...]

Rows: baseline pemp_stage1 pemp_stage2 panet canet rpmms pfenet s1_train
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Callable, Dict, Optional, Tuple

import torch

from pemp_tpu_torch.config import Config
from pemp_tpu_torch.core.experiment import set_precision
from pemp_tpu_torch.device import resolve_device, tool_precision
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.tools.export_serving import ServingForward, input_shapes
from pemp_tpu_torch.tools.profile_train import flagship_setup

GiB = 1024 ** 3

# (name, hw at preset resolution, probe batches for the linear fit): the
# JAX tool's rows
ROWS = {
    "baseline":    ("baseline", 401, (8, 16)),
    "pemp_stage1": ("pemp_stage1", 401, (8, 16)),
    "pemp_stage2": ("pemp_stage2", 401, (8, 16)),
    "panet":       ("panet", 401, (8, 16)),
    "canet":       ("canet", 321, (8, 16)),
    "rpmms":       ("rpmms", 481, (4, 8)),
    "pfenet":      ("pfenet", 473, (4, 8)),
    "s1_train":    (None, 401, (2, 4)),
}
# the JAX tool's models: Baseline and both PEMP stages on ResNet-50,
# the others at their defaults
BACKBONES = {"baseline": "resnet50", "pemp_stage1": "resnet50",
             "pemp_stage2": "resnet50"}
CPU_REASON = ("the CPU has no allocator peak (max_memory_allocated is the "
              "card's); run on the card for the peaks and the projection")


def project(params_bytes: float, var1: float, var2: float, b1: int, b2: int,
            budget: float) -> Tuple[float, float, int]:
    """(bytes an episode adds, fixed bytes, the largest batch under
    ``budget``) from the batch-dependent bytes ``var1``/``var2`` at the
    probe batches ``b1``/``b2`` (the JAX tool's ``report_row``)."""
    per_ep = max((var2 - var1) / (b2 - b1), 1.0)
    fixed = params_bytes + max(var1 - per_ep * b1, 0.0)
    return per_ep, fixed, int((budget - fixed) // per_ep)


def state_bytes(module: torch.nn.Module) -> int:
    """Bytes of ``module``'s floating ``state_dict`` (parameters and BN
    statistics; the BNs' integer step counters are left out)."""
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values() if t.is_floating_point())


def build(name: str, precision: str) -> torch.nn.Module:
    """Registry family ``name`` as the JAX tool builds it (1-shot), from
    seed 0, on the CPU."""
    cfg = Config(tag=name)
    cfg.net = registry.net_config(name)
    if name in BACKBONES:
        for key in ("backbone", "backbone2"):
            if hasattr(cfg.net, key):
                setattr(cfg.net, key, BACKBONES[name])
    cfg.dev.precision = precision
    model = registry.build(name, cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def episode(name: str, b: int, hw: int, device: torch.device) -> tuple:
    """Seeded inputs of ``b`` 1-shot episodes on ``device``: images,
    binary [fg, bg] masks, and stage 2's binary prior or CaNet's
    history."""
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = input_shapes(name, b, 1, 1, hw)
    sup = torch.randn(shapes[0], generator=gen, device=device)
    fg = (torch.rand(shapes[1][:-1] + (1,), generator=gen, device=device)
          > 0.5).float()
    qry = torch.randn(shapes[2], generator=gen, device=device)
    out = [sup, torch.cat([fg, 1 - fg], -1), qry]
    if len(shapes) > 3:
        extra = torch.rand(shapes[3], generator=gen, device=device)
        out.append((extra > 0.5).float() if name == "pemp_stage2" else extra)
    return tuple(out)


def peak(fn: Callable, device: torch.device) -> Tuple[int, int]:
    """(max allocated, max reserved) bytes while ``fn()`` runs."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device),
            torch.cuda.max_memory_reserved(device))


def eval_peaks(name: str, hw: int, batches, device: torch.device,
               precision: str) -> Tuple[int, list]:
    """(params bytes, [(allocated, reserved)] per batch) of the eval
    forward; the peaks only on the card."""
    model = build(name, precision)
    params = state_bytes(model)
    if device.type != "cuda":
        return params, []
    serve = ServingForward(name, model.to(
        device, memory_format=torch.channels_last).eval(), hw).eval()
    peaks = []
    for b in batches:
        inputs = episode(name, b, hw, device)

        @torch.no_grad()
        def run():
            serve(*inputs).argmax(-1).to(torch.int32)
        run()                                   # cuDNN picks, workspaces
        peaks.append(peak(run, device))
        del inputs
    del serve, model
    return params, peaks


def train_peaks(hw: int, batches, device: torch.device, precision: str
                ) -> Tuple[int, list, Optional[int]]:
    """(model bytes, [(allocated, reserved)] per batch, optimizer bytes)
    of the stage-1 train step (ce loss): each batch's step after one
    warm-up step (the momentum buffers exist by then)."""
    params = state_bytes(build("pemp_stage1", precision))
    if device.type != "cuda":
        return params, [], None
    peaks, opt_bytes = [], None
    for b in batches:
        setup = flagship_setup(hw, b, "ce", device, precision)
        step = setup.step()
        step()
        peaks.append(peak(step, device))
        opt_bytes = sum(v.numel() * v.element_size()
                        for st in setup.trainer.optimizer.state.values()
                        for v in st.values() if torch.is_tensor(v))
        del setup, step
        gc.collect()
        torch.cuda.empty_cache()
    return params, peaks, opt_bytes


def report_row(key: str, device: torch.device) -> Dict:
    name, hw, (b1, b2) = ROWS[key]
    precision = tool_precision(device)
    opt = None
    if key == "s1_train":
        params, peaks, opt = train_peaks(hw, (b1, b2), device, precision)
    else:
        params, peaks = eval_peaks(name, hw, (b1, b2), device, precision)
    row = {"row": key, "hw": hw, "probe_batches": [b1, b2],
           "precision": precision, "params_bytes": params,
           "params_gib": params / GiB}
    if opt is not None:
        row["optimizer_bytes"] = opt
    if device.type != "cuda":
        row.update(device="cpu", peak_bytes=None, reason=CPU_REASON)
        print(f"  {key:12s} hw={hw}  params {params / GiB:.3f} GiB  "
              "(no peak on the CPU)", file=sys.stderr)
        return row
    (a1, r1), (a2, r2) = peaks
    budget = torch.cuda.get_device_properties(device).total_memory
    per_ep, fixed, max_b = project(params, a1 - params, a2 - params, b1, b2,
                                   budget)
    row.update({
        "device": torch.cuda.get_device_name(device),
        "peak_bytes": [a1, a2], "reserved_bytes": [r1, r2],
        f"peak_gib_at_b{b2}": a2 / GiB,
        "per_episode_mib": per_ep / 1024 ** 2,
        "fixed_gib": fixed / GiB,
        "budget_bytes": budget,
        "projected_max_batch": max_b,
    })
    print(f"  {key:12s} hw={hw}  params {params / GiB:.3f} GiB  "
          f"per-episode {per_ep / 1024 ** 2:.1f} MiB  max B ~{max_b}",
          file=sys.stderr)
    gc.collect()
    torch.cuda.empty_cache()
    return row


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
    set_precision(tool_precision(device))
    out = []
    for r in rows:
        out.append(report_row(r, device))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
