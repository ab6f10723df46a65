"""A/B two train-step levers of the convolutions, behind a parity gate.

Counterpart of ``tools/exp_train_levers.py`` on the stage-1 train step
of ``profile_train`` (ResNet-50, ``--bs 4 --hw 401 --loss cedt``, the
JAX tool's synthetic batch, the port's ``Trainer``; bf16 on the card and
f32 on the CPU, as the JAX tool). The JAX tool routes
its convolutions through a hook in the model; here the tool swaps
modules of the built model instead, each new module holding the same
``nn.Parameter`` objects, so nothing in ``models/`` changes:

- ``s2b``: every 3x3, stride-1 ``nn.Conv2d`` with ``padding ==
  dilation = d > 1`` (ResNet layer3 d=2, layer4 d=4 where a trunk has
  one, the ASPPV2 branches d=6, 12, 18) becomes ``S2BConv2d``, computed
  by ``ops/s2b.py::s2b_conv2d``: H and W padded up to whole phase
  subgrids, the phase subgrids viewed as a batch, one dense padding-1
  3x3 convolution, the result interleaved back. The same sums as the
  dilated convolution (the pad-up rows are zeros the dilated
  convolution's zero padding would read too); cuDNN picks its kernels
  for the dense shape instead. The models take this route themselves
  at d >= 12 (``models/layers.py::Conv``); this arm prices it at every
  d.
- ``wgrad32``: every ``nn.Conv2d`` becomes ``WGrad32Conv2d``, whose
  forward and input gradient are as autocast gives them (bf16 operands
  under bf16) and whose weight gradient is
  ``torch.nn.grad.conv2d_weight`` on float32 operands, cast back. Under
  bf16 autocast the native weight gradients already take bf16 operands
  (``show_wgrad_dtypes`` prints them), so this arm prices the other
  side of that lever.
- ``native``: the model as built, with the models' own space-to-batch
  route for d >= 12 (``ops/s2b.py``, ``models/layers.py::Conv``) turned
  off, so that every dilated convolution runs on cuDNN's kernels.

Modes:

- ``verify``: one seeded train step per arm from the same weights,
  dropout seed and batch; the loss within rtol 2e-3 on the CPU and 2e-2
  on the card, and every parameter after the step within a max relative
  error of 5e-3 of its own largest magnitude on the CPU, or on the card
  of the larger of that and 1e-2 x the largest magnitude of all of them,
  below 2e-2 (the JAX tool's gate, ``tools/exp_train_levers.py:141-179``).
  Beside it, and held to nothing, ``worst_grad_rel``: the largest gap of
  a parameter's (clipped) gradient to native's over native's largest,
  leaf by leaf; one step's update is small beside the weights the gate
  compares, so the gradients are what shows a wrong backward;
- ``measure``: each arm's steady step (host clock, median of 10 after 3,
  ending in a synchronize), its device ms and idle share from a
  profiled step and its top convolutions by input shape
  (``utils/profiling.py``), eager or with ``--fuse k`` (replays of a
  ``dev.fuse_steps=k`` chunk), and each arm's ``speedup_vs_native``,
  with the cuDNN flags it ran under (``allow_tf32`` decides the wgrad32
  arm's float32 kernels). It measures; it claims nothing;
- ``show_wgrad_dtypes``: the dtypes of a dilated convolution's backward
  under bf16 autocast, read by an autograd hook on its backward node.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.exp_train_levers verify
  python -m pemp_tpu_torch.tools.exp_train_levers measure [--fuse 4] \\
      [--arms native,s2b,wgrad32]
  python -m pemp_tpu_torch.tools.exp_train_levers show_wgrad_dtypes
  python -m pemp_tpu_torch.tools.exp_train_levers verify --device cpu \\
      --hw 33 --bs 2
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pemp_tpu_torch.device import resolve_device, tool_precision
from pemp_tpu_torch.models.layers import Conv
from pemp_tpu_torch.ops import s2b
from pemp_tpu_torch.ops.s2b import s2b_conv2d
from pemp_tpu_torch.tools.profile_train import (
    Setup, flagship_setup, profile_calls, sync,
)
from pemp_tpu_torch.utils import profiling


# ---- lever (b): space-to-batch dilated schedule -------------------------

def s2b_eligible(conv: nn.Module) -> bool:
    """A 3x3, stride-1, ungrouped, zero-padded ``nn.Conv2d`` (the models'
    ``Conv`` and its subclasses included) with ``padding == dilation > 1``
    (the dilated convolutions of the models)."""
    return isinstance(conv, nn.Conv2d) and s2b.phase_dilation(conv) > 1


class S2BConv2d(nn.Module):
    """``conv`` (``s2b_eligible``) computed by ``s2b_conv2d``; holds the
    same ``weight`` and ``bias`` parameters, so the model's
    ``state_dict`` and optimizer see no change."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if not s2b_eligible(conv):
            raise ValueError(f"not a 3x3 stride-1 padding=dilation conv: "
                             f"{conv}")
        self.d = conv.dilation[0]
        self.weight = conv.weight
        self.bias = conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return s2b_conv2d(x, self.weight, self.bias, self.d)


# ---- lever (a): weight-gradient operand dtype ---------------------------

class _WGrad32(torch.autograd.Function):
    """conv2d whose weight gradient runs on float32 operands."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.conf = (stride, padding, dilation, groups)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, weight, g, stride,
                                            padding, dilation, groups)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.float(), weight.shape, g.float(), stride, padding,
                dilation, groups).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dx, dw, db, None, None, None, None


class WGrad32Conv2d(nn.Module):
    """``conv`` with ``_WGrad32``'s backward; the same parameters. Under
    autocast its operands are cast as autocast casts a convolution's."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if not isinstance(conv, nn.Conv2d) or conv.padding_mode != "zeros":
            raise ValueError(f"not a zero-padded nn.Conv2d: {conv}")
        self.conf = (conv.stride, conv.padding, conv.dilation, conv.groups)
        self.weight = conv.weight
        self.bias = conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        kind = x.device.type
        if torch.is_autocast_enabled(kind):
            dtype = torch.get_autocast_dtype(kind)
            x, w = x.to(dtype), w.to(dtype)
            b = None if b is None else b.to(dtype)
        with torch.autocast(kind, enabled=False):
            return _WGrad32.apply(x, w, b, *self.conf)


def swap_convs(model: nn.Module, make: Callable[[nn.Conv2d], nn.Module],
               eligible: Callable[[nn.Module], bool]) -> int:
    """Replace each ``eligible`` submodule of ``model`` by ``make(it)``;
    returns how many."""
    n = 0
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if eligible(child):
                setattr(parent, name, make(child))
                n += 1
    return n


def native_convs(model: nn.Module) -> int:
    """Turn the models' own space-to-batch route off (``Conv``'s
    ``s2b_dilation``): every convolution of ``model`` then runs as
    ``nn.Conv2d``, cuDNN's dilated kernels included; returns how many
    were routed."""
    routed = [m for m in model.modules()
              if isinstance(m, Conv) and m.s2b_dilation]
    for m in routed:
        m.s2b_dilation = 0
    return len(routed)


def apply_arm(model: nn.Module, arm: str) -> int:
    """Swap the modules of ``arm`` into ``model``; returns how many (for
    ``native``, how many convolutions left the models' own route)."""
    if arm == "native":
        return native_convs(model)
    if arm == "s2b":
        return swap_convs(model, S2BConv2d, s2b_eligible)
    if arm == "wgrad32":
        return swap_convs(model, WGrad32Conv2d,
                          lambda m: isinstance(m, nn.Conv2d)
                          and m.padding_mode == "zeros")
    raise KeyError(arm)


ARMS = ("native", "s2b", "wgrad32")


def arm_setup(arm: str, args, device: torch.device,
              fuse: int = 1) -> Tuple[Setup, int]:
    """The flagship step (weights and dropout from seed 0) with ``arm``'s
    modules swapped in, and how many were swapped."""
    swapped = []
    setup = flagship_setup(args.hw, args.bs, args.loss, device,
                           args.precision, fuse,
                           transform=lambda m: swapped.append(
                               apply_arm(m, arm)))
    return setup, swapped[0]


def one_step(arm: str, args, device: torch.device):
    """(loss, {parameter name: float64 numpy} after the step, the same of
    the step's clipped gradients, swapped modules) of one train step of
    ``arm``."""
    setup, swapped = arm_setup(arm, args, device)
    loss = float(setup.step()())
    named = list(setup.model.named_parameters())
    params = {k: p.detach().double().cpu().numpy() for k, p in named}
    grads = {k: p.grad.double().cpu().numpy() for k, p in named
             if p.grad is not None}
    return loss, params, grads, swapped


def grad_gap(base: Dict[str, np.ndarray], grads: Dict[str, np.ndarray]
             ) -> float:
    """The largest relative gap of a gradient to native's: max |g -
    g_native| / max |g_native|, leaf by leaf over native's nonzero
    gradients (a leaf native gave a gradient and ``grads`` not: 1)."""
    worst = 0.0
    for k, want in base.items():
        scale = float(np.abs(want).max())
        if scale > 0:
            got = grads.get(k, np.zeros_like(want))
            worst = max(worst, float(np.abs(got - want).max()) / scale)
    return worst


def gate(base_loss: float, base: Dict[str, np.ndarray], loss: float,
         params: Dict[str, np.ndarray], on_card: bool, name: str) -> float:
    """The JAX tool's verify gate: returns the worst per-parameter
    relative error, or raises."""
    rtol = 2e-2 if on_card else 2e-3
    if not abs(loss - base_loss) <= rtol * abs(base_loss):
        raise AssertionError(f"{name}: loss {loss} vs native {base_loss} "
                             f"(rtol {rtol})")
    if set(params) != set(base):
        raise AssertionError(f"{name}: parameter set changed")
    gscale = max(float(np.abs(v).max()) for v in base.values())
    worst = 0.0
    for k, b in base.items():
        scale = max(float(np.abs(b).max()),
                    1e-2 * gscale if on_card else 1e-8)
        worst = max(worst, float(np.abs(params[k] - b).max()) / scale)
    tol = 2e-2 if on_card else 5e-3
    if not worst < tol:
        raise AssertionError(f"{name}: post-step parameters off by "
                             f"{worst:.2e} (tol {tol})")
    return worst


def verify(args, device: torch.device) -> Dict:
    """Every arm against ``native`` through ``gate``."""
    on_card = device.type == "cuda"
    base_loss, base, base_grads, _ = one_step("native", args, device)
    arms = {}
    for name in args.arms:
        if name == "native":
            continue
        loss, params, grads, swapped = one_step(name, args, device)
        worst = gate(base_loss, base, loss, params, on_card, name)
        gworst = grad_gap(base_grads, grads)
        arms[name] = {"loss": loss, "worst_param_rel": worst,
                      "worst_grad_rel": gworst, "swapped_convs": swapped}
        print(f"verify {name}: ok (loss {loss:.6f} vs {base_loss:.6f}, "
              f"worst param rel {worst:.2e}, worst grad rel {gworst:.2e}, "
              f"{swapped} convs swapped)", file=sys.stderr)
    out = {"verify": "ok", "arms": args.arms, "native_loss": base_loss,
           "results": arms, "platform": "gpu" if on_card else "cpu",
           "device": (torch.cuda.get_device_name(device) if on_card
                      else "cpu")}
    print(json.dumps(out), flush=True)
    return out


def host_ms(fn: Callable, device: torch.device, warm: int = 3,
            n: int = 10) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronize, after
    ``warm`` calls."""
    for _ in range(warm):
        fn()
    sync(device)
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e3


def measure_arm(arm: str, args, device: torch.device) -> Dict:
    """One arm's steady step, eager or as ``--fuse`` chunks."""
    fuse = max(args.fuse, 1)
    setup, swapped = arm_setup(arm, args, device, fuse)
    fn = setup.step()
    call_ms = host_ms(fn, device)
    prof, wall, _ = profile_calls(fn, 1, device, warmup=0)
    summary = profiling.summarize(prof, fuse, wall)
    step_ms = call_ms / fuse
    return {
        "arm": arm, "swapped_convs": swapped,
        "path": "kernels" + (f"+fuse{fuse}" if fuse > 1 else ""),
        "fuse_steps": setup.fuse, "bs": setup.bs, "hw": setup.hw,
        "precision": args.precision,
        "step_ms": step_ms, "episodes_per_s": setup.bs / step_ms * 1e3,
        "device_ms_per_step": summary["device_ms_per_step"],
        "device_idle_share": summary["device_idle_share"],
        "timeline": summary["timeline"],
        "groups_ms_per_step": summary["groups_ms_per_step"],
        "conv_by_shape": summary["conv_by_shape"][:6],
        "cudnn": {k: getattr(torch.backends.cudnn, k) for k in
                  ("allow_tf32", "deterministic", "benchmark")},
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def measure(args, device: torch.device) -> List[Dict]:
    out = []
    for name in args.arms:
        out.append(measure_arm(name, args, device))
        print(json.dumps(out[-1]), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    base = next((r for r in out if r["arm"] == "native"), None)
    if base:
        for r in out:
            if r is not base:
                r["speedup_vs_native"] = (r["episodes_per_s"]
                                          / base["episodes_per_s"])
                print(json.dumps({"arm": r["arm"],
                                  "speedup_vs_native":
                                      r["speedup_vs_native"]}), flush=True)
    return out


def show_wgrad_dtypes(args, device: torch.device) -> List[Dict]:
    """The dtypes of the backward of a dilated 3x3 convolution under bf16
    autocast (the JAX tool's jaxpr check): the operands the backward node
    saved and the gradients it returns, read by a hook on the node."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, 3, 3, generator=gen).to(device).requires_grad_()
    x = torch.randn(2, 8, 16, 16, generator=gen).to(device).requires_grad_()
    seen = []
    with torch.autocast(device.type, dtype=torch.bfloat16):
        y = F.conv2d(x, w, padding=2, dilation=2)
    node = y.grad_fn

    def hook(grad_inputs, grad_outputs):
        seen.append({
            "node": type(node).__name__,
            "input": str(node._saved_input.dtype),
            "weight": str(node._saved_weight.dtype),
            "grad_output": str(grad_outputs[0].dtype),
            "grad_input": str(grad_inputs[0].dtype),
            "grad_weight": str(grad_inputs[1].dtype)})
    node.register_hook(hook)
    (y.float() ** 2).sum().backward()
    for row in seen:
        print(json.dumps({"conv": row, "device": device.type}), flush=True)
    return seen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["verify", "measure",
                                     "show_wgrad_dtypes"])
    ap.add_argument("--hw", type=int, default=401)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--loss", default="cedt")
    ap.add_argument("--fuse", type=int, default=0)
    ap.add_argument("--arms", default="native,s2b,wgrad32")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    args.arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    bad = [a for a in args.arms if a not in ARMS]
    if bad:
        ap.error(f"unknown arms {bad}; choose from {list(ARMS)}")
    device = resolve_device(args.device)
    args.precision = tool_precision(device)
    return {"verify": verify, "measure": measure,
            "show_wgrad_dtypes": show_wgrad_dtypes}[args.mode](args, device)


if __name__ == "__main__":
    main()
