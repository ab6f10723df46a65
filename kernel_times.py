#!/usr/bin/env python3
"""Time one checkout's port kernels through their public wrappers.

    python3 kernel_times.py [--root DIR] [--label NAME]

Imports ``pemp_tpu_torch`` from DIR (default: this script's checkout),
builds its CUDA kernels there, and times each call on one GPU with
``chip_smoke.py``'s timer (CUDA events, median of 30, an L2 flush before
each), twice: with the timer's device-side
spin (``device_ms``: the device's work alone; ~0.2 ms, and ~2 ms for
``mpm_backward``, whose enqueue may take longer) and without
(``host_ms``: what a caller waits on an idle device, the wrapper's
dispatch included). The calls, at the shapes of the port's paths (bf16
features, n=2601, c=512, p=3 unless named):

- ``assign_eval`` / ``assign_train``: ``mpm_assign`` at B=8 / B=4;
- ``assign_p8``: B=8 at p=8; ``assign_c1024``: B=4 at c=1024;
- ``match_eval``, ``chain_eval``: ``mpm_match``, ``mpm_chain_packed`` at B=8;
- ``minplus_phase1`` / ``minplus_phase2``: the EDT's two ``minplus``
  products at B=4, 401x401;
- ``mpm_backward``: the backward of ``MPMChainPacked`` at B=4 (and
  ``mpm_backward_f32`` with float32 features, ``mpm_backward_p12`` at
  p=12 where the checkout takes it);
- ``mpm_backward_b1`` / ``_b2`` / ``_b8``: the same at B=1, 2 and 8;
- ``chain_train`` / ``chain_train_step``: ``MPMChainPacked``'s forward on
  inputs that require grad at B=4 (what a train step's forward launches:
  K1, saving what its backward reads, then K2), and that forward with its
  backward.

``mpm_backward_sweep`` profiles the backward at B=1, 2, 4 and 8
(``chip_smoke.mpm_backward_sweep``): each backward kernel's device us a
call (every kernel whose name holds ``_bwd``), the call's other device
us (what the wrapper and autograd launch besides), and per kernel a
least-squares line us = fixed + bytes / rate over the four batches
(``fixed_us``, ``marginal_bytes_per_s``; bytes as
``chip_smoke.mpm_backward_work`` counts them).

Only wrappers that every checkout since the port's training slice has
are called, so two checkouts run with the same timer: run the script once
for each, in turns, in one session on one card (``--skip`` leaves out a
call that a checkout refuses, such as ``assign_c1024``). Each result is first held
against its plain version (prototypes within chip_smoke's PROTO_RTOL,
min-plus bit-equal). Prints one JSON line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke as smoke  # noqa: E402  (this checkout's timer)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose pemp_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--skip", nargs="*", default=(),
                    help="calls to leave out (one the checkout lacks)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from pemp_tpu_torch.ops import prototypes as plain
    from pemp_tpu_torch.ops.kernels import build
    from pemp_tpu_torch.ops.kernels import minplus as M
    from pemp_tpu_torch.ops.kernels import mpm as K
    if root not in Path(K.__file__).resolve().parents:
        raise RuntimeError(f"imported {K.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    build.build()

    bf16, scale, eps = torch.bfloat16, 20.0, plain.ASSIGN_EPS
    calls = {}

    def assign(name, b, c, p):
        if name in args.skip:
            return None
        fts, fg, bg, ctr = smoke.make_inputs(torch, b, 1, 1, 2601, c, p, bf16)
        got = torch.cat(K.mpm_assign(fts, fg, bg, ctr, p), 1)
        ref = torch.cat(plain.meta_prototype_assign(fts[:, :1], fg, bg, ctr,
                                                    p), 1)
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        if rel > smoke.PROTO_RTOL:
            raise AssertionError(f"{name}: rel err {rel}")
        calls[name] = lambda: K.mpm_assign(fts, fg, bg, ctr, p)
        return fts, fg, bg, ctr, ref

    assign("assign_train", 4, 512, 3)
    assign("assign_p8", 8, 512, 8)
    assign("assign_c1024", 4, 1024, 3)
    fts, fg, bg, ctr, ref = assign("assign_eval", 8, 512, 3)
    pf, pb = ref[:, :3], ref[:, 3:]
    calls["match_eval"] = lambda: K.mpm_match(fts, 1, pf, pb, scale)
    calls["chain_eval"] = lambda: K.mpm_chain_packed(fts, fg, bg, ctr, 3,
                                                     scale)

    # the EDT's two products on a random boundary map (the kernel does the
    # same work for any data): [H,H] x [B,H,W], then [B*H,W] x [W,W]
    g = torch.Generator(device="cuda").manual_seed(0)
    h = 401
    idx = torch.arange(h, device="cuda", dtype=torch.float32)
    off = ((idx[:, None] - idx[None, :]) ** 2).contiguous()
    src = torch.where(torch.rand(4, h, h, generator=g, device="cuda") < 0.02,
                      0.0, 1.0e12).contiguous()
    g2 = M.minplus(off, src)
    if not torch.equal(g2, M.plain_minplus(off, src)):
        raise AssertionError("minplus phase 1 is not bit-equal")
    g2 = g2.reshape(4 * h, h).contiguous()
    if not torch.equal(M.minplus(g2, off), M.plain_minplus(g2, off)):
        raise AssertionError("minplus phase 2 is not bit-equal")
    calls["minplus_phase1"] = lambda: M.minplus(off, src)
    calls["minplus_phase2"] = lambda: M.minplus(g2, off)

    def backward(b, p=3, dtype=bf16):
        fts, fg_, bg_, ctr_ = smoke.make_inputs(torch, b, 1, 1, 2601, 512, p,
                                                dtype, seed=3)
        fk, ck = fts.clone().requires_grad_(), ctr_.clone().requires_grad_()
        logits = K.MPMChainPacked.apply(fk, fg_, bg_, ck, p, scale, eps)
        cot = torch.randn(logits.shape, generator=g, device="cuda")
        return lambda: torch.autograd.grad(logits, (fk, ck), cot,
                                           retain_graph=True)

    def train_chain(b=4, p=3):
        fts, fg_, bg_, ctr_ = smoke.make_inputs(torch, b, 1, 1, 2601, 512, p,
                                                bf16, seed=3)
        fk, ck = fts.clone().requires_grad_(), ctr_.clone().requires_grad_()

        def forward():
            return K.MPMChainPacked.apply(fk, fg_, bg_, ck, p, scale, eps)
        cot = torch.randn(forward().shape, generator=g, device="cuda")
        return forward, lambda: torch.autograd.grad(forward(), (fk, ck), cot)

    calls["chain_train"], calls["chain_train_step"] = train_chain()
    calls["mpm_backward"] = backward(4)
    calls["mpm_backward_f32"] = backward(4, dtype=torch.float32)
    if "mpm_backward_p12" not in args.skip and K.MAX_PROTOS >= 12:
        calls["mpm_backward_p12"] = backward(4, p=12)
    for b in smoke.BWD_SWEEP_BATCHES:
        if b != 4:
            calls[f"mpm_backward_b{b}"] = backward(b)

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {"label": args.label or str(root), "nvidia_smi": smi,
           "device_ms": {}, "host_ms": {}}
    for name, fn in calls.items():
        if name in args.skip:
            continue
        cycles = (smoke.LONG_SPIN_CYCLES
                  if name.startswith(("mpm_backward", "chain_train"))
                  else smoke.SPIN_CYCLES)
        for key, spin in (("device_ms", True), ("host_ms", False)):
            out[key][name] = smoke.time_ms(torch, fn, flush, spin=spin,
                                           spin_cycles=cycles)
    out["mpm_backward_sweep"] = smoke.mpm_backward_sweep(
        torch, {b: calls["mpm_backward" if b == 4 else f"mpm_backward_b{b}"]
                for b in smoke.BWD_SWEEP_BATCHES})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
