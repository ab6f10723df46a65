#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pemp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. It builds the port's CUDA kernels from the sources in the
checkout, holds each kernel against its plain PyTorch version on the card,
drives the port's main path (PEMP stage 1, ResNet-50, 1-shot, 401x401
SYNTH episodes, 8 episodes a batch) through its ``test`` entry, and checks
that the path went through the kernels and agrees with the plain version.

Each phase prints one JSON line; then the kernel table, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero; without CUDA (or outside a
checkout) it fails before printing a result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TIMING_ITERS = 30                # CUDA-event samples per timing (median)
# kernel vs plain tolerances (fp32 accumulation in another order):
PROTO_RTOL = 1e-3    # prototypes: max abs err <= PROTO_RTOL * max |plain|
LOGIT_ATOL = 2e-3    # logits (cosine x 20): max abs err
MARGIN = 1e-3        # argmax indices must agree where the top-two gap > MARGIN
MAIN_AGREE = 0.999   # main path: argmax agreement, kernels vs plain mpm

MAIN_ARGS = ["test", "with", "split=0", "data.dataset=SYNTH",
             "data.height=401", "data.width=401", "shot=1", "query=1",
             "data.test_bs=8", "data.test_n=32", "te.epochs=1",
             "dev.precision=bf16", "seed=1234"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, flush) -> float:
    """Median CUDA-event time of ``fn`` over TIMING_ITERS launches, each
    after a write of ``flush`` (> L2) so the inputs come from HBM and the
    device is busy while the host enqueues ``fn``."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMING_ITERS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def work(b, s, q, n, c, p, esize, tile):
    """(bytes, flops) of each kernel and of the chain, for calls that write
    no indices: each input read once, each output written once; flops of
    |f|^2, the 2p-column products and the tile sums."""
    k2, tiles = 2 * p, -(-n // tile)
    masks, ctr = 2 * b * s * n * 4, c * k2 * 4
    part = b * s * tiles * k2 * (c + 1) * 4
    protos, logits = b * k2 * c * 4, b * q * n * 2 * 4
    f1 = b * s * n * (2 * c + 4 * c * k2)
    f2 = b * s * k2 * (c * tiles + tiles + 2 * c)
    f3 = b * q * n * (2 * c + 2 * c * k2)
    return {
        "assign_partial": (b * s * n * c * esize + masks + ctr + part, f1),
        "assign_reduce": (part + protos, f2),
        "match": (b * q * n * c * esize + protos + logits, f3),
        # the chain's own inputs and output; K1's scratch and prototypes
        # between the launches are not part of the function
        "chain": (b * (s + q) * n * c * esize + masks + ctr + logits,
                  f1 + f2 + f3),
    }


def make_inputs(torch, b, s, q, n, c, p, dtype, far=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    fts = torch.randn(b, s + q, n, c, generator=g, device="cuda")
    fg = (torch.rand(b, s, n, generator=g, device="cuda") > 0.6).float()
    ctr = torch.rand(c, 2 * p, generator=g, device="cuda")
    if far:
        # fg centers far from the features: |f - ctr|^2 ~ 5e4 on fg columns
        # while bg columns sit close -- exp over both classes would overflow
        fts = fts * 0.1
        ctr[:, :p] = 10.0
        ctr[:, p:] = 0.0
    return fts.to(dtype).contiguous(), fg, 1.0 - fg, ctr


def index_agreement(inds_a, inds_b, sims_margin):
    """(overall share equal, all equal where the margin > MARGIN)."""
    same = inds_a == inds_b
    sure = sims_margin > MARGIN
    return (same.float().mean().item(),
            bool(same[sure].all().item()))


def top2_margin(torch, fts_q, fg, bg, scale):
    """Per row and class, the gap between the two largest plain sims."""
    from pemp_tpu_torch.ops.prototypes import cosine_similarity
    out = []
    for pr in (bg, fg):
        sims = cosine_similarity(fts_q, pr[:, None]) * scale   # [B,Q,n,p]
        if sims.shape[-1] < 2:
            out.append(torch.full(sims.shape[:-1], math.inf, device="cuda"))
            continue
        top = sims.topk(2, dim=-1).values
        out.append(top[..., 0] - top[..., 1])
    return torch.stack(out, dim=-1)


def kernel_phase(torch, K, plain):
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    c, p, scale = 512, 3, 20.0
    cases = [
        # (name, B, S, Q, n, dtype, far)
        ("main_bf16", 8, 1, 1, 2601, torch.bfloat16, False),
        ("main_f32", 8, 1, 1, 2601, torch.float32, False),
        ("shot5_bf16", 8, 5, 1, 2601, torch.bfloat16, False),
        ("shot5_f32", 8, 5, 1, 2601, torch.float32, False),
        ("n1030_bf16", 8, 1, 1, 1030, torch.bfloat16, False),
        ("n1030_f32", 8, 2, 1, 1030, torch.float32, False),
        ("far_ctr_f32", 2, 1, 1, 2601, torch.float32, True),
        ("far_ctr_bf16", 2, 1, 1, 1030, torch.bfloat16, True),
    ]
    results = []
    worst = {"assign_partial": 0.0, "assign_reduce": 0.0, "match": 0.0,
             "chain": 0.0}
    for name, b, s, q, n, dtype, far in cases:
        fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, dtype, far)
        # K1's two launches, each against its plain version on its inputs
        kpart = K._assign_partial_launch(fts, fg, bg, ctr, p)
        ppart = K.plain_assign_partial(fts, fg, bg, ctr, p)
        err_p = (kpart - ppart).abs().max().item()
        rel_p = err_p / ppart.abs().max().item()
        kred = K._assign_reduce_launch(kpart, b, s, plain.ASSIGN_EPS)
        pred = K.plain_assign_reduce(kpart, b, s, plain.ASSIGN_EPS)
        err_r = (kred - pred).abs().max().item()
        rel_r = err_r / pred.abs().max().item()
        # K1 whole
        kf, kb = K.mpm_assign(fts, fg, bg, ctr, p)
        pf, pb = plain.meta_prototype_assign(fts[:, :s], fg, bg, ctr, p)
        ref = torch.cat([pf, pb], 1)
        err1 = (torch.cat([kf, kb], 1) - ref).abs().max().item()
        rel1 = err1 / ref.abs().max().item()
        finite1 = bool(torch.isfinite(kf).all() and torch.isfinite(kb).all())
        # K2 alone, on the plain prototypes
        kl, ki = K.mpm_match(fts, s, pf, pb, scale, return_indices=True)
        pl, pi = plain.prototype_predictions(fts[:, s:], pf, pb, scale, True)
        err2 = (kl - pl).abs().max().item()
        margin = top2_margin(torch, fts[:, s:], pf, pb, scale)
        agree2, sure2 = index_agreement(ki, pi, margin)
        # K3: the packed chain, twice (bit-identical), against plain
        cl, ci = K.mpm_chain_packed(fts, fg, bg, ctr, p, scale,
                                    return_indices=True)
        cl2, ci2 = K.mpm_chain_packed(fts, fg, bg, ctr, p, scale,
                                      return_indices=True)
        bitwise = bool(torch.equal(cl, cl2) and torch.equal(ci, ci2))
        err3 = (cl - pl).abs().max().item()
        agree3, sure3 = index_agreement(ci, pi, margin)
        torch.cuda.synchronize()
        ok = (finite1 and rel_p <= PROTO_RTOL and rel_r <= PROTO_RTOL
              and rel1 <= PROTO_RTOL and err2 <= LOGIT_ATOL
              and sure2 and err3 <= LOGIT_ATOL and sure3 and bitwise)
        row = {"case": name, "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p,
               "dtype": str(dtype).replace("torch.", ""),
               "assign_partial_max_abs_err": err_p,
               "assign_partial_max_rel_err": rel_p,
               "assign_reduce_max_abs_err": err_r,
               "assign_reduce_max_rel_err": rel_r,
               "assign_max_abs_err": err1, "assign_max_rel_err": rel1,
               "match_max_abs_err": err2, "match_index_agreement": agree2,
               "chain_max_abs_err": err3, "chain_index_agreement": agree3,
               "chain_bit_identical": bitwise, "ok": ok}
        results.append(row)
        worst["assign_partial"] = max(worst["assign_partial"], err_p)
        worst["assign_reduce"] = max(worst["assign_reduce"], err_r)
        worst["match"] = max(worst["match"], err2)
        worst["chain"] = max(worst["chain"], err3)
        if not ok:
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"kernel case {name} disagrees with plain")

    # timings at the main-path shapes, bf16 features (what the model feeds)
    b, s, q, n = 8, 1, 1, 2601
    fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, torch.bfloat16)
    part = K._assign_partial_launch(fts, fg, bg, ctr, p)
    packed = K._assign_reduce_launch(part, b, s, plain.ASSIGN_EPS)
    pf, pb = packed[:, :p], packed[:, p:]
    t = {
        "assign_partial": time_ms(torch, lambda: K._assign_partial_launch(
            fts, fg, bg, ctr, p), flush),
        "assign_partial_plain": time_ms(torch, lambda: K.plain_assign_partial(
            fts, fg, bg, ctr, p), flush),
        "assign_reduce": time_ms(torch, lambda: K._assign_reduce_launch(
            part, b, s, plain.ASSIGN_EPS), flush),
        "assign_reduce_plain": time_ms(torch, lambda: K.plain_assign_reduce(
            part, b, s, plain.ASSIGN_EPS), flush),
        "assign": time_ms(torch, lambda: K._assign_launch(
            fts, fg, bg, ctr, p, plain.ASSIGN_EPS), flush),
        "assign_plain": time_ms(torch, lambda: plain.meta_prototype_assign(
            fts[:, :s], fg, bg, ctr, p), flush),
        "match": time_ms(torch, lambda: K._match_launch(
            fts, s, packed, p, scale, False), flush),
        "match_plain": time_ms(torch, lambda: plain.prototype_predictions(
            fts[:, s:], pf, pb, scale), flush),
        "chain": time_ms(torch, lambda: K.mpm_chain_packed(
            fts, fg, bg, ctr, p, scale), flush),
        "chain_plain": time_ms(torch, lambda: plain.prototype_predictions(
            fts[:, s:], *plain.meta_prototype_assign(
                fts[:, :s], fg, bg, ctr, p), scale), flush),
    }
    bounds = {k: bound_ms(*v)
              for k, v in work(b, s, q, n, c, p, 2, K.TILE).items()}
    emit({"phase": "kernels", "cases": results, "timing_shapes": {
        "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p, "dtype": "bfloat16"},
        "ms": t, "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
        "tolerance": {"proto_rtol": PROTO_RTOL, "logit_atol": LOGIT_ATOL,
                      "index_margin": MARGIN},
        "note": "assign = assign_partial + assign_reduce (K1); chain = "
                "K1 then match on the packed tensor (K3), no launch of "
                "its own"})
    return t, bounds, worst


def main_path_phase(torch, K):
    from unittest import mock

    from pemp_tpu_torch.core.evaluator import make_fast_eval_step
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.models import pemp_stage1 as stage1

    def plain_chain(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                    return_indices=False):
        s = sup_fg.shape[1]
        return stage1.mpm_predict(fts[:, :s], fts[:, s:], sup_fg, sup_bg,
                                  ctr, protos, dist_scalar, return_indices)

    K.reset_launches()
    t0 = time.perf_counter()
    result = entry.main(MAIN_ARGS)
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    if not math.isfinite(result["miou"]) or not math.isfinite(result["loss"]):
        raise AssertionError(f"main path result not finite: {result}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")

    # one batch through the model twice: kernels vs plain mpm
    cfg = entry.ex.assemble("test", dict(a.split("=", 1)
                                         for a in MAIN_ARGS[2:]))
    device = torch.device("cuda")
    model = entry.build_model(cfg, device)
    ds, loader, _ = datasets.load(cfg)
    ds.sample_tasks()
    batch = next(iter(loader))
    t = {k: torch.from_numpy(batch[k]).to(device)
         for k in ("sup_rgb", "sup_mask", "qry_rgb")}
    with torch.no_grad():
        lk = model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
        before = dict(K.launches)
        with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
            lp = model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain forward launched a kernel")
    want = (cfg.data.test_bs, cfg.query, cfg.data.height, cfg.data.width, 2)
    if tuple(lk.shape) != want or not torch.isfinite(lk).all():
        raise AssertionError(f"logits {tuple(lk.shape)} (want {want}) or "
                             "not finite")
    err = (lk - lp).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    if agree < MAIN_AGREE or err > LOGIT_ATOL:
        raise AssertionError(f"kernels vs plain mpm: argmax agreement "
                             f"{agree}, max abs err {err}")
    # steady state, after the entry run's warm-up: the whole eval step
    # (H2D, forward, resize, metrics, one fetch) on the host clock, and
    # the forward alone with the batch already on the card
    step = make_fast_eval_step(model, device)
    step_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(batch)
        step_s.append(time.perf_counter() - t0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: model(
            t["sup_rgb"], t["sup_mask"], t["qry_rgb"]), flush)
    step_ms = statistics.median(step_s) * 1e3
    breakdown = profile_batch(torch, model, t)
    emit({"phase": "main_path", "args": MAIN_ARGS, "result": result,
          "wall_s": wall, "episodes_per_s": result["fps"],
          "launches": launches, "logits_max_abs_err_vs_plain": err,
          "argmax_agreement_vs_plain": agree,
          "steady_step_ms": step_ms, "forward_ms": fwd_ms,
          "steady_episodes_per_s": cfg.data.test_bs / step_ms * 1e3,
          "profile": breakdown})
    return launches, result


def profile_batch(torch, model, t):
    """Device time of one batch by kernel (torch.profiler); empty when
    the profiler records no device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    # device-side events only: the aten ops above them repeat their time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    mpm = sum(dev_us(e) for e in events if "assign" in e.key
              or "match_kernel" in e.key)
    top = sorted(events, key=dev_us, reverse=True)[:10]
    return {"device_us_total": total, "mpm_kernels_us": mpm,
            "top": [{"kernel": e.key[:90], "us": dev_us(e),
                     "calls": e.count} for e in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pemp_tpu_torch.ops import prototypes as plain
    from pemp_tpu_torch.ops.kernels import build
    from pemp_tpu_torch.ops.kernels import mpm as K

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    info = build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for rec in info.values() for ln in rec["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    times, bounds, worst = kernel_phase(torch, K, plain)
    launches, _ = main_path_phase(torch, K)

    # one row per __global__ kernel; the chain (K3, mpm.py:342) is these
    # launches on the packed tensor and has none of its own
    rows = [("assign_partial", "pemp_tpu/ops/pallas/mpm.py:119"),
            ("assign_reduce", "pemp_tpu/ops/pallas/mpm.py:119"),
            ("match", "pemp_tpu/ops/pallas/mpm.py:249")]
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "pemp_tpu_torch/ops/kernels/csrc/mpm.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name],
         "plain_ms": times[f"{name}_plain"], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, replaces in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
