#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pemp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. It builds the port's CUDA kernels from the sources in the
checkout, holds each kernel against its plain PyTorch version on the card,
and drives the port's two paths at full width (PEMP stage 1, ResNet-50,
1-shot, 401x401 SYNTH episodes):

- eval: the ``test`` entry, 8 episodes a batch (``main_path``);
- training: the ``train`` entry with the cedt loss, 4 episodes a step, six
  steps, the online eval and the chained ``test`` (``train_path``);

and checks that each path went through the kernels and agrees with the
plain version. The phases ``minplus`` (the EDT kernel, bit-exact) and
``mpm_backward`` (the mpm autograd Function against autograd of the plain
composition) hold the training slice's pieces on their own.

Each phase prints one JSON line; then the kernel table, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero; without CUDA (or outside a
checkout) it fails before printing a result. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# fp32 adds or mins a second: the 67 TFLOP/s peak counts an FMA as two
# flops, and a min-plus term is an add and a min with no multiply to fuse
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
TIMING_ITERS = 30                # CUDA-event samples per timing (median)
# kernel vs plain tolerances (fp32 accumulation in another order):
PROTO_RTOL = 1e-3    # prototypes: max abs err <= PROTO_RTOL * max |plain|
LOGIT_ATOL = 2e-3    # logits (cosine x 20): max abs err
MARGIN = 1e-3        # argmax indices must agree where the top-two gap > MARGIN
MAIN_AGREE = 0.999   # main path: argmax agreement, kernels vs plain mpm
# mpm backward vs autograd of the plain chain: max abs err of a cotangent
# <= GRAD_RTOL * its largest magnitude (float32 sums in another order);
# a bf16 feature cotangent is rounded to bf16 on both sides, so one bf16
# ulp (2^-7 of the largest value) is allowed there
GRAD_RTOL = 1e-3
GRAD_RTOL_BF16 = 2.0 ** -7
# one f32 train step, kernels vs plain mpm: relative loss error, and the
# relative L2 error of every trainable gradient
TRAIN_LOSS_RTOL = 1e-5
# EDT distances on the card vs the CPU: the squared distances are
# bit-equal; the float32 square roots may differ by one ulp (2^-23)
EDT_SQRT_RTOL = 2.0 ** -23
TRAIN_GRAD_RTOL = 1e-3

MAIN_ARGS = ["test", "with", "split=0", "data.dataset=SYNTH",
             "data.height=401", "data.width=401", "shot=1", "query=1",
             "data.test_bs=8", "data.test_n=32", "te.epochs=1",
             "dev.precision=bf16", "seed=1234"]
TRAIN_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
              "data.height=401", "data.width=401", "shot=1", "query=1",
              "data.bs=4", "data.train_n=24", "tr.total_epochs=1",
              "data.test_bs=8", "data.test_n=16", "te.epochs=1", "loss=cedt",
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


def bound_ms(nbytes: float, ops: float, rate: float = FP32_FLOPS_PER_S):
    """(least ms, what bounds it): the larger of the bytes over the HBM
    rate and ``ops`` over ``rate`` (flops, or instructions for min-plus)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def minplus_bound(za, zb, m, k, n):
    """Bound of one min-plus launch out[z] = min_k a[z] + b[z] (za, zb: 1
    for a shared operand): a, b read once and out written once in fp32;
    an add and a min per (z, m, n, k) term at FP32_INSTR_PER_S."""
    z = max(za, zb)
    nbytes = 4 * (za * m * k + zb * k * n + z * m * n)
    return bound_ms(nbytes, 2 * z * m * n * k, FP32_INSTR_PER_S)


def mpm_backward_work(b, s, q, n, c, p, esize):
    """(bytes, flops) of MPMChainPacked's backward for fts and ctr: reads
    fts, the masks, ctr, the packed prototypes, the int32 indices and the
    logit cotangent once, writes the fts and ctr cotangents once; flops of
    its contractions (assign side: six [n,c]x[c,2p]-sized products per
    support image; match side: three [n,c]x[c,p]-sized per class and
    query image) and its elementwise passes over [n, c]."""
    nbytes = (2 * b * (s + q) * n * c * esize + 2 * b * s * n * 4
              + 2 * c * 2 * p * 4 + b * 2 * p * c * 4 + 2 * b * q * n * 2 * 4)
    flops = (b * s * (6 * 2 * n * c * 2 * p + 6 * n * c)
             + b * q * (2 * 3 * 2 * n * c * p + 6 * n * c))
    return nbytes, flops


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


def synth_labels(torch, height, width, n, split=0):
    """Query labels [n, H, W] (int32) of the first SYNTH training episodes."""
    import numpy as np

    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    cfg = entry.ex.assemble("train", {
        "split": str(split), "data.dataset": "SYNTH",
        "data.height": str(height), "data.width": str(width),
        "data.train_n": str(n)})
    ds, _, _ = datasets.load(cfg, "train")
    ds.sample_tasks()
    return torch.from_numpy(np.stack([ds.get_episode(i)["qry_msk"][0]
                                      for i in range(n)])).cuda()


def minplus_phase(torch):
    """The min-plus kernel against its plain version, bit for bit
    (torch.equal), and the EDT on the card against the CPU plain EDT."""
    from pemp_tpu_torch.ops import edt
    from pemp_tpu_torch.ops.kernels import minplus as M

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = []

    def check(name, a, b):
        got, want = M.minplus(a, b), M.plain_minplus(a, b)
        ok = bool(torch.equal(got, want))
        cases.append({"case": name, "a": list(a.shape), "b": list(b.shape),
                      "bit_equal": ok,
                      "max_abs_err": (got - want).abs().max().item()})
        if not ok:
            emit({"phase": "minplus", "failed": cases[-1]})
            raise AssertionError(f"minplus case {name} is not bit-equal")
        return got

    def src2(feature):
        return torch.where(feature, 0.0, edt.INF2).float().contiguous()

    def phases(name, feature):
        b, h, w = feature.shape
        g2 = check(f"{name}_phase1", edt.offsets_sq(h, "cuda"), src2(feature))
        check(f"{name}_phase2", g2.reshape(b * h, w).contiguous(),
              edt.offsets_sq(w, "cuda"))

    train_feat = edt.boundary_map(synth_labels(torch, 401, 401, 4))
    phases("train_401_b4", train_feat)
    for m, k, n in ((40, 37, 53), (33, 401, 65)):
        a = torch.randint(0, 2 ** 20, (m, k), generator=g, device="cuda")
        b = torch.randint(0, 2 ** 20, (k, n), generator=g, device="cuda")
        check(f"random_{m}x{k}x{n}", a.float(), b.float())
    empty = train_feat.clone()
    empty[2] = False                      # one map with no boundary at all
    phases("one_empty_401_b4", empty)
    phases("other_473_b8", edt.boundary_map(synth_labels(torch, 473, 473, 8)))
    # the squared EDT bit for bit across devices; the distances after
    # PyTorch's sqrt (its own elementwise kernel on each device) within
    # EDT_SQRT_RTOL
    edt2_equal = bool(torch.equal(edt.edt2(empty).cpu(), edt.edt2(empty.cpu())))
    d_card = edt.euclidean_distance_transform(empty).cpu()
    d_cpu = edt.euclidean_distance_transform(empty.cpu())
    sqrt_rel = ((d_card - d_cpu).abs() / d_cpu.clamp(min=1.0)).max().item()
    if not edt2_equal or sqrt_rel > EDT_SQRT_RTOL:
        raise AssertionError(f"EDT on the card vs the CPU plain EDT: squared "
                             f"bit-equal {edt2_equal}, distances rel err "
                             f"{sqrt_rel}")

    # timings at the train shapes: bs 4 x 1 query, 401^2
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b, h, w = train_feat.shape
    dh2, dw2, s2 = (edt.offsets_sq(h, "cuda"), edt.offsets_sq(w, "cuda"),
                    src2(train_feat))
    g2 = M.minplus(dh2, s2).reshape(b * h, w).contiguous()
    t = {"phase1": time_ms(torch, lambda: M._minplus_launch(dh2, s2), flush),
         "phase1_plain": time_ms(torch, lambda: M.plain_minplus(dh2, s2),
                                 flush),
         "phase2": time_ms(torch, lambda: M._minplus_launch(g2, dw2), flush),
         "phase2_plain": time_ms(torch, lambda: M.plain_minplus(g2, dw2),
                                 flush)}
    # phase 1: [H, H] shared x [B, H, W]; phase 2: one [B*H, W] x [W, W]
    bounds = {"phase1": minplus_bound(1, b, h, h, w),
              "phase2": minplus_bound(1, 1, b * h, w, w)}
    emit({"phase": "minplus", "cases": cases,
          "edt2_card_bit_equals_cpu": edt2_equal,
          "edt_card_vs_cpu_max_rel_err": sqrt_rel,
          "edt_card_vs_cpu_equal": bool(torch.equal(d_card, d_cpu)),
          "timing_shapes": {"B": b, "H": h, "W": w}, "ms": t,
          "bound_ms": {k: v[0] for k, v in bounds.items()},
          "bound_by": {k: v[1] for k, v in bounds.items()},
          "tolerance": "bit-equal (torch.equal)"})
    return t, bounds


def mpm_backward_phase(torch, K, plain):
    """MPMChainPacked's cotangents of fts and ctr (kernels forward,
    analytic backward) against autograd of the plain chain, at the train
    shapes; both backwards timed."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b, s, q, n, c, p, scale = 4, 1, 1, 2601, 512, 3, 20.0
    rows, times, worst = [], {}, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, dtype, seed=3)
        g = torch.randn(b, q, n, 2, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
        fk, ck = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
        fp, cp = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
        lk = K.MPMChainPacked.apply(fk, fg, bg, ck, p, scale, plain.ASSIGN_EPS)
        pf, pb = plain.meta_prototype_assign(fp[:, :s], fg, bg, cp, p)
        lp = plain.prototype_predictions(fp[:, s:], pf, pb, scale)
        gk = torch.autograd.grad(lk, (fk, ck), g, retain_graph=True)
        gp = torch.autograd.grad(lp, (fp, cp), g, retain_graph=True)
        errs = [(a.float() - b_.float()).abs().max().item() for a, b_ in
                zip(gk, gp)]
        rels = [e / b_.float().abs().max().item() for e, b_ in zip(errs, gp)]
        with torch.no_grad():
            _, ki = K.mpm_chain_packed(fts, fg, bg, ctr, p, scale, True)
            _, pi = plain.prototype_predictions(fts[:, s:], pf.detach(),
                                                pb.detach(), scale, True)
            margin = top2_margin(torch, fts[:, s:], pf, pb, scale)
        agree, sure = index_agreement(ki, pi, margin)
        name = str(dtype).replace("torch.", "")
        ok = (rels[0] <= (GRAD_RTOL_BF16 if dtype == torch.bfloat16
                          else GRAD_RTOL) and rels[1] <= GRAD_RTOL and sure
              and bool(torch.isfinite(gk[0]).all()))
        row = {"dtype": name, "fts_grad_max_abs_err": errs[0],
               "fts_grad_max_rel_err": rels[0], "ctr_grad_max_abs_err": errs[1],
               "ctr_grad_max_rel_err": rels[1], "index_agreement": agree,
               "ok": ok}
        rows.append(row)
        worst = max(worst, *errs)
        if not ok:
            emit({"phase": "mpm_backward", "failed": row})
            raise AssertionError(f"mpm backward ({name}) disagrees with plain")
        times[name] = time_ms(torch, lambda: torch.autograd.grad(
            lk, (fk, ck), g, retain_graph=True), flush)
        times[f"{name}_plain"] = time_ms(torch, lambda: torch.autograd.grad(
            lp, (fp, cp), g, retain_graph=True), flush)
    bound = bound_ms(*mpm_backward_work(b, s, q, n, c, p, 2))
    emit({"phase": "mpm_backward", "cases": rows, "timing_shapes": {
        "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p}, "ms": times,
        "bound_ms_bf16": bound[0], "bound_by": bound[1],
        "tolerance": {"grad_rtol": GRAD_RTOL, "bf16_fts_grad_rtol":
                      GRAD_RTOL_BF16, "index_margin": MARGIN}})
    return times, bound, worst


def device_profile(torch, fn, names):
    """Device time of one call of ``fn`` by kernel (torch.profiler): the
    total, the share of each group in ``names`` ({group: [substrings]})
    and the top 10."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    out = {"device_us_total": total}
    for group, keys in names.items():
        us = sum(dev_us(e) for e in events if any(k in e.key for k in keys))
        out[f"{group}_us"] = us
        out[f"{group}_share"] = us / total if total else 0.0
    out["top"] = [{"kernel": e.key[:90], "us": dev_us(e), "calls": e.count}
                  for e in sorted(events, key=dev_us, reverse=True)[:10]]
    return out


def train_path_phase(torch, K, M):
    """The ``train`` entry at full width (6 steps, online eval, chained
    test), its launches and checkpoints; the steady train step; one f32
    step with the kernels against the same step with the plain mpm."""
    from unittest import mock

    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.core import losses as loss_lib
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.models import pemp_stage1 as stage1

    device = torch.device("cuda")
    overrides = dict(a.split("=", 1) for a in TRAIN_ARGS[2:])
    with tempfile.TemporaryDirectory() as tmp:
        K.reset_launches()
        M.reset_launches()
        t0 = time.perf_counter()
        result = entry.main(TRAIN_ARGS + [f"g.model_dir={tmp}"])
        wall = time.perf_counter() - t0
        launches = {**K.launches, **M.launches, **K.backward_calls}
        run_dir = Path(tmp) / "pemp_stage1" / str(result["train"]["run_id"])
        files = sorted(p.name for p in run_dir.iterdir())
        final = ckpt_lib.load(run_dir / ckpt_lib.CKPT)["model"]

    cfg = entry.ex.assemble("train", overrides)
    losses = result["train"]["losses"]
    steps = len(losses)
    evals = 2 * -(-cfg.data.test_n // cfg.data.test_bs) * cfg.te.epochs
    want = {"assign_partial": steps + evals, "assign_reduce": steps + evals,
            "match": steps + evals, "minplus": 2 * steps,
            "mpm_backward": steps}
    if steps != cfg.data.train_n // cfg.data.bs or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if launches != want:
        raise AssertionError(f"train path launches {launches}, want {want}")
    if not {ckpt_lib.CKPT, ckpt_lib.BEST} <= set(files):
        raise AssertionError(f"run dir holds {files}")
    if not math.isfinite(result["test"]["miou"]):
        raise AssertionError(f"chained test {result['test']}")
    # frozen backbone BN: affine bit-identical, running stats moved
    init = entry.build_model(cfg, torch.device("cpu")).state_dict()
    bn = [k[:-len(".running_mean")] for k in init
          if k.startswith("encoder.backbone.") and k.endswith("running_mean")]
    affine_same = all(torch.equal(init[f"{k}.{w}"], final[f"{k}.{w}"])
                      for k in bn for w in ("weight", "bias"))
    stats_moved = all(not torch.equal(init[f"{k}.running_mean"],
                                      final[f"{k}.running_mean"]) for k in bn)
    ctr_moved = not torch.equal(init["ctr"], final["ctr"])
    if not (affine_same and stats_moved and ctr_moved):
        raise AssertionError(f"frozen BN affine unchanged {affine_same}, "
                             f"running stats moved {stats_moved}, ctr "
                             f"moved {ctr_moved}")

    # steady train step (bf16 backbone, as the entry ran): host clock
    model = entry.build_model(cfg, device).train()
    params = model.freeze()
    opt = solver.make_optimizer(cfg.tr, params)
    trainer = Trainer(cfg, Run(None, None), model, opt, params,
                      loss_lib.get(cfg), solver.LRPolicy(cfg.tr, 100), device)
    model.set_dropout_generator(torch.Generator(device=device).manual_seed(0))
    ds, loader, _ = datasets.load(cfg, "train")
    ds.sample_tasks()
    batch = next(iter(loader))
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_ms = statistics.median(step_s) * 1e3
    prof = device_profile(torch, lambda: trainer.train_step(batch), {
        "mpm_kernels": ["assign_partial", "assign_reduce", "match_kernel"],
        "minplus_kernel": ["minplus_kernel"]})
    del trainer, opt, params, model

    # one f32 step twice (TF32 off): kernels vs the plain mpm chain
    def plain_chain(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                    return_indices=False):
        s = sup_fg.shape[1]
        return stage1.mpm_predict(fts[:, :s], fts[:, s:], sup_fg, sup_bg,
                                  ctr, protos, dist_scalar, return_indices)

    cfg32 = entry.ex.assemble("train", {**overrides, "dev.precision": "f32"})
    base = entry.build_model(cfg32, device).train()
    base.freeze()
    t = {k: torch.from_numpy(batch[k]).to(device)
         for k in ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")}
    loss_fn = loss_lib.get(cfg32)

    def grads(model):
        model.set_dropout_generator(
            torch.Generator(device=device).manual_seed(7))
        logits = model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
        loss = loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                       t["qry_msk"].reshape(-1, *t["qry_msk"].shape[-2:]))
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in
                             model.named_parameters() if p.requires_grad}

    kernel_model, plain_model = base, copy.deepcopy(base)
    before = dict(K.launches)
    loss_k, grads_k = grads(kernel_model)
    if K.launches == before:
        raise AssertionError("the kernel train step launched no mpm kernel")
    before = dict(K.launches)
    with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
        loss_p, grads_p = grads(plain_model)
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain train step launched an mpm kernel")
    rel = {k: ((grads_k[k] - grads_p[k]).norm()
               / grads_p[k].norm().clamp(min=1e-30)).item() for k in grads_p}
    worst_leaf = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if loss_rel > TRAIN_LOSS_RTOL or rel[worst_leaf] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"f32 step kernels vs plain: loss rel "
                             f"{loss_rel}, worst grad {worst_leaf} "
                             f"rel L2 {rel[worst_leaf]}")
    emit({"phase": "train_path", "args": TRAIN_ARGS, "wall_s": wall,
          "steps": steps, "losses": losses, "launches": launches,
          "launches_expected": want, "run_files": files,
          "best_iou": result["train"]["best_iou"], "test": result["test"],
          "backbone_bn_affine_unchanged": affine_same,
          "backbone_bn_running_stats_moved": stats_moved,
          "ctr_moved": ctr_moved,
          "f32_step_vs_plain": {"loss_kernels": loss_k, "loss_plain": loss_p,
                                "loss_rel_err": loss_rel,
                                "grad_max_rel_l2": rel[worst_leaf],
                                "grad_worst_leaf": worst_leaf,
                                "grad_leaves": len(rel),
                                "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                                              "grad_rel_l2": TRAIN_GRAD_RTOL}},
          "steady_step_ms": step_ms,
          "steady_episodes_per_s": cfg.data.bs / step_ms * 1e3,
          "profile": prof})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pemp_tpu_torch.ops import prototypes as plain
    from pemp_tpu_torch.ops.kernels import build
    from pemp_tpu_torch.ops.kernels import minplus as M
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
    mp_times, mp_bounds = minplus_phase(torch)
    bw_times, bw_bound, bw_worst = mpm_backward_phase(torch, K, plain)
    train_launches = train_path_phase(torch, K, M)

    # one row per __global__ kernel; the chain (K3, mpm.py:342) is these
    # launches on the packed tensor and has none of its own. The mpm rows'
    # launches are the eval path's (their slice), train_path_launches the
    # training path's. minplus: one EDT = its two launches (ms, plain_ms
    # and bound_ms add both phases at the train shapes). mpm_backward is
    # the K4 backward: PyTorch ops on the card, as the JAX package's is
    # jnp; its launches are the training path's backward passes.
    rows = [("assign_partial", "pemp_tpu/ops/pallas/mpm.py:119"),
            ("assign_reduce", "pemp_tpu/ops/pallas/mpm.py:119"),
            ("match", "pemp_tpu/ops/pallas/mpm.py:249")]
    table = [
        {"name": name, "route": "cuda",
         "source": "pemp_tpu_torch/ops/kernels/csrc/mpm.cu",
         "replaces": replaces, "launches": launches[name],
         "train_path_launches": train_launches[name],
         "max_abs_err": worst[name], "ms": times[name],
         "plain_ms": times[f"{name}_plain"], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, replaces in rows]
    table.append({
        "name": "minplus", "route": "cuda",
        "source": "pemp_tpu_torch/ops/kernels/csrc/minplus.cu",
        "replaces": "pemp_tpu/ops/pallas/minplus.py:47",
        "launches": train_launches["minplus"], "max_abs_err": 0.0,
        "ms": mp_times["phase1"] + mp_times["phase2"],
        "plain_ms": mp_times["phase1_plain"] + mp_times["phase2_plain"],
        "bound_ms": mp_bounds["phase1"][0] + mp_bounds["phase2"][0],
        "bound_by": "operations", "library_ms": None,
        "library_note": "no PyTorch call computes a min-plus product"})
    table.append({
        "name": "mpm_backward", "route": "cuda",
        "source": "pemp_tpu_torch/ops/kernels/mpm.py",
        "replaces": "pemp_tpu/ops/pallas/mpm_vjp.py:216",
        "launches": train_launches["mpm_backward"],
        "max_abs_err": bw_worst, "ms": bw_times["bfloat16"],
        "plain_ms": bw_times["bfloat16_plain"], "bound_ms": bw_bound[0],
        "bound_by": bw_bound[1], "library_ms": None,
        "note": "MPMChainPacked.backward: PyTorch ops, no kernel of its own"})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
