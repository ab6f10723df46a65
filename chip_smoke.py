#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pemp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. It builds the port's CUDA kernels from the sources in the
checkout, holds each kernel against its plain PyTorch version on the card,
and drives the port's paths at full width (ResNet-50, 1-shot, 401x401
SYNTH episodes):

- eval: PEMP stage 1's ``test`` entry, 8 episodes a batch (``main_path``);
- training: stage 1's ``train`` entry with the cedt loss, 4 episodes a
  step, six steps, the online eval and the chained ``test``
  (``train_path``);
- the stage-2 cascade: ``pemp_stage2``'s ``train`` entry (ResNetCM and
  PurifierV1 behind a frozen, seed-initialised stage 1, cedt, lr 0.0035),
  six steps, the online eval and the chained ``test``, with the f32 step
  and one eval batch held against the plain mpm (``stage2_path``);
- PEMP with ``net.backbone=vgg16``: both stages' ``train`` entries (VGG16,
  then VGG16CM behind that run's stage 1, clip 1.1), their launches per
  step and per eval batch, the kernels on the VGG features, one eval
  batch of each stage and one f32 step against the plain mpm
  (``vgg_path``);
- Baseline and PANet (VGG16): their ``train`` entries, which launch no
  kernel, and their steady steps (``baseline_path``, ``panet_path``);
- CaNet (321x321, two epochs of three steps: the history store holds one
  entry per epoch-1 query, the epoch-2 episodes that read a history are
  exactly those the host predicts from the reset draws, the chained test
  starts from an empty store; the write-back's cost), RPMMs (481x481:
  eval repeatable bit for bit, three finite outputs) and PFENet (473x473:
  no trunk gradient, the trunk's BN statistics move, every head
  gradient finite), which launch no kernel (``canet_path``,
  ``rpmms_path``, ``pfenet_path``);

and checks that each path went through the kernels and agrees with the
plain version. The phases ``minplus`` (the EDT kernel, bit-exact, also on
non-integer input) and ``mpm_backward`` (the mpm autograd Function's two
backward kernels against the plain backward on the card and against
autograd of the plain composition) hold the training slice's pieces on
their own. ``kernels`` also holds the assign kernel above 512 channels
(column passes) and the match kernel where no row ring fits (c=4096), and
times the assign kernel at the eval and train shapes, at p=8 and, with
four shots, its cost per extra row (the match kernel's too, with four
queries); ``minplus`` also times one 2048^3
product (the kernel's sustained rate); the train profile names the
convolutions behind cuDNN's fallback kernels by input shape.

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
import re
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
SPIN_CYCLES = 400_000            # ~0.2 ms at 1.98 GHz: covers the host's enqueue
# ~2 ms: covers the enqueue of a call of many ops (the mpm backward and its
# plain versions), so the events time its device work alone
LONG_SPIN_CYCLES = 4_000_000
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

# cuDNN's fallback convolution kernels at the top of the train step's
# profile, whose convolutions the profile names by input shape
CONV_FALLBACK = ("dgrad_engine", "wgrad_alg1_engine")

MAIN_ARGS = ["test", "with", "split=0", "data.dataset=SYNTH",
             "data.height=401", "data.width=401", "shot=1", "query=1",
             "data.test_bs=8", "data.test_n=32", "te.epochs=1",
             "dev.precision=bf16", "seed=1234"]
STAGE2_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
               "data.height=401", "data.width=401", "shot=1", "query=1",
               "data.bs=4", "data.train_n=24", "tr.total_epochs=1",
               "data.test_bs=8", "data.test_n=16", "te.epochs=1",
               "loss=cedt", "tr.lr=0.0035", "net.backbone=resnet50",
               "net.backbone2=resnet50", "net.cm=True", "dev.precision=bf16",
               "seed=1234"]
TRAIN_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
              "data.height=401", "data.width=401", "shot=1", "query=1",
              "data.bs=4", "data.train_n=24", "tr.total_epochs=1",
              "data.test_bs=8", "data.test_n=16", "te.epochs=1", "loss=cedt",
              "dev.precision=bf16", "seed=1234"]
# the VGG16 family: both PEMP stages with net.backbone=vgg16 (stage 2
# behind the stage-1 run, clip 1.1), scripts/baseline.sh's step (batch 4,
# lr 1e-3, ce) and scripts/panet.sh's (batch 1, lr 1e-3, ce + align), each
# cut to six steps and one epoch
VGG1_ARGS = TRAIN_ARGS + ["net.backbone=vgg16"]
VGG2_ARGS = [a for a in STAGE2_ARGS if not a.startswith("net.")] + [
    "net.backbone=vgg16", "net.backbone2=vgg16"]
BASELINE_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
                 "data.height=401", "data.width=401", "shot=1", "query=1",
                 "data.bs=4", "data.train_n=24", "tr.total_epochs=1",
                 "tr.lr=0.001", "data.test_bs=8", "data.test_n=16",
                 "te.epochs=1", "net.backbone=vgg16", "dev.precision=bf16",
                 "seed=1234"]
PANET_ARGS = [a for a in BASELINE_ARGS if not a.startswith(
    ("data.bs=", "data.train_n="))] + ["data.bs=1", "data.train_n=6"]
# CaNet, RPMMs and PFENet at their scripts' sizes and learning rates
# (scripts/{canet,rpmms,pfenet}.sh), batch 4, ce, 1-shot; CaNet two epochs
# of three steps, so that epoch 2 reads the history epoch 1 wrote
ZOO_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH", "shot=1",
            "query=1", "data.bs=4", "data.test_bs=8", "data.test_n=16",
            "te.epochs=1", "loss=ce", "dev.precision=bf16", "seed=1234"]
CANET_ARGS = ZOO_ARGS + ["data.height=321", "data.width=321", "tr.lr=0.0025",
                         "data.train_n=12", "tr.total_epochs=2"]
RPMMS_ARGS = ZOO_ARGS + ["data.height=481", "data.width=481", "tr.lr=0.0035",
                         "data.train_n=24", "tr.total_epochs=1"]
PFENET_ARGS = ZOO_ARGS + ["data.height=473", "data.width=473",
                          "tr.lr=0.0025", "data.train_n=24",
                          "tr.total_epochs=1"]
# K1-K5's launches per train step and per eval batch of one mpm chain
STEP_LAUNCHES = {"assign": 1, "match": 1, "match_bwd": 1, "assign_bwd": 1,
                 "minplus": 2}
EVAL_LAUNCHES = {"assign": 1, "match": 1, "match_bwd": 0, "assign_bwd": 0,
                 "minplus": 0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def ptxas_summary(log: str):
    """One line per kernel instance from nvcc's ``-Xptxas -v`` log: its
    name and template arguments (from the mangled name), registers and
    spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)(?:I(\w+?)(?:Li(\d+)E)?E)?",
                          m.group(1))
            name = (f"{k.group(1)}<{k.group(2) or ''},{k.group(3) or ''}>"
                    if k else m.group(1)[:60])
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name = None
    return out


def time_ms(torch, fn, flush, spin: bool = True,
            spin_cycles: int = SPIN_CYCLES) -> float:
    """Median CUDA-event time of ``fn`` over TIMING_ITERS launches, each
    after a write of ``flush`` (> L2) so the inputs come from HBM. With
    ``spin``, a device-side spin of ``spin_cycles`` keeps the device busy
    until the host has enqueued ``fn``: the events time the device's
    work, not the host's dispatch of it. Without, they time what a caller
    waits when the device is idle, dispatch included."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMING_ITERS):
        flush.zero_()
        if spin:
            torch.cuda._sleep(spin_cycles)
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


def mpm_backward_work(b, s, q, n, c, p, esize, partial_bytes=0):
    """(bytes, flops) of MPMChainPacked's backward for fts and ctr: reads
    fts, the masks, ctr, the packed prototypes, the int32 indices, the
    logit cotangent and the forward's saved assign partials
    (``partial_bytes``) once, writes the fts and ctr cotangents once;
    flops of its contractions (assign side: six [n,c]x[c,2p]-sized
    products per support image; match side: three [n,c]x[c,p]-sized per
    class and query image) and its elementwise passes over [n, c]."""
    nbytes = (2 * b * (s + q) * n * c * esize + 2 * b * s * n * 4
              + 2 * c * 2 * p * 4 + b * 2 * p * c * 4 + 2 * b * q * n * 2 * 4
              + partial_bytes)
    flops = (b * s * (6 * 2 * n * c * 2 * p + 6 * n * c)
             + b * q * (2 * 3 * 2 * n * c * p + 6 * n * c))
    return nbytes, flops


def work(b, s, q, n, c, p, esize):
    """(bytes, flops) of each kernel and of the chain, for calls that write
    no indices: each input read once, each output written once (the assign
    kernel's scratch is not part of its function); flops of |f|^2, the
    2p-column products, a^T f and the finish."""
    k2 = 2 * p
    masks, ctr = 2 * b * s * n * 4, c * k2 * 4
    protos, logits = b * k2 * c * 4, b * q * n * 2 * 4
    f1 = b * s * n * (2 * c + 4 * c * k2) + 2 * b * s * k2 * c
    f2 = b * q * n * (2 * c + 2 * c * k2)
    return {
        "assign": (b * s * n * c * esize + masks + ctr + protos, f1),
        "match": (b * q * n * c * esize + protos + logits, f2),
        "chain": (b * (s + q) * n * c * esize + masks + ctr + logits,
                  f1 + f2),
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


def check_kernels(torch, K, plain, name, fts, fg, bg, ctr, p, scale):
    """K1, K2 and the K3 chain on ``fts`` [B, S+Q, n, c] against their
    plain versions: K1's prototypes within PROTO_RTOL of their largest
    magnitude, the logits within LOGIT_ATOL, the indices equal wherever the
    plain top-two margin exceeds MARGIN, the chain bit-identical over three
    back-to-back runs (each assign launch leaves its tickets at zero)."""
    b, s = fg.shape[:2]
    n, c = fts.shape[2:]
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
    runs = [K.mpm_chain_packed(fts, fg, bg, ctr, p, scale,
                               return_indices=True) for _ in range(3)]
    cl, ci = runs[0]
    bitwise = all(torch.equal(cl, l2) and torch.equal(ci, i2)
                  for l2, i2 in runs[1:])
    err3 = (cl - pl).abs().max().item()
    agree3, sure3 = index_agreement(ci, pi, margin)
    torch.cuda.synchronize()
    ok = (finite1 and rel1 <= PROTO_RTOL and err2 <= LOGIT_ATOL
          and sure2 and err3 <= LOGIT_ATOL and sure3 and bitwise)
    return {"case": name, "B": b, "S": s, "Q": fts.shape[1] - s, "n": n,
            "c": c, "p": p, "dtype": str(fts.dtype).replace("torch.", ""),
            "assign_max_abs_err": err1, "assign_max_rel_err": rel1,
            "match_max_abs_err": err2, "match_index_agreement": agree2,
            "chain_max_abs_err": err3, "chain_index_agreement": agree3,
            "chain_bit_identical_x3": bitwise, "ok": ok}


def kernel_phase(torch, K, plain):
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    scale, eps = 20.0, plain.ASSIGN_EPS
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (name, B, S, Q, n, c, p, dtype, far)
        ("main_bf16", 8, 1, 1, 2601, 512, 3, bf16, False),
        ("main_f32", 8, 1, 1, 2601, 512, 3, f32, False),
        ("train_bf16", 4, 1, 1, 2601, 512, 3, bf16, False),
        ("shot5_bf16", 8, 5, 1, 2601, 512, 3, bf16, False),
        ("shot5_f32", 8, 5, 1, 2601, 512, 3, f32, False),
        ("n1030_bf16", 8, 1, 1, 1030, 512, 3, bf16, False),
        ("n1030_f32", 8, 2, 1, 1030, 512, 3, f32, False),
        ("far_ctr_f32", 2, 1, 1, 2601, 512, 3, f32, True),
        ("far_ctr_bf16", 2, 1, 1, 1030, 512, 3, bf16, True),
        ("p1_bf16", 8, 1, 1, 2601, 512, 1, bf16, False),
        ("p8_bf16", 8, 1, 1, 2601, 512, 8, bf16, False),
        ("p8_f32", 4, 2, 1, 1030, 512, 8, f32, False),
        # more than 512 channels: column passes (1512 bf16 at two stages)
        ("c1024_bf16", 4, 1, 1, 2601, 1024, 3, bf16, False),
        ("c768_f32", 2, 2, 1, 1030, 768, 3, f32, False),
        ("c1512_bf16", 2, 1, 1, 1030, 1512, 3, bf16, False),
    ]
    results = []
    worst = {"assign": 0.0, "match": 0.0, "chain": 0.0}
    for name, b, s, q, n, c, p, dtype, far in cases:
        fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, dtype, far)
        row = check_kernels(torch, K, plain, name, fts, fg, bg, ctr, p, scale)
        results.append(row)
        worst["assign"] = max(worst["assign"], row["assign_max_abs_err"])
        worst["match"] = max(worst["match"], row["match_max_abs_err"])
        worst["chain"] = max(worst["chain"], row["chain_max_abs_err"])
        if not row["ok"]:
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"kernel case {name} disagrees with plain")
    # the match kernel where no row ring fits beside its table (c=4096):
    # each lane reads its chunks from device memory
    for name, b, s, q, n, c, p, dtype in (
            ("match_c4096_bf16", 4, 1, 1, 1030, 4096, 3, bf16),):
        fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, dtype)
        pf, pb = plain.meta_prototype_assign(fts[:, :s], fg, bg, ctr, p)
        kl, ki = K.mpm_match(fts, s, pf, pb, scale, return_indices=True)
        pl, pi = plain.prototype_predictions(fts[:, s:], pf, pb, scale, True)
        err2 = (kl - pl).abs().max().item()
        agree2, sure2 = index_agreement(
            ki, pi, top2_margin(torch, fts[:, s:], pf, pb, scale))
        row = {"case": name, "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p,
               "dtype": str(dtype).replace("torch.", ""),
               "match_max_abs_err": err2, "match_index_agreement": agree2,
               "match_plan": K._plans[("match", fts.device, c, p, 1)],
               "ok": err2 <= LOGIT_ATOL and sure2}
        results.append(row)
        worst["match"] = max(worst["match"], err2)
        if not row["ok"]:
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"kernel case {name} disagrees with plain")
    # every launch left its tickets at zero
    torch.cuda.synchronize()
    tickets = sum(int(t.abs().sum()) for t in K._ticket_bufs.values())
    if tickets:
        raise AssertionError(f"assign tickets not reset: sum {tickets}")

    # timings, bf16 features (what the model feeds): the eval shapes (B=8)
    # and, for assign, the train shapes (B=4) and p=8
    c, s, q, n, p = 512, 1, 1, 2601, 3
    t, bounds = {}, {}
    for b, tag in ((8, ""), (4, "_train")):
        fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, bf16)
        t[f"assign{tag}"] = time_ms(torch, lambda: K._assign_launch(
            fts, fg, bg, ctr, p, eps), flush)
        t[f"assign{tag}_plain"] = time_ms(
            torch, lambda: plain.meta_prototype_assign(
                fts[:, :s], fg, bg, ctr, p), flush)
        bounds[f"assign{tag}"] = bound_ms(*work(b, s, q, n, c, p, 2)["assign"])
    fts, fg, bg, ctr = make_inputs(torch, 8, s, q, n, c, 8, bf16)
    t["assign_p8"] = time_ms(torch, lambda: K._assign_launch(
        fts, fg, bg, ctr, 8, eps), flush)
    t["assign_p8_plain"] = time_ms(torch, lambda: plain.meta_prototype_assign(
        fts[:, :s], fg, bg, ctr, 8), flush)
    bounds["assign_p8"] = bound_ms(*work(8, s, q, n, c, 8, 2)["assign"])
    # four shots: the same 128 blocks with four times the rows each, so
    # the difference to one shot is the kernel's cost per extra row
    fts, fg, bg, ctr = make_inputs(torch, 8, 4, q, n, c, p, bf16)
    t["assign_s4"] = time_ms(torch, lambda: K._assign_launch(
        fts, fg, bg, ctr, p, eps), flush)
    t["assign_s4_plain"] = time_ms(torch, lambda: plain.meta_prototype_assign(
        fts[:, :4], fg, bg, ctr, p), flush)
    bounds["assign_s4"] = bound_ms(*work(8, 4, q, n, c, p, 2)["assign"])
    extra = work(8, 4, q, n, c, p, 2)["assign"][0] - work(
        8, s, q, n, c, p, 2)["assign"][0]
    marginal = extra / ((t["assign_s4"] - t["assign"]) * 1e-3)
    b = 8
    fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, bf16)
    slots = K._assign_plan(K._lib(), fts.device, c, p, 1)[1]
    packed = K._assign_launch(fts, fg, bg, ctr, p, eps)
    pf, pb = packed[:, :p], packed[:, p:]
    t.update({
        "match": time_ms(torch, lambda: K._match_launch(
            fts, s, packed, p, scale, False), flush),
        "match_plain": time_ms(torch, lambda: plain.prototype_predictions(
            fts[:, s:], pf, pb, scale), flush),
        "chain": time_ms(torch, lambda: K.mpm_chain_packed(
            fts, fg, bg, ctr, p, scale), flush),
        "chain_plain": time_ms(torch, lambda: plain.prototype_predictions(
            fts[:, s:], *plain.meta_prototype_assign(
                fts[:, :s], fg, bg, ctr, p), scale), flush),
    })
    w = work(b, s, q, n, c, p, 2)
    bounds.update({k: bound_ms(*w[k]) for k in ("match", "chain")})
    # four query images: about the same blocks with four times the rows,
    # so the difference to one query is the match kernel's cost per row
    fts, fg, bg, ctr = make_inputs(torch, b, s, 4, n, c, p, bf16)
    packed = K._assign_launch(fts, fg, bg, ctr, p, eps)
    t["match_q4"] = time_ms(torch, lambda: K._match_launch(
        fts, s, packed, p, scale, False), flush)
    t["match_q4_plain"] = time_ms(torch, lambda: plain.prototype_predictions(
        fts[:, s:], packed[:, :p], packed[:, p:], scale), flush)
    bounds["match_q4"] = bound_ms(*work(b, s, 4, n, c, p, 2)["match"])
    extra = work(b, s, 4, n, c, p, 2)["match"][0] - w["match"][0]
    match_marginal = extra / ((t["match_q4"] - t["match"]) * 1e-3)
    emit({"phase": "kernels", "cases": results, "timing_shapes": {
        "B": [8, 4], "S": s, "Q": q, "n": n, "c": c, "p": p,
        "dtype": "bfloat16"},
        "assign_grid": {tag: K.assign_grid(n, imgs, slots)
                        for tag, imgs in (("eval", 8), ("train", 4),
                                          ("eval_s4", 32))},
        "match_plan_eval": K._plans[("match", fts.device, c, p, 1)],
        "assign_marginal_bytes_per_s": marginal,
        "match_marginal_bytes_per_s": match_marginal,
        "ms": t,
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
        "tolerance": {"proto_rtol": PROTO_RTOL, "logit_atol": LOGIT_ATOL,
                      "index_margin": MARGIN},
        "note": "assign = K1, one launch (B=8 eval, _train B=4, _s4 B=8 "
                "with 4 shots, _p8 B=8 at p=8); match = K2 (_q4: B=8 "
                "with 4 queries); *_marginal_bytes_per_s = the extra "
                "bytes of 4 shots (queries) over 1 by the extra time; "
                "chain = K1 "
                "then match on the packed tensor (K3), no launch of its "
                "own"})
    return t, bounds, worst


def plain_chain(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                return_indices=False):
    """The plain mpm in place of ``mpm_chain_packed`` (patched into
    ``models.pemp_stage1``, whose ``predict`` both PEMP stages use)."""
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    s = sup_fg.shape[1]
    return stage1.mpm_predict(fts[:, :s], fts[:, s:], sup_fg, sup_bg, ctr,
                              protos, dist_scalar, return_indices)


def host_ms(torch, fn, warm=3, n=10):
    """Median host-clock ms of ``fn`` ending in a synchronize, after
    ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e3


def main_path_phase(torch, K):
    from unittest import mock

    from pemp_tpu_torch.core.evaluator import make_fast_eval_step
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.models import pemp_stage1 as stage1

    K.reset_launches()
    t0 = time.perf_counter()
    result = entry.main(MAIN_ARGS)
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    if not math.isfinite(result["miou"]) or not math.isfinite(result["loss"]):
        raise AssertionError(f"main path result not finite: {result}")
    if (min(launches["assign"], launches["match"]) <= 0
            or launches["match_bwd"] or launches["assign_bwd"]):
        raise AssertionError(f"main path launches {launches}")

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
    mpm = sum(dev_us(e) for e in events if "assign_kernel" in e.key
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
    # any fp32 input, not only the EDT's integers: random non-integers of
    # both signs, K off the chunk (16) and the split (4 slices)
    for k in (1, 31, 33, 473):
        a = torch.randn(401, k, generator=g, device="cuda") * 1e3
        b = torch.randn(3, k, 401, generator=g, device="cuda") * 1e-2 - 0.5
        check(f"nonint_401x{k}x401_b3", a, b)
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
    # the kernel's sustained rate on a product large enough that edges and
    # waves do not count (no plain version at this size)
    big = torch.randn(2, 2048, 2048, generator=g, device="cuda")
    t["large_2048"] = time_ms(torch, lambda: M._minplus_launch(big[0], big[1]),
                              flush)
    bounds["large_2048"] = minplus_bound(1, 1, 2048, 2048, 2048)
    emit({"phase": "minplus", "cases": cases,
          "edt2_card_bit_equals_cpu": edt2_equal,
          "edt_card_vs_cpu_max_rel_err": sqrt_rel,
          "edt_card_vs_cpu_equal": bool(torch.equal(d_card, d_cpu)),
          "timing_shapes": {"B": b, "H": h, "W": w}, "ms": t,
          "bound_ms": {k: v[0] for k, v in bounds.items()},
          "bound_by": {k: v[1] for k, v in bounds.items()},
          "share_of_bound": {k: bounds[k][0] / t[k] for k in bounds},
          "tolerance": "bit-equal (torch.equal)"})
    return t, bounds


def mpm_backward_phase(torch, K, plain):
    """MPMChainPacked's backward (the match_bwd and assign_bwd kernels)
    against the plain backward on the card (``_match_backward`` then
    ``_assign_backward``, PyTorch ops, from the forward's prototypes and
    indices) and against autograd of the plain chain: at the train shapes
    in bf16 and f32, with S=Q=2 at n=1030 (a partial last stage) and at
    c=1024 (two column passes); two calls bit-identical, each launching
    both kernels once, the tickets back at 0. Timed at the train shapes
    with a long device spin (LONG_SPIN_CYCLES: its device work, however
    long the host takes to enqueue it) and without (what the step waits),
    beside the plain backward and autograd of the plain chain."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    scale, eps = 20.0, plain.ASSIGN_EPS
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (name, B, S, Q, n, c, p, dtype)
        ("train_bf16", 4, 1, 1, 2601, 512, 3, bf16),
        ("train_f32", 4, 1, 1, 2601, 512, 3, f32),
        ("s2q2_n1030_bf16", 4, 2, 2, 1030, 512, 3, bf16),
        ("s2q2_n1030_f32", 4, 2, 2, 1030, 512, 3, f32),
        ("c1024_bf16", 4, 1, 1, 2601, 1024, 3, bf16),
    ]
    rows, times, calls, worst = [], {}, {}, 0.0
    for name, b, s, q, n, c, p, dtype in cases:
        fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, dtype, seed=3)
        g = torch.randn(b, q, n, 2, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
        fk, ck = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
        lk = K.MPMChainPacked.apply(fk, fg, bg, ck, p, scale, eps)
        before = dict(K.launches)
        runs = [torch.autograd.grad(lk, (fk, ck), g, retain_graph=True)
                for _ in range(2)]
        launched = all(K.launches[k] - before[k] == 2
                       for k in ("match_bwd", "assign_bwd"))
        bitwise = all(torch.equal(x, y) for x, y in zip(*runs))
        gk = runs[0]
        # the plain backward from the forward's own prototypes and indices
        with torch.no_grad():
            packed = torch.cat(K.mpm_assign(fts, fg, bg, ctr, p), 1)
            _, inds = K.mpm_match(fts, s, packed[:, :p], packed[:, p:], scale,
                                  return_indices=True)

        def plain_backward(fts=fts, fg=fg, bg=bg, ctr=ctr, packed=packed,
                           inds=inds, g=g, s=s, p=p):
            gq, gpk = K._match_backward(fts[:, s:], packed, inds, g, p, scale)
            gs, _, _, gc = K._assign_backward(fts[:, :s], fg, bg, ctr, gpk,
                                              p, eps)
            return torch.cat([gs, gq], 1).to(fts.dtype), gc

        with torch.no_grad():
            gr = plain_backward()
        fp, cp = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
        pf, pb = plain.meta_prototype_assign(fp[:, :s], fg, bg, cp, p)
        lp = plain.prototype_predictions(fp[:, s:], pf, pb, scale)
        ga = torch.autograd.grad(lp, (fp, cp), g, retain_graph=True)

        def rel(x, y):
            e = (x.float() - y.float()).abs().max().item()
            return e, e / y.float().abs().max().item()

        fts_tol = GRAD_RTOL_BF16 if dtype == bf16 else GRAD_RTOL
        vs_plain = [rel(x, y) for x, y in zip(gk, gr)]
        vs_autograd = [rel(x, y) for x, y in zip(gk, ga)]
        with torch.no_grad():
            _, pi = plain.prototype_predictions(fts[:, s:], pf.detach(),
                                                pb.detach(), scale, True)
            margin = top2_margin(torch, fts[:, s:], pf, pb, scale)
        agree, sure = index_agreement(inds, pi, margin)
        ok = (launched and bitwise and sure
              and all(bool(torch.isfinite(x).all()) for x in gk)
              and all(r[0][1] <= fts_tol and r[1][1] <= GRAD_RTOL
                      for r in (vs_plain, vs_autograd)))
        row = {"case": name, "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p,
               "dtype": str(dtype).replace("torch.", ""),
               "fts_grad_vs_plain_backward": vs_plain[0],
               "ctr_grad_vs_plain_backward": vs_plain[1],
               "fts_grad_vs_autograd_plain": vs_autograd[0],
               "ctr_grad_vs_autograd_plain": vs_autograd[1],
               "index_agreement": agree, "bit_identical_x2": bitwise,
               "kernels_launched": launched, "ok": ok}
        rows.append(row)
        worst = max(worst, vs_plain[0][0], vs_plain[1][0])
        if not ok:
            emit({"phase": "mpm_backward", "failed": row})
            raise AssertionError(f"mpm backward ({name}) disagrees with plain")
        if name.startswith("train"):
            tag = str(dtype).replace("torch.", "")
            calls[tag] = (lambda lk=lk, fk=fk, ck=ck, g=g: torch.autograd.grad(
                lk, (fk, ck), g, retain_graph=True))
            calls[f"{tag}_plain"] = plain_backward
            calls[f"{tag}_autograd_plain"] = (
                lambda lp=lp, fp=fp, cp=cp, g=g: torch.autograd.grad(
                    lp, (fp, cp), g, retain_graph=True))
    torch.cuda.synchronize()
    tickets = sum(int(t.abs().sum()) for t in K._ticket_bufs.values())
    if tickets:
        raise AssertionError(f"tickets not reset: sum {tickets}")
    for tag, fn in calls.items():
        times[tag] = time_ms(torch, fn, flush, spin_cycles=LONG_SPIN_CYCLES)
        times[f"{tag}_no_spin"] = time_ms(torch, fn, flush, spin=False)
    # each backward kernel's device time (torch.profiler)
    split = device_profile(torch, calls["bfloat16"], {
        "match_bwd": ["match_bwd_kernel"], "assign_bwd": ["assign_bwd_kernel"]})
    b, s, q, n, c, p = 4, 1, 1, 2601, 512, 3
    fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, bf16)
    _, num, den = K._assign_launch(fts, fg, bg, ctr, p, eps, partials=True)
    bound = bound_ms(*mpm_backward_work(
        b, s, q, n, c, p, 2, 4 * (num.numel() + den.numel())))
    emit({"phase": "mpm_backward", "cases": rows, "timing_shapes": {
        "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p}, "ms": times,
        "bfloat16_kernel_us": {k: split[f"{k}_us"]
                               for k in ("match_bwd", "assign_bwd")},
        "plans": {k[0]: v for k, v in K._plans.items()
                  if isinstance(k[0], str) and k[0].endswith("_bwd")
                  and k[2:] == (c, p, 1)},
        "note": "bfloat16/float32: the kernels; *_plain: the plain "
                "backward (torch ops); *_autograd_plain: autograd of the "
                "plain chain; each with a ~2 ms device spin (device work) "
                "and *_no_spin without it (dispatch included: what the "
                "step waits)",
        "bound_ms_bf16": bound[0], "bound_by": bound[1],
        "tolerance": {"grad_rtol": GRAD_RTOL, "bf16_fts_grad_rtol":
                      GRAD_RTOL_BF16, "index_margin": MARGIN}})
    return times, bound, worst


def device_profile(torch, fn, names, by_shape=()):
    """Device time of one call of ``fn`` by kernel (torch.profiler): the
    total, the share of each group in ``names`` ({group: [substrings]})
    and the top 10. For each kernel whose name holds a substring of
    ``by_shape``, its time grouped by the convolution op that launched it
    and that op's input shapes (``record_shapes``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(by_shape)) as prof:
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
    if by_shape:
        groups = {}
        for e in prof.events():
            for k in getattr(e, "kernels", ()):
                if not any(sub in k.name for sub in by_shape):
                    continue
                op = e
                while op.cpu_parent is not None and "conv" not in op.name:
                    op = op.cpu_parent
                key = (k.name[:60], op.name, str(op.input_shapes))
                us, calls = groups.get(key, (0.0, 0))
                groups[key] = (us + k.duration, calls + 1)
        out["by_input_shape"] = [
            {"kernel": kn, "op": op, "input_shapes": shapes, "us": us,
             "calls": calls}
            for (kn, op, shapes), (us, calls) in sorted(
                groups.items(), key=lambda kv: -kv[1][0])]
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
    want = {"assign": steps + evals, "match": steps + evals,
            "match_bwd": steps, "assign_bwd": steps,
            "minplus": 2 * steps, "mpm_backward": steps}
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
                      entry.Stage1Runtime(cfg), solver.LRPolicy(cfg.tr, 100),
                      device)
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
        "mpm_kernels": ["assign_kernel", "match_kernel"],
        "mpm_backward_kernels": ["match_bwd_kernel", "assign_bwd_kernel"],
        "minplus_kernel": ["minplus_kernel"]}, CONV_FALLBACK)
    del trainer, opt, params, model

    # one f32 step twice (TF32 off): kernels vs the plain mpm chain
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
    if any(K.launches[k] == before[k] for k in K.launches):
        raise AssertionError(f"the kernel train step skipped an mpm kernel: "
                             f"{before} -> {K.launches}")
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


def stage2_path_phase(torch, K, M):
    """The stage-2 cascade (``pemp_tpu_torch.entry.pemp_stage2``) at full
    width: ``train`` (6 steps, online eval, chained test) from a seeded
    stage-1 checkpoint, its launches, checkpoints and the frozen stage 1;
    one eval batch of stage 2 with the kernels against the plain mpm on
    the same prior; one f32 stage-2 train step with the kernels against
    the plain mpm; the steady train and eval steps; one train step's
    profile with the convolutions by input shape."""
    from unittest import mock

    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.core import losses as loss_lib
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core.evaluator import make_fast_eval_step
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry1
    from pemp_tpu_torch.entry import pemp_stage2 as entry
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2

    device = torch.device("cuda")
    built = []
    build = entry.build_model

    def keep(cfg, dev):
        built.append(build(cfg, dev))
        return built[-1]

    with tempfile.TemporaryDirectory() as tmp:
        # the frozen stage 1: a seed-initialised PEMPStage1 checkpoint
        cfg1 = entry1.ex.assemble("test", {"split": "0", "seed": "1234"})
        s1_path = Path(tmp) / "stage1.pt"
        torch.save(entry1.build_model(cfg1, torch.device("cpu")).state_dict(),
                   s1_path)
        snapshot = torch.load(s1_path, map_location="cpu", weights_only=True)
        args = STAGE2_ARGS + [f"s1.ckpt={s1_path}", f"g.model_dir={tmp}"]
        K.reset_launches()
        M.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(entry, "build_model", keep):
            result = entry.main(args)
        wall = time.perf_counter() - t0
        launches = {**K.launches, **M.launches, **K.backward_calls}
        run_dir = Path(tmp) / "pemp_stage2" / str(result["train"]["run_id"])
        files = sorted(p.name for p in run_dir.iterdir())
        saved = {name: ckpt_lib.load(run_dir / name)["model"]
                 for name in (ckpt_lib.CKPT, ckpt_lib.BEST)}
        overrides = dict(a.split("=", 1) for a in args[2:])
        # the models of the checks below, from the same stage-1 file
        cfg_eval = entry.ex.assemble("test", overrides)
        model = entry.build_model(cfg_eval, device)
        cfg32 = entry.ex.assemble("train", {**overrides,
                                            "dev.precision": "f32"})
        base = entry.build_model(cfg32, device).train()

    cfg = entry.ex.assemble("train", overrides)
    losses = result["train"]["losses"]
    steps = len(losses)
    evals = 2 * -(-cfg.data.test_n // cfg.data.test_bs) * cfg.te.epochs
    # a train step: stage 1's prior (assign, match) and stage 2 (assign,
    # match, the backward's two kernels, the cedt EDT's two min-plus
    # launches); an eval batch: both stages' assign and match
    want = {"assign": 2 * (steps + evals), "match": 2 * (steps + evals),
            "match_bwd": steps, "assign_bwd": steps, "minplus": 2 * steps,
            "mpm_backward": steps}
    if steps != cfg.data.train_n // cfg.data.bs or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"stage-2 train losses {losses}")
    if launches != want:
        raise AssertionError(f"stage-2 path launches {launches}, want {want}")
    if files != sorted([ckpt_lib.BEST, ckpt_lib.CKPT]):
        raise AssertionError(f"stage-2 run dir holds {files}")
    if not math.isfinite(result["test"]["miou"]):
        raise AssertionError(f"stage-2 chained test {result['test']}")
    keys = PEMPStage2().state_dict()
    for name, sd in saved.items():
        if set(sd) != set(keys) or any(sd[k].shape != keys[k].shape
                                       for k in keys):
            raise AssertionError(f"{name} does not hold stage 2's keys only")
    # the frozen stage 1 of the train run: weights and BN buffers bit-equal
    after = {k: v.cpu() for k, v in built[0].stage1.state_dict().items()}
    stage1_equal = set(after) == set(snapshot) and all(
        torch.equal(after[k], v) for k, v in snapshot.items())
    if not stage1_equal:
        raise AssertionError("stage 1 changed while stage 2 trained")
    del built[:]

    # one eval batch: stage 2 with the kernels against the plain mpm, both
    # on the kernels' prior; the prior itself against the plain mpm's
    ds, loader, _ = datasets.load(cfg_eval)
    ds.sample_tasks()
    ebatch = next(iter(loader))
    t = {k: torch.from_numpy(ebatch[k]).to(device)
         for k in ("sup_rgb", "sup_mask", "qry_rgb")}
    with torch.no_grad():
        prior = model.prior(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
        lk = model.stage2(t["sup_rgb"], t["sup_mask"], t["qry_rgb"], prior)
        before = dict(K.launches)
        with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
            prior_p = model.prior(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
            lp = model.stage2(t["sup_rgb"], t["sup_mask"], t["qry_rgb"],
                              prior)
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain stage-2 forward launched a kernel")
    want_shape = (cfg_eval.data.test_bs, cfg_eval.query, cfg_eval.data.height,
                  cfg_eval.data.width, 2)
    if tuple(lk.shape) != want_shape or not torch.isfinite(lk).all():
        raise AssertionError(f"stage-2 logits {tuple(lk.shape)} (want "
                             f"{want_shape}) or not finite")
    err = (lk - lp).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    prior_agree = (prior == prior_p).float().mean().item()
    if agree < MAIN_AGREE or err > LOGIT_ATOL or prior_agree < MAIN_AGREE:
        raise AssertionError(f"stage 2, kernels vs plain mpm: argmax "
                             f"agreement {agree}, max abs err {err}, prior "
                             f"agreement {prior_agree}")

    # one f32 stage-2 step (TF32 off) on one prior: kernels vs plain mpm
    base.freeze()
    ds_t, loader_t, _ = datasets.load(cfg32, "train")
    ds_t.sample_tasks()
    batch = next(iter(loader_t))
    tt = {k: torch.from_numpy(batch[k]).to(device)
          for k in ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")}
    base.set_dropout_generator(torch.Generator(device=device).manual_seed(5))
    prior32 = base.prior(tt["sup_rgb"], tt["sup_mask"], tt["qry_rgb"])
    loss_fn = loss_lib.get(cfg32)

    def grads(stage2):
        stage2.set_dropout_generator(
            torch.Generator(device=device).manual_seed(7))
        logits = stage2(tt["sup_rgb"], tt["sup_mask"], tt["qry_rgb"], prior32)
        loss = loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                       tt["qry_msk"].reshape(-1, *tt["qry_msk"].shape[-2:]))
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in
                             stage2.named_parameters() if p.requires_grad}

    kernel_s2, plain_s2 = base.stage2, copy.deepcopy(base.stage2)
    before = dict(K.launches)
    loss_k, grads_k = grads(kernel_s2)
    if any(K.launches[k] == before[k] for k in K.launches):
        raise AssertionError(f"the kernel stage-2 step skipped an mpm "
                             f"kernel: {before} -> {K.launches}")
    before = dict(K.launches)
    with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
        loss_p, grads_p = grads(plain_s2)
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain stage-2 step launched an mpm kernel")
    # the CM linears' biases add one constant to the whole batch ahead of
    # 1x1 convolutions and train-mode BNs, which remove it: their gradient
    # is zero in exact arithmetic (rounding on either side), so each is
    # held to zero against its weight's gradient instead of to the other
    zero = [f"encoder.backbone.linear{i}.bias" for i in (1, 2, 3)]
    zero_rel = max((g[k].abs().max() / g[k[:-4] + "weight"].abs().max()
                    ).item() for g in (grads_k, grads_p) for k in zero)
    rel = {k: ((grads_k[k] - grads_p[k]).norm()
               / grads_p[k].norm().clamp(min=1e-30)).item()
           for k in grads_p if k not in zero}
    worst_leaf = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if (loss_rel > TRAIN_LOSS_RTOL or rel[worst_leaf] > TRAIN_GRAD_RTOL
            or zero_rel > TRAIN_GRAD_RTOL):
        raise AssertionError(f"f32 stage-2 step kernels vs plain: loss rel "
                             f"{loss_rel}, worst grad {worst_leaf} rel L2 "
                             f"{rel[worst_leaf]}, CM bias grads "
                             f"{zero_rel} of their weights'")
    del base, kernel_s2, plain_s2, grads_k, grads_p

    # steady train step (bf16, as the entry ran) and eval step: host clock
    model.train()
    params = model.freeze()
    opt = solver.make_optimizer(cfg.tr, params)
    trainer = Trainer(cfg, Run(None, None), model, opt, params,
                      entry.Stage2Runtime(cfg), solver.LRPolicy(cfg.tr, 100),
                      device, weights=model.stage2)
    model.set_dropout_generator(torch.Generator(device=device).manual_seed(0))
    ds_t, loader_t, _ = datasets.load(cfg, "train")
    ds_t.sample_tasks()
    batch = next(iter(loader_t))

    step_ms = host_ms(torch, lambda: trainer.train_step(batch))
    prof = device_profile(torch, lambda: trainer.train_step(batch), {
        "mpm_kernels": ["assign_kernel", "match_kernel"],
        "mpm_backward_kernels": ["match_bwd_kernel", "assign_bwd_kernel"],
        "minplus_kernel": ["minplus_kernel"]}, ("",))
    # every convolution's kernels by the op's input shape: the CM stages'
    # first convolutions (4, 66, 258 and 514 input channels) among them
    convs = [g for g in prof.pop("by_input_shape") if "conv" in g["op"]]
    odd_shape = re.compile(r"\[\d+, (4|66|258|514), \d+, \d+\]")
    odd = [g for g in convs if odd_shape.search(g["input_shapes"])]
    prof["conv_by_input_shape_top"] = convs[:12]
    prof["conv_odd_channels_us"] = sum(g["us"] for g in odd)
    prof["conv_odd_channels_top"] = odd[:12]
    model.eval()
    eval_step = make_fast_eval_step(model, device)
    eval_ms = host_ms(torch, lambda: eval_step(ebatch))
    eval_prof = device_profile(torch, lambda: eval_step(ebatch), {
        "mpm_kernels": ["assign_kernel", "match_kernel"]})
    del trainer, opt, params, model
    emit({"phase": "stage2_path", "args": STAGE2_ARGS, "wall_s": wall,
          "steps": steps, "losses": losses, "launches": launches,
          "launches_expected": want, "run_files": files,
          "checkpoint_keys": len(keys), "stage1_bit_equal": stage1_equal,
          "best_iou": result["train"]["best_iou"], "test": result["test"],
          "eval_vs_plain": {"logits_max_abs_err": err,
                            "argmax_agreement": agree,
                            "prior_agreement": prior_agree,
                            "tolerance": {"logit_atol": LOGIT_ATOL,
                                          "agree": MAIN_AGREE}},
          "f32_step_vs_plain": {"loss_kernels": loss_k, "loss_plain": loss_p,
                                "loss_rel_err": loss_rel,
                                "grad_max_rel_l2": rel[worst_leaf],
                                "grad_worst_leaf": worst_leaf,
                                "grad_leaves": len(rel),
                                "cm_bias_grad_vs_weight_grad": zero_rel,
                                "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                                              "grad_rel_l2": TRAIN_GRAD_RTOL}},
          "steady_step_ms": step_ms,
          "steady_episodes_per_s": cfg.data.bs / step_ms * 1e3,
          "train_device_idle_share": 1 - prof["device_us_total"] / 1e3
          / step_ms,
          "steady_eval_step_ms": eval_ms,
          "steady_eval_episodes_per_s": cfg.data.test_bs / eval_ms * 1e3,
          "eval_device_idle_share": 1 - eval_prof["device_us_total"] / 1e3
          / eval_ms,
          "profile": prof, "eval_profile": eval_prof})
    return launches


def counted(torch, K, M, fn):
    """The K1-K5 launches of one call of ``fn``."""
    K.reset_launches()
    M.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: {**K.launches, **M.launches}[k] for k in STEP_LAUNCHES}


def conv_profile(prof):
    """A ``device_profile(..., by_shape=("",))`` with its kernels grouped
    by op cut to the convolutions: their total and the top 12."""
    convs = [g for g in prof.pop("by_input_shape") if "conv" in g["op"]]
    prof["conv_us"] = sum(g["us"] for g in convs)
    prof["conv_by_input_shape_top"] = convs[:12]
    return prof


def steady_steps(torch, runtime, model, cfg, device, train_batch,
                 eval_batch, weights=None, groups=None):
    """The steady train step (a trainer over ``model`` in train mode, the
    runtime's hooks) and eval step (``runtime.eval_step``) on the host
    clock, each with one profiled call (device time by kernel, the
    convolutions by input shape) and the device's idle share of the
    step."""
    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core.trainer import Trainer

    model.train()
    params = model.freeze()
    opt = solver.make_optimizer(cfg.tr, params)
    trainer = Trainer(cfg, Run(None, None), model, opt, params, runtime,
                      solver.LRPolicy(cfg.tr, 100), device, weights=weights)
    model.set_dropout_generator(torch.Generator(device=device).manual_seed(0))
    out = {"train_step": lambda: trainer.train_step(train_batch)}
    out["steady_step_ms"] = host_ms(torch, out["train_step"])
    out["profile"] = conv_profile(device_profile(
        torch, out["train_step"], groups or {}, ("",)))
    out["train_device_idle_share"] = (
        1 - out["profile"]["device_us_total"] / 1e3 / out["steady_step_ms"])
    model.eval()
    step = runtime.eval_step(model, device)
    out["eval_step"] = lambda: step(eval_batch)
    out["steady_eval_step_ms"] = host_ms(torch, out["eval_step"])
    out["eval_profile"] = device_profile(torch, out["eval_step"], groups or {})
    out["eval_device_idle_share"] = (
        1 - out["eval_profile"]["device_us_total"] / 1e3
        / out["steady_eval_step_ms"])
    out["steady_episodes_per_s"] = cfg.data.bs / out["steady_step_ms"] * 1e3
    out["steady_eval_episodes_per_s"] = (cfg.data.test_bs
                                         / out["steady_eval_step_ms"] * 1e3)
    return out


def first_batch(datasets, cfg, mode="test", runtime=None):
    """The first batch of ``mode``'s data, through ``runtime.wrap_data``
    when a runtime is given (CaNet's history)."""
    ds, loader, _ = datasets.load(cfg, mode)
    if runtime is not None:
        ds, loader = runtime.wrap_data(ds, loader, mode == "train")
    ds.sample_tasks()
    return next(iter(loader))


def vgg_path_phase(torch, K, M, plain):
    """PEMP with ``net.backbone=vgg16`` at full width (VGG16, c=512, p=3):
    stage 1's ``train`` entry (cedt, clip 1.1; 6 steps, online eval,
    chained test), then stage 2's (VGG16CM behind that run's stage 1,
    clip 1.1), their exact launches over the run, per train step and per
    eval batch, their checkpoints, stage 1 bit-equal after stage 2
    trains; one eval batch of each stage with the kernels against the
    plain mpm, and the kernels against their plain versions on the
    batch's own VGG features (``check_kernels``); one f32 stage-1 train
    step with the kernels against the plain mpm; the steady train and
    eval steps of both stages with the device's idle share."""
    from unittest import mock

    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.core import losses as loss_lib
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry1
    from pemp_tpu_torch.entry import pemp_stage2 as entry2
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
    from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2

    device = torch.device("cuda")
    built = []
    build = entry2.build_model

    def keep(cfg, dev):
        built.append(build(cfg, dev))
        return built[-1]

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for stage, entry, args in ((1, entry1, VGG1_ARGS),
                                   (2, entry2, VGG2_ARGS)):
            args = args + [f"g.model_dir={tmp}"]
            if stage == 2:
                args.append(f"s1.id={runs[1]['result']['train']['run_id']}")
            K.reset_launches()
            M.reset_launches()
            t0 = time.perf_counter()
            with mock.patch.object(entry2, "build_model", keep):
                result = entry.main(args)
            wall = time.perf_counter() - t0
            run_dir = Path(tmp) / entry.NAME / str(result["train"]["run_id"])
            runs[stage] = {
                "result": result, "wall_s": wall,
                "launches": {**K.launches, **M.launches, **K.backward_calls},
                "overrides": dict(a.split("=", 1) for a in args[2:]),
                "files": sorted(p.name for p in run_dir.iterdir()),
                "saved": {name: ckpt_lib.load(run_dir / name)["model"]
                          for name in (ckpt_lib.CKPT, ckpt_lib.BEST)}}
        best1 = Path(tmp) / "pemp_stage1" / str(
            runs[1]["result"]["train"]["run_id"]) / ckpt_lib.BEST
        snapshot = ckpt_lib.load(best1)["model"]
        # the models of the checks below, from the runs' own files
        over1 = {**runs[1]["overrides"], "ckpt": str(best1)}
        cfg1 = entry1.ex.assemble("train", over1)
        model1 = entry1.build_model(cfg1, device)
        cfg1_32 = entry1.ex.assemble("train", {**over1,
                                               "dev.precision": "f32"})
        base32 = entry1.build_model(cfg1_32, device).train()
        cfg2 = entry2.ex.assemble("train", runs[2]["overrides"])
        model2 = entry2.build_model(cfg2, device)

    checks = {}
    for stage, cls, key in ((1, PEMPStage1, "pemp_stage1"),
                            (2, PEMPStage2, "pemp_stage2")):
        run, cfg = runs[stage], (cfg1, cfg2)[stage - 1]
        losses = run["result"]["train"]["losses"]
        steps = len(losses)
        evals = 2 * -(-cfg.data.test_n // cfg.data.test_bs) * cfg.te.epochs
        # a stage-2 step and eval batch run two forward chains (stage 1's
        # prior, stage 2), one backward and one cedt EDT
        want = {k: (stage if k in ("assign", "match") else 1)
                * (steps * STEP_LAUNCHES[k] + evals * EVAL_LAUNCHES[k])
                for k in STEP_LAUNCHES}
        want["mpm_backward"] = steps
        run["launches_expected"] = want
        if steps != cfg.data.train_n // cfg.data.bs or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"vgg stage {stage} train losses {losses}")
        if run["launches"] != want:
            raise AssertionError(f"vgg stage {stage} launches "
                                 f"{run['launches']}, want {want}")
        if run["files"] != sorted([ckpt_lib.BEST, ckpt_lib.CKPT]):
            raise AssertionError(f"vgg stage {stage} run dir {run['files']}")
        if not math.isfinite(run["result"]["test"]["miou"]):
            raise AssertionError(f"vgg stage {stage} chained test "
                                 f"{run['result']['test']}")
        keys = cls(backbone="vgg16").state_dict()
        for name, sd in run["saved"].items():
            if set(sd) != set(keys) or any(sd[k].shape != keys[k].shape
                                           for k in keys):
                raise AssertionError(f"vgg {key} {name}: not the model's keys")
        run["checkpoint_keys"] = len(keys)
        del run["saved"]
    # the frozen stage 1 of the stage-2 run: bit-equal to its snapshot
    after = {k: v.cpu() for k, v in built[0].stage1.state_dict().items()}
    stage1_equal = set(after) == set(snapshot) and all(
        torch.equal(after[k], v) for k, v in snapshot.items())
    if not stage1_equal:
        raise AssertionError("vgg stage 1 changed while stage 2 trained")
    del built[:]

    # one eval batch: each stage with the kernels against the plain mpm
    # (stage 2 on the kernels' prior), and the kernels against their plain
    # versions on the VGG features the batch gives them
    ebatch = first_batch(datasets, cfg1)
    t = {k: torch.from_numpy(ebatch[k]).to(device)
         for k in ("sup_rgb", "sup_mask", "qry_rgb")}
    args = (t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
    captured = []
    real = stage1.mpm_chain_packed

    def record(*a, **kw):
        captured.append(a)
        return real(*a, **kw)

    with torch.no_grad():
        with mock.patch.object(stage1, "mpm_chain_packed", record):
            lk1 = model1(*args)
            prior = model2.prior(*args)
            lk2 = model2.stage2(*args, prior)
        before = dict(K.launches)
        with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
            lp1 = model1(*args)
            prior_p = model2.prior(*args)
            lp2 = model2.stage2(*args, prior)
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain vgg forward launched a kernel")
    want_shape = (cfg1.data.test_bs, cfg1.query, cfg1.data.height,
                  cfg1.data.width, 2)
    eval_vs_plain = {"prior_agreement": (prior == prior_p).float().mean().item()}
    for tag, lk, lp in (("stage1", lk1, lp1), ("stage2", lk2, lp2)):
        if tuple(lk.shape) != want_shape or not torch.isfinite(lk).all():
            raise AssertionError(f"vgg {tag} logits {tuple(lk.shape)} (want "
                                 f"{want_shape}) or not finite")
        eval_vs_plain[tag] = {
            "logits_max_abs_err": (lk - lp).abs().max().item(),
            "argmax_agreement": (lk.argmax(-1) == lp.argmax(-1)).float()
            .mean().item()}
    # captured: stage 1's chain, stage 2's prior (stage 1 again), stage 2's
    feature_cases = []
    for tag, i in (("stage1", 0), ("stage2", 2)):
        case = check_kernels(torch, K, plain, f"vgg_{tag}_eval_features",
                             *captured[i])
        case["features_abs_max"] = captured[i][0].float().abs().max().item()
        feature_cases.append(case)
    bad = [k for k, v in eval_vs_plain.items() if k != "prior_agreement"
           and (v["logits_max_abs_err"] > LOGIT_ATOL
                or v["argmax_agreement"] < MAIN_AGREE)]
    if (bad or eval_vs_plain["prior_agreement"] < MAIN_AGREE
            or not all(c["ok"] for c in feature_cases)):
        emit({"phase": "vgg_path", "failed": {
            "eval_vs_plain": eval_vs_plain, "kernel_cases": feature_cases}})
        raise AssertionError("vgg path: kernels vs plain mpm disagree")

    # one f32 stage-1 step (TF32 off): kernels vs the plain mpm chain
    base32.freeze()
    batch = first_batch(datasets, cfg1_32, "train")
    tt = {k: torch.from_numpy(batch[k]).to(device)
          for k in ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")}
    loss_fn = loss_lib.get(cfg1_32)

    def grads(model):
        model.zero_grad(set_to_none=True)
        logits = model(tt["sup_rgb"], tt["sup_mask"], tt["qry_rgb"])
        loss = loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                       tt["qry_msk"].reshape(-1, *tt["qry_msk"].shape[-2:]))
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in
                             model.named_parameters() if p.requires_grad}

    before = dict(K.launches)
    loss_k, grads_k = grads(base32)
    if any(K.launches[k] == before[k] for k in K.launches):
        raise AssertionError(f"the kernel vgg step skipped an mpm kernel: "
                             f"{before} -> {K.launches}")
    before = dict(K.launches)
    with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
        loss_p, grads_p = grads(base32)
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain vgg step launched an mpm kernel")
    rel = {k: ((grads_k[k] - grads_p[k]).norm()
               / grads_p[k].norm().clamp(min=1e-30)).item() for k in grads_p}
    worst_leaf = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    f32_step = {"loss_kernels": loss_k, "loss_plain": loss_p,
                "loss_rel_err": loss_rel, "grad_max_rel_l2": rel[worst_leaf],
                "grad_worst_leaf": worst_leaf, "grad_leaves": len(rel),
                "grad_rel_l2": rel,
                "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                              "grad_rel_l2": TRAIN_GRAD_RTOL}}
    if loss_rel > TRAIN_LOSS_RTOL or rel[worst_leaf] > TRAIN_GRAD_RTOL:
        emit({"phase": "vgg_path", "failed": {"f32_step_vs_plain": f32_step}})
        raise AssertionError(f"f32 vgg step kernels vs plain: loss rel "
                             f"{loss_rel}, worst grad {worst_leaf} rel L2 "
                             f"{rel[worst_leaf]}")
    del base32, grads_k, grads_p

    # the steady steps of both stages, and their launches per train step
    # and per eval batch
    groups = {"mpm_kernels": ["assign_kernel", "match_kernel"],
              "mpm_backward_kernels": ["match_bwd_kernel",
                                       "assign_bwd_kernel"],
              "minplus_kernel": ["minplus_kernel"]}
    tbatch = first_batch(datasets, cfg1, "train")
    steady = {}
    for stage, runtime, model, weights in (
            (1, entry1.Stage1Runtime(cfg1), model1, None),
            (2, entry2.Stage2Runtime(cfg2), model2, model2.stage2)):
        out = steady_steps(torch, runtime, model, runtime.cfg, device, tbatch,
                           ebatch, weights, groups)
        per_step = counted(torch, K, M, out.pop("train_step"))
        per_eval = counted(torch, K, M, out.pop("eval_step"))
        want_step = {k: v * (stage if k in ("assign", "match") else 1)
                     for k, v in STEP_LAUNCHES.items()}
        want_eval = {k: v * stage for k, v in EVAL_LAUNCHES.items()}
        if per_step != want_step or per_eval != want_eval:
            raise AssertionError(f"vgg stage {stage}: launches per step "
                                 f"{per_step} (want {want_step}), per eval "
                                 f"batch {per_eval} (want {want_eval})")
        out.update(launches_per_train_step=per_step,
                   launches_per_eval_batch=per_eval,
                   grad_clip=runtime.cfg.tr.grad_clip)
        steady[f"stage{stage}"] = out
    if (steady["stage1"]["grad_clip"], steady["stage2"]["grad_clip"]) != (
            1.1, 1.1):
        raise AssertionError("the vgg runs must clip at 1.1")
    del model1, model2
    for run in runs.values():
        run["test"] = run["result"]["test"]
        run["losses"] = run["result"]["train"]["losses"]
        run["best_iou"] = run["result"]["train"]["best_iou"]
        del run["result"], run["overrides"]
    emit({"phase": "vgg_path", "args": {"stage1": VGG1_ARGS,
                                        "stage2": VGG2_ARGS},
          "runs": runs, "stage1_bit_equal": stage1_equal,
          "eval_vs_plain": eval_vs_plain, "kernel_cases": feature_cases,
          "f32_step_vs_plain": f32_step, "steady": steady,
          "tolerance": {"logit_atol": LOGIT_ATOL, "agree": MAIN_AGREE,
                        "proto_rtol": PROTO_RTOL, "index_margin": MARGIN}})
    return {k: runs[1]["launches"][k] + runs[2]["launches"][k]
            for k in runs[1]["launches"]}


def family_path_phase(torch, K, M, name, runtime_cls, args, runtime_of=None,
                      check=None):
    """A family without a kernel of its own (Baseline, PANet, CaNet, RPMMs,
    PFENet) at full width: the ``train`` entry (online eval, chained
    test), one finite loss a step, no mpm or EDT kernel launched (the JAX
    package runs no kernel of its own for these models); the steady train
    and eval steps with one profile each. ``runtime_of``: the runtime
    class the entry run builds (a recording subclass), ``check(torch,
    runtime, model, cfg, device, tbatch, ebatch, steady)``: the family's
    own checks, whose dict joins the phase's line. Returns the run's
    launches."""
    import importlib
    from unittest import mock

    from pemp_tpu_torch.core.evaluator import to_device
    from pemp_tpu_torch.data import datasets

    entry = importlib.import_module(f"pemp_tpu_torch.entry.{name}")
    runtime = getattr(entry, runtime_cls)
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with mock.patch.object(entry, runtime_cls, runtime_of or runtime):
            K.reset_launches()
            M.reset_launches()
            t0 = time.perf_counter()
            result = entry.main(args + [f"g.model_dir={tmp}"])
            wall = time.perf_counter() - t0
            launches = {**K.launches, **M.launches, **K.backward_calls}
        run_dir = Path(tmp) / name / str(result["train"]["run_id"])
        files = sorted(p.name for p in run_dir.iterdir())
    cfg = entry.ex.assemble("train", dict(a.split("=", 1) for a in args[2:]))
    losses = result["train"]["losses"]
    if len(losses) != cfg.tr.total_epochs * (
            cfg.data.train_n // cfg.data.bs) or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} train losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"{name} launched a kernel: {launches}")
    if not math.isfinite(result["test"]["miou"]) or len(files) != 2:
        raise AssertionError(f"{name} chained test {result['test']}, run "
                             f"files {files}")
    runtime = runtime(cfg)
    model = entry.build_model(cfg, device)
    tbatch = first_batch(datasets, cfg, "train", runtime)
    ebatch = first_batch(datasets, cfg, runtime=runtime)
    t = to_device(tbatch, runtime.device_keys, device)
    with torch.no_grad():
        logits, aux = runtime.apply_train(model.train(), t)
        loss = runtime.compute_loss(logits, t, aux)
    aux = {k: float(v) for k, v in aux.items()}
    if not math.isfinite(float(loss)) or not all(
            0.0 < v < math.inf for v in aux.values()):
        raise AssertionError(f"{name} loss {float(loss)}, aux {aux}")
    steady = steady_steps(torch, runtime, model, cfg, device, tbatch, ebatch)
    extra = {} if check is None else check(torch, runtime, model, cfg,
                                           device, tbatch, ebatch, steady)
    del steady["train_step"], steady["eval_step"], model
    emit({"phase": f"{name}_path", "args": args, "wall_s": wall,
          "steps": len(losses), "losses": losses, "launches": launches,
          "run_files": files, "best_iou": result["train"]["best_iou"],
          "test": result["test"], "first_batch_loss": float(loss),
          "first_batch_aux": aux, **steady, **extra})
    return launches


def canet_recorder(entry):
    """A ``CaNetRuntime`` that records, for the checks of ``canet_path``,
    its train loads (adapter epoch, episode index, class, query names,
    whether the history was non-zero), the store's keys when the second
    train epoch resamples (what its snapshot holds), the store's size when
    each dataset is wrapped, and the loads of the chained test."""

    class Recorder(entry.CaNetRuntime):
        runs = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.loads, self.test_loads, self.wrap_sizes = [], [], []
            self.epoch1_keys = None
            self.size_before_test = None
            Recorder.runs.append(self)

        def wrap_data(self, ds, loader, train):
            self.wrap_sizes.append(len(self.store))
            adapter, wrapped = super().wrap_data(ds, loader, train)
            log = self.loads if train else self.test_loads
            get, resample = adapter.get_episode, adapter.sample_tasks

            def get_episode(idx):
                ep = get(idx)
                log.append((adapter.epoch, idx, int(ep["cls"]),
                            tuple(ep["qry_names"]), bool(ep["history"].any())))
                return ep

            def sample_tasks():
                if train and adapter.epoch == 1:
                    self.epoch1_keys = self.store.keys()
                return resample()

            adapter.get_episode = get_episode
            adapter.sample_tasks = sample_tasks
            return adapter, wrapped

        def test(self):
            self.size_before_test = len(self.store)
            self.test_loads.clear()
            return super().test()

    return Recorder


def canet_check(recorder):
    """``canet_path``'s history checks: after epoch 1 the store holds one
    entry per distinct training query; the epoch-2 episodes that read a
    non-zero history are exactly those whose key epoch 1 wrote and whose
    reset draw (adapter epoch 2, episode index) missed; the chained test
    started from an empty store and read only zeros. Also the steady
    train step without the write-back, which costs a device-to-host copy
    and a wait each step."""

    def check(torch, runtime, model, cfg, device, tbatch, ebatch, steady):
        run = recorder.runs[-1]
        epoch1 = {(c, n) for e, _, c, names, _ in run.loads if e == 1
                  for n in names}
        train_classes = {c for c, _ in epoch1}
        written = {k for k in run.epoch1_keys if k[0] in train_classes}
        if written != epoch1:
            raise AssertionError(f"canet store after epoch 1 holds {written},"
                                 f" the epoch's queries {epoch1}")
        epoch2 = [ld for ld in run.loads if ld[0] == 2]
        want = sum(any((c, n) in written and not run.store.reset_draw(
            (c, n), 2, idx) for n in names) for _, idx, c, names, _ in epoch2)
        got = sum(ld[4] for ld in epoch2)
        if not epoch2 or got != want or want == 0:
            raise AssertionError(f"canet epoch-2 episodes with history: {got}"
                                 f", want {want} of {len(epoch2)}")
        if (run.wrap_sizes[-1] != 0 or not run.size_before_test
                or any(ld[4] for ld in run.test_loads)
                or not run.test_loads):
            raise AssertionError(
                f"canet chained test: store size {run.wrap_sizes} at each "
                f"wrap, {run.size_before_test} before the test, test loads "
                f"with history {sum(ld[4] for ld in run.test_loads)}")
        model.train()
        runtime.post_step = None
        no_wb_ms = host_ms(torch, steady["train_step"])
        return {"history": {
            "epoch1_distinct_queries": len(epoch1),
            "epoch2_episodes": len(epoch2),
            "epoch2_with_history": got, "epoch2_expected": want,
            "store_size_before_test": run.size_before_test,
            "test_loads": len(run.test_loads)},
            "steady_step_no_writeback_ms": no_wb_ms,
            "writeback_ms": steady["steady_step_ms"] - no_wb_ms}
    return check


def rpmms_check(torch, runtime, model, cfg, device, tbatch, ebatch, steady):
    """``rpmms_path``: the same eval batch twice gives bit-identical
    logits (the eval generator is seeded 0 for every batch); the three
    train outputs are finite and of feature resolution."""
    from pemp_tpu_torch.core.evaluator import to_device
    from pemp_tpu_torch.models.canet import feat_size

    t = to_device(ebatch, runtime.device_keys, device)
    with torch.no_grad():
        a = runtime.apply_eval(model.eval(), t)
        b = runtime.apply_eval(model, t)
        outs, _ = runtime.apply_train(model.train(), to_device(
            tbatch, runtime.device_keys, device))
    h = feat_size(cfg.data.height)
    shape = (cfg.data.bs, 1, h, feat_size(cfg.data.width), 2)
    if not torch.equal(a, b) or len(outs) != 3 or not all(
            tuple(o.shape) == shape and bool(torch.isfinite(o).all())
            for o in outs):
        raise AssertionError(
            f"rpmms: eval repeat equal {torch.equal(a, b)}, train outputs "
            f"{[tuple(o.shape) for o in outs]}")
    return {"eval_repeat_bit_equal": True,
            "train_output_shape": list(shape)}


def pfenet_check(torch, runtime, model, cfg, device, tbatch, ebatch,
                 steady):
    """``pfenet_path``: after one train step no trunk parameter has a
    gradient, the trunk's BN running stats changed, and every head
    parameter has a finite gradient."""
    trunk = model.trunk()
    bns = {f"{i}.{k}": v.clone() for i, part in enumerate(trunk)
           for k, v in part.state_dict().items() if "running" in k}
    model.train()
    steady["train_step"]()
    torch.cuda.synchronize()
    stats = {f"{i}.{k}": v for i, part in enumerate(trunk)
             for k, v in part.state_dict().items() if "running" in k}
    trunk_ids = {id(p) for part in trunk for p in part.parameters()}
    trunk_grads = sum(p.grad is not None for part in trunk
                      for p in part.parameters())
    head = [(k, p) for k, p in model.named_parameters()
            if id(p) not in trunk_ids]
    bad = [k for k, p in head
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    changed = sum(not torch.equal(bns[k], stats[k]) for k in bns)
    if trunk_grads or bad or changed != len(bns):
        raise AssertionError(f"pfenet: trunk grads {trunk_grads}, head "
                             f"params without a finite grad {bad[:5]}, BN "
                             f"stats changed {changed} of {len(bns)}")
    return {"trunk_params_with_grad": 0, "head_params": len(head),
            "trunk_bn_stats_changed": changed}


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
    ptxas = [ln for rec in info.values() for ln in ptxas_summary(rec["log"])]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    times, bounds, worst = kernel_phase(torch, K, plain)
    launches, _ = main_path_phase(torch, K)
    mp_times, mp_bounds = minplus_phase(torch)
    bw_times, bw_bound, bw_worst = mpm_backward_phase(torch, K, plain)
    train_launches = train_path_phase(torch, K, M)
    stage2_launches = stage2_path_phase(torch, K, M)
    vgg_launches = vgg_path_phase(torch, K, M, plain)
    other = {"baseline_path": family_path_phase(
        torch, K, M, "baseline", "BaselineRuntime", BASELINE_ARGS)}
    other["panet_path"] = family_path_phase(torch, K, M, "panet",
                                            "PANetRuntime", PANET_ARGS)
    from pemp_tpu_torch.entry import canet as canet_entry
    recorder = canet_recorder(canet_entry)
    other["canet_path"] = family_path_phase(
        torch, K, M, "canet", "CaNetRuntime", CANET_ARGS, recorder,
        canet_check(recorder))
    other["rpmms_path"] = family_path_phase(
        torch, K, M, "rpmms", "RPMMsRuntime", RPMMS_ARGS, check=rpmms_check)
    other["pfenet_path"] = family_path_phase(
        torch, K, M, "pfenet", "PFENetRuntime", PFENET_ARGS,
        check=pfenet_check)

    # one row per TPU kernel K1-K5. assign and match are one __global__
    # each; the chain (K3, mpm.py:342) is those two launches on the packed
    # tensor and has none of its own (its launches: its calls on the main
    # path, one assign and one match launch each). The mpm rows' launches
    # are the eval path's (their slice), train_path_launches the training
    # path's, stage2_path_launches the stage-2 cascade's. minplus: one EDT
    # = its two launches (ms, plain_ms and bound_ms add both phases at the
    # train shapes). mpm_backward (K4):
    # its two kernels, match_bwd and assign_bwd, one launch each per
    # backward pass of the training path.
    mpm_cu = "pemp_tpu_torch/ops/kernels/csrc/mpm.cu"
    table = [
        {"name": name, "route": "cuda", "source": mpm_cu,
         "replaces": replaces, "launches": launches[name],
         "train_path_launches": train_launches[name],
         "stage2_path_launches": stage2_launches[name],
         "vgg_path_launches": vgg_launches[name],
         "max_abs_err": worst[name], "ms": times[name],
         "plain_ms": times[f"{name}_plain"], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, replaces in (("assign", "pemp_tpu/ops/pallas/mpm.py:119"),
                               ("match", "pemp_tpu/ops/pallas/mpm.py:249"))]
    table.append({
        "name": "chain", "route": "cuda", "source": mpm_cu,
        "replaces": "pemp_tpu/ops/pallas/mpm.py:342",
        "launches": launches["match"],
        "train_path_launches": train_launches["match"],
        "stage2_path_launches": stage2_launches["match"],
        "vgg_path_launches": vgg_launches["match"],
        "max_abs_err": worst["chain"], "ms": times["chain"],
        "plain_ms": times["chain_plain"], "bound_ms": bounds["chain"][0],
        "bound_by": bounds["chain"][1], "library_ms": None,
        "note": "assign then match on the packed tensor, no launch of its "
                "own: launches = its calls on the main path"})
    table.append({
        "name": "mpm_backward", "route": "cuda",
        "source": "pemp_tpu_torch/ops/kernels/csrc/mpm_bwd.cu",
        "replaces": "pemp_tpu/ops/pallas/mpm_vjp.py:216",
        "launches": train_launches["mpm_backward"],
        "kernel_launches": {k: train_launches[k]
                            for k in ("match_bwd", "assign_bwd")},
        "stage2_path_launches": stage2_launches["mpm_backward"],
        "vgg_path_launches": vgg_launches["mpm_backward"],
        "max_abs_err": bw_worst, "ms": bw_times["bfloat16"],
        "ms_no_spin": bw_times["bfloat16_no_spin"],
        "plain_ms": bw_times["bfloat16_plain"],
        "plain_ms_no_spin": bw_times["bfloat16_plain_no_spin"],
        "autograd_plain_ms": bw_times["bfloat16_autograd_plain"],
        "bound_ms": bw_bound[0], "bound_by": bw_bound[1], "library_ms": None,
        "note": "MPMChainPacked.backward: match_bwd then assign_bwd; ms "
                "and plain_ms with a ~2 ms device spin (device work), "
                "*_no_spin without it (host dispatch included)"})
    table.append({
        "name": "minplus", "route": "cuda",
        "source": "pemp_tpu_torch/ops/kernels/csrc/minplus.cu",
        "replaces": "pemp_tpu/ops/pallas/minplus.py:47",
        "launches": train_launches["minplus"], "max_abs_err": 0.0,
        "stage2_path_launches": stage2_launches["minplus"],
        "vgg_path_launches": vgg_launches["minplus"],
        "ms": mp_times["phase1"] + mp_times["phase2"],
        "plain_ms": mp_times["phase1_plain"] + mp_times["phase2_plain"],
        "bound_ms": mp_bounds["phase1"][0] + mp_bounds["phase2"][0],
        "bound_by": "operations", "library_ms": None,
        "library_note": "no PyTorch call computes a min-plus product"})
    # the paths that launch no kernel (family_path_phase fails otherwise):
    # each row's count there; the chain's is its match launches
    for row in table:
        key = "match" if row["name"] == "chain" else row["name"]
        row["other_path_launches"] = {path: counts[key]
                                      for path, counts in other.items()}
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
