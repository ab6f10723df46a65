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
  and one eval batch held against the plain mpm, and both PEMP stages at
  ``net.protos`` 9 and 16 trained and tested through their entries
  against ``dev.use_kernels=False`` (``stage2_path``);
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
- a real run (``run_path``), in a temporary working directory: a seeded
  torchvision-layout ResNet-50 in ``data/`` (the stage-1 trunk equal to
  it on the card), stage 1's observed ``train`` with ``-p`` and
  ``g.mongodb`` (its run records), a ``test exp_id=<id>`` run, stage 2's
  ``train`` behind it from the same file (its padded channels zero) and
  ``visualize`` (its files, K1/K2 once an episode with indices), with the
  host time of the file's load and of the records, and PIL's version;
- real data (``real_data_path``), in a temporary directory: a PASCAL
  VOC tree (all 20 classes, JPEGs at 500x375-like sizes, {0, 255} PNG
  masks) and a COCO tree (the 80 category ids, 640x480-like JPEGs,
  polygons with fractional vertices, multi-ring, compressed and
  uncompressed RLEs); stage 1's ``train`` on PASCAL (4 steps, cedt, the
  default loader threads), ``test`` runs of its snapshot at test batch 1
  and 4 on the original-resolution GT: the TP/FP/FN counts equal with
  the forward run one episode at a time, the batched forward's within
  the argmax tolerance (cuDNN's algorithms depend on the batch size);
  COCO's file lists, a ``test`` and two train steps, the C++ rasterizer
  against its numpy version on every annotation; a real eval batch and
  the EDT against their plain versions, and the f32 step on seeded real
  batches, its gradient gap shown with and without the pixels where the
  kernels' and the plain argmax over p differ (near-ties);
  the loader's host ms a batch, the train step fed by it (serially and
  through the device prefetcher) against the same step fed by SYNTH, its
  wait on the loader and the card's idle share;
- the parallel layer (``parallel_path``; stage 1, ResNet-50, 401², bf16,
  cedt): a compact-wire epoch fed by the device prefetcher bit-equal to
  the serial one, one stage-2 eval batch's pageable and pinned copies,
  the loader-fed step's idle share with and without the prefetcher, the
  ``train`` entry under a ``torchrun``-style world of one over NCCL equal
  to the plain run, and in that world ``dev.fuse_steps=4`` (DDP's
  backward in the graph) bit-equal to eager, and two ranks sharing the card over gloo against one
  process at their global batch (f32 and bf16; subprocesses of this
  script: ``chip_smoke.py parallel-worker ...`` and ``entry-run ...``);
- the fused multi-step launch (``fused_path``; stage 1 as above with
  ``dev.fuse_steps=4``, two epochs of ten steps): one f32 step captured
  in a CUDA graph, K1-K5 inside it, against the eager step with the
  kernels (bit for bit) and with the plain mpm; the ``train`` entry eager
  against fused: at f32 bit-equal (losses, weights, momentum) or within
  two eager runs' spread, at bf16 the losses within 1e-3;
  captures, replays and K1-K5's launches as predicted, and as the
  profiler sees them in a replayed chunk; the steady step and the card's
  idle share, eager against a replayed chunk; CaNet's
  history store byte for byte the serial run's (321², three steps a
  chunk); a gloo world on the card refused;
- serving export (``serving_path``; ResNet-50, 1-shot, 401x401, bf16,
  seeded weights): stage 1 and the stage-1 -> stage-2 cascade exported
  with a symbolic batch by ``pemp_tpu_torch/tools/export_serving.py``'s
  functions (K1 and K2 as the graph nodes ``pemp.mpm_assign`` and
  ``pemp.mpm_match``), each artifact loaded in a fresh process
  (``chip_smoke.py serving-worker ...``) and called at B = 1 and 8 on a
  SYNTH eval batch: K1 and K2 once a stage a call (and as the profiler
  counts them), logits bit-equal to the live eager forward (cuDNN
  deterministic), the live forward against the plain mpm; the B = 1
  latency and B = 8 episodes/s of artifact and live forward, the
  export's seconds and the artifact's bytes;
- the operator tools (``tools_path``; ``pemp_tpu_torch/tools/``, each
  through its command line's ``main``): ``profile_eval`` (test batch 8,
  with and without the kernels) and ``profile_train`` (batch 4, cedt,
  eager and a replayed chunk of 4), K1-K5 as the profiler counts them
  against the prediction; ``memory_report``'s eight rows (the allocator's
  peaks at two batches, the projected largest batch under the card's
  memory); ``exp_train_levers`` (``verify`` within the card's gate, then
  ``measure`` of the native, space-to-batch and float32-weight-gradient
  arms, eager and fused) and one dilated 3x3 256->256 convolution alone,
  native against space-to-batch; ``bench_input`` on its miniature tree;
  ``verify_real_data``'s dry run, its phase 4 on seeded ``.pth`` files
  and one planned stage-1 ``test`` whose mIoU it parses;
- the last operator tools (``ops_tools_path``): the stage-1 launch
  preset's ``print_config cuda`` (``dev.fuse_steps = 8``); the SIGTERM /
  resume drill (``soak_run``) through that preset at 401², fused chunks
  of 8, three epochs, SIGTERM once epoch 1 is recorded, both phases exit
  0, every epoch recorded once, the chained test, the run's records;
  the int8 microbenchmarks (``exp_int8_conv``, ``exp_int8_blend``'s 23
  rows at B = 64: bf16 cuDNN, the same GEMMs in bf16 and int8
  ``torch._int_mm``, each GEMM alone), no arm in error, the int32
  accumulation exact on a case of each formulation; the cuDNN flag
  sweep (``exp_cudnn_flags``, base, benchmark and deterministic at batch
  4) with the dilation-12 and -18 convolutions' device ms; a seeded
  stage-1 ``.pth`` through both checkpoint converters bit for bit, and
  the converted ``.pt``'s eval forward on the card bit-equal to the
  ``.pth``'s;
- the measurement tools (``bench_path``; ``pemp_tpu_torch/tools/
  bench*.py``, each through its ``main`` with a few seconds of rounds):
  ``bench`` at 401², B = 256 (its one line, its counts of one launch
  within the argmax tolerance of ``dev.use_kernels=False``'s),
  ``bench_train --fuse 4`` (plain, kernels and fused arms: rates, MFU in
  (0, 1], K1-K5 as each arm predicts), ``bench_zoo``'s ``cascade1``,
  ``latency1`` and ``latency_artifact`` at B = 1 (an exported, saved and
  loaded cascade), ``bench_train_zoo``'s ``pemp_stage2`` and ``canet``;

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
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
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
# net.protos 9 and 16 through the PEMP entries: one snapshot tested with
# the kernels and with dev.use_kernels=False (f32), the test's loss
# (relative: float32 sums in another order, and for stage 2 a stage-1
# prior that may part at a near-tie pixel) and its mIoU (absolute: a flip
# at a near-tie pixel moves it)
WIDE_LOSS_RTOL = 1e-4
WIDE_MIOU_ATOL = 1e-2
# EDT distances on the card vs the CPU: the squared distances are
# bit-equal; the float32 square roots may differ by one ulp (2^-23)
EDT_SQRT_RTOL = 2.0 ** -23
TRAIN_GRAD_RTOL = 1e-3
# the f32 step on real batches (``real_batch_gaps``): (seed, batch) pairs,
# the four batches of REAL_TRAIN_N episodes under twelve seeds. On an H100
# five of them had the kernels' and the plain argmax over p part at 1-2
# (pixel, class) entries, each a near-tie (top-two gap <= 5.7e-6): their
# whole-gradient gaps read 6.4e-4 to 9.83e-3 (seed 0, batch 1), and 1.2e-5
# to 2.0e-5 with those entries masked, as the other 43 read unmasked
# (9.5e-6 to 6.1e-5). The whole gradient's gap is held to twice the
# largest reading.
REAL_GAP_BATCHES = tuple((seed, i) for seed in range(12) for i in range(4))
TIE_GRAD_RTOL = 2e-2

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
WIDE_PROTOS = (9, 16)
WIDE_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
             "data.height=193", "data.width=193", "shot=1", "query=1",
             "data.bs=2", "data.train_n=6", "tr.total_epochs=1",
             "data.test_bs=2", "data.test_n=4", "te.epochs=1", "loss=cedt",
             "dev.precision=f32", "seed=1234"]
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
# a recorded train run's folder: its checkpoints and the JAX CLI's records
# (REVISION too where the checkout is a git repository)
RUN_FILES = {"bestckpt.pt", "ckpt.pt", "config.json", "metrics.json",
             "sources"}
# the run_path phase: stage 1 (3 steps, one epoch, its online eval and
# chained test), a test run of its snapshot, stage 2 behind it (2 steps),
# and visualize at test batch 1 (one episode a batch)
RUN1_ARGS = [a for a in TRAIN_ARGS if not a.startswith("data.train_n=")] + [
    "data.train_n=12", "g.mongodb=True", "-p"]
RUN2_ARGS = [a for a in STAGE2_ARGS if not a.startswith("data.train_n=")] + [
    "data.train_n=8", "g.mongodb=True"]
VIS_EPISODES = 4
VIS_ARGS = ["visualize", "with", "split=0", "data.dataset=SYNTH",
            "data.height=401", "data.width=401", "shot=1", "query=1",
            "data.test_bs=1", f"data.test_n={VIS_EPISODES}",
            "dev.precision=bf16", "seed=1234"]
# the real_data_path phase: PEMP stage 1 on miniature PASCAL-5i and
# COCO-20i trees written in their on-disk layouts at VOC- and COCO-like
# original sizes (h, w), JPEG images, {0, 255} PNG masks and polygon /
# RLE annotations
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333))
VOC_PER_CLASS = 6
COCO_SIZES = ((480, 640), (427, 640), (640, 480), (640, 427))
COCO_PER_CAT = 2
REAL_TRAIN_N = 16
REAL_TEST_N = 8
# scripts/pemp_stage1.sh's step (batch 4, cedt, split 0) on the PASCAL
# tree, cut to REAL_TRAIN_N episodes; the online eval and chained test at
# test batch 4; data.num_workers at its default
REAL_ARGS = [a for a in TRAIN_ARGS if not a.startswith(
    ("data.dataset=", "data.train_n=", "data.test_bs=", "data.test_n="))] + [
    "data.dataset=PASCAL", f"data.train_n={REAL_TRAIN_N}", "data.test_bs=4",
    f"data.test_n={REAL_TEST_N}"]
REAL_TEST_ARGS = ["test"] + [a for a in REAL_ARGS[1:] if not a.startswith(
    ("data.bs=", "data.train_n=", "tr.", "loss=", "data.test_bs="))]
# COCO: a test at batch 4 and two train steps (one online eval batch),
# unobserved
COCO_TEST_ARGS = [a.replace("data.dataset=PASCAL", "data.dataset=COCO")
                  for a in REAL_TEST_ARGS] + ["data.test_bs=4", "-u"]
COCO_TRAIN_ARGS = [a.replace("data.dataset=PASCAL", "data.dataset=COCO")
                   for a in REAL_ARGS if not a.startswith(
                       ("data.train_n=", "data.test_n="))] + [
    "data.train_n=8", "data.test_n=4", "-u"]
# the loader's timings: batches rendered one after the other on one
# thread, and train steps fed by the loader (after LOADER_WARM steps)
LOADER_BATCHES = 6
FED_STEPS = 10
LOADER_WARM = 2


# K1-K5's launches per train step and per eval batch of one mpm chain
STEP_LAUNCHES = {"assign": 1, "match": 1, "mpm_bwd": 1,
                 "minplus": 2}
EVAL_LAUNCHES = {"assign": 1, "match": 1, "mpm_bwd": 0,
                 "minplus": 0}
# each count's kernel, as torch.profiler names it on the device
KERNEL_SYMBOLS = {"assign": ["assign_kernel"], "match": ["match_kernel"],
                  "mpm_bwd": ["mpm_bwd_kernel"],
                  "minplus": ["minplus_kernel"]}

# parallel_path: PEMP stage 1 (ResNet-50, c=512, p=3, 401x401, bf16, cedt,
# SYNTH). PAR_STEPS prefetched and serial compact-wire steps on the same
# batches; the NCCL world of one and the plain run (NCCL_ARGS, subprocesses,
# cuDNN deterministic); WORLD_STEPS steps of two ranks sharing the card over
# gloo at WORLD_BS episodes each against one process at twice that.
PAR_STEPS = 6
H2D_REPS = 10
NCCL_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
             "data.height=401", "data.width=401", "shot=1", "query=1",
             "data.bs=4", "data.train_n=8", "tr.total_epochs=1",
             "data.test_bs=4", "data.test_n=8", "te.epochs=1", "loss=cedt",
             "dev.precision=bf16", "seed=1234", "g.model_dir=md"]
WORLD_OF_ONE_BACKEND = "nccl"
# the same world of one, eager against dev.fuse_steps=FUSE_K: DDP's
# backward in the graph, after DDP_WARMUP_STEPS eager steps (3 chunks),
# then one replay in the first epoch and four in the second
NCCL_FUSE_ARGS = [a for a in NCCL_ARGS if not a.startswith(
    ("data.train_n=", "tr.total_epochs="))] + [
    "data.train_n=64", "tr.total_epochs=2"]
WORLD_BS = 2
WORLD_STEPS = 3
WORLD_TIMEOUT_S = 600        # each subprocess of the phase
# two ranks against one process (f32: TF32 off; bf16: the backbone's
# autocast): the first step's global loss, relative (the same weights on
# the global batch: the forward alone); every step's; the final state's
# distance from the single process's over the change its steps made
# (``update_rel``). Each rank's convolutions see half the batch, so cuDNN
# takes other algorithms and rounds elsewhere: about 50 float32 ulps, or
# 4 bfloat16 ulps, on the first loss; the mpm's max over p turns that
# into larger gradient differences later. Measured on an H100 (first
# loss, worst loss, update): f32 3.1e-6, 3.5e-4, 7.5e-6; bf16 1.7e-2,
# 3.6e-2, 5.2e-4; each bound is about 3-20x that.
WORLD_TOL = {"f32": {"first_loss_rtol": 2e-5, "loss_rtol": 2e-3,
                     "update_rel_l2": 1e-4},
             "bf16": {"first_loss_rtol": 5e-2, "loss_rtol": 1e-1,
                      "update_rel_l2": 1e-2}}

# fused_path: PEMP stage 1 (ResNet-50, c=512, p=3, 401x401, cedt, SYNTH,
# batch 4) with dev.fuse_steps=FUSE_K: two epochs of FUSE_STEPS steps, each
# two chunks and a two-step serial tail (the first chunk of the first
# epoch is the eager warm-up, so the graph replays 1 + 2 times), against
# the eager loop from one seeded state; f32 bit-equal (else within the
# spread of two eager runs), bf16 losses within FUSE_BF16_RTOL; CaNet at
# 321x321 with dev.fuse_steps=CANET_FUSE_K, two chunks an epoch
FUSE_K = 4
FUSE_STEPS = 10
FUSE_ARGS = ["train", "with", "split=0", "data.dataset=SYNTH",
             "data.height=401", "data.width=401", "shot=1", "query=1",
             "data.bs=4", f"data.train_n={4 * FUSE_STEPS}",
             "tr.total_epochs=2", "data.test_bs=8", "data.test_n=8",
             "te.epochs=1", "loss=cedt", "seed=1234"]
FUSE_BF16_RTOL = 1e-3
CANET_FUSE_K = 3
CANET_FUSE_ARGS = [a for a in CANET_ARGS if not a.startswith(
    "data.train_n=")] + ["data.train_n=24"]


# serving_path: PEMP stage 1 and the stage-1 -> stage-2 cascade (ResNet-50,
# c=512, p=3, 1-shot, 401x401, bf16, weights from SERVE_SEED) exported with
# a symbolic batch (pemp_tpu_torch/tools/export_serving.py), each artifact
# loaded in a fresh process (``chip_smoke.py serving-worker``) and called
# at SERVE_BATCHES on a SYNTH eval batch; K1 and K2 launch once a stage a
# call
SERVE_SEED = 1234
SERVE_BATCHES = (1, 8)
SERVE_STAGES = {"pemp_stage1": 1, "cascade": 2}
SERVE_TIMEOUT_S = 300        # each worker
# cuDNN's kernel that took 92 % of a B = 1 stage-1 call's device time on
# an H100 80GB HBM3 (700 W): its time by the convolution's input shapes
SERVE_CONV_BY_SHAPE = ("conv2d_grouped_direct",)

# the operator tools (``tools_path``; pemp_tpu_torch/tools/): profile_eval
# at test batch 8 (two profiled launches), profile_train at batch 4
# (three profiled steps, and one replayed chunk of TOOLS_FUSE), the levers'
# measure eager and fused, bench_input's pass length and worker counts
TOOLS_EVAL_ARGS = ["--batch", "8", "--hw", "401", "--launches", "2"]
TOOLS_TRAIN_ARGS = ["--bs", "4", "--hw", "401", "--steps", "3", "--loss",
                    "cedt"]
TOOLS_FUSE = 4
TOOLS_INPUT_ARGS = ["--episodes", "24", "--workers", "1,2,4"]
# the last operator tools (``ops_tools_path``): the stage-1 preset's
# print_config; the SIGTERM / resume drill through the preset on the card
# (fused chunks of 8), OPS_SOAK_TRAIN_N episodes an epoch (an epoch of
# several polls), SIGTERM once epoch 1 is recorded, the eval and chained
# test cut to OPS_SOAK_ARGS; the int8 microbenchmarks, their int32
# accumulation held exact on one case a formulation (OPS_INT8_EXACT:
# name, N, H, Cin, Cout, k, stride, dilation) at two images; the cuDNN
# flag sweep's arms at batch 4, OPS_FLAG_BUDGET seconds each; a seeded
# stage-1 ResNet-50 .pth through both converters and its eval forward
# at test batch OPS_CKPT_BATCH
OPS_SOAK_TRAIN_N = 400
OPS_SOAK_ARGS = ["tr.total_epochs=3", "data.test_n=16", "data.test_bs=8",
                 "te.epochs=1", "seed=1234"]
OPS_SOAK_POLL = 0.5
OPS_SOAK_DEVICE = "cuda"
OPS_INT8_EXACT = (("res_1x1", 2, 51, 1024, 256, 1, 1, 1),
                  ("aspp_3x3_d6", 2, 51, 256, 256, 3, 1, 6),
                  ("stem_7x7_s2", 2, 401, 3, 64, 7, 2, 1))
OPS_FLAG_ARMS = ["base", "benchmark", "deterministic"]
OPS_FLAG_BUDGET = "3"
OPS_CKPT_BATCH = 8
# the measurement tools (``bench_path``; pemp_tpu_torch/tools/bench*.py),
# each through its command line's ``main`` at the JAX tools' sizes, with
# BENCH_BUDGET_S seconds of rounds (PEMP_BENCH_BUDGET_S): bench at 401²,
# B = 256; bench_train with --fuse BENCH_FUSE; bench_zoo's BENCH_ZOO_ROWS,
# the artifact at B = 1 only (BENCH_ARTIFACT_SAMPLES a round, two rounds);
# bench_train_zoo's BENCH_TRAIN_ZOO_ROWS
BENCH_BUDGET_S = "3"
BENCH_FUSE = 4
BENCH_ZOO_ROWS = ["cascade1", "latency1", "latency_artifact"]
BENCH_ARTIFACT_SAMPLES = 40
BENCH_TRAIN_ZOO_ROWS = ["pemp_stage2", "canet"]
# one dilated 3x3 256->256 convolution (bf16, channels_last) alone, native
# against the space-to-batch schedule: (N, C, H, W, dilation, backward):
# layer3's d=2 at serving B = 1, eval B = 4 and with a backward; the
# ASPPV2 branches (d=6, 12, 18) at serving B = 1 and with the train step's
# backward. On an H100 80GB HBM3 (700 W) cuDNN ran d=12 and 18 on its
# grouped direct kernel (serving B = 1) and its fallback dgrad/wgrad
# engines (the train step), which the s2b arm avoids
S2B_CONV_CASES = ((2, 256, 51, 51, 2, False), (8, 256, 51, 51, 2, False),
                  (4, 256, 51, 51, 2, True)) + tuple(
    case for d in (6, 12, 18)
    for case in ((2, 256, 51, 51, d, False), (8, 256, 51, 51, d, True)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_run_files(files, what: str) -> None:
    if set(files) - {"REVISION"} != RUN_FILES:
        raise AssertionError(f"{what} run dir holds {files}, want "
                             f"{sorted(RUN_FILES)} (and REVISION)")


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
        # p above 8: the padded instances 12 and 16
        ("p9_bf16", 4, 1, 1, 2601, 512, 9, bf16, False),
        ("p12_f32", 2, 2, 1, 1030, 512, 12, f32, False),
        ("p16_bf16", 4, 1, 1, 1030, 512, 16, bf16, False),
        ("p16_f32", 2, 1, 1, 1030, 512, 16, f32, False),
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
    slots = K._assign_plan(K._lib(1), fts.device, c, p, 1)[1]
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
    with tempfile.TemporaryDirectory() as tmp:      # the test run's records
        result = entry.main(MAIN_ARGS + [f"g.model_dir={tmp}"])
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    if not math.isfinite(result["miou"]) or not math.isfinite(result["loss"]):
        raise AssertionError(f"main path result not finite: {result}")
    if (min(launches["assign"], launches["match"]) <= 0
            or launches["mpm_bwd"]):
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
    step = make_fast_eval_step(model, device,
                               compact_wire=cfg.dev.compact_wire)
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
    """Device time of one batch by kernel (``device_profile``): the total,
    the mpm kernels' time and the top 10."""
    with torch.no_grad():
        prof = device_profile(torch, lambda: model(
            t["sup_rgb"], t["sup_mask"], t["qry_rgb"]),
            {"mpm_kernels": ["assign_kernel", "match_kernel"]})
    return {k: prof[k] for k in ("device_us_total", "mpm_kernels_us", "top")}


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


BWD_SWEEP_BATCHES = (1, 2, 4, 8)
BWD_SWEEP_CALLS = 20


def mpm_backward_sweep(torch, fns, esize=2):
    """{B: {kernel: us, "other_us": us}} of one call of each ``fns[B]``
    (torch.profiler over BWD_SWEEP_CALLS calls; every kernel whose name
    holds ``_bwd``, and the call's other device us), and per kernel the
    least-squares line us = fixed_us + bytes / marginal_bytes_per_s over
    the batches (bytes: ``mpm_backward_work`` at the train shapes)."""
    from torch.profiler import ProfilerActivity, profile

    from pemp_tpu_torch.utils import profiling
    per_b = {}
    for b, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(BWD_SWEEP_CALLS):
                fn()
            torch.cuda.synchronize()
        times = profiling.device_times(prof)
        row = {re.search(r"\w*_bwd\w*", name).group(0): us / BWD_SWEEP_CALLS
               for name, (us, _) in times.items() if "_bwd" in name}
        row["other_us"] = (sum(us for us, _ in times.values())
                           / BWD_SWEEP_CALLS - sum(row.values()))
        per_b[b] = row
    fits = {}
    for name in per_b[min(per_b)]:
        xs = [mpm_backward_work(b, 1, 1, 2601, 512, 3, esize)[0]
              for b in per_b]
        ys = [per_b[b].get(name, 0.0) for b in per_b]
        mx, my = statistics.fmean(xs), statistics.fmean(ys)
        slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                 / sum((x - mx) ** 2 for x in xs))
        fits[name] = {"fixed_us": my - slope * mx,
                      "marginal_bytes_per_s": (1e6 / slope if slope > 0
                                               else None)}
    return {"us_per_call": {str(b): row for b, row in per_b.items()},
            "fit": fits}


def backward_call(torch, K, b, s, q, n, c, p, dtype):
    """(call, (fts, fg, bg, ctr, g)): ``call`` takes ``torch.autograd.grad``
    of MPMChainPacked's logits at the given shapes (make_inputs, seed 3;
    the cotangent ``g`` seeded 4) with respect to the features and the
    centers."""
    scale, eps = 20.0, K.ASSIGN_EPS
    fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, dtype, seed=3)
    g = torch.randn(b, q, n, 2, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    fk, ck = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
    lk = K.MPMChainPacked.apply(fk, fg, bg, ck, p, scale, eps)
    return (lambda: torch.autograd.grad(lk, (fk, ck), g, retain_graph=True),
            (fts, fg, bg, ctr, g))


def graph_backward_vs_eager(torch, K, fts, fg, bg, ctr, g, p):
    """K4 captured in a CUDA graph (after an eager call on the capture
    stream makes its plan and barrier counters) and replayed twice, each
    replay bit-equal to the eager call; the counters back at 0."""
    scale, eps = 20.0, K.ASSIGN_EPS
    packed, num, den, sm = K._assign_launch(fts, fg, bg, ctr, p, eps,
                                            partials=True)
    _, inds = K._match_launch(fts, fg.shape[1], packed, p, scale, True)
    args = (fts, fg, bg, ctr, packed, inds, num, den, sm, g, p, scale, eps,
            True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = K._backward_launch(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = K._backward_launch(*args)
    torch.cuda.current_stream().wait_stream(stream)
    same = []
    for _ in range(2):
        for t in captured:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(x, y) for x, y in zip(eager, captured)))
    tickets = int(K._ticket_bufs[(fts.device, stream.cuda_stream,
                                  "mpm_bwd")].abs().sum())
    del graph
    return all(same) and tickets == 0


def mpm_backward_phase(torch, K, plain):
    """MPMChainPacked's backward (K4: the one kernel of csrc/mpm_bwd.cu)
    against the plain backward on the card (``_match_backward`` then
    ``_assign_backward``, PyTorch ops, from the forward's prototypes and
    indices) and against autograd of the plain chain: at the train shapes
    in bf16 and f32, with S=Q=2 at n=1030 (a partial last stage), at
    c=1024 (two column passes), f32 at c=768 (no ring: rows read from
    device memory) and at p = 9 and 16 (the padded instances 12 and 16,
    p = 16 also in f32); two calls bit-identical, each launching the
    kernel once, the barrier counters back at 0; the train shapes in a
    captured and replayed CUDA graph bit-equal to eager. Timed at the
    train shapes with a long device spin (LONG_SPIN_CYCLES: its device
    work, however long the host takes to enqueue it) and without (what the
    step waits), beside the plain backward and autograd of the plain
    chain; then B = 1, 2, 4, 8 at the train shapes otherwise (bf16), each
    timed and profiled (the kernel's device us, the call's other device
    us, the fixed and marginal split)."""
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
        ("c768_f32_no_ring", 2, 2, 1, 1030, 768, 3, f32),
        ("p9_bf16", 4, 1, 1, 2601, 512, 9, bf16),
        ("p16_bf16", 4, 1, 1, 2601, 512, 16, bf16),
        ("p16_f32", 2, 1, 1, 1030, 512, 16, f32),
    ]
    rows, times, calls, worst = [], {}, {}, 0.0
    for name, b, s, q, n, c, p, dtype in cases:
        call, (fts, fg, bg, ctr, g) = backward_call(torch, K, b, s, q, n, c,
                                                    p, dtype)
        before = K.launches["mpm_bwd"]
        runs = [call() for _ in range(2)]
        launched = K.launches["mpm_bwd"] - before == 2
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
               "plan": K._plans[("mpm_bwd", fts.device, c,
                                 K.padded_protos(p), int(dtype == bf16))],
               "fts_grad_vs_plain_backward": vs_plain[0],
               "ctr_grad_vs_plain_backward": vs_plain[1],
               "fts_grad_vs_autograd_plain": vs_autograd[0],
               "ctr_grad_vs_autograd_plain": vs_autograd[1],
               "index_agreement": agree, "bit_identical_x2": bitwise,
               "kernel_launched": launched, "ok": ok}
        if name == "train_bf16":
            row["graph_replay_bit_equal"] = graph_backward_vs_eager(
                torch, K, fts, fg, bg, ctr, g, p)
            ok = ok and row["graph_replay_bit_equal"]
            row["ok"] = ok
        rows.append(row)
        worst = max(worst, vs_plain[0][0], vs_plain[1][0])
        if not ok:
            emit({"phase": "mpm_backward", "failed": row})
            raise AssertionError(f"mpm backward ({name}) disagrees with plain")
        if name.startswith("train"):
            tag = str(dtype).replace("torch.", "")
            calls[tag] = call
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
    # the batch sweep (bf16, train shapes otherwise)
    sweep_fns = {bb: (calls["bfloat16"] if bb == 4 else backward_call(
        torch, K, bb, 1, 1, 2601, 512, 3, bf16)[0])
        for bb in BWD_SWEEP_BATCHES}
    for bb, fn in sweep_fns.items():
        times[f"bfloat16_b{bb}"] = time_ms(torch, fn, flush,
                                           spin_cycles=LONG_SPIN_CYCLES)
    sweep = mpm_backward_sweep(torch, sweep_fns)
    b, s, q, n, c, p = 4, 1, 1, 2601, 512, 3
    fts, fg, bg, ctr = make_inputs(torch, b, s, q, n, c, p, bf16)
    _, num, den, sm = K._assign_launch(fts, fg, bg, ctr, p, eps,
                                       partials=True)
    # the function's traffic: the forward's assign partials are what any
    # backward reads in place of a second pass over the support rows; the
    # class softmax this design also reads (where the function can
    # recompute it from the rows it reads anyway) is its own traffic,
    # reported beside the bound
    bound = bound_ms(*mpm_backward_work(
        b, s, q, n, c, p, 2, 4 * (num.numel() + den.numel())))
    softmax_bytes = 4 * sm.numel()
    emit({"phase": "mpm_backward", "cases": rows, "timing_shapes": {
        "B": b, "S": s, "Q": q, "n": n, "c": c, "p": p}, "ms": times,
        "bfloat16_kernel_us": sweep["us_per_call"]["4"],
        "batch_sweep": sweep,
        "note": "bfloat16/float32: the kernel; *_plain: the plain "
                "backward (torch ops); *_autograd_plain: autograd of the "
                "plain chain; each with a ~2 ms device spin (device work) "
                "and *_no_spin without it (dispatch included: what the "
                "step waits); bfloat16_b<B>: the kernel at B episodes; "
                "batch_sweep: its device us a call by torch.profiler",
        "bound_ms_bf16": bound[0], "bound_by": bound[1],
        "softmax_read_bytes": softmax_bytes,
        "softmax_read_ms_at_hbm_rate": softmax_bytes / HBM_BYTES_PER_S * 1e3,
        "tolerance": {"grad_rtol": GRAD_RTOL, "bf16_fts_grad_rtol":
                      GRAD_RTOL_BF16, "index_margin": MARGIN}})
    return times, bound, worst


def device_profile(torch, fn, names, by_shape=()):
    """Device time of one call of ``fn`` by kernel (torch.profiler, read by
    ``pemp_tpu_torch/utils/profiling.py``): the total, the time, share and
    kernel count of each group in ``names`` ({group: [substrings]}) and the
    top 10. For each kernel whose name holds a substring of ``by_shape``,
    its time grouped by the convolution op that launched it and that op's
    input shapes (``record_shapes``)."""
    from torch.profiler import ProfilerActivity, profile

    from pemp_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(by_shape)) as prof:
        fn()
        torch.cuda.synchronize()
    times = profiling.device_times(prof)
    total = sum(us for us, _ in times.values())
    out = {"device_us_total": total}
    for group, keys in names.items():
        us, calls = profiling.matching(times, keys)
        out[f"{group}_calls"] = calls
        out[f"{group}_us"] = us
        out[f"{group}_share"] = us / total if total else 0.0
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])
    out["top"] = [{"kernel": name[:90], "us": us, "calls": calls}
                  for name, (us, calls) in ranked[:10]]
    if by_shape:
        out["by_input_shape"] = profiling.conv_by_shape(prof, None, by_shape)
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
            "mpm_bwd": steps, "minplus": 2 * steps, "mpm_backward": steps}
    if steps != cfg.data.train_n // cfg.data.bs or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if launches != want:
        raise AssertionError(f"train path launches {launches}, want {want}")
    check_run_files(files, "train path")
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
        "mpm_backward_kernels": ["mpm_bwd_kernel"],
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
            "mpm_bwd": steps, "minplus": 2 * steps,
            "mpm_backward": steps}
    if steps != cfg.data.train_n // cfg.data.bs or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"stage-2 train losses {losses}")
    if launches != want:
        raise AssertionError(f"stage-2 path launches {launches}, want {want}")
    check_run_files(files, "stage-2 path")
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
        "mpm_backward_kernels": ["mpm_bwd_kernel"],
        "minplus_kernel": ["minplus_kernel"]}, ("",))
    # every convolution's kernels by the op's input shape: the CM stages'
    # first convolutions (4, 66, 258 and 514 input channels) among them
    convs = prof.pop("by_input_shape")
    odd_shape = re.compile(r"\[\d+, (4|66|258|514), \d+, \d+\]")
    odd = [g for g in convs if odd_shape.search(g["input_shapes"])]
    prof["conv_by_input_shape_top"] = convs[:12]
    prof["conv_odd_channels_us"] = sum(g["us"] for g in odd)
    prof["conv_odd_channels_top"] = odd[:12]
    model.eval()
    eval_step = make_fast_eval_step(model, device,
                                    compact_wire=cfg.dev.compact_wire)
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
          "profile": prof, "eval_profile": eval_prof,
          "wide_protos": wide_protos_entries(torch, K, M)})
    return launches


def wide_protos_entries(torch, K, M):
    """F9 through the entries: PEMP stage 1 at ``net.protos=p`` and the
    cascade's stage 2 at ``net.protos2=p`` behind that stage 1's file, for
    p in WIDE_PROTOS. Each stage's ``train`` entry (WIDE_ARGS, chained
    test) runs with the kernels and with ``dev.use_kernels=False``, and
    its ``test`` entry runs the kernels' run's snapshot with
    ``dev.use_kernels=False``. The kernels launch as a step and an eval
    batch do, the plain runs launch none; the test of one snapshot within
    WIDE_LOSS_RTOL (loss) and WIDE_MIOU_ATOL (mIoU); stage 1's first step
    (same weights, same batch) within TRAIN_LOSS_RTOL. Printed, not held:
    the later steps, whose weights part after the first update (the
    argmax over p of a random model's nearly equal prototypes routes a
    pixel's gradient to another prototype), and stage 2's first step,
    whose input holds stage 1's argmax (the prior): in one run of this
    phase it read 1e-7 apart, in another 1.8e-3, with the same code and a
    stage-1 file trained anew, which only a discrete input can do."""
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.entry import pemp_stage1 as entry1
    from pemp_tpu_torch.entry import pemp_stage2 as entry2

    def run(entry, argv):
        K.reset_launches()
        M.reset_launches()
        return entry.main(argv), {**K.launches, **M.launches}

    cfg = entry1.ex.assemble("train", dict(
        a.split("=", 1) for a in WIDE_ARGS[2:]))
    steps = cfg.data.train_n // cfg.data.bs
    evals = 2 * -(-cfg.data.test_n // cfg.data.test_bs)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for p in WIDE_PROTOS:
            s1_file = None
            for stage, entry in ((1, entry1), (2, entry2)):
                extra = [f"net.protos={p}"] + (
                    [f"net.protos2={p}", "tr.lr=0.0035",
                     f"s1.ckpt={s1_file}"] if stage == 2 else [])
                dirs = {on: f"g.model_dir={Path(tmp) / f'p{p}_{on}'}"
                        for on in (True, False)}
                on, launched = run(entry, WIDE_ARGS + extra + [dirs[True]])
                off, plain_launched = run(entry, WIDE_ARGS + extra + [
                    "dev.use_kernels=False", dirs[False]])
                rid = on["train"]["run_id"]
                tested, test_launched = run(entry, ["test"] + WIDE_ARGS[1:]
                                            + extra + [
                    "dev.use_kernels=False", dirs[True], f"exp_id={rid}",
                    "-u"])
                if stage == 1:
                    s1_file = (Path(tmp) / f"p{p}_True" / "pemp_stage1"
                               / str(rid) / ckpt_lib.BEST)
                want = {"assign": stage * (steps + evals),
                        "match": stage * (steps + evals), "mpm_bwd": steps,
                        "minplus": 2 * steps}
                first = on["train"]["losses"][0]
                first_rel = abs(first - off["train"]["losses"][0]) / first
                test_rel = (abs(on["test"]["loss"] - tested["loss"])
                            / abs(tested["loss"]))
                miou_gap = abs(on["test"]["miou"] - tested["miou"])
                row = {"losses": on["train"]["losses"],
                       "losses_plain": off["train"]["losses"],
                       "first_loss_rel_err": first_rel,
                       "test": on["test"], "test_plain": tested,
                       "test_loss_rel_err": test_rel,
                       "test_miou_abs_err": miou_gap, "launches": launched}
                out[f"stage{stage}_p{p}"] = row
                if (launched != want or any(plain_launched.values())
                        or any(test_launched.values())
                        or len(on["train"]["losses"]) != steps
                        or not all(math.isfinite(x) for x in
                                   on["train"]["losses"])
                        or not (stage == 2 or first_rel <= TRAIN_LOSS_RTOL)
                        or not test_rel <= WIDE_LOSS_RTOL
                        or not miou_gap <= WIDE_MIOU_ATOL):
                    raise AssertionError(
                        f"stage {stage} at protos {p}, kernels vs plain: "
                        f"{row}, want launches {want}, plain launches "
                        f"{plain_launched}, {test_launched}")
    out["tolerance"] = {"stage1_first_loss_rtol": TRAIN_LOSS_RTOL,
                        "test_loss_rtol": WIDE_LOSS_RTOL,
                        "test_miou_atol": WIDE_MIOU_ATOL}
    return out


def counted(torch, K, M, fn):
    """The K1-K5 launches of one call of ``fn``."""
    K.reset_launches()
    M.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: {**K.launches, **M.launches}[k] for k in STEP_LAUNCHES}


def conv_profile(prof):
    """A ``device_profile(..., by_shape=("",))`` with its convolutions'
    kernels by op and input shape cut to their total and the top 12."""
    convs = prof.pop("by_input_shape")
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
        check_run_files(run["files"], f"vgg stage {stage}")
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
    f32_step = f32_step_vs_plain(torch, K, base32, tt,
                                 loss_lib.get(cfg1_32), "vgg")
    del base32

    # the steady steps of both stages, and their launches per train step
    # and per eval batch
    groups = {"mpm_kernels": ["assign_kernel", "match_kernel"],
              "mpm_backward_kernels": ["mpm_bwd_kernel"],
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
    if not math.isfinite(result["test"]["miou"]):
        raise AssertionError(f"{name} chained test {result['test']}")
    check_run_files(files, name)
    runtime = runtime(cfg)
    model = entry.build_model(cfg, device)
    tbatch = first_batch(datasets, cfg, "train", runtime)
    ebatch = first_batch(datasets, cfg, runtime=runtime)
    t = to_card(tbatch, runtime.device_keys, device, cfg.dev.compact_wire)
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
    from pemp_tpu_torch.models.canet import feat_size

    t = to_card(ebatch, runtime.device_keys, device, cfg.dev.compact_wire)
    with torch.no_grad():
        a = runtime.apply_eval(model.eval(), t)
        b = runtime.apply_eval(model, t)
        outs, _ = runtime.apply_train(model.train(), to_card(
            tbatch, runtime.device_keys, device, cfg.dev.compact_wire))
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


def torchvision_resnet50(torch, seed: int):
    """A seeded state_dict in torchvision's ResNet-50 layout at its
    published shapes (``conv1``, ``bn1``, ``layer1``-``layer4``, ``fc``:
    ~100 MB at float32), as ``data/resnet50-19c8e357.pth`` holds it."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def put(key, *shape):
        sd[key] = torch.randn(shape, generator=g)

    def bn(key, c):
        for t in ("weight", "bias", "running_mean"):
            put(f"{key}.{t}", c)
        sd[f"{key}.running_var"] = torch.rand(c, generator=g) + 0.5

    put("conv1.weight", 64, 3, 7, 7)
    bn("bn1", 64)
    inplanes = 64
    for si, (n, p) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), 1):
        for bi in range(n):
            key = f"layer{si}.{bi}"
            put(f"{key}.conv1.weight", p, inplanes if bi == 0 else 4 * p, 1, 1)
            put(f"{key}.conv2.weight", p, p, 3, 3)
            put(f"{key}.conv3.weight", 4 * p, p, 1, 1)
            for ci, c in ((1, p), (2, p), (3, 4 * p)):
                bn(f"{key}.bn{ci}", c)
            if bi == 0:
                put(f"{key}.downsample.0.weight", 4 * p, inplanes, 1, 1)
                bn(f"{key}.downsample.1", 4 * p)
        inplanes = 4 * p
    put("fc.weight", 1000, 2048)
    put("fc.bias", 1000)
    return sd


class HostTimer:
    """Host-clock seconds spent in the patched callables, by name."""

    def __init__(self):
        self.s, self.calls = {}, {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
                self.calls[name] = self.calls.get(name, 0) + 1
        return timed


def trunk_vs_file(torch, got, sd, device, prefix, pads=None):
    """The trunk tensors of ``got`` (under ``prefix``; the CMs' linears and
    the BN counters aside) that differ from the file ``sd``, on the card;
    ``pads``: {key: n} tensors whose last ``n`` input channels must be
    zero and the rest the file's."""
    pads = pads or {}
    bad = []
    for key, value in got.items():
        if (not key.startswith(prefix) or ".linear" in key
                or key.endswith("num_batches_tracked")):
            continue
        src = sd[key[len(prefix):]].to(device)
        n = pads.get(key[len(prefix):-len(".weight")], 0)
        if n:
            same = (torch.equal(value[:, :-n], src)
                    and torch.count_nonzero(value[:, -n:]).item() == 0)
        else:
            same = torch.equal(value, src)
        if not same:
            bad.append(key)
    return bad


def run_path_phase(torch, K, M):
    """A real run through the user's entry points, at full width in a
    temporary working directory: a seeded torchvision ResNet-50 file in
    ``data/``, the pretrained stage-1 trunk bit-equal to it on the card;
    ``pemp_stage1 train`` observed (records, Mongo documents, ``-p``, the
    chained test), then ``test exp_id=<id>`` in a run folder of its own;
    ``pemp_stage2 train`` behind that run from the same file (the stem's
    prior channel and the CMs' +2 input channels zero, every other trunk
    tensor the file's before the first step); ``visualize`` of the
    stage-1 run (its files, K1/K2 once an episode with indices). Host
    times: each command's wall, the file's load, the records' writes."""
    import os
    from unittest import mock

    import PIL

    from pemp_tpu_torch import config as config_lib
    from pemp_tpu_torch.entry import pemp_stage1 as entry1
    from pemp_tpu_torch.entry import pemp_stage2 as entry2
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    from pemp_tpu_torch.models import registry
    from pemp_tpu_torch.utils import observers, pretrained

    device = torch.device("cuda")
    timer = HostTimer()
    cwd, static = os.getcwd(), os.environ.get("PEMP_HTTP_STATIC")
    out = {"phase": "run_path", "pil_version": PIL.__version__}
    launches = {}

    def counted_run(what, main, argv):
        K.reset_launches()
        M.reset_launches()
        t0 = time.perf_counter()
        result = main(argv)
        out[f"{what}_wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches[what] = {**K.launches, **M.launches, **K.backward_calls}
        return result

    def records(run_dir, what, scalars):
        files = sorted(p.name for p in run_dir.iterdir())
        want = {"config.json", "sources", "mongo"} | (
            RUN_FILES if scalars else set())
        if set(files) - {"REVISION"} != want:
            raise AssertionError(f"{what} run dir holds {files}")
        (mongo,) = [json.loads(ln) for ln in
                    (run_dir / "mongo" / "runs.json").read_text().splitlines()]
        if mongo["status"] != "COMPLETED":
            raise AssertionError(f"{what} Mongo status {mongo['status']}")
        out[f"{what}_run_files"] = files
        if scalars:
            metrics = json.loads((run_dir / "metrics.json").read_text())
            if set(metrics) != {"train_loss", "val_loss", "val_mIoU",
                                "val_bIoU"} or not all(
                    len(v) == 1 and math.isfinite(v[0][1])
                    for v in metrics.values()):
                raise AssertionError(f"{what} metrics.json {metrics}")
            out[f"{what}_metrics"] = metrics

    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        os.environ["PEMP_HTTP_STATIC"] = str(Path(tmp) / "static")
        try:
            md = f"g.model_dir={Path(tmp) / 'model_dir'}"
            # 1. the pretrained file and the stage-1 trunk built from it
            path = Path(pretrained.PRETRAINED_FILES["resnet50"])
            path.parent.mkdir()
            sd = torchvision_resnet50(torch, 1234)
            torch.save(sd, path)
            out["pretrained_file_mb"] = path.stat().st_size / 2 ** 20
            t0 = time.perf_counter()
            pretrained.load_state_dict(path)
            out["pretrained_load_ms"] = (time.perf_counter() - t0) * 1e3
            cfg1 = entry1.ex.assemble("train", dict(
                a.split("=", 1) for a in RUN1_ARGS[2:] if "=" in a))
            with mock.patch.object(pretrained, "try_load_backbone",
                                   timer.wrap("pretrained",
                                              pretrained.try_load_backbone)):
                got = entry1.build_model(cfg1, device).state_dict()
            out["pretrained_init_ms"] = timer.s["pretrained"] * 1e3
            seeded = registry.build("pemp_stage1", cfg1)
            seeded.reset_parameters(torch.Generator().manual_seed(cfg1.seed))
            seeded = seeded.state_dict()
            prefix = "encoder.backbone."
            bad = trunk_vs_file(torch, got, sd, device, prefix)
            head_moved = [k for k in got if not k.startswith(prefix)
                          and not torch.equal(got[k], seeded[k].to(device))]
            has_layer4 = any(k.startswith(f"{prefix}layer4") for k in got)
            if bad or head_moved or has_layer4:
                raise AssertionError(
                    f"pretrained stage 1: trunk tensors off the file {bad}, "
                    f"head tensors off the seeded draw {head_moved}, "
                    f"layer4 {has_layer4}")
            out["pretrained_trunk_tensors"] = sum(
                k.startswith(prefix) and not k.endswith("num_batches_tracked")
                for k in got)
            del got, seeded

            # 2. stage 1 train (observed, -p, Mongo), then a test run
            patches = [mock.patch.object(config_lib.Run, "log_scalar",
                                         timer.wrap("log_scalar",
                                                    config_lib.Run.log_scalar)),
                       mock.patch.object(config_lib.Experiment, "open_run",
                                         timer.wrap("open_run",
                                                    config_lib.Experiment
                                                    .open_run)),
                       mock.patch.object(observers.MongoRunObserver, "finish",
                                         timer.wrap("mongo_finish",
                                                    observers.MongoRunObserver
                                                    .finish))]
            for p in patches:
                p.start()
            try:
                r1 = counted_run("stage1_train", entry1.main, RUN1_ARGS + [md])
                out["records_host_ms_per_epoch"] = (
                    timer.s["log_scalar"] + timer.s["mongo_finish"]) \
                    * 1e3 / cfg1.tr.total_epochs
                out["open_run_host_ms"] = timer.s["open_run"] * 1e3
                run1 = r1["train"]["run_id"]
                rt = counted_run("stage1_test", entry1.main, MAIN_ARGS[:1] + [
                    "with", *MAIN_ARGS[2:], "data.test_n=16", md,
                    "g.mongodb=True", f"exp_id={run1}"])
            finally:
                for p in patches:
                    p.stop()
            steps = len(r1["train"]["losses"])
            evals = 2 * -(-cfg1.data.test_n // cfg1.data.test_bs)
            want = {"stage1_train": predicted(steps, evals, 1),
                    "stage1_test": predicted(0, 2, 1)}
            tag_dir = Path(tmp) / "model_dir" / "pemp_stage1"
            records(tag_dir / str(run1), "stage1_train", True)
            records(tag_dir / str(run1 + 1), "stage1_test", False)
            if (steps != cfg1.data.train_n // cfg1.data.bs
                    or not all(math.isfinite(x) for x in r1["train"]["losses"])
                    or not math.isfinite(rt["miou"])
                    or abs(rt["miou"] - r1["test"]["miou"]) > 1e-3):
                raise AssertionError(f"stage-1 run {r1}, test run {rt}")

            # 3. stage 2 behind the stage-1 run, from the same file
            built = []
            build2 = entry2.build_model

            def keep(cfg, dev):
                model = build2(cfg, dev)
                if not built:       # before the first step
                    built.append({k: v.clone() for k, v in
                                  model.stage2.state_dict().items()})
                return model

            with mock.patch.object(entry2, "build_model", keep):
                r2 = counted_run("stage2_train", entry2.main, RUN2_ARGS + [
                    md, f"s1.id={run1}"])
            pads = {"conv1": 1, **{f"layer{s}.0.{m}": 2 for s in (1, 2, 3)
                                   for m in ("conv1", "downsample.0")}}
            bad = trunk_vs_file(torch, built[0], sd, device, prefix, pads)
            if bad:
                raise AssertionError(f"stage-2 trunk off the file or its "
                                     f"pads not zero: {bad}")
            steps2 = len(r2["train"]["losses"])
            want["stage2_train"] = predicted(steps2, evals, 2)
            records(Path(tmp) / "model_dir" / "pemp_stage2"
                    / str(r2["train"]["run_id"]), "stage2_train", True)
            if not math.isfinite(r2["test"]["miou"]):
                raise AssertionError(f"stage-2 run {r2}")

            # 4. visualize the stage-1 run: K1/K2 once an episode, indices
            flags = []
            chain = stage1.mpm_chain_packed

            def chain_flags(*args, **kwargs):
                flags.append(kwargs.get("return_indices", False))
                return chain(*args, **kwargs)

            with mock.patch.object(stage1, "mpm_chain_packed", chain_flags):
                folder = Path(counted_run("visualize", entry1.main, VIS_ARGS + [
                    md, f"exp_id={run1}"]))
            want["visualize"] = predicted(0, VIS_EPISODES, 1)
            episodes = sorted(p for p in folder.iterdir())
            kinds = [sorted(re.sub(r".*_((sup|qry)_[a-z]+)_synth.*", r"\1",
                                   f.name) for f in ep.iterdir())
                     for ep in episodes]
            data = [json.loads((ep / "data.json").read_text())
                    for ep in episodes]
            if (len(episodes) != VIS_EPISODES or flags != [True] * len(flags)
                    or len(flags) != VIS_EPISODES
                    or any(k != ["data.json", "qry_color", "qry_img",
                                 "qry_msk", "qry_pred", "sup_img", "sup_msk"]
                           for k in kinds)
                    or any(set(d) != {"acc", "cls_id", "cls_name", "qry",
                                      "sup"} for d in data)):
                raise AssertionError(f"visualize: {len(episodes)} episodes, "
                                     f"chain return_indices {flags}, files "
                                     f"{kinds}, data {data}")
            out["visualize_folder"] = folder.name
            out["visualize_data"] = data
        finally:
            os.chdir(cwd)
            if static is None:
                os.environ.pop("PEMP_HTTP_STATIC", None)
            else:
                os.environ["PEMP_HTTP_STATIC"] = static
    if launches != want:
        raise AssertionError(f"run path launches {launches}, want {want}")
    out.update({"launches": launches, "launches_expected": want,
                "stage1_losses": r1["train"]["losses"],
                "stage1_chained_test": r1["test"], "stage1_test_run": rt,
                "stage2_losses": r2["train"]["losses"],
                "stage2_chained_test": r2["test"],
                "record_calls": timer.calls,
                "records_timing": "host clock (time.perf_counter)"})
    emit(out)
    return {k: sum(counts[k] for counts in launches.values())
            for k in STEP_LAUNCHES}


def predicted(steps, evals, chains=1):
    """K1-K5's launches (and the K4 backward passes) of ``steps`` train
    steps and ``evals`` eval batches of ``chains`` mpm chains each."""
    want = {k: (chains if k in ("assign", "match") else 1)
            * (steps * STEP_LAUNCHES[k] + evals * EVAL_LAUNCHES[k])
            for k in STEP_LAUNCHES}
    want["mpm_backward"] = steps
    return want


def smooth_jpeg(rng, h, w, path):
    """A JPEG of natural-image-like statistics (low-resolution noise
    upsampled): noise JPEGs decode about twice as slowly as photos."""
    import numpy as np
    from PIL import Image
    low = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
    Image.fromarray(low).resize((w, h), Image.BILINEAR).save(path, quality=90)


def blob(rng, h, w):
    """An ellipse mask of random centre and radii, bool [h, w]."""
    import numpy as np
    cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
    ry, rx = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
    yy, xx = np.ogrid[:h, :w]
    return (yy - cy) ** 2 / ry ** 2 + (xx - cx) ** 2 / rx ** 2 <= 1.0


def write_voc_tree(root: Path, seed: int = 0) -> int:
    """A PASCAL VOC tree (``JPEGImages/``, ``Binary_map_aug/{train,val}/
    <cls>/`` masks and ``<cls>.txt`` lists) of all 20 classes, train and
    val, VOC_PER_CLASS samples each at VOC_SIZES; returns the image
    count."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    (root / "JPEGImages").mkdir(parents=True)
    n = 0
    for subset in ("train", "val"):
        for cls in range(1, 21):
            cdir = root / "Binary_map_aug" / subset / str(cls)
            cdir.mkdir(parents=True)
            names = []
            for i in range(VOC_PER_CLASS):
                h, w = VOC_SIZES[n % len(VOC_SIZES)]
                name = f"{subset}_{cls:02d}_{i}"
                smooth_jpeg(rng, h, w, root / "JPEGImages" / f"{name}.jpg")
                Image.fromarray(blob(rng, h, w).astype(np.uint8) * 255).save(
                    cdir / f"{name}.png")
                names.append(name)
                n += 1
            (root / "Binary_map_aug" / subset / f"{cls}.txt").write_text(
                "\n".join(names) + "\n")
    return n


def rle_counts(mask):
    """Column-major run lengths of a {0, 1} mask, from a 0-run."""
    import numpy as np
    flat = mask.T.ravel().astype(np.int8)
    edges = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], edges, [flat.size]])
    counts = np.diff(bounds).tolist()
    return counts if flat[0] == 0 else [0] + counts


def rle_string(counts) -> str:
    """COCO's compressed count string of run lengths."""
    s = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = x != (-1 if ch & 0x10 else 0)
            s.append(chr((ch | 0x20 if more else ch) + 48))
    return "".join(s)


def write_coco_tree(root: Path, seed: int = 0) -> dict:
    """A COCO tree (``annotations/instances_{train,val}2014.json``,
    ``{train,val}2014/`` JPEGs) over the 80 original category ids,
    COCO_PER_CAT images each a subset at COCO_SIZES. Each image holds an
    instance of its category as a polygon with fractional vertices (every
    third image two rings), a second instance (every fifth an
    uncompressed RLE, every seventh a compressed one, else a polygon),
    and another category's instance; returns the counts of each kind."""
    import numpy as np
    from pemp_tpu_torch.data.coco import CV_SPLIT
    rng = np.random.RandomState(seed)
    cats = [c for split in CV_SPLIT for c in split]
    (root / "annotations").mkdir(parents=True)
    kinds = {"images": 0, "polygon": 0, "multi_ring": 0, "rle": 0,
             "rle_string": 0}

    def ring(cy, cx, ry, rx, k=12):
        t = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.6, 1.0, k)
        return np.stack([cx + rx * r * np.cos(t), cy + ry * r * np.sin(t)],
                        1).ravel().round(2).tolist()

    for subset in ("train2014", "val2014"):
        (root / subset).mkdir()
        images, anns = [], []
        for cat in cats:
            for i in range(COCO_PER_CAT):
                img_id = len(images) + 1
                h, w = COCO_SIZES[img_id % len(COCO_SIZES)]
                name = f"COCO_{subset}_{img_id:012d}.jpg"
                smooth_jpeg(rng, h, w, root / subset / name)
                images.append({"id": img_id, "height": h, "width": w,
                               "file_name": name})
                segs = [[ring(h / 2, w / 3, h / 4, w / 5)]]
                if img_id % 3 == 0:
                    segs[0].append(ring(h / 3, 3 * w / 4, h / 8, w / 10))
                    kinds["multi_ring"] += 1
                if img_id % 5 == 0:
                    segs.append({"size": [h, w],
                                 "counts": rle_counts(blob(rng, h, w))})
                    kinds["rle"] += 1
                elif img_id % 7 == 0:
                    segs.append({"size": [h, w], "counts": rle_string(
                        rle_counts(blob(rng, h, w)))})
                    kinds["rle_string"] += 1
                else:
                    segs.append([ring(3 * h / 4, w / 2, h / 6, w / 6)])
                other = cats[(cats.index(cat) + 1) % len(cats)]
                for c, seg in [(cat, s) for s in segs] + [
                        (other, [ring(h / 4, 3 * w / 4, h / 8, w / 8)])]:
                    anns.append({"id": len(anns) + 1, "image_id": img_id,
                                 "category_id": c, "segmentation": seg,
                                 "iscrowd": int(isinstance(seg, dict))})
                kinds["polygon"] += len(segs) + 1 - isinstance(segs[1], dict)
        kinds["images"] += len(images)
        (root / "annotations" / f"instances_{subset}.json").write_text(
            json.dumps({"images": images, "annotations": anns,
                        "categories": [{"id": c} for c in cats]}))
    return kinds


def chain_spy(fn, seen=None, keep=None):
    """``fn`` (stage 1's mpm chain or ``plain_chain``) keeping its inputs
    in ``seen`` and, given ``keep`` [B,Q,n,2], zeroing the logits'
    cotangent where ``keep`` is 0 (the forward is unchanged)."""
    def chain(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
              return_indices=False):
        if seen is not None:
            seen[:] = [x.detach() for x in (fts, sup_fg, sup_bg, ctr)] + [
                protos, dist_scalar]
        out = fn(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                 return_indices)
        if keep is not None:
            out.register_hook(lambda g: g * keep)
        return out
    return chain


def f32_grads(torch, model, t, loss_fn, chain):
    """One train step's loss and trainable gradients of ``model`` on the
    device tensors ``t`` (dropout seed 7), ``chain`` in place of stage 1's
    ``mpm_chain_packed``."""
    from unittest import mock

    from pemp_tpu_torch.models import pemp_stage1 as stage1
    model.zero_grad(set_to_none=True)
    model.set_dropout_generator(torch.Generator(device="cuda").manual_seed(7))
    with mock.patch.object(stage1, "mpm_chain_packed", chain):
        logits = model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
        loss = loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                       t["qry_msk"].reshape(-1, *t["qry_msk"].shape[-2:]))
        loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in
                         model.named_parameters() if p.requires_grad}


def rel_l2(want, got):
    """Each gradient's relative L2 distance, ``got`` from ``want``."""
    return {k: ((got[k] - want[k]).norm()
                / want[k].norm().clamp(min=1e-30)).item() for k in want}


def f32_step_vs_plain(torch, K, model, t, loss_fn, what):
    """One float32 train step's loss and gradients of ``model`` on the
    device tensors ``t``, with the mpm kernels and with the plain mpm:
    the loss within TRAIN_LOSS_RTOL, every gradient within
    TRAIN_GRAD_RTOL (relative L2)."""
    before = dict(K.launches)
    loss_k, grads_k = f32_grads(torch, model, t, loss_fn, K.mpm_chain_packed)
    if any(K.launches[k] == before[k] for k in K.launches):
        raise AssertionError(f"the kernel {what} step skipped an mpm kernel: "
                             f"{before} -> {K.launches}")
    before = dict(K.launches)
    loss_p, grads_p = f32_grads(torch, model, t, loss_fn, plain_chain)
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError(f"the plain {what} step launched an mpm kernel")
    rel = rel_l2(grads_p, grads_k)
    worst = max(rel, key=rel.get)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_max_rel_l2": rel[worst], "grad_worst_leaf": worst,
           "grad_leaves": len(rel), "grad_rel_l2": rel,
           "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                         "grad_rel_l2": TRAIN_GRAD_RTOL}}
    if out["loss_rel_err"] > TRAIN_LOSS_RTOL or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"f32 {what} step kernels vs plain: {out}")
    return out


def real_batch_gap(torch, K, model, t, loss_fn):
    """The f32 step on one real batch, mpm kernels against the plain mpm,
    and where its gradient gap comes from. The max over p has no gradient
    at a tie: the kernel's backward follows its argmax, the plain chain's
    autograd its own (an exact tie it splits), and two prototypes that tie
    in value need not in gradient. So on the chain's inputs of the kernel
    step: the (pixel, class) entries where the two argmax differ or the
    plain sims tie exactly, the largest top-two gap of the plain sims
    there, and the gap again with the logits' cotangent zeroed at those
    entries in both steps (``chain_spy``). Returns the readings; the
    caller checks them."""
    from pemp_tpu_torch.ops.prototypes import meta_prototype_assign
    seen = []
    loss_k, grads_k = f32_grads(torch, model, t, loss_fn,
                                chain_spy(K.mpm_chain_packed, seen))
    loss_p, grads_p = f32_grads(torch, model, t, loss_fn, plain_chain)
    fts, sup_fg, sup_bg, ctr, protos, scale = seen
    s = sup_fg.shape[1]
    with torch.no_grad():
        _, inds_k = K.mpm_chain_packed(fts, sup_fg, sup_bg, ctr, protos,
                                       scale, return_indices=True)
        _, inds_p = plain_chain(fts, sup_fg, sup_bg, ctr, protos, scale,
                                return_indices=True)
        fg, bg = meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr,
                                       protos)
        margin = top2_margin(torch, fts[:, s:], fg, bg, scale)
    moved = (inds_k != inds_p) | (margin == 0)
    keep = (~moved).float()
    _, masked_k = f32_grads(torch, model, t, loss_fn,
                            chain_spy(K.mpm_chain_packed, keep=keep))
    _, masked_p = f32_grads(torch, model, t, loss_fn,
                            chain_spy(plain_chain, keep=keep))
    rel, rel_m = rel_l2(grads_p, grads_k), rel_l2(masked_p, masked_k)
    worst, worst_m = max(rel, key=rel.get), max(rel_m, key=rel_m.get)
    return {"loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
            "grad_max_rel_l2": rel[worst], "grad_worst_leaf": worst,
            "argmax_differs": int((inds_k != inds_p).sum()),
            "exact_ties": int((margin == 0).sum()),
            "pixels_masked": int(moved.any(dim=-1).sum()),
            "pixels": int(moved[..., 0].numel()),
            "near_ties": int((margin <= MARGIN).sum()),
            "max_margin_where_masked": (float(margin[moved].max())
                                        if moved.any() else None),
            "grad_max_rel_l2_masked": rel_m[worst_m],
            "grad_worst_leaf_masked": worst_m}


def seeded_batch(ds, loader, seed, i):
    """The loader's ``i``-th batch of episodes, drawn on this thread after
    ``random.seed(seed)`` (the loader's threads would interleave their
    augmentation draws)."""
    from pemp_tpu_torch.data.loader import _collate
    random.seed(seed)
    chunk = list(loader._batches())[i]
    return _collate([ds.get_episode(e) for e in chunk])


def real_batch_gaps(torch, K, model, ds, loader, loss_fn, device):
    """``real_batch_gap`` on each of REAL_GAP_BATCHES, (seed, i): the
    ``seeded_batch``. Every batch: the loss within TRAIN_LOSS_RTOL;
    the gradients without the masked entries within TRAIN_GRAD_RTOL;
    every masked entry a tie (plain top-two gap <= MARGIN), on at most
    1 - MAIN_AGREE of the pixels; the whole gradient within
    TIE_GRAD_RTOL."""
    out = []
    for seed, i in REAL_GAP_BATCHES:
        batch = seeded_batch(ds, loader, seed, i)
        t = {k: torch.from_numpy(batch[k]).to(device)
             for k in ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")}
        gap = {"seed": seed, "batch": i, "cls": batch["cls"].tolist(),
               **real_batch_gap(torch, K, model, t, loss_fn)}
        out.append(gap)
        margin = gap["max_margin_where_masked"]
        if (gap["loss_rel_err"] > TRAIN_LOSS_RTOL
                or gap["grad_max_rel_l2_masked"] > TRAIN_GRAD_RTOL
                or (margin is not None and margin > MARGIN)
                or gap["pixels_masked"] > (1 - MAIN_AGREE) * gap["pixels"]
                or gap["grad_max_rel_l2"] > TIE_GRAD_RTOL):
            raise AssertionError(f"f32 real-data step kernels vs plain: "
                                 f"{out}")
    return {"batches": out,
            "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                          "grad_rel_l2_masked": TRAIN_GRAD_RTOL,
                          "tie_margin": MARGIN,
                          "pixels_masked_share": 1 - MAIN_AGREE,
                          "grad_rel_l2": TIE_GRAD_RTOL}}


def loader_costs(cfg, mode):
    """Host ms to render one batch of ``mode`` on one thread (median of
    LOADER_BATCHES), decoding every image (``data.cache=False``) and
    from decoded images in host RAM (``data.cache=True``, after one
    pass); each episode's draws seeded alike."""
    import random

    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.data.loader import _collate
    out = {}
    for cache in (False, True):
        cfg = copy.deepcopy(cfg)
        cfg.data.cache = cache
        ds, loader, _ = datasets.load(cfg, mode)
        ds.sample_tasks()
        chunks = list(loader._batches())[:LOADER_BATCHES]
        for rep in range(1 + cache):      # the cached pass after a warm one
            samples = []
            for chunk in chunks:
                random.seed(chunk[0])
                t0 = time.perf_counter()
                _collate([ds.get_episode(i) for i in chunk])
                samples.append((time.perf_counter() - t0) * 1e3)
        key = "cached" if cache else "decoded"
        out[f"{mode}_batch_host_ms_{key}"] = statistics.median(samples)
    return out


def fed_steps(torch, trainer, loader):
    """Train steps fed by ``loader``'s background threads, as the train
    loop runs them (no synchronize between steps): the mean ms a step
    and the mean ms the step waited on the loader's queue, over FED_STEPS
    steps after LOADER_WARM."""
    it = iter(loader)
    for _ in range(LOADER_WARM):
        trainer.train_step(next(it))
    torch.cuda.synchronize()
    wait = 0.0
    t0 = time.perf_counter()
    for _ in range(FED_STEPS):
        w0 = time.perf_counter()
        batch = next(it)
        wait += time.perf_counter() - w0
        trainer.train_step(batch)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    del it
    return {"step_ms": total / FED_STEPS * 1e3,
            "loader_wait_ms": wait / FED_STEPS * 1e3}


def real_data_path_phase(torch, K, M):
    """PEMP stage 1 at full width on the real-data layer: miniature
    PASCAL and COCO trees written in a temporary directory; ``train`` on
    PASCAL (cedt, 4 steps, online eval, chained test), then ``test`` runs
    of its snapshot at test batch 1 and 4 whose TP/FP/FN counts on the
    original-resolution GT must be equal (batch 4 with the forward one
    episode at a time; batched, within MAIN_AGREE); K1-K5's launches against
    the prediction from the step and batch counts; on a real batch the
    f32 step, an eval batch and the EDT with the kernels against their
    plain versions; COCO's file lists, a ``test`` and two train steps,
    the C++ rasterizer loaded and equal to its numpy version on every
    annotation; the loader's host ms a batch, the train step fed by it
    (serially, and through the ``DevicePrefetcher``) against the same step
    fed by SYNTH, its wait on the loader and the card's idle share."""
    from unittest import mock

    import numpy as np

    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import evaluator as evaluator_mod
    from pemp_tpu_torch.core import losses as loss_lib
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.data import datasets, mask_ops
    from pemp_tpu_torch.data.coco_index import COCOIndex
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    from pemp_tpu_torch.ops import edt
    from pemp_tpu_torch.parallel.step import DevicePrefetcher

    device = torch.device("cuda")
    out = {"phase": "real_data_path"}
    start = time.perf_counter()
    launches, want = {}, {}
    rounds = {}

    class Recorded(evaluator_mod.FewShotMetric):
        """Keeps every eval round's counts, by the run in ``current``."""
        current = None

        def __init__(self, classes):
            super().__init__(classes)
            rounds.setdefault(Recorded.current, []).append(self)

    def counted_run(what, argv, expect):
        K.reset_launches()
        M.reset_launches()
        Recorded.current = what
        t0 = time.perf_counter()
        with mock.patch.object(evaluator_mod, "FewShotMetric", Recorded):
            result = entry.main(argv)
        out[f"{what}_wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches[what] = {**K.launches, **M.launches, **K.backward_calls}
        want[what] = expect
        return result

    def batches(n, bs):
        return -(-n // bs)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        voc, coco, md = tmp / "voc", tmp / "coco", f"g.model_dir={tmp / 'md'}"
        t0 = time.perf_counter()
        out["voc_images"] = write_voc_tree(voc)
        out["coco_annotations"] = write_coco_tree(coco)
        out["write_trees_s"] = time.perf_counter() - t0
        voc_arg, coco_arg = f"data.base_dir={voc}", f"data.base_dir={coco}"

        # 1. PASCAL: train (observed: a snapshot), then its two test runs
        cfg = entry.ex.assemble("train", dict(
            a.split("=", 1) for a in REAL_ARGS[2:] + [voc_arg]))
        steps = cfg.data.train_n // cfg.data.bs
        evals = 2 * batches(cfg.data.test_n, cfg.data.test_bs)
        r = counted_run("pascal_train", REAL_ARGS + [voc_arg, md],
                        predicted(steps, evals))
        run_id = r["train"]["run_id"]
        if len(r["train"]["losses"]) != steps or not all(
                math.isfinite(x) for x in r["train"]["losses"] + [
                    r["test"]["miou"], r["test"]["loss"]]):
            raise AssertionError(f"PASCAL train run {r}")
        out["pascal_train"] = {"losses": r["train"]["losses"],
                               "chained_test": r["test"]}
        # test batch 1 and 4 on the original-resolution GT. cuDNN picks
        # its convolution algorithms by batch size, so the batched
        # forward is not bit-identical to four forwards of one episode
        # (bf16 and f32 alike): the counts of "test_bs4_per_episode"
        # (the forward one episode at a time, everything after it
        # batched: the list of GTs, the per-episode resize, the metric
        # accumulation) must equal batch 1's; the batched run as users
        # run it may differ only at near ties, within MAIN_AGREE
        orig = entry.Stage1Runtime.apply_eval

        def per_episode(self, model, t):
            b = t["qry_rgb"].shape[0]
            return torch.cat([orig(self, model, {k: v[i:i + 1]
                                                 for k, v in t.items()})
                              for i in range(b)])

        tests = {}
        for what, bs, forward in (("test_bs1", 1, orig),
                                  ("test_bs4_per_episode", 4, per_episode),
                                  ("test_bs4", 4, orig)):
            n_forward = REAL_TEST_N if forward is per_episode else batches(
                REAL_TEST_N, bs)
            with mock.patch.object(entry.Stage1Runtime, "apply_eval",
                                   forward):
                tests[what] = counted_run(
                    f"pascal_{what}", REAL_TEST_ARGS + [
                        voc_arg, md, f"exp_id={run_id}",
                        f"data.test_bs={bs}"], predicted(0, n_forward))
            tests[what]["counts"] = [m.stat.tolist()
                                     for m in rounds[f"pascal_{what}"]]
        out["pascal_tests"] = tests
        one = np.asarray(tests["test_bs1"]["counts"])
        exact = np.asarray(tests["test_bs4_per_episode"]["counts"])
        batched = np.asarray(tests["test_bs4"]["counts"])
        # a pixel whose prediction flips moves one count of the bg row
        # (TP or FP); the valid pixels: the bg row's TP + FP + FN and the
        # classes' TP
        flips = int(np.abs(batched - one)[:, 0, :2].sum())
        pixels = int(one[:, 0].sum() + one[:, 1:, 0].sum())
        out["batched_vs_bs1"] = {"bg_row_count_moves": flips,
                                 "pixels": pixels,
                                 "share_agreeing": 1 - flips / pixels,
                                 "counts_diff": (batched - one).tolist()}
        if (not np.array_equal(exact, one) or not one.sum()
                or 1 - flips / pixels < MAIN_AGREE):
            emit({"phase": "real_data_path", "failed": {
                "counts": {k: v["counts"] for k, v in tests.items()},
                "batched_vs_bs1": out["batched_vs_bs1"]}})
            raise AssertionError("test batch 1 and 4: counts differ")
        cfg_test = entry.ex.assemble("test", dict(
            a.split("=", 1) for a in REAL_TEST_ARGS[2:] + [
                voc_arg, "data.test_bs=4"]))
        ds, loader, _ = datasets.load(cfg_test, "test")
        ds.sample_tasks()
        ebatch = next(iter(loader))
        gt_sizes = sorted({tuple(g.shape[-2:]) for g in ebatch["qry_msk"]})
        if (cfg.data.height, cfg.data.width) in gt_sizes or len(gt_sizes) < 2:
            raise AssertionError(f"test GT sizes {gt_sizes}")
        out["test_gt_sizes"] = gt_sizes

        # 2. COCO: the file lists, a test run and two train steps
        cfg_coco = entry.ex.assemble("train", dict(
            a.split("=", 1) for a in COCO_TRAIN_ARGS[2:] if "=" in a))
        cfg_coco.data.base_dir = str(coco)
        t0 = time.perf_counter()
        mask_ops.get_lib()                  # g++, from the checkout's source
        out["rasterizer_build_ms"] = (time.perf_counter() - t0) * 1e3
        gen = {}
        for mode in ("train", "test"):
            t0 = time.perf_counter()
            datasets.load(cfg_coco, mode)
            gen[mode] = (time.perf_counter() - t0) * 1e3
        out["coco_file_list_ms"] = gen
        lists = {p.name: {c: len(v) for c, v in json.loads(
            p.read_text()).items() if v} for p in coco.glob("*_list_*.json")}
        if sorted(lists) != ["train2014_list_16.json", "val2014_list_0.json"]:
            raise AssertionError(f"COCO file lists {sorted(lists)}")
        out["coco_list_images"] = {k: sum(v.values())
                                   for k, v in lists.items()}
        calls = mask_ops.native_calls
        rc = counted_run("coco_test", COCO_TEST_ARGS + [coco_arg],
                         predicted(0, batches(REAL_TEST_N, 4)))
        rt = counted_run("coco_train", COCO_TRAIN_ARGS + [coco_arg, md],
                         predicted(2, 1))
        if not (math.isfinite(rc["miou"]) and len(rt["train"]["losses"]) == 2
                and all(math.isfinite(x) for x in rt["train"]["losses"])):
            raise AssertionError(f"COCO runs: test {rc}, train {rt}")
        out["coco_test"] = rc
        out["coco_train_losses"] = rt["train"]["losses"]
        # the C++ rasterizer loaded, used, and equal to numpy everywhere
        bad, n_ann = [], 0
        t_native = t_numpy = 0.0
        for subset in ("train2014", "val2014"):
            index = COCOIndex(coco / "annotations" / f"instances_{subset}.json")
            for ann in index.anns.values():
                meta = index.imgs[ann["image_id"]]
                h, w = meta["height"], meta["width"]
                t0 = time.perf_counter()
                a = mask_ops.ann_to_mask(ann, h, w)
                t1 = time.perf_counter()
                b = mask_ops.ann_to_mask(ann, h, w, native=False)
                t_native += t1 - t0
                t_numpy += time.perf_counter() - t1
                n_ann += 1
                if not np.array_equal(a, b) or not a.any():
                    bad.append(ann["id"])
        if not mask_ops.loaded() or mask_ops.native_calls <= calls or bad:
            raise AssertionError(f"rasterizer: loaded {mask_ops.loaded()}, "
                                 f"native calls {calls} -> "
                                 f"{mask_ops.native_calls}, differing or "
                                 f"empty annotations {bad}")
        out["rasterizer"] = {
            "native_loaded": True, "library": mask_ops.lib_path().name,
            "annotations_equal_numpy": n_ann,
            "native_calls_in_runs": mask_ops.native_calls - calls,
            "native_ms_per_annotation": t_native / n_ann * 1e3,
            "numpy_ms_per_annotation": t_numpy / n_ann * 1e3}

        # 3. the kernels against their plain versions on real batches
        model = entry.build_model(cfg, device)
        step = evaluator_mod.make_fast_eval_step(model, device,
                                                 entry.Stage1Runtime(
                                                     cfg).apply_eval,
                                                 with_logits=True,
                                                 compact_wire=cfg.dev
                                                 .compact_wire)
        before = dict(K.launches)
        ck, lk, fk = step(ebatch)
        with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
            cp, lp, fp = step(ebatch)
        torch.cuda.synchronize()
        if K.launches["assign"] != before["assign"] + 1:
            raise AssertionError("the kernel eval batch launched no assign")
        err = float(np.abs(fk - fp).max())
        pixels = sum(int(np.prod(g.shape)) for g in ebatch["qry_msk"])
        count_diff = int(np.abs(ck - cp).sum()) / 2
        out["eval_batch_vs_plain"] = {
            "feature_logits_max_abs_err": err,
            "pixels_counted_differently": count_diff,
            "share_agreeing": 1 - count_diff / pixels,
            "loss_rel_err": float(np.abs(lk - lp).max() / np.abs(lp).max())}
        if err > LOGIT_ATOL or 1 - count_diff / pixels < MAIN_AGREE:
            raise AssertionError(f"real eval batch kernels vs plain: "
                                 f"{out['eval_batch_vs_plain']}")
        cfg32 = copy.deepcopy(cfg)
        cfg32.dev.precision = "f32"
        base32 = entry.build_model(cfg32, device).train()
        base32.freeze()
        ds32, loader32, _ = datasets.load(cfg32, "train")
        ds32.sample_tasks()
        out["f32_step_vs_plain"] = real_batch_gaps(
            torch, K, base32, ds32, loader32, loss_lib.get(cfg32), device)
        del base32
        tbatch = seeded_batch(ds32, loader32, cfg32.seed, 0)
        qry_msk = torch.from_numpy(tbatch["qry_msk"]).to(device)
        feature = edt.boundary_map(qry_msk.reshape(-1, *qry_msk.shape[-2:]))
        if not torch.equal(edt.edt2(feature).cpu(), edt.edt2(feature.cpu())):
            raise AssertionError("real labels: EDT on the card differs from "
                                 "the CPU plain EDT")
        out["edt2_card_bit_equals_cpu"] = True

        # 4. the loader's cost, and the train step fed by it
        costs = loader_costs(cfg, "train")
        costs.update(loader_costs(cfg_test, "test"))
        out["loader"] = costs
        model.train()
        params = model.freeze()
        trainer = Trainer(cfg, Run(None, None), model,
                          solver.make_optimizer(cfg.tr, params), params,
                          entry.Stage1Runtime(cfg),
                          solver.LRPolicy(cfg.tr, 100), device)
        model.set_dropout_generator(
            torch.Generator(device=device).manual_seed(0))
        n = (LOADER_WARM + FED_STEPS) * cfg.data.bs
        fed = {}
        for name, extra in (("synth", {"data.dataset": "SYNTH"}),
                            ("pascal_decoded", {"data.cache": "False"}),
                            ("pascal_cached", {}),
                            ("pascal_cached_prefetched", {})):
            fcfg = entry.ex.assemble("train", {
                **dict(a.split("=", 1) for a in REAL_ARGS[2:] + [voc_arg]),
                "data.train_n": str(n), "data.seed": "4321", **extra})
            ds_f, loader_f, _ = datasets.load(fcfg, "train")
            ds_f.sample_tasks()
            if name.endswith("_prefetched"):
                loader_f = DevicePrefetcher(
                    loader_f, device, fcfg.dev.prefetch,
                    fcfg.dev.compact_wire, entry.Stage1Runtime.device_keys)
            fed[name] = fed_steps(torch, trainer, loader_f)
        prof = device_profile(torch, lambda: trainer.train_step(tbatch), {
            "mpm_kernels": ["assign_kernel", "match_kernel"],
            "mpm_backward_kernels": ["mpm_bwd_kernel"],
            "minplus_kernel": ["minplus_kernel"]})
        device_ms = prof["device_us_total"] / 1e3
        for v in fed.values():
            v["device_idle_share"] = 1 - device_ms / v["step_ms"]
        out["fed_train_step"] = fed
        out["train_step_device_ms"] = device_ms
        out["profile"] = prof
        del trainer, model

    if launches != want:
        raise AssertionError(f"real data path launches {launches}, want "
                             f"{want}")
    out.update({"wall_s": time.perf_counter() - start,
                "launches": launches, "launches_expected": want,
                "args": {"pascal_train": REAL_ARGS,
                         "pascal_test": REAL_TEST_ARGS,
                         "coco_test": COCO_TEST_ARGS,
                         "coco_train": COCO_TRAIN_ARGS},
                "timing": "host clock (time.perf_counter)",
                "tolerance": {"logit_atol": LOGIT_ATOL, "agree": MAIN_AGREE,
                              "counts_bs1_vs_bs4_per_episode": "equal",
                              "counts_bs1_vs_bs4_batched":
                                  "share_agreeing >= agree"}})
    emit(out)
    return {k: sum(c[k] for c in launches.values()) for k in STEP_LAUNCHES}


def to_card(batch, keys, device, compact_wire=True):
    """A host batch's arrays ``keys`` on ``device`` in the compute dtypes,
    as the port's steps take them (``parallel/step.py``)."""
    from pemp_tpu_torch.parallel.step import device_batch, unpack_batch
    return unpack_batch(device_batch(batch, device, compact_wire, keys))


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


WORLD_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
             "NUM_PROCESSES", "PROCESS_ID")


def sub_env(**world):
    """This process's environment without a world, plus ``world``."""
    import os
    env = {k: v for k, v in os.environ.items() if k not in WORLD_ENV}
    env.update({k: str(v) for k, v in world.items()})
    return env


def world_train(torch, K, M, precision, bs, steps, model_dir,
                keep_init=False, extra=()):
    """PEMP stage 1's ``train`` (``EntryRuntime._train``, unrecorded) at
    ``bs`` episodes a process for ``steps`` steps and one online eval of
    two batches of 4, in the world this process is in (``extra``: more
    ``key=value`` overrides): the global losses, K1-K5's launches, the
    final (and with ``keep_init`` the initial) state on the CPU, the world
    and its backend, and each step's host ms (until its loss is on the
    host, which follows the step's last kernel on the stream)."""
    from unittest import mock

    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import experiment
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.parallel import mesh

    world = mesh.process_count()
    args = dict(a.split("=", 1) for a in TRAIN_ARGS[2:])
    args.update({"data.bs": str(bs), "data.train_n": str(steps * bs * world),
                 "data.test_bs": "4", "data.test_n": "8",
                 "dev.precision": precision, "g.model_dir": str(model_dir)})
    args.update(a.split("=", 1) for a in extra)
    cfg = entry.ex.assemble("train", args)
    kept = {}

    def build(cfg, device):
        kept["model"] = entry.build_model(cfg, device)
        if keep_init:
            kept["init"] = {k: v.detach().cpu().clone()
                            for k, v in kept["model"].state_dict().items()}
        return kept["model"]

    step_s = []

    class TimedTrainer(Trainer):
        def train_step(self, batch):
            t0 = time.perf_counter()
            loss = super().train_step(batch)
            loss.item()
            step_s.append(time.perf_counter() - t0)
            return loss

    K.reset_launches()
    M.reset_launches()
    with mock.patch.object(experiment, "Trainer", TimedTrainer):
        result = entry.Stage1Runtime(cfg, Run(None, None), build)._train()
    return {"losses": result["losses"], "world": world,
            "step_ms": [t * 1e3 for t in step_s],
            "rank": mesh.process_index(),
            "backend": (mesh.dist.get_backend() if mesh.dist.is_initialized()
                        else None),
            "launches": {**K.launches, **M.launches, **K.backward_calls},
            "state": {k: v.detach().cpu()
                      for k, v in kept["model"].state_dict().items()},
            "init": kept.get("init")}


def parallel_worker(argv) -> int:
    """``chip_smoke.py parallel-worker <out> <precision> <bs> <steps>
    [key=value ...]``: one rank of a world that ``torchrun``'s variables
    describe (``world_train``, written with ``torch.save``), with the
    cuDNN TF32 setting of ``main``'s process by then (off)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from pemp_tpu_torch.ops.kernels import minplus as M
    from pemp_tpu_torch.ops.kernels import mpm as K
    from pemp_tpu_torch.parallel import mesh
    out, precision, bs, steps = argv[0], argv[1], int(argv[2]), int(argv[3])
    extra = argv[4:]
    torch.backends.cudnn.allow_tf32 = False
    device = dict(a.split("=", 1) for a in extra).get("dev.device", "cuda")
    if not mesh.initialize_distributed(device):
        raise RuntimeError("parallel-worker: no world in the environment")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.save(world_train(torch, K, M, precision, bs, steps, tmp,
                                   extra=extra), out)
    finally:
        mesh.dist.destroy_process_group()
    return 0


def entry_run(argv) -> int:
    """``chip_smoke.py entry-run <out.json> <command> with ...``: PEMP
    stage 1's command with cuDNN's deterministic algorithms, in the world
    the environment names (none without one); writes the result, the
    world and its backend, and what a fused step did (``fused``: its
    warm-up steps, captures, replays, recorded and replayed launches)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from pemp_tpu_torch.core import trainer as trainer_mod
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.parallel import mesh
    torch.backends.cudnn.deterministic = True
    seen = {"world": 1, "backend": None}
    init = mesh.initialize_distributed
    made = []
    real_make = trainer_mod.FusedTrainStep

    def make(*args, **kwargs):
        made.append(real_make(*args, **kwargs))
        return made[-1]
    trainer_mod.FusedTrainStep = make

    def spy(device="cuda"):
        joined = init(device)
        if mesh.dist.is_initialized():
            seen.update(world=mesh.process_count(),
                        backend=mesh.dist.get_backend())
        return joined
    mesh.initialize_distributed = spy
    result = entry.main(argv[1:])
    fused = None
    if made:
        f = made[-1]
        fused = {"warmup_steps": f.eager_steps, "warmup_limit": f.warmup_steps,
                 "captures": f.captures, "replays": f.replays,
                 "recorded": [g.recorded for g in f.graphs.values()],
                 "replayed": f.replayed}
    Path(argv[0]).write_text(json.dumps({**seen, "result": result,
                                         "fused": fused}))
    return 0


def run_world(argv_of, env_of, n, timeout, cwd):
    """``n`` subprocesses of this script (``argv_of(rank)``,
    ``env_of(rank)``), each waited for at most ``timeout`` s and killed
    after; raises unless every one exits 0."""
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               *argv_of(r)], env=env_of(r), cwd=cwd,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n[killed: timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"subprocess {r} of {n} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return logs


def nccl_fused_world(torch, tmp, test_keys):
    """The ``train`` entry in a world of one over NCCL (DDP), eager
    against ``dev.fuse_steps=FUSE_K`` (two subprocesses, cuDNN
    deterministic): DDP's backward and its all-reduce captured in the
    graph after DDP_WARMUP_STEPS eager steps. The losses, final weights,
    momentum buffers and chained test bit-equal; the warm-up, captures,
    replays and recorded launches as predicted."""
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.parallel.step import DDP_WARMUP_STEPS

    runs = {}
    for name, fuse in (("eager", 1), ("fused", FUSE_K)):
        cwd = tmp / f"nccl_fuse_{name}"
        cwd.mkdir()
        res = cwd / "result.json"
        world = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, LOCAL_WORLD_SIZE=1,
                     MASTER_ADDR="localhost", MASTER_PORT=free_port())
        t0 = time.perf_counter()
        run_world(lambda r: ["entry-run", str(res), *NCCL_FUSE_ARGS,
                             f"dev.fuse_steps={fuse}"],
                  lambda r: sub_env(**world), 1, WORLD_TIMEOUT_S, cwd)
        runs[name] = {**json.loads(res.read_text()),
                      "wall_s": time.perf_counter() - t0}
        runs[name]["ckpt"] = ckpt_lib.load(cwd / "md" / "pemp_stage1" / "1"
                                           / ckpt_lib.CKPT)
    e, f = runs["eager"], runs["fused"]
    pe, pf = e["ckpt"], f["ckpt"]
    se, sf = pe["optimizer"]["state"], pf["optimizer"]["state"]
    equal = {
        "losses": e["result"]["train"]["losses"]
        == f["result"]["train"]["losses"],
        "weights": all(torch.equal(pe["model"][k], pf["model"][k])
                       for k in pe["model"]),
        "momentum": se.keys() == sf.keys() and all(
            torch.equal(se[i]["momentum_buffer"], sf[i]["momentum_buffer"])
            for i in se),
        "test": all(e["result"]["test"][k] == f["result"]["test"][k]
                    for k in test_keys)}
    per_epoch = 64 // 4
    warm_chunks = -(-DDP_WARMUP_STEPS // FUSE_K)
    fused = f["fused"]
    want = {"warmup_steps": warm_chunks * FUSE_K,
            "warmup_limit": DDP_WARMUP_STEPS, "captures": 1,
            "replays": 2 * per_epoch // FUSE_K - warm_chunks,
            "recorded": [{k: FUSE_K * n for k, n in STEP_LAUNCHES.items()}]}
    got = {k: fused[k] for k in want} if fused else None
    out = {"args": NCCL_FUSE_ARGS, "fuse_steps": FUSE_K,
           "backends": [e["backend"], f["backend"]],
           "worlds": [e["world"], f["world"]], "bit_equal": equal,
           "fused": fused, "fused_expected": want,
           "eager_made_no_fused_step": e["fused"] is None,
           "losses": f["result"]["train"]["losses"],
           "test": f["result"]["test"],
           "wall_s": {"eager": e["wall_s"], "fused": f["wall_s"]}}
    if (out["backends"] != [WORLD_OF_ONE_BACKEND] * 2
            or out["worlds"] != [1, 1] or e["fused"] is not None
            or got != want or not all(equal.values())
            or len(out["losses"]) != 2 * per_epoch):
        raise AssertionError(f"NCCL world of one, fused vs eager: {out}")
    return out


def update_rel(got, want, init):
    """How far ``got`` lies from ``want``, measured against the change
    the steps made to ``want`` (from ``init``): the L2 norm of the
    difference over that of the change, over every float tensor at once
    (parameters and running statistics), and the worst single tensor's
    largest difference over its largest change, with its key. Integer
    tensors must be equal (inf otherwise)."""
    diff2 = moved2 = 0.0
    worst, where = 0.0, None
    for key, w in want.items():
        g = got[key]
        if not w.is_floating_point():
            if not (g == w).all():
                return math.inf, math.inf, key
            continue
        d = g.double() - w.double()
        m = w.double() - init[key].double()
        diff2 += float((d * d).sum())
        moved2 += float((m * m).sum())
        dmax, mmax = float(d.abs().max()), float(m.abs().max())
        rel = dmax / mmax if mmax else (0.0 if dmax == 0 else math.inf)
        if rel > worst:
            worst, where = rel, key
    return math.sqrt(diff2 / moved2) if moved2 else math.inf, worst, where


def parallel_path_phase(torch, K, M):
    """The parallel layer on the card (PEMP stage 1, ResNet-50 at full
    width, 401x401, bf16, cedt, SYNTH):

    - a compact-wire epoch of PAR_STEPS steps fed by the
      ``DevicePrefetcher`` against the same steps fed host batches
      (cuDNN deterministic): losses and state bit-equal, the prefetched
      device batch bit-equal to the plain path's; the prefetched epoch's
      launches (this phase's row in the kernel table);
    - one stage-2 eval batch (8 episodes) to the card: pageable float32
      copies (the port's path before ``parallel/``), pinned float32 and
      pinned compact wire, host clock;
    - train steps fed by the loader's threads, serially and through the
      prefetcher: step ms, wait on the loader, the device's idle share;
    - the ``train`` entry under a ``torchrun``-style world of one over
      NCCL against the same run without it (two subprocesses, cuDNN
      deterministic): checkpoints, records and the chained test equal;
      and in that world, eager against ``dev.fuse_steps=FUSE_K``
      (``nccl_fused_world``);
    - two ranks sharing the card over gloo, WORLD_BS episodes each,
      against one process at twice that, for WORLD_STEPS steps at f32 and
      bf16: the ranks' losses and states equal, both within WORLD_TOL of
      the single process, each rank's K1-K5 launches as predicted.
    """
    import numpy as np

    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.parallel import step as pstep

    device = torch.device("cuda")
    start = time.perf_counter()
    keys = entry.Stage1Runtime.device_keys
    overrides = dict(a.split("=", 1) for a in TRAIN_ARGS[2:])
    cfg = entry.ex.assemble("train", {
        **overrides, "data.train_n": str(PAR_STEPS * 4)})
    ds, loader, _ = datasets.load(cfg, "train")
    ds.sample_tasks()
    host = list(loader)

    def trainer_for(model):
        params = model.freeze()
        return Trainer(cfg, Run(None, None), model,
                       solver.make_optimizer(cfg.tr, params), params,
                       entry.Stage1Runtime(cfg),
                       solver.LRPolicy(cfg.tr, PAR_STEPS), device)

    def epoch(feed):
        model = entry.build_model(cfg, device).train()
        trainer = trainer_for(model)
        model.set_dropout_generator(
            torch.Generator(device=device).manual_seed(cfg.seed + 1))
        losses, first = [], None
        for batch in feed:
            if first is None:
                first = {k: v for k, v in batch.items()
                         if isinstance(v, torch.Tensor)}
            losses.append(trainer.train_step(batch))
            trainer.lr_policy.step_step()
        torch.cuda.synchronize()
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        return torch.stack(losses).cpu(), state, first

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        serial_losses, serial_state, _ = epoch(host)
        K.reset_launches()
        M.reset_launches()
        pref_losses, pref_state, first = epoch(pstep.DevicePrefetcher(
            host, device, cfg.dev.prefetch, True, keys))
        launches = {**K.launches, **M.launches, **K.backward_calls}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = predicted(PAR_STEPS, 0)
    if launches != want:
        raise AssertionError(f"prefetched epoch launches {launches}, want "
                             f"{want}")
    plain = to_card(host[0], keys, device)
    batch_equal = set(first) == set(plain) and all(
        torch.equal(pstep.unpack_batch(first)[k], plain[k]) for k in plain)
    losses_equal = torch.equal(serial_losses, pref_losses)
    state_equal = all(torch.equal(serial_state[k], pref_state[k])
                      for k in serial_state)
    if not (batch_equal and losses_equal and state_equal
            and bool(torch.isfinite(pref_losses).all())):
        raise AssertionError(
            f"prefetched vs serial epoch: device batch equal {batch_equal},"
            f" losses {pref_losses.tolist()} vs {serial_losses.tolist()}, "
            f"state equal {state_equal}")
    out = {"prefetched_epoch": {
        "steps": PAR_STEPS, "losses": pref_losses.tolist(),
        "losses_bit_equal_serial": losses_equal,
        "state_bit_equal_serial": state_equal,
        "device_batch_bit_equal_plain": batch_equal,
        "launches": launches, "launches_expected": want}}
    del first, plain, serial_state, pref_state

    # one stage-2 eval batch to the card (host clock, ends in a sync)
    ecfg = entry.ex.assemble("test", dict(a.split("=", 1)
                                          for a in MAIN_ARGS[2:]))
    ebatch = first_batch(datasets, ecfg)
    ekeys = ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk")
    copies = {
        "pageable_f32": lambda: {k: torch.from_numpy(np.ascontiguousarray(
            ebatch[k])).to(device) for k in ekeys},
        "pinned_f32": lambda: pstep.device_batch(ebatch, device, False,
                                                 ekeys),
        "pinned_compact_wire": lambda: pstep.device_batch(ebatch, device,
                                                          True, ekeys)}
    h2d = {f"{name}_ms": host_ms(torch, fn, n=H2D_REPS)
           for name, fn in copies.items()}
    h2d["f32_bytes"] = sum(ebatch[k].nbytes for k in ekeys)
    h2d["wire_bytes"] = sum(
        ebatch[k].size * np.dtype(pstep.WIRE_DTYPES[k]).itemsize
        for k in ekeys)
    h2d["episodes"] = len(ebatch["cls"])
    out["h2d_stage2_eval_batch"] = h2d

    # train steps fed by the loader's threads: serial and prefetched
    fcfg = entry.ex.assemble("train", {
        **overrides, "data.train_n": str((LOADER_WARM + FED_STEPS) * 4)})
    model = entry.build_model(fcfg, device).train()
    trainer = trainer_for(model)
    model.set_dropout_generator(torch.Generator(device=device).manual_seed(0))
    fed = {}
    for name in ("serial", "prefetched"):
        ds_f, loader_f, _ = datasets.load(fcfg, "train")
        ds_f.sample_tasks()
        if name == "prefetched":
            loader_f = pstep.DevicePrefetcher(loader_f, device,
                                              fcfg.dev.prefetch, True, keys)
        fed[name] = fed_steps(torch, trainer, loader_f)
    prof = device_profile(torch, lambda: trainer.train_step(host[0]), {
        "mpm_kernels": ["assign_kernel", "match_kernel"],
        "mpm_backward_kernels": ["mpm_bwd_kernel"],
        "minplus_kernel": ["minplus_kernel"], "memcpy": ["Memcpy"]})
    device_ms = prof["device_us_total"] / 1e3
    for v in fed.values():
        v["device_idle_share"] = 1 - device_ms / v["step_ms"]
    out["fed_train_step"] = fed
    out["train_step_device_ms"] = device_ms
    out["train_step_profile"] = prof
    del trainer, model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # a torchrun-style world of one over NCCL against no world
        runs = {}
        for name, world in (("plain", {}), ("nccl_world_of_one", {
                "RANK": 0, "WORLD_SIZE": 1, "LOCAL_RANK": 0,
                "LOCAL_WORLD_SIZE": 1, "MASTER_ADDR": "localhost",
                "MASTER_PORT": free_port()})):
            cwd = Path(tmp) / name
            cwd.mkdir()
            res = cwd / "result.json"
            t0 = time.perf_counter()
            run_world(lambda r: ["entry-run", str(res), *NCCL_ARGS],
                      lambda r: sub_env(**world), 1, WORLD_TIMEOUT_S, cwd)
            runs[name] = {**json.loads(res.read_text()),
                          "wall_s": time.perf_counter() - t0,
                          "dir": cwd / "md" / "pemp_stage1" / "1"}
        a, b = runs["plain"], runs["nccl_world_of_one"]
        same = {}
        for f in (ckpt_lib.CKPT, ckpt_lib.BEST):
            pa, pb = (ckpt_lib.load(r["dir"] / f) for r in (a, b))
            same[f] = (pa["epoch"] == pb["epoch"]
                       and pa["extra"] == pb["extra"] and all(
                           torch.equal(pa["model"][k], pb["model"][k])
                           for k in pa["model"]))
        for f in ("metrics.json", "config.json"):
            same[f] = ((a["dir"] / f).read_text()
                       == (b["dir"] / f).read_text())
        test_keys = ("loss", "miou", "biou")
        same["test"] = all(a["result"]["test"][k] == b["result"]["test"][k]
                           for k in test_keys)
        same["losses"] = (a["result"]["train"]["losses"]
                          == b["result"]["train"]["losses"])
        if (b["backend"], b["world"], a["backend"]) != (
                WORLD_OF_ONE_BACKEND, 1, None) \
                or not all(same.values()):
            raise AssertionError(f"NCCL world of one vs plain: backends "
                                 f"{a['backend']} / {b['backend']}, equal "
                                 f"{same}")
        out["nccl_world_of_one"] = {
            "args": NCCL_ARGS, "backend": b["backend"], "world": b["world"],
            "equal_to_plain": same, "test": b["result"]["test"],
            "wall_s": {"plain": a["wall_s"], "world": b["wall_s"]}}
        out["nccl_world_of_one_fused"] = nccl_fused_world(
            torch, Path(tmp), test_keys)

        # two ranks sharing the card over gloo against one process
        worlds = {}
        torch.backends.cudnn.allow_tf32 = False     # as parallel_worker
        for precision in ("f32", "bf16"):
            single = world_train(torch, K, M, precision, 2 * WORLD_BS,
                                 WORLD_STEPS, Path(tmp) / "single",
                                 keep_init=True)
            torch.cuda.empty_cache()
            port = free_port()
            outs = [Path(tmp) / f"{precision}_rank{r}.pt" for r in range(2)]
            t0 = time.perf_counter()
            run_world(
                lambda r: ["parallel-worker", str(outs[r]), precision,
                           str(WORLD_BS), str(WORLD_STEPS)],
                lambda r: sub_env(RANK=r, WORLD_SIZE=2, LOCAL_RANK=r,
                                  LOCAL_WORLD_SIZE=2, MASTER_ADDR="localhost",
                                  MASTER_PORT=port,
                                  PEMP_DIST_TIMEOUT_S=WORLD_TIMEOUT_S // 2),
                2, WORLD_TIMEOUT_S, tmp)
            wall = time.perf_counter() - t0
            r0, r1 = (torch.load(o) for o in outs)
            ranks_equal = (r0["losses"] == r1["losses"] and all(
                torch.equal(r0["state"][k], r1["state"][k])
                for k in r0["state"]))
            loss_rel = [abs(x - y) / abs(y) for x, y in
                        zip(r0["losses"], single["losses"])]
            upd, upd_worst, upd_key = update_rel(
                r0["state"], single["state"], single["init"])
            want = predicted(WORLD_STEPS, 2)
            tol = WORLD_TOL[precision]
            ok = (ranks_equal and len(r0["losses"]) == WORLD_STEPS
                  and (r0["world"], r0["backend"]) == (2, "gloo")
                  and r0["launches"] == r1["launches"] == want
                  and single["launches"] == want
                  and loss_rel[0] <= tol["first_loss_rtol"]
                  and max(loss_rel) <= tol["loss_rtol"]
                  and upd <= tol["update_rel_l2"])
            worlds[precision] = {
                "losses_ranks": r0["losses"], "losses_single": single["losses"],
                "ranks_bit_equal": ranks_equal, "loss_rel": loss_rel,
                "update_rel_l2": upd, "update_worst_tensor_rel": upd_worst,
                "update_worst_key": upd_key,
                "tolerance": tol, "backend": r0["backend"],
                "launches_rank0": r0["launches"],
                "launches_rank1": r1["launches"],
                "launches_single": single["launches"],
                "launches_expected": want, "world_wall_s": wall,
                "step_ms_rank0": r0["step_ms"], "step_ms_rank1": r1["step_ms"],
                "step_ms_single": single["step_ms"]}
            if not ok:
                raise AssertionError(f"two ranks vs one process "
                                     f"({precision}): {worlds[precision]}")
            del single, r0, r1
        out["two_ranks_one_card_gloo"] = {
            "episodes_per_rank": WORLD_BS, "steps": WORLD_STEPS,
            "worlds": worlds}
    out.update({"phase": "parallel_path", "args": TRAIN_ARGS,
                "timing": "host clock (time.perf_counter) ending in a "
                          "synchronize; device ms from torch.profiler",
                "wall_s": time.perf_counter() - start,
                "launches": launches})
    emit(out)
    return launches


def device_launches(K, M, recorded=(), replayed=None):
    """K1-K5's launches on the device since the last reset: the wrappers'
    calls, less those the graph captures ``recorded`` (one dict a graph),
    plus those the graph replays made (``replayed``, the fused step's
    count)."""
    calls = {**K.launches, **M.launches}
    replayed = replayed or {}
    return {k: calls[k] - sum(r.get(k, 0) for r in recorded)
            + replayed.get(k, 0) for k in STEP_LAUNCHES}


def graph_step_vs_plain(torch, K, M, entry, cfg, batch):
    """One f32 train step (forward and backward, no update) of stage 1
    captured in a CUDA graph and replayed, K1-K5 inside it, against the
    same step eager with the kernels (bit for bit) and eager with the plain
    mpm (loss within TRAIN_LOSS_RTOL, each gradient within
    TRAIN_GRAD_RTOL relative L2), from the same weights and dropout
    seed."""
    from unittest import mock

    from pemp_tpu_torch.core import losses as loss_lib
    from pemp_tpu_torch.models import pemp_stage1 as stage1

    device = torch.device("cuda")
    model = entry.build_model(cfg, device).train()
    model.freeze()
    gen = torch.Generator(device=device)
    model.set_dropout_generator(gen)
    t = to_card(batch, ("sup_rgb", "sup_mask", "qry_rgb", "qry_msk"), device)
    loss_fn = loss_lib.get(cfg)

    def step():
        logits = model(t["sup_rgb"], t["sup_mask"], t["qry_rgb"])
        loss = loss_fn(logits.reshape(-1, *logits.shape[-3:]),
                       t["qry_msk"].reshape(-1, *t["qry_msk"].shape[-2:]))
        loss.backward()
        return loss.detach()

    def eager():
        model.zero_grad(set_to_none=True)
        gen.manual_seed(7)
        loss = step().item()
        return loss, {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.requires_grad}

    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(3):
            eager()
    current.wait_stream(side)
    model.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    before = {**K.launches, **M.launches}
    with torch.cuda.graph(graph, stream=side):
        static_loss = step()
    recorded = {k: n - before[k] for k, n in {**K.launches,
                                              **M.launches}.items()}
    gen.manual_seed(7)
    graph.replay()
    loss_g = static_loss.item()
    grads_g = {k: p.grad.clone() for k, p in model.named_parameters()
               if p.requires_grad}
    loss_k, grads_k = eager()
    before = dict(K.launches)
    with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
        loss_p, grads_p = eager()
    torch.cuda.synchronize()
    if K.launches != before:
        raise AssertionError("the plain step launched an mpm kernel")
    del graph
    rel = rel_l2(grads_p, grads_g)
    worst = max(rel, key=rel.get)
    out = {"recorded_launches": recorded, "loss_graph": loss_g,
           "loss_eager_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err_vs_plain": abs(loss_g - loss_p) / abs(loss_p),
           "grad_max_rel_l2_vs_plain": rel[worst], "grad_worst_leaf": worst,
           "graph_bit_equal_eager_kernels": loss_g == loss_k and all(
               torch.equal(grads_g[k], grads_k[k]) for k in grads_k),
           "grad_max_abs_vs_eager_kernels": max(
               float((grads_g[k] - grads_k[k]).abs().max()) for k in grads_k),
           "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                         "grad_rel_l2": TRAIN_GRAD_RTOL}}
    want = {k: STEP_LAUNCHES[k] for k in STEP_LAUNCHES}
    if ({k: recorded[k] for k in want} != want
            or out["loss_rel_err_vs_plain"] > TRAIN_LOSS_RTOL
            or rel[worst] > TRAIN_GRAD_RTOL):
        raise AssertionError(f"graph step vs plain: {out}")
    return out


def fused_launch_check(runs, steps, chunks, warm_chunks):
    """(b): each fused run built one graph after ``warm_chunks`` eager
    chunks, recorded FUSE_K steps' K1-K5 launches, replayed the other
    chunks, and launched on the device what its eager twin did."""
    checks = {}
    for precision in ("f32", "bf16"):
        e, f = runs[f"eager_{precision}"], runs[f"fused_{precision}"]
        recorded = f["recorded"][0] if f["recorded"] else {}
        ok = (len(f["losses"]) == len(e["losses"]) == steps
              and all(math.isfinite(x) for x in f["losses"])
              and f["captures"] == 1 and len(f["recorded"]) == 1
              and f["replays"] == chunks - warm_chunks
              and f["warmup_steps"] == warm_chunks * FUSE_K
              and recorded == {k: FUSE_K * n for k, n in STEP_LAUNCHES.items()}
              and f["replayed"] == {k: recorded[k] * f["replays"]
                                    for k in recorded}
              and f["device_launches"] == e["launches"]
              and e["launches"] == e["device_launches"])
        if not ok:
            raise AssertionError(
                f"{precision} fused launches: {f['captures']} captures, "
                f"{f['replays']} replays, {f['warmup_steps']} warm-up steps, "
                f"recorded {f['recorded']}, replayed {f['replayed']}, device "
                f"{f['device_launches']} vs eager {e['launches']}")
        checks[precision] = ok
    return checks


def gloo_world_refusal(torch, entry, args):
    """(e): ``train`` with ``dev.fuse_steps=2`` in a gloo world of one
    process on the card raises; returns its message."""
    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            entry.main(args + ["dev.fuse_steps=2", "-u",
                               f"g.model_dir={tmp}"])
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("dev.fuse_steps=2 trained in a gloo world")
    finally:
        dist.destroy_process_group()
    if "gloo" not in message or "NCCL" not in message:
        raise AssertionError(f"gloo world refusal: {message}")
    return message


def fused_path_phase(torch, K, M, smi):
    """The fused multi-step launch (``dev.fuse_steps``) on the card:

    - one f32 step captured in a CUDA graph (K1-K5 inside it) against the
      same step eager, with the kernels and with the plain mpm
      (``graph_step_vs_plain``);
    - (a) stage 1's ``train`` entry at full width, FUSE_STEPS steps an
      epoch for two epochs, eager (``dev.fuse_steps=1``) and fused
      (``FUSE_K``), from one seeded state, cuDNN deterministic: at f32
      (TF32 off) the losses, final weights and momentum buffers bit-equal,
      or else no farther apart than two eager runs; at bf16 the losses
      within FUSE_BF16_RTOL;
    - (b) the captures and replays, and K1-K5's launches
      (``fused_launch_check``);
    - (c) the steady step, eager and fused (a chunk of FUSE_K replayed),
      host clock, and each one's device idle share from a profile;
    - (d) CaNet at 321x321, ``dev.fuse_steps=CANET_FUSE_K``, two epochs of
      two chunks: the history store at every epoch boundary byte for byte
      the serial run's;
    - (e) ``dev.fuse_steps=2`` in a gloo world raises
      (``gloo_world_refusal``).

    Returns the bf16 fused run's device launches (the table's
    ``fused_path_launches``)."""
    from unittest import mock

    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.core import trainer as trainer_mod
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import canet as canet_entry
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.parallel.step import WARMUP_STEPS, device_batch

    device = torch.device("cuda")
    start = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)

    @contextmanager
    def deterministic():
        """cuDNN's deterministic algorithms, for the equality checks; the
        timing keeps the flags the phase found (the deterministic dgrad
        kernels of the 3x3 convolutions take most of a step)."""
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved

    made = []
    real_make = trainer_mod.FusedTrainStep

    def spy(*args, **kwargs):
        made.append(real_make(*args, **kwargs))
        return made[-1]

    def run(runner, fuse):
        """``runner()`` with K1-K5's counts from 0, and what the fused
        step it built did."""
        K.reset_launches()
        M.reset_launches()
        made.clear()
        t0 = time.perf_counter()
        with mock.patch.object(trainer_mod, "FusedTrainStep", spy):
            result = runner()
        torch.cuda.synchronize()
        out = {"result": result, "wall_s": time.perf_counter() - t0,
               "launches": {**K.launches, **M.launches},
               "mpm_backward": K.backward_calls["mpm_backward"]}
        recorded, replayed = [], {}
        if fuse > 1:
            fused = made[-1]
            recorded = [dict(g.recorded) for g in fused.graphs.values()]
            replayed = dict(fused.replayed)
            out.update(captures=fused.captures, replays=fused.replays,
                       warmup_steps=fused.eager_steps, recorded=recorded,
                       replayed=replayed)
        out["device_launches"] = device_launches(K, M, recorded, replayed)
        return out

    def stage1(precision, fuse, tmp, observed):
        args = FUSE_ARGS + [f"dev.precision={precision}",
                            f"dev.fuse_steps={fuse}", f"g.model_dir={tmp}"]
        out = run(lambda: entry.main(args + ([] if observed else ["-u"])),
                  fuse)
        out["losses"] = out["result"]["train"]["losses"]
        if observed:
            rid = out["result"]["train"]["run_id"]
            ck = ckpt_lib.load(Path(tmp) / "pemp_stage1" / str(rid)
                               / ckpt_lib.CKPT)
            out["model"] = ck["model"]
            out["momentum"] = {i: st["momentum_buffer"]
                               for i, st in ck["optimizer"]["state"].items()}
        return out

    def distance(a, b):
        """Largest absolute differences of two observed runs' losses,
        final floating weights and momentum buffers (integer tensors must
        match)."""
        for k, v in b["model"].items():
            if not v.is_floating_point() and not torch.equal(a["model"][k],
                                                             v):
                raise AssertionError(f"{k} differs")
        return {
            "losses": max(abs(x - y) for x, y in zip(a["losses"],
                                                     b["losses"])),
            "weights": max(float((a["model"][k].double() - v.double())
                                 .abs().max())
                           for k, v in b["model"].items()
                           if v.is_floating_point()),
            "momentum": max(float((a["momentum"][i] - v).abs().max())
                            for i, v in b["momentum"].items())}

    cfg32 = entry.ex.assemble("train", dict(
        a.split("=", 1) for a in FUSE_ARGS[2:] + ["dev.precision=f32"]))
    ds, loader, _ = datasets.load(cfg32, "train")
    ds.sample_tasks()
    batch = next(iter(loader))
    with deterministic():
        out = {"graph_step_vs_plain": graph_step_vs_plain(
            torch, K, M, entry, cfg32, batch)}
        torch.cuda.empty_cache()

        # (a) and (b): the entry, eager and fused, f32 and bf16
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            for precision in ("f32", "bf16"):
                for name, fuse in (("eager", 1), ("fused", FUSE_K)):
                    runs[f"{name}_{precision}"] = stage1(
                        precision, fuse, f"{tmp}/{name}_{precision}",
                        precision == "f32")
                    torch.cuda.empty_cache()
            e32, f32 = runs["eager_f32"], runs["fused_f32"]
            fused_vs_eager = distance(f32, e32)
            bit_equal = not any(fused_vs_eager.values())
            eager_spread = None
            if not bit_equal:
                eager_spread = distance(stage1(
                    "f32", 1, f"{tmp}/eager_f32_again", True), e32)
                if any(fused_vs_eager[k] > eager_spread[k]
                       for k in fused_vs_eager):
                    raise AssertionError(
                        f"f32 fused vs eager {fused_vs_eager}, beyond two "
                        f"eager runs' spread {eager_spread}")
        e16, f16 = runs["eager_bf16"], runs["fused_bf16"]
        bf16_rel = max(abs(x - y) / abs(y) for x, y in zip(f16["losses"],
                                                           e16["losses"]))
        if bf16_rel > FUSE_BF16_RTOL:
            raise AssertionError(f"bf16 fused losses {f16['losses']} vs "
                                 f"eager {e16['losses']}: {bf16_rel}")
        checks = fused_launch_check(runs, 2 * FUSE_STEPS,
                                    2 * (FUSE_STEPS // FUSE_K),
                                    -(-WARMUP_STEPS // FUSE_K))
        out["a_equality"] = {
            "f32_bit_equal": bit_equal, "f32_fused_vs_eager": fused_vs_eager,
            "f32_eager_vs_eager": eager_spread,
            "f32_losses_eager": e32["losses"],
            "f32_losses_fused": f32["losses"],
            "bf16_losses_eager": e16["losses"],
            "bf16_losses_fused": f16["losses"],
            "bf16_loss_max_rel": bf16_rel,
            "bf16_loss_max_abs": max(abs(x - y) for x, y in
                                     zip(f16["losses"], e16["losses"])),
            "bf16_rtol": FUSE_BF16_RTOL}
        out["b_launches"] = {
            name: {k: r[k] for k in ("launches", "device_launches",
                                     "mpm_backward", "captures", "replays",
                                     "warmup_steps", "recorded", "replayed",
                                     "wall_s") if k in r}
            for name, r in runs.items()}
        out["b_launches"]["checks"] = checks
        del runs, e32, f32
        torch.cuda.empty_cache()

    # (c) the steady step, eager and fused, bf16 (the main path's)
    cfg = entry.ex.assemble("train", dict(
        a.split("=", 1) for a in FUSE_ARGS[2:]
        + [f"dev.fuse_steps={FUSE_K}"]))
    model = entry.build_model(cfg, device).train()
    params = model.freeze()
    trainer = trainer_mod.Trainer(
        cfg, Run(None, None), model,
        solver.make_optimizer(cfg.tr, params, capturable=True), params,
        entry.Stage1Runtime(cfg), solver.LRPolicy(cfg.tr, 1000), device,
        fuse_steps=FUSE_K)
    trainer.dropout_generator.manual_seed(0)
    model.set_dropout_generator(trainer.dropout_generator)
    lr = trainer.lr_policy.lr

    def timing(feed):
        """The steady eager step and fused chunk on ``feed`` (repeated),
        host clock, and each one's device idle share from a profile."""
        def eager_step():
            trainer.train_step(feed)

        def fused_chunk():
            trainer.train_step_fused([feed] * FUSE_K, [lr] * FUSE_K)

        eager_ms = host_ms(torch, eager_step)
        eager_dev = device_profile(torch, eager_step, KERNEL_SYMBOLS)
        chunk_ms = host_ms(torch, fused_chunk)
        chunk_dev = device_profile(torch, fused_chunk, KERNEL_SYMBOLS)
        # the launches the profiler saw: a step's, and a replayed chunk's
        # against what its graph recorded at capture
        seen = {k: {n: prof[f"{n}_calls"] for n in KERNEL_SYMBOLS}
                for k, prof in (("eager_step", eager_dev),
                                ("fused_chunk", chunk_dev))}
        graph, = trainer.train_step_fused.graphs.values()
        if (seen["eager_step"] != STEP_LAUNCHES
                or seen["fused_chunk"] != graph.recorded
                or graph.recorded != {k: FUSE_K * n
                                      for k, n in STEP_LAUNCHES.items()}):
            raise AssertionError(f"profiled K1-K5 launches {seen}, graph "
                                 f"recorded {graph.recorded}")
        return fused_chunk, {
            "profiled_launches": seen,
            "eager_step_ms": eager_ms,
            "fused_step_ms": chunk_ms / FUSE_K, "fused_chunk_ms": chunk_ms,
            "eager_device_ms": eager_dev["device_us_total"] / 1e3,
            "fused_chunk_device_ms": chunk_dev["device_us_total"] / 1e3,
            "eager_device_idle_share":
                1 - eager_dev["device_us_total"] / 1e3 / eager_ms,
            "fused_device_idle_share":
                1 - chunk_dev["device_us_total"] / 1e3 / chunk_ms,
            "eager_profile_top": eager_dev["top"],
            "fused_profile_top": chunk_dev["top"]}

    # a host batch (each call casts and copies it, as the serial loader
    # path does), then the same batch already on the card (as the entry's
    # prefetcher hands it over)
    fused_chunk, host_fed = timing(batch)
    chunk_dev_ms = time_ms(torch, fused_chunk,
                           torch.empty(1 << 20, device=device),
                           spin_cycles=LONG_SPIN_CYCLES)
    _, card_fed = timing(device_batch(batch, device, cfg.dev.compact_wire,
                                      entry.Stage1Runtime.device_keys))
    out["c_timing"] = {
        "nvidia_smi": smi, "precision": cfg.dev.precision,
        **host_fed, "fused_chunk_device_ms_events": chunk_dev_ms,
        "device_batch": card_fed,
        "fused_captures": trainer.train_step_fused.captures,
        "timing": "host clock (median of 10 after 3 warm calls) ending in "
                  "a synchronize; device ms from torch.profiler over one "
                  "call (and, for the host-fed chunk, CUDA events behind a "
                  "device spin)"}
    del trainer, model, params
    torch.cuda.empty_cache()

    # (d) CaNet: the history store, fused against serial
    def canet(fuse, tmp):
        ccfg = canet_entry.ex.assemble("train", dict(
            a.split("=", 1) for a in CANET_FUSE_ARGS[2:]
            + [f"dev.fuse_steps={fuse}", f"g.model_dir={tmp}"]))
        rt = canet_entry.CaNetRuntime(ccfg, Run(None, None))
        store, next_epoch = rt.store, rt.store.next_epoch
        snaps = []

        def recording():
            snaps.append({k: v.copy() for k, v in store._store.items()})
            next_epoch()
        store.next_epoch = recording
        r = run(rt.train, fuse)
        r["snapshots"] = snaps
        r["losses"] = r["result"]["train"]["losses"]
        return r

    with deterministic():
        with tempfile.TemporaryDirectory() as tmp:
            cs, cf = canet(1, tmp), canet(CANET_FUSE_K, tmp)
        same = (len(cs["snapshots"]) == len(cf["snapshots"]) > 2
                and all(a.keys() == b.keys() and all(
                    a[k].tobytes() == b[k].tobytes() for k in a)
                    for a, b in zip(cs["snapshots"], cf["snapshots"])))
        sizes = [len(snap) for snap in cf["snapshots"]]
        out["d_canet"] = {
            "args": CANET_FUSE_ARGS, "fuse_steps": CANET_FUSE_K,
            "store_bit_equal_serial": same, "store_sizes": sizes,
            "captures": cf["captures"], "replays": cf["replays"],
            "losses_serial": cs["losses"], "losses_fused": cf["losses"],
            "loss_max_abs": max(abs(x - y) for x, y in
                                zip(cs["losses"], cf["losses"])),
            "wall_s": {"serial": cs["wall_s"], "fused": cf["wall_s"]}}
        if not same or not any(sizes) or cf["replays"] < 1:
            raise AssertionError(f"CaNet fused history store: "
                                 f"{out['d_canet']}")
        del cs, cf
        torch.cuda.empty_cache()

    # (e) a gloo world on the card cannot hold a graph's collectives
    out["e_gloo_world_refused"] = gloo_world_refusal(torch, entry, FUSE_ARGS)
    out.update({"phase": "fused_path", "args": FUSE_ARGS,
                "fuse_steps": FUSE_K, "wall_s": time.perf_counter() - start})
    emit(out)
    return out["b_launches"]["fused_bf16"]["device_launches"]


def serving_launches():
    """K1-K5's counts in this process; ``minplus`` 0 when its module was
    never imported (then nothing launched it)."""
    mpm = sys.modules["pemp_tpu_torch.ops.kernels.mpm"]
    minplus = sys.modules.get("pemp_tpu_torch.ops.kernels.minplus")
    return {**mpm.launches, **mpm.backward_calls,
            "minplus": minplus.launches["minplus"] if minplus else 0}


def serving_worker(argv) -> int:
    """``chip_smoke.py serving-worker <artifact> <inputs.npz> <out.npz>
    <cudnn allow_tf32 0|1>``: a fresh process that imports
    ``load_serving`` alone (which registers the ``pemp::`` operators),
    loads the artifact and calls it once at each SERVE_BATCHES size under
    cuDNN's deterministic algorithms (the logits and K1-K5's launches of
    those calls into <out.npz>, ``.json`` beside it); then, with the
    flags as found, the host-clock ms of a call at each size and its
    kernels as the profiler counts them (``serving_timing``)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from pemp_tpu_torch.tools.export_serving import load_serving
    artifact, inputs, out = argv[0], argv[1], Path(argv[2])
    torch.backends.cudnn.allow_tf32 = argv[3] == "1"
    t0 = time.perf_counter()
    fn = load_serving(artifact).module()
    load_s = time.perf_counter() - t0
    data = np.load(inputs)
    args = {b: [torch.from_numpy(data[k][:b]).cuda()
                for k in ("sup_rgb", "sup_mask", "qry_rgb")]
            for b in SERVE_BATCHES}
    cudnn = torch.backends.cudnn
    mpm = sys.modules["pemp_tpu_torch.ops.kernels.mpm"]
    mpm.reset_launches()
    logits, per_call = {}, {}
    cudnn.deterministic = True
    with torch.no_grad():
        for b in SERVE_BATCHES:
            before = serving_launches()
            logits[f"b{b}"] = fn(*args[b]).float().cpu().numpy()
            per_call[b] = {k: v - before[k]
                           for k, v in serving_launches().items()}
    launches = serving_launches()
    cudnn.deterministic = False
    timing = serving_timing(torch, fn, args)
    np.savez(out, **logits)
    Path(f"{out}.json").write_text(json.dumps({
        "load_s": load_s, "launches": launches,
        "per_call": {str(b): v for b, v in per_call.items()},
        "timing": timing}))
    return 0


def serving_timing(torch, fn, args):
    """For each batch size b of ``args``: the host-clock ms of
    ``fn(*args[b])`` (median of 10 after 3), its device ms, idle share,
    K1/K2 counts, top kernels and the SERVE_CONV_BY_SHAPE kernels' time by
    convolution shape (one profiled call)."""
    out = {}
    with torch.no_grad():
        for b in SERVE_BATCHES:
            ms = host_ms(torch, lambda b=b: fn(*args[b]))
            prof = device_profile(torch, lambda b=b: fn(*args[b]),
                                  {k: KERNEL_SYMBOLS[k]
                                   for k in ("assign", "match")},
                                  by_shape=SERVE_CONV_BY_SHAPE)
            device_ms = prof["device_us_total"] / 1e3
            out[str(b)] = {"host_ms": ms, "device_ms": device_ms,
                           "device_idle_share": 1 - device_ms / ms,
                           "assign_calls": prof["assign_calls"],
                           "match_calls": prof["match_calls"],
                           "top": prof["top"][:5],
                           "conv_by_shape": prof["by_input_shape"][:3]}
    return out


def serving_path_phase(torch, K):
    """Serving export on the card: PEMP stage 1 and the cascade (stage 1,
    its argmax prior, stage 2), full width in bf16, exported with a
    symbolic batch through ``pemp_tpu_torch/tools/export_serving.py``'s
    functions and saved; each loaded in a fresh process
    (``serving_worker``) and called at B = 1 and 8 on a SYNTH eval batch.
    Checks: K1 and K2 launch once a stage a call there (also as the
    profiler counts a B = 8 call) and the export launches nothing; the
    artifact's logits bit-equal to the live eager forward of the same
    weights (cuDNN deterministic in both processes); the live forward
    with the kernels against the plain mpm (as ``main_path`` and
    ``stage2_path``: max abs err, argmax and prior agreement). Host-clock
    ms (median of 10 after 3) of a B = 1 call and of a B = 8 call, the
    artifact's and the live forward's, the export's seconds and the
    artifact's bytes. Returns K1-K5's launches in the workers' counted
    calls (the table's ``serving_path_launches``)."""
    import numpy as np
    from unittest import mock

    from pemp_tpu_torch.core.experiment import set_precision
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    from pemp_tpu_torch.models import registry
    from pemp_tpu_torch.tools import export_serving as X

    start = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cfg = entry.ex.assemble("test", dict(a.split("=", 1)
                                         for a in MAIN_ARGS[2:]))
    hw = cfg.data.height
    set_precision(cfg.dev.precision)
    models = {}
    for name in ("pemp_stage1", "pemp_stage2"):
        models[name] = registry.build(name, cfg)
        models[name].reset_parameters(
            torch.Generator().manual_seed(SERVE_SEED))
    built = {"pemp_stage1": X.build_serving_fn(
        "pemp_stage1", models["pemp_stage1"], "poly", 1, 1, hw, "cuda"),
        "cascade": X.build_cascade_serving_fn(
            models["pemp_stage1"], models["pemp_stage2"], "poly", 1, 1, hw,
            "cuda")}
    batch = first_batch(datasets, cfg)
    if batch["sup_rgb"].shape[0] < max(SERVE_BATCHES):
        raise AssertionError("the SYNTH eval batch is smaller than "
                             f"{max(SERVE_BATCHES)}")
    keys = ("sup_rgb", "sup_mask", "qry_rgb")
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.npz"
        np.savez(inputs, **{k: np.asarray(batch[k], np.float32)
                            for k in keys})
        for name, (serve, example, dyn) in built.items():
            before = dict(K.launches)
            t0 = time.perf_counter()
            exported = X.export_serving(serve, example, dyn)
            export_s = time.perf_counter() - t0
            if K.launches != before:
                raise AssertionError(f"exporting {name} launched a kernel")
            nodes = sorted(str(n.target) for n in exported.graph.nodes
                           if str(n.target).startswith("pemp."))
            want_nodes = sorted(["pemp.mpm_assign.default",
                                 "pemp.mpm_match.default"]
                                * SERVE_STAGES[name])
            if nodes != want_nodes:
                raise AssertionError(f"{name} graph's mpm nodes {nodes}")
            path = Path(tmp) / f"{name}.pt2"
            nbytes = X.save_serving(exported, path, {
                "model": name, "hw": hw, "batch": "b",
                "precision": cfg.dev.precision})
            del exported
            w0 = time.perf_counter()
            run_world(lambda r: ["serving-worker", str(path), str(inputs),
                                 str(Path(tmp) / f"{name}.out.npz"),
                                 str(int(cudnn.allow_tf32))],
                      lambda r: None, 1, SERVE_TIMEOUT_S, tmp)
            worker_s = time.perf_counter() - w0
            rep = json.loads(Path(tmp, f"{name}.out.npz.json").read_text())
            got = np.load(Path(tmp) / f"{name}.out.npz")
            stages = SERVE_STAGES[name]
            want_call = {k: stages if k in ("assign", "match") else 0
                         for k in rep["launches"]}
            for b in SERVE_BATCHES:
                if rep["per_call"][str(b)] != want_call:
                    raise AssertionError(f"{name} B={b} launches "
                                         f"{rep['per_call'][str(b)]}, "
                                         f"want {want_call}")
            art_t = rep["timing"]
            counted = {b: (v["assign_calls"], v["match_calls"])
                       for b, v in art_t.items()}
            if set(counted.values()) != {(stages, stages)}:
                raise AssertionError(f"{name}: the profiler counts "
                                     f"(assign, match) {counted}")
            launches[name] = rep["launches"]

            # the live forward, same weights and inputs, in this process
            cudnn.deterministic = True
            eq, vs_plain = {}, {}
            try:
                with torch.no_grad():
                    for b in SERVE_BATCHES:
                        t = [torch.from_numpy(np.asarray(batch[k][:b],
                                                         np.float32)).cuda()
                             for k in keys]
                        live = serve(*t).float()
                        art = torch.from_numpy(got[f"b{b}"]).cuda()
                        if art.shape != (b, 1, hw, hw, 2) or not bool(
                                torch.isfinite(art).all()):
                            raise AssertionError(
                                f"{name} B={b}: logits {tuple(art.shape)} "
                                "or not finite")
                        eq[b] = {"bit_equal": bool(torch.equal(art, live)),
                                 "max_abs_diff": (art - live).abs().max()
                                 .item()}
                        vs_plain[b] = serving_vs_plain(
                            K, mock, stage1, serve, name, t, live)
            finally:
                cudnn.deterministic = saved
            if not all(v["bit_equal"] for v in eq.values()):
                raise AssertionError(f"{name}: artifact vs live {eq}")
            bad = {b: v for b, v in vs_plain.items()
                   if v["max_abs_err"] > LOGIT_ATOL
                   or v["argmax_agreement"] < MAIN_AGREE
                   or (v["prior_agreement"] is not None
                       and v["prior_agreement"] < MAIN_AGREE)}
            if bad:
                raise AssertionError(f"{name}: kernels vs plain mpm {bad}")
            live_t = serving_timing(torch, serve, {
                b: [torch.from_numpy(np.asarray(batch[k][:b], np.float32))
                    .cuda() for k in keys] for b in SERVE_BATCHES})
            big = str(max(SERVE_BATCHES))
            out[name] = {
                "export_s": export_s, "artifact_bytes": nbytes,
                "archive_bytes": archive_bytes(path),
                "worker_s": worker_s, "load_s": rep["load_s"],
                "launches": rep["launches"], "per_call": rep["per_call"],
                "vs_live": eq, "vs_plain": vs_plain,
                "artifact": art_t, "live": live_t,
                "artifact_b1_latency_ms": art_t["1"]["host_ms"],
                "live_b1_latency_ms": live_t["1"]["host_ms"],
                f"artifact_b{big}_episodes_per_s":
                    int(big) / art_t[big]["host_ms"] * 1e3,
                f"live_b{big}_episodes_per_s":
                    int(big) / live_t[big]["host_ms"] * 1e3}
    total = {k: sum(v[k] for v in launches.values())
             for k in launches["pemp_stage1"]}
    emit({"phase": "serving_path", "hw": hw,
          "precision": cfg.dev.precision, "batches": list(SERVE_BATCHES),
          "seed": SERVE_SEED, "wall_s": time.perf_counter() - start,
          "launches": total, **out,
          "tolerance": {"artifact_vs_live": "bit-equal (cuDNN "
                        "deterministic)", "logit_atol": LOGIT_ATOL,
                        "agree": MAIN_AGREE}})
    return total


def archive_bytes(path):
    """The ``.pt2`` archive's bytes by folder (its weights, constants,
    graph), uncompressed."""
    import zipfile
    sizes = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            parts = info.filename.split("/")
            key = "/".join(parts[1:3] if len(parts) > 3 else parts[1:2])
            sizes[key] = sizes.get(key, 0) + info.file_size
    return dict(sorted(sizes.items(), key=lambda kv: -kv[1])[:6])


def serving_vs_plain(K, mock, stage1, serve, name, t, live):
    """The live forward with the kernels (``live``) against the same
    forward with the plain mpm, which must launch no kernel; for the
    cascade, as ``stage2_path``: stage 2 on the kernels' prior both ways,
    and that prior against the plain mpm's (None for stage 1)."""
    prior_agree = None
    if name == "cascade":
        prior = serve.model.prior(*t)           # with the kernels
    before = dict(K.launches)
    with mock.patch.object(stage1, "mpm_chain_packed", plain_chain):
        if name == "cascade":
            prior_agree = (serve.model.prior(*t) == prior).float().mean(
            ).item()
            plain = serve.model.stage2(*t, prior).float()
        else:
            plain = serve(*t).float()
    if K.launches != before:
        raise AssertionError(f"{name}: the plain forward launched a kernel")
    return {"max_abs_err": (live - plain).abs().max().item(),
            "argmax_agreement": (live.argmax(-1) == plain.argmax(-1))
            .float().mean().item(),
            "prior_agreement": prior_agree}


def conv_s2b_times(torch, flush):
    """One dilated 3x3 256->256 convolution (bf16, channels_last) on the
    card, cuDNN's native dilated kernels against ``S2BConv2d``'s
    space-to-batch schedule, per ``S2B_CONV_CASES`` (the forward, or the
    forward and backward): CUDA-event ms behind a device spin, cuDNN's
    flags as the phase found them, and the two outputs' largest
    difference. A printed measurement, not a check."""
    from pemp_tpu_torch.tools.exp_train_levers import S2BConv2d
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for n, c, h, w, d, backward in S2B_CONV_CASES:
        conv = torch.nn.Conv2d(c, c, 3, padding=d, dilation=d, bias=False)
        conv = conv.to(device, torch.bfloat16,
                       memory_format=torch.channels_last)
        s2b = S2BConv2d(conv)
        x = torch.randn(n, c, h, w, generator=gen, device=device,
                        dtype=torch.bfloat16).to(
            memory_format=torch.channels_last).requires_grad_(backward)
        g = torch.randn(n, c, h, w, generator=gen, device=device,
                        dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        row = {"input": [n, c, h, w], "dilation": d, "dtype": "bfloat16",
               "backward": backward}
        outs = {}
        for name, mod in (("native", conv), ("s2b", s2b)):
            def call(mod=mod):
                if backward:
                    conv.weight.grad = x.grad = None
                    mod(x).backward(g)
                else:
                    with torch.no_grad():
                        return mod(x)
            row[f"{name}_ms"] = time_ms(torch, call, flush,
                                        spin_cycles=LONG_SPIN_CYCLES)
            with torch.no_grad():
                outs[name] = mod(x).float()
        row["s2b_over_native"] = row["s2b_ms"] / row["native_ms"]
        row["max_abs_diff"] = (outs["s2b"] - outs["native"]).abs().max().item()
        rows.append(row)
    return rows


def synth_eval_inputs(batch, shots, hw):
    """The first SYNTH test batch (split 0, seed 1234) of ``batch``
    episodes at ``hw`` in ``profile_eval.make_inputs``' layout: (sup
    [B,S,H,W,3], msk [B,S,H,W,2], qry [B,1,H,W,3], ref [B,H,W]) numpy
    arrays, blob masks on textured images, where the two classes'
    prototypes differ."""
    from pemp_tpu_torch.data import datasets
    from pemp_tpu_torch.entry import pemp_stage1 as entry
    cfg = entry.ex.assemble("test", {
        "split": "0", "data.dataset": "SYNTH", "data.height": str(hw),
        "data.width": str(hw), "shot": str(shots), "query": "1",
        "data.test_bs": str(batch), "data.test_n": str(batch),
        "seed": "1234"})
    ds, loader, _ = datasets.load(cfg)
    ds.sample_tasks()
    b = next(iter(loader))
    return (b["sup_rgb"], b["sup_mask"], b["qry_rgb"],
            b["qry_msk"][:, 0].astype("int32"))


def tools_path_phase(torch, K, M, smi):
    """The operator tools (``pemp_tpu_torch/tools/``) on the card, each
    through its command line's ``main`` (each prints its JSON line):

    - ``profile_eval`` (stage 1 at test batch 8, 401², bf16, two profiled
      launches): the profiler counts one assign and one match kernel a
      launch, as the wrappers do; with ``--no-kernels`` none. On the
      tool's own inputs (noise images, random masks: the two classes'
      prototypes nearly equal, every pixel a near-tie) only the logits
      are compared: within LOGIT_ATOL of the plain route's, the argmax
      flipping only where the plain top-two gap is <= 2 x the measured
      error; the agreement is printed. The tool's counts are held on
      inputs where the classes separate: the tool run again, kernels and
      ``--no-kernels``, on the first SYNTH test batch
      (``synth_eval_inputs`` in place of its ``make_inputs``); there the
      argmax agrees on >= MAIN_AGREE of the pixels, and the counts
      differ by at most 3 (1 - MAIN_AGREE) of them (a flipped pixel
      moves three counts by one);
    - ``profile_train`` (batch 4, 401², cedt, bf16): three eager steps
      and one replayed chunk of TOOLS_FUSE, K1-K5 counted by the profiler
      as predicted (STEP_LAUNCHES a step), the replay's as recorded;
    - ``memory_report``, all eight rows: peak(b2) > peak(b1) > the
      parameter bytes;
    - ``exp_train_levers``: ``verify`` (every arm within the card's gate),
      ``measure`` of native, s2b and wgrad32, eager and with ``--fuse``,
      and one dilated convolution alone, native against S2BConv2d
      (``conv_s2b_times``: printed, not checked), under PyTorch's
      default cuDNN flags (set at the phase's start);
    - ``bench_input`` on its miniature tree (24 episodes, 1, 2, 4
      workers), the demand this phase's profiles measured, with the
      decoded-image cache warm (augment and collate) and with
      ``--no-cache`` (the JPEG decode too);
    - ``verify_real_data``: the dataless dry run (every phase SKIP), phase
      4 on seeded reference-layout ``.pth`` files of both stages, and one
      planned stage-1 ``test`` command on a miniature PASCAL tree
      (``write_voc_tree``; ``data.test_n=8 te.epochs=1``) whose mIoU the
      tool's parser reads, finite.

    Returns K1-K5's wrapper counts over the phase (the table's
    ``tools_path_launches``)."""
    import io
    from contextlib import redirect_stdout
    from unittest import mock

    import numpy as np

    from pemp_tpu_torch.ops.kernels import use_kernels
    from pemp_tpu_torch.tools import (
        bench_input, exp_train_levers, memory_report, profile_eval,
        profile_train, verify_real_data,
    )

    device = torch.device("cuda")
    start = time.perf_counter()
    # PyTorch's default cuDNN flags: earlier phases turn TF32 off for
    # their f32 runs (set_precision), which the wgrad32 arm's float32
    # weight-gradient convolutions would otherwise inherit
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = False, False, True
    K.reset_launches()
    M.reset_launches()
    out = {"phase": "tools_path", "nvidia_smi": smi}
    none = {k: 0 for k in STEP_LAUNCHES}

    # profile_eval, kernels and plain
    ev = profile_eval.main(TOOLS_EVAL_ARGS)
    ev_plain = profile_eval.main(TOOLS_EVAL_ARGS + ["--no-kernels"])
    want = {k: 2 * n for k, n in EVAL_LAUNCHES.items()}
    if ev["profiled_launches"] != want or ev["launches"] != want:
        raise AssertionError(f"profile_eval launches {ev['launches']}, "
                             f"profiled {ev['profiled_launches']}, want {want}")
    if ev_plain["profiled_launches"] != none or ev_plain["launches"] != none:
        raise AssertionError(f"--no-kernels launched {ev_plain}")
    batch, hw = int(TOOLS_EVAL_ARGS[1]), int(TOOLS_EVAL_ARGS[3])
    pixels = batch * hw * hw
    model = profile_eval.build_model(device)

    def kernels_vs_plain(inputs):
        sup, msk, qry, _ = (torch.from_numpy(a).to(device) for a in inputs)
        with torch.no_grad():
            lk = model(sup, msk, qry).float()
            with use_kernels(False):
                lp = model(sup, msk, qry).float()
        same = lk.argmax(-1) == lp.argmax(-1)
        return (lk - lp).abs().max().item(), same, lp

    # the tool's own inputs: the logits, and flips only at near-ties
    err, same, lp = kernels_vs_plain(profile_eval.make_inputs(batch, 1, hw))
    gap = (lp[..., 1] - lp[..., 0]).abs()
    flips_outside = int((~same & (gap > 2 * err)).sum())
    agree = same.float().mean().item()
    if err > LOGIT_ATOL or flips_outside:
        raise AssertionError(
            f"profile_eval kernels vs plain: logits max abs err {err}, "
            f"{flips_outside} flips outside near-ties")
    # the counts, where the two classes separate: the tool on the first
    # SYNTH test batch at its shapes, kernels and plain
    with mock.patch.object(profile_eval, "make_inputs", synth_eval_inputs):
        sk = profile_eval.main(TOOLS_EVAL_ARGS)
        sp = profile_eval.main(TOOLS_EVAL_ARGS + ["--no-kernels"])
    s_err, s_same, _ = kernels_vs_plain(synth_eval_inputs(batch, 1, hw))
    s_agree = s_same.float().mean().item()
    moved = int(np.abs(np.asarray(sk["counts"])
                       - np.asarray(sp["counts"])).sum())
    del model, lp, gap, same, s_same
    if (s_err > LOGIT_ATOL or s_agree < MAIN_AGREE
            or moved > 3 * (1 - MAIN_AGREE) * pixels
            or sk["launches"] != want or sp["launches"] != none):
        raise AssertionError(
            f"profile_eval on the SYNTH batch: logits max abs err {s_err}, "
            f"argmax agreement {s_agree}, counts {sk['counts']} vs "
            f"{sp['counts']} ({moved} moved of {pixels} pixels), launches "
            f"{sk['launches']} / {sp['launches']}")
    out["profile_eval"] = {"kernels": ev, "plain": ev_plain,
                           "logits_max_abs_err_vs_plain": err,
                           "argmax_agreement_vs_plain": agree,
                           "synth_counts": {"kernels": sk["counts"],
                                            "plain": sp["counts"]},
                           "synth_counts_moved": moved, "pixels": pixels,
                           "synth_logits_max_abs_err_vs_plain": s_err,
                           "synth_argmax_agreement_vs_plain": s_agree,
                           "main_agree": MAIN_AGREE}
    torch.cuda.empty_cache()

    # profile_train, eager and one replayed chunk
    tr = profile_train.main(TOOLS_TRAIN_ARGS)
    fu = profile_train.main(TOOLS_TRAIN_ARGS[:-4] + [
        "--steps", str(TOOLS_FUSE), "--loss", "cedt", "--fuse",
        str(TOOLS_FUSE)])
    for r in (tr, fu):
        want = {k: r["steps_traced"] * n for k, n in STEP_LAUNCHES.items()}
        if r["profiled_launches"] != want or r["launches"] != want:
            raise AssertionError(
                f"profile_train (fuse {r['fuse_steps']}) launches "
                f"{r['launches']}, profiled {r['profiled_launches']}, "
                f"want {want}")
    out["profile_train"] = {"eager": tr, "fused": fu}
    torch.cuda.empty_cache()

    # memory_report, every row
    rows = memory_report.main([])
    for r in rows:
        p1, p2 = r["peak_bytes"]
        if not p2 > p1 > r["params_bytes"]:
            raise AssertionError(f"memory row {r}")
    out["memory_report"] = rows
    torch.cuda.empty_cache()

    # the train levers
    out["levers_verify"] = exp_train_levers.main(["verify"])
    out["levers_measure"] = {
        "eager": exp_train_levers.main(["measure"]),
        "fused": exp_train_levers.main(["measure", "--fuse",
                                        str(TOOLS_FUSE)])}
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    out["conv_s2b_vs_native"] = conv_s2b_times(torch, flush)
    del flush
    torch.cuda.empty_cache()

    # bench_input, at the demand measured above
    demand = f"train={tr['device_eps']},test={ev['device_eps']}"
    out["bench_input"] = {
        "cached": bench_input.main(TOOLS_INPUT_ARGS
                                   + ["--device-eps", demand]),
        "no_cache": bench_input.main(TOOLS_INPUT_ARGS
                                     + ["--device-eps", demand,
                                        "--no-cache"])}

    # verify_real_data: the dry run, phase 4, one planned test
    text = io.StringIO()
    with redirect_stdout(text):
        rc = verify_real_data.main(["--splits", "0", "--shots", "1",
                                    "--families", "pemp_stage1,pemp_stage2"])
    dry = text.getvalue()
    print(dry, flush=True)
    if rc != 0 or dry.count("[SKIP]") != 5:
        raise AssertionError(f"verify_real_data dry run rc {rc}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpts = tmp / "ckpts"
        ckpts.mkdir()
        for seed, fam in enumerate(("pemp_stage1", "pemp_stage2")):
            m = verify_real_data.family_model(fam, 1)
            m.reset_parameters(torch.Generator().manual_seed(seed))
            torch.save(m.state_dict(),
                       ckpts / f"{fam}_pascal_split0_shot1.pth")
        found = {"pascal": False, "coco": False}
        convert = verify_real_data.phase_convert(tmp, found, ckpts)
        if convert[0] != verify_real_data.OK:
            raise AssertionError(f"verify_real_data phase 4 {convert}")
        write_voc_tree(tmp / "VOCdevkit" / "VOC2012")
        plan = verify_real_data.miou_plan(
            tmp, None, ["pemp_stage1"], [0], [1], ["pascal"], tmp / "md",
            "cuda", ["data.test_n=8", "te.epochs=1"])
        t0 = time.perf_counter()
        rc, miou, tail = verify_real_data.run_row(plan[0]["cmd"],
                                                  timeout=SERVE_TIMEOUT_S)
        if rc != 0 or miou is None or not math.isfinite(miou):
            raise AssertionError(f"planned test rc {rc}, mIoU {miou}: "
                                 f"{tail}")
        pub = plan[0]["published"]
        out["verify_real_data"] = {
            "dry_run_rc": 0, "convert": convert,
            "planned_cmd": plan[0]["cmd"][2:], "miou": miou,
            "published": pub, "status": (
                "no published row" if pub is None else
                "PASS" if abs(miou - pub) <= verify_real_data.TOLERANCE
                else "FAIL (expected on a miniature tree)"),
            "planned_wall_s": time.perf_counter() - t0}

    torch.cuda.synchronize()
    launches = {k: v for k, v in {**K.launches, **M.launches}.items()
                if k in STEP_LAUNCHES}
    out.update(launches=launches, wall_s=time.perf_counter() - start)
    emit(out)
    return launches


def ops_int8_exact(torch, conv_tool, device):
    """The int8 tools' int32 accumulation (a ``torch._int_mm`` GEMM) against
    the exact integer convolution (float64 ``F.conv2d``, whose integer
    sums are exact) on one case a formulation of OPS_INT8_EXACT, seeded
    int8 inputs at the cases' widths: {case: (formulation, equal)}."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, n, h, ci, co, k, s, d in OPS_INT8_EXACT:
        xq = torch.randint(-127, 128, (n, h, h, ci), generator=gen,
                           dtype=torch.int8).to(device)
        wq = torch.randint(-127, 128, (k, k, ci, co), generator=gen,
                           dtype=torch.int8).to(device)
        conv = conv_tool.gemm_conv(wq, s, d)
        got = conv_tool.int8_conv(xq, conv).long()
        want = conv_tool.exact_conv(xq, wq, s, d)
        out[name] = {"formulation": conv.kind, "k_pad": list(conv.k_pad),
                     "equal": bool(torch.equal(got, want)),
                     "max_abs_acc": int(want.abs().max())}
    return out


def ops_ckpt_roundtrip(torch, tmp):
    """A seeded stage-1 ResNet-50 reference ``.pth`` through
    ``convert_reference_ckpt`` (-> ``.pt``) and ``export_reference_ckpt``
    (-> ``.pth``), bit-equal; the eval forward of the converted ``.pt``
    on the card against that of the ``.pth`` loaded directly (f32, cuDNN
    deterministic), bit-equal; K1/K2 once a forward."""
    from pemp_tpu_torch.core.experiment import load_weights
    from pemp_tpu_torch.tools import convert_reference_ckpt as convert
    from pemp_tpu_torch.tools import export_reference_ckpt as export
    from pemp_tpu_torch.tools.verify_real_data import load_strict, read_pth

    device = torch.device("cuda")
    model = convert.build_model("pemp_stage1", "resnet50", 1)
    model.reset_parameters(torch.Generator().manual_seed(7))
    ref, pt, back = tmp / "ref.pth", tmp / "conv.pt", tmp / "back.pth"
    torch.save(export.reference_sd(model), ref)
    args = ["--model", "pemp_stage1", "--backbone", "resnet50"]
    t0 = time.perf_counter()
    convert.main([*args, "--ckpt", str(ref), "--out", str(pt)])
    export.main([*args, "--ckpt", str(pt), "--out", str(back)])
    convert_s = time.perf_counter() - t0
    want, got = read_pth(ref), read_pth(back)
    same = set(want) == set(got) and all(
        got[k].dtype == v.dtype and torch.equal(got[k], v)
        for k, v in want.items())
    if not same:
        raise AssertionError("converted .pth -> .pt -> .pth differs")

    sup, msk, qry, _ = (torch.from_numpy(a).to(device) for a in
                        synth_eval_inputs(OPS_CKPT_BATCH, 1, 401))
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    logits = {}
    try:
        for how in ("pth", "pt"):
            m = convert.build_model("pemp_stage1", "resnet50", 1)
            if how == "pth":
                load_strict(m, want)
            else:
                load_weights(m, pt)
            m = m.to(device).eval()
            with torch.no_grad():
                logits[how] = m(sup, msk, qry).float()
            torch.cuda.synchronize()
            del m
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    equal = torch.equal(logits["pt"], logits["pth"])
    finite = bool(torch.isfinite(logits["pt"]).all())
    if not (equal and finite):
        raise AssertionError(
            f"forward of the converted .pt vs the .pth: equal {equal}, "
            f"finite {finite}, max abs diff "
            f"{(logits['pt'] - logits['pth']).abs().max().item()}")
    return {"tensors": len(want), "pth_roundtrip_bit_equal": True,
            "forward_bit_equal": True, "logits_shape":
            list(logits["pt"].shape), "convert_export_s": convert_s,
            "file_bytes": {p.name: p.stat().st_size for p in (ref, pt,
                                                              back)}}


def ops_launches(n: int) -> dict:
    """A kernel row's ``ops_tools_path_launches``: the in-process count
    (the converters' forwards) and the parts run in subprocesses."""
    return {"in_process": n, "soak_drill": "subprocess",
            "flag_sweep": "subprocess"}


def ops_tools_path_phase(torch, K, M, smi):
    """The last operator tools on the card:

    - the launch preset: ``pemp_tpu_torch/scripts/pemp_stage1.sh
      print_config cuda`` shows ``dev.fuse_steps = 8``;
    - ``soak_run``: the stage-1 preset's ``train cuda`` (401², ResNet-50,
      fused chunks of 8, prefetch, observers and ``g.mongodb``),
      OPS_SOAK_TRAIN_N episodes an epoch, three epochs, SIGTERM once
      epoch 1 is recorded, then ``resume=True exp_id=1``: both phases exit
      0, three epochs recorded once each, the chained test's line, the run
      folder's checkpoints, records and Mongo files; where the stop landed
      (epoch, steps, chunks) is printed;
    - ``exp_int8_conv`` (3 cases) and ``exp_int8_blend`` (23 rows, B = 64):
      no arm errors; the int32 accumulation exact on one case a
      formulation (``ops_int8_exact``);
    - ``exp_cudnn_flags`` at batch 4, arms OPS_FLAG_ARMS: every arm ran,
      with the dilation-12 and -18 convolutions' device ms;
    - the converters (``ops_ckpt_roundtrip``), in this process.

    Returns K1-K5's wrapper counts over the phase's in-process parts (the
    soak drill and the flag sweep run in subprocesses, not counted)."""
    from pemp_tpu_torch.tools import (
        exp_cudnn_flags, exp_int8_blend, exp_int8_conv, soak_run,
    )

    device = torch.device("cuda")
    start = time.perf_counter()
    # PyTorch's default cuDNN flags, as in tools_path (the flag sweep's
    # arms set theirs in their own processes)
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = False, False, True
    K.reset_launches()
    M.reset_launches()
    out = {"phase": "ops_tools_path", "nvidia_smi": smi}

    # the launch preset
    preset = ROOT / "pemp_tpu_torch" / "scripts" / "pemp_stage1.sh"
    r = subprocess.run(["bash", str(preset), "print_config", "cuda"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHON": sys.executable})
    if r.returncode != 0 or "dev.fuse_steps = 8" not in r.stdout:
        raise AssertionError(f"preset print_config rc {r.returncode}: "
                             f"{r.stdout[-800:]} {r.stderr[-800:]}")
    out["preset_print_config"] = [ln.strip() for ln in r.stdout.splitlines()
                                  if ln.strip().startswith(
                                      ("dev.", "tag", "tr.total_epochs",
                                       "loss", "net.backbone ="))]

    # the SIGTERM / resume drill
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as md:
        soak = soak_run.drill(Path(md), OPS_SOAK_TRAIN_N, 1, OPS_SOAK_POLL,
                              OPS_SOAK_DEVICE, OPS_SOAK_ARGS)
        print("SOAK_SUMMARY " + json.dumps(soak), flush=True)
        run_dir = Path(md) / "pemp_stage1" / "1"
        files = sorted(p.name for p in run_dir.iterdir())
        mongo = sorted(p.name for p in (run_dir / "mongo").iterdir()) \
            if (run_dir / "mongo").is_dir() else []
        log = (Path(md) / "soak_train.log").read_text()
        first = log.find("Traceback")
        log_tail = (log[first:first + 4000] + " ... " if first >= 0
                    else "") + log[-2000:]
    soak["wall_s"] = time.perf_counter() - t0
    soak["run_files"], soak["mongo_files"] = files, mongo
    out["soak"] = soak
    stop = soak.get("stop") or {}
    print(f"ops_tools_path soak: SIGTERM at epoch {soak['sigterm_at_epoch']}"
          f", stop inside epoch {stop.get('epoch')} after "
          f"{stop.get('steps')} steps = {stop.get('chunks')} chunks of "
          f"{stop.get('fuse_steps')}", flush=True)
    want_files = {"ckpt.pt", "bestckpt.pt", "config.json", "metrics.json",
                  "mongo"}
    if not ((soak["rc1"], soak["rc2"]) == (0, 0)
            and soak["epochs_recorded"] == 3
            and soak["duplicate_epochs"] == [] and soak["final_test"]
            and soak["sigterm_at_epoch"] is not None and stop
            and want_files <= set(files)
            and mongo == ["metrics.json", "runs.json"]):
        raise AssertionError(f"soak drill {soak}; log tail {log_tail}")
    torch.cuda.empty_cache()

    # the int8 microbenchmarks
    t0 = time.perf_counter()
    conv_rows = exp_int8_conv.main([])
    blend_rows, blend = exp_int8_blend.main([])
    errors = [r["case"] for r in conv_rows + blend_rows
              if any(k.endswith("_error") for k in r)]
    exact = ops_int8_exact(torch, exp_int8_conv, device)
    out["int8"] = {"conv": conv_rows, "blend_rows": blend_rows,
                   "blend": blend, "exact": exact,
                   "wall_s": time.perf_counter() - t0}
    if errors or "speedup" not in blend or len(blend_rows) != 23 or not all(
            e["equal"] for e in exact.values()):
        raise AssertionError(f"int8: error rows {errors}, blend {blend}, "
                             f"exact {exact}")
    for r in conv_rows + blend_rows:
        print(f"ops_tools_path int8 {r['case']}: bf16 {r['bf16_ms']:.4f} "
              f"ms, bf16 GEMM {r['bf16_gemm_ms']:.4f} ms, int8 "
              f"{r['int8_ms']:.4f} ms; GEMM alone bf16 "
              f"{r['bf16_mm_ms']:.4f} ms, int8 {r['int8_mm_ms']:.4f} ms",
              flush=True)
    print(f"ops_tools_path int8 blend: bf16 {blend['blend_bf16_ms']:.3f} ms"
          f", bf16 GEMM {blend['blend_bf16_gemm_ms']:.3f} ms, int8 "
          f"{blend['blend_int8_ms']:.3f} ms, speedup {blend['speedup']:.4f}"
          f" (vs bf16 GEMM {blend['speedup_vs_bf16_gemm']:.4f}); GEMM alone"
          f" bf16 {blend['blend_bf16_mm_ms']:.3f} ms, int8 "
          f"{blend['blend_int8_mm_ms']:.3f} ms", flush=True)
    torch.cuda.empty_cache()

    # the cuDNN flag sweep (a subprocess an arm)
    t0 = time.perf_counter()
    rows, summary = exp_cudnn_flags.main(["--bs", "4", "--budget",
                                          OPS_FLAG_BUDGET, "--arms",
                                          *OPS_FLAG_ARMS])
    bad = [r for r in rows if "error" in r]
    if bad or [r["arm"] for r in rows] != OPS_FLAG_ARMS:
        raise AssertionError(f"flag sweep: {bad or rows}")
    out["cudnn_flags"] = {"rows": rows, "summary": summary,
                          "wall_s": time.perf_counter() - t0}
    for r in rows:
        print(f"ops_tools_path flags {r['arm']}: step {r['step_ms']} ms, "
              f"device {r['device_ms_per_step']} ms/step, idle "
              f"{r['device_idle_share']}, d12/d18 convs "
              f"{r['conv_ms_by_dilation']} ms", flush=True)

    # the converters, in this process (K1/K2 counted)
    K.reset_launches()
    M.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        out["ckpt"] = ops_ckpt_roundtrip(torch, Path(tmp))
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**K.launches, **M.launches}.items()
                if k in STEP_LAUNCHES}
    want = {k: 2 * n for k, n in EVAL_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"converter forwards launched {launches}, "
                             f"want {want}")
    out.update(launches=launches, wall_s=time.perf_counter() - start)
    emit(out)
    return launches


def finite_positive(*values) -> bool:
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in values)


def bench_counts_vs_plain(torch, bench_tool, counts_one):
    """``bench``'s counts of one launch against the same launch under
    ``use_kernels(False)`` (``dev.use_kernels=False``), within the argmax
    tolerance: the logits within LOGIT_ATOL, the argmax flipping only at
    near-ties (a plain top-two gap <= 2 x the measured error), and the
    counts moved by at most 3 a near-tie pixel (a flip moves three
    counts by one)."""
    import numpy as np

    from pemp_tpu_torch.core.metrics import tp_fp_fn
    from pemp_tpu_torch.ops.kernels import use_kernels
    from pemp_tpu_torch.tools import profile_eval

    device = torch.device("cuda")
    hw, batch = bench_tool.HW, bench_tool.BATCH
    sup, msk, qry, ref = (torch.from_numpy(a).to(device) for a in
                          profile_eval.make_inputs(batch, 1, hw))
    model = profile_eval.build_model(device)
    with torch.no_grad():
        lk = model(sup, msk, qry).float()
        with use_kernels(False):
            lp = model(sup, msk, qry).float()
    err = (lk - lp).abs().max().item()
    same = lk.argmax(-1) == lp.argmax(-1)
    near = (lp[..., 1] - lp[..., 0]).abs() <= 2 * err
    plain = tp_fp_fn(lp.argmax(-1).to(torch.int32).reshape(-1, hw, hw),
                     ref).sum(0).tolist()
    out = {"logits_max_abs_err": err,
           "argmax_agreement": same.float().mean().item(),
           "flips_outside_near_ties": int((~same & ~near).sum()),
           "near_tie_pixels": int(near.sum()), "plain_counts": plain,
           "counts": counts_one,
           "counts_moved": int(np.abs(np.asarray(counts_one)
                                      - np.asarray(plain)).sum())}
    del model, lk, lp, same, near
    torch.cuda.empty_cache()
    if (err > LOGIT_ATOL or out["flips_outside_near_ties"]
            or out["counts_moved"] > 3 * out["near_tie_pixels"]):
        raise AssertionError(f"bench counts vs dev.use_kernels=False: {out}")
    return out


def tool_lines(main, argv):
    """A tool's ``main(argv)`` with its stdout captured and echoed: (what
    it returned, the JSON lines it printed, parsed)."""
    import io
    from contextlib import redirect_stdout
    text = io.StringIO()
    with redirect_stdout(text):
        got = main(argv)
    print(text.getvalue(), end="", flush=True)
    return got, [json.loads(ln) for ln in text.getvalue().splitlines()
                 if ln.startswith("{")]


def bench_path_phase(torch, K, M, smi):
    """The measurement tools on the card (``pemp_tpu_torch/tools/``), each
    through its command line's ``main``, PEMP_BENCH_BUDGET_S =
    BENCH_BUDGET_S; every line a tool prints parses, and is what it
    returned:

    - ``bench`` (stage 1, 401², B = 256, bf16): exactly one line, the
      JAX script's four keys, the value finite and above 0,
      ``vs_baseline`` = value / 25; K1 and K2 once an ``eval_batch``
      call; its counts of one launch within the argmax tolerance of the
      same launch with ``dev.use_kernels=False``
      (``bench_counts_vs_plain``);
    - ``bench_train --fuse BENCH_FUSE`` (batch 4, cedt, 401², bf16): every
      rate finite and above 0, 0 < mfu <= 1; K1-K5 over the timed steps:
      none in ``plain``, STEP_LAUNCHES a step in ``kernels`` and in the
      fused arm (its replays' launches);
    - ``bench_zoo`` BENCH_ZOO_ROWS (the artifact at B = 1): every value
      finite and above 0; K1 and K2 once a stage a call; ``device_ms``
      finite and above 0; p99 >= p50;
    - ``bench_train_zoo`` BENCH_TRAIN_ZOO_ROWS: stage 2 launches two mpm
      chains, one backward and one EDT a step, CaNet nothing; 0 < mfu <= 1.

    Returns K1-K5's wrapper counts over the phase (the table's
    ``bench_path_launches``; a replay adds nothing to them)."""
    from unittest import mock

    from pemp_tpu_torch.tools import (
        bench, bench_train, bench_train_zoo, bench_zoo,
    )

    start = time.perf_counter()
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = False, False, True
    K.reset_launches()
    M.reset_launches()
    out = {"phase": "bench_path", "nvidia_smi": smi,
           "budget_s": BENCH_BUDGET_S}
    walls = {}
    with mock.patch.dict(os.environ,
                         {"PEMP_BENCH_BUDGET_S": BENCH_BUDGET_S}):
        # bench
        t0 = time.perf_counter()
        b, printed = tool_lines(bench.main, [])
        line = {k: b[k] for k in ("metric", "value", "unit", "vs_baseline")}
        if not (printed == [line] and finite_positive(b["value"])
                and b["vs_baseline"] == b["value"] / bench.V100_EST_EPS
                and b["launches"] == {"assign": b["calls"],
                                      "match": b["calls"]}):
            raise AssertionError(f"bench: {b}; printed {printed}")
        out["bench"] = b
        out["bench_vs_plain"] = bench_counts_vs_plain(torch, bench,
                                                      b["counts"])
        walls["bench"] = time.perf_counter() - t0

        # bench_train, plain / kernels / fused
        t0 = time.perf_counter()
        lines, printed = tool_lines(bench_train.main,
                                    ["--fuse", str(BENCH_FUSE)])
        rows = lines[:3]
        if printed != lines or [r["path"] for r in rows] != [
                "plain", "kernels", f"kernels+fuse{BENCH_FUSE}"]:
            raise AssertionError(f"bench_train lines {printed}")
        for r in rows:
            want = {k: 0 if r["path"] == "plain"
                    else r["steps_timed"] * n
                    for k, n in STEP_LAUNCHES.items()}
            if not (finite_positive(r["episodes_per_s"], r["step_flops"],
                                    r["mfu"]) and r["mfu"] <= 1
                    and math.isfinite(r["loss_final"])
                    and r["launches"] == want):
                raise AssertionError(f"bench_train {r['path']}: {r}; "
                                     f"launches want {want}")
        out["bench_train"] = lines
        walls["bench_train"] = time.perf_counter() - t0

        # bench_zoo
        t0 = time.perf_counter()
        with mock.patch.object(bench_zoo, "ARTIFACT_BATCHES", (1,)), \
                mock.patch.object(bench_zoo, "ARTIFACT_SAMPLES",
                                  {1: BENCH_ARTIFACT_SAMPLES}), \
                mock.patch.object(bench_zoo, "ARTIFACT_ROUNDS", 2):
            zoo, printed = tool_lines(bench_zoo.main, BENCH_ZOO_ROWS)
        if printed != zoo or [r["row"] for r in zoo] != [
                "cascade1", "latency1", "latency1", "latency_artifact"]:
            raise AssertionError(f"bench_zoo lines {printed}")
        for r in zoo:
            stages = 1 if r["metric"].startswith("pemp_stage1") else 2
            want = {"assign": stages * r["calls"],
                    "match": stages * r["calls"]}
            ok = finite_positive(r["value"]) and r["launches"] == want
            if "device_ms" in r:
                ok = ok and finite_positive(r["device_ms"])
            if "p99_ms" in r:
                ok = ok and r["p99_ms"] >= r["value"]
            if not ok:
                raise AssertionError(f"bench_zoo {r}; launches want {want}")
        out["bench_zoo"] = zoo
        walls["bench_zoo"] = time.perf_counter() - t0

        # bench_train_zoo
        t0 = time.perf_counter()
        tz, printed = tool_lines(bench_train_zoo.main, BENCH_TRAIN_ZOO_ROWS)
        if printed != tz or [r["row"] for r in tz] != BENCH_TRAIN_ZOO_ROWS:
            raise AssertionError(f"bench_train_zoo lines {printed}")
        for r in tz:
            want = {k: 0 for k in STEP_LAUNCHES}      # CaNet: no kernel
            if r["row"] == "pemp_stage2":
                want = {k: v for k, v in predicted(r["steps_timed"], 0,
                                                   2).items()
                        if k in STEP_LAUNCHES}
            if not (finite_positive(r["value"], r["step_gflops"], r["mfu"])
                    and r["mfu"] <= 1 and r["launches"] == want):
                raise AssertionError(f"bench_train_zoo {r}; launches want "
                                     f"{want}")
        out["bench_train_zoo"] = tz
        walls["bench_train_zoo"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**K.launches, **M.launches}.items()
                if k in STEP_LAUNCHES}
    out.update(launches=launches, walls_s=walls,
               wall_s=time.perf_counter() - start)
    emit(out)
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
    run_launches = run_path_phase(torch, K, M)
    real_launches = real_data_path_phase(torch, K, M)
    parallel_launches = parallel_path_phase(torch, K, M)
    fused_launches = fused_path_phase(torch, K, M, smi)
    serving = serving_path_phase(torch, K)
    tools = tools_path_phase(torch, K, M, smi)
    ops = ops_tools_path_phase(torch, K, M, smi)
    bench = bench_path_phase(torch, K, M, smi)

    # one row per TPU kernel K1-K5. assign and match are one __global__
    # each; the chain (K3, mpm.py:342) is those two launches on the packed
    # tensor and has none of its own (its launches: its calls on the main
    # path, one assign and one match launch each). The mpm rows' launches
    # are the eval path's (their slice), train_path_launches the training
    # path's, stage2_path_launches the stage-2 cascade's,
    # serving_path_launches the exported artifacts' counted calls in their
    # workers (stage 1 and the cascade at B = 1 and 8). minplus: one EDT
    # = its two launches (ms, plain_ms and bound_ms add both phases at the
    # train shapes). mpm_backward (K4):
    # its one kernel, mpm_bwd, one launch per backward pass of the
    # training path.
    mpm_cu = "pemp_tpu_torch/ops/kernels/csrc/mpm.cu"
    table = [
        {"name": name, "route": "cuda", "source": mpm_cu,
         "replaces": replaces, "launches": launches[name],
         "train_path_launches": train_launches[name],
         "stage2_path_launches": stage2_launches[name],
         "vgg_path_launches": vgg_launches[name],
         "run_path_launches": run_launches[name],
         "real_data_path_launches": real_launches[name],
         "parallel_path_launches": parallel_launches[name],
         "fused_path_launches": fused_launches[name],
         "serving_path_launches": serving[name],
         "tools_path_launches": tools[name],
         "ops_tools_path_launches": ops_launches(ops[name]),
         "bench_path_launches": bench[name],
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
        "run_path_launches": run_launches["match"],
        "real_data_path_launches": real_launches["match"],
        "parallel_path_launches": parallel_launches["match"],
        "fused_path_launches": fused_launches["match"],
        "serving_path_launches": serving["match"],
        "tools_path_launches": tools["match"],
        "ops_tools_path_launches": ops_launches(ops["match"]),
        "bench_path_launches": bench["match"],
        "max_abs_err": worst["chain"], "ms": times["chain"],
        "plain_ms": times["chain_plain"], "bound_ms": bounds["chain"][0],
        "bound_by": bounds["chain"][1], "library_ms": None,
        "note": "assign then match on the packed tensor, no launch of its "
                "own: launches = its calls on the main path"})
    table.append({
        "name": "mpm_backward", "route": "cuda",
        "source": "pemp_tpu_torch/ops/kernels/csrc/mpm_bwd.cu",
        "replaces": "pemp_tpu/ops/pallas/mpm_vjp.py:216",
        "launches": train_launches["mpm_bwd"],
        "backward_calls": train_launches["mpm_backward"],
        "stage2_path_launches": stage2_launches["mpm_bwd"],
        "vgg_path_launches": vgg_launches["mpm_bwd"],
        "run_path_launches": run_launches["mpm_bwd"],
        "real_data_path_launches": real_launches["mpm_bwd"],
        "parallel_path_launches": parallel_launches["mpm_bwd"],
        "fused_path_launches": fused_launches["mpm_bwd"],
        "serving_path_launches": serving["mpm_bwd"],
        "tools_path_launches": tools["mpm_bwd"],
        "ops_tools_path_launches": ops_launches(ops["mpm_bwd"]),
        "bench_path_launches": bench["mpm_bwd"],
        "max_abs_err": bw_worst, "ms": bw_times["bfloat16"],
        "ms_no_spin": bw_times["bfloat16_no_spin"],
        "plain_ms": bw_times["bfloat16_plain"],
        "plain_ms_no_spin": bw_times["bfloat16_plain_no_spin"],
        "autograd_plain_ms": bw_times["bfloat16_autograd_plain"],
        "bound_ms": bw_bound[0], "bound_by": bw_bound[1], "library_ms": None,
        "note": "MPMChainPacked.backward: one cooperative launch of "
                "mpm_bwd_kernel; ms and plain_ms with a ~2 ms device spin "
                "(device work), *_no_spin without it (host dispatch "
                "included)"})
    table.append({
        "name": "minplus", "route": "cuda",
        "source": "pemp_tpu_torch/ops/kernels/csrc/minplus.cu",
        "replaces": "pemp_tpu/ops/pallas/minplus.py:47",
        "launches": train_launches["minplus"], "max_abs_err": 0.0,
        "stage2_path_launches": stage2_launches["minplus"],
        "vgg_path_launches": vgg_launches["minplus"],
        "run_path_launches": run_launches["minplus"],
        "real_data_path_launches": real_launches["minplus"],
        "parallel_path_launches": parallel_launches["minplus"],
        "fused_path_launches": fused_launches["minplus"],
        "serving_path_launches": serving["minplus"],
        "tools_path_launches": tools["minplus"],
        "ops_tools_path_launches": ops_launches(ops["minplus"]),
        "bench_path_launches": bench["minplus"],
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


SUBCOMMANDS = {"parallel-worker": parallel_worker, "entry-run": entry_run,
               "serving-worker": serving_worker}

if __name__ == "__main__":
    if len(sys.argv) > 1:
        sys.exit(SUBCOMMANDS[sys.argv[1]](sys.argv[2:]))
    sys.exit(main())
