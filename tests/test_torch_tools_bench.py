"""The port's measurement tools on the CPU (``pemp_tpu_torch/tools/
{bench,bench_train,bench_zoo,bench_train_zoo}.py``), each through its
``main(argv)`` with ``--device cpu`` at toy sizes and one short round,
against the JAX tools (``bench.py``, ``bench_train.py``,
``tools/bench_zoo.py``, ``tools/bench_train_zoo.py``):

- ``bench`` prints exactly one JSON line with the JAX script's keys,
  ``vs_baseline`` = value / 25.0 (run as a script with no progress: the
  line at 0, exit 3); its inputs are bit-equal to the JAX
  script's draws (``bench.py:271-276``, reproduced here in numpy: the
  script starts a watchdog thread when imported), and its counts of one
  launch equal ``profile_eval.eval_batch``'s on them;
- ``bench_train``'s rows carry the JAX tool's keys; each arm's first
  loss equals ``profile_train.flagship_setup``'s first step; the
  forward's FLOP count equals 2 x the MACs of its convolutions (forward
  hooks on the modules) plus its matrix products (the resize's two
  matmuls and the plain mpm's three contractions, from the shapes the
  hooks saw); ``--fuse 2`` counts twice one step's FLOPs a launch;
- ``bench_zoo``'s rows are the JAX tool's; ``cascade1``'s counts equal
  stage 1 -> argmax prior -> stage 2 -> ``tp_fp_fn`` composed here; a
  family row (``canet321``) runs;
- ``bench_train_zoo`` runs a row (CaNet, its history written back) eager
  and with ``--fuse 2`` (the flush deferred a launch).

Nothing is exported and no JAX model runs; nothing is written outside
``tmp_path`` (``bench_train_zoo`` keeps its stage-1 snapshot in a
temporary directory it removes).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pemp_tpu_torch.core.metrics import tp_fp_fn
from pemp_tpu_torch.parallel.step import device_batch, unpack_batch
from pemp_tpu_torch.tools import (
    bench, bench_train, bench_train_zoo, bench_zoo, profile_eval,
    profile_train,
)
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the JAX tools' keys
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
TRAIN_KEYS = {"path", "episodes_per_s", "it_per_s", "step_flops", "device",
              "mfu", "round_rates", "loss_final"}
ZOO_KEYS = {"metric", "value", "unit"}
TRAIN_ZOO_KEYS = {"metric", "value", "unit", "step_gflops", "mfu"}


@pytest.fixture
def one_round(monkeypatch):
    """Every tool's off-card budget at 0 (one round) and short rounds."""
    for mod in (bench, bench_train, bench_zoo, bench_train_zoo):
        monkeypatch.setattr(mod, "OFF_CARD_BUDGET_S", 0)
    monkeypatch.setattr(bench_train, "ROUNDS", 1)
    monkeypatch.setattr(bench_train, "LAUNCHES", 1)
    monkeypatch.setattr(bench_train_zoo, "LAUNCHES", 2)


def jax_bench_draws(batch, hw):
    """``bench.py:271-276``'s draws, in its order."""
    rng = np.random.RandomState(0)
    sup = rng.randn(batch, 1, hw, hw, 3).astype(np.float32)
    fg = (rng.rand(batch, 1, hw, hw, 1) > 0.5).astype(np.float32)
    msk = np.concatenate([fg, 1 - fg], axis=-1)
    qry = rng.randn(batch, 1, hw, hw, 3).astype(np.float32)
    ref = rng.randint(0, 2, (batch, hw, hw)).astype(np.int32)
    return sup, msk, qry, ref


def test_bench_prints_one_contract_line(one_round, capsys):
    out = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS and line["unit"] == "episodes/s"
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / 25.0
    assert "(65x65, B=2, cpu)" in line["metric"]
    assert out["calls"] == bench.WARMUP + bench.CPU_LAUNCHES
    assert out["launches"] == {"assign": 0, "match": 0}   # plain versions

    hw, batch = bench.CPU_HW, bench.CPU_BATCH
    mine = profile_eval.make_inputs(batch, 1, hw)
    for got, want in zip(mine, jax_bench_draws(batch, hw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    model = profile_eval.build_model(CPU)
    want = profile_eval.eval_batch(
        model, *(torch.from_numpy(a) for a in mine)).tolist()
    assert out["counts"] == want
    # every query pixel is counted once as tp or fn of its GT class
    assert sum(want[c][0] + want[c][2] for c in (0, 1)) == batch * hw * hw


def test_bench_watchdog_prints_the_zero_line():
    """Run as a script, ``bench`` arms its watchdog before ``import
    torch``: with a 0.5 s window (less than the import and the model build
    take) it prints the contract line at 0 and exits 3."""
    env = {**os.environ, "PEMP_BENCH_WATCHDOG_S": "0.5"}
    r = subprocess.run([sys.executable, "-m", "pemp_tpu_torch.tools.bench",
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 3, r.stderr[-2000:]
    line, = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert set(line) == BENCH_KEYS and line["value"] == 0.0
    assert "WATCHDOG" in line["metric"] and "WATCHDOG: bench" in r.stderr


def conv_and_matmul_flops(setup):
    """The forward's FLOPs worked out here: 2 x each convolution's MACs
    from forward hooks on the modules, plus the matrix products of the
    plain mpm (f.ctr and the prototype sums over the S supports, the
    cosine over the Q queries) and of the bilinear resize (two
    matmuls), from the shapes the hooks saw."""
    model = setup.model
    macs, feats = [], []

    def conv_hook(m, inp, out):
        n, co, ho, wo = out.shape
        kh, kw = m.kernel_size
        macs.append(n * co * ho * wo * (m.in_channels // m.groups) * kh * kw)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks.append(model.encoder.register_forward_hook(
        lambda m, i, o: feats.append(o.shape)))
    t = unpack_batch(device_batch(setup.batch, CPU,
                                  setup.trainer.cfg.dev.compact_wire,
                                  setup.trainer.runtime.device_keys))
    _, counted, by_op = bench_train.flop_count(
        lambda: setup.trainer.forward(t))
    for h in hooks:
        h.remove()
    b, s, H, W, _ = t["sup_rgb"].shape
    q = t["qry_rgb"].shape[1]
    (_, c, h, w), = feats
    p = model.protos
    mpm = 2 * b * (h * w) * c * (2 * p) * (2 * s + q)
    resize = 2 * H * h * (b * q * w * 2) + 2 * W * w * (b * q * H * 2)
    return counted, by_op, 2 * sum(macs), mpm + resize


def test_bench_train_rows_first_loss_and_flops(one_round, capsys):
    lines = bench_train.main(["--device", "cpu", "--fuse", "2"])
    rows = lines[:3]
    assert [r["path"] for r in rows] == ["plain", "kernels",
                                         "kernels+fuse2"]
    for r in rows:
        assert TRAIN_KEYS <= set(r)
        assert r["kernels"] is False and r["device"] == "cpu"
        assert r["mfu"] is None and "mfu_note" in r
        assert r["episodes_per_s"] > 0 and np.isfinite(r["loss_final"])
        assert r["launches"] == {k: 0 for k in r["launches"]}
    assert set(lines[3]) == {"kernels_speedup"}
    assert set(lines[4]) == {"fused_speedup"}
    # one JSON line a row and a speedup (the entries' log lines beside)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == lines
    assert rows[2]["step_flops"] == 2 * rows[1]["step_flops"]
    assert rows[0]["step_flops"] == rows[1]["step_flops"]
    assert rows[2]["steps_timed"] == 2 * bench_train.LAUNCHES

    setup = profile_train.flagship_setup(bench_train.CPU_HW,
                                         bench_train.CPU_BS, "cedt", CPU,
                                         "f32")
    want = float(setup.trainer.train_step(setup.batch))
    assert {r["loss_first"] for r in rows} == {want}

    counted, by_op, conv, matmul = conv_and_matmul_flops(setup)
    assert by_op["aten.convolution"] == conv
    assert counted == conv + matmul
    assert conv + matmul < rows[1]["step_flops"]     # the backward adds


def test_bench_zoo_rows_are_the_jax_rows():
    from tools import bench_zoo as jax_bench_zoo
    assert list(bench_zoo.ROWS) == list(jax_bench_zoo.ROWS)


def test_cascade1_counts_equal_the_composed_cascade(one_round):
    row, = bench_zoo.main(["cascade1", "--device", "cpu"])
    assert ZOO_KEYS <= set(row) and row["value"] > 0
    assert "(33x33, B=2)" in row["metric"]

    hw, b = bench_zoo.CPU_HW, bench_zoo.CPU_BATCH
    rng = np.random.RandomState(0)
    sup = rng.randn(b, 1, hw, hw, 3).astype(np.float32)
    fg = (rng.rand(b, 1, hw, hw, 1) > 0.5).astype(np.float32)
    msk = np.concatenate([fg, 1 - fg], -1)
    qry = rng.randn(b, 1, hw, hw, 3).astype(np.float32)
    ref = torch.from_numpy(rng.randint(0, 2, (b, hw, hw)).astype(np.int32))
    sup, msk, qry = (torch.from_numpy(a) for a in (sup, msk, qry))
    s1 = profile_eval.build_model(CPU, "pemp_stage1", 1, 0)
    s2 = profile_eval.build_model(CPU, "pemp_stage2", 1, 1)
    with torch.no_grad():
        prior = s1(sup, msk, qry, out_hw=(hw, hw)).argmax(-1).float()
        pred = s2(sup, msk, qry, prior, out_hw=(hw, hw)).argmax(-1)
    want = tp_fp_fn(pred.to(torch.int32).reshape(-1, hw, hw), ref).sum(0)
    assert row["counts"] == want.tolist()


def test_canet321_row_runs(one_round):
    row, = bench_zoo.main(["canet321", "--device", "cpu"])
    assert ZOO_KEYS <= set(row) and row["value"] > 0
    assert row["metric"].startswith("canet 1-shot eval")
    assert row["launches"] == {"assign": 0, "match": 0}


def test_bench_train_zoo_row_eager_and_fused(one_round):
    eager, = bench_train_zoo.main(["canet", "--device", "cpu"])
    fused, = bench_train_zoo.main(["canet", "--device", "cpu", "--fuse",
                                   "2"])
    for row, k in ((eager, 1), (fused, 2)):
        assert TRAIN_ZOO_KEYS <= set(row) and row["value"] > 0
        assert row["fuse_steps"] == k and row["mfu"] is None
        assert row["steps_timed"] % (bench_train_zoo.LAUNCHES * k) == 0
        assert "(33x33, bs=2, preset" in row["metric"]
    assert "fuse=2" in fused["metric"]
    assert fused["step_gflops"] == eager["step_gflops"] > 0
    assert fused["loss_first"] == eager["loss_first"]
