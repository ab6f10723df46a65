"""The port's profiling tools on the CPU (``pemp_tpu_torch/utils/
profiling.py``, ``tools/profile_train.py``, ``tools/profile_eval.py``)
against the JAX tools (``tools/profile_train.py``,
``tools/profile_eval.py``).

- ``profile_eval``'s eval batch at float64, 33x33, batch 2 (ResNet-50,
  1-shot, the JAX tool's ``RandomState(0)`` inputs), with the JAX
  variables of ``PEMPStage1(...).init(PRNGKey(0))`` carried across by
  ``state_dict_from_jax``, gives the JAX ``eval_batch`` counts
  (``tools/profile_eval.py:64-70``) exactly.
- The aggregation on a CPU-profiled run of the port gives the JAX
  tools' JSON keys; its per-op totals are at most the profiled wall
  time, and no CPU number stands under a device metric.
- The CUDA kernel names map onto the JAX tool's ``GROUPS`` labels.
- Without a card and without ``--device cpu`` every tool of the slice
  raises, and the import scan covers every new file.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core.metrics import tp_fp_fn as jax_tp_fp_fn
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.tools import (
    bench_input, exp_train_levers, memory_report, profile_eval,
    profile_train, verify_real_data,
)
from pemp_tpu_torch.utils import profiling
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests import test_torch_no_jax_imports as scan
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tools import profile_train as jax_profile_train

HW, BATCH = 33, 2
# the JAX tools' JSON keys (``pallas`` becomes ``kernels``)
TRAIN_KEYS = {"family", "bs", "hw", "loss", "kernels", "steps_traced",
              "wall_ms_per_step", "device_ms_per_step", "device_eps",
              "dispatch_gap_ms_per_step", "groups_ms_per_step",
              "trace_dir"}
EVAL_KEYS = {"batch", "hw", "shots", "kernels", "launches_traced",
             "wall_ms_per_launch", "device_ms_per_launch", "device_eps",
             "wall_eps", "groups_ms_per_launch", "trace_dir"}
TOOLS = (("bench_input", bench_input.main, ["--device-eps",
                                             "train=1,test=1"]),
         ("exp_train_levers", exp_train_levers.main, ["verify"]),
         ("memory_report", memory_report.main, []),
         ("profile_eval", profile_eval.main, []),
         ("profile_train", profile_train.main, []),
         ("verify_real_data", verify_real_data.main, []))


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


def test_eval_counts_equal_the_jax_eval_batch_at_f64():
    sup, msk, qry, ref = profile_eval.make_inputs(BATCH, 1, HW)
    jax.config.update("jax_enable_x64", True)
    try:
        model = JaxPEMPStage1(backbone="resnet50", dtype=jnp.float64,
                              use_pallas=False)
        args = [jnp.asarray(a, jnp.float64) for a in (sup, msk, qry)]
        variables = jax.jit(lambda s, m, q: model.init(
            {"params": jax.random.PRNGKey(0)}, s, m, q, out_hw=None))(
            args[0][:1], args[1][:1], args[2][:1])

        @jax.jit
        def eval_batch(variables, sup, msk, qry, ref):
            logits = model.apply(variables, sup, msk, qry,
                                 out_hw=(HW, HW), train=False)
            pred = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            refs = jnp.repeat(ref, pred.shape[1], axis=0)
            return jax.vmap(jax_tp_fp_fn)(pred.reshape(-1, HW, HW),
                                          refs).sum(axis=0)

        want = np.asarray(eval_batch(variables, *args, jnp.asarray(ref)))
    finally:
        jax.config.update("jax_enable_x64", False)
    port = PEMPStage1(backbone="resnet50")
    port.load_state_dict(state_dict_from_jax(
        _unfreeze(variables["params"]), _unfreeze(variables["batch_stats"])))
    port = port.double().eval()
    got = profile_eval.eval_batch(
        port, *(torch.from_numpy(a).double() for a in (sup, msk, qry)),
        torch.from_numpy(ref)).numpy()
    assert got.shape == (2, 3) and got.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_profile_eval_cli_on_the_cpu():
    out = profile_eval.main(["--device", "cpu", "--hw", str(HW), "--batch",
                             str(BATCH), "--launches", "2"])
    assert EVAL_KEYS <= set(out) and out["precision"] == "f32"
    assert out["kernels"] is False and out["timeline"] == "cpu"
    assert out["device_ms_per_launch"] is None and out["device_eps"] is None
    assert out["busy_ms_per_launch"] <= out["wall_ms_per_launch"]
    counts = np.asarray(out["counts"])
    # every query pixel is counted once as tp or fn of its GT class
    assert counts.shape == (2, 3)
    assert counts[:, 0].sum() + counts[:, 2].sum() == BATCH * HW * HW
    plain = profile_eval.main(["--device", "cpu", "--hw", str(HW),
                               "--batch", str(BATCH), "--launches", "1",
                               "--no-kernels"])
    assert plain["kernels"] is False
    assert np.asarray(plain["counts"]).sum() == counts.sum()


def test_profile_train_cli_on_the_cpu():
    out = profile_train.main(["--device", "cpu", "--hw", str(HW), "--bs",
                              "2", "--steps", "2"])
    assert TRAIN_KEYS <= set(out) and out["precision"] == "f32"
    assert out["steps_traced"] == 2 and out["loss"] == "cedt"
    assert out["timeline"] == "cpu" and out["device_ms_per_step"] is None
    assert out["device_idle_share"] is None
    wall = out["wall_ms_per_step"]
    assert 0 < out["busy_ms_per_step"] <= wall
    assert all(0 <= v <= wall for v in out["groups_ms_per_step"].values())
    assert all(r["ms_per_step"] <= wall for r in out["top"])
    assert out["groups_ms_per_step"]["conv"] > 0
    assert out["conv_by_shape"] and out["launches"] == {
        k: 0 for k in profiling.KERNEL_SYMBOLS}       # plain versions


def test_profile_train_fused_chunks_on_the_cpu():
    out = profile_train.main(["--device", "cpu", "--hw", str(HW), "--bs",
                              "1", "--steps", "2", "--fuse", "2",
                              "--loss", "ce"])
    assert out["fuse_steps"] == 2 and out["steps_traced"] == 2


@pytest.mark.parametrize("row,fuse", [("pemp_stage2", 1), ("canet", 2)])
def test_profile_train_family_rows_on_the_cpu(row, fuse):
    """A family row at the JAX tool's off-chip size (stage 2 behind a
    seeded stage-1 snapshot; CaNet's history written back a chunk)."""
    out = profile_train.main(["--device", "cpu", "--family", row,
                              "--steps", "2", "--fuse", str(fuse)])
    assert (out["family"], out["loss"], out["hw"], out["bs"]) == (
        row, "preset", HW, 2)
    assert out["steps_traced"] == 2 and out["fuse_steps"] == fuse


def test_family_rows_are_the_jax_rows():
    from tools import bench_train_zoo
    assert profile_train.FAMILY_ROWS == bench_train_zoo.ROWS
    assert profile_train.RUNTIMES == bench_train_zoo.RUNTIMES


def test_summarize_on_a_cpu_profile_keeps_totals_under_the_wall():
    from torch.profiler import ProfilerActivity, profile
    conv = torch.nn.Conv2d(3, 8, 3, padding=2, dilation=2)
    x = torch.randn(2, 3, 17, 17)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            conv(x).relu().sum().backward()
        wall = time.perf_counter() - t0
    s = profiling.summarize(prof, 3, wall)
    assert s["timeline"] == "cpu" and s["device_ms_per_step"] is None
    assert 0 < s["busy_ms_per_step"] <= s["wall_ms_per_step"]
    assert sum(s["groups_ms_per_step"].values()) == pytest.approx(
        s["busy_ms_per_step"])
    shapes = [r["input_shapes"] for r in s["conv_by_shape"]]
    assert any("[2, 3, 17, 17]" in sh for sh in shapes)


@pytest.mark.parametrize("name,group", [
    ("void assign_kernel<3, __nv_bfloat16>(...)", "custom-call/kernels"),
    ("void mpm_bwd_kernel<float, 3>(...)", "custom-call/kernels"),
    ("minplus_kernel", "custom-call/kernels"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("void cudnn::engines_precompiled::dgrad_engine<float>", "conv"),
    ("conv2d_grouped_direct_kernel", "conv"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128", "matmul"),
    ("ampere_sgemm_128x64_nn", "matmul"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", "copy"),
    ("void at::native::max_pool_forward_nhwc<float>", "pool"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "fusion"),
    ("void at::native::batch_norm_collect_statistics_kernel", "fusion"),
    ("some_unknown_kernel", "other"),
])
def test_cuda_kernel_names_map_onto_the_jax_groups(name, group):
    assert profiling.label(name) == group
    jax_labels = {label for _, label in jax_profile_train.GROUPS}
    assert group in (jax_labels - {"custom-call/pallas"}) | {
        "custom-call/kernels", "other"}


@pytest.mark.parametrize("name,main,argv", TOOLS, ids=[t[0] for t in TOOLS])
def test_tools_need_the_card_unless_asked_for_the_cpu(monkeypatch, name,
                                                      main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_the_import_scan_covers_the_tools():
    names = {p.relative_to(scan.ROOT).as_posix() for p in scan.FILES}
    for tool, _, _ in TOOLS:
        assert f"pemp_tpu_torch/tools/{tool}.py" in names
    assert "pemp_tpu_torch/utils/profiling.py" in names
