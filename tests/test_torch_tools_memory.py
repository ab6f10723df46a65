"""The port's memory report (``pemp_tpu_torch/tools/memory_report.py``)
against the JAX tool (``tools/memory_report.py``): the same eight rows
with their resolutions and probe batches; ``project`` gives the JAX
tool's per-episode slope and projected batch on fixed numbers (its
``report_row`` fed the same bytes); every row's parameter bytes equal the
JAX model's parameter count x bytes (``jax.eval_shape`` of its init, no
compute); on the CPU a row reports no peak, with the reason.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pemp_tpu_torch.tools import memory_report
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tools import memory_report as jax_memory_report

MiB, GiB = 1024 ** 2, 1024 ** 3


def test_rows_are_the_jax_rows():
    assert memory_report.ROWS == jax_memory_report.ROWS


@pytest.mark.parametrize("params,var1,var2,b1,b2", [
    (48e6, 3.1e9, 6.0e9, 8, 16),
    (140e6, 1.5e9, 2.9e9, 4, 8),
    (48e6, 2.0e9, 2.0e9, 2, 4),          # no slope: the 1-byte floor
    (48e6, 0.5e9, 4.9e9, 8, 16),         # no fixed part left
])
def test_project_is_the_jax_arithmetic(monkeypatch, params, var1, var2, b1,
                                       b2):
    """The JAX ``report_row`` on fixed memory analyses (temps carry the
    batch-dependent bytes) against ``project``."""
    key = "pemp_stage1"
    monkeypatch.setitem(jax_memory_report.ROWS, key,
                        ("pemp_stage1", 401, (b1, b2)))
    fixed = {b1: var1, b2: var2}
    monkeypatch.setattr(jax_memory_report, "eval_mem", lambda n, hw, b, d, p: {
        "params_bytes": params, "arg_bytes": params, "out_bytes": 0,
        "temp_bytes": fixed[b]})
    row = jax_memory_report.report_row(key, True, jnp.bfloat16)
    per_ep, fix, max_b = memory_report.project(
        params, var1, var2, b1, b2, jax_memory_report.HBM_BYTES)
    assert round(per_ep / MiB, 1) == row["per_episode_mib"]
    assert max_b == row["projected_max_batch_16gib"]
    assert fix >= params


def _jax_param_bytes(key):
    name, _, _ = jax_memory_report.ROWS[key]
    hw = 41 if key == "pfenet" else 33
    specs = jax_memory_report._zeros_like_spec(
        jax_memory_report.episode_spec(1, 1, 1, hw))
    if key == "s1_train":
        from pemp_tpu.models.pemp_stage1 import PEMPStage1
        model = PEMPStage1(backbone="resnet50", dtype=jnp.float32,
                           use_pallas=False)
        variables = jax.eval_shape(lambda a, m, q: model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, a, m, q, out_hw=None,
            train=True), *specs)
    else:
        model, rngs, extra = jax_memory_report.build(name, hw, jnp.float32,
                                                     False)
        ex = jax_memory_report._zeros_like_spec(extra(1))
        init_rngs = {"params": jax.random.PRNGKey(0), **(rngs or {})}
        variables = jax.eval_shape(lambda a, m, q, *e: model.init(
            init_rngs, a, m, q, *e, out_hw=None), *specs, *ex)
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(variables))


@pytest.mark.parametrize("key", list(jax_memory_report.ROWS))
def test_params_bytes_equal_the_jax_models(key):
    name = memory_report.ROWS[key][0] or "pemp_stage1"
    got = memory_report.state_bytes(memory_report.build(name, "bf16"))
    assert got == _jax_param_bytes(key)


def test_cpu_rows_report_no_peak():
    out = memory_report.main(["pemp_stage1", "s1_train", "--device", "cpu"])
    assert [r["row"] for r in out] == ["pemp_stage1", "s1_train"]
    for r in out:
        assert r["peak_bytes"] is None and "no allocator peak" in r["reason"]
        assert r["params_bytes"] == out[0]["params_bytes"] > 0
        assert r["probe_batches"] == list(memory_report.ROWS[r["row"]][2])
        assert "projected_max_batch" not in r
    with pytest.raises(SystemExit):
        memory_report.main(["bogus", "--device", "cpu"])
