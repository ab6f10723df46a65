"""The port's int8 convolution microbenchmarks
(``pemp_tpu_torch/tools/exp_int8_{conv,blend}.py``) against the JAX
tools (``tools/exp_int8_{conv,blend}.py``) on the CPU:

- the quantization (the fixed scales of ``exp_int8_conv``, the dynamic
  activation amax and the static per-output-channel weight scale of
  ``exp_int8_blend``) on seeded inputs equals the JAX tools' formulas
  (``jnp.round`` / ``clip`` / ``astype(int8)``) bit for bit;
- the int8 convolution as one ``torch._int_mm`` GEMM (1x1, strided 1x1,
  3x3 d=2 and the 7x7 stride-2 stem through im2col, the stem's K padded
  147 -> 152)
  equals ``jax.lax.conv_general_dilated`` on the same int8 tensors with
  ``preferred_element_type=int32`` exactly; ``_int_mm`` runs on the CPU
  build too, so this is the call the card makes;
- each tool's JSON keys are the JAX tool's (both run with their timing
  stubbed, at toy sizes), plus the port's documented extras; an arm
  that raises is an ``*_error`` entry, and the blend then prints
  ``errors`` and no speedup.
"""

import io
import json
import sys
from contextlib import ExitStack, redirect_stdout
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

sys.path.insert(0, str(Path(__file__).parents[1]))

from pemp_tpu_torch.tools import exp_int8_blend as blend  # noqa: E402
from pemp_tpu_torch.tools import exp_int8_conv as conv  # noqa: E402
from tools import exp_int8_blend as jax_blend  # noqa: E402
from tools import exp_int8_conv as jax_conv  # noqa: E402

DN = lax.conv_dimension_numbers((1, 1, 1, 1), (1, 1, 1, 1),
                                ("NHWC", "HWIO", "NHWC"))
PORT_ROW_EXTRAS = {"formulation", "k_pad", "n_pad"} | {
    f"{arm}_{unit}" for arm in ("bf16_gemm", "bf16_mm", "int8_mm")
    for unit in ("ms", "tflops")}


def test_quantization_equals_the_jax_formulas():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 9, 9, 24) * 3).astype(np.float32)
    # exact halves too, where round-half-to-even decides
    x[0, 0, 0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 7.5, 8.5, -9.5],
                              np.float32) / 16
    w = (rng.randn(3, 3, 24, 16) * 0.05).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)

    # exp_int8_conv: fixed scales
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * 16), -127, 127)
                      .astype(jnp.int8))
    np.testing.assert_array_equal(
        conv.quantize(xt, 1.0 / conv.X_SCALE).numpy(), want)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(w) * 512), -127, 127)
                      .astype(jnp.int8))
    np.testing.assert_array_equal(
        conv.quantize(wt, 1.0 / conv.W_SCALE).numpy(), want)

    # exp_int8_blend: the activation scale (jnp) and the weights' (numpy)
    jx = jnp.asarray(x)
    xscale = jnp.max(jnp.abs(jx)) / 127.0 + 1e-12
    want = np.asarray(jnp.clip(jnp.round(jx / xscale), -127, 127)
                      .astype(jnp.int8))
    got_scale = conv.amax_scale(xt)
    assert got_scale.dtype == torch.float32
    assert got_scale.item() == float(xscale)
    np.testing.assert_array_equal(conv.quantize(xt, got_scale).numpy(), want)
    wscale = np.abs(w).max(axis=(0, 1, 2)) / 127.0 + 1e-12
    wq = np.clip(np.round(w / wscale), -127, 127).astype(np.int8)
    _, got_w = blend.quantized_weights(wt, 1, 1)
    np.testing.assert_array_equal(got_w.numpy(), wscale.astype(np.float32))
    np.testing.assert_array_equal(
        conv.quantize(wt, got_w).numpy(), wq)


# (N, H, Cin, Cout, k, stride, dilation, formulation)
CONV_CASES = [
    (2, 13, 16, 8, 1, 1, 1, "1x1"),
    (2, 13, 16, 16, 1, 2, 1, "1x1"),
    (2, 11, 16, 12, 3, 1, 2, "im2col"),
    (2, 13, 3, 16, 7, 2, 1, "im2col"),
]


@pytest.mark.parametrize("n,h,ci,co,k,s,d,kind", CONV_CASES,
                         ids=lambda v: str(v))
def test_int8_gemm_conv_equals_jax_int32_conv(n, h, ci, co, k, s, d, kind):
    rng = np.random.RandomState(k * 10 + s + d)
    xq = rng.randint(-127, 128, (n, h, h, ci)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8)
    pad = d * (k - 1) // 2
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (s, s), [(pad, pad), (pad, pad)],
        rhs_dilation=(d, d), dimension_numbers=DN,
        preferred_element_type=jnp.int32))
    g = conv.gemm_conv(torch.from_numpy(wq), s, d)
    assert g.kind == kind
    assert g.k_pad == (k * k * ci, -(-k * k * ci // 8) * 8)
    if k == 7:
        assert g.k_pad == (147, 152)
    got = conv.int8_conv(torch.from_numpy(xq), g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the int8_mm arm's GEMM alone, on the operand gathered beforehand
    alone = conv.int8_mm_fn(torch.from_numpy(xq), g)()
    np.testing.assert_array_equal(
        alone[:, :co].reshape(got.shape).numpy(), want)
    # the card's exact reference agrees with both
    np.testing.assert_array_equal(
        conv.exact_conv(torch.from_numpy(xq), torch.from_numpy(wq), s,
                        d).numpy(), want)


class _ZeroDraws:
    """``np.random.RandomState`` whose draws are one zero per axis: the JAX
    tools' arrays stay tiny while their timing is stubbed."""

    def __init__(self, seed):
        pass

    def randn(self, *shape):
        return np.zeros((1,) * len(shape))


def _json_lines(fn):
    text = io.StringIO()
    with redirect_stdout(text):
        fn()
    return [json.loads(ln) for ln in text.getvalue().splitlines()]


def test_exp_int8_conv_keys_equal_the_jax_tool():
    with mock.patch.object(jax_conv, "bench", lambda fn, args: 1e-3), \
            mock.patch.object(np.random, "RandomState", _ZeroDraws):
        want = _json_lines(jax_conv.main)
    toy = [("aspp_3x3_d6", 2, 9, 9, 16, 16, 3, 6),
           ("res_1x1", 2, 9, 9, 32, 16, 1, 1),
           ("res_3x3_d2", 2, 9, 9, 16, 16, 3, 2)]
    with mock.patch.object(conv, "CASES", toy), \
            mock.patch.object(conv, "ITERS", 1), \
            mock.patch.object(conv, "ROUNDS", 1):
        got = _json_lines(lambda: conv.main(["--device", "cpu"]))
    assert [r["case"] for r in got] == [r["case"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w) | PORT_ROW_EXTRAS | {"device"}
        assert not any(k.endswith("_error") for k in g)


def _blend_toy(*extra):
    """The port's blend at toy sizes, one timed call an arm."""
    toy = [("stem_7x7_s2", 1, 13, 13, 3, 16, 7, 2, 1),
           ("l2_in_1x1_s2", 1, 9, 9, 16, 8, 1, 2, 1),
           ("aspp_3x3_d6", 2, 9, 9, 16, 16, 3, 1, 6)]
    stack = ExitStack()
    for p in (mock.patch.object(blend, "CASES", toy),
              mock.patch.object(blend, "B", 2),
              mock.patch.object(blend, "ITERS", 1),
              mock.patch.object(blend, "ROUNDS", 1), *extra):
        stack.enter_context(p)
    return stack


def test_exp_int8_blend_keys_equal_the_jax_tool():
    toy = [("stem_7x7_s2", 1, 13, 13, 3, 16, 7, 2, 1),
           ("l2_in_1x1_s2", 1, 9, 9, 16, 8, 1, 2, 1)]
    with mock.patch.object(jax_blend, "bench",
                           lambda fn, a, iters, rounds: 1e-3), \
            mock.patch.object(jax_blend, "CASES", toy), \
            mock.patch.object(jax_blend, "B", 2):
        *want_rows, want_sum = _json_lines(jax_blend.main)
    with _blend_toy():
        *rows, summary = _json_lines(lambda: blend.main(["--device", "cpu"]))
    assert len(rows) == 3 and len(want_rows) == 2
    for r in rows:
        assert set(r) == set(want_rows[0]) | PORT_ROW_EXTRAS
    assert rows[0]["formulation"] == "im2col" and rows[0]["k_pad"] == [147,
                                                                      152]
    assert set(summary) == set(want_sum) | {
        "blend_bf16_gemm_ms", "blend_bf16_mm_ms", "blend_int8_mm_ms",
        "speedup_vs_bf16_gemm", "device"}
    assert summary["speedup"] == pytest.approx(
        summary["blend_bf16_ms"] / summary["blend_int8_ms"])


def test_an_arm_that_raises_is_an_error_entry():
    def broken(a, b):
        raise RuntimeError("no int8 GEMM here")
    with _blend_toy(mock.patch.object(conv, "int_mm", broken)):
        *rows, summary = _json_lines(lambda: blend.main(["--device", "cpu"]))
    for r in rows:
        assert "int8_error" in r and "int8_ms" not in r and "bf16_ms" in r
        assert "int8_mm_error" in r and "bf16_mm_ms" in r
    assert "speedup" not in summary
    assert summary["errors"] == [f"{r['case']}:{arm}" for r in rows
                                 for arm in ("int8", "int8_mm")]
