"""``MPMChainPacked`` (``pemp_tpu_torch/ops/kernels/mpm.py``) on the CPU,
where its forward is the plain chain and its backward the analytic one it
also runs on the card, against ``jax.value_and_grad`` of the JAX package's
packed custom-VJP chain (``mpm_fused_chain_packed``, Pallas in interpret
mode) and of the jnp ground truth, on the same numpy inputs: the value
and all four cotangents (features, fg mask, bg mask, centers).

Tolerance: the value within rtol 1e-4, as tests/test_pallas_vjp.py
uses; each cotangent's max abs error within 5e-5 of its largest
magnitude. Both sides sum in float32 in another order, and against a
float64 run of the same backward each is ~5e-6 of that magnitude off;
the centers' cotangent subtracts nearly equal terms, so its small
elements carry errors of ~1e-3 of themselves and an element-wise rtol
does not fit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.ops.pallas.mpm_vjp import mpm_fused_chain_packed
from pemp_tpu.ops.prototypes import meta_prototype_assign, prototype_predictions
from pemp_tpu_torch.ops.kernels import mpm as K

SCALE = 20.0


GRAD_TOL = 5e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def _grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= GRAD_TOL * scale


def _inputs(seed, b, s, q, n, c, p, zero_bg=False):
    rng = np.random.RandomState(seed)
    fts = rng.randn(b, s + q, n, c).astype(np.float32)
    fg = (rng.rand(b, s, n) > 0.5).astype(np.float32)
    if zero_bg:
        fg[:] = 1.0                       # empty bg class: zero bg prototype
    ctr = rng.rand(c, 2 * p).astype(np.float32)
    w = rng.randn(b, q, n, 2).astype(np.float32)
    return fts, fg, (1.0 - fg).astype(np.float32), ctr, w


def _jax_value_and_grads(fts, fg, bg, ctr, w, s, p):
    def loss_ref(fts, fg, bg, ctr):
        f, g = meta_prototype_assign(fts[:, :s], fg, bg, ctr, p)
        return jnp.sum(prototype_predictions(fts[:, s:], f, g, SCALE) * w)

    def loss_packed(fts, fg, bg, ctr):
        return jnp.sum(mpm_fused_chain_packed(fts, fg, bg, ctr, p, SCALE,
                                              interpret=True) * w)

    args = tuple(jnp.asarray(a) for a in (fts, fg, bg, ctr))
    with jax.default_matmul_precision("highest"):
        return [jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2, 3)))(*args)
                for fn in (loss_ref, loss_packed)]


def _port_value_and_grads(fts, fg, bg, ctr, w, p):
    t = [torch.from_numpy(a).requires_grad_() for a in (fts, fg, bg, ctr)]
    logits = K.MPMChainPacked.apply(*t, p, SCALE, K.ASSIGN_EPS)
    loss = (logits * torch.from_numpy(w)).sum()
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in t]


@pytest.mark.parametrize("s,q", [(1, 1), (2, 1), (1, 2)])
def test_value_and_all_cotangents_match_jax(s, q):
    p = 3
    fts, fg, bg, ctr, w = _inputs(23, 2, s, q, 81, 64, p)
    K.reset_launches()
    value, grads = _port_value_and_grads(fts, fg, bg, ctr, w, p)
    assert K.backward_calls == {"mpm_backward": 1}
    assert K.launches == {"assign_partial": 0, "assign_reduce": 0, "match": 0}
    for ref_value, ref_grads in _jax_value_and_grads(fts, fg, bg, ctr, w, s, p):
        _close(value, ref_value)
        for got, want in zip(grads, ref_grads):
            _grad_close(got, want)


def test_zero_prototype_gives_finite_matching_grads():
    """An empty bg class gives an all-zero bg prototype: the _safe_norm
    guard keeps every cotangent finite. p=1, so the zero class has no tie
    in the max over p (ties split in autodiff, go to the first occurrence
    here)."""
    p = 1
    fts, fg, bg, ctr, w = _inputs(5, 1, 1, 1, 50, 64, p, zero_bg=True)
    value, grads = _port_value_and_grads(fts, fg, bg, ctr, w, p)
    for ref_value, ref_grads in _jax_value_and_grads(fts, fg, bg, ctr, w, 1, p):
        _close(value, ref_value)
        for got, want in zip(grads, ref_grads):
            assert np.isfinite(got).all()
            _grad_close(got, want)


def test_chain_takes_the_function_only_with_grad():
    """With grad enabled and an input that needs it, mpm_chain_packed is
    the Function; under no_grad (eval) it keeps the plain path, bit-equal
    values either way."""
    fts, fg, bg, ctr, _ = _inputs(9, 2, 1, 1, 49, 32, 3)
    t = [torch.from_numpy(a) for a in (fts, fg, bg, ctr)]
    ctr_p = t[3].clone().requires_grad_()
    with torch.no_grad():
        eval_logits = K.mpm_chain_packed(t[0], t[1], t[2], ctr_p, 3)
    train_logits = K.mpm_chain_packed(t[0], t[1], t[2], ctr_p, 3)
    assert eval_logits.grad_fn is None
    assert type(train_logits.grad_fn).__name__ == "MPMChainPackedBackward"
    torch.testing.assert_close(train_logits.detach(), eval_logits, rtol=0,
                               atol=0)
