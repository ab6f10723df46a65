"""The plain versions of the mpm backward kernels' stages
(``pemp_tpu_torch/ops/kernels/mpm.py``: ``plain_match_bwd_blocks``,
``plain_match_bwd_finish``, ``plain_shot_sums``,
``plain_assign_bwd_blocks`` on ``plain_assign_softmax``'s softmax,
``plain_assign_bwd_finish``) composed as the CUDA kernel's four phases
compose them, on the CPU, against the cotangents of the
JAX package's packed custom-VJP chain (``mpm_fused_chain_packed``, Pallas
in interpret mode, as tests/test_torch_mpm_backward.py runs it) on the
same numpy inputs. The forward partials they read are those of
``plain_assign_blocks`` (the assign kernel's cluster partials), and the
blocks are ragged (n = 81 and 130 rows in blocks of 32). At p = 9, 12
and 16 the stages run on the kernels' padded layout (the instances 12
and 16: zero columns past each class's p, out of every softmax) and,
unpadded, are held against ``_match_backward`` / ``_assign_backward``
at p.

Tolerance: each cotangent's max abs error within GRAD_TOL = 5e-5 of its
largest magnitude, tests/test_torch_mpm_backward.py's: both sides sum in
float32 in another order (here also over blocks), against a float64 run
each is ~5e-6 of that magnitude off, and the centers' cotangent subtracts
nearly equal terms, so an element-wise rtol does not fit. The per-shot
sums of the partials against the backward's recomputed ones: rtol 1e-5
(float32 sums over blocks against one sum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.ops.pallas.mpm_vjp import mpm_fused_chain_packed
from pemp_tpu_torch.ops import prototypes as tp
from pemp_tpu_torch.ops.kernels import mpm as K

SCALE = 20.0
GRAD_TOL = 5e-5
ROWS = 32                 # pixel rows of a backward block (a ring stage)


def _inputs(seed, b, s, q, n, c, p, zero_bg=False):
    rng = np.random.RandomState(seed)
    fts = rng.randn(b, s + q, n, c).astype(np.float32)
    fg = (rng.rand(b, s, n) > 0.5).astype(np.float32)
    if zero_bg:
        fg[:] = 1.0                       # empty bg class: zero bg prototype
    ctr = rng.rand(c, 2 * p).astype(np.float32)
    w = rng.randn(b, q, n, 2).astype(np.float32)
    return fts, fg, (1.0 - fg).astype(np.float32), ctr, w


def _jax_grads(fts, fg, bg, ctr, w, p):
    def loss(fts, fg, bg, ctr):
        return jnp.sum(mpm_fused_chain_packed(fts, fg, bg, ctr, p, SCALE,
                                              interpret=True) * w)

    args = tuple(jnp.asarray(a) for a in (fts, fg, bg, ctr))
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)


def _stages(fts, fg, bg, ctr, w, s, p):
    """The backward as the kernels compute it: the query rows' tile
    partials and the episodes' finish (from the forward's cluster
    partials), then the support rows' tile partials (from the forward's
    softmax) and the centers' finish."""
    fts, fg, bg, ctr, w = (torch.from_numpy(a) for a in (fts, fg, bg, ctr, w))
    b = fts.shape[0]
    num, den = K.plain_assign_blocks(fts, fg, bg, ctr, p, K.CLUSTER * ROWS)
    packed = K.plain_assign_finish(num, den, b, s)
    _, inds = tp.prototype_predictions(fts[:, s:], packed[:, :p],
                                       packed[:, p:], SCALE, True)
    g_q, gp, gpn = K.plain_match_bwd_blocks(fts[:, s:], packed, inds, w, p,
                                            SCALE, ROWS)
    _, g_num, g_den = K.plain_match_bwd_finish(gp, gpn, packed, num, den, s)
    sm = K.plain_assign_softmax(fts, fg, ctr, p)
    g_f, g_fg, g_bg, gc, gd = K.plain_assign_bwd_blocks(
        fts[:, :s], fg, bg, ctr, g_num, g_den, p, ROWS, sm=sm)
    g_ctr = K.plain_assign_bwd_finish(gc, gd, ctr)
    return [torch.cat([g_f, g_q], dim=1), g_fg, g_bg, g_ctr]


def _grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= GRAD_TOL * scale


@pytest.mark.parametrize("n", [81, 130])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("s,q", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_stages_compose_to_the_jax_cotangents(s, q, p, n):
    fts, fg, bg, ctr, w = _inputs(n + 10 * s + q, 2, s, q, n, 64, p)
    got = _stages(fts, fg, bg, ctr, w, s, p)
    for g, want in zip(got, _jax_grads(fts, fg, bg, ctr, w, p)):
        _grad_close(g.numpy(), want)


def test_stages_keep_an_empty_class_finite():
    """An empty bg class gives an all-zero bg prototype: every cotangent
    stays finite and matches JAX's (p=1, so the zero class has no tie)."""
    fts, fg, bg, ctr, w = _inputs(5, 1, 1, 1, 81, 64, 1, zero_bg=True)
    got = _stages(fts, fg, bg, ctr, w, 1, 1)
    for g, want in zip(got, _jax_grads(fts, fg, bg, ctr, w, 1)):
        _grad_close(g.numpy(), want)


@pytest.mark.parametrize("s,n", [(1, 81), (2, 130)])
def test_stages_agree_with_the_plain_backward(s, n):
    """The composed stages against ``MPMChainPacked``'s CPU backward (the
    torch-op plain version), every cotangent within GRAD_TOL."""
    p = 3
    fts, fg, bg, ctr, w = _inputs(n * s, 2, s, 2, n, 64, p)
    got = _stages(fts, fg, bg, ctr, w, s, p)
    t = [torch.from_numpy(a).requires_grad_() for a in (fts, fg, bg, ctr)]
    logits = K.MPMChainPacked.apply(*t, p, SCALE, K.ASSIGN_EPS)
    want = torch.autograd.grad(logits, t, torch.from_numpy(w))
    for g, ref in zip(got, want):
        _grad_close(g.numpy(), ref.numpy())


@pytest.mark.parametrize("s,n", [(1, 81), (2, 130)])
def test_shot_sums_of_the_forward_partials(s, n):
    """num_s and den_s summed from the assign kernel's cluster partials
    against the sums the torch-op backward recomputes, rtol 1e-5."""
    p = 3
    fts, fg, bg, ctr, _ = (torch.from_numpy(a) for a in
                           _inputs(7 + n, 2, s, 1, n, 64, p))
    num, den = K.plain_assign_blocks(fts, fg, bg, ctr, p, K.CLUSTER * ROWS)
    num_s, den_s = K.plain_shot_sums(num, den)
    a = tp.soft_assignment(fts[:, :s], fg, bg, ctr, p)
    want_num = torch.einsum("bsnc,bsnk->bskc", fts[:, :s], a)
    want_den = a.sum(dim=2) + K.ASSIGN_EPS
    torch.testing.assert_close(num_s, want_num.reshape(num_s.shape),
                               rtol=1e-5, atol=1e-5 * want_num.abs().max())
    torch.testing.assert_close(den_s, want_den.reshape(den_s.shape),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("p", [9, 12, 16])
def test_padded_stages_agree_with_the_plain_backward(p):
    """The four stages on the padded instance ``padded_protos(p)`` (the
    centers and prototypes with zero columns, ``live=p``), unpadded,
    against the plain backward at p from the same prototypes and indices,
    every cotangent within GRAD_TOL; the padded columns' cotangents 0."""
    s, n = 2, 81
    pp = K.padded_protos(p)
    fts, fg, bg, ctr, w = (torch.from_numpy(a) for a in
                           _inputs(3 * p, 2, s, 1, n, 64, p))
    ctr_pp = K.pad_protos(ctr, p, pp, 1)
    num, den = K.plain_assign_blocks(fts, fg, bg, ctr_pp, pp,
                                     K.CLUSTER * ROWS, live=p)
    packed_pp = K.plain_assign_finish(num, den, 2, s)
    packed = K.unpad_protos(packed_pp, p, pp, 1)
    _, inds = tp.prototype_predictions(fts[:, s:], packed[:, :p],
                                       packed[:, p:], SCALE, True)
    g_q, gp, gpn = K.plain_match_bwd_blocks(fts[:, s:], packed_pp, inds, w,
                                            pp, SCALE, ROWS)
    g_pk, g_num, g_den = K.plain_match_bwd_finish(gp, gpn, packed_pp, num,
                                                  den, s)
    sm = K.plain_assign_softmax(fts, fg, ctr_pp, pp, live=p)
    dead = (torch.arange(2 * pp) % pp) >= p
    assert not sm.reshape(-1, 2 * pp)[:, dead].any()
    g_f, g_fg, g_bg, gc, gd = K.plain_assign_bwd_blocks(
        fts[:, :s], fg, bg, ctr_pp, g_num, g_den, pp, ROWS, live=p, sm=sm)
    g_ctr_pp = K.plain_assign_bwd_finish(gc, gd, ctr_pp)
    assert not g_pk[:, dead].any() and not g_ctr_pp[:, dead].any()
    g_qry, g_packed = K._match_backward(fts[:, s:], packed, inds, w, p, SCALE)
    g_sup, w_fg, w_bg, w_ctr = K._assign_backward(
        fts[:, :s], fg, bg, ctr, g_packed, p, K.ASSIGN_EPS)
    _grad_close(K.unpad_protos(g_pk, p, pp, 1).numpy(), g_packed.numpy())
    for got, want in ((torch.cat([g_f, g_q], 1), torch.cat([g_sup, g_qry], 1)),
                      (g_fg, w_fg), (g_bg, w_bg),
                      (K.unpad_protos(g_ctr_pp, p, pp, 1), w_ctr)):
        _grad_close(got.numpy(), want.numpy())
