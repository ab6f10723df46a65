"""The port's plain ops (pemp_tpu_torch.ops / core) against their
pemp_tpu counterparts, on the same numpy inputs made from a seed.

Tolerance: float32 on both sides, rtol 1e-5 (atol 1e-6 for values near
zero); integer outputs (indices, counts, nearest resize) equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core import losses as jl
from pemp_tpu.core import metrics as jm
from pemp_tpu.ops import prototypes as jp
from pemp_tpu.ops import resize as jr
from pemp_tpu_torch.core import losses as tl
from pemp_tpu_torch.core import metrics as tm
from pemp_tpu_torch.ops import prototypes as tp
from pemp_tpu_torch.ops import resize as tr

RTOL, ATOL = 1e-5, 1e-6


def close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("hw,out", [((5, 7), (33, 41)), ((51, 51), (401, 401)),
                                    ((9, 9), (9, 4)), ((1, 3), (5, 1))])
def test_resize_bilinear_matches_jax(hw, out):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jr.resize_bilinear_align_corners(jnp.asarray(x), out)
    close(tr.resize_bilinear_align_corners(torch.from_numpy(x), out), ref)
    close(tr.resize_bilinear_align_corners_np(x, out), ref, rtol=1e-5,
          atol=1e-5)
    for in_n, out_n in zip(hw, out):
        np.testing.assert_array_equal(tr._interp_matrix(in_n, out_n),
                                      jr._interp_matrix(in_n, out_n))


@pytest.mark.parametrize("hw,out", [((401, 401), (51, 51)), ((33, 33), (5, 5)),
                                    ((7, 5), (14, 3))])
def test_resize_nearest_matches_jax(hw, out):
    x = np.random.RandomState(1).randint(0, 255, (2, *hw, 2)).astype(np.int32)
    ref = jr.resize_nearest(jnp.asarray(x), out)
    np.testing.assert_array_equal(
        tr.resize_nearest(torch.from_numpy(x), out).numpy(), np.asarray(ref))


def _episode(seed, b=2, s=2, q=1, n=49, c=32, p=3):
    rng = np.random.RandomState(seed)
    sup = rng.randn(b, s, n, c).astype(np.float32)
    qry = rng.randn(b, q, n, c).astype(np.float32)
    fg = (rng.rand(b, s, n) > 0.6).astype(np.float32)
    ctr = rng.rand(c, 2 * p).astype(np.float32)
    return sup, qry, fg, 1.0 - fg, ctr


def test_masked_average_pooling_matches_jax():
    sup, _, fg, _, _ = _episode(2)
    with jax.default_matmul_precision("highest"):
        ref = jp.masked_average_pooling(jnp.asarray(sup), jnp.asarray(fg))
    close(tp.masked_average_pooling(torch.from_numpy(sup),
                                    torch.from_numpy(fg)), ref)


def test_cosine_similarity_matches_jax():
    sup, qry, _, _, _ = _episode(3)
    x, y = qry[:, 0], sup[:, 0, :5]
    y[0, 0] = 0.0           # zero vector: the eps clamp path
    ref = jp.cosine_similarity(jnp.asarray(x), jnp.asarray(y))
    close(tp.cosine_similarity(torch.from_numpy(x), torch.from_numpy(y)),
          ref)


@pytest.mark.parametrize("p", [1, 3])
def test_prototype_predictions_matches_jax(p):
    sup, qry, _, _, _ = _episode(4, p=p)
    fg, bg = sup[:, 0, :p], sup[:, 1, :p]
    if p == 1:
        fg, bg = fg[:, 0], bg[:, 0]          # single-prototype [B, c] form
    lr, ir = jp.prototype_predictions(jnp.asarray(qry), jnp.asarray(fg),
                                      jnp.asarray(bg), 20.0,
                                      return_indices=True)
    lo, io = tp.prototype_predictions(torch.from_numpy(qry),
                                      torch.from_numpy(fg),
                                      torch.from_numpy(bg), 20.0,
                                      return_indices=True)
    close(lo, lr, atol=1e-5)
    np.testing.assert_array_equal(io.numpy(), np.asarray(ir))


@pytest.mark.parametrize("s,p", [(1, 3), (2, 3), (5, 2)])
def test_meta_prototype_assign_matches_jax(s, p):
    sup, _, fg, bg, ctr = _episode(5, s=s, p=p)
    rf, rb = jp.meta_prototype_assign(jnp.asarray(sup), jnp.asarray(fg),
                                      jnp.asarray(bg), jnp.asarray(ctr), p)
    of, ob = tp.meta_prototype_assign(torch.from_numpy(sup),
                                      torch.from_numpy(fg),
                                      torch.from_numpy(bg),
                                      torch.from_numpy(ctr), p)
    close(of, rf)
    close(ob, rb)


def test_eval_loss_and_counts_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(3, 2, 9, 9, 2).astype(np.float32)
    labels = rng.randint(0, 2, (3, 2, 9, 9)).astype(np.int32)
    labels[0, 1, :4] = 255
    labels[2, 0] = 255                                   # a fully void query
    ref = jl.per_episode_cross_entropy(
        jnp.asarray(logits.reshape(3, 2, -1, 2)),
        jnp.asarray(labels.reshape(3, 2, -1)))
    ours = tl.per_episode_cross_entropy(
        torch.from_numpy(logits.reshape(3, 2, -1, 2)),
        torch.from_numpy(labels.reshape(3, 2, -1)))
    close(ours, ref)
    close(tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
          jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))

    pred = logits.argmax(-1).astype(np.int32)
    ref_counts = jax.vmap(jax.vmap(jm.tp_fp_fn))(jnp.asarray(pred),
                                                 jnp.asarray(labels))
    ours_counts = tm.tp_fp_fn(torch.from_numpy(pred), torch.from_numpy(labels))
    np.testing.assert_array_equal(ours_counts.numpy(), np.asarray(ref_counts))
