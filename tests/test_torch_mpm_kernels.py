"""The port's mpm kernel wrappers (pemp_tpu_torch/ops/kernels/mpm.py) on
the CPU, where they run their plain version, against the JAX package's
packed Pallas chain in interpret mode (as tests/test_pallas_kernels.py
runs it), on the same numpy inputs.

Tolerance: logits within 1e-4 (cosine x 20, float32 sums in another
order); prototypes within rtol 1e-4 / atol 1e-5; argmax indices equal
wherever the top-two similarity margin exceeds 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pemp_tpu.ops.pallas.mpm import mpm_chain_packed_pallas
from pemp_tpu_torch.ops import prototypes as tp
from pemp_tpu_torch.ops.kernels import mpm as K

C, P, SCALE = 32, 3, 20.0


def _inputs(b, s, q, n, seed):
    rng = np.random.RandomState(seed)
    fts = rng.randn(b, s + q, n, C).astype(np.float32)
    fg = (rng.rand(b, s, n) > 0.6).astype(np.float32)
    ctr = rng.rand(C, 2 * P).astype(np.float32)
    return fts, fg, (1.0 - fg).astype(np.float32), ctr


def _top2_margin(fts_q, fg_proto, bg_proto):
    out = []
    for pr in (bg_proto, fg_proto):
        sims = tp.cosine_similarity(fts_q, pr[:, None]) * SCALE
        top = sims.topk(2, dim=-1).values
        out.append(top[..., 0] - top[..., 1])
    return torch.stack(out, dim=-1).numpy()


@pytest.mark.parametrize("n", [49, 1030])
@pytest.mark.parametrize("s", [1, 2])
def test_chain_matches_pallas_interpret(n, s):
    fts, fg, bg, ctr = _inputs(2, s, 1, n, seed=n + s)
    ref_l, ref_i, ref_f, ref_b = mpm_chain_packed_pallas(
        jnp.asarray(fts), jnp.asarray(fg), jnp.asarray(bg), jnp.asarray(ctr),
        P, SCALE, return_residuals=True, interpret=True)
    t = [torch.from_numpy(a) for a in (fts, fg, bg, ctr)]
    logits, inds = K.mpm_chain_packed(*t, P, SCALE, return_indices=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_l), atol=1e-4,
                               rtol=0)
    f, b = K.mpm_assign(t[0], t[1], t[2], t[3], P)
    np.testing.assert_allclose(f.numpy(), np.asarray(ref_f), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=1e-4,
                               atol=1e-5)
    sure = _top2_margin(t[0][:, s:], f, b) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(inds.numpy()[sure], np.asarray(ref_i)[sure])


def test_match_wrapper_splits_queries_like_the_plain_chain():
    fts, fg, bg, ctr = _inputs(2, 2, 2, 49, seed=7)
    t = [torch.from_numpy(a) for a in (fts, fg, bg, ctr)]
    f, b = K.mpm_assign(*t, P)
    logits, inds = K.mpm_match(t[0], 2, f, b, SCALE, return_indices=True)
    chain_l, chain_i = K.mpm_chain_packed(*t, P, SCALE, return_indices=True)
    assert logits.shape == (2, 2, 49, 2) and inds.dtype == torch.int32
    torch.testing.assert_close(logits, chain_l, rtol=0, atol=0)
    torch.testing.assert_close(inds, chain_i, rtol=0, atol=0)


def test_cpu_path_launches_no_kernel():
    K.reset_launches()
    fts, fg, bg, ctr = _inputs(1, 1, 1, 49, seed=8)
    K.mpm_chain_packed(*[torch.from_numpy(a) for a in (fts, fg, bg, ctr)], P)
    assert K.launches == {"assign": 0, "match": 0, "mpm_bwd": 0}


@pytest.mark.parametrize("n,s", [(49, 1), (1030, 2)])
def test_plain_assign_stages_compose_to_the_jax_prototypes(n, s):
    """The plain versions of the assign kernel's two stages (the partial
    sums of each cluster of blocks at the kernel's rows per block for a
    132-SM card, then the fixed-order finish) give the JAX prototypes:
    rtol 1e-4, atol 1e-5. The partials cover n with a partial last one."""
    fts, fg, bg, ctr = _inputs(2, s, 1, n, seed=n * s)
    _, _, ref_f, ref_b = mpm_chain_packed_pallas(
        jnp.asarray(fts), jnp.asarray(fg), jnp.asarray(bg), jnp.asarray(ctr),
        P, SCALE, return_residuals=True, interpret=True)
    t = [torch.from_numpy(a) for a in (fts, fg, bg, ctr)]
    tiles, rows = K.assign_grid(n, 2 * s, 132)
    num, den = K.plain_assign_blocks(*t, P, K.CLUSTER * rows)
    assert num.shape == (2 * s, tiles // K.CLUSTER, 2 * P, C)
    assert den.shape == (2 * s, tiles // K.CLUSTER, 2 * P)
    protos = K.plain_assign_finish(num, den, 2, s)
    np.testing.assert_allclose(protos[:, :P].numpy(), np.asarray(ref_f),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(protos[:, P:].numpy(), np.asarray(ref_b),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,images,slots,want", [
    (2601, 8, 128, (16, 163)),        # eval: 128 blocks, one wave
    (2601, 4, 128, (32, 82)),         # train: 128 blocks, one wave
    (49, 4, 128, (2, 32)),            # at least one ring stage a block
    (1030, 300, 128, (2, 515)),       # more images than slots
    (990, 4, 132, (32, 32)),          # a last cluster with one empty block
    (2601, 16, 128, (8, 326)),        # 8 images, c=1024: two column passes
])
def test_assign_grid_fills_the_card(n, images, slots, want):
    tiles, rows = K.assign_grid(n, images, slots)
    assert (tiles, rows) == want
    assert tiles % K.CLUSTER == 0
    assert -(-n // rows) <= tiles < -(-n // rows) + K.CLUSTER
