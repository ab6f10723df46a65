"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Run where there is one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do
not need and the GPU machine may not have.)

Each kernel against its plain PyTorch version on the same CUDA tensors:
partial sums and prototypes within 1e-3 of their largest magnitude,
logits within 2e-3
(float32 sums in another order), indices equal wherever the top-two
similarity margin exceeds 1e-3, and the chain bit-identical run to run.
"""

import pytest
import torch

from pemp_tpu_torch.ops import prototypes as plain
from pemp_tpu_torch.ops.kernels import mpm as K

pytestmark = pytest.mark.cuda

P, SCALE = 3, 20.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b, s, q, n, c, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    fts = torch.randn(b, s + q, n, c, generator=g, device=cuda).to(dtype)
    fg = (torch.rand(b, s, n, generator=g, device=cuda) > 0.6).float()
    ctr = torch.rand(c, 2 * P, generator=g, device=cuda)
    return fts, fg, 1.0 - fg, ctr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,n", [(1, 49), (2, 1030)])
def test_kernels_match_plain(cuda, dtype, s, n):
    fts, fg, bg, ctr = _inputs(cuda, 2, s, 1, n, 64, dtype)
    K.reset_launches()
    part = K._assign_partial_launch(fts, fg, bg, ctr, P)
    ppart = K.plain_assign_partial(fts, fg, bg, ctr, P)
    assert (part - ppart).abs().max() <= 1e-3 * ppart.abs().max()
    red = K._assign_reduce_launch(part, 2, s, plain.ASSIGN_EPS)
    pred = K.plain_assign_reduce(part, 2, s, plain.ASSIGN_EPS)
    assert (red - pred).abs().max() <= 1e-3 * pred.abs().max()

    kf, kb = K.mpm_assign(fts, fg, bg, ctr, P)
    pf, pb = plain.meta_prototype_assign(fts[:, :s], fg, bg, ctr, P)
    ref = torch.cat([pf, pb], 1)
    assert (torch.cat([kf, kb], 1) - ref).abs().max() <= 1e-3 * ref.abs().max()

    kl, ki = K.mpm_match(fts, s, pf, pb, SCALE, return_indices=True)
    pl, pi = plain.prototype_predictions(fts[:, s:], pf, pb, SCALE, True)
    assert (kl - pl).abs().max() <= 2e-3
    margin = torch.stack([
        (plain.cosine_similarity(fts[:, s:], pr[:, None]) * SCALE)
        .topk(2, dim=-1).values.diff(dim=-1).neg()[..., 0]
        for pr in (pb, pf)], dim=-1)
    sure = margin > 1e-3
    assert torch.equal(ki[sure], pi[sure])

    cl, ci = K.mpm_chain_packed(fts, fg, bg, ctr, P, SCALE, True)
    cl2, ci2 = K.mpm_chain_packed(fts, fg, bg, ctr, P, SCALE, True)
    assert torch.equal(cl, cl2) and torch.equal(ci, ci2)
    assert (cl - pl).abs().max() <= 2e-3
    assert K.launches == {"assign_partial": 4, "assign_reduce": 4,
                          "match": 3}


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 64, torch.float16)
    with pytest.raises(TypeError):
        K.mpm_chain_packed(fts, fg, bg, ctr, P)
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 60, torch.float32)
    with pytest.raises(ValueError):
        K.mpm_chain_packed(fts, fg, bg, ctr, P)
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 64, torch.float32)
    with pytest.raises(ValueError):
        K.mpm_chain_packed(fts, fg, bg, torch.rand(64, 18, device=cuda), 9)
    with pytest.raises(ValueError):
        K.mpm_chain_packed(fts, fg.cpu(), bg, ctr, P)
