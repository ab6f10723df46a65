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
The min-plus kernel and the squared EDT are bit-equal to their plain
versions; ``MPMChainPacked``'s cotangents are within 1e-3 of the largest
magnitude of autograd's through the plain chain (float32 features).
"""

import pytest
import torch

from pemp_tpu_torch.ops import edt
from pemp_tpu_torch.ops import prototypes as plain
from pemp_tpu_torch.ops.kernels import minplus as M
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


@pytest.mark.parametrize("m,k,n,z", [(40, 37, 53, 0), (33, 401, 65, 0),
                                     (70, 65, 129, 3)])
def test_minplus_bit_equals_plain(cuda, m, k, n, z):
    g = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(0, 2 ** 20, (m, k), generator=g, device=cuda).float()
    shape = (z, k, n) if z else (k, n)
    b = torch.randint(0, 2 ** 20, shape, generator=g, device=cuda).float()
    M.reset_launches()
    assert torch.equal(M.minplus(a, b), M.plain_minplus(a, b))
    assert M.launches == {"minplus": 1}
    with pytest.raises(TypeError):
        M.minplus(a.double(), b.double())
    with pytest.raises(ValueError):
        M.minplus(a, b.cpu())


def test_edt2_on_the_card_bit_equals_the_cpu(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    feat = torch.rand(3, 61, 47, generator=g, device=cuda) < 0.01
    feat[0, 3, 4] = True
    feat[2] = False
    assert torch.equal(edt.edt2(feat).cpu(), edt.edt2(feat.cpu()))


def test_mpm_backward_matches_autograd_of_plain(cuda):
    fts, fg, bg, ctr = _inputs(cuda, 2, 2, 1, 1030, 64, torch.float32)
    fk, ck = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
    fp, cp = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
    w = torch.randn(2, 1, 1030, 2, device=cuda)
    K.reset_launches()
    lk = K.mpm_chain_packed(fk, fg, bg, ck, P, SCALE)
    gk = torch.autograd.grad((lk * w).sum(), (fk, ck))
    assert K.launches == {"assign_partial": 1, "assign_reduce": 1, "match": 1}
    assert K.backward_calls == {"mpm_backward": 1}
    pf, pb = plain.meta_prototype_assign(fp[:, :2], fg, bg, cp, P)
    lp = plain.prototype_predictions(fp[:, 2:], pf, pb, SCALE)
    gp = torch.autograd.grad((lp * w).sum(), (fp, cp))
    for a, b in zip(gk, gp):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
