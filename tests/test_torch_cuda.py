"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Run where there is one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do
not need and the GPU machine may not have.)

Each kernel against its plain PyTorch version on the same CUDA tensors:
prototypes within 1e-3 of their largest magnitude, logits within 2e-3
(float32 sums in another order), indices equal wherever the top-two
similarity margin exceeds 1e-3, and the prototypes and the chain
bit-identical run to run. The min-plus kernel (integer and non-integer
inputs) and the squared EDT are bit-equal to their plain versions;
``MPMChainPacked``'s cotangents are within 1e-3 of the largest magnitude
of autograd's through the plain chain (float32 features). Captured in a
CUDA graph (the fused train step's path), the chain's forward and
backward and the EDT replay bit-equal to their eager launches, and a
replay counts no launch; a kernel's plan or tickets missing at capture raise;
``FusedTrainStep`` captures while the ``DevicePrefetcher``'s thread copies.
p above 8: K1, K2 and K4 on the padded instances against their plain
versions, and both PEMP stages at p = 9 and 16 trained and tested through
their entries against ``dev.use_kernels=False``.
The operator tools: ``S2BConv2d`` against cuDNN's dilated convolution
(outputs and gradients, float32 with TF32 off and bfloat16),
``memory_report``'s ``s1_train`` row, and ``profile_train``'s profile
counting K1-K5 as their wrappers do.
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
    assert K.launches == {"assign": 3, "match": 3, "mpm_bwd": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mpm_ops_launch_the_kernels(cuda, dtype):
    """``pemp::mpm_assign`` and ``pemp::mpm_match`` on CUDA tensors launch
    one kernel each, equal the wrappers bit for bit and pass opcheck."""
    fts, fg, bg, ctr = _inputs(cuda, 2, 1, 1, 1030, 64, dtype)
    K.reset_launches()
    packed = torch.ops.pemp.mpm_assign(fts, fg, bg, ctr, P, K.ASSIGN_EPS)
    logits, inds = torch.ops.pemp.mpm_match(fts, 1, packed, P, SCALE, True)
    assert K.launches == {"assign": 1, "match": 1, "mpm_bwd": 0}
    cl, ci = K.mpm_chain_packed(fts, fg, bg, ctr, P, SCALE, True)
    assert torch.equal(logits, cl) and torch.equal(inds, ci)
    torch.library.opcheck(torch.ops.pemp.mpm_assign.default,
                          (fts, fg, bg, ctr, P, K.ASSIGN_EPS))
    for ind in (True, False):
        torch.library.opcheck(torch.ops.pemp.mpm_match.default,
                              (fts, 1, packed, P, SCALE, ind))


@pytest.mark.parametrize("p", [1, 8])
def test_assign_tickets_reset_between_launches(cuda, p):
    """Three back-to-back launches give bit-identical prototypes (the last
    block of each episode resets its ticket), within 1e-3 of plain."""
    g = torch.Generator(device=cuda).manual_seed(p)
    fts = torch.randn(3, 2, 1030, 64, generator=g, device=cuda)
    fg = (torch.rand(3, 1, 1030, generator=g, device=cuda) > 0.6).float()
    ctr = torch.rand(64, 2 * p, generator=g, device=cuda)
    K.reset_launches()
    runs = [torch.cat(K.mpm_assign(fts, fg, 1.0 - fg, ctr, p), 1)
            for _ in range(3)]
    assert K.launches == {"assign": 3, "match": 0, "mpm_bwd": 0}
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ref = torch.cat(plain.meta_prototype_assign(fts[:, :1], fg, 1.0 - fg,
                                                ctr, p), 1)
    assert (runs[0] - ref).abs().max() <= 1e-3 * ref.abs().max()
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in K._ticket_bufs.values())


@pytest.mark.parametrize("c,dtype", [(1024, torch.bfloat16),
                                     (768, torch.float32),
                                     (1512, torch.bfloat16)])
def test_assign_takes_more_than_one_column_pass(cuda, c, dtype):
    """c > 512 channels run in column passes of 512 (1512 bf16 also at
    the fewest ring stages): within 1e-3 of plain, bit-identical twice,
    and the tickets back at zero."""
    fts, fg, bg, ctr = _inputs(cuda, 2, 2, 1, 1030, c, dtype, seed=c)
    K.reset_launches()
    runs = [torch.cat(K.mpm_assign(fts, fg, bg, ctr, P), 1) for _ in range(2)]
    assert K.launches == {"assign": 2, "match": 0, "mpm_bwd": 0}
    assert torch.equal(runs[0], runs[1])
    ref = torch.cat(plain.meta_prototype_assign(fts[:, :2], fg, bg, ctr, P), 1)
    assert (runs[0] - ref).abs().max() <= 1e-3 * ref.abs().max()
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in K._ticket_bufs.values())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 64, torch.float16)
    with pytest.raises(TypeError):
        K.mpm_chain_packed(fts, fg, bg, ctr, P)
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 60, torch.float32)
    with pytest.raises(ValueError):
        K.mpm_chain_packed(fts, fg, bg, ctr, P)
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 64, torch.float32)
    with pytest.raises(ValueError, match="dev.use_kernels=False"):
        K.mpm_chain_packed(fts, fg, bg, torch.rand(64, 34, device=cuda), 17)
    with pytest.raises(ValueError):
        K.mpm_chain_packed(fts, fg.cpu(), bg, ctr, P)
    # more shared memory than a block may have, at the fewest ring stages
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 1600, torch.bfloat16)
    with pytest.raises(ValueError):
        K.mpm_chain_packed(fts, fg, bg, ctr, P)


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


@pytest.mark.parametrize("k", [1, 31, 33, 473])
def test_minplus_bit_equals_plain_on_non_integer_input(cuda, k):
    """Random fp32 with negative values; K not a multiple of the chunk or
    of the split."""
    g = torch.Generator(device=cuda).manual_seed(k)
    a = torch.randn(70, k, generator=g, device=cuda) * 1e3
    b = torch.randn(2, k, 97, generator=g, device=cuda) * 1e-2 - 0.5
    assert torch.equal(M.minplus(a, b), M.plain_minplus(a, b))


def test_edt2_on_the_card_bit_equals_the_cpu(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    feat = torch.rand(3, 61, 47, generator=g, device=cuda) < 0.01
    feat[0, 3, 4] = True
    feat[2] = False
    assert torch.equal(edt.edt2(feat).cpu(), edt.edt2(feat.cpu()))


@pytest.mark.parametrize("p,dtype", [(9, torch.bfloat16),
                                     (12, torch.float32),
                                     (16, torch.bfloat16),
                                     (16, torch.float32)])
def test_padded_protos_kernels_match_plain(cuda, p, dtype):
    """K1 and K2 at p above 8 (the instances 12 and 16, zero columns past
    each class's p): the prototypes, the logits and the indices against
    the plain versions as in test_kernels_match_plain, and no index past
    p."""
    g = torch.Generator(device=cuda).manual_seed(p)
    fts = torch.randn(2, 2, 1030, 512, generator=g, device=cuda).to(dtype)
    fg = (torch.rand(2, 1, 1030, generator=g, device=cuda) > 0.6).float()
    ctr = torch.rand(512, 2 * p, generator=g, device=cuda)
    K.reset_launches()
    kf, kb = K.mpm_assign(fts, fg, 1.0 - fg, ctr, p)
    pf, pb = plain.meta_prototype_assign(fts[:, :1], fg, 1.0 - fg, ctr, p)
    ref = torch.cat([pf, pb], 1)
    assert kf.shape == pf.shape and kb.shape == pb.shape
    assert (torch.cat([kf, kb], 1) - ref).abs().max() <= 1e-3 * ref.abs().max()
    kl, ki = K.mpm_match(fts, 1, pf, pb, SCALE, return_indices=True)
    pl, pi = plain.prototype_predictions(fts[:, 1:], pf, pb, SCALE, True)
    assert (kl - pl).abs().max() <= 2e-3
    assert int(ki.max()) < p
    margin = torch.stack([
        (plain.cosine_similarity(fts[:, 1:], pr[:, None]) * SCALE)
        .topk(2, dim=-1).values.diff(dim=-1).neg()[..., 0]
        for pr in (pb, pf)], dim=-1)
    sure = margin > 1e-3
    assert torch.equal(ki[sure], pi[sure])
    assert K.launches == {"assign": 1, "match": 1, "mpm_bwd": 0}


def test_use_kernels_off_runs_the_plain_versions_on_the_card(cuda):
    """``dev.use_kernels=False`` (``ops.kernels.use_kernels``): CUDA
    tensors take the plain versions of K1-K5, forward and backward, and
    no kernel launches; the outputs equal the plain functions'."""
    from pemp_tpu_torch.ops import kernels
    fts, fg, bg, ctr = _inputs(cuda, 2, 1, 1, 49, 64, torch.float32)
    fk = fts.clone().requires_grad_()
    K.reset_launches()
    M.reset_launches()
    with kernels.use_kernels(False):
        logits = K.mpm_chain_packed(fk, fg, bg, ctr, P, SCALE)
        logits.sum().backward()
        d = edt.edt2(logits[..., 1].detach() > 0)
    assert kernels.kernels_on(fk.device)
    assert not any(K.launches.values()) and not any(M.launches.values())
    assert K.backward_calls == {"mpm_backward": 1}
    pf, pb = plain.meta_prototype_assign(fts[:, :1], fg, bg, ctr, P)
    assert torch.equal(logits.detach(), plain.prototype_predictions(
        fts[:, 1:], pf, pb, SCALE))
    assert torch.equal(d.cpu(), edt.edt2((logits[..., 1].detach() > 0).cpu()))


WIDE_ARGS = ["with", "split=0", "data.dataset=SYNTH", "data.height=65",
             "data.width=65", "data.bs=2", "data.train_n=6",
             "tr.total_epochs=1", "data.test_bs=2", "data.test_n=4",
             "te.epochs=1", "loss=cedt", "dev.precision=f32", "seed=1234"]


@pytest.mark.parametrize("p", [9, 16])
def test_wide_protos_train_and_test_through_the_entries(cuda, tmp_path, p):
    """F9 at the model level: PEMP stage 1 at ``net.protos=p`` and the
    cascade's stage 2 at ``net.protos2=p`` behind that stage 1's file,
    each trained three steps (f32, cedt) by its ``train`` entry on the
    card with the kernels and with ``dev.use_kernels=False``, and the
    kernels' snapshot tested again by its ``test`` entry with
    ``dev.use_kernels=False``. The kernels launch as a step and an eval
    batch do and the plain runs launch none; the one snapshot's test loss
    within 1e-4 relative and its mIoU within 1e-2 (a flip at a near-tie
    pixel moves it); stage 1's first step's loss (same weights, same
    batch) within 1e-5 relative. Not compared: the later steps, whose
    weights part after the first update (the argmax over p of a random
    model's nearly equal prototypes routes a pixel's gradient to another
    prototype), and stage 2's first step, whose input holds stage 1's
    argmax (the prior), which can part at a near-tie pixel."""
    from pemp_tpu_torch.core import checkpoint as ckpt_lib
    from pemp_tpu_torch.entry import pemp_stage1 as entry1
    from pemp_tpu_torch.entry import pemp_stage2 as entry2

    def run(entry, command, extra, on, model_dir):
        K.reset_launches()
        M.reset_launches()
        res = entry.main([command, *WIDE_ARGS, *extra,
                          f"dev.use_kernels={on}",
                          f"g.model_dir={tmp_path / model_dir}"])
        return res, {**K.launches, **M.launches}

    steps, evals = 3, 4      # online eval and chained test: 2 batches each
    extra = [f"net.protos={p}"]
    for stage, entry in ((1, entry1), (2, entry2)):
        if stage == 2:
            extra += [f"net.protos2={p}", "tr.lr=0.0035",
                      f"s1.ckpt={s1_file}"]
        on, launched = run(entry, "train", extra, True, "kernels")
        off, plain_launched = run(entry, "train", extra, False, "plain")
        rid = on["train"]["run_id"]
        tested, test_launched = run(entry, "test", extra + [f"exp_id={rid}",
                                                            "-u"],
                                    False, "kernels")
        s1_file = (tmp_path / "kernels" / "pemp_stage1" / str(rid)
                   / ckpt_lib.BEST)
        assert launched == {"assign": stage * (steps + evals),
                            "match": stage * (steps + evals),
                            "mpm_bwd": steps, "minplus": 2 * steps}
        assert not any(plain_launched.values())
        assert not any(test_launched.values())
        assert len(on["train"]["losses"]) == steps
        first, first_plain = (on["train"]["losses"][0],
                              off["train"]["losses"][0])
        assert stage == 2 or abs(first - first_plain) <= 1e-5 * first_plain
        assert (abs(on["test"]["loss"] - tested["loss"])
                <= 1e-4 * tested["loss"])
        assert abs(on["test"]["miou"] - tested["miou"]) <= 1e-2


def test_mpm_backward_matches_autograd_of_plain(cuda):
    fts, fg, bg, ctr = _inputs(cuda, 2, 2, 1, 1030, 64, torch.float32)
    fk, ck = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
    fp, cp = fts.clone().requires_grad_(), ctr.clone().requires_grad_()
    w = torch.randn(2, 1, 1030, 2, device=cuda)
    K.reset_launches()
    lk = K.mpm_chain_packed(fk, fg, bg, ck, P, SCALE)
    gk = torch.autograd.grad((lk * w).sum(), (fk, ck))
    assert K.launches == {"assign": 1, "match": 1, "mpm_bwd": 1}
    assert K.backward_calls == {"mpm_backward": 1}
    pf, pb = plain.meta_prototype_assign(fp[:, :2], fg, bg, cp, P)
    lp = plain.prototype_predictions(fp[:, 2:], pf, pb, SCALE)
    gp = torch.autograd.grad((lp * w).sum(), (fp, cp))
    for a, b in zip(gk, gp):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def _backward_inputs(cuda, b, s, q, n, c, p, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    fts = torch.randn(b, s + q, n, c, generator=g, device=cuda).to(dtype)
    fg = (torch.rand(b, s, n, generator=g, device=cuda) > 0.6).float()
    ctr = torch.rand(c, 2 * p, generator=g, device=cuda)
    w = torch.randn(b, q, n, 2, generator=g, device=cuda)
    return fts, fg, 1.0 - fg, ctr, w


def _plain_backward(fts, fg, bg, ctr, packed, inds, w, s, p):
    g_qry, g_packed = K._match_backward(fts[:, s:], packed, inds, w, p, SCALE)
    g_sup, g_fg, g_bg, g_ctr = K._assign_backward(
        fts[:, :s], fg, bg, ctr, g_packed, p, plain.ASSIGN_EPS)
    return torch.cat([g_sup, g_qry], 1).to(fts.dtype), g_fg, g_bg, g_ctr


@pytest.mark.parametrize("c,p,dtype", [(64, 3, torch.float32),
                                       (64, 3, torch.bfloat16),
                                       (512, 1, torch.float32),
                                       (512, 8, torch.bfloat16),
                                       (512, 9, torch.bfloat16),
                                       (512, 16, torch.float32),
                                       (512, 16, torch.bfloat16),
                                       (768, 3, torch.float32),
                                       (1024, 3, torch.bfloat16)])
def test_mpm_backward_kernels_match_the_plain_backward(cuda, c, p, dtype):
    """S=2, Q=2, n=1030 (a partial last stage), every cotangent, one and
    two column passes, p = 9 and 16 on the padded instances 12 and 16
    (f32 at p = 16: no row ring, rows read from device memory); two
    backward calls bit-identical and the barrier counters back at zero."""
    fts, fg, bg, ctr, w = _backward_inputs(cuda, 2, 2, 2, 1030, c, p, dtype,
                                           seed=c + p)
    t = [fts.clone().requires_grad_(), fg.clone().requires_grad_(),
         bg.clone().requires_grad_(), ctr.clone().requires_grad_()]
    K.reset_launches()
    logits = K.MPMChainPacked.apply(*t, p, SCALE, plain.ASSIGN_EPS)
    runs = [torch.autograd.grad(logits, t, w, retain_graph=True)
            for _ in range(2)]
    assert K.launches == {"assign": 1, "match": 1, "mpm_bwd": 2}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with torch.no_grad():
        packed = torch.cat(K.mpm_assign(fts, fg, bg, ctr, p), 1)
        _, inds = K.mpm_match(fts, 2, packed[:, :p], packed[:, p:], SCALE,
                              return_indices=True)
    ref = _plain_backward(fts, fg, bg, ctr, packed, inds, w, 2, p)
    for i, (got, want) in enumerate(zip(runs[0], ref)):
        tol = 2.0 ** -7 if i == 0 and dtype == torch.bfloat16 else 1e-3
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs().max()
                <= tol * want.float().abs().max())
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in K._ticket_bufs.values())


def test_mpm_backward_refuses_what_the_kernels_do_not_take(cuda):
    """On CUDA the backward launches its kernels or raises: no fallback
    to the PyTorch ops."""
    fts, fg, bg, ctr, w = _backward_inputs(cuda, 1, 1, 1, 49, 64, P,
                                           torch.float32, seed=1)
    packed, num, den, sm = K._assign_launch(fts, fg, bg, ctr, P,
                                            plain.ASSIGN_EPS, partials=True)
    _, inds = K._match_launch(fts, 1, packed, P, SCALE, True)
    args = [fts, fg, bg, ctr, packed, inds, num, den, sm, w, P, SCALE,
            plain.ASSIGN_EPS, False]
    K.reset_launches()
    for i, bad, err in ((0, fts.half(), TypeError),
                        (1, fg.cpu(), ValueError),
                        (8, sm[:, :1].contiguous(), ValueError),
                        (9, w[..., :1].contiguous(), ValueError),
                        (10, 17, ValueError)):
        with pytest.raises(err):
            K._backward_launch(*args[:i], bad, *args[i + 1:])
    assert K.launches["mpm_bwd"] == 0


@pytest.mark.parametrize("p,c,dtype", [(1, 512, torch.bfloat16),
                                       (8, 512, torch.float32),
                                       (3, 1024, torch.bfloat16),
                                       (3, 4096, torch.bfloat16)])
def test_match_kernel_widths_and_first_occurrence_ties(cuda, p, c, dtype):
    """K2 against plain at p=1 and p=8, c=1024, and c=4096 (no row ring
    fits beside the table: rows read from device memory); the fg
    prototypes [u, v, v] tie at v, which must go to the first of the two
    (index 1, never 2), as the plain argmax does."""
    g = torch.Generator(device=cuda).manual_seed(p * c)
    fts = torch.randn(2, 2, 1030, c, generator=g, device=cuda).to(dtype)
    fgp = torch.randn(2, p, c, generator=g, device=cuda)
    bgp = torch.randn(2, p, c, generator=g, device=cuda)
    if p > 2:
        fgp[:, 2] = fgp[:, 1]
    kl, ki = K.mpm_match(fts, 1, fgp, bgp, SCALE, return_indices=True)
    pl, pi = plain.prototype_predictions(fts[:, 1:], fgp, bgp, SCALE, True)
    assert (kl - pl).abs().max() <= 2e-3
    if p > 2:
        assert (ki[..., 1] != 2).all()
        assert (ki[..., 1] == 1).any()
    margin = torch.stack([
        (plain.cosine_similarity(fts[:, 1:], pr[:, None]) * SCALE)
        .topk(min(2, p), dim=-1).values.diff(dim=-1).neg()[..., 0]
        if p > 1 else torch.full(pl.shape[:-1], 1.0, device=cuda)
        for pr in (bgp, fgp)], dim=-1)
    sure = (margin > 1e-3) | (margin == 0)      # exact ties: first occurrence
    assert torch.equal(ki[sure], pi[sure])


def _vgg_episode(cuda, b=2, hw=97, seed=0):
    g = torch.Generator().manual_seed(seed)
    fg = (torch.rand(b, 1, hw, hw, 1, generator=g) > 0.5).float()
    return [t.to(cuda) for t in (
        torch.randn(b, 1, hw, hw, 3, generator=g), torch.cat([fg, 1 - fg], -1),
        torch.randn(b, 1, hw, hw, 3, generator=g),
        (torch.rand(b, 1, hw, hw, generator=g) > 0.5).float())]


def _plain_chain(fts, sup_fg, sup_bg, ctr, protos, dist_scalar,
                 return_indices=False):
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    s = sup_fg.shape[1]
    return stage1.mpm_predict(fts[:, :s], fts[:, s:], sup_fg, sup_bg, ctr,
                              protos, dist_scalar, return_indices)


@pytest.mark.parametrize("stage", [1, 2])
def test_vgg16_pemp_stages_kernels_match_plain(cuda, stage):
    """PEMP with ``vgg16`` (bf16 VGG16 or VGG16CM, no purifier) on the
    card: the forward through the kernels against the plain mpm on the
    same features (logits within 2e-3, argmax agreement >= 0.999), and
    one f32 train step's gradients (rel L2 <= 1e-3 each, loss rel 1e-5)."""
    from unittest import mock

    from pemp_tpu_torch.core import losses
    from pemp_tpu_torch.models import pemp_stage1 as stage1
    from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2

    cls = stage1.PEMPStage1 if stage == 1 else PEMPStage2
    sup, mask, qry, prior = _vgg_episode(cuda)
    args = (sup, mask, qry) + ((prior,) if stage == 2 else ())
    model = cls(backbone="vgg16", compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(stage))
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    K.reset_launches()
    with torch.no_grad():
        lk = model(*args)
        assert K.launches["assign"] == 1 and K.launches["match"] == 1
        with mock.patch.object(stage1, "mpm_chain_packed", _plain_chain):
            lp = model(*args)
    assert (lk - lp).abs().max() <= 2e-3
    assert (lk.argmax(-1) == lp.argmax(-1)).float().mean() >= 0.999

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model.compute_dtype = torch.float32
        model.train()
        labels = (qry[..., 0] > 0).long().reshape(-1, *qry.shape[2:4])

        def step():
            model.zero_grad(set_to_none=True)
            out = model(*args)
            loss = losses.cedt(out.reshape(-1, *out.shape[-3:]), labels)
            loss.backward()
            return loss.item(), {k: p.grad.clone()
                                 for k, p in model.named_parameters()}

        loss_k, gk = step()
        assert K.launches["mpm_bwd"] == 1
        with mock.patch.object(stage1, "mpm_chain_packed", _plain_chain):
            loss_p, gp = step()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for k in gp:
        assert (gk[k] - gp[k]).norm() <= 1e-3 * gp[k].norm(), k


@pytest.mark.parametrize("name", ["baseline", "panet"])
def test_baseline_and_panet_on_the_card_match_the_cpu(cuda, name):
    """Baseline and PANet (VGG16, f32, TF32 off) on the card against the
    same model on the CPU: logits and PANet's alignment loss within rtol
    1e-3, atol 2e-4 (cuDNN and oneDNN sum in other orders); no kernel
    launched."""
    from pemp_tpu_torch.models.baseline import Baseline
    from pemp_tpu_torch.models.panet import PANet

    sup, mask, qry, _ = _vgg_episode(cuda, hw=65, seed=3)
    model = (Baseline if name == "baseline" else PANet)(backbone="vgg16")
    model.reset_parameters(torch.Generator().manual_seed(4))
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    K.reset_launches()
    try:
        with torch.no_grad():
            cpu = model.eval()(sup.cpu(), mask.cpu(), qry.cpu())
            card = model.to(cuda)(sup, mask, qry)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    assert not any(K.launches.values())
    cpu = cpu if name == "panet" else (cpu,)
    card = card if name == "panet" else (card,)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=2e-4)


def test_kernels_replay_in_a_cuda_graph_as_eager(cuda):
    fts, fg, bg, ctr = _inputs(cuda, 2, 2, 1, 1030, 64, torch.bfloat16)
    fts = fts.requires_grad_()
    w = torch.randn(2, 1, 1030, 2, device=cuda)

    def step():
        fts.grad = None
        logits = K.mpm_chain_packed(fts, fg, bg, ctr, P, SCALE)
        (logits * w).sum().backward()
        return logits.detach(), fts.grad, edt.edt2(logits[..., 1] > 0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = [t.clone() for t in step()]      # makes plans and tickets
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    K.reset_launches()
    M.reset_launches()
    with torch.cuda.graph(graph, stream=side):
        out = step()
    recorded = {**K.launches, **M.launches}
    assert recorded == {"assign": 1, "match": 1, "mpm_bwd": 1, "minplus": 2}
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, exp in zip(out, want):
            assert torch.equal(got, exp)
    # a replay counts no launch (parallel/step.py::FusedTrainStep counts
    # what its replays launched)
    assert {**K.launches, **M.launches} == recorded


def test_fused_capture_survives_the_prefetcher_thread(cuda):
    """``FusedTrainStep`` captures while the ``DevicePrefetcher``'s thread
    keeps copying the next batches (new device memory on its side
    stream), as in a loader-fed epoch, where the default global capture
    mode failed (ROADMAP.md §3, F8): the capture holds and the replays
    train."""
    import time

    import numpy as np

    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.parallel.step import DevicePrefetcher, FusedTrainStep

    k, chunks = 8, 4
    w = torch.nn.Parameter(torch.randn(256, 256, device=cuda) * 0.05)
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9, fused=True)

    def step(t, lr):
        opt.zero_grad(set_to_none=True)
        h = t["x"]
        for _ in range(4):
            h = torch.tanh(h @ w)
        loss = h.square().mean()
        loss.backward()
        solver.step(opt, lr)
        return loss.detach(), None

    def loader():       # slower than the steps: the thread never idles
        rng = np.random.RandomState(0)
        for _ in range(8 * k * chunks):
            time.sleep(0.001)
            yield {"x": rng.randn(512, 256).astype(np.float32)}

    fused = FusedTrainStep(step, k, cuda, opt, compact_wire=False,
                           keys=("x",), warmup_steps=k)
    feed = iter(DevicePrefetcher(loader(), cuda, depth=8 * k * chunks,
                                 compact_wire=False, keys=("x",)))
    try:
        losses = [fused([next(feed) for _ in range(k)], [0.01] * k)[0]
                  for _ in range(chunks)]   # warm-up, capture, replays
        torch.cuda.synchronize()
    finally:
        feed.close()
    assert fused.captures == 1 and fused.replays == chunks - 1
    assert torch.isfinite(torch.cat(losses)).all()


def test_capture_raises_where_a_kernel_plan_is_missing(cuda):
    fts, fg, bg, ctr = _inputs(cuda, 1, 1, 1, 49, 24, torch.float32)
    K._plans.clear()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        with torch.cuda.graph(graph):
            K.mpm_chain_packed(fts, fg, bg, ctr, P, SCALE)


# --- the operator tools (pemp_tpu_torch/tools/) on the card -------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 6, 12, 18])
def test_s2b_conv_matches_the_dilated_conv_on_the_card(cuda, dtype, d):
    """``S2BConv2d`` against cuDNN's dilated convolution (TF32 off):
    outputs and both gradients within 1e-4 of the largest magnitude at
    float32, two bf16 ulps (2^-7) at bfloat16."""
    from pemp_tpu_torch.tools.exp_train_levers import S2BConv2d
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator(device=cuda).manual_seed(d)
        conv = torch.nn.Conv2d(64, 48, 3, padding=d, dilation=d).to(
            cuda, dtype, memory_format=torch.channels_last)
        x = torch.randn(2, 64, 51, 47, generator=g, device=cuda,
                        dtype=dtype).to(memory_format=torch.channels_last)
        r = torch.randn(2, 48, 51, 47, generator=g, device=cuda, dtype=dtype)
        outs = []
        for mod in (conv, S2BConv2d(conv)):
            conv.weight.grad = conv.bias.grad = None
            xi = x.clone().requires_grad_()
            y = mod(xi)
            y.backward(r)
            outs.append([t.float() for t in (y, xi.grad, conv.weight.grad,
                                              conv.bias.grad)])
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for want, got in zip(*outs):
        assert (got - want).abs().max() <= tol * want.abs().max()


def test_memory_report_s1_train_row_runs(cuda):
    from pemp_tpu_torch.tools import memory_report
    row = memory_report.report_row("s1_train", cuda)
    p1, p2 = row["peak_bytes"]
    assert p2 > p1 > row["params_bytes"] and row["optimizer_bytes"] > 0
    assert row["budget_bytes"] == torch.cuda.get_device_properties(
        cuda).total_memory
    assert row["projected_max_batch"] > 4


def test_profile_train_counts_the_kernels_in_the_profile(cuda):
    from pemp_tpu_torch.tools import profile_train
    out = profile_train.main(["--bs", "2", "--hw", "97", "--steps", "2",
                              "--loss", "cedt"])
    want = {"assign": 2, "match": 2, "mpm_bwd": 2,
            "minplus": 4}
    assert out["timeline"] == "cuda" and out["kernels"] is True
    assert out["profiled_launches"] == want and out["launches"] == want
    assert 0 < out["device_ms_per_step"] < out["wall_ms_per_step"]
    assert out["groups_ms_per_step"]["custom-call/kernels"] > 0
