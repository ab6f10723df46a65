"""PFENet against the JAX package on the same numpy inputs:

- ``adaptive_avg_pool`` (``F.adaptive_avg_pool2d``) against the JAX
  package's integral-image emulation at 5->8, 60->30, 51->15 and 7->7,
  float64 within 1e-12;
- the training-free prior (``prior_mask``) and ``weighted_gap`` at
  float64 within 1e-12;
- the PFENet forward in eval mode at float64 (the v2 trunk cut to one
  block a stage on both sides, bins (6, 3, 2, 1), 33x33, 2 episodes): the
  logits and every auxiliary output within 1e-6 of its largest
  magnitude. 2-shot: the JAX module cannot build more than one shot (its
  loop over the shots names a second ``down_supp_conv`` and flax raises
  ``NameInUseError``), so the port's 2-shot forward is held against the
  JAX 1-shot forward on two copies of the same support, which the shot
  average must reproduce;
- one train step at float64 (drop rates 0, ce plus ``loss_coef`` times
  the auxiliary CE, SGD, the whole trunk frozen and gradient-free): the
  loss, every trainable gradient, every BN running stat (the trunk runs
  the query, the support, then layer4 on the masked support, in that
  order) and every parameter after the step within 1e-7 of each leaf's
  largest magnitude;
- the full-depth forward at float32 (default widths and bins, 33x33):
  rel 1e-4.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core import losses as jax_losses
from pemp_tpu.models import pfenet as jax_pfenet
from pemp_tpu_torch.entry import pfenet as pfenet_entry
from pemp_tpu_torch.models import pfenet
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import (  # noqa: F401 (fixture)
    assert_port_step_matches, draw_variables, episode, jax_sgd_step,
    one_torch_thread, tree64,
)

H = W = 33
EXACT, FWD_REL, REL, F32_REL = 1e-12, 1e-6, 1e-7, 1e-4
SCALES = (6, 3, 2, 1)
SMALL = (1, 1, 1, 1)
LOSS_COEF = 0.6
TR_CFG = SimpleNamespace(opt="sgd", lr=0.0025, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=0.0)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def small(monkeypatch, x64):
    """The JAX trunk cut to one block a stage (the port's ``layers``)."""
    monkeypatch.setattr(jax_pfenet, "_V2_STAGES", [
        (planes, 1, stride, dil) for planes, _, stride, dil
        in jax_pfenet._V2_STAGES])


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("size,out", [(5, 8), (60, 30), (51, 15), (7, 7)])
def test_adaptive_avg_pool_matches_jax(x64, size, out):
    x = np.random.RandomState(size).randn(2, size, size, 3)
    ref = jax_pfenet.adaptive_avg_pool(jnp.asarray(x), out)
    ours = pfenet.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    out)
    _close(ours.permute(0, 2, 3, 1), ref, EXACT)


def test_prior_and_weighted_gap_match_jax(x64):
    rng = np.random.RandomState(0)
    q4 = np.abs(rng.randn(2, 6, 6, 16))
    s4 = np.abs(rng.randn(2, 6, 6, 16))
    mask = (rng.rand(2, 6, 6, 1) > 0.5).astype(np.float64)
    mask[1] = 0.0                       # no support pixel: sim / eps
    with jax.default_matmul_precision("highest"):
        ref = jax_pfenet.PFENet()._prior(*map(jnp.asarray, (q4, s4, mask)))
    ours = pfenet.prior_mask(*map(torch.from_numpy, (q4, s4, mask)))
    assert ours.shape == (2, 6, 6, 1)
    _close(ours, ref, EXACT)
    assert float(ours.min()) >= 0.0 and float(ours[0].max()) > 0.99
    ref = jax_pfenet.weighted_gap(jnp.asarray(s4), jnp.asarray(mask))
    _close(pfenet.weighted_gap(torch.from_numpy(s4), torch.from_numpy(mask)),
           ref, EXACT)


def _carried(seed, shot=1, port_shot=None):
    model = jax_pfenet.PFENet(shot=shot, ppm_scales=SCALES,
                              drop_rates=(0.0, 0.0), dtype=jnp.float64)
    zeros = (jnp.zeros((1, shot, H, W, 3)), jnp.zeros((1, shot, H, W, 2)),
             jnp.zeros((1, 1, H, W, 3)))
    params, stats = draw_variables(model, zeros, seed)
    port = pfenet.PFENet(shot=port_shot or shot, ppm_scales=SCALES,
                         drop_rates=(0.0, 0.0), layers=SMALL)
    port.load_state_dict(state_dict_from_jax(params, stats))
    return model, params, stats, port.double()


@pytest.mark.parametrize("shot", [1, 2])
def test_pfenet_forward_matches_jax(small, shot):
    model, params, stats, port = _carried(3, port_shot=shot)
    sup, mask, qry = episode(4, 2, 1, 1, H, W)
    variables = {"params": tree64(params), "batch_stats": tree64(stats)}
    with jax.default_matmul_precision("highest"):
        ref, ref_aux = jax.jit(lambda v, *a: model.apply(v, *a))(
            variables, *map(jnp.asarray, (sup, mask, qry)))
    # the port's shots: copies of the one support the JAX module takes
    args = [torch.from_numpy(np.repeat(a, shot, axis=1)) for a in (sup, mask)]
    with torch.no_grad():
        out, aux = port.eval()(*args, torch.from_numpy(qry))
        feat, _ = port(*args, torch.from_numpy(qry), out_hw=None)
    assert out.shape == (2, 1, H, W, 2) and len(aux) == len(SCALES)
    _close(out, ref, FWD_REL)
    for a, r in zip(aux, ref_aux):
        _close(a, r, FWD_REL)
    assert feat.shape == (2, 1, 5, 5, 2)


def test_pfenet_train_step_matches_jax(small):
    model, params, stats, port = _carried(5)
    args = episode(6, 2, 1, 1, H, W)
    labels = np.random.RandomState(7).randint(0, 2, (2, 1, H, W))
    labels[:, :, :5, :7] = 255
    labels = labels.astype(np.int32)
    jargs = [jnp.asarray(a) for a in args]
    jlabels = jnp.asarray(labels.reshape(-1, H, W))

    def loss_fn(p):
        (out, aux), mutated = model.apply(
            {"params": p, "batch_stats": tree64(stats)}, *jargs,
            out_hw=(H, W), train=True, mutable=["batch_stats"])
        main = jax_losses.cross_entropy(out.reshape(-1, H, W, 2), jlabels)
        return (main + LOSS_COEF * jax_losses.pfenet_aux_loss(aux, jlabels),
                mutated["batch_stats"])

    want = jax_sgd_step(loss_fn, tree64(params),
                        jax_pfenet.PFENet.FROZEN["resnet50v2"], TR_CFG)
    cfg = pfenet_entry.ex.assemble("train", {
        "split": "0", "loss": "ce", "loss_coef": str(LOSS_COEF)})
    runtime = pfenet_entry.PFENetRuntime(cfg)
    batch = dict(zip(("sup_rgb", "sup_mask", "qry_rgb"),
                     map(torch.from_numpy, args)),
                 qry_msk=torch.from_numpy(labels))
    port.train()
    logits, aux = runtime.apply_train(port, batch)
    assert logits.shape == (2, 1, H, W, 2) and set(aux) == {"aux_loss"}
    frozen = assert_port_step_matches(
        port, runtime.compute_loss(logits, batch, aux), want, TR_CFG, REL)
    trunk = {k for k, _ in port.named_parameters()
             if k.startswith(("layer0.", "layer1.", "layer2.", "layer3.",
                              "layer4."))}
    assert frozen == trunk and trunk
    assert all(p.grad is None for part in port.trunk()
               for p in part.parameters())


def test_pfenet_full_depth_forward_matches_jax_in_float32():
    model = jax_pfenet.PFENet(drop_rates=(0.0, 0.0))
    args = [a.astype(np.float32) for a in episode(8, 1, 1, 1, H, W)]
    params, stats = draw_variables(
        model, [jnp.zeros_like(jnp.asarray(a)) for a in args], 9)
    port = pfenet.PFENet(drop_rates=(0.0, 0.0))
    port.load_state_dict(state_dict_from_jax(params, stats))
    with jax.default_matmul_precision("highest"):
        ref, ref_aux = jax.jit(lambda v, *a: model.apply(v, *a))(
            {"params": params, "batch_stats": stats}, *map(jnp.asarray, args))
    with torch.no_grad():
        out, aux = port.eval()(*map(torch.from_numpy, args))
    _close(out, ref, F32_REL)
    for a, r in zip(aux, ref_aux):
        _close(a, r, F32_REL)
