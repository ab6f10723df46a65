"""RPMMs against the JAX package on the same numpy inputs:

- ``pmm_mu_init``'s draw normalised as the JAX one normalises it, and
  ``pmm_em`` (10 iterations, kappa 20) and ``pmm_prob_map`` ([bg, fg]) at
  float64 within 1e-10 of the largest magnitude, at one, three and six
  prototypes;
- the RPMMs forward in eval mode at float64 with the same ``mu_init`` on
  both sides (ResNet-50 cut to one block a stage, 33x33, 2 episodes):
  each of the three outputs within 1e-6 of its largest logit;
- one train step at float64 (drop rate 0, the three-term CE without
  ignore on the outputs upsampled to the label size, SGD, the trunk BNs
  frozen): the loss, every trainable gradient, every BN running stat
  (support and query run the trunk in separate calls, support first) and
  every parameter after the step within 1e-7 of each leaf's largest
  magnitude; ``layer5``'s conv bias, whose gradient is zero in exact
  arithmetic (a train-mode BN follows it), within 1e-7 of its weight's
  largest gradient of zero on both sides;
- the full-depth forward at float32 (default widths, 33x33): rel 1e-4.

The JAX package draws ``mu0`` from its ``pmm`` rng, whose bits torch
cannot reproduce, so the parity tests pass ``mu_init`` to both sides.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pemp_tpu.models.common as jax_common
from pemp_tpu.core import losses as jax_losses
from pemp_tpu.models import rpmms as jax_rpmms
from pemp_tpu.models.common import output_resize as jax_output_resize
from pemp_tpu_torch.entry import rpmms as rpmms_entry
from pemp_tpu_torch.models import rpmms
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import (  # noqa: F401 (fixture)
    assert_port_step_matches, draw_variables, episode, jax_sgd_step,
    one_torch_thread, tree64,
)

H = W = 33
H8 = 5
C = 256
KS = (1, 3, 6)
EM_REL, FWD_REL, REL, F32_REL = 1e-10, 1e-6, 1e-7, 1e-4
SMALL = (1, 1, 1)
TR_CFG = SimpleNamespace(opt="sgd", lr=0.0035, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=0.0)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def small(monkeypatch, x64):
    """The JAX RPMMs' ResNet-50 cut to one block a stage (the port's
    ``layers``), float64 on."""
    monkeypatch.setitem(jax_common.RESNET_LAYERS, "resnet50", SMALL)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _mu_init(seed, c=C):
    """One [1, c, k] init per scale, normalised as ``pmm_mu_init``."""
    rng = np.random.RandomState(seed)
    mus = [rng.randn(1, c, k) * np.sqrt(2.0 / k) for k in KS]
    return [m / (1e-6 + np.linalg.norm(m, axis=1, keepdims=True))
            for m in mus]


@pytest.mark.parametrize("k", KS)
def test_pmm_em_and_prob_map_match_jax(x64, k):
    rng = np.random.RandomState(k)
    b, n, c = 2, 40, 24
    fts = np.abs(rng.randn(b, n, c))
    mask = (rng.rand(b, n, 1) > 0.4).astype(np.float64)
    qry = np.abs(rng.randn(b, 4, 5, c))
    mu0 = torch.randn((1, c, k), generator=torch.Generator().manual_seed(k))
    want0 = mu0.numpy() * np.sqrt(2.0 / k)
    want0 = want0 / (1e-6 + np.linalg.norm(want0, axis=1, keepdims=True))
    mu0 = rpmms.pmm_mu_init(torch.Generator().manual_seed(k), c, k)
    _close(mu0.numpy(), want0, 1e-6)
    mu0 = want0.astype(np.float64)
    with jax.default_matmul_precision("highest"):
        ref_f = jax_rpmms.pmm_em(None, jnp.asarray(fts * mask), k,
                                 mu0=jnp.asarray(mu0))
        ref_b = jax_rpmms.pmm_em(None, jnp.asarray(fts * (1 - mask)), k,
                                 mu0=jnp.asarray(mu0))
        ref_p = jax_rpmms.pmm_prob_map(jnp.asarray(qry), ref_f, ref_b)
    t = torch.from_numpy
    mu_f = rpmms.pmm_em(t(fts * mask), t(mu0))
    mu_b = rpmms.pmm_em(t(fts * (1 - mask)), t(mu0))
    prob = rpmms.pmm_prob_map(t(qry), mu_f, mu_b)
    assert mu_f.shape == (b, k, c) and prob.shape == (b, 4, 5, 2)
    _close(mu_f, ref_f, EM_REL)
    _close(mu_b, ref_b, EM_REL)
    _close(prob, ref_p, EM_REL)
    np.testing.assert_allclose(prob.sum(-1).numpy(), 1.0, rtol=1e-12)


def _carried(seed):
    model = jax_rpmms.RPMMs(drop_rate=0.0, dtype=jnp.float64)
    zeros = (jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H, W, 2)),
             jnp.zeros((1, 1, H, W, 3)))
    params, stats = draw_variables(
        model, zeros, seed, mu_init=[jnp.zeros((1, C, k)) for k in KS])
    port = rpmms.RPMMs(drop_rate=0.0, layers=SMALL)
    port.load_state_dict(state_dict_from_jax(params, stats))
    return model, params, stats, port.double()


def test_rpmms_forward_matches_jax(small):
    model, params, stats, port = _carried(3)
    args = episode(4, 2, 1, 1, H, W)
    mus = _mu_init(5)
    variables = {"params": tree64(params), "batch_stats": tree64(stats)}
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, mu, *a: model.apply(v, *a, mu_init=mu))(
            variables, [jnp.asarray(m) for m in mus], *map(jnp.asarray, args))
    with torch.no_grad():
        ours = port.eval()(*map(torch.from_numpy, args),
                           mu_init=[torch.from_numpy(m) for m in mus])
    assert len(ours) == 3
    for o, r in zip(ours, ref):
        assert o.shape == (2, 1, H8, H8, 2)
        _close(o.numpy(), r, FWD_REL)


def test_rpmms_train_step_matches_jax(small):
    model, params, stats, port = _carried(6)
    args = episode(7, 2, 1, 1, H, W)
    mus = _mu_init(8)
    labels = np.random.RandomState(9).randint(0, 2, (2, 1, H, W))
    labels = labels.astype(np.int32)
    jargs = [jnp.asarray(a) for a in args]
    jmus = [jnp.asarray(m) for m in mus]

    def loss_fn(p):
        outs, mutated = model.apply(
            {"params": p, "batch_stats": tree64(stats)}, *jargs, train=True,
            mu_init=jmus, mutable=["batch_stats"])
        ups = [jax_output_resize(o, (H, W)) for o in outs]
        total, _, _ = jax_losses.rpmms_loss(ups, labels.reshape(-1, H, W))
        return total, mutated["batch_stats"]

    want = jax_sgd_step(loss_fn, tree64(params),
                        jax_rpmms.RPMMs.FROZEN["resnet50"], TR_CFG)
    cfg = rpmms_entry.ex.assemble("train", {"split": "0"})
    runtime = rpmms_entry.RPMMsRuntime(cfg)
    batch = dict(zip(("sup_rgb", "sup_mask", "qry_rgb"),
                     map(torch.from_numpy, args)),
                 qry_msk=torch.from_numpy(labels))
    port.train()
    outs = port(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                mu_init=[torch.from_numpy(m) for m in mus])
    # layer5's conv bias sits ahead of a train-mode BN
    frozen = assert_port_step_matches(
        port, runtime.compute_loss(outs, batch, {}), want, TR_CFG, REL,
        zero_grads=("layer5.0.bias",))
    # the trunk's BN affines only; layer5's BN trains
    assert "model_res.layer2.0.downsample.1.weight" in frozen
    assert "layer5.1.weight" not in frozen
    assert all(k.startswith("model_res.") and ".conv" not in k
               and "downsample.0" not in k for k in frozen)


def test_rpmms_full_depth_forward_matches_jax_in_float32():
    model = jax_rpmms.RPMMs(drop_rate=0.0)
    args = [a.astype(np.float32) for a in episode(10, 1, 1, 1, H, W)]
    mus = [m.astype(np.float32) for m in _mu_init(11)]
    params, stats = draw_variables(
        model, [jnp.zeros_like(jnp.asarray(a)) for a in args], 12,
        mu_init=[jnp.asarray(m) for m in mus])
    port = rpmms.RPMMs(drop_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, mu, *a: model.apply(v, *a, mu_init=mu))(
            {"params": params, "batch_stats": stats},
            [jnp.asarray(m) for m in mus], *map(jnp.asarray, args))
    with torch.no_grad():
        ours = port.eval()(*map(torch.from_numpy, args),
                           mu_init=[torch.from_numpy(m) for m in mus])
    for o, r in zip(ours, ref):
        _close(o.numpy(), r, F32_REL)
