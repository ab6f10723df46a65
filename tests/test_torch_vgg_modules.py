"""The VGG16 family's modules against the JAX package on the same numpy
inputs, at float64 (the weights, drawn from numpy, carried across with
``state_dict_from_jax``):

- ``VGG16`` and ``VGG16CM`` (spq 2) at 33x33 and at 32x32: at an even
  size VGG's (3, 2, 1) floor-mode pools differ from the ResNet stem's
  ceil-mode pool, and 33 and 32 give different feature sizes (5 and 4);
- ``masked_average_pooling_adjoint`` against the JAX one and against the
  port's own upsample-then-pool;
- ``cross_entropy_no_ignore``;
- the VGG init: the convs kaiming-normal (relu gain, fan_in), the CM
  linears torch's default.

Tolerance: rel 1e-6 of the largest magnitude (float64; the sums run in
another order in XLA and oneDNN).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core import losses as jax_losses
from pemp_tpu.models import backbones as jax_backbones
from pemp_tpu.ops import prototypes as jax_protos
from pemp_tpu_torch.core.losses import cross_entropy_no_ignore
from pemp_tpu_torch.models.backbones import VGG16, VGG16CM
from pemp_tpu_torch.models.layers import max_pool_torch
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2
from pemp_tpu_torch.ops.prototypes import (
    masked_average_pooling, masked_average_pooling_adjoint,
)
from pemp_tpu_torch.ops.resize import resize_bilinear_align_corners
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import draw_variables, tree64

REL = 1e-6


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def _backbone_sd(params, prefix="encoder.backbone."):
    sd = state_dict_from_jax({"backbone": params}, {})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size", [33, 32])
def test_vgg16_matches_jax(x64, size):
    net = jax_backbones.VGG16(last_relu=False, dtype=jnp.float64)
    x = np.random.RandomState(size).randn(2, size, size, 3)
    params, _ = draw_variables(net, (jnp.zeros((1, size, size, 3)), False),
                               seed=size)
    ref = jax.jit(lambda p, a: net.apply({"params": p}, a, False))(
        tree64(params), jnp.asarray(x))
    port = VGG16()
    port.load_state_dict(_backbone_sd(params))
    with torch.no_grad():
        ours = port.double()(_nchw(x))
    hw = 5 if size == 33 else 4
    assert ours.shape[1:] == (512, hw, hw)
    _close(ours.permute(0, 2, 3, 1).numpy(), ref)
    # the last conv has no ReLU: its output has negative values
    assert (ours < 0).any()


def test_vgg_pool_is_not_the_resnet_stem_pool():
    """At an even size the stem's ceil-mode pool gives one more row and
    column than VGG's floor-mode pool; at 33 and 401 they agree."""
    vgg = VGG16().features[4]
    for size, same in ((32, False), (33, True), (401, True)):
        x = torch.randn(1, 1, size, size)
        assert (vgg(x).shape == max_pool_torch()(x).shape) == same, size


@pytest.mark.parametrize("size", [33, 32])
def test_vgg16cm_matches_jax(x64, size):
    spq = 2
    net = jax_backbones.VGG16CM(spq=spq, last_relu=False, dtype=jnp.float64)
    rng = np.random.RandomState(size + 1)
    x = rng.randn(2 * spq, size, size, 3)
    prior = (rng.rand(2 * spq, size, size, 1) > 0.4).astype(np.float64)
    inp = np.concatenate([x, prior], -1)
    args = ((jnp.zeros((spq, size, size, 4)), jnp.zeros((spq, size, size, 1))),
            False)
    params, _ = draw_variables(net, args, seed=size + 1)
    ref = jax.jit(lambda p, a, m: net.apply({"params": p}, (a, m), False))(
        tree64(params), jnp.asarray(inp), jnp.asarray(prior))
    port = VGG16CM()
    port.load_state_dict(_backbone_sd(params))
    with torch.no_grad():
        ours = port.double()(_nchw(inp), _nchw(prior), spq)
    _close(ours.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 1, 5, 5, 8, 33, 33),
                                   (1, 3, 4, 6, 16, 32, 41)])
def test_masked_average_pooling_adjoint(x64, shape):
    b, s, h, w, c, big_h, big_w = shape
    rng = np.random.RandomState(sum(shape))
    fts = rng.randn(b, s, h, w, c)
    mask = (rng.rand(b, s, big_h, big_w) > 0.5).astype(np.float64)
    ours = masked_average_pooling_adjoint(torch.from_numpy(fts),
                                          torch.from_numpy(mask))
    ref = jax_protos.masked_average_pooling_adjoint(jnp.asarray(fts),
                                                    jnp.asarray(mask))
    _close(ours.numpy(), ref)
    # the same as pooling the features upsampled to the mask's size
    up = resize_bilinear_align_corners(
        torch.from_numpy(fts).reshape(b * s, h, w, c), (big_h, big_w))
    direct = masked_average_pooling(up.reshape(b, s, big_h * big_w, c),
                                    torch.from_numpy(mask).reshape(b, s, -1))
    _close(ours.numpy(), direct.numpy())


def test_cross_entropy_no_ignore(x64):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 3, 9, 7, 2) * 4
    labels = rng.randint(0, 2, (2, 3, 9, 7)).astype(np.float64)
    ours = cross_entropy_no_ignore(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    ref = jax_losses.cross_entropy_no_ignore(jnp.asarray(logits),
                                             jnp.asarray(labels))
    _close(ours.numpy(), ref)
    manual = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, 2),
        torch.from_numpy(labels).long().reshape(-1))
    _close(ours.numpy(), manual.numpy())


@pytest.mark.parametrize("stage", [1, 2])
def test_vgg_init_draws_kaiming_normal(stage):
    model = (PEMPStage1(backbone="vgg16") if stage == 1
             else PEMPStage2(backbone="vgg16"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    feats = model.encoder.backbone.features
    for idx in (5, 28):
        w = feats[idx].weight
        std = (2.0 / w[0].numel()) ** 0.5
        assert abs(w.std().item() / std - 1) < 0.02, idx
        bound = 1.0 / w[0].numel() ** 0.5
        assert feats[idx].bias.abs().max() <= bound
    if stage == 2:                    # nn.Linear's kaiming-uniform a=sqrt(5)
        lin = model.encoder.backbone.linear4.weight
        assert lin.abs().max() <= 1.0 / lin.shape[1] ** 0.5
    again = type(model)(backbone="vgg16")
    again.reset_parameters(torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
