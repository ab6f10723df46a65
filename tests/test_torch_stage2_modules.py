"""The stage-2 modules of the port against the JAX package on the same
numpy inputs: ``CommModule`` (spq 2 and 6, mask strides 1 and 2),
``ResNetCM`` at ``layers=(1, 1, 1)`` in eval mode with the BN statistics
randomised, ``PurifierV1`` in eval mode, and ``Dropout2d``'s train-mode
semantics (whole channels zeroed, the rest scaled by 1 / (1 - rate)).

Tolerances: the CM's pooled linear rtol 1e-5 (float32, a few hundred
terms); the convolutional modules rtol 1e-3, atol 2e-4, as
tests/test_torch_model_parity.py (XLA and oneDNN sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.models import backbones as jax_backbones
from pemp_tpu.models import common as jax_common
from pemp_tpu.models import layers as jax_layers
from pemp_tpu_torch.models.backbones import CommModule, ResNetCM
from pemp_tpu_torch.models.common import PurifierV1
from pemp_tpu_torch.models.layers import Dropout2d
from pemp_tpu_torch.utils.convert import state_dict_from_jax

RTOL, ATOL = 1e-3, 2e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


def _randomise_bn(params, stats, rng):
    def walk(p, s):
        for name in p:
            if name == "BatchNorm_0":
                c = p[name]["scale"].shape[0]
                p[name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[name]["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                s[name]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
                s[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(p[name], dict) and name in s:
                walk(p[name], s[name])
    walk(params, stats)


def _sub_state(params, stats, scope, prefix):
    """``state_dict_from_jax`` of a submodule's trees placed under
    ``scope``, with the port's ``prefix`` stripped."""
    sd = state_dict_from_jax({scope: params}, {scope: stats} if stats else {})
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("spq", [2, 6])
@pytest.mark.parametrize("stride", [1, 2])
def test_comm_module_matches_jax(spq, stride):
    rng = np.random.RandomState(spq * 10 + stride)
    b, c, h = 2, 16, 9
    H = h if stride == 1 else 2 * h - 1       # 17 -> 9 as 201 -> 101
    x = rng.randn(b * spq, h, h, c).astype(np.float32)
    mask = (rng.rand(b * spq, H, H, 1) > 0.5).astype(np.float32)
    module = jax_backbones.CommModule(n=2, spq=spq, mask_stride=stride)
    variables = module.init({"params": jax.random.PRNGKey(spq)},
                            jnp.asarray(x), jnp.asarray(mask))
    want, want_mask = module.apply(variables, jnp.asarray(x),
                                   jnp.asarray(mask))
    kernel = np.asarray(variables["params"]["linear"]["kernel"])
    bias = np.asarray(variables["params"]["linear"]["bias"])

    port = CommModule(c, stride)
    port.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                          "bias": torch.from_numpy(bias.copy())})
    with torch.no_grad():
        got, got_mask = port(_nchw(x), _nchw(mask), spq)
    assert got.shape == (b * spq, 2, h, h)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(_nhwc(got_mask), np.asarray(want_mask))


def test_comm_module_init_is_nn_linear_default():
    """The JAX package draws the CM linear with torch_conv_default_init /
    torch_bias_init: nn.Linear's own init, the bound 1/sqrt(2c)."""
    port = CommModule(64, 2)
    assert tuple(port.weight.shape) == (2, 128)
    bound = 1.0 / np.sqrt(128)
    assert port.weight.abs().max() <= bound and port.bias.abs().max() <= bound


@pytest.fixture(scope="module")
def resnet_cm():
    rng = np.random.RandomState(3)
    spq, b, hw = 2, 2, 33
    x = rng.randn(b * spq, hw, hw, 4).astype(np.float32)
    prior = (rng.rand(b * spq, hw, hw, 1) > 0.5).astype(np.float32)
    x[..., 3:] = prior
    model = jax_backbones.ResNetCM((1, 1, 1), spq=spq)
    variables = jax.jit(lambda k: model.init({"params": k}, (x, prior),
                                             False))(jax.random.PRNGKey(1))
    params = _unfreeze(variables["params"])
    stats = _unfreeze(variables["batch_stats"])
    _randomise_bn(params, stats, rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v: model.apply(v, (x, prior), False))(
            {"params": params, "batch_stats": stats})
    return x, prior, params, stats, np.asarray(want)


def test_resnet_cm_111_matches_jax(resnet_cm):
    x, prior, params, stats, want = resnet_cm
    port = ResNetCM((1, 1, 1))
    port.load_state_dict(_sub_state(params, stats, "backbone",
                                    "encoder.backbone."), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x), _nchw(prior), 2)
    assert got.shape == (4, 1024, 5, 5)
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


def test_resnet_cm_keys_and_first_blocks():
    sd = ResNetCM((3, 4, 6)).state_dict()
    assert tuple(sd["conv1.weight"].shape) == (64, 4, 7, 7)
    for si, cin, blocks in ((1, 66, 3), (2, 258, 4), (3, 514, 6)):
        assert sd[f"layer{si}.0.conv1.weight"].shape[1] == cin
        assert sd[f"layer{si}.0.downsample.0.weight"].shape[1] == cin
        assert f"layer{si}.{blocks - 1}.conv3.weight" in sd
        assert f"layer{si}.{blocks}.conv1.weight" not in sd
        assert tuple(sd[f"linear{si}.weight"].shape) == (2, 2 * (cin - 2))


def test_purifier_v1_matches_jax():
    rng = np.random.RandomState(4)
    x = np.abs(rng.randn(2, 9, 9, 64)).astype(np.float32)
    module = jax_common.PurifierV1(out_channels=32, drop_rate=0.5)
    variables = module.init({"params": jax.random.PRNGKey(2)},
                            jnp.asarray(x), False)
    with jax.default_matmul_precision("highest"):
        want = module.apply(variables, jnp.asarray(x), False)
    params = _unfreeze(variables["params"])
    port = PurifierV1(64, 32, 0.5)
    port.load_state_dict(_sub_state(params, {}, "purifier",
                                    "encoder.purifier."), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _channel_dropout_ok(x, y, rate):
    """y [N, C, H, W]: every (image, channel) map is wholly zero or
    exactly x / (1 - rate); returns the share of maps kept."""
    kept = (y != 0).flatten(2)
    assert torch.equal(kept.all(-1), kept.any(-1))
    keep = kept.all(-1)[..., None, None]
    assert torch.equal(y, torch.where(keep, x / (1 - rate), 0.0))
    return keep.float().mean().item()


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout2d_zeroes_whole_channels_like_jax(rate):
    x = torch.from_numpy(np.random.RandomState(5).rand(8, 64, 5, 5)
                         .astype(np.float32) + 0.5)
    drop = Dropout2d(rate).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    assert abs(_channel_dropout_ok(x, y, rate) - (1 - rate)) < 0.1
    # the JAX package's Dropout2d has the same structure on NHWC
    jy = jax_layers.Dropout2d(rate).apply(
        {}, jnp.asarray(_nhwc(x)), True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    assert abs(_channel_dropout_ok(x, _nchw(np.array(jy)), rate)
               - (1 - rate)) < 0.1
    # the same generator state draws the same mask
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)


def test_dropout2d_is_the_identity_in_eval_and_at_rate_0():
    x = torch.randn(2, 4, 3, 3)
    assert Dropout2d(0.5).eval()(x) is x
    assert Dropout2d(0.0).train()(x) is x
    # rate 1 drops everything (no 0 / 0), as the JAX package's Dropout
    assert torch.equal(Dropout2d(1.0).train()(x), torch.zeros_like(x))
