"""Whole-model parity: JAX ``PEMPStage1(backbone="resnet50",
use_pallas=False)`` against the port's ``PEMPStage1`` at 33x33, with the
weights carried across by ``state_dict_from_jax`` and every BN's running
statistics and affine parameters randomised from numpy. Also the dilated
ResNet alone at ``layers=(1, 1, 1)``.

Tolerance: rtol 1e-3, atol 2e-4 on the logits, as
tests/test_forward_parity.py uses for a float32 model (convolutions sum in
another order in XLA and oneDNN); response maps equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.models import backbones as jax_backbones
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu_torch.models.backbones import ResNet
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.utils.convert import state_dict_from_jax

H = W = 33
RTOL, ATOL = 1e-3, 2e-4


def _randomise_bn(params, stats, rng):
    """BN scale/bias/mean/var drawn from numpy (init leaves them 1/0)."""
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


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def carried():
    """JAX variables (init once per module) and the port loaded with them."""
    model = JaxPEMPStage1(backbone="resnet50", use_pallas=False)
    x = jnp.zeros((1, 1, H, W, 3))
    m = jnp.zeros((1, 1, H, W, 2))
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(lambda k: model.init({"params": k}, x, m, x))(
            jax.random.PRNGKey(0))
    params = _unfreeze(variables["params"])
    stats = _unfreeze(variables["batch_stats"])
    _randomise_bn(params, stats, np.random.RandomState(0))
    port = PEMPStage1(backbone="resnet50")
    port.load_state_dict(state_dict_from_jax(params, stats))
    return model, {"params": params, "batch_stats": stats}, port.eval()


def _episode(seed, b=2, s=1, q=1):
    rng = np.random.RandomState(seed)
    sup = rng.randn(b, s, H, W, 3).astype(np.float32)
    fg = (rng.rand(b, s, H, W, 1) > 0.5).astype(np.float32)
    qry = rng.randn(b, q, H, W, 3).astype(np.float32)
    return sup, np.concatenate([fg, 1 - fg], -1), qry


@pytest.mark.parametrize("shot", [1, 2])
def test_pemp_stage1_forward_matches_jax(carried, shot):
    model, variables, port = carried
    sup, mask, qry = _episode(shot, s=shot)
    with jax.default_matmul_precision("highest"):
        ref, ref_resp = jax.jit(lambda v, a, b_, c: model.apply(
            v, a, b_, c, ret_ind=True, train=False))(
            variables, jnp.asarray(sup), jnp.asarray(mask), jnp.asarray(qry))
    with torch.no_grad():
        ours, resp = port(torch.from_numpy(sup), torch.from_numpy(mask),
                          torch.from_numpy(qry), ret_ind=True)
        no_ind = port(torch.from_numpy(sup), torch.from_numpy(mask),
                      torch.from_numpy(qry))
    assert ours.shape == (2, 1, H, W, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(ref_resp))
    torch.testing.assert_close(no_ind, ours, rtol=0, atol=0)


def test_masked_average_branch_matches_jax(carried):
    """protos=0: plain masked-average prototypes, no centers."""
    _, variables, _ = carried
    model = JaxPEMPStage1(backbone="resnet50", protos=0, use_pallas=False)
    params = {k: v for k, v in variables["params"].items() if k != "ctr"}
    v0 = {"params": params, "batch_stats": variables["batch_stats"]}
    port = PEMPStage1(backbone="resnet50", protos=0)
    port.load_state_dict(state_dict_from_jax(params, v0["batch_stats"]))
    sup, mask, qry = _episode(3)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, a, b_, c: model.apply(v, a, b_, c))(
            v0, jnp.asarray(sup), jnp.asarray(mask), jnp.asarray(qry))
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(sup), torch.from_numpy(mask),
                           torch.from_numpy(qry))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_resnet_111_matches_jax():
    net = jax_backbones.ResNet((1, 1, 1))
    x = np.random.RandomState(4).randn(2, H, W, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(lambda k, a: net.init(k, a, False))(
            jax.random.PRNGKey(1), jnp.asarray(x))
        params = _unfreeze(variables["params"])
        stats = _unfreeze(variables["batch_stats"])
        _randomise_bn(params, stats, np.random.RandomState(5))
        ref = jax.jit(lambda v, a: net.apply(v, a, False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    sd = state_dict_from_jax({"backbone": params}, {"backbone": stats})
    port = ResNet((1, 1, 1))
    port.load_state_dict({k[len("encoder.backbone."):]: v
                          for k, v in sd.items()})
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)
