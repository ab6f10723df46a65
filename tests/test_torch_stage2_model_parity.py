"""Whole-model parity of stage 2 and of the cascade: JAX
``PEMPStage2(backbone="resnet50", use_pallas=False)`` against the port's
``PEMPStage2`` at 33x33, B=2, 1-shot and 5-shot, the same prior fed to
both; and the cascade, whose prior (a carried-over stage 1's argmax in
eval mode) must equal JAX ``argmax(stage1.apply(...))`` and whose stage-2
logits must match JAX's stage 2 on the JAX prior. Weights go across with
``state_dict_from_jax``; every BN's affine and running statistics are
randomised from numpy.

Tolerance: rtol 1e-3, atol 2e-4 on the logits, as
tests/test_whole_model_parity.py holds the JAX package against the
reference; response maps equal on >= 99 % of pixels, the priors on
>= 99.9 %.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu.models.pemp_stage2 import PEMPStage2 as JaxPEMPStage2
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade, PEMPStage2
from pemp_tpu_torch.utils.convert import state_dict_from_jax

H = W = 33
RTOL, ATOL = 1e-3, 2e-4
RESP_AGREE, PRIOR_AGREE = 0.99, 0.999


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


def _init(model, args, seed):
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(lambda k: model.init({"params": k}, *args))(
            jax.random.PRNGKey(seed))
    params = _unfreeze(variables["params"])
    stats = _unfreeze(variables["batch_stats"])
    _randomise_bn(params, stats, np.random.RandomState(seed))
    return {"params": params, "batch_stats": stats}


def _episode(seed, b=2, s=1, q=1):
    rng = np.random.RandomState(seed)
    sup = rng.randn(b, s, H, W, 3).astype(np.float32)
    fg = (rng.rand(b, s, H, W, 1) > 0.5).astype(np.float32)
    qry = rng.randn(b, q, H, W, 3).astype(np.float32)
    prior = (rng.rand(b, q, H, W) > 0.5).astype(np.float32)
    return sup, np.concatenate([fg, 1 - fg], -1), qry, prior


@pytest.fixture(scope="module")
def stage2():
    """JAX stage-2 variables (init once per module) and the port loaded
    with them."""
    x = jnp.zeros((1, 1, H, W, 3))
    args = (x, jnp.zeros((1, 1, H, W, 2)), x, jnp.zeros((1, 1, H, W)))
    variables = _init(JaxPEMPStage2(backbone="resnet50", spq=2), args, 1)
    port = PEMPStage2(backbone="resnet50")
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return variables, port.eval()


@pytest.fixture(scope="module")
def stage1():
    x = jnp.zeros((1, 1, H, W, 3))
    variables = _init(JaxPEMPStage1(backbone="resnet50"),
                      (x, jnp.zeros((1, 1, H, W, 2)), x), 2)
    port = PEMPStage1(backbone="resnet50")
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return variables, port.eval()


def _jax_stage2(variables, sup, mask, qry, prior):
    model = JaxPEMPStage2(backbone="resnet50", spq=sup.shape[1] + qry.shape[1],
                          use_pallas=False)
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, *a: model.apply(v, *a, ret_ind=True))(
            variables, sup, mask, qry, prior)


@pytest.mark.parametrize("shot", [1, 5])
def test_pemp_stage2_forward_matches_jax(stage2, shot):
    variables, port = stage2
    sup, mask, qry, prior = _episode(shot, s=shot)
    ref, ref_resp = _jax_stage2(variables, sup, mask, qry, prior)
    with torch.no_grad():
        got, resp = port(*(torch.from_numpy(a) for a in (sup, mask, qry,
                                                          prior)),
                         ret_ind=True)
    assert got.shape == (2, 1, H, W, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    agree = (resp.numpy() == np.asarray(ref_resp)).mean()
    assert agree >= RESP_AGREE, agree


def test_cascade_prior_and_logits_match_jax(stage1, stage2):
    v1, s1 = stage1
    v2, s2 = stage2
    sup, mask, qry, _ = _episode(7)
    with jax.default_matmul_precision("highest"):
        logits1 = jax.jit(lambda v, *a: JaxPEMPStage1(
            backbone="resnet50", use_pallas=False).apply(v, *a))(
                v1, sup, mask, qry)
    ref_prior = np.asarray(jnp.argmax(logits1, -1).astype(jnp.float32))
    ref, _ = _jax_stage2(v2, sup, mask, qry, ref_prior)

    cascade = PEMPCascade(s1, s2).eval()
    t = [torch.from_numpy(a) for a in (sup, mask, qry)]
    with torch.no_grad():
        prior = cascade.prior(*t)
        got = cascade(*t)
    assert prior.dtype == torch.float32 and prior.shape == (2, 1, H, W)
    agree = (prior.numpy() == ref_prior).mean()
    assert agree >= PRIOR_AGREE, agree
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not any(p.requires_grad for p in cascade.stage1.parameters())
