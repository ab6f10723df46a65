"""The port's min-plus product, EDT, boundary map and cedt loss on the CPU
(``pemp_tpu_torch/ops/kernels/minplus.py``, ``ops/edt.py``,
``core/losses.py``) against the JAX package on the same numpy inputs.

Tolerance: the min-plus product and the squared EDT are bit-equal (their
values are integers below 2^24 or the 1e12 sentinel, exact in float32) to
numpy, to ``minplus_matmul``/``edt2_pallas`` in interpret mode and to the
jnp EDT; the boundary map is equal; cedt within 1e-6 relative (float32
sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pemp_tpu.core import losses as jax_losses
from pemp_tpu.ops import edt as jax_edt
from pemp_tpu.ops.pallas.minplus import edt2_pallas, minplus_matmul
from pemp_tpu_torch.core import losses
from pemp_tpu_torch.ops import edt
from pemp_tpu_torch.ops.kernels import minplus as M


def _labels(seed, b=2, h=41, w=37):
    rng = np.random.RandomState(seed)
    target = np.zeros((b, h, w), np.int32)
    for i in range(b):
        y, x = rng.randint(4, h - 12), rng.randint(4, w - 12)
        target[i, y:y + rng.randint(3, 10), x:x + rng.randint(3, 10)] = 1
    target[:, :3, :5] = 255
    return target


@pytest.mark.parametrize("m,k,n", [(40, 37, 53), (128, 8, 128), (33, 401, 65)])
def test_plain_minplus_bit_equals_numpy_and_pallas(m, k, n):
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2 ** 20, (m, k)).astype(np.float32)
    b = rng.randint(0, 2 ** 20, (k, n)).astype(np.float32)
    want = (a[:, :, None] + b[None, :, :]).min(axis=1)
    got = M.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(minplus_matmul(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True)))


def test_plain_minplus_batches_and_chunks(monkeypatch):
    """A shared 2-D operand against a batch, in row chunks smaller than M,
    equals the product item by item."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randint(0, 999, (13, 7)).astype(np.float32))
    b = torch.from_numpy(rng.randint(0, 999, (3, 7, 11)).astype(np.float32))
    monkeypatch.setattr(M, "PLAIN_CHUNK", 7 * 11 * 4)       # 4 rows a chunk
    got = M.minplus(a, b)
    assert got.shape == (3, 13, 11)
    for i in range(3):
        want = (a.numpy()[:, :, None] + b[i].numpy()[None]).min(axis=1)
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_cpu_tensors_launch_nothing_and_the_launch_path_checks():
    M.reset_launches()
    a = torch.zeros(4, 5)
    M.minplus(a, torch.zeros(5, 6))
    assert M.launches == {"minplus": 0}
    with pytest.raises(ValueError, match="expected cuda"):
        M._minplus_launch(a, torch.zeros(5, 6))
    with pytest.raises(ValueError, match="inner sizes"):
        M.minplus(a, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="batch"):
        M.minplus(torch.zeros(2, 4, 5), torch.zeros(3, 5, 6))


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 64, 64), (3, 16, 16)])
def test_edt2_bit_equals_edt2_pallas(shape):
    rng = np.random.RandomState(2)
    feat = rng.rand(*shape) < 0.02
    feat[0, 5, 7] = True
    if shape[0] > 1:
        feat[-1] = False                  # a map with no feature pixel
    got = edt.edt2(torch.from_numpy(feat)).numpy()
    want = np.asarray(edt2_pallas(jnp.asarray(feat), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_edt_equals_the_jnp_edt_where_a_feature_exists():
    rng = np.random.RandomState(3)
    feat = rng.rand(3, 29, 45) < 0.03
    feat[:, 4, 5] = True
    got = edt.euclidean_distance_transform(torch.from_numpy(feat))
    want = np.asarray(jax_edt.euclidean_distance_transform(
        jnp.asarray(feat), use_pallas=False))
    np.testing.assert_array_equal(got.numpy() ** 2, want ** 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_boundary_map_equals_jax():
    target = _labels(4)
    got = edt.boundary_map(torch.from_numpy(target)).numpy()
    want = np.asarray(jax_edt.boundary_map(jnp.asarray(target)))
    assert got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [5, 6])
def test_cedt_matches_jax(seed):
    rng = np.random.RandomState(seed)
    target = _labels(seed)
    target[1] = 0                          # no boundary: weight exactly 1
    logits = rng.randn(*target.shape, 2).astype(np.float32)
    got = losses.cedt(torch.from_numpy(logits), torch.from_numpy(target), 5.0)
    want = jax_losses.cedt(jnp.asarray(logits), jnp.asarray(target), 5.0,
                           use_pallas=False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    w = edt.edt_boundary_weight(torch.from_numpy(target), 5.0)
    np.testing.assert_array_equal(w[1].numpy(), 1.0)


def test_loss_factory():
    class Cfg:
        loss, sigma = "cedt", 3.0
    t = torch.from_numpy(_labels(7))
    lg = torch.randn(*t.shape, 2)
    assert torch.equal(losses.get(Cfg)(lg, t), losses.cedt(lg, t, 3.0))
    Cfg.loss = "ce"
    assert losses.get(Cfg) is losses.cross_entropy
    Cfg.loss = "bogus"
    with pytest.raises(ValueError):
        losses.get(Cfg)
