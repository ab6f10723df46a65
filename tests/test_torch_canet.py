"""CaNet and its history store against the JAX package on the same numpy
inputs:

- SYNTH episodes with and without ``ret_name`` equal the JAX package's,
  and so do their batches (the names stay lists of ``str``);
- ``HistoryStore`` over a scripted sequence of ``put``, ``get``,
  ``next_epoch`` and ``clear``, and ``CaNetDataAdapter`` over three
  train epochs and two eval rounds sharing one store, with the train
  reset draws: identical arrays and reset pattern (exact);
- the CaNet forward in eval mode at float64, with and without history
  (ResNet-50 cut to one block a stage on both sides, 33x33, 2 episodes):
  rel 1e-6 of the largest logit;
- one train step at float64 (drop rate 0, ce on the logits upsampled to
  the label size, SGD, the whole trunk frozen): the loss, every
  trainable gradient, every BN running stat and every parameter after
  the step within 1e-7 of each leaf's largest magnitude;
- the full-depth forward at float32 (default widths, 33x33): rel 1e-4.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pemp_tpu.models.common as jax_common
from pemp_tpu.config.base import Config as JaxConfig
from pemp_tpu.config.base import apply_overrides as jax_overrides
from pemp_tpu.core import losses as jax_losses
from pemp_tpu.data import history as jax_history
from pemp_tpu.data.loader import _collate as jax_collate
from pemp_tpu.data.synthetic import SyntheticDataset as JaxSynth
from pemp_tpu.models.canet import CaNet as JaxCaNet
from pemp_tpu.models.common import output_resize as jax_output_resize
from pemp_tpu_torch.data import history
from pemp_tpu_torch.data.loader import _collate
from pemp_tpu_torch.data.synthetic import SyntheticDataset
from pemp_tpu_torch.entry import canet as canet_entry
from pemp_tpu_torch.models.canet import CaNet
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import (  # noqa: F401 (fixture)
    assert_port_step_matches, draw_variables, episode, jax_sgd_step,
    one_torch_thread, tree64,
)

H = W = 33
H8 = 5
FWD_REL, REL, F32_REL = 1e-6, 1e-7, 1e-4
SMALL = (1, 1, 1)
TR_CFG = SimpleNamespace(opt="sgd", lr=0.0025, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=0.0)
OVERRIDES = {"data.dataset": "SYNTH", "data.height": "33",
             "data.width": "33", "data.train_n": "6", "data.test_n": "4",
             "split": "1"}


@pytest.fixture
def small(monkeypatch):
    """The JAX CaNet's ResNet-50 cut to one block a stage (the port's
    ``layers``), float64 on."""
    monkeypatch.setitem(jax_common.RESNET_LAYERS, "resnet50", SMALL)
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _datasets(train, ret_name):
    cfg = canet_entry.ex.assemble("train", OVERRIDES)
    jcfg = JaxConfig()
    jax_overrides(jcfg, OVERRIDES)
    return (SyntheticDataset(cfg, train, 1, 1, 2, ret_name=ret_name),
            JaxSynth(jcfg, train, 1, 1, 2, ret_name=ret_name))


@pytest.mark.parametrize("ret_name", [False, True])
def test_ret_name_episodes_equal_the_jax_package(ret_name):
    ours, ref = _datasets(True, ret_name)
    for ds in (ours, ref):
        ds.sample_tasks()
    eps = [(ours.get_episode(i), ref.get_episode(i))
           for i in range(len(ours))]
    for a, b in eps:
        assert set(a) == set(b)
        assert ("qry_names" in a) == ret_name
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    batch = _collate([a for a, _ in eps[:3]])
    want = jax_collate([b for _, b in eps[:3]])
    assert set(batch) == set(want)
    for key in batch:
        if key.endswith("_names"):
            assert batch[key] == want[key]
            assert all(isinstance(n, str) for ns in batch[key] for n in ns)
        else:
            np.testing.assert_array_equal(batch[key], want[key])


def test_history_store_matches_jax():
    ours = history.HistoryStore(H8, 4, seed=7)
    ref = jax_history.HistoryStore(H8, 4, seed=7)
    rng = np.random.RandomState(0)
    keys = [(c, f"synth_{c:02d}_{i:03d}") for c in (3, 9) for i in range(20)]
    resets = []
    for epoch in range(1, 5):
        for store in (ours, ref):
            store.next_epoch()
        for idx, key in enumerate(keys):
            for train in (True, False):
                a = ours.get(*key, train, idx, epoch)
                b = ref.get(*key, train, idx, epoch)
                np.testing.assert_array_equal(a, b)
                assert a.shape == (H8, 4, 2) and a.dtype == np.float32
                if train:
                    resets.append(not a.any())
            value = rng.rand(H8, 4, 2)
            ours.put(*key, value)
            ref.put(*key, value)
        if epoch == 3:
            for store in (ours, ref):
                store.clear()
    assert len(ours) == len(keys) and ours.keys() == set(keys)
    # the draws: about 0.3 of the loads that had a history are reset
    assert 0.15 < np.mean(resets[len(keys):2 * len(keys)]) < 0.45


def test_adapter_matches_jax_over_epochs_and_eval_rounds():
    """Train epochs and eval rounds share one store; the adapter counts
    its own resamples, reads the epoch's snapshot, and the write-backs of
    an epoch show from the next one."""
    stores = (history.HistoryStore(H8, H8, seed=3),
              jax_history.HistoryStore(H8, H8, seed=3))
    adapters = []
    for train in (True, False):
        ours, ref = _datasets(train, False)
        adapters.append((history.CaNetDataAdapter(ours, stores[0], train),
                         jax_history.CaNetDataAdapter(ref, stores[1], train)))
    rng = np.random.RandomState(1)
    nonzero = 0
    for rnd in range(3):
        for a_ours, a_ref in adapters[:1] + adapters[1:] * (rnd < 2):
            a_ours.sample_tasks()
            a_ref.sample_tasks()
            assert a_ours.epoch == a_ref.epoch
            for i in range(len(a_ours)):
                ea, eb = a_ours.get_episode(i), a_ref.get_episode(i)
                assert ea["qry_names"] == eb["qry_names"]
                np.testing.assert_array_equal(ea["history"], eb["history"])
                assert ea["history"].shape == (2, H8, H8, 2)
                nonzero += int(ea["history"].any())
                for name in ea["qry_names"]:
                    value = rng.rand(H8, H8, 2)
                    stores[0].put(ea["cls"], name, value)
                    stores[1].put(eb["cls"], name, value)
    assert nonzero > 0
    assert adapters[0][0].epoch == 3 and adapters[1][0].epoch == 2


def _carried(seed, **kwargs):
    model = JaxCaNet(drop_rate=0.0, dtype=jnp.float64, **kwargs)
    zeros = (jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H, W, 2)),
             jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H8, H8, 2)))
    params, stats = draw_variables(model, zeros, seed)
    port = CaNet(drop_rate=0.0, layers=SMALL, **kwargs)
    port.load_state_dict(state_dict_from_jax(params, stats))
    return model, params, stats, port.double()


def _inputs(seed, b=2):
    sup, mask, qry = episode(seed, b, 1, 1, H, W)
    hist = np.random.RandomState(seed + 1).rand(b, 1, H8, H8, 2)
    return sup, mask, qry, hist / hist.sum(-1, keepdims=True)


@pytest.mark.parametrize("use_history", [True, False])
def test_canet_forward_matches_jax(small, use_history):
    model, params, stats, port = _carried(3, use_history=use_history)
    args = _inputs(4)
    variables = {"params": tree64(params), "batch_stats": tree64(stats)}
    fn = jax.jit(lambda v, *a: model.apply(v, *a, out_hw=None))
    ref = np.asarray(fn(variables, *map(jnp.asarray, args)))
    assert ref.shape == (2, 1, H8, H8, 2)
    with torch.no_grad():
        ours = port.eval()(*map(torch.from_numpy, args), out_hw=None)
        full = port(*map(torch.from_numpy, args))
    assert np.abs(ours.numpy() - ref).max() <= FWD_REL * np.abs(ref).max()
    assert full.shape == (2, 1, H, W, 2)
    # the history enters the logits only when the model takes it
    hist = torch.from_numpy(args[3])
    with torch.no_grad():
        other = port(*map(torch.from_numpy, args[:3]), 1 - hist, out_hw=None)
    assert torch.equal(other, ours) != use_history


def test_canet_train_step_matches_jax(small):
    model, params, stats, port = _carried(5)
    args = _inputs(6)
    labels = np.random.RandomState(7).randint(0, 2, (2, 1, H, W))
    labels[:, :, :5, :7] = 255
    labels = labels.astype(np.int32)
    jargs = [jnp.asarray(a) for a in args]

    def loss_fn(p):
        logits, mutated = model.apply(
            {"params": p, "batch_stats": tree64(stats)}, *jargs, out_hw=None,
            train=True, mutable=["batch_stats"])
        up = jax_output_resize(logits, (H, W)).reshape(-1, H, W, 2)
        return (jax_losses.cross_entropy(up, labels.reshape(-1, H, W)),
                mutated["batch_stats"])

    want = jax_sgd_step(loss_fn, tree64(params), JaxCaNet.FROZEN[True],
                        TR_CFG)
    cfg = canet_entry.ex.assemble("train", {"split": "0", "loss": "ce"})
    runtime = canet_entry.CaNetRuntime(cfg)
    batch = dict(zip(("sup_rgb", "sup_mask", "qry_rgb", "history"),
                     map(torch.from_numpy, args)),
                 qry_msk=torch.from_numpy(labels))
    port.train()
    logits, aux = runtime.apply_train(port, batch)
    assert logits.shape == (2, 1, H8, H8, 2)
    frozen = assert_port_step_matches(
        port, runtime.compute_loss(logits, batch, aux), want, TR_CFG, REL)
    # the whole trunk is frozen, nothing of the head
    assert frozen == {k for k, _ in port.encoder.named_parameters(
        prefix="encoder")}


def test_canet_full_depth_forward_matches_jax_in_float32():
    model = JaxCaNet(drop_rate=0.0)
    args = _inputs(8, b=1)
    args32 = [a.astype(np.float32) for a in args]
    params, stats = draw_variables(
        model, [jnp.zeros_like(jnp.asarray(a)) for a in args32], 9)
    port = CaNet(drop_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda v, *a: model.apply(v, *a))(
            {"params": params, "batch_stats": stats},
            *map(jnp.asarray, args32)))
    with torch.no_grad():
        ours = port.eval()(*map(torch.from_numpy, args32)).numpy()
    assert ours.shape == ref.shape == (1, 1, H, W, 2)
    assert np.abs(ours - ref).max() <= F32_REL * np.abs(ref).max()
