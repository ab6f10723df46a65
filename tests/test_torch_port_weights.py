"""state_dict_from_jax: every conv, BN and linear leaf of a JAX PEMP
stage-1 or stage-2 model lands in the right tensor of the port, and the
port's keys are the reference checkpoint layout that
tools/export_reference_ckpt.py writes. Exact equality: the conversion only
transposes and copies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu.models.pemp_stage2 import PEMPStage2 as JaxPEMPStage2
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tools.export_reference_ckpt import export_trained


def _random_trees(backbone, seed=0, stage=1):
    """JAX param / batch_stats trees of the model, filled from numpy
    (shapes from eval_shape: no init compute)."""
    x = jnp.zeros((1, 1, 33, 33, 3))
    m = jnp.zeros((1, 1, 33, 33, 2))
    if stage == 1:
        model, args = JaxPEMPStage1(backbone=backbone), (x, m, x)
    else:
        model = JaxPEMPStage2(backbone=backbone, spq=2)
        args = (x, m, x, jnp.zeros((1, 1, 33, 33)))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.RandomState(seed)
    fill = lambda s: rng.randn(*s.shape).astype(np.float32)  # noqa: E731
    return (jax.tree_util.tree_map(fill, shapes["params"]),
            jax.tree_util.tree_map(fill, shapes["batch_stats"]))


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_state_dict_from_jax_round_trip(backbone):
    params, stats = _random_trees(backbone)
    sd = state_dict_from_jax(params, stats)
    port = PEMPStage1(backbone=backbone)
    port.load_state_dict(sd, strict=True)        # no key missing or extra
    got = port.state_dict()

    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves((params, stats)))
    n_port = sum(v.numel() for k, v in got.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port

    bb = params["backbone"]
    np.testing.assert_array_equal(
        got["encoder.backbone.conv1.weight"].numpy(),
        bb["conv1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        port.encoder.backbone.layer2[0].downsample[0].weight.detach().numpy(),
        bb["layer2_0"]["downsample_conv"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    bn = port.encoder.backbone.layer3[5].bn2
    np.testing.assert_array_equal(
        bn.weight.detach().numpy(), bb["layer3_5"]["bn2"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        stats["backbone"]["layer3_5"]["bn2"]["BatchNorm_0"]["var"])
    aspp = port.encoder.purifier[6]
    pa = params["purifier"]["aspp"]
    np.testing.assert_array_equal(aspp.aspp_3[2].bias.detach().numpy(),
                                  pa["aspp_3_conv"]["Conv_0"]["bias"])
    np.testing.assert_array_equal(
        aspp.aspp_0[0].running_mean.numpy(),
        stats["purifier"]["aspp"]["aspp_0_bn"]["BatchNorm_0"]["mean"])
    np.testing.assert_array_equal(port.ctr.detach().numpy(), params["ctr"])

    # the same tensors under the same keys as the reference .pth export
    ref = export_trained("pemp_stage1", backbone, params, stats)
    ours = {k: v for k, v in got.items()
            if not k.endswith("num_batches_tracked")}
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_stage2_state_dict_from_jax_matches_the_reference_export():
    """ResNetCM + PurifierV1: the 4-channel stem, +2 input channels on each
    stage's first block, the CM linears (kernel transposed) and the ASPP
    branch convs, under the keys and shapes of the reference .pth."""
    params, stats = _random_trees("resnet50", seed=1, stage=2)
    sd = state_dict_from_jax(params, stats)
    port = PEMPStage2(backbone="resnet50")
    port.load_state_dict(sd, strict=True)
    got = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref = export_trained("pemp_stage2", "resnet50", params, stats)
    assert set(ref) == set(got)
    for k, v in ref.items():
        assert tuple(got[k].shape) == np.shape(v), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    bb = "encoder.backbone"
    assert tuple(got[f"{bb}.conv1.weight"].shape) == (64, 4, 7, 7)
    for si, cin in ((1, 66), (2, 258), (3, 514)):
        for key in (f"layer{si}.0.conv1", f"layer{si}.0.downsample.0"):
            assert got[f"{bb}.{key}.weight"].shape[1] == cin, key
        assert got[f"{bb}.linear{si}.weight"].shape == (2, 2 * (cin - 2))
    np.testing.assert_array_equal(
        got[f"{bb}.linear2.weight"].numpy(),
        params["backbone"]["cm2"]["linear"]["kernel"].T)
    np.testing.assert_array_equal(
        got["encoder.purifier.6.aspp_3.0.weight"].numpy(),
        params["purifier"]["aspp"]["aspp_3"]["Conv_0"]["kernel"]
        .transpose(3, 2, 0, 1))


@pytest.mark.parametrize("path,layer", [
    (("purifier", "conv7"), "Conv_0"),
    (("head", "conv1"), "Conv_0"),
    (("backbone", "layer1"), "Conv_0"),
    (("backbone", "conv1"), "Dense_0"),
])
def test_state_dict_from_jax_rejects_unknown_paths(path, layer):
    tree = leaf = {}
    for name in path:
        leaf[name] = {}
        leaf = leaf[name]
    leaf[layer] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError):
        state_dict_from_jax(tree, {})
