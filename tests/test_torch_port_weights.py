"""state_dict_from_jax: every conv, BN and linear leaf of a JAX PEMP
stage-1, stage-2, Baseline, PANet, CaNet, RPMMs or PFENet model lands in
the right tensor of the port, and the port's keys are the reference
checkpoint layout that tools/export_reference_ckpt.py writes wherever it
has one. Exact equality:
the conversion only transposes and copies. Stage 2 with ``vgg16`` has no
reference layout; its trees round-trip into the port's ``PEMPStage2`` and
give the JAX forward (float64, rel 1e-6 of the largest logit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.models.baseline import Baseline as JaxBaseline
from pemp_tpu.models.canet import CaNet as JaxCaNet
from pemp_tpu.models.panet import PANet as JaxPANet
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu.models.pemp_stage2 import PEMPStage2 as JaxPEMPStage2
from pemp_tpu.models.pfenet import PFENet as JaxPFENet
from pemp_tpu.models.rpmms import RPMMs as JaxRPMMs
from pemp_tpu_torch.models.baseline import Baseline
from pemp_tpu_torch.models.canet import CaNet
from pemp_tpu_torch.models.panet import PANet
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2
from pemp_tpu_torch.models.pfenet import PFENet
from pemp_tpu_torch.models.rpmms import RPMMs
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import draw_variables, episode, tree64
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


JAX_MODELS = {"pemp_stage1": (JaxPEMPStage1, PEMPStage1),
              "baseline": (JaxBaseline, Baseline), "panet": (JaxPANet, PANet),
              "canet": (JaxCaNet, CaNet), "rpmms": (JaxRPMMs, RPMMs),
              "pfenet": (JaxPFENet, PFENet)}
# the families whose one layout takes no backbone argument, and the
# extra inputs of their init
ZOO = {"canet": lambda: ((jnp.zeros((1, 1, 5, 5, 2)),), {}),
       "rpmms": lambda: ((), {"mu_init": [jnp.zeros((1, 256, k))
                                          for k in (1, 3, 6)]}),
       "pfenet": lambda: ((), {})}
# (JAX block, its port key, JAX head conv path, its port key)
ZOO_LEAVES = {
    "canet": ("layer3_0", "encoder.layer3.0.downsample.1",
              ("residual_1", "conv2"), "residual_1.3"),
    "rpmms": ("layer3_0", "model_res.layer3.0.downsample.1",
              ("layer6", "aspp_4"), "layer6.aspp_4.0"),
    "pfenet": ("layer4_0", "layer4.0.downsample.1",
               ("inner_cls_3", "cls"), "inner_cls.3.3")}


def _family_trees(name, backbone, seed):
    """JAX trees of a stage-1, Baseline, PANet, CaNet, RPMMs or PFENet
    model, filled from numpy."""
    x = jnp.zeros((1, 1, 33, 33, 3))
    m = jnp.zeros((1, 1, 33, 33, 2))
    if name in ZOO:
        model = JAX_MODELS[name][0]()
        extra, kwargs = ZOO[name]()
    else:
        model = JAX_MODELS[name][0](backbone=backbone)
        extra, kwargs = (), {}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, x, m, x, *extra, **kwargs))
    rng = np.random.RandomState(seed)
    fill = lambda s: rng.randn(*s.shape).astype(np.float32)  # noqa: E731
    return (jax.tree_util.tree_map(fill, shapes["params"]),
            jax.tree_util.tree_map(fill, shapes.get("batch_stats", {})))


@pytest.mark.parametrize("name,backbone", [
    ("pemp_stage1", "vgg16"), ("baseline", "vgg16"), ("baseline", "resnet50"),
    ("panet", "vgg16"), ("canet", "resnet50"), ("rpmms", "resnet50"),
    ("pfenet", "resnet50v2")])
def test_state_dict_from_jax_keys_equal_the_reference_export(name, backbone):
    params, stats = _family_trees(name, backbone, seed=2)
    sd = state_dict_from_jax(params, stats)
    port = (JAX_MODELS[name][1]() if name in ZOO
            else JAX_MODELS[name][1](backbone=backbone))
    port.load_state_dict(sd, strict=True)
    got = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref = export_trained(name, backbone, params, stats)
    assert set(ref) == set(got)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if name in ZOO:
        # a trunk BN and a head conv where each family keeps them
        stat, bn_key, conv, conv_key = ZOO_LEAVES[name]
        np.testing.assert_array_equal(
            got[f"{bn_key}.running_var"].numpy(),
            stats["backbone"][stat]["downsample_bn"]["BatchNorm_0"]["var"])
        node = params
        for part in conv:
            node = node[part]
        np.testing.assert_array_equal(
            got[f"{conv_key}.weight"].numpy(),
            node["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    elif backbone == "vgg16":
        np.testing.assert_array_equal(
            got["encoder.backbone.features.28.weight"].numpy(),
            params["backbone"]["conv12"]["Conv_0"]["kernel"]
            .transpose(3, 2, 0, 1))
    else:
        np.testing.assert_array_equal(
            got["encoder.projection.bias"].numpy(),
            params["projection"]["Conv_0"]["bias"])


def test_vgg16cm_trees_round_trip_and_give_the_jax_forward():
    """Stage 2 with ``vgg16``: ``backbone/conv{i}`` at
    ``encoder.backbone.features.{j}`` (4 input channels at ``conv0``, +2
    at the first conv of blocks 2-5), ``backbone/cm{k}/linear`` at
    ``encoder.backbone.linear{k}`` (k = 1..4, kernel transposed), and
    ``ctr``; the port then computes the JAX forward."""
    x = jnp.zeros((1, 1, 33, 33, 3))
    m = jnp.zeros((1, 1, 33, 33, 2))
    model = JaxPEMPStage2(backbone="vgg16", spq=2, dtype=jnp.float64)
    params, stats = draw_variables(model, (x, m, x, jnp.zeros((1, 1, 33, 33))),
                                   seed=3)
    assert stats == {}
    port = PEMPStage2(backbone="vgg16")
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    got = port.state_dict()
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(v.numel() for v in got.values())
    bb, jb = "encoder.backbone", params["backbone"]
    for i, j, cin in ((0, 0, 4), (2, 5, 66), (4, 10, 130), (7, 17, 258),
                      (10, 24, 514), (12, 28, 512)):
        w = got[f"{bb}.features.{j}.weight"]
        assert w.shape[1] == cin, (i, j)
        np.testing.assert_array_equal(
            w.numpy(), jb[f"conv{i}"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    for k, c in ((1, 64), (2, 128), (3, 256), (4, 512)):
        np.testing.assert_array_equal(
            got[f"{bb}.linear{k}.weight"].numpy(),
            jb[f"cm{k}"]["linear"]["kernel"].T)
        assert got[f"{bb}.linear{k}.weight"].shape == (2, 2 * c)
    np.testing.assert_array_equal(got["ctr"].numpy(), params["ctr"])

    # float64 forward on both sides (the float32 weights are exact there)
    sup, mask, qry = episode(4, 2, 1, 1, 33, 33)
    prior = (np.random.RandomState(5).rand(2, 1, 33, 33) > 0.5) * 1.0
    args = (sup, mask, qry, prior)
    jax.config.update("jax_enable_x64", True)
    try:
        ref = np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
            tree64(params), *map(jnp.asarray, args)))
    finally:
        jax.config.update("jax_enable_x64", False)
    with torch.no_grad():
        ours = port.double().eval()(*map(torch.from_numpy, args)).numpy()
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("path,layer", [
    (("purifier", "conv7"), "Conv_0"),
    (("head", "conv1"), "Conv_0"),
    (("backbone", "layer1"), "Conv_0"),
    (("backbone", "conv1"), "Dense_0"),
    (("residual_1", "conv3"), "Conv_0"),          # CaNet
    (("residule1", "bn1"), "BatchNorm_0"),        # RPMMs
    (("down_query_conv", "extra"), "Conv_0"),     # PFENet
])
def test_state_dict_from_jax_rejects_unknown_paths(path, layer):
    tree = leaf = {}
    for name in path:
        leaf[name] = {}
        leaf = leaf[name]
    leaf[layer] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError):
        state_dict_from_jax(tree, {})
