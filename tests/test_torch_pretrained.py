"""The pretrained trunk (``pemp_tpu_torch/utils/pretrained.py``) against
the JAX package's ``try_load_backbone``
(``pemp_tpu/utils/torch_convert.py:172-199``).

One seeded file in torchvision's layout per trunk, at the published
shapes (ResNet-50/101 stages 1-3, VGG16 ``features``, the deep-base
ResNet-50 v2; each with an ``fc`` it must ignore), is written into a
``data/`` that the test makes its working directory. For every family
and trunk, JAX's conversion runs on the JAX init tree and goes through
the port's ``state_dict_from_jax``; the port's ``init_weights`` must give
the same trunk tensors bit for bit, zeros in the padded input channels
(the stage-2 prior channel and the CMs' ``+2``), and the port's own
seeded draw everywhere else. Without the file the seeded draw stays.
"""

import logging
import shutil
from types import SimpleNamespace

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
from pemp_tpu.utils import torch_convert
from pemp_tpu_torch.core.experiment import init_weights
from pemp_tpu_torch.entry import (
    baseline, canet, panet, pemp_stage1, pemp_stage2, pfenet, rpmms,
)
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.utils import pretrained
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401

ENTRIES = {"pemp_stage1": pemp_stage1, "pemp_stage2": pemp_stage2,
           "baseline": baseline, "panet": panet, "canet": canet,
           "rpmms": rpmms, "pfenet": pfenet}
CASES = [("pemp_stage1", "resnet50"), ("pemp_stage1", "resnet101"),
         ("pemp_stage1", "vgg16"), ("pemp_stage2", "resnet50"),
         ("pemp_stage2", "vgg16"), ("baseline", "vgg16"),
         ("panet", "resnet50"), ("canet", "resnet50"), ("rpmms", "resnet50"),
         ("pfenet", "resnet50v2")]
VGG = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
       (14, 256), (17, 512), (19, 512), (21, 512), (24, 512), (26, 512),
       (28, 512))


def torchvision_file(backbone, rng):
    """A torchvision-layout state_dict at the published shapes: the keys
    the loaders read (ResNet-50/101 stages 1-3, every VGG16 conv, the
    whole deep-base v2) plus ``fc``."""
    sd = {}

    def put(key, *shape):
        sd[key] = torch.from_numpy(rng.standard_normal(shape, np.float32))

    def bn(key, c):
        for t in ("weight", "bias", "running_mean"):
            put(f"{key}.{t}", c)
        sd[f"{key}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))

    if backbone == "vgg16":
        cin = 3
        for i, c in VGG:
            put(f"features.{i}.weight", c, cin, 3, 3)
            put(f"features.{i}.bias", c)
            cin = c
    else:
        v2 = backbone == "resnet50v2"
        blocks = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23),
                  "resnet50v2": (3, 4, 6, 3)}[backbone]
        if v2:      # the deep-base stem: three 3x3 convs
            for i, (cout, cin) in enumerate(((64, 3), (64, 64), (128, 64)), 1):
                put(f"conv{i}.weight", cout, cin, 3, 3)
                bn(f"bn{i}", cout)
            inplanes = 128
        else:
            put("conv1.weight", 64, 3, 7, 7)
            bn("bn1", 64)
            inplanes = 64
        for si, (n, p) in enumerate(zip(blocks, (64, 128, 256, 512)), 1):
            for bi in range(n):
                key = f"layer{si}.{bi}"
                put(f"{key}.conv1.weight", p, inplanes if bi == 0 else 4 * p,
                    1, 1)
                put(f"{key}.conv2.weight", p, p, 3, 3)
                put(f"{key}.conv3.weight", 4 * p, p, 1, 1)
                for ci, c in ((1, p), (2, p), (3, 4 * p)):
                    bn(f"{key}.bn{ci}", c)
                if bi == 0:
                    put(f"{key}.downsample.0.weight", 4 * p, inplanes, 1, 1)
                    bn(f"{key}.downsample.1", 4 * p)
            inplanes = 4 * p
    put("fc.weight", 1000, 2048)
    put("fc.bias", 1000)
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``data/`` with one seeded file per trunk, removed at the end (the
    four take ~300 MB)."""
    root = tmp_path_factory.mktemp("pretrained")
    (root / "data").mkdir()
    rng = np.random.default_rng(0)
    sds = {}
    for backbone, name in pretrained.PRETRAINED_FILES.items():
        sds[backbone] = torchvision_file(backbone, rng)
        torch.save(sds[backbone], root / name)
    yield root, sds
    shutil.rmtree(root, ignore_errors=True)


def jax_trunk(name, backbone):
    """JAX's ``try_load_backbone`` on the family's init tree (shapes from
    ``eval_shape``, zeros elsewhere), in the port's keys."""
    x, m = jnp.zeros((1, 1, 33, 33, 3)), jnp.zeros((1, 1, 33, 33, 2))
    args, kwargs = (x, m, x), {}
    if name == "pemp_stage1":
        model = JaxPEMPStage1(backbone=backbone)
    elif name == "pemp_stage2":
        model = JaxPEMPStage2(backbone=backbone, spq=2)
        args += (jnp.zeros((1, 1, 33, 33)),)
    elif name in ("baseline", "panet"):
        model = {"baseline": JaxBaseline, "panet": JaxPANet}[name](
            backbone=backbone)
    elif name == "canet":
        model, args = JaxCaNet(), args + (jnp.zeros((1, 1, 5, 5, 2)),)
    elif name == "rpmms":
        model = JaxRPMMs()
        kwargs = {"mu_init": [jnp.zeros((1, 256, k)) for k in (1, 3, 6)]}
    else:
        model = JaxPFENet()
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, *args, **kwargs))
    zeros = lambda s: np.zeros(s.shape, np.float32)  # noqa: E731
    params = jax.tree_util.tree_map(zeros, shapes["params"])
    stats = jax.tree_util.tree_map(zeros, shapes.get("batch_stats", {}))
    cfg = SimpleNamespace(net=SimpleNamespace(backbone=backbone,
                                              backbone2=backbone))
    assert torch_convert.try_load_backbone(name, cfg, params, stats,
                                           logging.getLogger("jax"))
    return state_dict_from_jax(params, stats)


def port_model(name, backbone):
    """The port's model as its entry builds it, before ``init_weights``."""
    net = ENTRIES[name].base_cfg.net
    cfg = ENTRIES[name].ex.assemble("train", {
        "split": "0", "dev.device": "cpu", "dev.precision": "f32",
        **{f"net.{k}": backbone for k in ("backbone", "backbone2")
           if hasattr(net, k)}})
    return registry.build(name, cfg), cfg


def file_keys(model):
    """The tensors the file sets: those of the model's ``trunk()`` but the
    CMs' linears and the BN counters."""
    names = {id(m): n for n, m in model.named_modules()}
    prefixes = tuple(f"{names[id(m)]}." for m in model.trunk())
    return [k for k in model.state_dict() if k.startswith(prefixes)
            and ".linear" not in k and not k.endswith("num_batches_tracked")]


@pytest.mark.parametrize("name,backbone", CASES)
def test_pretrained_trunk_equals_the_jax_conversion(files, monkeypatch, name,
                                                    backbone):
    root, sds = files
    monkeypatch.chdir(root)
    want = jax_trunk(name, backbone)
    model, cfg = port_model(name, backbone)
    init_weights(model, cfg, name)
    got = model.state_dict()
    seeded, _ = port_model(name, backbone)
    seeded.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    seeded = seeded.state_dict()

    trunk = file_keys(model)
    assert trunk and set(trunk) <= set(want)
    for k in trunk:
        assert torch.equal(got[k], want[k]), k
        assert not torch.equal(got[k], seeded[k]), k
    for k in set(got) - set(trunk):
        assert torch.equal(got[k], seeded[k]), k

    # the stage-2 surgery: the prior channel and the CMs' +2 are zero,
    # every other input channel is the file's
    sd, pads = sds[backbone], {}
    if name == "pemp_stage2" and backbone == "vgg16":
        pads = {"features.0": 1, "features.5": 2, "features.10": 2,
                "features.17": 2, "features.24": 2}
    elif name == "pemp_stage2":
        pads = {"conv1": 1, **{f"layer{s}.0.{m}": 2 for s in (1, 2, 3)
                               for m in ("conv1", "downsample.0")}}
    for key, n in pads.items():
        w = got[f"encoder.backbone.{key}.weight"]
        assert w.shape[1] == sd[f"{key}.weight"].shape[1] + n, key
        assert torch.count_nonzero(w[:, -n:]) == 0, key
        assert torch.equal(w[:, :-n], sd[f"{key}.weight"]), key


@pytest.mark.parametrize("name,backbone", [("pemp_stage2", "resnet50"),
                                           ("pfenet", "resnet50v2")])
def test_absent_file_keeps_the_seeded_draw(tmp_path, monkeypatch, caplog,
                                           name, backbone):
    monkeypatch.chdir(tmp_path)
    model, cfg = port_model(name, backbone)
    seeded, _ = port_model(name, backbone)
    seeded.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    with caplog.at_level(logging.INFO):
        assert not pretrained.try_load_backbone(
            name, cfg, model, logging.getLogger("pemp_tpu_torch.test"))
    assert "keeps random init" in caplog.text
    init_weights(model, cfg, name)
    for k, v in seeded.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_a_shape_the_trunk_does_not_have_raises(files, monkeypatch):
    """The loader refuses a file tensor whose shape is not the trunk's."""
    root, sds = files
    model, _ = port_model("pemp_stage1", "resnet50")
    sd = dict(sds["resnet50"])
    sd["layer1.0.conv2.weight"] = sd["layer1.0.conv2.weight"][:, :32]
    with pytest.raises(ValueError, match="shape mismatch"):
        pretrained.load_into(model, sd, pretrained.resnet_plan(
            model.encoder.backbone, sd), "encoder.backbone.")
