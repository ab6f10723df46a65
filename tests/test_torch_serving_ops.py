"""The meta-prototype operators and the serving tool's own surface on the
CPU: ``pemp::mpm_assign`` and ``pemp::mpm_match`` (``torch.library``
custom ops, ``ops/kernels/mpm.py``) pass ``opcheck`` and have a CPU and a
CUDA implementation and no other; an export followed by an eager call
computes on real tensors (F6: the resize constants made during a trace
were cached as fake tensors); a static-batch artifact; the command line
writes an artifact and its manifest that a fresh process loads with
``load_serving`` alone and that gives the live model's logits; without
``--device cpu`` the tool raises on a host without a card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2
from pemp_tpu_torch.ops import resize
from pemp_tpu_torch.ops.kernels import mpm as K
from pemp_tpu_torch.tools import export_serving as X
from tests import torch_serving_helpers as H
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tests.torch_serving_helpers import tmp_path  # noqa: F401

ROOT = Path(__file__).parents[1]
P, S, Q, N, C = 3, 2, 1, 25, 16


def _op_args(dtype):
    """Features in ``dtype``; masks and centers in float32, float64 with
    float64 features (the plain version contracts them together)."""
    rng = np.random.RandomState(0)
    other = torch.float64 if dtype == torch.float64 else torch.float32
    fts = torch.from_numpy(rng.randn(2, S + Q, N, C)).to(dtype)
    fg = torch.from_numpy(rng.rand(2, S, N) > 0.5).to(other)
    ctr = torch.from_numpy(rng.rand(C, 2 * P)).to(other)
    return fts, fg, 1.0 - fg, ctr


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_mpm_ops_pass_opcheck_and_equal_the_plain_chain(dtype):
    fts, fg, bg, ctr = _op_args(dtype)
    packed = K.assign_op(fts, fg, bg, ctr, P, 1e-6)
    torch.library.opcheck(torch.ops.pemp.mpm_assign.default,
                          (fts, fg, bg, ctr, P, 1e-6))
    for ind in (True, False):
        torch.library.opcheck(torch.ops.pemp.mpm_match.default,
                              (fts, S, packed, P, 20.0, ind))
    fgp, bgp = K.meta_prototype_assign(fts[:, :S], fg, bg, ctr, P)
    torch.testing.assert_close(packed, torch.cat([fgp, bgp], 1), rtol=0,
                               atol=0)
    logits, inds = K.prototype_predictions(fts[:, S:], fgp, bgp, 20.0, True)
    got_l, got_i = K.mpm_chain_packed(fts, fg, bg, ctr, P, 20.0, True)
    torch.testing.assert_close(got_l, logits, rtol=0, atol=0)
    torch.testing.assert_close(got_i, inds, rtol=0, atol=0)
    assert K.match_op(fts, S, packed, P, 20.0, False)[1].shape == (0,)


@pytest.mark.parametrize("op", ["pemp::mpm_assign", "pemp::mpm_match"])
def test_mpm_ops_run_on_the_cpu_and_cuda_only(op):
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(op, "CPU") and has(op, "CUDA")
    for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd",
                "XPU", "MPS"):
        assert not has(op, key), key


def test_export_then_eager_computes_on_real_tensors():
    """F6: build a stage 1, export it with a symbolic batch, then call it
    eagerly: real logits, bit-equal to a twin never exported, and no fake
    tensor left in the resize cache."""
    resize._recent.clear()
    models = []
    for _ in range(2):
        m = PEMPStage1(backbone="resnet50")
        m.reset_parameters(torch.Generator().manual_seed(7))
        models.append(m.eval())
    exported_one, twin = models
    args = tuple(torch.from_numpy(a) for a in H.episode("pemp_stage1", 2, 8))
    with torch.no_grad():
        torch.export.export(exported_one, args, dynamic_shapes=tuple(
            {0: torch.export.Dim("b", min=1)} for _ in args))
        got = exported_one(*args)
        want = twin(*args)
    assert type(got) is torch.Tensor
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for cache in (resize._recent, resize._held):
        assert not any(isinstance(t, FakeTensor) for t in cache.values())


def test_static_batch_artifact(tmp_path):
    """``--batch 1``: the artifact takes B = 1 only."""
    port = PEMPStage1(backbone="resnet50")
    port.reset_parameters(torch.Generator().manual_seed(3))
    serve, inputs, dyn = X.build_serving_fn("pemp_stage1", port, 1, 1, 1, 33,
                                            "cpu")
    assert dyn is None and inputs[0].shape[0] == 1
    loaded, exported, _ = H.roundtrip(serve, inputs, dyn, tmp_path, "static")
    assert H.mpm_nodes(exported) == sorted(H.MPM_OPS)
    arrays = H.episode("pemp_stage1", 1, seed=5)
    np.testing.assert_array_equal(H.run_port(loaded.module(), arrays),
                                  H.run_port(serve, arrays))
    with pytest.raises(Exception):
        H.run_port(loaded.module(), H.episode("pemp_stage1", 2, seed=6))


LOAD_AND_RUN = """
import sys, numpy as np, torch
from pemp_tpu_torch.tools.export_serving import load_serving
torch.set_num_threads(1)            # as the test (one_torch_thread)
fn = load_serving(sys.argv[1]).module()
for i, path in enumerate(sys.argv[2:]):
    data = np.load(path)
    with torch.no_grad():
        out = fn(*[torch.from_numpy(data[k]) for k in sorted(data.files)])
    np.save(f"{sys.argv[1]}.out{i}.npy", out.numpy())
assert "jax" not in sys.modules
"""


def _cli(*args):
    X.main(["--device", "cpu", "--precision", "f32", "--hw", "33",
            "--batch", "poly", *map(str, args)])


def _fresh_process_logits(out, episodes, tmp_path):
    paths = []
    for i, arrays in enumerate(episodes):
        paths.append(tmp_path / f"ep{i}.npz")
        np.savez(paths[-1], **{f"a{j}": a for j, a in enumerate(arrays)})
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", LOAD_AND_RUN, str(out),
                    *map(str, paths)], check=True, env=env, timeout=300)
    return [np.load(f"{out}.out{i}.npy") for i in range(len(episodes))]


def test_cli_stage1_artifact_loads_in_a_fresh_process(tmp_path):
    model = PEMPStage1(backbone="resnet50")
    model.reset_parameters(torch.Generator().manual_seed(11))
    ckpt = tmp_path / "s1.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    out = tmp_path / "s1.pt2"
    _cli("--model", "pemp_stage1", "--ckpt", ckpt, "--out", out)
    manifest = json.loads(Path(f"{out}.json").read_text())
    assert manifest["bytes"] == out.stat().st_size
    assert {k: manifest[k] for k in ("model", "batch", "device", "hw")} == {
        "model": "pemp_stage1", "batch": "b", "device": "cpu", "hw": 33}
    assert manifest["inputs"][0] == ["b", 1, 33, 33, 3]
    assert set(manifest) >= {"backbone", "shot", "query", "torch", "output"}
    # the live model as the tool runs it: channels_last weights
    live = model.to(memory_format=torch.channels_last).eval()
    episodes = [H.episode("pemp_stage1", b, seed=30 + b) for b in (1, 2)]
    for arrays, got in zip(episodes, _fresh_process_logits(
            out, episodes, tmp_path)):
        np.testing.assert_array_equal(got, H.run_port(live, arrays))


def test_cli_cascade_takes_both_checkpoints(tmp_path):
    s1, s2 = PEMPStage1(backbone="vgg16"), PEMPStage2(backbone="vgg16")
    s1.reset_parameters(torch.Generator().manual_seed(12))
    s2.reset_parameters(torch.Generator().manual_seed(13))
    torch.save({"model": s1.state_dict()}, tmp_path / "s1.pt")
    torch.save(s2.state_dict(), tmp_path / "s2.pt")
    out = tmp_path / "cascade.pt2"
    with pytest.raises(SystemExit):
        _cli("--model", "cascade", "--backbone", "vgg16", "--ckpt",
             tmp_path / "s2.pt", "--out", out)
    _cli("--model", "cascade", "--backbone", "vgg16", "--s1-ckpt",
         tmp_path / "s1.pt", "--ckpt", tmp_path / "s2.pt", "--out", out)
    loaded = X.load_serving(out)
    assert H.mpm_nodes(loaded) == sorted(H.MPM_OPS * 2)
    arrays = H.episode("cascade", 2, seed=40)
    with torch.no_grad():
        x = [torch.from_numpy(a) for a in arrays]
        s1, s2 = (m.to(memory_format=torch.channels_last).eval()
                  for m in (s1, s2))
        want = s2(*x, s1(*x).argmax(dim=-1).float())
    np.testing.assert_array_equal(H.run_port(loaded.module(), arrays),
                                  want.numpy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        X.main(["--model", "pemp_stage1", "--ckpt", str(tmp_path / "x.pt"),
                "--out", str(tmp_path / "x.pt2")])
    assert not any(tmp_path.iterdir())
