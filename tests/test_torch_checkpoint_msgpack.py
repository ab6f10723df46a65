"""The port reads the JAX package's ``.msgpack`` checkpoints without
``flax`` or ``msgpack`` (``pemp_tpu_torch/core/checkpoint.py``).

Files are written by ``pemp_tpu.core.checkpoint.save`` in the same
process: a narrow stage-1 tree at float32 with an optimizer state and an
``extra`` dict, the same tree at bfloat16, and one with its arrays
chunked (flax's ``MAX_CHUNK_SIZE`` made small). Every leaf the port
reads equals flax's ``msgpack_restore`` bit for bit; ``load_weights`` of
the file gives the JAX forward at float32 within the whole-model
tolerance of ``tests/test_torch_model_parity.py`` (rtol 1e-3, atol 2e-4;
response maps equal). ``find_snapshot`` agrees with
``pemp_tpu.utils.misc.find_snapshot`` on a tree of run folders, and a
process that imports the port and loads a file has imported neither
``msgpack`` nor ``flax``.
"""

import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pemp_tpu.core import checkpoint as jax_ckpt
from pemp_tpu.models import common as jax_common
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu.utils import misc as jax_misc
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core.experiment import load_weights
from pemp_tpu_torch.entry import pemp_stage1 as entry
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from tests.test_torch_parity_helpers import (  # noqa: F401 (fixture)
    draw_variables, episode, one_torch_thread,
)

ROOT = Path(__file__).resolve().parents[1]
LAYERS = (1, 1, 1)
H = W = 33
RTOL, ATOL = 1e-3, 2e-4
EXTRA = {"best_iou": 0.4375, "best_epoch": 3, "neg": -7, "big": 2 ** 40,
         "flag": True, "none": None, "name": "run", "lr": np.float32(0.5),
         "lr_policy": {"step": 12, "history": [0.25, 1.5, -2.0]}}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints the test wrote
    into it once the test ends (tens of MB at ResNet-50 width)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def narrow(monkeypatch):
    """The JAX stage 1 with one block a ResNet stage, and its variables
    drawn from numpy."""
    monkeypatch.setitem(jax_common.RESNET_LAYERS, "resnet50", LAYERS)
    model = JaxPEMPStage1(backbone="resnet50", use_pallas=False)
    x, m = jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H, W, 2))
    params, stats = draw_variables(model, (x, m, x), seed=3)
    return model, {"params": params, "batch_stats": stats}


def flat(tree, prefix=()):
    """``{path: leaf}``; lists and flax's ``{"0": ...}`` maps alike."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def assert_bit_equal(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if torch.is_tensor(g):                  # bfloat16
            assert w.dtype == jnp.bfloat16, k
            assert tuple(g.shape) == w.shape, k
            assert (g.view(torch.int16).numpy().tobytes()
                    == np.asarray(w).view(np.int16).tobytes()), k
        elif isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and np.shape(g) == w.shape, k
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), k
        else:
            assert g == w and type(g) is type(w), k


def restored(path):
    """flax's decoding of a checkpoint's two msgpack layers."""
    payload = serialization.msgpack_restore(path.read_bytes())
    return payload, serialization.msgpack_restore(payload["variables"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "chunked"])
def test_read_msgpack_gives_flax_leaves_bit_for_bit(narrow, tmp_path,
                                                    monkeypatch, dtype):
    _, variables = narrow
    if dtype == "bfloat16":
        variables = jax.tree_util.tree_map(
            lambda x: np.asarray(x, jnp.bfloat16), variables)
    if dtype == "chunked":      # every array above 256 bytes in chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    opt_state = ({"mu": variables["params"]["ctr"]}, (), np.int32(4))
    path = jax_ckpt.save(tmp_path / "ckpt.msgpack", variables, opt_state,
                         epoch=5, extra=EXTRA)
    data = path.read_bytes()
    if dtype == "chunked":
        assert b"__msgpack_chunked_array__" in data
    payload = ckpt_lib.read_msgpack(data)
    want_payload, want_vars = restored(path)
    assert payload["epoch"] == 5
    assert_bit_equal({k: v for k, v in payload.items() if k != "variables"},
                     {k: v for k, v in want_payload.items()
                      if k != "variables"})
    assert payload["extra"]["lr_policy"]["history"] == [0.25, 1.5, -2.0]
    assert_bit_equal(ckpt_lib.read_msgpack(payload["variables"]), want_vars)
    assert_bit_equal(ckpt_lib.read_msgpack(payload["opt_state"]),
                     serialization.msgpack_restore(want_payload["opt_state"]))

    tree = ckpt_lib.read_jax_checkpoint(path)
    assert (tree["epoch"], tree["extra"]["best_epoch"]) == (5, 3)
    assert_bit_equal({"params": tree["params"],
                      "batch_stats": tree["batch_stats"]}, want_vars)


def test_read_msgpack_decodes_every_wire_type():
    """The formats a checkpoint can hold, against the ``msgpack``
    package's encoder (ints of each width, floats, str and bin of each
    length class, arrays and maps of 16 and 32 entries, ext types)."""
    import msgpack
    doc = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                    -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
           "floats": [0.5, -1e300, float("inf")], "f32": 1.5,
           "strs": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 65536],
           "bins": [b"", b"x" * 256, b"y" * 65536],
           "arr16": list(range(16)), "arr_big": list(range(70000)),
           "map16": {f"k{i}": i for i in range(16)},
           "map_big": {f"k{i}": i for i in range(70000)},
           "nested": {"0": 1, "1": [True, False, None]}}
    data = msgpack.packb(doc, use_bin_type=True)
    got = ckpt_lib.read_msgpack(data)
    want = dict(doc, nested=[1, [True, False, None]])    # a flax list map
    assert got == want
    single = msgpack.packb(np.float32(2.5).item(), use_single_float=True)
    assert ckpt_lib.read_msgpack(single) == 2.5
    with pytest.raises(ValueError, match="truncated"):
        ckpt_lib.read_msgpack(data[:-3])
    with pytest.raises(ValueError, match="unsupported msgpack ext"):
        ckpt_lib.read_msgpack(msgpack.packb(msgpack.ExtType(2, b"xy")))


def test_load_weights_of_a_msgpack_gives_the_jax_forward(narrow, tmp_path):
    model, variables = narrow
    path = jax_ckpt.save(tmp_path / "bestckpt.msgpack", variables, epoch=1)
    port = PEMPStage1(backbone="resnet50", layers=LAYERS)
    load_weights(port, path)
    sup, mask, qry = episode(2, 2, 1, 1, H, W, np.float32)
    with jax.default_matmul_precision("highest"):
        ref, ref_resp = jax.jit(lambda v, a, b, c: model.apply(
            v, a, b, c, ret_ind=True, train=False))(
            variables, jnp.asarray(sup), jnp.asarray(mask), jnp.asarray(qry))
    with torch.no_grad():
        ours, resp = port.eval()(torch.from_numpy(sup),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(qry), ret_ind=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(ref_resp))


def test_the_port_imports_no_msgpack_or_flax(narrow, tmp_path):
    _, variables = narrow
    path = jax_ckpt.save(tmp_path / "bestckpt.msgpack", variables, epoch=1)
    code = (
        "import sys\n"
        "from pemp_tpu_torch.core.experiment import load_weights\n"
        "from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1\n"
        f"load_weights(PEMPStage1(layers={LAYERS}), {str(path)!r})\n"
        "print(sorted(m for m in ('msgpack', 'flax', 'jax')"
        " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def run_tree(tmp_path):
    """Run folders: tag ``a`` runs 1 (bestckpt and ckpt), 2 (ckpt.pth),
    3 (empty), 4 (a custom name); tag ``b`` run 7."""
    files = ["a/1/bestckpt.msgpack", "a/1/ckpt.msgpack", "a/2/ckpt.pth",
             "a/4/weights.msgpack", "b/7/bestckpt.msgpack", "free.msgpack"]
    (tmp_path / "a" / "3").mkdir(parents=True)
    for f in files:
        (tmp_path / f).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / f).write_bytes(b"")
    return tmp_path


@pytest.mark.parametrize("tag,exp_id,ckpt", [
    ("a", 1, ""), ("a", 2, ""), ("a", 1, "ckpt.msgpack"),
    ("a", 4, "weights.msgpack"), ("a", 7, ""), ("a", 3, ""), ("a", -1, ""),
    ("a", 9, "weights.msgpack"), ("a", -1, "free.msgpack"),
    ("b", 1, ""), ("c", -1, ""), ("c", 3, "")])
def test_find_snapshot_agrees_with_the_jax_package(run_tree, monkeypatch,
                                                   tag, exp_id, ckpt):
    monkeypatch.chdir(run_tree)
    cfg = SimpleNamespace(g=SimpleNamespace(model_dir=str(run_tree)), tag=tag)
    try:
        want = jax_misc.find_snapshot(cfg, exp_id, ckpt)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            ckpt_lib.find_snapshot(run_tree, tag, exp_id, ckpt)
        return
    assert ckpt_lib.find_snapshot(run_tree, tag, exp_id, ckpt) == want


def test_find_snapshot_takes_the_ports_pt_first(tmp_path):
    (tmp_path / "t" / "2").mkdir(parents=True)
    for name in ("bestckpt.msgpack", "bestckpt.pt", "ckpt.pt"):
        (tmp_path / "t" / "2" / name).write_bytes(b"")
    assert ckpt_lib.find_snapshot(tmp_path, "t", 2).name == "bestckpt.pt"


def test_test_command_finds_a_jax_runs_snapshot(tmp_path, monkeypatch):
    """``test exp_id=<id>`` loads the JAX run's ``bestckpt.msgpack`` from
    the same model dir; a resume from it is refused."""
    model = JaxPEMPStage1(backbone="resnet50", use_pallas=False)
    x, m = jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H, W, 2))
    params, stats = draw_variables(model, (x, m, x), seed=4)
    run = tmp_path / "pemp_stage1" / "3"
    jax_ckpt.save(run / "bestckpt.msgpack",
                  {"params": params, "batch_stats": stats}, epoch=2)
    jax_ckpt.save(run / "ckpt.msgpack",
                  {"params": params, "batch_stats": stats}, epoch=2)
    small = ["split=0", "data.dataset=SYNTH", f"data.height={H}",
             f"data.width={W}", "data.test_bs=2", "data.test_n=2",
             "te.epochs=1", "data.num_workers=1", "dev.device=cpu",
             "dev.precision=f32", f"g.model_dir={tmp_path}"]
    loaded = []
    build = entry.build_model

    def keep(cfg, device):
        loaded.append(cfg.ckpt)
        return build(cfg, device)

    monkeypatch.setattr(entry, "build_model", keep)
    result = entry.main(["test", "with", *small, "exp_id=3", "-u"])
    assert loaded == [str(run / "bestckpt.msgpack")]
    assert np.isfinite(result["miou"])
    with pytest.raises(ValueError, match="resume needs the port's ckpt.pt"):
        entry.main(["train", "with", *small, "data.bs=2", "data.train_n=2",
                    "resume=True", "exp_id=3"])
