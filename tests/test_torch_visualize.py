"""``visualize`` (``pemp_tpu_torch/core/visualize.py``) against the JAX
package's (``pemp_tpu/core/visualize.py:49-147``).

Both packages' stage-1 ``visualize`` load one JAX checkpoint (a stage 1
with one block a ResNet stage, weights drawn from numpy, float32) from
the same run folder, on the same SYNTH stream, each into its own
``PEMP_HTTP_STATIC``. The folders, the file names and the support and
query images and masks are byte for byte the same; ``data.json`` holds
the same keys and names and an accuracy within ``ACC_TOL`` (the
predictions come from float32 logits that agree within rtol 1e-3,
atol 2e-4, so a pixel at a near tie may flip); the prediction and the
response colours agree on at least ``PIXEL_AGREE`` of the pixels. The
single-episode mode (the ``p`` scope) and the stage-2 cascade's
``visualize`` write their files too.
"""

import json
import re
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from pemp_tpu.core import checkpoint as jax_ckpt
from pemp_tpu.models import common as jax_common
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu_torch.core.visualize import RESPONSE_COLORS
from pemp_tpu_torch.entry import pemp_stage1 as entry1
from pemp_tpu_torch.entry import pemp_stage2 as entry2
from pemp_tpu_torch.models import common as port_common
from tests.test_torch_parity_helpers import (  # noqa: F401 (fixture)
    draw_variables, one_torch_thread,
)

ROOT = Path(__file__).resolve().parents[1]
LAYERS = (1, 1, 1)
SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.test_bs=2", "data.test_n=6", "data.num_workers=1", "exp_id=1"]
KIND = re.compile(r"[a-z ]+_(sup_img|sup_msk|qry_img|qry_msk|qry_pred|"
                  r"qry_color)_synth_\d{2}_\d{3}\.(?:jpg|png)")
ACC_TOL = 2e-3
PIXEL_AGREE = 0.999


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints the test wrote
    into it once the test ends (tens of MB at ResNet-50 width)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def files(folder):
    return sorted(str(p.relative_to(folder)) for p in folder.rglob("*")
                  if p.is_file())


def pixels(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """The JAX and the port's ``visualize`` of one checkpoint:
    ``(jax folder, port folder)``."""
    root = tmp_path_factory.mktemp("visualize")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_common.RESNET_LAYERS, "resnet50", LAYERS)
        mp.setitem(port_common.RESNET_LAYERS, "resnet50", LAYERS)
        model = JaxPEMPStage1(backbone="resnet50", use_pallas=False)
        x, m = jnp.zeros((1, 1, 33, 33, 3)), jnp.zeros((1, 1, 33, 33, 2))
        params, stats = draw_variables(model, (x, m, x), seed=5)
        jax_ckpt.save(root / "md" / "pemp_stage1" / "1" / "bestckpt.msgpack",
                      {"params": params, "batch_stats": stats}, epoch=1)
        md = f"g.model_dir={root / 'md'}"
        script = ROOT / "entry" / "pemp_stage1.py"
        jax_ex = runpy.run_path(str(script), run_name="jax_entry")["ex"]
        mp.setattr(sys, "argv", [str(script)])
        mp.setenv("PEMP_HTTP_STATIC", str(root / "jax"))
        with jax.default_matmul_precision("highest"):
            jax_ex.run_commandline(["visualize", "with", *SMALL, md,
                                    "tpu.precision=f32"])
        mp.setenv("PEMP_HTTP_STATIC", str(root / "port"))
        entry1.main(["visualize", "with", *SMALL, md, "dev.device=cpu",
                     "dev.precision=f32"])
    folder = "1_synth_1shot_pemp_stage1_s0"
    yield root / "jax" / folder, root / "port" / folder
    shutil.rmtree(root, ignore_errors=True)


def test_visualize_writes_the_jax_files(dumps):
    jax_dir, port_dir = dumps
    assert files(port_dir) == files(jax_dir)
    episodes = sorted(p.name for p in port_dir.iterdir())
    assert len(episodes) == 3        # the first episode of each batch
    for ep in episodes:
        kinds = sorted(KIND.fullmatch(p.name)[1] if p.suffix != ".json"
                       else p.name for p in (port_dir / ep).iterdir())
        assert kinds == ["data.json", "qry_color", "qry_img", "qry_msk",
                         "qry_pred", "sup_img", "sup_msk"], kinds


def test_visualize_images_and_records_match_jax(dumps):
    jax_dir, port_dir = dumps
    for rel in files(port_dir):
        ours, ref = port_dir / rel, jax_dir / rel
        if rel.endswith("data.json"):
            a, b = (json.loads(p.read_text()) for p in (ours, ref))
            assert set(a) == set(b) and float(a.pop("acc")) == \
                pytest.approx(float(b.pop("acc")), abs=ACC_TOL)
            assert a == b
        elif "_pred_" in rel or "_color_" in rel:
            a, b = pixels(ours), pixels(ref)
            assert a.shape == b.shape and a.dtype == b.dtype
            agree = np.all(a == b, axis=-1) if a.ndim == 3 else a == b
            assert agree.mean() >= PIXEL_AGREE, (rel, agree.mean())
            if "_color_" in rel:    # every colour is one of the palette's
                assert {tuple(c) for c in a.reshape(-1, 3)} <= {
                    tuple(c) for c in RESPONSE_COLORS}
        else:                       # the inputs: byte for byte
            assert ours.read_bytes() == ref.read_bytes(), rel


def test_visualize_single_episode_and_the_cascade(tmp_path, monkeypatch):
    """``p.cls`` names one episode (the ``_misc`` folder); stage 2's
    ``visualize`` draws the cascade behind a stage-1 checkpoint."""
    monkeypatch.setitem(port_common.RESNET_LAYERS, "resnet50", LAYERS)
    monkeypatch.setenv("PEMP_HTTP_STATIC", str(tmp_path / "static"))
    cpu = ["dev.device=cpu", "dev.precision=f32",
           f"g.model_dir={tmp_path / 'md'}"]
    cfg = entry1.ex.assemble("test", {"split": "0"})
    cfg.dev.device = "cpu"
    s1 = entry1.build_model(cfg, torch.device("cpu"))
    run = tmp_path / "md" / "pemp_stage1" / "1"
    run.mkdir(parents=True)
    torch.save(s1.state_dict(), run / "bestckpt.pt")
    entry1.main(["visualize", "with", *SMALL, *cpu, "p.cls=3",
                 "p.sup=synth_03_004", "p.qry=synth_03_009"])
    misc = tmp_path / "static" / "1_synth_1shot_pemp_stage1_s0_misc"
    assert [p.name for p in misc.iterdir()] == ["000_03"]
    data = json.loads((misc / "000_03" / "data.json").read_text())
    assert (data["cls_name"], data["sup"], data["qry"]) == (
        "bird", "synth_03_004", "synth_03_009")

    s2_cfg = entry2.ex.assemble("train", {"split": "0", "s1.id": "1"})
    s2_cfg.g.model_dir, s2_cfg.dev.device = str(tmp_path / "md"), "cpu"
    cascade = entry2.build_model(s2_cfg, torch.device("cpu"))
    run2 = tmp_path / "md" / "pemp_stage2" / "1"
    run2.mkdir(parents=True)
    torch.save(cascade.stage2.state_dict(), run2 / "bestckpt.pt")
    entry2.main(["visualize", "with", *SMALL, *cpu, "s1.id=1"])
    out = tmp_path / "static" / "1_synth_1shot_pemp_stage2_s0"
    assert len(files(out)) == 3 * 7
