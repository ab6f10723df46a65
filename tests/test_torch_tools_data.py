"""The port's data tools (``pemp_tpu_torch/tools/bench_input.py``,
``tools/verify_real_data.py``) against the JAX tools and fixtures.

bench_input: its miniature tree is byte-equal to
``tests/fixtures.py::make_fake_voc``'s for the same arguments; the first
batch of a one-worker pass equals the JAX loader's for the same seed; the
CLI gives the JAX tool's summary keys, the wire cast and the cores of the
demand it is given, which has no default.

verify_real_data: the dataless dry run prints ``[SKIP]`` for all five
phases, as ``tests/test_verify_real_data.py`` asks of the JAX tool; its
plan is the JAX ``_miou_plan``'s (family, split, shot, dataset) matrix
with the same targets, checkpoints and ``s1.id`` wiring, with the port's
entry commands; phase 4 reports OK on a seeded reference-layout
``pemp_stage1`` ``.pth`` (strict load, bit-exact round trip) and FAIL on
one that misses a tensor; ``--eval`` runs a planned ``test`` on a
miniature PASCAL tree and parses its mIoU.
"""

import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pemp_tpu.config import Config as JaxConfig
from pemp_tpu.data.loader import EpisodeLoader as JaxLoader
from pemp_tpu.data.pascal import PascalVOC as JaxPascal
from pemp_tpu.models import registry as jax_registry
from pemp_tpu_torch.data.pascal import PascalVOC
from pemp_tpu_torch.tools import bench_input, verify_real_data
from tests.fixtures import make_fake_voc
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tools import verify_real_data as jax_verify

PHASES = ("1 inventory", "2 goldens", "3 rasterizer", "4 convert",
          "5 miou")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed once the test ends (trees of JPEGs
    and ResNet-50 checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _files(root: Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_fake_tree_is_byte_equal_to_the_fixture(tmp_path):
    kwargs = dict(per_class=1, classes=range(1, 4), size=(375, 500),
                  smooth=True, quality=90)
    bench_input.fake_voc(tmp_path / "port", **kwargs)
    make_fake_voc(tmp_path / "jax", **kwargs)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(got) == 3 * 2 * 3 and got == want   # jpg, png, txt
    plain = dict(per_class=2, classes=range(5, 7), seed=3)
    bench_input.fake_voc(tmp_path / "port2", **plain)
    make_fake_voc(tmp_path / "jax2", **plain)
    assert _files(tmp_path / "port2") == _files(tmp_path / "jax2")


@pytest.mark.parametrize("train", [True, False])
def test_first_batch_of_a_one_worker_pass_equals_the_jax_loader(tmp_path,
                                                                 train):
    bench_input.fake_voc(tmp_path, per_class=3, size=(60, 80), smooth=True)
    cfg = bench_input.make_config(tmp_path, 49, 4, cache=True)
    jcfg = JaxConfig()
    jcfg.net = jax_registry.net_config("pemp_stage1")
    jcfg.data.dataset, jcfg.data.base_dir = "PASCAL", str(tmp_path)
    jcfg.data.height = jcfg.data.width = 49
    jcfg.data.train_n = jcfg.data.test_n = 4
    bs = 2 if train else 1
    ours = PascalVOC(cfg, train=train, split=0, shot=1, query=1)
    ref = JaxPascal(jcfg, train=train, split=0, shot=1, query=1)
    batches = []
    for ds, take in ((ours, lambda d: bench_input.run_pass(
            d, bs, 1, keep_first=True)[3]),
            (ref, lambda d: next(iter(JaxLoader(d, bs, num_workers=1,
                                                prefetch=2))))):
        random.seed(7)
        np.random.seed(7)
        ds.sample_tasks()
        batches.append(take(ds))
    a, b = batches
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def test_bench_input_cli_on_the_cpu(capsys):
    out = bench_input.main(["--device", "cpu", "--episodes", "4",
                            "--workers", "1,2", "--hw", "65",
                            "--device-eps", "train=50,test=400"])
    for key in ("metric", "cores", "ms_per_episode_cpu", "results",
                "synthetic_tree"):
        assert key in out
    assert out["synthetic_tree"] and out["device"] == "cpu"
    assert out["decoded_image_cache"] is True
    assert [(r["mode"], r["workers"]) for r in out["results"]] == [
        ("train", 1), ("train", 2), ("test", 1), ("test", 2)]
    for mode, eps in (("train", 50), ("test", 400)):
        assert out["cores"][mode] == pytest.approx(
            eps * out["ms_per_episode_cpu"][mode] / 1e3)
        assert out["wire_cast_ms_per_episode"][mode] > 0
    assert "input pipeline @ 65x65" in capsys.readouterr().out
    with pytest.raises(SystemExit):             # the demand has no default
        bench_input.main(["--device", "cpu"])


def test_bench_input_without_the_cache(monkeypatch):
    """``--no-cache`` reads every image anew each pass: no warm-up pass,
    and the decode is inside the timed passes."""
    warmed = []
    real = bench_input.run_pass

    def spy(ds, bs, workers, keep_first=False):
        warmed.append(not keep_first)
        return real(ds, bs, workers, keep_first)
    monkeypatch.setattr(bench_input, "run_pass", spy)
    out = bench_input.main(["--device", "cpu", "--episodes", "2",
                            "--workers", "1", "--hw", "65", "--no-cache",
                            "--device-eps", "train=50,test=400"])
    assert out["decoded_image_cache"] is False and not any(warmed)
    assert [(r["mode"], r["workers"]) for r in out["results"]] == [
        ("train", 1), ("test", 1)]


def test_dataless_dry_run_skips_all_five_phases(capsys):
    rc = verify_real_data.main(["--device", "cpu", "--splits", "0",
                                "--shots", "1", "--families",
                                "pemp_stage1,pemp_stage2"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for phase in PHASES:
        assert f"[SKIP] {phase}" in out, out
    assert "pemp_tpu_torch.entry.pemp_stage2 test" in out
    assert "s1.id=100" in out                   # cascade prior wiring
    assert "target 55.74" in out                # published table wired in
    assert "dev.device=cpu" in out


def test_plan_is_the_jax_plan(tmp_path):
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    for name in ("pemp_stage1_pascal_split0_shot1",
                 "pemp_stage2_pascal_split0_shot1",
                 "rpmms_coco_split1_shot5", "baseline_pascal_split2_shot1"):
        (ckpts / f"{name}.pth").write_bytes(b"")
    args = (tmp_path, ckpts, ["baseline", "rpmms", "pemp_stage1",
                              "pemp_stage2"], [0, 1, 2, 3], [1, 5],
            ["pascal", "coco"], tmp_path / "md")
    ours, ref = verify_real_data.miou_plan(*args), jax_verify._miou_plan(*args)
    assert verify_real_data.PUBLISHED == jax_verify.PUBLISHED
    assert verify_real_data.TOLERANCE == jax_verify.TOLERANCE
    assert len(ours) == len(ref) == 2 * 4 * 2 * 4
    fields = ("family", "dataset", "split", "shot", "published", "ckpt",
              "s1_ckpt")
    for a, b in zip(ours, ref):
        assert [a[k] for k in fields] == [b[k] for k in fields]
        assert ("s1.id=100" in a["cmd"]) == ("s1.id=100" in b["cmd"]) \
            == (a["family"] == "pemp_stage2")
        assert a["cmd"][1:4] == ["-m", f"pemp_tpu_torch.entry.{a['family']}",
                                 "test"]
        same = [c for c in b["cmd"][3:] if "=" in c]
        assert same == [c for c in a["cmd"][4:] if c in same]


def _seeded_pth(path: Path, drop=()):
    model = verify_real_data.family_model("pemp_stage1", 1)
    model.reset_parameters(torch.Generator().manual_seed(3))
    sd = {k: v for k, v in model.state_dict().items() if k not in drop}
    torch.save(sd, path)


def test_phase_convert_on_a_seeded_reference_pth(tmp_path, capsys):
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    _seeded_pth(ckpts / "pemp_stage1_pascal_split0_shot1.pth")
    argv = ["--device", "cpu", "--ckpt-dir", str(ckpts), "--splits", "0",
            "--shots", "1", "--families", "pemp_stage1", "--data-root",
            str(tmp_path / "nodata")]
    assert verify_real_data.main(argv) == 0
    out = capsys.readouterr().out
    assert "[OK  ] 4 convert" in out and "round-trip bit-exact" in out, out
    _seeded_pth(ckpts / "pemp_stage1_pascal_split0_shot1.pth",
                drop=("ctr",))
    assert verify_real_data.main(argv) == 1
    assert "[FAIL] 4 convert" in capsys.readouterr().out


def test_eval_runs_a_planned_test_and_parses_its_miou(tmp_path, capsys):
    voc = tmp_path / "data" / "VOCdevkit" / "VOC2012"
    bench_input.fake_voc(voc, per_class=2, size=(40, 52))
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    _seeded_pth(ckpts / "pemp_stage1_pascal_split0_shot1.pth")
    status, detail = verify_real_data.phase_miou(
        tmp_path / "data", ckpts, ["pemp_stage1"], [0], [1], ["pascal"],
        run_eval=True, device="cpu",
        overrides=["data.test_n=2", "te.epochs=1", "data.height=33",
                   "data.width=33", "dev.precision=f32"])
    out = capsys.readouterr().out
    assert status == verify_real_data.OK and "got=" in out, (detail, out)
    got = float(out.split("got=")[1].split()[0])
    assert 0.0 <= got <= 100.0
    assert verify_real_data.parse_miou(
        "x mIoU: [1.0, 2.0] -> 1.50\nLoss: 0.6931, mIoU: 12.34, bIoU: 40.00"
    ) == 12.34
    assert verify_real_data.parse_miou("no result") is None
