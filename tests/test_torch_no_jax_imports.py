"""Static scan: nothing under pemp_tpu_torch/ and nothing in chip_smoke.py,
kernel_times.py or input_times.py imports jax, flax or pemp_tpu (any
module of it), nor msgpack or pymongo; the launch presets
(``pemp_tpu_torch/scripts/*.sh``) run the port's entries and name no JAX
setting, module or script (the port reads the JAX checkpoints and writes the
Mongo documents itself); the COCO rasterizer is the port's own C++ copy. A sys.modules check would prove nothing here,
because jax is preloaded in this environment
(``tests/test_torch_checkpoint_msgpack.py`` runs one in a fresh process).
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pemp_tpu", "msgpack",
             "pymongo")
FILES = sorted((ROOT / "pemp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_times.py", ROOT / "input_times.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_the_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "pemp_tpu_torch/ops/kernels/mpm.py" in names
    for new in ("core/experiment.py", "models/registry.py",
                "models/baseline.py", "models/panet.py", "entry/baseline.py",
                "entry/panet.py", "data/history.py", "models/canet.py",
                "models/rpmms.py", "models/pfenet.py", "entry/canet.py",
                "entry/rpmms.py", "entry/pfenet.py", "utils/pretrained.py",
                "utils/observers.py", "core/visualize.py",
                "core/checkpoint.py", "data/transforms.py", "data/pascal.py",
                "data/coco.py", "data/coco_index.py", "data/mask_ops.py",
                "data/episodic.py", "tools/export_serving.py",
                "tools/soak_run.py", "tools/exp_int8_conv.py",
                "tools/exp_int8_blend.py", "tools/exp_cudnn_flags.py",
                "tools/convert_reference_ckpt.py",
                "tools/export_reference_ckpt.py"):
        assert f"pemp_tpu_torch/{new}" in names
    assert {"chip_smoke.py", "kernel_times.py", "input_times.py"} <= names
    assert len(names) > 20


def test_the_rasterizer_builds_from_the_port_copy():
    """The COCO rasterizer compiles the port's own copy of the C++ source
    into the port's build directory, never the JAX package's ``native/``
    (a static check: nothing is built here)."""
    from pemp_tpu_torch.data import mask_ops
    source = ROOT / "pemp_tpu_torch" / "data" / "native" / "coco_mask.cpp"
    assert mask_ops.SOURCE == source and source.exists()
    assert mask_ops.lib_path().parent == ROOT / "build" / "pemp_tpu_torch"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_pemp_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for module in _imported_modules(tree):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {module}"


SCRIPTS = sorted((ROOT / "pemp_tpu_torch" / "scripts").glob("*.sh"))
JAX_WORDS = re.compile(r"\bjax\b|JAX_|XLA_|\bflax\b|pemp_tpu(?!_torch)|"
                       r"\bentry/|tpu\.", re.I)


def test_the_scan_sees_the_presets():
    assert {p.stem for p in SCRIPTS} == {
        "launch", "baseline", "canet", "panet", "pemp_stage1",
        "pemp_stage2", "pfenet", "rpmms"}


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_preset_runs_the_port_only(path):
    code = [ln for ln in path.read_text().splitlines()
            if not ln.lstrip().startswith("#")]
    for ln in code:
        assert not JAX_WORDS.search(ln), f"{path.name}: {ln}"
    assert any("launch.sh" in ln or "pemp_tpu_torch.entry." in ln
               for ln in code)
