"""Static scan: nothing under pemp_tpu_torch/ and nothing in chip_smoke.py
or kernel_times.py imports jax, flax or pemp_tpu (any module of it). A sys.modules check
would prove nothing here, because jax is preloaded in this environment.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pemp_tpu")
FILES = sorted((ROOT / "pemp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]


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
                "entry/rpmms.py", "entry/pfenet.py"):
        assert f"pemp_tpu_torch/{new}" in names
    assert "chip_smoke.py" in names and len(names) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_pemp_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for module in _imported_modules(tree):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {module}"
