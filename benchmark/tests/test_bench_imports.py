"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's ``pemp_tpu_torch`` is not
``pemp_tpu``); the reference imports nothing of the program; no file
imports the program's tools."""

from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pemp_tpu"}


def imports(path: Path):
    """Every module name a file imports (absolute), with the line."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno
            for a in node.names:
                yield f"{node.module}.{a.name}", node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value, node.lineno


def files():
    return sorted(BENCH.rglob("*.py"))


def test_no_jax_anywhere():
    found = [(p.name, n, line) for p in files() for n, line in imports(p)
             if n.split(".")[0] in FORBIDDEN]
    assert not found


def test_reference_imports_nothing_of_the_program():
    ref = BENCH / "reference"
    found = [(p.name, n) for p in ref.rglob("*.py") for n, _ in imports(p)
             if n.split(".")[0] == "pemp_tpu_torch"]
    assert not found


def test_no_tools():
    found = [(p.name, n) for p in files() for n, _ in imports(p)
             if n.startswith("pemp_tpu_torch.tools")]
    assert not found


def test_the_check_is_whole_name():
    names = FORBIDDEN
    assert "pemp_tpu_torch".split(".")[0] not in names
    assert "pemp_tpu.models".split(".")[0] in names


def test_the_run_refuses_jax_after_the_window(monkeypatch):
    import sys
    import types
    from benchmark import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax.numpy"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert "pemp_tpu_torch" not in run.forbidden_modules()
