"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``pollen_tpu_torch`` begins with ``pollen_tpu``),
and the reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "pollen_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    assert not set(_imports(path)) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference.py", HERE / "trace.py", HERE / "roofline.py"):
        assert set(_imports(path)) <= {"__future__", "numpy", "collections", "json"}


def test_loaded_modules_hold_no_jax():
    """What the harness loads, in a fresh process (the test process
    itself may hold JAX from other suites)."""
    code = ("import sys, portbench.harness, portbench.__main__; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert "pollen_tpu_torch" in loaded
    assert not loaded & JAX


def test_forbidden_modules(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pollen_tpu_torch.fake", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "pollen_tpu.fake", object())
    assert "pollen_tpu" in harness.forbidden_modules()
