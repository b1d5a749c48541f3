"""No module the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PACKAGE = harness.PACKAGE
SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax_anywhere(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), path


def test_reference_imports_no_program():
    for path in sorted((PACKAGE / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch",
                        "portbench"}, (path, tops)
        assert not any(n.startswith("portbench.") and not n.startswith("portbench.reference")
                       for n in _imports(path)), path


def test_a_run_loads_no_forbidden_module():
    code = ("from portbench.tests import tiny; from portbench import harness; "
            "tiny.run('ml1m-train'); tiny.run('ml1m-serve'); print(harness.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
