"""Nothing under bench/ imports JAX or the JAX package, by top-level module
name compared whole (the port, `repro_torch`, is allowed); the plain
reference imports nothing of the port or of the harness."""
import ast
import sys
import types

import pytest

from bench import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_torch(path):
    assert _top_level_imports(path) <= {"__future__", "math", "typing", "torch"}


def test_the_run_check_compares_whole_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    import repro_torch  # noqa: F401  (its name begins with the JAX package's)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert harness.forbidden_modules() == ["repro"]
