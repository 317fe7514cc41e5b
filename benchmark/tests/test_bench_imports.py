"""No module under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
``splatam_torch`` begins with the JAX package's first letters)."""
import ast

import pytest

from benchmark.core.guard import FORBIDDEN
from benchmark.core.manifest import BENCH

SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "splatam_torch" not in top_level_imports(path)


def test_whole_name_comparison():
    import sys

    from benchmark.core.guard import forbidden_modules

    sys.modules.setdefault("splatam_torch_lookalike", sys)
    try:
        assert "splatam_torch_lookalike" not in forbidden_modules()
    finally:
        del sys.modules["splatam_torch_lookalike"]
