"""Nothing that kdbench runs imports jax, jaxlib, flax or repro, compared by
whole top-level module name (``repro_torch`` is not ``repro``); the
reference imports no repro_torch either."""

import ast
from pathlib import Path

import pytest

from kdbench import catalog, harness

KDBENCH = catalog.ROOT / "kdbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(KDBENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(KDBENCH)))
def test_no_forbidden_import(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(KDBENCH).parts:
        assert "repro_torch" not in names and "kdbench" not in names


def test_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom reprox import y\nimport jaxtyping\n")
    assert top_level_imports(f) & FORBIDDEN == set()
    f.write_text("from repro.core import x\n")
    assert top_level_imports(f) & FORBIDDEN == {"repro"}


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.loaded_forbidden() == ["jax"]
