"""Import hygiene of the PyTorch port: no module of ``src/repro_torch/``,
nor ``chip_smoke.py`` or the port's ``tools/``, imports ``jax`` or the
reference package ``repro`` (``repro_torch`` itself is allowed)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
] + sorted((ROOT / "tools").glob("*.py"))
BANNED = ("jax", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED


def test_port_files_exist():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "static_engine.py", "policies.py", "criteria.py",
            "ell_relax.py", "frontier_crit.py", "ell_key_min.py",
            "ell_relax_keys.py", "ell_sliced.py", "ops.py", "ref.py",
            "backends.py", "interop.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_banned_imports():
    src = "import jax.numpy as jnp\nfrom repro.core import graph\n" \
          "from repro_torch.core import graph\nimport jaxlib\n"
    found = [m for m in _imported_modules(ast.parse(src)) if _banned(m)]
    assert found == ["jax.numpy", "repro.core"]
