"""Import hygiene of the PyTorch port: no module of ``src/repro_torch/``,
nor ``chip_smoke.py`` or the port's ``tools/``, imports ``jax`` or the
reference package ``repro`` (``repro_torch`` itself is allowed)."""
import ast
import os
import subprocess
import sys
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
            "backends.py", "interop.py", "scheduler.py", "queue.py",
            "metrics.py", "cache.py", "point.py", "timer.py", "registry.py",
            "tracer.py", "delta_stepping.py", "phased.py", "oracle.py",
            "telemetry.py", "faults.py", "resilience.py", "config.py",
            "__main__.py", "distributed.py", "mesh.py", "sssp_run.py",
            "layers.py", "transformer.py", "base.py"} <= names
    obs = ROOT / "src" / "repro_torch" / "obs"
    assert {obs / f for f in ("__init__.py", "__main__.py", "timer.py",
                              "registry.py", "tracer.py",
                              "telemetry.py")} <= set(FILES)
    serving = ROOT / "src" / "repro_torch" / "serving"
    assert {serving / f for f in ("faults.py", "resilience.py",
                                  "backends.py")} <= set(FILES)
    pkg = ROOT / "src" / "repro_torch"
    assert {pkg / "models" / "layers.py", pkg / "models" / "transformer.py",
            pkg / "configs" / "base.py"} <= set(FILES)
    assert {pkg / "optim" / "adamw.py", pkg / "data" / "pipeline.py",
            pkg / "checkpoint" / "manager.py",
            pkg / "runtime" / "train_loop.py",
            pkg / "launch" / "train.py"} <= set(FILES)
    assert {pkg / "sharding" / "partition.py", pkg / "sharding" / "comm.py",
            pkg / "launch" / "steps.py", pkg / "launch" / "collectives.py",
            pkg / "runtime" / "elastic.py"} <= set(FILES)
    archs = {p.stem for p in (pkg / "configs").glob("*.py")}
    assert len(archs - {"__init__", "base"}) == 10, sorted(archs)


@pytest.mark.parametrize("module", [
    "repro_torch.serving.faults", "repro_torch.serving.resilience",
    "repro_torch.serving.backends", "repro_torch.kernels.config",
    "repro_torch.obs.__main__", "repro_torch.core.distributed",
    "repro_torch.launch.mesh", "repro_torch.launch.sssp_run",
    "repro_torch.configs", "repro_torch.models", "repro_torch.interop",
    "repro_torch.optim.adamw", "repro_torch.data.pipeline",
    "repro_torch.checkpoint.manager", "repro_torch.runtime.train_loop",
    "repro_torch.launch.train", "repro_torch.sharding.partition",
    "repro_torch.sharding.comm", "repro_torch.launch.steps",
    "repro_torch.runtime.elastic", "repro_torch.launch.collectives"])
def test_new_modules_import_without_jax(module):
    """Each module of the portfolio, fault and resilience tiers, the CLI,
    the sharded stepper, the launchers and the LM substrate (serving,
    training and the mesh) imports in a fresh interpreter that has no ``jax`` or
    ``repro`` module loaded afterwards."""
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert res.returncode == 0, res.stderr


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
