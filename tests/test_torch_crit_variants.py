"""``tools/crit_variants.py`` against the kernel source it edits.

The tool builds variants of ``kernels/csrc/frontier_crit.cu`` by replacing
the body of its ``nan_min``; each edit must match the source exactly once,
or the tool stops on the card. Runs on the CPU: it only edits text.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "frontier_crit.cu"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "crit_variants", ROOT / "tools" / "crit_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.mark.parametrize("name", sorted(TOOL.VARIANTS))
def test_variant_applies_to_the_source(name):
    edits = TOOL.VARIANTS[name]
    src = SOURCE.read_text()
    out = TOOL.variant_source(src, edits)
    for old, new in edits:
        assert new in out and old not in out
    assert (out == src) == (not edits)


def test_variant_edit_that_does_not_apply_stops_the_tool():
    with pytest.raises(SystemExit, match="does not apply"):
        TOOL.variant_source(SOURCE.read_text(), [("no such text", "")])
