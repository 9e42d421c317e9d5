"""``tools/push_variants.py`` against the kernel source it edits.

The tool builds variants of ``kernels/csrc/ell_push.cu`` by replacing
``#define``s and short runs of text; each must still match the source
exactly once, or the tool stops on the card. Runs on the CPU: it only edits
text.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ell_push.cu"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "push_variants", ROOT / "tools" / "push_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.mark.parametrize("name", sorted(TOOL.VARIANTS))
def test_variant_applies_to_the_source(name):
    defines, edits, _ = TOOL.VARIANTS[name]
    src = SOURCE.read_text()
    out = TOOL.variant_source(src, defines, edits)
    for macro, value in defines.items():
        assert f"#define {macro} {value}" in out
    for old, new in edits:
        assert new in out
    assert (out == src) == (not defines and not edits)


def test_variant_edit_that_does_not_apply_stops_the_tool():
    with pytest.raises(SystemExit, match="does not apply"):
        TOOL.variant_source(SOURCE.read_text(), {}, [("no such text", "")])
    with pytest.raises(SystemExit, match="no #define"):
        TOOL.variant_source(SOURCE.read_text(), {"NO_SUCH_MACRO": 1}, [])
