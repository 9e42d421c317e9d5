"""``tools/crit_variants.py`` against the kernel source it edits.

The tool builds variants of ``kernels/csrc/frontier_crit.cu`` by changing
``#define``s and replacing the body of its ``nan_min`` or its unroll rule;
each edit must match the source exactly once, or the tool stops on the
card. It also builds the two-pass body the kernel replaced, from a source
of its own, to time the two in turns. Runs on the CPU: it only edits and
reads text.
"""
import importlib.util
import re
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
    defines, edits = TOOL.VARIANTS[name]
    src = SOURCE.read_text()
    out = TOOL.variant_source(src, defines, edits)
    for macro, value in defines.items():
        assert f"#define {macro} {value}" in out
    for old, new in edits:
        assert new in out and old not in out
    assert (out == src) == (not defines and not edits)


def test_variant_edit_that_does_not_apply_stops_the_tool():
    with pytest.raises(SystemExit, match="does not apply"):
        TOOL.variant_source(SOURCE.read_text(), {}, [("no such text", "")])
    with pytest.raises(SystemExit, match="no #define"):
        TOOL.variant_source(SOURCE.read_text(), {"NO_SUCH_MACRO": 1}, [])


def test_two_pass_body_matches_its_binding():
    """The old body's C entry point takes as many arguments as the tool
    binds, and keeps the fold of the shipped source."""
    src = TOOL.TWO_PASS_SOURCE
    sig = re.search(r'extern "C" int frontier_crit_two_pass_launch\((.*?)\)',
                    src, re.S)
    assert sig is not None
    assert sig.group(1).count(",") + 1 == len(TOOL.TWO_PASS_SIGNATURE[0])
    assert "min.NaN.f32" in src
    assert "frontier_crit_lanes_launch" not in src
