"""The port's SSSP entry points against the reference's scripts:
``repro_torch.examples.{quickstart,sssp_pipeline,batch_serving}`` with
``--device cpu`` beside ``examples/*.py`` on the same arguments, both in
this process (the reference through ``runpy`` with ``sys.argv`` patched,
stdout captured). One parser reads both outputs and every field but the
times must be equal: phases, sum |F|, the verdicts, the graph sizes, the
spot-checked rows. ``sssp_pipeline`` also runs with its padded-view
budget forced to 0 (the degree-sliced views) and must print the same.
Each twin's module must import neither ``jax`` nor ``repro``.
"""
import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.examples import (
    batch_serving,
    quickstart,
    sssp_pipeline,
    tensor_bytes,
)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def run_reference(script: str, args: list[str]) -> list[str]:
    """The reference script's printed lines, run in this process."""
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = [script] + args
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / script),
                           run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue().splitlines()


def run_twin(module, args: list[str]) -> list[str]:
    """The twin's printed lines on the CPU; its record must hold them."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = module.main(args + ["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert rec.lines == lines
    return lines


def imports_of(module: str) -> set[str]:
    """The top-level packages a fresh interpreter holds after importing
    ``module``."""
    code = (f"import sys; import {module}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    return set(out.stdout.split())


@pytest.mark.parametrize("name", ["quickstart", "sssp_pipeline",
                                  "batch_serving"])
def test_twin_imports_no_jax(name):
    held = imports_of(f"repro_torch.examples.{name}")
    assert "repro_torch" in held
    assert not held & {"jax", "jaxlib", "repro"}, sorted(held)


# ---- quickstart: no time in its output, so every line is equal ----------

def test_quickstart_prints_the_reference_lines():
    want = run_reference("quickstart.py", [])
    got = run_twin(quickstart, [])
    assert got == want
    assert len(got) == 10 and got[2].split()[-1] == "True"


# ---- sssp_pipeline ------------------------------------------------------

HEADER = re.compile(r"^== (.+): n=(\d+) m=(\d+) \(sequential Dijkstra "
                    r"\d+ ms\)$")
ENGINE = re.compile(r"^  (.{34}) phases=\s*(\d+) time=\s*[\d.]+ ms  "
                    r"speedup-vs-seq=x\s*[\d.]+ correct=(True|False)$")
VIEW = re.compile(r"^  view=(padded|sliced) bytes=(\d+)$")


def parse_pipeline(lines: list[str]) -> tuple[list, list]:
    """(families, views): each family as (name, n, m, [(engine index,
    phases, correct), ...]); engines by position, since the static
    engine's label names the kernels of its package; the view lines (the
    port's only)."""
    families, views = [], []
    for line in lines:
        if not line:
            continue
        if m := HEADER.match(line):
            families.append((m[1], int(m[2]), int(m[3]), []))
        elif m := ENGINE.match(line):
            engines = families[-1][3]
            engines.append((len(engines), int(m[2]), m[3] == "True"))
        elif m := VIEW.match(line):
            views.append((m[1], int(m[2])))
        else:
            raise AssertionError(f"unparsed line: {line!r}")
    return families, views


@pytest.fixture(scope="module")
def pipeline_reference():
    return parse_pipeline(run_reference("sssp_pipeline.py",
                                        ["--n", "2000"]))[0]


def test_sssp_pipeline_matches_the_reference(pipeline_reference):
    got, views = parse_pipeline(run_twin(sssp_pipeline, ["--n", "2000"]))
    assert got == pipeline_reference
    assert [f[0] for f in got] == ["uniform G(2000,10/n)", "kronecker 2^10",
                                   "road grid", "web graph"]
    assert all(ok for f in got for _, _, ok in f[3])
    assert all(len(f[3]) == 4 for f in got)
    assert [v for v, _ in views] == ["padded"] * 4  # all fit at n = 2000


def test_sssp_pipeline_sliced_views_print_the_same(pipeline_reference,
                                                   monkeypatch):
    monkeypatch.setattr(sssp_pipeline, "view_budget", lambda dev: 0)
    got, views = parse_pipeline(run_twin(sssp_pipeline, ["--n", "2000"]))
    assert got == pipeline_reference
    assert [v for v, _ in views] == ["sliced"] * 4
    assert all(b > 0 for _, b in views)


def test_padded_bytes_counts_the_views_it_predicts():
    from repro_torch.core import to_ell_in, to_ell_out
    from repro_torch.graphs import webgraph

    g = webgraph(500, 8, seed=0, device="cpu")
    built = tensor_bytes(to_ell_in(g), to_ell_out(g))
    assert sssp_pipeline.padded_bytes(g) == built


# ---- batch_serving --------------------------------------------------------

REQUEST = re.compile(r"^request (\d+): B=(\d+) answered in\s+[\d.]+ ms "
                     r"\(\s*[\d.]+ q/s\), phases=(\d+), spot-check row (\d+) "
                     r"vs Dijkstra: (OK|MISMATCH)$")
SERVED = re.compile(r"^served (\d+) queries in \d+ ms -> [\d.]+ queries/sec "
                    r"sustained$")


def parse_batch(lines: list[str]) -> list:
    out = []
    for line in lines:
        if not line:
            continue
        if line.startswith("serving road grid"):
            out.append(line)
        elif m := REQUEST.match(line):
            out.append(tuple(m.groups()))
        elif m := SERVED.match(line):
            out.append(int(m[1]))
        else:
            raise AssertionError(f"unparsed line: {line!r}")
    return out


@pytest.mark.parametrize("args", [
    ["--n", "900", "--batch", "8", "--requests", "2"],
    ["--n", "400", "--batch", "3", "--requests", "3"],
])
def test_batch_serving_matches_the_reference(args):
    want = parse_batch(run_reference("batch_serving.py", args))
    got = parse_batch(run_twin(batch_serving, args))
    assert got == want
    assert all(r[-1] == "OK" for r in got[1:-1])
    assert len(got) == int(args[-1]) + 2
