"""The port's serving entry points against the reference's scripts:
``repro_torch.examples.continuous_serving`` (plain, with ``--trace`` /
``--report``, and under ``--chaos 0``) and ``distributed_serving`` with
``--device cpu``, beside ``examples/*.py`` on the same arguments.

One parser reads both outputs. Every field but the times must be equal:
each completion's id, source, lane, phases and cache / coalesced tag, the
metrics report without its time fields, the dashboard's counters, the
registry snapshot without its histograms of seconds, the trace's event
count (and the twin's trace file must pass the reference's validator).
Under ``--chaos`` both servers read a virtual clock, so the whole output,
times included, must be equal: the fault plan, the faults that fired and
the recovery counts.

``distributed_serving``: the reference forces 8 host devices, which needs
``XLA_FLAGS`` before ``jax`` is imported, so it runs in a subprocess; the
twin runs in a gloo world of 2 (this process as rank 0). The world's size
shows in two header fields, the ranks and ``n_pad``, and each is held to
the block sizes of its world (8 blocks there, 2 here).
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch.core.distributed import block_sizes
from repro_torch.examples import continuous_serving, distributed_serving
from test_torch_examples_sssp import (
    ROOT,
    SRC,
    imports_of,
    run_reference,
    run_twin,
)

REQ = re.compile(r"^  req\s+(\d+) src=(\d+)\s+done in\s+[\d.]+ ms "
                 r"\((.+)\)$")
TRACE = re.compile(r"^trace: (\d+) events -> (.+) \(open in "
                   r"https://ui.perfetto.dev\)$")
TIME_KEYS = re.compile(r"(_s|_qps)$")


def untimed(report: dict) -> dict:
    """A metrics report or registry snapshot without its time fields."""
    return {k: v for k, v in report.items() if not TIME_KEYS.search(k)}


def parse_serving(lines: list[str]) -> dict:
    """The fields of a serving script's output: its lines other than the
    completions, the metrics JSON and the dashboard (``text``), the
    completions as (id, source, tag), the metrics without times, the
    trace's event count and the dashboard's lines without the histograms
    of seconds."""
    out = {"text": [], "requests": [], "metrics": None, "events": None,
           "board": []}
    i = 0
    while i < len(lines):
        line = lines[i]
        if m := REQ.match(line):
            out["requests"].append(m.groups())
        elif line == "{":  # the metrics report, to its closing brace
            j = lines.index("}", i)
            out["metrics"] = untimed(json.loads("\n".join(lines[i:j + 1])))
            i = j
        elif m := TRACE.match(line):
            out["events"] = int(m[1])
        elif line.startswith("report: "):
            out["text"].append("report:")
        elif line.startswith("== "):  # the dashboard runs to the end
            board, skip = [], False
            for row in lines[i:]:
                name = row.split()[0] if row.startswith("  serving.") else ""
                if name:
                    skip = name.endswith("_s")
                if not skip or row.startswith("=="):
                    board.append(row)
            out["board"] = board
            break
        else:
            out["text"].append(line)
        i += 1
    return out


@pytest.mark.parametrize("name", ["continuous_serving",
                                  "distributed_serving"])
def test_twin_imports_no_jax(name):
    held = imports_of(f"repro_torch.examples.{name}")
    assert "repro_torch" in held
    assert not held & {"jax", "jaxlib", "repro"}, sorted(held)


@pytest.mark.parametrize("args", [
    ["--n", "400", "--queries", "16"],
    ["--n", "300", "--queries", "12", "--lanes", "3",
     "--phases-per-step", "5", "--hot-frac", "0.6", "--seed", "2"],
])
def test_continuous_serving_matches_the_reference(args):
    want = parse_serving(run_reference("continuous_serving.py", args))
    got = parse_serving(run_twin(continuous_serving, args))
    assert got == want
    n_q = int(args[args.index("--queries") + 1])
    assert len(got["requests"]) == got["metrics"]["queries_completed"] == n_q
    assert got["text"][-1] == f"all {n_q} answers bit-exact vs " \
                              "run_phased_static"


def test_continuous_serving_with_trace_and_report(tmp_path):
    from repro.obs.tracer import validate_trace_file

    def args(side):
        return ["--n", "400", "--queries", "16",
                "--trace", str(tmp_path / f"{side}.json"),
                "--report", str(tmp_path / f"{side}_report.json")]

    want = parse_serving(run_reference("continuous_serving.py", args("ref")))
    got = parse_serving(run_twin(continuous_serving, args("port")))
    assert got == want
    assert got["events"] > 0 and got["board"]
    assert validate_trace_file(str(tmp_path / "port.json")) == []
    snaps = []
    for side in ("ref", "port"):
        with open(tmp_path / f"{side}_report.json") as f:
            snaps.append(untimed(json.load(f)))
    assert snaps[0] == snaps[1]


def test_continuous_serving_under_chaos_prints_every_line_alike():
    args = ["--n", "400", "--queries", "16", "--chaos", "0"]
    want = run_reference("continuous_serving.py", args)
    got = run_twin(continuous_serving, args)
    assert got == want
    text = "\n".join(got)
    assert "chaos plan (seed 0):" in text and "\nrecovery: " in text
    fired = re.search(r"chaos: (\d+) backend fault", text)
    assert fired and int(fired[1]) > 0


def test_distributed_serving_matches_the_reference():
    args = ["--n", "100", "--queries", "4", "--lanes", "2"]
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "distributed_serving.py")]
        + args, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"))
    got_lines = run_twin(distributed_serving, args + ["--ranks", "2"])
    want_lines, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0
    want = parse_serving(want_lines.splitlines())
    got = parse_serving(got_lines)
    head = re.compile(r"^serving road grid (\d+)x\1 \(n=(\d+), n_pad=(\d+)\) "
                      r"sharded over (\d+) cpu (?:devices|ranks), (.+)$")
    (w_head, *w_rest), (g_head, *g_rest) = want["text"], got["text"]
    wm, gm = head.match(w_head), head.match(g_head)
    # side, n; lanes, k, schedule
    assert wm.group(1, 2, 5) == gm.group(1, 2, 5)
    n = int(gm[2])
    assert (int(wm[4]), int(wm[3])) == (8, block_sizes(n, 8, 8)[1])
    assert (int(gm[4]), int(gm[3])) == (2, block_sizes(n, 2, 8)[1])
    assert g_rest == w_rest
    assert got["requests"] == want["requests"]
    assert got["metrics"] == want["metrics"]
    assert len(got["requests"]) == 4
