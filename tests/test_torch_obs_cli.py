"""``python -m repro_torch.obs`` against ``python -m repro.obs``.

``main([...])`` of both packages runs on the same files and must print the
same text and return the same code: ``validate`` on a valid trace, a
malformed one, a bare-array one and a missing one; ``export`` of a trace
(both then validate the same exported bytes); ``dashboard`` on a registry
snapshot, on a portfolio ledger (the reference's case of
``tests/test_obs.py``), on a ledger the port's probe wrote, on a mixed
file and on one that is not an object. Also the port's ``load_trace`` and
``validate_trace_file``, and the module run as ``python -m``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro.obs import MetricsRegistry as JReg
from repro.obs import Tracer as JTracer
from repro.obs import tracer as jtracer
from repro.obs.__main__ import main as j_main
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import config as tcfg
from repro_torch.obs import MetricsRegistry as TReg
from repro_torch.obs import Tracer as TTracer
from repro_torch.obs import tracer as ttracer
from repro_torch.obs.__main__ import main as t_main
from repro_torch.serving import EngineCandidate, measure_portfolio

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _golden(Tracer):
    tr = Tracer(clock=FakeClock())
    tr.name_thread("lane 0", "serving lane 0")
    tr.name_thread("scheduler", "scheduler")
    tr.begin("src 7", cat="request", tid="lane 0", source=7)
    with tr.span("step", cat="step", tid="scheduler", busy=1):
        with tr.span("chunk", cat="chunk", tid="scheduler"):
            pass
    tr.counter("scheduler load", {"queue_depth": 3, "busy_lanes": 1})
    tr.instant("cache hit", cat="request", tid="scheduler", source=7)
    tr.end("src 7", cat="request", tid="lane 0", phases=12)
    return tr


def _both(capsys, argv):
    """(rc, stdout) of the reference's and the port's main on ``argv``."""
    out = []
    for main in (j_main, t_main):
        capsys.readouterr()
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    assert out[1] == out[0]
    return out[1]


def test_tracers_write_the_same_trace(tmp_path):
    a, b = tmp_path / "j.json", tmp_path / "t.json"
    _golden(JTracer).export(str(a))
    _golden(TTracer).export(str(b))
    assert a.read_text() == b.read_text()
    assert ttracer.load_trace(str(b)) == jtracer.load_trace(str(b))
    assert ttracer.validate_trace_file(str(b)) == []


def test_cli_validate_and_export_match(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    _golden(TTracer).export(str(trace))
    assert _both(capsys, ["validate", str(trace)])[0] == 0
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(json.loads(trace.read_text())["traceEvents"]))
    assert _both(capsys, ["validate", str(bare), str(trace)])[0] == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "E", "name": "x", "pid": 1, "tid": 1, "ts": 0}]}))
    rc, out = _both(capsys, ["validate", str(bad), str(trace)])
    assert rc == 1 and "INVALID" in out
    rc, out = _both(capsys, ["validate", str(tmp_path / "missing.json")])
    assert rc == 1
    weird = tmp_path / "weird.json"
    weird.write_text('{"traceEvents": 3}')
    assert _both(capsys, ["validate", str(weird)])[0] == 1
    assert ttracer.validate_trace_file(str(weird)) == \
        jtracer.validate_trace_file(str(weird))

    # export: the same text, the same bytes written, and both validate them
    unsorted = tmp_path / "unsorted.json"
    events = json.loads(trace.read_text())["traceEvents"]
    unsorted.write_text(json.dumps(events[::-1]))
    outs = []
    for main, name in ((j_main, "j_rt.json"), (t_main, "t_rt.json")):
        capsys.readouterr()
        assert main(["export", str(unsorted), "-o",
                     str(tmp_path / name)]) == 0
        outs.append(capsys.readouterr().out.replace(name, "rt.json"))
    assert outs[0] == outs[1]
    assert (tmp_path / "j_rt.json").read_text() == \
        (tmp_path / "t_rt.json").read_text()
    assert _both(capsys, ["validate", str(tmp_path / "t_rt.json")])[0] == 0
    assert len(ttracer.load_trace(str(tmp_path / "t_rt.json"))) == \
        len(events)
    # an unexportable trace: the same problems, rc 1
    rc, out = _both(capsys, ["export", str(bad), "-o",
                             str(tmp_path / "never.json")])
    assert rc == 1 and not (tmp_path / "never.json").exists()


def test_cli_dashboard_on_a_registry_snapshot(tmp_path, capsys):
    snaps = []
    for Reg in (JReg, TReg):
        reg = Reg()
        reg.counter("serving.completed", "done").inc(3)
        reg.gauge("serving.busy_lanes").set(2.5)
        h = reg.histogram("serving.latency_s", window=4)
        for v in (0.25, 0.5, 1e-5, 3e6, 0.75):
            h.observe(v)
        reg.histogram("kernel.launch.relax")
        snaps.append(reg.to_json())
    assert snaps[0] == snaps[1]
    report = tmp_path / "report.json"
    report.write_text(snaps[1])
    rc, out = _both(capsys, ["dashboard", str(report)])
    assert rc == 0 and "serving.completed" in out and "p99" in out
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert "(empty report)" in _both(capsys, ["dashboard", str(empty)])[1]
    arr = tmp_path / "arr.json"
    arr.write_text("[1, 2]")
    assert _both(capsys, ["dashboard", str(arr)])[0] == 1


def test_cli_dashboard_portfolio_view(tmp_path, capsys):
    ledger = {
        "portfolio:flat-uniform-shallow:b4:delta@x2:sliced": {
            "qps": 40.0, "settle_attribution": {"light": 6, "heavy": 2},
        },
        "portfolio:flat-uniform-shallow:b4:instatic|outstatic:padded": {
            "qps": 10.0,
            "settle_attribution": {"instatic": 9, "outstatic": 1},
        },
        "portfolio:skew-uniform-shallow:b4:delta@x2:sliced": {
            "qps": 20.0, "settle_attribution": {"light": 2, "heavy": 6},
        },
        "portfolio:flat-uniform-shallow:b8:in|out:padded": {"qps": 5.0},
        "portfolio:broken-key": {"qps": 1.0},
        "cpu:slicing:in:n64": {"boundaries": [8, 32]},
    }
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps(ledger))
    rc, out = _both(capsys, ["dashboard", str(path)])
    assert rc == 0
    assert "family flat-uniform-shallow" in out
    assert "family skew-uniform-shallow" in out
    assert "delta@x2:sliced" in out and "win 100%" in out
    assert "light=0.75" in out and "heavy=0.75" in out
    assert "drift 0.25" in out and "drift 0.00" in out
    assert "cpu:slicing" not in out
    # a registry snapshot and portfolio records in one file: both views
    mixed = dict(ledger)
    mixed["serving.completed"] = {"kind": "counter", "value": 3}
    path.write_text(json.dumps(mixed))
    out = _both(capsys, ["dashboard", str(path)])[1]
    assert "serving.completed" in out and "== portfolio" in out


def test_cli_dashboard_on_a_ledger_the_probe_wrote(tmp_path, capsys):
    g = TGen.uniform_gnp(48, 0.15, seed=3, device="cpu")
    led = tcfg.TuningLedger()
    for lanes in (2, 3):
        measure_portfolio(g, lanes=lanes, candidates=(
            EngineCandidate("instatic|outstatic", "padded"),
            EngineCandidate("in|out", "sliced"),
            EngineCandidate("delta", "padded", delta_scale=2.0)),
            ledger=led, repeats=1)
    path = led.save(str(tmp_path / "ledger.json"))
    rc, out = _both(capsys, ["dashboard", path])
    assert rc == 0 and "(lane counts: 2, 3)" in out
    for eng in ("instatic|outstatic:padded", "in|out:sliced",
                "delta@x2:padded"):
        assert eng in out


def test_python_dash_m_runs_the_port_cli(tmp_path):
    trace = tmp_path / "trace.json"
    _golden(TTracer).export(str(trace))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", str(trace)],
        capture_output=True, text=True, env=env, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    n = len(ttracer.load_trace(str(trace)))
    assert res.stdout == f"{trace}: ok ({n} events)\n"
    assert "jax" not in res.stderr
