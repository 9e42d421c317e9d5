"""The rest of ``tests/test_obs.py`` on the port's ``obs`` package, each
case held against the reference where it can run the same case: the trace
validator's rejections (the same error lists on the same events), the
tracer's event bound, histogram aggregates under windowing (with the
hypothesis property), the registry's kind conflict and counter
monotonicity, and the observability bundle's modes.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.obs import Observability as JObs
from repro.obs.registry import Histogram as JHist
from repro.obs.registry import MetricsRegistry as JReg
from repro.obs.tracer import Tracer as JTracer
from repro.obs.tracer import validate_events as j_validate
from repro_torch.obs import Observability as TObs
from repro_torch.obs.registry import Histogram as THist
from repro_torch.obs.registry import MetricsRegistry as TReg
from repro_torch.obs.tracer import _NULL_SPAN as T_NULL_SPAN
from repro_torch.obs.tracer import Tracer as TTracer
from repro_torch.obs.tracer import validate_events as t_validate


class FakeClock:
    """Deterministic injectable clock: each read advances 1 ms."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def _golden(tracer_cls):
    """One of everything the tracer can emit, on a deterministic clock."""
    tr = tracer_cls(clock=FakeClock())
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


MUTATIONS = [
    (lambda evs: evs.append({"ph": "Z", "name": "x", "pid": 1, "tid": 1,
                             "ts": 9e9}), "unknown ph"),
    (lambda evs: evs.append({"ph": "E", "name": "never-opened",
                             "pid": "repro", "tid": "lane 9", "ts": 9e9}),
     "no open 'B'"),
    (lambda evs: evs.append({"ph": "B", "name": "left-open", "pid": "repro",
                             "tid": "lane 9", "ts": 9e9}), "never closed"),
    (lambda evs: evs.append({"ph": "i", "name": "time-travel", "pid": "repro",
                             "tid": "m", "ts": -1.0}), "bad ts"),
    (lambda evs: evs.insert(0, {"ph": "i", "name": "unsorted", "pid": "repro",
                                "tid": "m", "ts": 9e9}), "not sorted"),
    (lambda evs: evs.append({"ph": "C", "name": "load", "pid": "repro",
                             "tid": "c", "ts": 9e9,
                             "args": {"depth": "three"}}), "numeric args"),
    (lambda evs: evs.append({"ph": "X", "name": "negative-span",
                             "pid": "repro", "tid": "m", "ts": 9e9,
                             "dur": -5}), "bad dur"),
]


def test_golden_traces_are_equal_and_valid():
    events = _golden(TTracer).events()
    assert events == _golden(JTracer).events()
    assert t_validate(events) == [] == j_validate(events)


@pytest.mark.parametrize("mutate, phrase", MUTATIONS)
def test_validator_rejects_malformed_events(mutate, phrase):
    events = _golden(TTracer).events()
    mutate(events)
    errors = t_validate(events)
    assert errors, f"expected a {phrase!r} error"
    assert any(phrase in e for e in errors), errors
    assert errors == j_validate(events)


def test_mismatched_be_names_rejected():
    found = []
    for tracer_cls, validate in ((TTracer, t_validate),
                                 (JTracer, j_validate)):
        tr = tracer_cls(clock=FakeClock())
        tr.begin("alpha", tid="t")
        tr.end("beta", tid="t")
        found.append(validate(tr.events()))
    assert any("does not match" in e for e in found[0]), found[0]
    assert found[0] == found[1]


def test_tracer_event_bound_counts_drops():
    got = []
    for tracer_cls, validate in ((TTracer, t_validate),
                                 (JTracer, j_validate)):
        tr = tracer_cls(clock=FakeClock(), max_events=2)
        for k in range(5):
            tr.instant(f"e{k}")
        assert len(tr._events) == 2 and tr.dropped == 3
        assert validate(tr.events()) == []  # truncated stays valid
        got.append(tr.events())
    assert got[0] == got[1]


def _check_hist_exact(values, window):
    hists = []
    for cls in (THist, JHist):
        h = cls("t", window=window)
        for v in values:
            h.observe(v)
        hists.append(h)
    h, j = hists
    assert h.count == len(values)
    seq_sum = 0.0  # the histogram's own left-to-right accumulation
    for v in values:
        seq_sum += float(v)
    assert h.sum == seq_sum
    assert h.min == min(values) and h.max == max(values)
    tail = values[-window:]
    assert list(h._window) == [float(v) for v in tail]
    assert h.percentile(50) == pytest.approx(float(np.percentile(tail, 50)))
    # the reference's histogram, fed the same values, holds the same numbers
    assert (h.count, h.sum, h.min, h.max) == (j.count, j.sum, j.min, j.max)
    assert list(h._window) == list(j._window)
    assert h.percentile(50) == j.percentile(50)
    assert h.snapshot() == j.snapshot()


def test_histogram_aggregates_exact_under_windowing():
    rng = np.random.default_rng(0)
    for _ in range(50):
        window = int(rng.integers(1, 12))
        count = int(rng.integers(1, 80))
        scale = float(10.0 ** rng.integers(-6, 7))
        values = (rng.standard_normal(count) * scale).tolist()
        _check_hist_exact(values, window)
    # adversarial shape: the true max leaves the window at once
    _check_hist_exact([1e9] + [0.001] * 100, window=4)


@given(values=st.lists(st.floats(allow_nan=False, allow_infinity=False,
                                 width=32), min_size=1, max_size=64),
       window=st.integers(1, 8))
@settings(max_examples=100, deadline=None)
def test_histogram_aggregates_exact_hypothesis(values, window):
    _check_hist_exact(values, window)


def test_registry_kind_conflict_and_counter_monotonicity():
    for cls in (TReg, JReg):
        reg = cls()
        reg.counter("x.y")
        with pytest.raises(TypeError):
            reg.gauge("x.y")
        with pytest.raises(ValueError):
            reg.counter("x.y").inc(-1)
        reg.counter("x.y").inc(2)
        assert reg.snapshot()["x.y"]["value"] == 2


def test_observability_bundle_modes():
    for obs_cls in (TObs, JObs):
        on, off = obs_cls.enabled(), obs_cls.disabled()
        assert on.tracer.enabled and not off.tracer.enabled
        with on.tracer.span("s"):
            pass
        assert len(on.tracer.events()) == 1
    assert TObs.disabled().tracer.span("s") is T_NULL_SPAN
    on_t, on_j = TObs.enabled(clock=FakeClock()), JObs.enabled(
        clock=FakeClock())
    for o in (on_t, on_j):
        with o.tracer.span("s", tid="m"):
            pass
    assert on_t.tracer.events() == on_j.tracer.events()
