"""The port's continuous batcher against the JAX reference's, on one trace.

Both packages' ``ContinuousBatcher`` serve the same script of submissions,
steps, drains and closes, each with its own copy of one injected clock
(it advances on every call, so equal timings mean the scheduling loops
call the clock alike). Compared: the retired requests in order, each
with its lane, outcome, flags, timestamps and row (bit for bit); every
raise; ``metrics.report()`` in full; the cache's counters; and, with
observability on, the registry's snapshot and the trace's events. The
reference runs its plain twins (``use_pallas=False``); no tolerance.

Also here: the cache (``graph_key`` equal across packages, ``pad_to``
included; snapshots restore across packages; LRU, read-only rows, no leak
across graphs or criteria) and the obs surface (the port's trace passes
the reference's validator).
"""
import dataclasses
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import generators as JGen
from repro.obs import Observability as JObs
from repro.obs import validate_events as j_validate_events
from repro.serving import Backpressure as JBackpressure
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import DistCache as JCache
from repro.serving import DrainStalled as JDrainStalled
from repro.serving import ServerClosed as JServerClosed
from repro.serving import StaticBackend as JBackend
from repro.serving import graph_key as j_graph_key
from repro.serving.cache import _Entry as JEntry
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.obs import Observability as TObs
from repro_torch.obs import validate_events as t_validate_events
from repro_torch.serving import (
    ArrivalQueue,
    Backpressure,
    DrainStalled,
    ServerClosed,
    ServingMetrics,
)
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import DistCache as TCache
from repro_torch.serving import StaticBackend as TBackend
from repro_torch.serving import graph_key as t_graph_key
from repro_torch.serving.cache import _Entry as TEntry

torch.set_num_threads(1)

PLANS = ["instatic|outstatic", "in|out"]
LAYOUTS = ["padded", "sliced"]
REQ_FIELDS = ("req_id", "source", "target", "priority", "lane", "outcome",
              "phases", "cache_hit", "coalesced", "downgraded",
              "served_stale", "t_arrival", "t_admitted", "t_completed",
              "fail_reason", "retries")
CACHE_STATS = ("hits", "misses", "evictions", "corrupt_dropped",
               "stale_misses")


@pytest.fixture(scope="module")
def graphs():
    return {
        "gnp": (JGen.uniform_gnp(120, 8 / 120, seed=31),
                TGen.uniform_gnp(120, 8 / 120, seed=31, device="cpu")),
        "grid": (JGen.grid_road(9, 8, seed=32),
                 TGen.grid_road(9, 8, seed=32, device="cpu")),
    }


class Clock:
    """Advances 0.25 on every call (and on ``advance``): one per server."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t

    def advance(self, dt):
        self.t += dt


def _pair(gj, gt, *, criterion=None, layout=None, obs=False, cache=None,
          **kw):
    """The reference's and the port's batcher over one configuration."""
    servers = []
    for pkg in ("j", "t"):
        clock = Clock()
        args = dict(kw, clock=clock)
        if cache is not None:
            args["cache"] = (JCache if pkg == "j" else TCache)(capacity=cache)
        if obs:
            args["obs"] = (JObs if pkg == "j" else TObs).enabled(clock=clock)
        if layout is not None:
            be = dict(criterion=criterion or "instatic|outstatic",
                      layout=layout,
                      point_queries=kw.get("point_queries", False))
            args["backend"] = (JBackend(gj, use_pallas=False, **be)
                               if pkg == "j" else
                               TBackend(gt, device="cpu", **be))
        elif criterion is not None:
            args["criterion"] = criterion
        if pkg == "j" and layout is None:
            args["use_pallas"] = False
        servers.append((JBatcher if pkg == "j" else TBatcher)(
            gj if pkg == "j" else gt, **args))
    return servers


def _run(server, script):
    """Run a script on one server: ("submit", source, kwargs), ("step",),
    ("drain", max_steps), ("close",), ("advance", dt). Returns the log:
    each op's retired requests (or the name of what it raised)."""
    log = []
    for op in script:
        try:
            if op[0] == "submit":
                server.submit(op[1], **(op[2] if len(op) > 2 else {}))
                out = []
            elif op[0] == "step":
                out = server.step()
            elif op[0] == "drain":
                out = server.drain(max_steps=op[1] if len(op) > 1 else 5000)
            elif op[0] == "close":
                out = server.close()
            else:
                server.clock.advance(op[1])
                out = []
        except (Backpressure, ServerClosed, DrainStalled, JBackpressure,
                JServerClosed, JDrainStalled) as e:
            out = [type(e).__name__] + list(getattr(e, "completed", []))
        log.append(out)
    return log


def _req_view(r):
    if isinstance(r, str):
        return r
    return tuple(getattr(r, f) for f in REQ_FIELDS)


def assert_rows_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def assert_served_alike(sj, st, lj, lt):
    """Everything observable about two servers that ran one script."""
    assert [[_req_view(r) for r in out] for out in lj] == \
        [[_req_view(r) for r in out] for out in lt]
    for out_j, out_t in zip(lj, lt):
        for a, b in zip(out_j, out_t):
            if not isinstance(a, str):
                assert_rows_equal(a.dist, b.dist)
                if b.dist is not None:
                    assert not b.dist.flags.writeable
    assert [_req_view(r) for r in sj.completed] == \
        [_req_view(r) for r in st.completed]
    assert sj.metrics.report() == st.metrics.report()
    assert (sj.busy_lanes, sj.pending, sj.idle, sj.closed) == \
        (st.busy_lanes, st.pending, st.idle, st.closed)
    if sj.cache is not None:
        assert [getattr(sj.cache, f) for f in CACHE_STATS] == \
            [getattr(st.cache, f) for f in CACHE_STATS]
        assert len(sj.cache) == len(st.cache)
    if sj.obs is not None:
        assert sj.obs.registry.snapshot() == st.obs.registry.snapshot()
        assert sj.obs.registry.to_prometheus() == \
            st.obs.registry.to_prometheus()
        events = st.obs.tracer.events()
        assert sj.obs.tracer.events() == events
        assert j_validate_events(events) == []
        assert t_validate_events(events) == []


def _served(gj, gt, script, **kw):
    sj, st = _pair(gj, gt, **kw)
    lj, lt = _run(sj, script), _run(st, script)
    assert_served_alike(sj, st, lj, lt)
    return st, lt


def _random_script(rng, n, n_q, dup_pool=None):
    script, submitted = [], 0
    while submitted < n_q:
        for _ in range(int(rng.integers(0, 4))):
            if submitted == n_q:
                break
            pool = dup_pool if dup_pool is not None else n
            script.append(("submit", int(rng.integers(0, pool))))
            submitted += 1
        script.append(("step",))
    script.append(("drain",))
    return script


# ---------------------------------------------------------------------------
# the scheduling contract of tests/test_serving.py, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("criterion", PLANS)
@pytest.mark.parametrize("graph", ["gnp", "grid"])
def test_random_arrivals_match_reference(graphs, graph, criterion, layout):
    """Random bursts x lane counts x chunk lengths, duplicates coalescing
    and hitting the cache, observability on: the same completions in the
    same order on the same lanes, bit-equal rows, equal reports, registry
    and trace."""
    gj, gt = graphs[graph]
    rng = np.random.default_rng(100 + len(graph) + len(criterion))
    lanes, k = int(rng.integers(1, 5)), int(rng.integers(1, 12))
    script = _random_script(rng, gt.n, int(rng.integers(10, 18)),
                            dup_pool=12)
    st, lt = _served(gj, gt, script, criterion=criterion, layout=layout,
                     obs=True, cache=16, lanes=lanes, phases_per_step=k)
    served = [r for out in lt for r in out]
    assert len(served) == sum(op[0] == "submit" for op in script)
    assert any(r.cache_hit or r.coalesced for r in served)
    # every row is the standalone solve's
    for r in served:
        solo = TS.run_phased_static(gt, r.source, criterion=criterion,
                                    layout=layout, device="cpu")
        assert_rows_equal(solo.dist.numpy(), r.dist)
        if not (r.cache_hit or r.coalesced):
            assert r.phases == int(solo.phases)


@pytest.mark.parametrize("graph", ["gnp", "grid"])
def test_no_cache_bursts_match_reference(graphs, graph):
    """Without a cache, duplicates burn lanes of their own (no coalescing),
    as in the reference; the default backend and plan."""
    gj, gt = graphs[graph]
    rng = np.random.default_rng(7)
    script = _random_script(rng, gt.n, 14, dup_pool=6)
    _, lt = _served(gj, gt, script, lanes=3, phases_per_step=5)
    assert not any(r.cache_hit or r.coalesced for out in lt for r in out)


def test_order_and_lane_assignment_is_arrival_fifo(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", s) for s in (0, 1, 2, 3)] + [("drain", 2000)]
    st, lt = _served(gj, gt, script, lanes=2, phases_per_step=4)
    first_two = sorted(st.completed, key=lambda r: r.req_id)[:2]
    assert [r.lane for r in first_two] == [0, 1]


def test_duplicates_coalesce_and_then_hit_cache(graphs):
    gj, gt = graphs["grid"]
    script = [("submit", s) for s in (5, 5, 7, 5)] + [("drain",),
                                                      ("submit", 5),
                                                      ("drain",)]
    st, lt = _served(gj, gt, script, cache=16, lanes=2, phases_per_step=4)
    done = lt[4] + lt[6]
    assert sorted(r.source for r in done if not (r.cache_hit or r.coalesced)) \
        == [5, 7]
    assert lt[6][0].cache_hit and lt[6][0].phases == 0
    assert st.cache.hits == sum(r.cache_hit for r in done)
    assert st.cache.misses == sum(not r.cache_hit for r in done)


def test_cache_hit_served_even_when_all_lanes_busy(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", 3), ("drain",), ("submit", 8), ("step",),
              ("submit", 9), ("submit", 3), ("step",), ("drain",)]
    st, lt = _served(gj, gt, script, cache=8, lanes=1, phases_per_step=1)
    (hit,) = [r for r in lt[6] if r.cache_hit]
    assert hit.source == 3


def test_completed_retention_is_bounded(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", s) for s in range(5)] + [("drain",)]
    st, lt = _served(gj, gt, script, lanes=2, retain_completed=3)
    assert len(lt[-1]) == 5 and len(st.completed) == 3


@pytest.mark.parametrize("kind", ["gnp", "grid"])
def test_completed_rows_survive_reuse_with_donate(graphs, kind):
    """donate=True reaches the backend and changes nothing: delivered rows
    stay host-owned, read-only and equal while the lanes are reused."""
    gj, gt = graphs[kind]
    sj, st = _pair(gj, gt, lanes=2, phases_per_step=4, donate=True)
    assert st._donate
    lj = _run(sj, [("submit", s) for s in (0, 40, 70)] + [("drain",)])
    lt = _run(st, [("submit", s) for s in (0, 40, 70)] + [("drain",)])
    snaps = [(r, r.dist.copy()) for r in lt[-1]]
    more = [("submit", s) for s in (17, 63, 5, 71)] + [("drain",)]
    lj += _run(sj, more)
    lt += _run(st, more)
    assert_served_alike(sj, st, lj, lt)
    for r, snap in snaps:
        assert not r.dist.flags.writeable
        assert_rows_equal(r.dist, snap)


def test_engine_trips_and_report_match_reference(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", s) for s in (0, 1, 0, 2, 1, 0)] + [("drain",)]
    st, _ = _served(gj, gt, script, cache=8, lanes=3, phases_per_step=5)
    rep = json.loads(st.metrics.to_json())
    assert rep["queries_completed"] == 6
    assert rep["engine_trips"] == int(st.state.trips)
    assert 0.0 < rep["lane_occupancy"] <= 1.0


def test_trip_count_is_wrap_safe_like_reference(graphs):
    """The device trip counter is int32 in both packages; the batcher's
    host count adds wrap-safe deltas, so a server past 2^31 trips keeps
    counting."""
    gj, gt = graphs["gnp"]
    sj, st = _pair(gj, gt, lanes=2, phases_per_step=3)
    start = 2**31 - 4
    sj.state = dataclasses.replace(sj.state, trips=jnp.int32(start))
    st.state = dataclasses.replace(
        st.state, trips=torch.tensor(start, dtype=torch.int32))
    sj._trips_dev = st._trips_dev = start
    script = [("submit", s) for s in (0, 5, 9)] + [("drain",)]
    lj, lt = _run(sj, script), _run(st, script)
    assert_served_alike(sj, st, lj, lt)
    assert int(st.state.trips) < 0  # the device counter wrapped
    assert st.metrics.engine_trips == st._trips > 3


def test_backend_criterion_is_plumbed_and_checked(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", s) for s in (0, 7, 0, 119)] + [("drain",)]
    _served(gj, gt, script, criterion="insimple|outsimple", layout="padded",
            cache=8, lanes=2, phases_per_step=5)
    assert TBatcher(gt, backend=TBackend(gt, criterion="out|in",
                                         device="cpu"),
                    criterion="in|out").criterion == "in|out"
    with pytest.raises(ValueError, match="disagrees"):
        TBatcher(gt, backend=TBackend(gt, device="cpu"), criterion="in|out")
    with pytest.raises(ValueError, match="different Graph"):
        TBatcher(gt, backend=TBackend(
            TGen.uniform_gnp(120, 8 / 120, seed=31, device="cpu"),
            device="cpu"))
    with pytest.raises(ValueError, match="oracle"):
        TBackend(gt, criterion="oracle", device="cpu")


def test_submit_and_constructor_validate(graphs):
    _, gt = graphs["gnp"]
    server = TBatcher(gt, lanes=1)
    for bad in (gt.n, -1):
        with pytest.raises(ValueError, match="source"):
            server.submit(bad)
    with pytest.raises(ValueError, match="lanes"):
        TBatcher(gt, lanes=0)
    with pytest.raises(ValueError, match="phases_per_step"):
        TBatcher(gt, lanes=1, phases_per_step=0)
    with pytest.raises(ValueError, match="max_pending"):
        TBatcher(gt, max_pending=0)
    # the default backend runs on the graph's device
    assert TBatcher(gt, lanes=1).backend.device == torch.device("cpu")


def test_metrics_and_queue_surfaces_match_reference():
    from repro.serving import ArrivalQueue as JQueue
    from repro.serving import ServingMetrics as JMetrics

    assert JMetrics(lanes=4).report() == ServingMetrics(lanes=4).report()
    json.dumps(ServingMetrics(lanes=4).report())
    for q in (JQueue(), ArrivalQueue()):
        a = q.push(3, t_arrival=1.0)
        b = q.push(4, t_arrival=2.0, target=7, priority=2, deadline=5.0)
        assert len(q) == 2 and q.peek() is a
        assert q.pop() is a and q.pop() is b and not q
        a.t_admitted, a.t_completed = 1.5, 3.0
        assert (a.queue_wait, a.latency, b.effective_target) == (0.5, 2.0, 7)
        b.downgraded = True
        assert b.effective_target is None and q.total_enqueued == 2


# ---------------------------------------------------------------------------
# admission hardening (the fault-free admission tests of test_resilience.py)
# ---------------------------------------------------------------------------


def test_priority_wins_a_lane_first(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", s) for s in (0, 3, 17)] + [
        ("submit", 40, {"priority": 5}), ("drain", 500)]
    st, _ = _served(gj, gt, script, lanes=1)
    order = [r.source for r in sorted(st.completed,
                                      key=lambda r: r.t_admitted)]
    assert order[0] == 40


def test_backpressure_rejects_and_priority_sheds(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", 0), ("submit", 3), ("submit", 17),
              ("submit", 40, {"priority": 1}), ("drain", 500)]
    st, lt = _served(gj, gt, script, lanes=1, max_pending=2, obs=True)
    assert lt[2] == ["Backpressure"]
    assert st.metrics.rejected == 1 and st.metrics.shed == 1
    assert {r.source for r in lt[-1]} == {0, 40}


def test_stale_ok_ladder(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", 0), ("drain", 500), ("advance", 100.0),
              ("submit", 0), ("submit", 0, {"stale_ok": True}),
              ("drain", 500), ("submit", 0), ("drain", 500)]
    st, lt = _served(gj, gt, script, lanes=1, cache=8, cache_max_age=5.0)
    stale = [r for r in lt[5] if r.served_stale]
    assert len(stale) == 1 and stale[0].cache_hit
    assert st.cache.stale_misses == 1 and st.metrics.stale_served == 1
    assert lt[-1][0].cache_hit and not lt[-1][0].served_stale


def test_deadlines_shed_and_stay_out_of_completion_aggregates(graphs):
    gj, gt = graphs["grid"]
    script = [("submit", 0), ("submit", 3, {"deadline": -1.0}),
              ("submit", 5), ("submit", 9, {"deadline": 3.0}),
              ("drain", 500)]
    st, lt = _served(gj, gt, script, lanes=1, phases_per_step=2, obs=True)
    outcomes = {r.source: r.outcome for r in lt[-1]}
    assert outcomes == {0: "ok", 3: "deadline", 5: "ok", 9: "deadline"}
    rep = st.metrics.report()
    assert rep["queries_completed"] == 2
    assert rep["deadline_expired"] == rep["deadline_misses"] == 2


def test_close_sheds_and_later_calls_raise(graphs):
    gj, gt = graphs["gnp"]
    script = [("submit", 0), ("step",), ("submit", 3), ("close",),
              ("submit", 17), ("step",), ("drain",), ("close",)]
    st, lt = _served(gj, gt, script, lanes=1, phases_per_step=1, obs=True)
    assert {r.source for r in lt[3]} == {0, 3}
    assert all(r.outcome == "shed" for r in lt[3])
    assert lt[4] == lt[5] == lt[6] == ["ServerClosed"] and lt[7] == []
    assert st.closed and st.idle


def test_duplicate_harvest_raises(graphs):
    _, gt = graphs["gnp"]
    server = TBatcher(gt, lanes=1)
    req = server.submit(0)
    server.drain(max_steps=500)
    assert req.outcome == "ok"
    with pytest.raises(RuntimeError, match="already retired"):
        server._finish(req)
    with pytest.raises(RuntimeError, match="already retired"):
        server._fail(req, "shed", 0.0)


def test_drain_stalled_keeps_the_delivered_work(graphs):
    gj, gt = graphs["grid"]
    script = [("submit", 3), ("submit", 3), ("submit", 40), ("drain", 2),
              ("drain",)]
    st, lt = _served(gj, gt, script, lanes=1, phases_per_step=1, cache=4)
    assert lt[3][0] == "DrainStalled"
    assert len(lt[3]) - 1 + len(lt[4]) == 3


# ---------------------------------------------------------------------------
# the cache across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_to", [None, 900])
def test_graph_key_equals_the_reference(pad_to):
    gj = JGen.uniform_gnp(60, 0.1, seed=5, pad_to=pad_to)
    gt = TGen.uniform_gnp(60, 0.1, seed=5, pad_to=pad_to, device="cpu")
    assert gt.m == gj.m
    assert t_graph_key(gt) == j_graph_key(gj)
    assert t_graph_key(gt) is gt.__dict__["_graph_key"]  # memoised
    other = TGen.uniform_gnp(60, 0.1, seed=6, device="cpu")
    assert t_graph_key(other) != t_graph_key(gt)
    twin = TGen.uniform_gnp(60, 0.1, seed=5, pad_to=pad_to, device="cpu")
    assert t_graph_key(twin) == t_graph_key(gt)


def test_snapshots_restore_across_packages(tmp_path, graphs):
    gj, gt = graphs["gnp"]
    rng = np.random.default_rng(4)
    rows = {s: rng.uniform(0, 3, gt.n).astype(np.float32) for s in (0, 3, 17)}
    key = t_graph_key(gt)
    for src_cls, dst_cls in ((TCache, JCache), (JCache, TCache)):
        c = src_cls()
        for s, r in rows.items():
            c.put(key, "in|out", s, r, now=float(s))
        path = str(tmp_path / f"{src_cls.__module__}.bin")
        assert c.snapshot(path) == 3
        back = dst_cls()
        assert back.restore(path, now=100.0) == 3
        for s, r in rows.items():
            got = back.get(j_graph_key(gj), "in|out", s)
            assert_rows_equal(r, got)
            assert not got.flags.writeable
        assert back.age(key, "in|out", 0, now=100.0) == 17.0
    blob = open(path, "rb").read()
    assert blob.startswith(b"REPRODC1")


def test_cache_rows_are_readonly_and_lru_evicts():
    for cls in (TCache, JCache):
        c = cls(capacity=2)
        c.put("g", "crit", 1, np.ones(4, np.float32))
        c.put("g", "crit", 2, np.full(4, 2.0, np.float32))
        assert c.get("g", "crit", 1) is not None
        c.put("g", "crit", 3, np.full(4, 3.0, np.float32))
        assert c.evictions == 1 and c.get("g", "crit", 2) is None
        row = c.get("g", "crit", 1)
        with pytest.raises(ValueError):
            row[0] = 99.0
        assert len(c) == 2 and (c.hits, c.misses) == (2, 1)
        with pytest.raises(ValueError):
            cls(capacity=0)


def test_cache_does_not_leak_across_graphs(graphs):
    _, g1 = graphs["gnp"]
    g3 = TGen.uniform_gnp(120, 8 / 120, seed=6, device="cpu")
    cache = TCache()
    s1 = TBatcher(g1, lanes=1, cache=cache)
    s1.submit(0)
    s1.drain(max_steps=500)
    s3 = TBatcher(g3, lanes=1, cache=cache)
    s3.submit(0)
    (done,) = s3.drain(max_steps=500)
    assert not done.cache_hit
    assert_rows_equal(TS.run_phased_static(g3, 0, device="cpu").dist.numpy(),
                      done.dist)


def test_cache_does_not_leak_across_criteria(graphs):
    """A row poisoned under one criterion's key is never served to a server
    of another criterion over the same graph and cache."""
    _, g = graphs["gnp"]
    cache = TCache()
    a = TBatcher(g, lanes=1, cache=cache)
    a.submit(3)
    a.drain(max_steps=500)
    key = (t_graph_key(g), a.criterion, 3)
    assert key in cache
    poisoned = np.full(g.n, -1.0, np.float32)
    cache._d[key] = TEntry(poisoned, zlib.crc32(poisoned.tobytes()), 0.0)
    b = TBatcher(g, lanes=1, cache=cache, criterion="in|out")
    b.submit(3)
    (done,) = b.drain(max_steps=500)
    assert not done.cache_hit
    assert_rows_equal(
        TS.run_phased_static(g, 3, criterion="in|out", device="cpu")
        .dist.numpy(), done.dist)
    assert_rows_equal(cache.get(t_graph_key(g), a.criterion, 3), poisoned)
    assert JEntry.__slots__ == TEntry.__slots__


def test_restored_reference_snapshot_serves_a_cold_port_server(tmp_path,
                                                              graphs):
    gj, gt = graphs["gnp"]
    path = str(tmp_path / "cache.bin")
    warm = JBatcher(gj, lanes=1, cache=JCache(), use_pallas=False)
    warm.submit(0)
    (want,) = warm.drain(max_steps=500)
    warm.cache.snapshot(path)
    restored = TCache()
    assert restored.restore(path) == 1
    cold = TBatcher(gt, lanes=1, cache=restored)
    req = cold.submit(0)
    cold.drain(max_steps=500)
    assert req.cache_hit and req.phases == 0
    assert_rows_equal(want.dist, req.dist)


# ---------------------------------------------------------------------------
# the obs surface
# ---------------------------------------------------------------------------


def test_tracer_and_registry_formats_match_reference(tmp_path):
    """The same calls on both packages' tracer and registry give the same
    events, snapshot, JSON and Prometheus text; the port's export passes
    the reference's validator."""
    from repro.obs import MetricsRegistry as JReg
    from repro.obs import Tracer as JTracer
    from repro_torch.obs import MetricsRegistry as TReg
    from repro_torch.obs import Tracer as TTracer
    from repro_torch.obs import timer

    out = []
    for Reg, Tracer in ((JReg, JTracer), (TReg, TTracer)):
        clock = Clock()
        tr = Tracer(clock=clock, max_events=5)
        reg = Reg()
        tr.name_thread("lane 0", "serving lane 0")
        with tr.span("step", cat="step", tid="scheduler", busy=1):
            tr.begin("src 3", cat="request", tid="lane 0", source=3)
            tr.counter("scheduler load", {"queue_depth": 2, "busy_lanes": 1})
        tr.end("src 3", cat="request", tid="lane 0")
        tr.instant("cache hit src 3", cat="request", tid="scheduler")
        tr.instant("dropped", tid="scheduler")
        reg.counter("serving.completed", "requests").inc(2)
        reg.gauge("serving.busy_lanes").set(3)
        h = reg.histogram("serving.latency_s", window=2)
        for v in (0.5, 0.25, 1.0):
            h.observe(v)
        path = tmp_path / f"{Tracer.__module__}.json"
        tr.export(str(path))
        out.append((tr.events(), tr.dropped, reg.snapshot(), reg.to_json(),
                    reg.to_prometheus(), json.loads(path.read_text())))
    assert out[0] == out[1]
    assert j_validate_events(out[1][5]["traceEvents"]) == []
    assert out[1][1] == 1  # max_events bounds the trace
    assert timer.Stopwatch().elapsed == 0.0
    t, val = timer.timed(lambda: 7, repeats=2)
    assert val == 7 and t >= 0.0
