"""The port's telemetry rings and their decoder against the JAX reference.

``fringe_trace``, ``relax_trace`` and ``attr_trace`` are held bit for bit
against the reference's for the default plan, ``in|out``, an oracle plan
and delta-stepping, on both layouts, chunk by chunk across lane resets;
``repro_torch.obs.telemetry`` decodes, publishes and traces them into the
same records, registry contents and events as ``repro.obs.telemetry``;
and a run with the rings on equals one with them off on every other field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import oracle as JO
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.obs import Observability as JObs
from repro.obs import telemetry as JT
from repro.obs import validate_events as j_validate_events
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.obs import Observability as TObs
from repro_torch.obs import telemetry as TT
from repro_torch.obs import validate_events as t_validate_events

torch.set_num_threads(1)

POLICIES = ["instatic|outstatic", "in|out", "instatic|outstatic|oracle",
            "oracle", "delta"]
RINGS = ("settled_trace", "fringe_trace", "relax_trace", "attr_trace")
BASE_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
               "total_phases", "settled_per_phase")


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(want, got):
    want, got = _bits(want), _bits(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(want, got)


@pytest.fixture(scope="module")
def graphs():
    return (JGen.uniform_gnp(90, 0.07, seed=21),
            TGen.uniform_gnp(90, 0.07, seed=21, device="cpu"))


def _truth(gj, sources):
    return np.stack([
        np.full(gj.n, np.inf, np.float32) if s < 0
        else JO.dijkstra_numpy(gj, int(s)).astype(np.float32)
        for s in sources])


def _init(gj, gt, policy, sources, trace_len, telemetry=True):
    kw = dict(criterion=policy, trace_len=trace_len, telemetry=telemetry)
    if "oracle" in policy:
        kw["dist_true"] = _truth(gj, sources)
    return (JS.init_batch_state(gj, sources, **kw),
            TS.init_batch_state(gt, sources, device="cpu", **kw))


def _reset(gj, sj, st, sources):
    kw = {}
    if sj.dist_true is not None:
        kw["dist_true"] = _truth(gj, sources)
    src = np.asarray(sources, np.int32)
    return (JS.reset_lanes(sj, src, **kw), TS.reset_lanes(st, src, **kw))


def _run_pair(gj, gt, policy, layout, trace_len=None, telemetry=True):
    """Both packages over one chunk schedule with a refill and a park;
    every ring compared after every chunk. Returns the final states."""
    trace_len = trace_len or 4 * gt.n + 16
    ell_j = JS.to_ell_in_sliced(gj) if layout == "sliced" else None
    ell_t = TS.to_ell_in_sliced(gt) if layout == "sliced" else None
    sj, st = _init(gj, gt, policy, [2, TS.EMPTY_LANE, 40], trace_len,
                   telemetry)
    for chunk in range(400):
        if chunk == 2:
            sj, st = _reset(gj, sj, st, [TS.KEEP_LANE, 7, TS.KEEP_LANE])
        if chunk == 4:
            sj, st = _reset(gj, sj, st, [TS.KEEP_LANE, TS.KEEP_LANE,
                                         TS.EMPTY_LANE])
        sj = JS.step_batch(gj, sj, 3, ell=ell_j, use_pallas=False)
        st = TS.step_batch(gt, st, 3, ell=ell_t)
        for ring in RINGS:
            w, g = getattr(sj, ring), getattr(st, ring)
            if w is None or g is None:
                assert w is None and g is None, ring
            else:
                assert_bits(w, g)
        if not TS.lanes_active(st).any():
            break
    assert not TS.lanes_active(st).any()
    return sj, st


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("policy", POLICIES)
def test_rings_match_reference_across_chunks_and_resets(graphs, policy,
                                                        layout):
    gj, gt = graphs
    sj, st = _run_pair(gj, gt, policy, layout)
    want, got = JS.harvest(sj), TS.harvest(st)
    for f in BASE_FIELDS + ("fringe_per_phase", "relax_per_phase",
                            "settle_attribution"):
        assert_bits(getattr(want, f), getattr(got, f))
    # reconciliation, lane by lane: the rings sum to the counters, and the
    # attribution's settles to the settled ring
    attr = got.settle_attribution.numpy()
    terms = TT.attribution_terms(policy)
    settles = [k for k, t in enumerate(terms) if t not in ("light", "bucket")]
    for lane in range(3):
        assert got.fringe_per_phase[lane].sum() == got.sum_fringe[lane]
        assert got.relax_per_phase[lane].sum() == got.relax_edges[lane]
        np.testing.assert_array_equal(
            attr[lane][:, settles].sum(axis=1),
            got.settled_per_phase[lane].numpy())


@pytest.mark.parametrize("policy", ["in|out", "oracle", "delta"])
def test_telemetry_off_leaves_every_other_field_alone(graphs, policy):
    gj, gt = graphs
    on = _run_pair(gj, gt, policy, "padded", trace_len=64)[1]
    off = _run_pair(gj, gt, policy, "padded", trace_len=64,
                    telemetry=False)[1]
    assert off.attr_trace is None and off.fringe_trace is None
    r_on, r_off = TS.harvest(on), TS.harvest(off)
    for f in BASE_FIELDS:
        assert_bits(getattr(r_on, f), getattr(r_off, f))
    assert r_off.settle_attribution is None
    assert_bits(on.crit_keys, off.crit_keys)


def test_short_ring_harvests_no_profile(graphs):
    gj, gt = graphs
    res = TS.run_phased_static_batch(gt, [0, 5], trace_len=1,
                                     telemetry=True, device="cpu")
    assert res.fringe_per_phase is None and res.settle_attribution is None
    want = JS.run_phased_static_batch(gj, [0, 5], trace_len=1,
                                      telemetry=True, use_pallas=False)
    assert want.fringe_per_phase is None


def _records(sj, st):
    return JT.phase_telemetry(sj), TT.phase_telemetry(st)


@pytest.mark.parametrize("policy", ["instatic|outstatic", "in|out", "oracle",
                                    "delta"])
def test_phase_telemetry_records_match_reference(graphs, policy):
    gj, gt = graphs
    sj, st = _run_pair(gj, gt, policy, "sliced")
    rj, rt = _records(sj, st)
    assert [r.as_dict() for r in rj] == [r.as_dict() for r in rt]
    assert len(rt) == int(st.phases.sum())
    assert TT.attribution_terms(policy) == JT.attribution_terms(policy)
    lanes = [r.as_dict() for r in TT.phase_telemetry(st, lanes=[0])]
    assert lanes == [r.as_dict() for r in JT.phase_telemetry(sj, lanes=[0])]


@pytest.mark.parametrize("policy", ["in|out", "delta"])
def test_published_registry_and_trace_match_reference(graphs, policy):
    gj, gt = graphs
    sj, st = _run_pair(gj, gt, policy, "padded")
    rj, rt = _records(sj, st)
    oj, ot = JObs.enabled(clock=lambda: 0.0), TObs.enabled(clock=lambda: 0.0)
    JT.publish_phase_telemetry(rj, oj.registry)
    TT.publish_phase_telemetry(rt, ot.registry)
    assert oj.registry.snapshot() == ot.registry.snapshot()
    assert oj.registry.to_prometheus() == ot.registry.to_prometheus()
    JT.trace_phase_telemetry(rj, oj.tracer)
    TT.trace_phase_telemetry(rt, ot.tracer)
    events = ot.tracer.events()
    assert oj.tracer.events() == events
    assert t_validate_events(events) == [] == j_validate_events(events)
    off = TObs.disabled()
    TT.trace_phase_telemetry(rt, off.tracer)  # a disabled tracer is inert
    assert off.tracer.events() == []


def test_decoder_refuses_what_is_not_a_profile(graphs):
    gj, gt = graphs
    st = TS.init_batch_state(gt, [0], trace_len=4, device="cpu")
    with pytest.raises(ValueError, match="no telemetry rings"):
        TT.phase_telemetry(st)
    st = TS.init_batch_state(gt, [0], trace_len=4, telemetry=True,
                             device="cpu")
    st = TS.step_batch(gt, st, 40)
    assert int(st.phases[0]) > 4
    with pytest.raises(ValueError, match="early phases were overwritten"):
        TT.phase_telemetry(st)


def test_delta_attribution_shape(graphs):
    """test_delta_policy.py's telemetry contract on the port: the heavy
    slot equals the settled ring, every phase is light or heavy, the
    bucket id never goes down, and every reached vertex settles once."""
    _, gt = graphs
    res = TS.run_phased_static_batch(gt, [0, gt.n // 2], criterion="delta",
                                     trace_len=4 * gt.n + 16, telemetry=True,
                                     device="cpu")
    attr = res.settle_attribution.numpy()
    settled = res.settled_per_phase.numpy()
    for lane in range(2):
        p = int(res.phases[lane])
        np.testing.assert_array_equal(attr[lane, :p, 1], settled[lane, :p])
        assert np.array_equal(attr[lane, :p, 0] > 0, ~(attr[lane, :p, 1] > 0))
        assert (np.diff(attr[lane, :p, 2]) >= 0).all()
    np.testing.assert_array_equal(settled.sum(axis=1),
                                  np.isfinite(res.dist.numpy()).sum(axis=1))


def test_telemetry_state_crosses_over_through_interop(graphs):
    from repro_torch import interop

    gj, gt = graphs
    sj, st = _init(gj, gt, "in|out", [3, 9], 64)
    sj = JS.step_batch(gj, sj, 5, use_pallas=False)
    fields = {f.name: (sj.criterion if f.name == "criterion"
                       else None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)}
    st = interop.state_from_numpy(fields, device="cpu")
    for ring in RINGS:
        assert_bits(getattr(sj, ring), getattr(st, ring))
    sj = JS.step_batch(gj, sj, 200, use_pallas=False)
    st = TS.step_batch(gt, st, 200)
    rj, rt = _records(sj, st)
    assert [r.as_dict() for r in rj] == [r.as_dict() for r in rt]
