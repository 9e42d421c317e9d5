"""The port's engine portfolio against the reference's, on the CPU.

Both packages get the same seeded graphs. Compared: ``graph_family`` on
the four regimes (flat, skewed, deep, heavy-tailed weights, the buckets in
f64 numpy in both), ``family_fallbacks``, every candidate's
``ledger_policy`` and ``resolve_delta``, ``measure_portfolio``'s entries in
everything but the measured walls (``phases``, ``queries``, ``delta``,
``settle_attribution``), ``pick_engine`` on hand-written ledgers, the
policies' ``share_terms``, and ``PortfolioBackend`` serving one script
with bit-equal rows. The reference runs its Pallas kernels in interpret
mode, as its own tests do; the port runs its plain twins on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core import criteria as JC
from repro.core import policies as JP
from repro.core.delta_stepping import default_delta as j_default_delta
from repro.core.graph import from_coo as j_from_coo
from repro.graphs import generators as JGen
from repro.kernels import config as jcfg
from repro.serving import backends as JB
from repro.serving import ContinuousBatcher as JBatcher
from repro_torch.core import policies as TP
from repro_torch.core import static_engine as TS
from repro_torch.core.graph import from_coo as t_from_coo
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import config as tcfg
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import backends as TB
from repro_torch.serving import ContinuousBatcher as TBatcher

torch.set_num_threads(1)

PROBED = ("phases", "queries", "delta", "settle_attribution")
CANDS = ((TB.EngineCandidate("instatic|outstatic", "padded"),
          TB.EngineCandidate("delta", "sliced")),
         (JB.EngineCandidate("instatic|outstatic", "padded"),
          JB.EngineCandidate("delta", "sliced")))


@pytest.fixture(autouse=True)
def _isolated_ledgers(monkeypatch):
    monkeypatch.delenv("REPRO_TUNING_LEDGER", raising=False)
    monkeypatch.delenv("REPRO_TORCH_TUNING_LEDGER", raising=False)
    jcfg.reset_global_ledger()
    tcfg.reset_global_ledger()
    yield
    jcfg.reset_global_ledger()
    tcfg.reset_global_ledger()


def _pair(name, *args, **kw):
    return (getattr(JGen, name)(*args, **kw),
            getattr(TGen, name)(*args, **kw, device="cpu"))


@pytest.fixture(scope="module")
def gnp():
    return _pair("uniform_gnp", 64, 8.0 / 64, seed=2)


def _weighted_pair(weights_of):
    gj0 = JGen.uniform_gnp(128, 8.0 / 128, seed=0)
    src, dst = np.asarray(gj0.src, np.int64), np.asarray(gj0.dst, np.int64)
    w = weights_of(np.random.default_rng(0), src.shape[0])
    return j_from_coo(src, dst, w, 128), t_from_coo(src, dst, w, 128,
                                                    device="cpu")


FAMILIES = {
    "gnp": (lambda: _pair("uniform_gnp", 128, 8.0 / 128, seed=0),
            "flat-uniform-shallow"),
    "kronecker": (lambda: _pair("kronecker", 7, seed=0),
                  "skew-uniform-shallow"),
    "grid": (lambda: _pair("grid_road", 22, 22, seed=0), "flat-uniform-deep"),
    "pareto": (lambda: _weighted_pair(
        lambda r, m: r.pareto(1.5, size=m).astype(np.float32) + 0.01),
        "flat-heavy-shallow"),
    "exponential": (lambda: _weighted_pair(
        lambda r, m: r.exponential(1.0, size=m).astype(np.float32)), None),
    "webgraph": (lambda: _pair("webgraph", 300, seed=4), None),
}


def _strip(entries):
    return {k: {f: e.get(f) for f in PROBED} for k, e in entries.items()}


# ---------------------------------------------------------------------------
# families, candidates, share terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_graph_family_equals_the_reference(kind):
    make, want = FAMILIES[kind]
    gj, gt = make()
    fam = TB.graph_family(gt)
    assert fam == JB.graph_family(gj)
    if want is not None:
        assert fam == want
    assert gt.__dict__["_graph_family"] is fam  # memoised
    for axis in ("_degree_bucket", "_weight_bucket", "_depth_bucket"):
        assert getattr(TB, axis)(gt) == getattr(JB, axis)(gj)


@pytest.mark.parametrize("family", ["skew-uniform-shallow", "flat",
                                    "flat-heavy-deep"])
def test_family_fallbacks_equal(family):
    assert TB.family_fallbacks(family) == JB.family_fallbacks(family)


def test_candidates_equal_the_reference(gnp):
    gj, gt = gnp
    extra = [("delta", "padded", 0.125, None), ("delta", "sliced", None, 3.0),
             ("out|in", "padded", None, None)]
    tc = list(TB.DEFAULT_CANDIDATES) + [TB.EngineCandidate(*a) for a in extra]
    jc = list(JB.DEFAULT_CANDIDATES) + [JB.EngineCandidate(*a) for a in extra]
    assert len(TB.DEFAULT_CANDIDATES) == 8
    for a, b in zip(jc, tc):
        assert dataclass_fields(a) == dataclass_fields(b)
        assert (a.spec, a.ledger_policy) == (b.spec, b.ledger_policy)
        assert a.resolve_delta(gj) == b.resolve_delta(gt)


def dataclass_fields(c):
    return (c.policy, c.layout, c.delta, c.delta_scale)


def test_share_terms_equal_for_every_plan():
    specs = sorted(set(JC.REGISTRY) | {"delta", "in|out", "instatic|outstatic",
                                       "insimple|outsimple", "in|out|oracle"})
    for spec in specs:
        jp, tp = JP.policy_for(spec), TP.policy_for(spec)
        assert tp.attribution_terms() == jp.attribution_terms(), spec
        assert tp.share_terms() == jp.share_terms(), spec
    assert TP.policy_for("delta").share_terms() == ("light", "heavy")


# ---------------------------------------------------------------------------
# measurement and routing
# ---------------------------------------------------------------------------


def test_measure_portfolio_entries_equal_the_reference(gnp):
    """Every default candidate probed on one graph: the same keys, phases,
    queries, bucket widths and settle-attribution totals; the walls are
    measurements and are only checked for being rates."""
    gj, gt = gnp
    led_j, led_t, reg = jcfg.TuningLedger(), tcfg.TuningLedger(), \
        MetricsRegistry()
    ej = JB.measure_portfolio(gj, lanes=2, ledger=led_j, repeats=1)
    et = TB.measure_portfolio(gt, lanes=2, ledger=led_t, registry=reg,
                              repeats=1)
    assert list(et) == list(ej)
    # the port tags each entry with the device it probed on; the rest of
    # the entry is the reference's
    assert all(e.pop("device") == "cpu" for e in et.values())
    assert _strip(et) == _strip(ej)
    assert set(led_t.entries) == set(led_j.entries)
    for key, e in et.items():
        assert e["qps"] > 0 and e["phases"] > 0
        assert e["qps"] == pytest.approx(e["queries"] / e["wall_s"])
        assert e["per_phase_s"] == pytest.approx(e["wall_s"] / e["phases"])
        assert reg.snapshot()[f"portfolio.qps.{key[0]}.{key[1]}"]["value"] \
            == e["qps"]
    assert et[("delta@x4", "sliced")]["delta"] == pytest.approx(
        4.0 * j_default_delta(gj))
    assert set(et[("delta", "sliced")]["settle_attribution"]) == {"light",
                                                                  "heavy"}
    assert set(et[("in|out", "padded")]["settle_attribution"]) == {"in",
                                                                   "out"}


@pytest.mark.parametrize("kind", ["grid", "kronecker"])
def test_measure_portfolio_on_other_families(kind):
    gj, gt = FAMILIES[kind][0]()
    et = TB.measure_portfolio(gt, lanes=3, candidates=CANDS[0],
                              ledger=tcfg.TuningLedger(), repeats=1)
    ej = JB.measure_portfolio(gj, lanes=3, candidates=CANDS[1],
                              ledger=jcfg.TuningLedger(), repeats=1)
    assert all(e.pop("device") == "cpu" for e in et.values())
    assert _strip(et) == _strip(ej)


def test_measure_portfolio_probes_warms_then_times(gnp, monkeypatch):
    """Per candidate: one telemetry probe, one untimed warm-up, then the
    ``repeats`` timed solves (each closed by a synchronize on the card)."""
    _, gt = gnp
    calls = []
    real = TS.run_phased_static_batch

    def counting(*a, **kw):
        calls.append(kw.get("telemetry", False))
        return real(*a, **kw)

    monkeypatch.setattr(TB, "run_phased_static_batch", counting)
    TB.measure_portfolio(gt, lanes=2, candidates=CANDS[0][:1],
                         ledger=tcfg.TuningLedger(), repeats=3)
    assert calls == [True, False, False, False, False]


def _hand_ledgers(rows):
    leds = []
    for kcfg in (jcfg, tcfg):
        led = kcfg.TuningLedger()
        for fam, b, pol, lay, qps in rows:
            kcfg.record_portfolio(led, fam, b, pol, lay, wall_s=b / qps,
                                  phases=10, queries=b)
        leds.append(led)
    return leds


@pytest.mark.parametrize("family,lanes", [
    ("flat-uniform-shallow", 4), ("flat-uniform-deep", 4),
    ("skew-uniform-shallow", 4), ("flat-uniform-shallow", 8),
    ("skew-heavy-deep", 2)])
def test_pick_engine_picks_alike(family, lanes):
    rows = [
        ("flat-uniform-shallow", 4, "delta@x0.5", "sliced", 40.0),
        ("flat-uniform-shallow", 4, "delta@x2", "sliced", 20.0),
        ("flat-uniform-shallow", 4, "instatic|outstatic", "padded", 30.0),
        ("flat", 4, "in|out", "sliced", 99.0),  # coarse, pre-rich record
        ("skew", 4, "delta", "padded", 5.0),
        ("skew-uniform-shallow", 4, "in|out", "padded", 7.0),
        ("skew-uniform-shallow", 4, "delta", "sliced", 6.0),
        ("flat-uniform-shallow", 8, "not-a-candidate", "padded", 1e9),
    ]
    lj, lt = _hand_ledgers(rows)
    cj = JB.pick_engine(family, lanes, JB.DEFAULT_CANDIDATES, lj)
    ct = TB.pick_engine(family, lanes, TB.DEFAULT_CANDIDATES, lt)
    assert dataclass_fields(cj) == dataclass_fields(ct)
    # the empty ledger falls back to the first candidate
    assert TB.pick_engine(family, lanes, CANDS[0],
                          tcfg.TuningLedger()) is CANDS[0][0]


# ---------------------------------------------------------------------------
# PortfolioBackend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("winner", range(len(TB.DEFAULT_CANDIDATES)))
def test_portfolio_backend_serves_like_the_reference(winner):
    """A hand-written ledger makes each default candidate win in turn; both
    packages' ``PortfolioBackend`` route to it without a probe, and one
    script served through both batchers gives the same completions and
    bit-equal rows, each the routed engine's standalone solve."""
    gj, gt = _pair("grid_road", 7, 8, seed=5)
    fam = TB.graph_family(gt)
    rows = [(fam, 2, c.ledger_policy, c.layout,
             100.0 if i == winner else 10.0 + i)
            for i, c in enumerate(TB.DEFAULT_CANDIDATES)]
    lj, lt = _hand_ledgers(rows)
    bj = JB.PortfolioBackend(gj, lanes_hint=2, ledger=lj, use_pallas=False)
    bt = TB.PortfolioBackend(gt, lanes_hint=2, ledger=lt)
    assert dataclass_fields(bt.choice) == dataclass_fields(bj.choice)
    assert bt.choice == TB.DEFAULT_CANDIDATES[winner]
    assert (bt.family, bt.criterion, bt.n) == (bj.family, bj.criterion, bj.n)
    assert bt.inner.delta == bj.inner.delta
    assert bt.inner.device == torch.device("cpu")
    assert len(lt.entries) == len(rows)  # no probe ran
    sj = JBatcher(gj, lanes=2, backend=bj, phases_per_step=3)
    st = TBatcher(gt, lanes=2, backend=bt, phases_per_step=3)
    srcs = [0, 9, 17, 33, 9, 55]
    for s in srcs:
        sj.submit(s)
        st.submit(s)
    dj, dt = sj.drain(max_steps=5000), st.drain(max_steps=5000)
    assert [(r.req_id, r.source, r.lane, r.phases) for r in dt] == \
        [(r.req_id, r.source, r.lane, r.phases) for r in dj]
    for a, b in zip(dj, dt):
        np.testing.assert_array_equal(np.asarray(a.dist).view(np.int32),
                                      b.dist.view(np.int32))
        solo = TS.run_phased_static(
            gt, b.source, criterion=bt.choice.spec, layout=bt.choice.layout,
            delta=bt.choice.resolve_delta(gt), device="cpu")
        np.testing.assert_array_equal(solo.dist.numpy().view(np.int32),
                                      b.dist.view(np.int32))


def test_portfolio_backend_probes_an_unknown_family_once(gnp, monkeypatch):
    gj, gt = gnp
    led = tcfg.TuningLedger()
    backend = TB.PortfolioBackend(gt, lanes_hint=2, candidates=CANDS[0],
                                  ledger=led)
    entries = tcfg.portfolio_entries(led, TB.graph_family(gt), 2)
    assert set(entries) == {(c.ledger_policy, c.layout) for c in CANDS[0]}
    best = max(entries, key=lambda k: entries[k]["qps"])
    assert (backend.choice.ledger_policy, backend.choice.layout) == best
    # a second server of the family routes from the records: no probe
    monkeypatch.setattr(TB, "measure_portfolio", _no_probe)
    again = TB.PortfolioBackend(gt, lanes_hint=2, candidates=CANDS[0],
                                ledger=led)
    assert again.choice == backend.choice
    with pytest.raises(RuntimeError, match="probe"):
        TB.PortfolioBackend(gt, lanes_hint=2, candidates=CANDS[0],
                            ledger=led, probe=True)
    with pytest.raises(ValueError, match="non-empty"):
        TB.PortfolioBackend(gt, candidates=(), ledger=led)


def _no_probe(*a, **kw):
    raise RuntimeError("probe ran")


def test_portfolio_backend_reads_the_process_ledger(gnp, tmp_path,
                                                    monkeypatch):
    """A ledger saved by one process routes a fresh one through
    ``REPRO_TORCH_TUNING_LEDGER``, with no probe."""
    _, gt = gnp
    led = tcfg.TuningLedger()
    fam = TB.graph_family(gt)
    tcfg.record_portfolio(led, fam, 2, "delta@x2", "sliced", wall_s=0.01,
                          phases=10, queries=2)
    tcfg.record_portfolio(led, fam, 2, "instatic|outstatic", "padded",
                          wall_s=0.1, phases=10, queries=2)
    path = led.save(str(tmp_path / "ledger.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNING_LEDGER", path)
    tcfg.reset_global_ledger()
    monkeypatch.setattr(TB, "measure_portfolio", _no_probe)
    backend = TB.PortfolioBackend(gt, lanes_hint=2)
    assert backend.choice == TB.EngineCandidate("delta", "sliced",
                                                delta_scale=2.0)
    assert backend.inner.delta == pytest.approx(2.0 * j_default_delta(gnp[0]))
