"""The port's tuning ledger (``repro_torch.kernels.config``) against the
reference's (``repro.kernels.config``).

The cases of ``tests/test_kernel_config.py`` that concern the ledger run
on both packages: corrupt JSON, malformed values, atomic save, partial
load, save with no path, the round trip, and the process ledger's env
autoload (the port's under ``REPRO_TORCH_TUNING_LEDGER`` only). A file
saved by either package loads in the other with equal entries, and with a
hand-put slicing entry the sliced builders of both packages build the same
tuned buckets, bit for bit (the reference's key is ``interpret:...`` on
the CPU, the port's ``cpu:...``).
"""
import json

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.graphs import generators as JGen
from repro.kernels import config as jcfg
from repro_torch.core import graph as TG
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import config as tcfg
from repro_torch.obs import MetricsRegistry, set_default_registry

torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("kcfg", [jcfg, tcfg], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _isolated_ledgers(monkeypatch):
    """Every test sees fresh process ledgers and leaves none behind."""
    monkeypatch.delenv("REPRO_TUNING_LEDGER", raising=False)
    monkeypatch.delenv("REPRO_TORCH_TUNING_LEDGER", raising=False)
    jcfg.reset_global_ledger()
    tcfg.reset_global_ledger()
    yield
    jcfg.reset_global_ledger()
    tcfg.reset_global_ledger()


def _key(kcfg, *args):
    if kcfg is tcfg:
        return kcfg.ledger_key(*args, device="cpu")
    return kcfg.ledger_key(*args)


def _slicing_key(kcfg, side, n):
    if kcfg is tcfg:
        return kcfg.slicing_ledger_key(side, n, device="cpu")
    return kcfg.slicing_ledger_key(side, n)


# ---------------------------------------------------------------------------
# the reference's ledger cases, on both packages
# ---------------------------------------------------------------------------


@BOTH
def test_ledger_corrupted_json_loads_nothing(kcfg, tmp_path):
    p = tmp_path / "ledger.json"
    p.write_text("{not json")
    led = kcfg.TuningLedger(str(p))
    assert led.entries == {}
    led.put("k", {"block_rows": 128})
    assert led.load(str(p)) == 0
    assert led.get("k") == {"block_rows": 128}  # memory never dropped


@BOTH
def test_ledger_malformed_values_are_skipped(kcfg, tmp_path):
    p = tmp_path / "ledger.json"
    for payload in ("[1, 2, 3]", "512", "null"):
        p.write_text(payload)
        assert kcfg.TuningLedger(str(p)).entries == {}
    p.write_text(json.dumps(
        {"good": {"block_rows": 512}, "bad": 512, "worse": [1]}))
    led = kcfg.TuningLedger(str(p))
    assert led.entries == {"good": {"block_rows": 512}}


@BOTH
def test_ledger_save_is_atomic(kcfg, tmp_path):
    p = tmp_path / "ledger.json"
    led = kcfg.TuningLedger()
    led.put("a", {"block_rows": 512})
    led.save(str(p))
    led.put("b", {"block_rows": 256})
    led.save()
    assert [f.name for f in tmp_path.iterdir()] == ["ledger.json"]
    assert kcfg.TuningLedger(str(p)).entries == led.entries
    p.write_text('{"a": {"block_rows": 512}, "tr')  # torn mid-write
    led2 = kcfg.TuningLedger(str(p))
    assert led2.entries == {}
    led2.put("c", {"block_rows": 128})
    led2.save(str(p))
    assert kcfg.TuningLedger(str(p)).entries == {"c": {"block_rows": 128}}


@BOTH
def test_ledger_partial_entries_load(kcfg, tmp_path):
    key = _key(kcfg, "relax", 1000, 4, 2)
    p = tmp_path / "ledger.json"
    p.write_text(json.dumps({key: {"block_rows": 1024}}))
    led = kcfg.TuningLedger(str(p))
    assert led.get(key) == {"block_rows": 1024}
    assert led.get(_key(kcfg, "relax", 999, 4, 2)) is None


@BOTH
def test_ledger_save_without_path_raises(kcfg):
    led = kcfg.TuningLedger()
    led.put("k", {"block_rows": 128})
    with pytest.raises(ValueError, match="no ledger path"):
        led.save()


@BOTH
def test_ledger_roundtrip_remembers_path(kcfg, tmp_path):
    p = tmp_path / "ledger.json"
    led = kcfg.TuningLedger()
    led.put("a", {"block_rows": 512, "wall_s": 1e-4})
    assert led.save(str(p)) == str(p)
    led.put("b", {"boundaries": [8, 32], "split": 128})
    led.save()
    back = kcfg.TuningLedger(str(p))
    assert back.get("a") == {"block_rows": 512, "wall_s": 1e-4}
    assert back.get("b") == {"boundaries": [8, 32], "split": 128}


@BOTH
def test_resolve_slice_boundaries_padded_winner_maps_to_none(kcfg):
    key = _slicing_key(kcfg, "in", 777)
    kw = {"device": "cpu"} if kcfg is tcfg else {}
    kcfg.global_ledger().put(key, {"boundaries": None, "wall_s": 1e-4})
    assert kcfg.resolve_slice_boundaries("in", 777, **kw) is None
    kcfg.global_ledger().put(key, {"boundaries": [8, 32], "wall_s": 1e-4})
    assert kcfg.resolve_slice_boundaries("in", 777, **kw) == (8, 32)
    assert kcfg.resolve_slice_boundaries("out", 777, **kw) is None


def test_global_ledger_autoloads_the_ports_variable_only(tmp_path,
                                                          monkeypatch):
    key = tcfg.slicing_ledger_key("in", 500, device="cpu")
    p = tmp_path / "ledger.json"
    p.write_text(json.dumps({key: {"boundaries": [16, 64]}}))
    # the reference's variable never routes the port
    monkeypatch.setenv("REPRO_TUNING_LEDGER", str(p))
    tcfg.reset_global_ledger()
    assert tcfg.global_ledger().entries == {}
    assert tcfg.resolve_slice_boundaries("in", 500, "cpu") is None
    monkeypatch.setenv("REPRO_TORCH_TUNING_LEDGER", str(p))
    tcfg.reset_global_ledger()
    assert tcfg.global_ledger().get(key) == {"boundaries": [16, 64]}
    assert tcfg.resolve_slice_boundaries("in", 500, "cpu") == (16, 64)
    assert tcfg.global_ledger().path == str(p)


# ---------------------------------------------------------------------------
# the port's keys, files across packages, portfolio records
# ---------------------------------------------------------------------------


def test_kernel_shape_keys_carry_the_device():
    assert tcfg.device_tag("cpu") == "cpu"
    assert tcfg.ledger_key("relax", 1000, 8, 4, 2, device="cpu") == \
        "cpu:relax:n1000:d8:b4:l2"
    assert tcfg.slicing_ledger_key("out", 77, device="cpu") == \
        "cpu:slicing:out:n77"
    # the reference's keys lead with a kernel mode instead: the two never
    # collide in one file
    assert jcfg.slicing_ledger_key("out", 77).split(":", 1)[1] == \
        "slicing:out:n77"
    assert jcfg.slicing_ledger_key("out", 77) != \
        tcfg.slicing_ledger_key("out", 77, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcfg.ledger_key("relax", 1, 8, 1)  # None means the card


@pytest.mark.parametrize("writer,reader", [(jcfg, tcfg), (tcfg, jcfg)],
                         ids=["ref-to-port", "port-to-ref"])
def test_a_file_saved_by_either_package_loads_in_the_other(writer, reader,
                                                           tmp_path):
    led = writer.TuningLedger()
    writer.record_portfolio(led, "flat-uniform-shallow", 4, "delta@x0.5",
                            "sliced", wall_s=0.25, phases=20, queries=4,
                            delta=0.3, attribution={"light": 7, "heavy": 5})
    writer.record_portfolio(led, "skew", 8, "instatic|outstatic", "padded",
                            wall_s=1.5, phases=40, queries=8)
    led.put(_slicing_key(writer, "in", 99), {"boundaries": [8, 32]})
    led.put("foreign:key", {"block_rows": 256, "measured": {"128": 1e-4}})
    p = str(tmp_path / "ledger.json")
    led.save(p)
    back = reader.TuningLedger(p)
    assert back.entries == led.entries
    assert reader.portfolio_entries(back, "flat-uniform-shallow", 4) == \
        writer.portfolio_entries(led, "flat-uniform-shallow", 4)
    # one JSON layout: the reader saves the same bytes
    q = str(tmp_path / "again.json")
    back.save(q)
    assert open(p).read() == open(q).read()


def test_portfolio_records_equal_the_reference():
    leds = []
    for kcfg in (jcfg, tcfg):
        led = kcfg.TuningLedger()
        e1 = kcfg.record_portfolio(led, "flat", 4, "instatic|outstatic",
                                   "padded", wall_s=0.5, phases=10, queries=4)
        e2 = kcfg.record_portfolio(led, "flat", 4, "delta", "sliced",
                                   wall_s=0.25, phases=20, queries=4,
                                   delta=0.3,
                                   attribution={"light": 7, "heavy": 5})
        kcfg.record_portfolio(led, "skew", 4, "delta", "sliced",
                              wall_s=1.0, phases=0, queries=4)
        leds.append((led.entries, e1, e2,
                     kcfg.portfolio_entries(led, "flat", 4),
                     kcfg.portfolio_entries(led, "flat", 8),
                     kcfg.portfolio_ledger_key("f", 2, "in|out", "padded")))
    assert leds[0] == leds[1]
    assert leds[1][2]["qps"] == pytest.approx(16.0)
    assert leds[1][4] == {}


def test_measure_launch_publishes_every_repetition():
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        calls = []

        def fn():
            calls.append(1)
            return torch.zeros(3), (torch.ones(2),)

        wall = tcfg.measure_launch("relax", fn, reps=3)
    finally:
        set_default_registry(prev)
    assert len(calls) == 4  # one warm-up, three timed
    snap = reg.snapshot()["kernel.launch.relax"]
    assert snap["count"] == 3 and snap["min"] <= wall <= snap["max"]


def test_autotune_slicing_ledgers_the_winner():
    led = tcfg.TuningLedger()
    walls = {None: 3, (8,): 1, (8, 32): 2}

    def make_call(bset):
        def call():
            return torch.full((walls[bset] * 20000,), 1.0).cumsum(0)
        return call

    got = tcfg.autotune_slicing(make_call, 64, side="out",
                                boundary_sets=tuple(walls), reps=1,
                                ledger=led, device="cpu")
    entry = led.get(tcfg.slicing_ledger_key("out", 64, device="cpu"))
    assert set(entry["measured"]) == {"padded", "[8]", "[8, 32]"}
    best = min(entry["measured"], key=entry["measured"].get)
    assert got == (None if best == "padded" else tuple(json.loads(best)))
    assert entry["boundaries"] == (None if got is None else list(got))
    with pytest.raises(ValueError, match="non-empty"):
        tcfg.autotune_slicing(make_call, 64, boundary_sets=(), ledger=led,
                              device="cpu")


# ---------------------------------------------------------------------------
# the sliced builders read the ledger
# ---------------------------------------------------------------------------


def _assert_views_equal(jv, tv):
    assert len(jv.slices) == len(tv.slices)
    for a, b in zip(jv.slices, tv.slices):
        for f in ("rows", "cols", "ws"):
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    np.testing.assert_array_equal(np.asarray(jv.merge_idx),
                                  tv.merge_idx.numpy())


@pytest.mark.parametrize("side", ["in", "out"])
@pytest.mark.parametrize("bounds", [(8,), (8, 16), (16, 48, 96)])
def test_sliced_builders_take_tuned_boundaries_like_the_reference(side,
                                                                  bounds):
    gj = JGen.kronecker(7, seed=21)
    gt = TGen.kronecker(7, seed=21, device="cpu")
    jb = JG.to_ell_in_sliced if side == "in" else JG.to_ell_out_sliced
    tb = TG.to_ell_in_sliced if side == "in" else TG.to_ell_out_sliced
    before = tb(gt)  # built before tuning: the degree default
    jcfg.global_ledger().put(jcfg.slicing_ledger_key(side, gj.n),
                             {"boundaries": list(bounds)})
    tcfg.global_ledger().put(
        tcfg.slicing_ledger_key(side, gt.n, device="cpu"),
        {"boundaries": list(bounds)})
    jv, tv = jb(gj), tb(gt)
    _assert_views_equal(jv, tv)
    want = tuple(sorted({-(-b // 8) * 8 for b in bounds}))
    assert tv.widths[-1] == want[-1]
    # the memo is keyed by the resolved boundaries: no stale view
    assert tv is not before
    assert tb(gt) is tv
    assert tb(gt, boundaries=bounds) is tv
    # the other side is untouched by this side's record
    other = TG.to_ell_out_sliced if side == "in" else TG.to_ell_in_sliced
    jother = JG.to_ell_out_sliced if side == "in" else JG.to_ell_in_sliced
    _assert_views_equal(jother(gj), other(gt))


def test_reverse_graph_in_view_takes_the_in_sides_tuned_boundaries():
    """``transpose`` shares the view memos swapped; the reverse graph's
    in-view must still resolve the ``"in"`` side's record, as the
    reference's reverse graph does."""
    gj = JGen.kronecker(7, seed=4)
    gt = TGen.kronecker(7, seed=4, device="cpu")
    for kcfg, key in ((jcfg, jcfg.slicing_ledger_key("in", gj.n)),
                      (tcfg, tcfg.slicing_ledger_key("in", gt.n,
                                                     device="cpu"))):
        kcfg.global_ledger().put(key, {"boundaries": [8, 24]})
    out_t = TG.to_ell_out_sliced(gt)  # the "out" side: no record, default
    rt = TG.transpose(gt)
    rin_t = TG.to_ell_in_sliced(rt)
    rin_j = JG.to_ell_in_sliced(JG.transpose(gj))
    _assert_views_equal(rin_j, rin_t)
    assert rin_t.widths == (8, 24)
    assert rin_t is not out_t
    _assert_views_equal(JG.to_ell_out_sliced(gj), out_t)
    # the forward out-view built with the in side's boundaries is the same
    # memo entry as the reverse graph's tuned in-view
    assert TG.to_ell_out_sliced(gt, boundaries=(8, 24)) is rin_t
