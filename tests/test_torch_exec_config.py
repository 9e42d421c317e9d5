"""The port's execution config (``repro_torch.kernels.config``) against the
reference's where it has a meaning here: the kernel mode, the scans' split
form (``tools/scan_variants.py``: bit-equal to the fused scans on both
layouts, and to the reference's ``REPRO_SCAN_FUSION=split``), the timer,
and the portfolio's device tags.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels import config as jcfg
from repro.kernels import ops as jops
from repro.serving import backends as JB
from repro_torch.core import static_engine as TS
from repro_torch.core.graph import to_ell_in_sliced, to_ell_out_sliced
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import config as tcfg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import registry as R
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.registry import set_default_registry
from repro_torch.serving import backends as TB

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "scan_variants",
    Path(__file__).resolve().parents[1] / "tools" / "scan_variants.py")
scan_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scan_tool)
INF = np.float32(np.inf)
FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
          "total_phases")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """A fresh process ledger each test, and no mode variables."""
    for var in ("REPRO_TORCH_KERNEL_MODE", "REPRO_SCAN_FUSION",
                "REPRO_TORCH_TUNING_LEDGER"):
        monkeypatch.delenv(var, raising=False)
    tcfg.reset_global_ledger()
    yield
    tcfg.reset_global_ledger()


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(want, got):
    want, got = _bits(want), _bits(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# kernel mode
# ---------------------------------------------------------------------------


def test_bad_kernel_mode_rejected(monkeypatch):
    # no mode swaps a kernel for its twin on the card: "twins" is refused
    for bad in ("compiled", "twins"):
        monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", bad)
        with pytest.raises(ValueError, match="REPRO_TORCH_KERNEL_MODE"):
            tcfg.kernel_mode()


def test_kernel_mode_resolution(monkeypatch):
    assert tcfg.kernel_mode() == "auto"
    x = torch.zeros(2)
    assert tcfg.runs_twin(x) is True  # auto: a CPU tensor runs the twin
    monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", "  Kernels ")  # normalised
    assert tcfg.kernel_mode() == "kernels"
    with pytest.raises(RuntimeError, match="CPU tensor"):
        tcfg.runs_twin(x)


def test_kernels_mode_refuses_cpu_tensors(monkeypatch):
    cols, ws = R.fixture_ell()
    gate = R.fixture_lane_batch()
    want = tops.key_min_batch(gate[:, :-1], cols, ws)  # auto: the twin
    monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", "kernels")
    with pytest.raises(RuntimeError, match="CPU tensor"):
        tops.key_min_batch(gate[:, :-1], cols, ws)
    # an explicit use_kernels=False still runs the twin (explicit wins)
    assert_bits(want, tops.key_min_batch(gate[:, :-1], cols, ws,
                                         use_kernels=False))


# ---------------------------------------------------------------------------
# the scans' split form
# ---------------------------------------------------------------------------


def _scan_inputs(seed, b, n, k=2):
    rng = np.random.default_rng(seed)

    def rows(*shape):
        x = rng.uniform(0, 3, shape).astype(np.float32)
        x[rng.random(shape) < 0.3] = INF
        return x

    return dict(d=rows(b, n), settle=rng.random((b, n)) < 0.4,
                parts=[tuple(rows(b, n) for _ in range(3)) for _ in range(k)],
                gates=rows(k, b, n), dga=rows(b, n), dgb=rows(b, n))


def _fused_split_refuse(monkeypatch):
    """In the split form the fused kernels must not be reached."""
    def refuse(*a, **k):
        raise AssertionError("a fused kernel ran in the split form")

    for name in ("ell_relax_keys_batch", "ell_keys_dep_batch",
                 "ell_sliced_relax_keys_batch", "ell_sliced_keys_dep_batch"):
        monkeypatch.setattr(tops, name, refuse)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_split_scans_equal_fused_and_the_reference_split(monkeypatch, layout,
                                                         b):
    gj = JGen.kronecker(6, seed=b)
    gt = TGen.kronecker(6, seed=b, device="cpu")
    n = gt.n
    x = _scan_inputs(b, b, n)
    T = torch.from_numpy
    if layout == "padded":
        from repro.core.graph import to_ell_in as j_in, to_ell_out as j_out
        from repro_torch.core.graph import to_ell_in, to_ell_out
        ell_j, ell_t = j_in(gj), to_ell_in(gt)
        out_j, out_t = j_out(gj), to_ell_out(gt)
    else:
        from repro.core.graph import to_ell_in_sliced as j_in_s
        from repro.core.graph import to_ell_out_sliced as j_out_s
        kw = dict(boundaries=(2, 4, 8), pad_multiple=2)
        ell_j, ell_t = j_in_s(gj, **kw), to_ell_in_sliced(gt, **kw)
        out_j, out_t = j_out_s(gj, **kw), to_ell_out_sliced(gt, **kw)
    tp = tuple(tuple(T(p) for p in ps) for ps in x["parts"])
    jp = tuple(tuple(jnp.asarray(p) for p in ps) for ps in x["parts"])

    def port():
        ins = tops.in_scan_relax_keys_batch(T(x["d"]), T(x["settle"]), tp,
                                            ell_t)
        outs = [tops.out_scan_keys_batch(
            T(x["gates"]), (T(x["dga"]), T(x["dgb"]), dep), out_t)
            for dep in (0, 1)]
        return [ins[0], ins[1], *outs]

    fused = port()
    with monkeypatch.context() as m, scan_tool.split_scans():
        _fused_split_refuse(m)
        split = port()
    assert tops.in_scan_relax_keys_batch is not scan_tool.split_in_scan
    for a, c in zip(fused, split):
        assert_bits(a, c)
    # the reference's split shape on the same inputs (interpret mode)
    monkeypatch.setenv("REPRO_SCAN_FUSION", "split")
    kw = dict(block_rows=32)
    want = jops.in_scan_relax_keys_batch(
        jnp.asarray(x["d"]), jnp.asarray(x["settle"]), jp, ell_j, **kw)
    assert_bits(want[0], split[0])
    assert_bits(want[1], split[1])
    for dep, got in zip((0, 1), split[2:]):
        assert_bits(jops.out_scan_keys_batch(
            jnp.asarray(x["gates"]), (jnp.asarray(x["dga"]),
                                      jnp.asarray(x["dgb"]), dep),
            out_j, **kw), got)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_split_solves_equal_fused_and_the_reference(monkeypatch, layout):
    gj = JGen.uniform_gnp(90, 0.07, seed=4)
    gt = TGen.uniform_gnp(90, 0.07, seed=4, device="cpu")
    srcs = [0, 11, 40]
    kw = dict(criterion="in|out", layout=layout)
    fused = TS.run_phased_static_batch(gt, srcs, device="cpu", **kw)
    with monkeypatch.context() as m, scan_tool.split_scans():
        _fused_split_refuse(m)
        split = TS.run_phased_static_batch(gt, srcs, device="cpu", **kw)
    want = JS.run_phased_static_batch(gj, srcs, use_pallas=False, **kw)
    for f in FIELDS:
        assert_bits(getattr(fused, f), getattr(split, f))
        assert_bits(getattr(want, f), getattr(split, f))


# ---------------------------------------------------------------------------
# the timer
# ---------------------------------------------------------------------------


def test_measure_launch_times_cpu_work_on_the_host_clock():
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        calls = []

        def fn():
            calls.append(1)
            return torch.zeros(3)

        wall = tcfg.measure_launch("crit", fn, reps=5)
        host = tcfg.measure_launch("crit", fn, reps=5, clock="host")
        with pytest.raises(ValueError, match="clock"):
            tcfg.measure_launch("crit", fn, clock="events")
    finally:
        set_default_registry(prev)
    assert len(calls) == 12  # a warm-up and five timed, twice
    snap = reg.snapshot()["kernel.launch.crit"]
    assert snap["count"] == 10 and snap["min"] <= min(wall, host)
    assert 0 <= wall < 1 and 0 <= host < 1


# ---------------------------------------------------------------------------
# the portfolio's device tags
# ---------------------------------------------------------------------------


def _portfolio_ledger(tags):
    led = tcfg.TuningLedger()
    for (policy, layout, qps), tag in zip(
            (("instatic|outstatic", "padded", 1.0), ("in|out", "padded", 5.0),
             ("delta", "sliced", 3.0)), tags):
        e = tcfg.record_portfolio(led, "flat", 4, policy, layout,
                                  wall_s=4 / qps, phases=10, queries=4)
        if tag is not None:
            e["device"] = tag
            led.put(tcfg.portfolio_ledger_key("flat", 4, policy, layout), e)
    return led


def test_record_portfolio_tags_the_device_only_when_given():
    led = tcfg.TuningLedger()
    e = tcfg.record_portfolio(led, "flat", 4, "delta", "sliced", wall_s=1.0,
                              phases=3, queries=4)
    assert "device" not in e
    e = tcfg.record_portfolio(led, "flat", 4, "delta", "sliced", wall_s=1.0,
                              phases=3, queries=4, device="cpu")
    assert e["device"] == "cpu"
    # the reference reads the tagged file and routes by it
    assert jcfg.portfolio_entries(led, "flat", 4) == tcfg.portfolio_entries(
        led, "flat", 4)


def test_pick_engine_skips_other_devices():
    cands = TB.DEFAULT_CANDIDATES
    # every entry from the card: the CPU routes to the first candidate
    led = _portfolio_ledger(["sm_90"] * 3)
    assert TB.pick_engine("flat", 4, cands, led, device="cpu") == cands[0]
    assert TB.pick_engine("flat", 4, cands, led).policy == "in|out"
    # tagged cpu entries route the cpu; untagged (the reference's) route all
    led = _portfolio_ledger(["cpu", "sm_90", None])
    got = TB.pick_engine("flat", 4, cands, led, device="cpu")
    assert (got.policy, got.layout) == ("delta", "sliced")
    jc = JB.pick_engine("flat", 4, JB.DEFAULT_CANDIDATES, led)
    assert (jc.policy, jc.layout) == ("in|out", "padded")


def test_portfolio_backend_ignores_another_devices_entries(monkeypatch):
    g = TGen.uniform_gnp(48, 0.15, seed=3, device="cpu")
    fam = TB.graph_family(g)
    led = tcfg.TuningLedger()
    tcfg.record_portfolio(led, fam, 2, "in|out", "padded", wall_s=0.01,
                          phases=5, queries=2)
    led.entries[tcfg.portfolio_ledger_key(fam, 2, "in|out", "padded")][
        "device"] = "sm_90"
    probed = []
    monkeypatch.setattr(TB, "measure_portfolio",
                        lambda *a, **k: probed.append(1))
    be = TB.PortfolioBackend(g, lanes_hint=2, ledger=led)
    assert probed == [1]  # no entry of this device: it probes
    assert be.choice == TB.DEFAULT_CANDIDATES[0]
