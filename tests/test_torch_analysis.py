"""The port's analysis gate (``python -m repro_torch.analysis``), with the
contract of ``tests/test_analysis.py``: the shipped registry audits clean
on the CPU and the shipped tree lints clean, and every lint rule and every
CPU audit check has a negative control that makes the gate exit 1. The
card checks are tested here on hand-written ``ptxas`` text; they run on
the card in ``tests/test_torch_cuda.py``. Every reference contract has a
port contract of the same name, and on the reference's own spec cases,
carried over from numpy, the two packages' oracles give the same bits.
"""
import ctypes
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.kernels import registry as JR
from repro_torch import interop
from repro_torch.analysis import __main__ as gate
from repro_torch.analysis import kernel_audit as A
from repro_torch.analysis import lint as L
from repro_torch.analysis import trace_guard as G
from repro_torch.kernels import _build
from repro_torch.kernels import config as tcfg
from repro_torch.kernels import registry as R
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.registry import set_default_registry

torch.set_num_threads(1)
PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PORT_ONLY = {"ell_push_relax_batch", "ell_sliced_push_relax_batch",
             "ell_sliced_relax_keys_batch_push", "ell_key_min_status_batch",
             "ell_push_rect_batch", "embed_grad", "ell_delta_push_batch",
             "ell_sliced_delta_push_batch", "ell_settle_commit_batch",
             "ell_sliced_settle_commit_batch", "delta_thresholds_batch",
             "ell_delta_commit_batch", "ell_sliced_delta_commit_batch"}


@pytest.fixture(scope="module")
def reg():
    return R.collect()


def _gate(capsys, argv):
    rc = gate.main(argv)
    return rc, capsys.readouterr().out


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------


def test_shipped_registry_audits_clean(reg):
    report = A.audit_registry(reg)
    assert report.ok, [str(f) for f in report.findings]
    assert report.kernels == len(reg.names()) >= 33
    assert report.cases >= 100


def test_shipped_tree_lints_clean():
    assert L.lint_paths([PKG]) == []


def test_gate_exits_0_on_the_cpu_and_reports_the_card_checks_not_run(capsys):
    rc, out = _gate(capsys, [])
    assert rc == 0, out
    assert "lint: 0 finding(s)" in out and "0 finding(s)" in out
    assert "audit (card): not run" in out
    rc, out = _gate(capsys, ["--require-card"])
    assert rc == 1 and "--require-card" in out


def test_every_reference_contract_has_a_port_contract(reg):
    ref_names = set(JR.collect().names())
    assert len(ref_names) == 27
    assert ref_names <= set(reg.names())
    assert PORT_ONLY <= set(reg.names())
    assert set(reg.names()) - ref_names - PORT_ONLY == {
        "push_settled_batch", "push_settled_batch_sliced",
        "delta_push_relax_batch", "delta_thresholds"}
    for c in reg.contracts():
        assert c.oracle is not None and c.make_cases()
    # every __global__ kernel of csrc/ is launched by some contract
    claimed = {k for c in reg.contracts() for k in c.kernels}
    assert len(claimed) == 19


def test_the_cases_cover_the_ports_shapes(reg):
    labels = {case.label for c in reg.contracts() for case in c.make_cases()}
    for b, n in R.WIDE_SHAPES:
        assert f"b{b}_n{n}" in labels
    assert {f"groups_b{b}" for b in (1, 8, 13, 40)} <= labels
    groups = R.fixture_sliced_groups()
    live = [s for s in groups.slices if s.rows.shape[0]]
    assert len(live) > tcfg.SLICED_GROUP_BUCKETS  # two launch groups
    assert R.fixture_graph(signed=True).w.signbit().any()


def test_collect_refuses_an_oracle_less_contract(monkeypatch):
    monkeypatch.setattr(R, "KERNEL_MODULES", R.KERNEL_MODULES[:-1])
    with pytest.raises(RuntimeError, match="without oracles"):
        R.collect()
    r = R.KernelRegistry()
    r.register(R.KernelContract("x", "m", abs, lambda: ()))
    with pytest.raises(ValueError, match="twice"):
        r.register(R.KernelContract("x", "m", abs, lambda: ()))
    with pytest.raises(KeyError):
        r.bind_oracle("y", abs)


# ---------------------------------------------------------------------------
# the two packages' oracles on the reference's spec cases
# ---------------------------------------------------------------------------


def _carry(x):
    """A reference spec-case value as the port takes it."""
    if isinstance(x, jax.Array) or isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x, copy=True))
    if type(x).__name__ == "SlicedEll":
        return interop.sliced_from_numpy(
            {"slices": [{"rows": np.asarray(s.rows),
                         "cols": np.asarray(s.cols),
                         "ws": np.asarray(s.ws)} for s in x.slices],
             "merge_idx": np.asarray(x.merge_idx)}, device="cpu")
    if isinstance(x, tuple):
        return tuple(_carry(v) for v in x)
    return x


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    if x is None:
        return []
    a = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return [a.view(np.int32) if a.dtype == np.float32 else a]


@pytest.mark.parametrize("name", sorted(JR.collect().names()))
def test_both_oracles_agree_on_the_reference_cases(reg, name):
    ref = JR.collect().get(name)
    port = reg.get(name)
    for case in ref.make_cases():
        want = _leaves(ref.oracle(*case.args))
        got = _leaves(port.oracle(*_carry(case.args)))
        assert len(want) == len(got), case.label
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w.reshape(g.shape), g,
                                          err_msg=f"{name}/{case.label}")


# ---------------------------------------------------------------------------
# negative controls: every CPU audit check
# ---------------------------------------------------------------------------


def _one_contract_registry(contract):
    r = R.KernelRegistry()
    r.register(contract)
    return r


def _gate_with(monkeypatch, capsys, registry):
    import repro_torch.kernels.registry as kreg

    monkeypatch.setattr(kreg, "collect", lambda: registry)
    return _gate(capsys, ["--no-lint"])


def _crit_contract(**kw):
    base = R.collect().get("frontier_crit_lanes_batch")
    return dataclasses.replace(base, **kw)


def test_a_float_counter_is_a_finding(monkeypatch, capsys):
    base = R.collect().get("frontier_crit_lanes_batch")

    def float_count(d, status, keys, **kw):
        mins, cnt = base.wrapper(d, status, keys)
        return mins, cnt.float()

    bad = _crit_contract(wrapper=float_count, oracle=float_count)
    findings = A.audit_contract(bad)
    assert any(f.check == "dtype" and "work counter" in f.message
               for f in findings)
    rc, out = _gate_with(monkeypatch, capsys, _one_contract_registry(bad))
    assert rc == 1 and "work counter" in out


def test_a_wrong_dtype_is_a_finding(monkeypatch, capsys):
    base = R.collect().get("ell_key_min_batch")

    def f64_case():
        gate, cols, ws = base.make_cases()[0].args
        return (R.SpecCase("f64", (gate.double(), cols, ws)),
                R.SpecCase("i64", (gate, cols.long(), ws)))

    def narrowed(g, c, w):
        return base.oracle(g.float(), c.int(), w)

    bad = dataclasses.replace(base, make_cases=f64_case, wrapper=narrowed,
                              oracle=narrowed)
    findings = A.audit_contract(bad)
    msgs = [f.message for f in findings if f.check == "dtype"]
    assert any("float64" in m for m in msgs) and any("int64" in m
                                                     for m in msgs)
    rc, out = _gate_with(monkeypatch, capsys, _one_contract_registry(bad))
    assert rc == 1 and "[dtype]" in out


@pytest.mark.parametrize("how", ["shape", "bits"])
def test_an_oracle_mismatch_is_a_finding(monkeypatch, capsys, how):
    base = R.collect().get("ell_relax_batch")

    def wrong(dmask, cols, ws, **kw):
        out = base.oracle(dmask, cols, ws)
        return out[:, :-1] if how == "shape" else out + 1.0

    bad = dataclasses.replace(base, oracle=wrong)
    assert any(f.check == "oracle" for f in A.audit_contract(bad))
    rc, out = _gate_with(monkeypatch, capsys, _one_contract_registry(bad))
    assert rc == 1 and "[oracle]" in out


def test_an_int32_engine_counter_is_a_finding(monkeypatch, capsys):
    from repro_torch.core import static_engine as TS

    real = TS.init_batch_state

    def narrow(*a, **k):
        s = real(*a, **k)
        return dataclasses.replace(s, relax_edges=s.relax_edges.int())

    monkeypatch.setattr(TS, "init_batch_state", narrow)
    assert [f.case for f in A.audit_engine_counters()] == ["relax_edges"]
    rc, out = _gate_with(monkeypatch, capsys, R.KernelRegistry())
    assert rc == 1 and "not int64" in out


def test_a_define_mismatch_is_a_finding(monkeypatch, capsys):
    assert A.audit_geometry_mirrors() == []
    text = (_build.CSRC / "ell_push.cu").read_text()
    edited = text.replace("#define PUSH_THREADS 256", "#define PUSH_THREADS 128")
    assert edited != text
    sources = {f: (_build.CSRC / f).read_text()
               for f in _build.SOURCES.values()}
    sources["ell_push.cu"] = edited
    findings = A.audit_geometry_mirrors(sources)
    assert [(f.kernel, f.case) for f in findings] == [("ell_push.cu",
                                                       "PUSH_THREADS")]
    gone = dict(sources, **{"ell_push.cu": edited.replace(
        "#define PUSH_THREADS 128", "")})
    assert "no such" in A.audit_geometry_mirrors(gone)[0].message
    monkeypatch.setitem(tcfg.GEOMETRY_MIRRORS, ("frontier_crit.cu", "KMAX"),
                        16)
    rc, out = _gate_with(monkeypatch, capsys, R.KernelRegistry())
    assert rc == 1 and "[mirror]" in out and "KMAX" in out


def test_parse_defines_evaluates_expressions():
    got = A.parse_defines("#define A 8\n#define B (A + 8)  // note\n"
                          "#define C B * 2 / 4\n#define D 0xffu\n"
                          "#define E F\n")
    assert got == {"A": 8, "B": 16, "C": 8}


# ---------------------------------------------------------------------------
# the card checks on hand-written ptxas text
# ---------------------------------------------------------------------------

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11crit_kernelILi1ELb1EEv8CritArgs' for 'sm_90a'
ptxas info    : Function properties for _Z11crit_kernelILi1ELb1EEv8CritArgs
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11crit_kernelILi0ELb0EEv8CritArgs' for 'sm_90a'
ptxas info    : Function properties for _Z11crit_kernelILi0ELb0EEv8CritArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 200 bytes smem, 400 bytes cmem[0]
"""


def _resources(regs=56, smem=132, spill=0, extra=""):
    return {"frontier_crit": _build.parse_ptxas(
        PTXAS.format(regs=regs, smem=smem, spill=spill) + extra)}


def test_parse_ptxas_reads_every_instance():
    res = _resources()["frontier_crit"]
    assert set(res) == {"crit_kernel"}
    k = res["crit_kernel"]
    assert (k["registers"], k["smem_bytes"]) == (56, 200)
    assert k["instances"][(1, 1)]["registers"] == 56
    assert k["instances"][(0, 0)]["smem_bytes"] == 200


def test_resources_within_the_limits_pass(reg):
    findings, rows = A.audit_resources(_resources(), reg)
    assert findings == []
    assert rows == [("frontier_crit", "crit_kernel", 56, 200, 0, 0, 2)]


@pytest.mark.parametrize("kw, phrase", [
    ({"regs": 72}, "blocks an SM"),  # 72 x 256 x 4 > 65,536
    ({"regs": 300}, "registers a thread"),
    ({"smem": 240000}, "shared bytes"),
    ({"spill": 16}, "spills"),
])
def test_resources_over_a_limit_are_findings(reg, kw, phrase):
    findings, _ = A.audit_resources(_resources(**kw), reg)
    assert findings and all(f.check == "resources" for f in findings)
    assert any(phrase in f.message for f in findings), findings


def test_a_spill_a_contract_allows_is_no_finding(reg):
    # the shipped contracts allow crit_kernel's K = 7 and 8 scalar forms
    text = PTXAS.replace("ILi1ELb1EE", "ILi7ELb0EE")
    res = {"frontier_crit": _build.parse_ptxas(text.format(
        regs=56, smem=132, spill=36))}
    assert A.audit_resources(res, reg)[0] == []
    # an allowance names one instance: <1,1> is not covered by them
    findings, _ = A.audit_resources(_resources(spill=16), reg)
    assert [f.message[:5] for f in findings] == ["<1,1>"]
    r = R.KernelRegistry()
    for c in reg.contracts():
        r.register(dataclasses.replace(
            c, spills_ok={"crit_kernel<1,1>": "measured: no cost"})
            if c.name == "frontier_crit" else c)
    findings, _ = A.audit_resources(_resources(spill=16), r)
    assert findings == []


@pytest.mark.parametrize("threads", [200, 1056])
def test_a_launch_of_partial_warps_or_too_many_threads_is_a_finding(
        reg, threads):
    defines = A.source_defines()
    defines["frontier_crit.cu"]["CRIT_THREADS"] = threads
    findings, _ = A.audit_resources(_resources(), reg, defines)
    assert any("threads a block" in f.message for f in findings), findings


def test_the_scan_bodys_dynamic_shared_memory_counts(reg):
    text = PTXAS.replace("crit_kernel", "scan_kernel").replace(
        "_Z11scan_kernelILi1ELb1EE", "_Z11scan_kernelILi8ELb1ELb0EE")
    res = {"ell_gather": _build.parse_ptxas(text.format(
        regs=64, smem=0, spill=0))}
    findings, _ = A.audit_resources(res, reg)
    assert findings == []  # 82,080 dynamic bytes: within a block's
    defines = A.source_defines()
    defines["ell_gather.cu"]["SCAN_STAGE_ELEMS"] = 15000  # 3 x the stage
    findings, _ = A.audit_resources(res, reg, defines)
    assert any("dynamic" in f.message for f in findings)


def test_an_unclaimed_kernel_is_a_finding(reg):
    extra = PTXAS.replace("crit_kernel", "new_kernel").replace(
        "_Z11new_kernel", "_Z10new_kernel").format(regs=8, smem=0, spill=0)
    findings, _ = A.audit_resources(_resources(extra=extra), reg)
    assert [f.kernel for f in findings] == ["frontier_crit.cu:new_kernel"]


def test_resource_records_need_a_build():
    if _build.ptxas_path("frontier_crit").exists():
        pytest.skip("this checkout holds a build record")
    with pytest.raises(FileNotFoundError, match="build"):
        _build.kernel_resources("frontier_crit")


def test_every_build_keeps_its_ptxas_record():
    assert "-Xptxas" in _build.NVCC_FLAGS and "-v" in _build.NVCC_FLAGS
    rec = _build.ptxas_path("ell_push")
    assert rec.name.endswith(".ptxas.txt")
    assert rec.name[:-len(".ptxas.txt")] == _build.library_path(
        "ell_push").stem


# ---------------------------------------------------------------------------
# negative controls: every lint rule
# ---------------------------------------------------------------------------

LINT_CASES = [
    ("kernel-launch-site", "serving/x.py",
     "from repro_torch.kernels import _build\nlib = _build.load('a', {})\n"),
    ("kernel-launch-site", "core/x.py",
     "import ctypes\nlib = ctypes.CDLL('libx.so')\n"),
    ("padding-outside-ops", "core/x.py",
     "import torch.nn.functional as F\ny = F.pad(x, (0, 1))\n"),
    ("padding-outside-ops", "serving/x.py",
     "import torch\ny = torch.nn.functional.pad(x, (0, 1))\n"),
    ("unregistered-kernel-module", "kernels/x.py",
     "from repro_torch.kernels import _build\n\ndef lib():\n"
     "    return _build.load('x', {})\n"),
    ("env-outside-config", "serving/x.py",
     "import os\nmode = os.environ.get('REPRO_TORCH_KERNEL_MODE')\n"),
    ("env-outside-config", "core/x.py",
     "import os\nmode = os.environ['REPRO_TORCH_SCAN_FUSION']\n"),
    ("raw-timer", "core/x.py", "import time\nt0 = time.perf_counter()\n"),
    ("raw-timer", "serving/x.py", "import time\nt0 = time.time()\n"),
    ("swallowed-exception", "core/x.py",
     "try:\n    f()\nexcept Exception:\n    pass\n"),
    ("swallowed-exception", "obs/x.py", "try:\n    f()\nexcept:\n    g()\n"),
    ("hardcoded-twin", "core/x.py", "y = f(x, use_kernels=False)\n"),
    ("hardcoded-twin", "serving/x.py",
     "def f(x, *, use_kernels=False):\n    return x\n"),
    ("reference-import", "core/x.py", "import jax.numpy as jnp\n"),
    ("reference-import", "serving/x.py", "from repro.core import graph\n"),
]


@pytest.mark.parametrize("rule, rel, src", LINT_CASES)
def test_each_lint_rule_fires(tmp_path, capsys, rule, rel, src):
    path = f"src/repro_torch/{rel}"
    found = L.lint_source(src, path)
    assert [f.rule for f in found] == [rule]
    # the pragma silences exactly that rule on that line
    lines = src.splitlines()
    lines[found[0].line - 1] += f"  # repro_torch: allow({rule})"
    assert L.lint_source("\n".join(lines) + "\n", path) == []
    # and the gate exits 1 on the file
    f = tmp_path / "repro_torch" / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    rc, out = _gate(capsys, ["--no-audit", "--paths", str(f)])
    assert rc == 1 and f"[{rule}]" in out


def test_lint_rules_keep_their_zones():
    ok = [
        ("kernels/x.py", "from repro_torch.kernels import _build\n\n"
         "def lib():\n    return _build.load('x', {})\n\n"
         "def register_kernels(reg):\n    pass\n"),
        ("kernels/config.py", "import os\nm = os.environ.get('REPRO_TORCH_X')\n"),
        ("obs/timer.py", "import time\nt = time.perf_counter()\n"),
        ("kernels/ref.py", "y = f(x, use_kernels=False)\n"),
        ("analysis/x.py", "y = f(x, use_kernels=False)\n"),
        ("kernels/ops.py", "import torch.nn.functional as F\ny = F.pad(x, (1,))\n"),
        ("core/x.py", "try:\n    f()\nexcept ValueError:\n    pass\n"),
        ("core/x.py", "import os\nos.environ['REPRO_TORCH_X'] = '1'\n"),
        ("core/x.py", "from .graph import Graph\nimport repro_torch\n"),
    ]
    for rel, src in ok:
        assert L.lint_source(src, f"/x/core/obs/src/repro_torch/{rel}") == [], rel
    assert set(L.RULES) == {r for r, _, _ in LINT_CASES}


# ---------------------------------------------------------------------------
# the build sentinel
# ---------------------------------------------------------------------------


def test_trace_guard_counts_builds_and_first_loads(monkeypatch):
    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        def __getattr__(self, name):
            return FakeFn()

    monkeypatch.setattr(_build, "build", lambda names=None: {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_loaded", {})
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        with pytest.raises(G.RetraceError, match="1 kernel compile"):
            with G.TraceGuard(label="warm loop") as tg:
                _build.load("ell_push", {"f": ([], None)})
                assert tg.compiles == 1
        with G.TraceGuard() as tg:  # loaded already: no second count
            _build.load("ell_push", {"f": ([], None)})
        assert tg.compiles == 0
        with G.TraceGuard(max_compiles=1):
            _build.load("frontier_crit", {"f": ([], None)})
        # an exception inside the block passes through, unmasked
        with pytest.raises(KeyError):
            with G.TraceGuard():
                _build.load("ell_gather", {})
                raise KeyError("inner")
    finally:
        set_default_registry(prev)
    assert reg.snapshot()["trace_guard.retrace_errors"]["value"] == 1
    assert G.TraceGuard().compiles == 0  # not entered


def test_a_warmed_cpu_serving_loop_compiles_nothing():
    from repro_torch.graphs import uniform_gnp
    from repro_torch.serving import StaticBackend

    g = uniform_gnp(64, 0.1, seed=1, device="cpu")
    be = StaticBackend(g, device="cpu", policy="in|out")
    state = be.init(2)
    state = be.reset_lanes(state, np.array([0, 5]))
    with G.TraceGuard() as tg:
        for _ in range(3):
            state = be.step(state, 4)
    assert tg.compiles == 0 and G.compile_count() == _build.compile_count()
