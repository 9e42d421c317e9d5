"""Kernel contract auditor (counterpart of ``repro.analysis.kernel_audit``).

A CUDA kernel has no BlockSpecs to abstract-evaluate, so the reference's
grid x BlockSpec coverage, race and VMEM passes become two measured checks
on the card, beside the checks the CPU can make. Every check reports
findings; the card checks report themselves as not run where there is no
card, and never pass in silence.

On the CPU (:func:`audit_registry`):

  * **dtype** — every tensor a contract's cases pass or get back: floats
    exactly f32 (the +inf padding and the -0 / NaN rules are f32's), index
    and count tensors int32, uint8 or bool (a sliced view's ``merge_ptr``
    offsets are int64 by design: a hub's edges may pass 2^31; so are the
    stepper's ``sum_fringe`` / ``relax_edges``, which the phase-committing
    pair writes), and the ``counter_outputs`` integers.
  * **oracle** — the wrapper's output tree equals its oracle's in shape
    and dtype, leaf for leaf, and in bits (every NaN one value; on the CPU
    the wrapper runs the twins, so this holds the ops layer's padding and
    dispatch against the twin's composition).
  * **engine counters** (:func:`audit_engine_counters`) — the stepper's
    cumulative ``sum_fringe`` / ``relax_edges`` are int64. This replaces
    the reference's two-limb rule, which exists only because JAX runs
    without x64.
  * **geometry mirrors** (:func:`audit_geometry_mirrors`) — every value of
    ``config.GEOMETRY_MIRRORS`` equals the ``#define`` it mirrors in
    ``csrc/``.

On the card only (:func:`audit_card`):

  * **resources** (:func:`audit_resources`) — from each build's ``ptxas``
    record (``_build.kernel_resources``), for every instance of every
    ``__global__`` kernel at the launch shape its source gives it
    (:func:`launch_shapes`): whole warps, at most 1,024 threads a block,
    registers x threads x the blocks an SM it asks for within 65,536, at
    most 255 registers a thread, static plus dynamic
    shared memory within 232,448 bytes a block, and no spill unless a
    contract that launches the kernel gives a reason for that instance
    (``spills_ok``); a kernel no contract claims is a finding too.
  * **coverage** (:func:`audit_coverage`) — each case runs 3 times on the
    card, each run after the caching allocator was poisoned: blocks of the
    outputs' sizes filled with the NaN payload ``0x7fa5a5a5`` (the card's
    arithmetic makes only the canonical NaN) and freed. An output cell that
    still holds the poison was never written; every cell's bits are held
    against the twin (every NaN one value), and a run that differs from
    the first is a finding.
"""
from __future__ import annotations

import ast
import dataclasses
import operator
import re

import numpy as np
import torch

from repro_torch.kernels import config as kcfg
from repro_torch.kernels import registry as kreg

ALLOWED_INT = frozenset((torch.int32, torch.uint8, torch.bool))
# int64 by design (see docstring): offsets, and the stepper's cumulative
# counters a committed phase writes
WIDE_FIELDS = frozenset(("merge_ptr", "sum_fringe", "relax_edges"))
COUNTERS = ("sum_fringe", "relax_edges")
POISON = 0x7FA5A5A5  # a NaN payload the card's arithmetic never makes
RUNS = 3  # coverage runs a case


@dataclasses.dataclass(frozen=True)
class Finding:
    kernel: str
    case: str
    check: str  # dtype | oracle | call | counter | mirror | resources | coverage
    message: str

    def __str__(self):
        return f"[{self.check}] {self.kernel}/{self.case}: {self.message}"


@dataclasses.dataclass(frozen=True)
class AuditReport:
    findings: tuple[Finding, ...]
    kernels: int
    cases: int

    @property
    def ok(self) -> bool:
        return not self.findings


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------


def tensor_leaves(x, field: str = ""):
    """``(field, tensor)`` for every tensor in ``x`` (tensors, tuples,
    lists, NamedTuples, dicts), depth first; ``field`` is the innermost
    NamedTuple field or dict key a tensor sits under."""
    if torch.is_tensor(x):
        yield field, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            yield from tensor_leaves(v, name)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensor_leaves(v, field)
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from tensor_leaves(v, str(k))


def to_device(x, dev):
    """``x`` with every tensor moved to ``dev`` (the structure kept)."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x


def _outputs(out) -> list[torch.Tensor]:
    return [t for _, t in tensor_leaves(out)]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality with every NaN taken as one value."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a = torch.where(torch.isnan(a), float("nan"), a).view(torch.int32)
        b = torch.where(torch.isnan(b), float("nan"), b).view(torch.int32)
    return bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# CPU checks
# ---------------------------------------------------------------------------


def check_dtypes(emit, contract, case, out) -> None:
    """The dtype discipline over a case's inputs and a wrapper's outputs."""
    for where, tree in (("in", (case.args, case.kwargs)), ("out", out)):
        for field, t in tensor_leaves(tree):
            if t.dtype.is_floating_point:
                if t.dtype != torch.float32:
                    emit("dtype", f"{where} {field or 'tensor'} is {t.dtype}"
                                  ", not float32")
            elif t.dtype not in ALLOWED_INT and not (
                    t.dtype == torch.int64 and field in WIDE_FIELDS):
                emit("dtype", f"{where} {field or 'tensor'} is {t.dtype}, "
                              "outside int32 / uint8 / bool")
    outs = _outputs(out)
    for pos in contract.counter_outputs:
        if pos >= len(outs):
            emit("dtype", f"counter output {pos} missing ({len(outs)} "
                          "outputs)")
        elif outs[pos].dtype.is_floating_point:
            emit("dtype", f"out[{pos}] is a work counter but has "
                          f"{outs[pos].dtype}")


def check_oracle(emit, got, want) -> None:
    g, w = _outputs(got), _outputs(want)
    shapes = [(tuple(t.shape), t.dtype) for t in g]
    want_shapes = [(tuple(t.shape), t.dtype) for t in w]
    if shapes != want_shapes:
        emit("oracle", f"wrapper outputs {shapes} != oracle outputs "
                       f"{want_shapes}")
        return
    for pos, (a, b) in enumerate(zip(g, w)):
        if not same_bits(a.cpu(), b.cpu()):
            emit("oracle", f"out[{pos}] differs from the oracle's bits")


def audit_contract(contract: kreg.KernelContract) -> list[Finding]:
    """Every spec case of one contract through the CPU checks."""
    findings: list[Finding] = []
    for case in contract.make_cases():
        def emit(check, message, _case=case.label):
            findings.append(Finding(contract.name, _case, check, message))

        try:
            got = contract.wrapper(*case.args, **case.kwargs)
        except Exception as e:  # noqa: BLE001 (a finding, not a crash)
            emit("call", f"wrapper raised {e!r}")
            continue
        check_dtypes(emit, contract, case, got)
        if contract.oracle is None:
            emit("oracle", "no oracle bound")
            continue
        try:
            want = contract.oracle(*case.args, **case.kwargs)
        except Exception as e:  # noqa: BLE001
            emit("oracle", f"oracle raised {e!r}")
            continue
        check_oracle(emit, got, want)
    return findings


def audit_engine_counters() -> list[Finding]:
    """The stepper's cumulative work counters must be int64."""
    from repro_torch.core.graph import from_coo
    from repro_torch.core.static_engine import init_batch_state

    g = from_coo(np.array([0, 1], np.int32), np.array([1, 0], np.int32),
                 np.array([1.0, 1.0], np.float32), 2, device="cpu")
    state = init_batch_state(g, [0], device="cpu")
    findings = []
    for name in COUNTERS:
        t = getattr(state, name, None)
        if t is None:
            findings.append(Finding("static_engine.BatchState", name,
                                    "counter", f"no counter {name}"))
        elif t.dtype != torch.int64:
            findings.append(Finding(
                "static_engine.BatchState", name, "counter",
                f"{name} is {t.dtype}, not int64: cumulative edge counts "
                "pass 2^31 on reachable workloads"))
    return findings


_DEFINE = re.compile(r"^[ \t]*#define[ \t]+([A-Za-z_]\w*)[ \t]+(.+?)[ \t]*"
                     r"(//.*)?$", re.M)


def parse_defines(text: str) -> dict[str, int]:
    """The integer ``#define`` s of a CUDA source, expressions of earlier
    ones (``+ - * /``, parentheses) evaluated; others are left out."""
    raw = {m.group(1): m.group(2).strip() for m in _DEFINE.finditer(text)}
    out: dict[str, int] = {}

    def value(name, seen=()):
        if name in out:
            return out[name]
        if name not in raw or name in seen:
            raise ValueError(name)
        node = ast.parse(raw[name], mode="eval").body
        out[name] = int(_eval(node, lambda nm: value(nm, seen + (name,))))
        return out[name]

    for name in raw:
        try:
            value(name)
        except (ValueError, SyntaxError, TypeError):
            out.pop(name, None)
    return out


_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.FloorDiv: operator.floordiv,
           ast.Div: operator.floordiv}  # C's integer division


def _eval(node, lookup):
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return lookup(node.id)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_eval(node.left, lookup),
                                      _eval(node.right, lookup))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval(node.operand, lookup)
    raise TypeError(ast.dump(node))


def source_defines(sources: dict[str, str] | None = None
                   ) -> dict[str, dict[str, int]]:
    """``{source name: its #defines}`` for ``csrc/*.cu`` (``sources``:
    file name -> text, to check other text)."""
    from repro_torch.kernels import _build

    if sources is None:
        sources = {f: (_build.CSRC / f).read_text()
                   for f in _build.SOURCES.values()}
    return {f: parse_defines(text) for f, text in sources.items()}


def audit_geometry_mirrors(sources: dict[str, str] | None = None,
                           mirrors: dict | None = None) -> list[Finding]:
    """Every ``config.GEOMETRY_MIRRORS`` value against its ``#define``."""
    defines = source_defines(sources)
    mirrors = kcfg.GEOMETRY_MIRRORS if mirrors is None else mirrors
    findings = []
    for (src, name), want in sorted(mirrors.items()):
        got = defines.get(src, {}).get(name)
        if got != want:
            findings.append(Finding(
                src, name, "mirror",
                f"config.py says {want}, the source "
                + ("has no such #define" if got is None else f"says {got}")))
    return findings


def audit_registry(reg: kreg.KernelRegistry | None = None, *,
                   engines: bool = True, mirrors: bool = True) -> AuditReport:
    """The CPU checks over every registered contract (and the engine
    counters and geometry mirrors)."""
    reg = kreg.collect() if reg is None else reg
    findings: list[Finding] = []
    cases = 0
    for contract in reg.contracts():
        cases += len(contract.make_cases())
        findings.extend(audit_contract(contract))
    if engines:
        findings.extend(audit_engine_counters())
    if mirrors:
        findings.extend(audit_geometry_mirrors())
    return AuditReport(findings=tuple(findings), kernels=len(reg.names()),
                       cases=cases)


# ---------------------------------------------------------------------------
# Card checks
# ---------------------------------------------------------------------------

def launch_shapes(defines: dict[str, dict[str, int]]) -> dict:
    """``{(source, kernel): shape(template values) -> (threads a block,
    blocks an SM asked for, dynamic shared bytes)}``: the launches of each
    ``__global__`` kernel as its source and its wrapper make them
    (``config.RELAX_THREADS``, ``config.CRIT_BLOCKS_PER_SM``).
    ``pack_kernel`` runs at the relax's threads or the scan body's; the
    larger is checked."""
    g, p, c, e = (defines["ell_gather.cu"], defines["ell_push.cu"],
                  defines["frontier_crit.cu"], defines["embed_grad.cu"])
    relax, crit_blocks = kcfg.RELAX_THREADS, kcfg.CRIT_BLOCKS_PER_SM
    scan_smem = (4 * g["SCAN_STAGES"] * 2 * g["SCAN_STAGE_ELEMS"]
                 + 8 * 2 * g["SCAN_STAGES"])

    def scan(targs):  # scan_kernel<W, SKIP, BITS>
        skip = len(targs) > 1 and bool(targs[1])
        warps = g["SCAN_SKIP_WARPS"] if skip else g["SCAN_WARPS"]
        return (32 * warps + 32, 1 if skip else g["SCAN_BLOCKS_PER_SM"],
                scan_smem)

    def fixed(threads, blocks=1):
        return lambda targs: (threads, blocks, 0)

    return {
        ("ell_gather", "pack_kernel"): fixed(max(relax, 32 * g["SCAN_WARPS"])),
        ("ell_gather", "pack_status_kernel"): fixed(32 * g["SCAN_WARPS"]),
        ("ell_gather", "gather_min_kernel"): fixed(relax),
        ("ell_gather", "scan_kernel"): scan,
        ("ell_gather", "sliced_gather_min_kernel"): fixed(relax),
        ("ell_gather", "merge_kernel"): fixed(relax),
        ("ell_gather", "short_merge_kernel"): fixed(g["MERGE_THREADS"]),
        ("ell_push", "push_mark_kernel"): fixed(p["PUSH_THREADS"]),
        ("ell_push", "push_kernel"): fixed(p["PUSH_THREADS"]),
        ("ell_push", "delta_mark_kernel"): fixed(p["PUSH_THREADS"]),
        ("ell_push", "delta_push_kernel"): fixed(p["PUSH_THREADS"]),
        ("ell_push", "settle_mark_kernel"): fixed(p["SETTLE_THREADS"]),
        ("ell_push", "settle_push_kernel"): fixed(p["PUSH_THREADS"]),
        ("ell_push", "settle_tail_kernel"): fixed(p["SETTLE_TAIL_THREADS"]),
        ("ell_push", "delta_settle_mark_kernel"): fixed(p["SETTLE_THREADS"]),
        ("ell_push", "delta_settle_push_kernel"): fixed(p["PUSH_THREADS"]),
        ("frontier_crit", "crit_kernel"): fixed(c["CRIT_THREADS"],
                                                crit_blocks),
        ("frontier_crit", "delta_crit_kernel"): fixed(c["CRIT_THREADS"],
                                                      crit_blocks),
        ("embed_grad", "embed_grad_kernel"): fixed(e["EMBED_THREADS"]),
    }


def audit_resources(resources: dict[str, dict] | None = None,
                    reg: kreg.KernelRegistry | None = None,
                    defines: dict | None = None) -> tuple[list, list]:
    """The resource checks over ``{source: _build.kernel_resources(source)}``
    (default: every source's build record). Returns ``(findings, rows)``,
    a row ``(source, kernel, registers, smem_bytes, spill_stores,
    spill_loads, instances)`` a kernel."""
    from repro_torch.kernels import _build

    if resources is None:
        resources = {nm: _build.kernel_resources(nm) for nm in _build.SOURCES}
    reg = kreg.collect() if reg is None else reg
    shapes = launch_shapes(source_defines() if defines is None else defines)
    claims: dict = {}
    for c in reg.contracts():
        for key in c.kernels:
            claims.setdefault(key, []).append(c)
    findings, rows = [], []
    for src, kernels in sorted(resources.items()):
        for name, res in sorted(kernels.items()):
            def emit(message, _k=f"{src}.cu:{name}", _case="all"):
                findings.append(Finding(_k, _case, "resources", message))

            rows.append((src, name, res["registers"], res["smem_bytes"],
                         res["spill_stores"], res["spill_loads"],
                         len(res["instances"])))
            shape = shapes.get((src, name))
            owners = claims.get((src, name), [])
            if shape is None or not owners:
                emit("a __global__ kernel no contract claims (no launch "
                     "shape or no registered wrapper launches it)")
                continue
            for targs, inst in sorted(res["instances"].items()):
                threads, blocks, dyn = shape(targs)
                regs, tag = inst["registers"], f"<{','.join(map(str, targs))}>"
                allowed = any(name + tag in c.spills_ok for c in owners)
                if threads > kcfg.MAX_THREADS_PER_BLOCK or threads % 32:
                    emit(f"{tag} {threads} threads a block: not whole warps "
                         f"within {kcfg.MAX_THREADS_PER_BLOCK}")
                if regs > kcfg.MAX_REGISTERS_PER_THREAD:
                    emit(f"{tag} {regs} registers a thread > "
                         f"{kcfg.MAX_REGISTERS_PER_THREAD}")
                if regs * threads * blocks > kcfg.REGISTERS_PER_SM:
                    emit(f"{tag} {regs} registers x {threads} threads x "
                         f"{blocks} blocks an SM = {regs * threads * blocks}"
                         f" > {kcfg.REGISTERS_PER_SM}")
                smem = inst["smem_bytes"] + dyn
                if smem > kcfg.MAX_SMEM_PER_BLOCK:
                    emit(f"{tag} {inst['smem_bytes']} static + {dyn} dynamic "
                         f"shared bytes > {kcfg.MAX_SMEM_PER_BLOCK} a block")
                if (inst["spill_stores"] or inst["spill_loads"]) and \
                        not allowed:
                    emit(f"{tag} spills {inst['spill_stores']} bytes stored,"
                         f" {inst['spill_loads']} loaded, and no contract "
                         "gives a reason")
    return findings, rows


def _poison(sizes: list[int], dev, copies: int = 8) -> None:
    """Fill blocks of these byte sizes with :data:`POISON` and free them
    back into the caching allocator, where the next allocations of those
    sizes find them."""
    held = [torch.full(((nbytes + 3) // 4,), POISON, dtype=torch.int32,
                       device=dev)
            for nbytes in sizes for _ in range(copies)]
    torch.cuda.synchronize(dev)
    del held


def _poisoned_cells(outs) -> int:
    n = 0
    for t in outs:
        if t.element_size() == 4 and t.numel():
            n += int((t.contiguous().view(torch.int32) == POISON).sum())
    return n


def audit_coverage(reg: kreg.KernelRegistry | None = None, dev=None,
                   runs: int = RUNS) -> tuple[list, dict]:
    """The coverage check of every case of every contract on the card.
    Returns ``(findings, stats)``: contracts, cases, runs and the output
    cells found still poisoned."""
    reg = kreg.collect() if reg is None else reg
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None \
        else torch.device(dev)
    findings: list[Finding] = []
    stats = {"contracts": 0, "cases": 0, "runs": 0, "poisoned_cells": 0}
    for contract in reg.contracts():
        stats["contracts"] += 1
        for case in contract.make_cases():
            stats["cases"] += 1

            def emit(message, _n=contract.name, _c=case.label):
                findings.append(Finding(_n, _c, "coverage", message))

            args = to_device(case.args, dev)
            kwargs = to_device(case.kwargs, dev)
            want = _outputs(contract.oracle(*args, **kwargs))
            first = None
            for run in range(runs):
                _poison([t.numel() * t.element_size() for t in want], dev)
                try:
                    got = _outputs(contract.wrapper(*args, **kwargs))
                    torch.cuda.synchronize(dev)
                except Exception as e:  # noqa: BLE001 (a finding)
                    emit(f"run {run} raised {e!r}")
                    break
                stats["runs"] += 1
                cells = _poisoned_cells(got)
                stats["poisoned_cells"] += cells
                if cells:
                    emit(f"run {run}: {cells} output cells never written")
                if len(got) != len(want) or not all(
                        same_bits(a, b) for a, b in zip(got, want)):
                    emit(f"run {run}: outputs differ from the twin's bits")
                if first is None:
                    first = got
                elif not all(same_bits(a, b) for a, b in zip(got, first)):
                    emit(f"run {run}: outputs differ from run 0")
    return findings, stats


def audit_card(reg: kreg.KernelRegistry | None = None,
               dev=None) -> tuple[list, list, dict]:
    """Both card checks: builds every source first (which writes the
    ``ptxas`` records). Returns ``(findings, resource rows, coverage
    stats)``. Raises when there is no card: the caller reports the checks
    as not run."""
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the card checks cannot run")
    reg = kreg.collect() if reg is None else reg
    _build.build()
    res_findings, rows = audit_resources(reg=reg)
    cov_findings, stats = audit_coverage(reg, dev)
    return res_findings + cov_findings, rows, stats
