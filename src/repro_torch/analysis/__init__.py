"""The port's analysis gate: kernel audit, build sentinel, lint
(counterpart of ``repro.analysis``), with one front end,
``python -m repro_torch.analysis``.

  * :mod:`repro_torch.analysis.kernel_audit` — every registered kernel
    contract (``repro_torch.kernels.registry``): the dtype, oracle,
    engine-counter and geometry-mirror checks on the CPU, and on the card
    each kernel's ``ptxas`` resources against the H100's limits and the
    write coverage of every case on a poisoned caching allocator.
  * :mod:`repro_torch.analysis.trace_guard` — a build sentinel: a context
    manager that holds the steady state of a serving loop or stepper to
    zero kernel builds, first loads and graph captures.
  * :mod:`repro_torch.analysis.lint` — the port's AST rules: its layering,
    the one config module, and no import of JAX or of the reference.
"""
from repro_torch.analysis.kernel_audit import (
    AuditReport,
    Finding,
    audit_card,
    audit_contract,
    audit_engine_counters,
    audit_geometry_mirrors,
    audit_registry,
    audit_resources,
)
from repro_torch.analysis.lint import LintFinding, lint_paths, lint_source
from repro_torch.analysis.trace_guard import (
    RetraceError,
    TraceGuard,
    capture_count,
    compile_count,
)

__all__ = [
    "AuditReport",
    "Finding",
    "audit_card",
    "audit_contract",
    "audit_engine_counters",
    "audit_geometry_mirrors",
    "audit_registry",
    "audit_resources",
    "LintFinding",
    "lint_paths",
    "lint_source",
    "RetraceError",
    "TraceGuard",
    "capture_count",
    "compile_count",
]
