"""Build sentinel: count the port's kernel compiles, pin steady state to
zero (counterpart of ``repro.analysis.trace_guard``, which counts XLA
compilations).

The port compiles at two points, both counted by ``kernels/_build.py``:
an ``nvcc`` build of a source and the first load of its library in the
process. A warmed serving loop or stepper chunk must do neither: a build
in the steady state means a wrapper reached a source (or a flag set) that
warm-up never built, and costs seconds a request. Usage::

    warm_up()                      # the one-time builds and loads
    with TraceGuard() as tg:       # the steady state begins here
        for _ in range(trips):
            state = backend.step(state, k)
    # raises RetraceError on exit if anything compiled inside the block
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.obs.registry import default_registry


def compile_count() -> int:
    """Builds plus first library loads in this process so far."""
    return _build.compile_count()


class RetraceError(AssertionError):
    """Raised when a guarded block compiled more than its budget allows."""


class TraceGuard:
    """Context manager asserting at most ``max_compiles`` compiles (builds
    and first loads) inside the block; the default budget of zero is the
    steady-state contract."""

    def __init__(self, max_compiles: int = 0, label: str = ""):
        self.max_compiles = int(max_compiles)
        self.label = label
        self._start: int | None = None

    @property
    def compiles(self) -> int:
        """Compiles observed since entering the guard."""
        if self._start is None:
            return 0
        return compile_count() - self._start

    def __enter__(self) -> "TraceGuard":
        self._start = compile_count()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        seen = self.compiles
        if seen > self.max_compiles:
            where = f" in {self.label!r}" if self.label else ""
            default_registry().counter(
                "trace_guard.retrace_errors",
                "TraceGuard budget violations raised").inc()
            raise RetraceError(
                f"{seen} kernel compile(s){where} where at most "
                f"{self.max_compiles} allowed: a wrapper reached a source or "
                "library that warm-up never built or loaded")
