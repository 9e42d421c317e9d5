"""Build sentinel: count the port's kernel compiles and the stepper's
graph captures, pin steady state to zero (counterpart of
``repro.analysis.trace_guard``, which counts XLA compilations).

The port compiles at two points, both counted by ``kernels/_build.py``:
an ``nvcc`` build of a source and the first load of its library in the
process. It captures at one: the first chunk of a stepper key on the card
(``core/static_engine.py``), where JAX would trace. A warmed serving loop
or stepper chunk must do none of these: a build in the steady state means
a wrapper reached a source (or a flag set) that warm-up never built, and a
capture a key that warm-up never stepped (or one the memo freed); each
costs a request its time. Usage::

    warm_up()                      # the one-time builds, loads, captures
    with TraceGuard() as tg:       # the steady state begins here
        for _ in range(trips):
            state = backend.step(state, k)
    # raises RetraceError on exit if anything compiled or was captured
    # inside the block
"""
from __future__ import annotations

from repro_torch.core.static_engine import capture_count
from repro_torch.kernels import _build
from repro_torch.obs.registry import default_registry


def compile_count() -> int:
    """Builds plus first library loads in this process so far."""
    return _build.compile_count()


class RetraceError(AssertionError):
    """Raised when a guarded block compiled more than its budget allows."""


class TraceGuard:
    """Context manager asserting at most ``max_compiles`` compiles (builds
    and first loads) and at most as many graph captures inside the block;
    the default budget of zero is the steady-state contract."""

    def __init__(self, max_compiles: int = 0, label: str = ""):
        self.max_compiles = int(max_compiles)
        self.label = label
        self._start: tuple[int, int] | None = None

    @property
    def compiles(self) -> int:
        """Compiles observed since entering the guard."""
        if self._start is None:
            return 0
        return compile_count() - self._start[0]

    @property
    def captures(self) -> int:
        """Graph captures observed since entering the guard."""
        if self._start is None:
            return 0
        return capture_count() - self._start[1]

    def __enter__(self) -> "TraceGuard":
        self._start = (compile_count(), capture_count())
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        seen, caught = self.compiles, self.captures
        if seen > self.max_compiles or caught > self.max_compiles:
            where = f" in {self.label!r}" if self.label else ""
            default_registry().counter(
                "trace_guard.retrace_errors",
                "TraceGuard budget violations raised").inc()
            raise RetraceError(
                f"{seen} kernel compile(s) and {caught} graph capture(s)"
                f"{where} where at most {self.max_compiles} of each allowed: "
                "a wrapper reached a source or library that warm-up never "
                "built or loaded, or the stepper a key it never captured")
