"""Deterministic fault injection for the serving runtime (counterpart of
``repro.serving.faults``; the numpy generators are the reference's, so a
plan of one seed is one schedule in both packages).

Chaos testing only works when the chaos replays: a :class:`FaultPlan` is a
seeded, fully explicit schedule of faults, and the injection shims —
:class:`FaultyBackend` around any :class:`~repro_torch.serving.backends
.EngineBackend`, :class:`FaultyDistCache` around the result cache — fire
each fault exactly once at its scheduled ordinal, so a failing chaos run
reproduces from its seed alone. Every fault is a host-side manufactured
event: the engine and its kernels run unchanged underneath.

Fault kinds and where they bite:

  * ``row_nan`` / ``row_neg`` / ``row_perturb`` — corrupt one entry of a
    harvested distance row (NaN, negative, or a positive bump on a finite
    entry). Injected on the *copy* ``take_row`` hands to the scheduler, so
    the live engine state stays valid — this models read-out/transfer
    corruption, and keeps the retry semantics clean: a re-solve of the
    same lane is bitwise a fresh solve.
  * ``step_error`` — an engine ``step`` call raises
    :class:`InjectedFault` *before* the inner backend runs (the state the
    scheduler holds remains usable, mirroring a failed dispatch).
  * ``stall`` — a ``step`` call consumes ``magnitude`` units of virtual
    time on the shared :class:`VirtualClock` (a slow device / preempted
    host), inflating latencies and expiring deadlines without sleeping.
  * ``cache_poison`` — a stored cache row is bit-flipped *after* its
    checksum was recorded (in-memory rot): the next lookup must detect the
    mismatch and drop the entry instead of serving it.

Nothing here changes scheduling when no plan matches: a
:class:`FaultyBackend` with an empty plan is a transparent proxy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("row_nan", "row_neg", "row_perturb", "step_error", "stall",
               "cache_poison")
_ROW_KINDS = ("row_nan", "row_neg", "row_perturb")


class InjectedFault(RuntimeError):
    """An engine failure manufactured by a :class:`FaultPlan`."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``at`` is the ordinal of the event stream the fault rides on — engine
    ``step`` calls for ``step_error``/``stall``/row faults, cache ``put``
    calls for ``cache_poison`` — and the fault fires at the first
    opportunity at or after it (a plan survives a run that takes fewer
    steps than expected; unfired faults are simply reported as such).
    ``lane`` narrows row faults to one lane (None = first lane harvested).
    """

    kind: str
    at: int
    lane: int | None = None
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.at < 0:
            raise ValueError(f"fault ordinal must be >= 0; got {self.at}")


class FaultPlan:
    """An ordered, seeded schedule of :class:`Fault`\\ s."""

    def __init__(self, faults=(), seed: int = 0):
        self.faults: tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed)

    @classmethod
    def random(cls, seed: int, n_faults: int = 4, horizon: int = 24,
               lanes: int = 4, kinds=FAULT_KINDS) -> "FaultPlan":
        """A reproducible plan: same arguments, same schedule, always."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(int(n_faults)):
            kind = str(kinds[int(rng.integers(len(kinds)))])
            lane = (int(rng.integers(max(1, lanes)))
                    if kind in _ROW_KINDS else None)
            faults.append(Fault(
                kind=kind, at=int(rng.integers(max(1, horizon))), lane=lane,
                magnitude=float(rng.uniform(0.5, 4.0)),
            ))
        return cls(faults, seed=seed)

    def indexed(self, kinds) -> list[tuple[int, Fault]]:
        """(plan index, fault) pairs for the given kinds, schedule order."""
        return [(i, f) for i, f in enumerate(self.faults) if f.kind in kinds]

    def rng_for(self, index: int) -> np.random.Generator:
        """The corruption RNG of one fault: derived from (plan seed, fault
        index) so every fault's randomness is independent and replayable."""
        return np.random.default_rng([self.seed, int(index)])

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, faults={list(self.faults)!r})"


class VirtualClock:
    """A clock that moves only when told to — stalls cost virtual time,
    tests and benches replay identically on any machine."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"time only moves forward; got dt={dt}")
        self._t += float(dt)
        return self._t


def _corrupt_row(row: np.ndarray, fault: Fault,
                 rng: np.random.Generator) -> np.ndarray:
    """A corrupted copy of ``row`` per the fault kind (always a real change
    the harvest verifier is expected to catch)."""
    out = np.array(row)  # writable copy; never mutate the engine's buffer
    n = out.shape[-1]
    if fault.kind == "row_perturb":
        # bump a finite entry: +mag on a settled distance breaks the
        # relax-fixed-point achievement equality (an inf entry would absorb
        # the bump and turn the fault into a no-op)
        finite = np.flatnonzero(np.isfinite(out))
        i = int(finite[int(rng.integers(len(finite)))])
        out[..., i] = np.float32(out[..., i]) + np.float32(abs(fault.magnitude))
    elif fault.kind == "row_nan":
        out[..., int(rng.integers(n))] = np.nan
    else:  # row_neg
        out[..., int(rng.integers(n))] = -abs(np.float32(fault.magnitude))
    return out


class FaultyBackend:
    """An :class:`EngineBackend` proxy that executes a :class:`FaultPlan`.

    Scheduling-transparent: ``init``/``reset_lanes``/``peek`` pass through
    untouched, ``step`` counts call ordinals and fires ``step_error`` /
    ``stall`` faults, ``take_row`` applies any armed row fault for that
    lane to the harvested copy. ``fired`` records each fault as it lands
    (chaos assertions bound retry amplification against it).
    """

    def __init__(self, inner, plan: FaultPlan,
                 clock: VirtualClock | None = None):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.steps_taken = 0
        self.fired: list[Fault] = []
        self._unfired = {i for i, _ in plan.indexed(
            ("step_error", "stall") + _ROW_KINDS)}

    # -- protocol surface (delegated) ---------------------------------------

    @property
    def g(self):
        return self.inner.g

    @property
    def criterion(self):
        return self.inner.criterion

    @property
    def n(self):
        return self.inner.n

    @property
    def point_queries(self):
        return getattr(self.inner, "point_queries", False)

    def init(self, lanes: int):
        return self.inner.init(lanes)

    def reset_lanes(self, state, sources, donate: bool = False, **kw):
        return self.inner.reset_lanes(state, sources, donate=donate, **kw)

    def peek(self, state):
        return self.inner.peek(state)

    # -- injection points ---------------------------------------------------

    def _take(self, kinds, lane: int | None = None) -> tuple[int, Fault] | None:
        """Claim the next unfired fault of ``kinds`` due at/after now."""
        for i, f in self.plan.indexed(kinds):
            if i not in self._unfired or f.at > self.steps_taken:
                continue
            if lane is not None and f.lane is not None and f.lane != lane:
                continue
            self._unfired.discard(i)
            self.fired.append(f)
            return i, f
        return None

    def step(self, state, k: int, stop_on_lane_finish: bool = False,
             donate: bool = False):
        ordinal = self.steps_taken
        self.steps_taken = ordinal + 1
        stall = self._take(("stall",))
        if stall is not None:
            if self.clock is not None:
                self.clock.advance(abs(stall[1].magnitude))
        err = self._take(("step_error",))
        if err is not None:
            raise InjectedFault(
                f"injected engine failure (fault #{err[0]} of plan seed "
                f"{self.plan.seed}, step ordinal {ordinal})"
            )
        return self.inner.step(state, k, stop_on_lane_finish=stop_on_lane_finish,
                               donate=donate)

    def take_row(self, state, lane: int) -> np.ndarray:
        row = self.inner.take_row(state, lane)
        hit = self._take(_ROW_KINDS, lane=lane)
        if hit is None:
            return row
        idx, fault = hit
        return _corrupt_row(row, fault, self.plan.rng_for(idx))


class FaultyDistCache:
    """A :class:`DistCache` wrapper firing ``cache_poison`` faults.

    Poisoning flips bytes of a stored row *after* its CRC was recorded —
    exactly the in-memory-rot case the checksummed ``get`` path exists to
    catch. Implemented by containment (not subclassing) so the poisoned
    state lives outside the cache's own invariants; everything else
    delegates.
    """

    def __init__(self, cache, plan: FaultPlan):
        self.cache = cache
        self.plan = plan
        self.puts = 0
        self.poisoned: list[tuple[str, str, int]] = []
        self._unfired = {i for i, _ in plan.indexed(("cache_poison",))}

    def __getattr__(self, name):
        return getattr(self.cache, name)

    def __len__(self):
        return len(self.cache)

    def __contains__(self, key):
        return key in self.cache

    def get(self, *a, **kw):
        return self.cache.get(*a, **kw)

    def put(self, gkey: str, criterion: str, source: int, dist,
            now: float = 0.0) -> None:
        ordinal = self.puts
        self.puts = ordinal + 1
        self.cache.put(gkey, criterion, source, dist, now=now)
        for i, f in self.plan.indexed(("cache_poison",)):
            if i not in self._unfired or f.at > ordinal:
                continue
            key = (gkey, criterion, int(source))
            entry = self.cache._d.get(key)
            if entry is None:  # evicted on insert: nothing to poison
                continue
            rng = self.plan.rng_for(i)
            rotten = np.array(entry.row)
            rotten[int(rng.integers(rotten.shape[-1]))] = np.float32(
                -abs(f.magnitude)) if rng.integers(2) else np.nan
            rotten.flags.writeable = False
            entry.row = rotten  # crc still describes the clean bytes
            self._unfired.discard(i)
            self.poisoned.append(key)
