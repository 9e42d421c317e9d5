"""The resumable phased-SSSP stepper (counterpart of
``repro.core.static_engine``).

Stepper API, as in the reference:

  * :func:`init_batch_state` scatters B sources into fresh ``(B, n)`` state
    (``-1`` marks an empty lane: all-+inf distances, no fringe, a fixed
    point that rides along at no phase cost);
  * :func:`step_batch` advances the phase loop by *up to* ``k_phases``
    more trips and returns a new :class:`BatchState` of the same shapes;
  * :func:`reset_lanes` / :func:`reset_lane` re-initialise lanes between
    chunks (a reset lane is bitwise a fresh solve);
  * :func:`harvest` freezes a state into a :class:`BatchedResult`.

``criterion`` is any policy spec: a criterion plan (an oracle plan takes
per-lane ``dist_true`` rows) or ``"delta"``, delta-stepping on the same
stepper with the bucket width ``delta`` as data (``core.policies``).
``telemetry=True`` adds the fringe, relax and settle-attribution rings
that ``repro_torch.obs.telemetry`` decodes.

``targets`` (``init_batch_state``) turns lanes into s->t queries: a target
lane's remaining fringe is demoted the phase its target settles, and the
policy relaxes only from settled vertices nearer than the target's current
distance (``ops._bound_gate``), so only ``dist[lane, target]`` (and every
vertex nearer) is final on that row. A target-free state (``target`` is
None) runs the exact pre-target program.

``run_phased_static`` (B = 1) and ``run_phased_static_batch`` are thin
wrappers over the same stepper.

What differs from the reference, and why:

  * **Counters** are int64 tensors. The reference's two-limb u32/i32
    counters exist only because ``jax_enable_x64`` is off; ``harvest``
    returns the same int64 values.
  * **The trip loop is a replayed chunk of gated phases** where the
    reference runs a ``lax.while_loop`` on the device. Each phase computes
    the reference's loop predicate on the device from the state at its
    entry (some lane live, trips left in the call's ``budget`` and, under
    ``stop_on_lane_finish``, no entry-live lane finished) and gates every
    write on it: a phase under a false predicate is a fixed point, bit for
    bit, ``trips`` included. :data:`PHASES_PER_REPLAY` such phases form a
    chunk over static state buffers, and the host reads one flag a chunk
    (whether the next phase would run) to decide on the next. On the card
    with the kernels the chunk is a CUDA graph, captured once per
    :func:`_chunk_key` after one eager chunk on a side stream and replayed
    from then on; on the CPU, and with ``use_kernels=False``, the same
    chunk function runs eagerly. A failed capture raises. The chunks are
    memoised on the graph (:data:`CHUNKS_PER_GRAPH` of them, the oldest
    freed first), which keeps the views whose addresses a capture baked in;
    the captures of a device share one memory pool, so one call at a time
    may step a device's states. A capture replays the ops-layer functions
    it called: code that swaps one of them frees the chunks of the graphs
    it steps (:func:`forget_chunks`) on each side of the swap.
    A replay makes no Python call, so it adds the launch counts its capture
    recorded to the wrappers' ``launches``; the launches of the phases a
    chunk ran past the loop's end are counted there too, and also apart
    (:func:`chunk_stats`).
  * **A caller's state is never written in place**: a call copies it into
    the chunk's buffers (whose rings the phases write in place) and
    returns clones, so a state handed to :func:`step_batch` stays valid,
    as a JAX array does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import criteria as C
from repro_torch.core import policies as P
from repro_torch.kernels import launch_counters
from repro_torch.kernels.frontier_crit import capture_scratch
from repro_torch.kernels.settle_push import (
    capture_scratch as capture_settle_scratch,
)
from repro_torch.obs.timer import Stopwatch
from repro_torch.core.graph import (
    Graph,
    f32_rows,
    graph_device,
    out_degrees,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
)
from repro_torch.core.delta_stepping import default_delta
from repro_torch.core.phased import PhasedResult
from repro_torch.kernels.ops import _is_sliced

INF = float("inf")

EMPTY_LANE = -1  # sentinel source id: lane holds no query
KEEP_LANE = -2  # sentinel source id for reset_lanes: leave the lane untouched

DEFAULT_CRITERION = "instatic|outstatic"  # the paper's parallel implementation

# Phases of one chunk: one graph replay on the card, one host read of the
# loop flag. Chosen on an H100 (PERF.md: the ms a phase of the replayed
# loop against the device ms of the dead phases past a loop's end).
PHASES_PER_REPLAY = 8
# Chunks (captures on the card) memoised on one graph, the oldest freed
# first: a server steps a few keys at a time, and each chunk holds a copy
# of its state's buffers (the captures share one pool, ``_POOLS``).
CHUNKS_PER_GRAPH = 4


@dataclasses.dataclass(frozen=True)
class BatchState:
    """Resumable state of a batched phase loop (one row per lane)."""

    dist: torch.Tensor  # (B, n) f32 tentative distances
    status: torch.Tensor  # (B, n) int32 (0=U, 1=F, 2=S)
    trips: torch.Tensor  # scalar int32: loop trips since init
    phases: torch.Tensor  # (B,) int32: phases each lane's current query was live
    sum_fringe: torch.Tensor  # (B,) int64: per-lane sum over live phases of |F|
    relax_edges: torch.Tensor  # (B,) int64: per-lane out-edges relaxed
    out_deg: torch.Tensor  # (n,) int32: graph out-degrees (for the counters)
    crit_keys: torch.Tensor | None  # (K, B, n) f32 policy-owned carried
    #   stack (the plan's dynamic keys, ordered like plan.keys), or None
    keys_valid: bool | None  # whether the in-side slots of crit_keys match
    #   status (None: the plan carries none); a host bool, so checking it
    #   costs no device sync
    dist_true: torch.Tensor | None  # (B, n) f32 per-lane true distances,
    #   only on oracle-plan states
    settled_trace: torch.Tensor  # (B, trace_len) int32 ring of per-phase
    #   settle counts: phase p of a lane's query lands in slot p % trace_len
    fringe_trace: torch.Tensor | None  # (B, trace_len) int32 ring of |F| at
    #   phase entry, only with telemetry=True
    relax_trace: torch.Tensor | None  # (B, trace_len) int32 ring of the
    #   out-edges relaxed each phase, only with telemetry=True
    attr_trace: torch.Tensor | None  # (B, trace_len, T) int32 ring of the
    #   policy's attribution slots (``policy.attribution_terms()``), only
    #   with telemetry=True
    delta: torch.Tensor | None  # 0-dim f32 bucket width, only on
    #   delta-stepping states
    target: torch.Tensor | None  # (B,) int32 per-lane s->t target (-1 =
    #   full solve), or None on a state initialised without target lanes
    criterion: str  # canonical policy spec

    @property
    def num_lanes(self) -> int:
        return self.dist.shape[0]

    @property
    def n(self) -> int:
        return self.dist.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dist.device

    @property
    def plan(self) -> C.CritPlan:
        return C.plan_for(self.criterion)


@dataclasses.dataclass(frozen=True)
class BatchedResult:
    """Result of one batched multi-source solve over a shared graph."""

    dist: torch.Tensor  # (B, n) f32 final distances (inf = unreachable)
    status: torch.Tensor  # (B, n) int8 (0=U, 1=F, 2=S)
    phases: torch.Tensor  # (B,) int32: phases each row was live for
    sum_fringe: np.ndarray  # (B,) int64 host: per-row sum over phases of |F|
    relax_edges: np.ndarray  # (B,) int64 host: per-row out-edges relaxed
    total_phases: torch.Tensor  # scalar int32: loop trips since state init
    settled_per_phase: torch.Tensor | None = None  # (B, trace_len) int32
    #   ring, or None when tracing was off (trace_len == 1)
    fringe_per_phase: torch.Tensor | None = None  # (B, trace_len) int32,
    #   only from telemetry states with trace_len > 1
    relax_per_phase: torch.Tensor | None = None  # (B, trace_len) int32,
    #   likewise
    settle_attribution: torch.Tensor | None = None  # (B, trace_len, T)
    #   int32, likewise; T indexes the policy's attribution_terms()
    target: torch.Tensor | None = None  # (B,) int32 per-lane target (-1 =
    #   full solve), only from target-enabled states: on a target lane only
    #   dist[lane, target[lane]] (and nearer vertices) is final


def validate_sources(sources, n: int, lo: int, range_desc: str,
                     expect_lanes: int | None = None) -> np.ndarray:
    """Validate a host-side source vector and return it as int32 numpy.

    Rejects non-integer dtypes, empty or non-1-D shapes, and any id outside
    ``[lo, n)``, in the *original* dtype (casting first would let ids beyond
    int32 wrap into the valid range).
    """
    src_np = np.atleast_1d(np.asarray(sources))
    if expect_lanes is not None and src_np.shape != (expect_lanes,):
        raise ValueError(
            f"sources must have shape ({expect_lanes},); got {src_np.shape}"
        )
    if src_np.ndim != 1 or src_np.size == 0:
        raise ValueError(
            f"sources must be a non-empty (B,) vector; got shape {src_np.shape}"
        )
    if src_np.dtype.kind not in "iu":
        raise ValueError(f"sources must be integer vertex ids; got {src_np.dtype}")
    if int(src_np.min()) < lo or int(src_np.max()) >= n:
        raise ValueError(f"sources must be {range_desc}; got {src_np}")
    return src_np.astype(np.int32)


def _fresh_rows(sources: torch.Tensor, n: int):
    """(B, n) dist/status rows for fresh queries: the single source of truth
    for lane initialisation, shared by init and reset. A source below 0
    gives an empty all-+inf, fringe-free row."""
    b = sources.shape[0]
    dev = sources.device
    rows = torch.arange(b, device=dev)
    valid = sources >= 0
    col = sources.clamp(0, n - 1).long()
    d = torch.full((b, n), INF, dtype=torch.float32, device=dev)
    d[rows, col] = torch.where(valid, 0.0, INF)
    status = torch.zeros((b, n), dtype=torch.int32, device=dev)
    status[rows, col] = valid.to(torch.int32)
    return d, status


def _validate_targets(targets, b: int, n: int) -> np.ndarray | None:
    """(B,) int32 host target vector (or None): each entry a vertex id for
    an s->t lane or -1 for a full solve, through the source gatekeeper."""
    if targets is None:
        return None
    return validate_sources(
        targets, n, EMPTY_LANE, f"in [0, {n}) or -1 for a full-solve lane",
        expect_lanes=b,
    )


def _validate_dist_true(dist_true, policy: P.PhasePolicy, b: int, n: int,
                        dev) -> torch.Tensor | None:
    """(B, n) f32 ``dist_true`` on ``dev`` when the policy reads it, else
    None: a ``dist_true`` given to a plan without the oracle is dropped, as
    the reference drops it."""
    if not policy.needs_oracle:
        return None
    if dist_true is None:
        raise ValueError(
            f"criterion {policy.spec!r} includes 'oracle': per-lane "
            f"dist_true of shape ({b}, {n}) is required"
        )
    dt = f32_rows(dist_true, dev)
    if tuple(dt.shape) != (b, n):
        raise ValueError(
            f"dist_true must have shape ({b}, {n}); got {tuple(dt.shape)}"
        )
    return dt


def _validate_delta(policy: P.PhasePolicy, g: Graph, delta):
    """0-dim f32 bucket width on the graph's device for delta-stepping
    states (default :func:`~repro_torch.core.delta_stepping.default_delta`),
    else None; a criterion policy rejects a delta."""
    if not policy.uses_delta:
        if delta is not None:
            raise ValueError(
                f"criterion {policy.spec!r} does not take a delta bucket "
                f"width; use criterion='delta' for delta-stepping"
            )
        return None
    delta = float(default_delta(g) if delta is None else delta)
    if not (np.isfinite(delta) and delta > 0):
        raise ValueError(
            f"delta must be a positive finite bucket width; got {delta}"
        )
    return torch.tensor(delta, dtype=torch.float32, device=g.device)


def init_batch_state(
    g: Graph,
    sources,
    criterion: str = DEFAULT_CRITERION,
    dist_true=None,
    trace_len: int = 1,
    telemetry: bool = False,
    delta: float | None = None,
    targets=None,
    device=None,
) -> BatchState:
    """Fresh ``(B, n)`` stepper state for B lanes over one shared graph.

    ``sources[i] == -1`` (:data:`EMPTY_LANE`) leaves lane ``i`` empty.
    ``criterion`` is any policy spec (see the module docstring). An oracle
    plan requires per-lane ``dist_true`` rows ``(B, n)``; other plans drop
    them. ``criterion="delta"`` takes the bucket width ``delta`` (default
    ``default_delta(g)``), stored as a 0-dim f32 tensor; other policies
    reject one. ``trace_len`` sizes the per-lane settled-per-phase ring
    (1 = off); ``telemetry=True`` adds the fringe, relax and
    ``(B, trace_len, T)`` attribution rings. ``targets``, a
    ``(B,)`` int vector of target vertices (-1 = full solve), makes the
    state target-capable (see the module docstring). ``device`` (None =
    the CUDA card) must be the graph's device.
    """
    policy = P.policy_for(criterion)
    dev = graph_device(g, device)
    src_np = validate_sources(
        sources, g.n, EMPTY_LANE, f"in [0, {g.n}) or -1 for an empty lane"
    )
    if trace_len < 1:
        raise ValueError(f"trace_len must be >= 1; got {trace_len}")
    b = src_np.shape[0]
    dt = _validate_dist_true(dist_true, policy, b, g.n, dev)
    dl = _validate_delta(policy, g, delta)
    tg = _validate_targets(targets, b, g.n)
    d0, status0 = _fresh_rows(torch.from_numpy(src_np).to(dev), g.n)
    zeros_i32 = torch.zeros((b,), dtype=torch.int32, device=dev)
    zeros_i64 = torch.zeros((b,), dtype=torch.int64, device=dev)

    def ring(*shape):
        return torch.zeros((b, int(trace_len)) + shape, dtype=torch.int32,
                           device=dev)

    n_terms = len(policy.attribution_terms())
    return BatchState(
        dist=d0,
        status=status0,
        trips=torch.zeros((), dtype=torch.int32, device=dev),
        phases=zeros_i32,
        sum_fringe=zeros_i64,
        relax_edges=zeros_i64,
        out_deg=out_degrees(g),
        crit_keys=policy.fresh_keys(b, g.n, dev),
        keys_valid=policy.init_keys_valid(),
        dist_true=dt,
        settled_trace=ring(),
        fringe_trace=ring() if telemetry else None,
        relax_trace=ring() if telemetry else None,
        attr_trace=ring(n_terms) if telemetry else None,
        delta=dl,
        target=None if tg is None else torch.from_numpy(tg).to(dev),
        criterion=policy.spec,
    )


class LoopGate(NamedTuple):
    """The loop predicate's operands of a phase, callable on the phase's
    fringe sizes (the policies' ``go_of``): the budget of trips left, the
    lanes live at the call's entry and ``stop_on_lane_finish``. A policy
    that commits its phase in place (``PhaseOutcome.committed``) reads
    them itself and spends ``budget`` in place."""

    budget: torch.Tensor  # 0-dim int32
    live0: torch.Tensor  # (B,) bool
    stop: bool

    def __call__(self, n_fringe) -> torch.Tensor:
        return _go(n_fringe > 0, self.budget, self.live0, self.stop)


def _go(live, budget, live0, stop_on_lane_finish: bool) -> torch.Tensor:
    """The reference's loop predicate (its ``cond``) as a 0-dim bool on the
    device: some lane live and trips left in the call's ``budget``, and
    under ``stop_on_lane_finish`` every lane live at entry still live
    (lanes never revive)."""
    go = torch.any(live) & (budget > 0)
    if stop_on_lane_finish:
        go = go & torch.all(live == live0)
    return go


def _phase(g: Graph, aux, s: BatchState, policy: P.PhasePolicy,
           use_kernels: bool, budget, live0, stop_on_lane_finish: bool):
    """One trip of the loop, the reference's ``body`` gated on its
    ``cond``: the policy's phase plus the chassis' ring and counter
    writes, gated per lane on ``n_fringe > 0`` and every one on the loop
    predicate, which the policy computes from the fringe sizes its
    reduction found at the phase's entry. On a target lane, the phase its
    target settles demotes the remaining fringe to status 0: the lane is
    then a fixed point, and the phase itself still counts. A policy's
    committed phase (the push plans' pair) did all of that in place on
    ``s``'s buffers and ``budget``. Returns the next state and the budget
    left."""
    out = policy.phase(g, aux, s, use_kernels,
                       LoopGate(budget, live0, stop_on_lane_finish))
    if out.committed:
        return dataclasses.replace(s, crit_keys=out.crit_keys), budget
    rows = torch.arange(s.num_lanes, device=s.device)
    status = out.status
    if s.target is not None:
        tcol = s.target.clamp(0, s.n - 1).long()
        hit = (s.target >= 0) & (status[rows, tcol] == 2)
        status = torch.where(hit[:, None] & (status == 1), 0, status)
    # finished/empty lanes stop counting, and every lane in a dead phase
    lane_on = (out.n_fringe > 0) & out.go
    idx = (s.phases % s.settled_trace.shape[1]).long()

    def write(ring, vals):
        # in place: the rings are the chunk's own buffers (a ring may be as
        # long as the phase cap). Dead lanes must not write: their stuck
        # slot may hold a wrapped entry
        on = lane_on.reshape((-1,) + (1,) * (vals.dim() - 1))
        ring[rows, idx] = torch.where(on, vals, ring[rows, idx])
        return ring

    fringe_trace, relax_trace, attr_trace = (
        s.fringe_trace, s.relax_trace, s.attr_trace)
    if attr_trace is not None:
        fringe_trace = write(fringe_trace, out.n_fringe)
        relax_trace = write(relax_trace, out.relax_inc.to(torch.int32))
        attr_trace = write(attr_trace, out.attr_counts)
    go = out.go.to(torch.int32)
    return BatchState(
        dist=out.dist,
        status=status,
        trips=s.trips + go,
        phases=s.phases + lane_on.to(torch.int32),
        sum_fringe=s.sum_fringe
        + torch.where(lane_on, out.n_fringe, 0).to(torch.int64),
        relax_edges=s.relax_edges + out.relax_inc,
        out_deg=s.out_deg,
        crit_keys=out.crit_keys,
        keys_valid=s.keys_valid,
        dist_true=s.dist_true,
        settled_trace=write(s.settled_trace, out.n_settled),
        fringe_trace=fringe_trace,
        relax_trace=relax_trace,
        attr_trace=attr_trace,
        delta=s.delta,
        target=s.target,
        criterion=s.criterion,
    ), budget - go


# the state fields the phases rewrite, and those they only read
_CARRIED = ("dist", "status", "trips", "phases", "sum_fringe", "relax_edges",
            "crit_keys", "settled_trace", "fringe_trace", "relax_trace",
            "attr_trace")
_READ = ("out_deg", "dist_true", "delta", "target")


@dataclasses.dataclass
class ChunkStats:
    """What the chunk loop did since :func:`reset_chunk_stats`."""

    chunks: int = 0  # chunks run, eager or replayed
    replays: int = 0  # of them, graph replays
    captures: int = 0  # graph captures
    capture_s: float = 0.0  # host seconds of the captures (warm-up apart)
    host_reads: int = 0  # reads of the loop flag: one a chunk
    live_phases: int = 0  # phases run under a true predicate (trips)
    dead_phases: int = 0  # phases a chunk ran past its loop's end
    dead_launches: dict = dataclasses.field(default_factory=dict)  # wrapper
    #   name -> launches of the dead phases (also in the wrappers' counts)


_STATS = ChunkStats()
_CAPTURES = [0]  # graph captures in this process (never reset)
_SIDE_STREAMS: dict = {}  # device index -> the warm-up and capture stream
# device index -> the private memory pool every capture shares: a chunk's
# intermediates die within it (its results land in its own buffers, #2's
# scratch is held), and the replays run one at a time in stream order, so
# the pool holds the largest chunk's intermediates, not their sum. Kept
# beside the graphs captured into it (weakly): PyTorch's allocators free a
# pool once its last graph is gone and refuse its id after that, so a
# capture takes a new pool when none of them lives
_POOLS: dict = {}  # device index -> (pool id, weakref.WeakSet of graphs)
_COUNTERS: dict = {}


def chunk_stats() -> ChunkStats:
    """The chunk loop's counts since the last :func:`reset_chunk_stats`."""
    return _STATS


def reset_chunk_stats():
    """Zero :func:`chunk_stats` (``capture_count`` keeps counting)."""
    global _STATS
    _STATS = ChunkStats()


def capture_count() -> int:
    """Graph captures of the stepper's chunk in this process so far."""
    return _CAPTURES[0]


def _counts() -> dict:
    if not _COUNTERS:
        _COUNTERS.update(launch_counters())
    return {nm: getattr(f, a) for nm, (f, a) in _COUNTERS.items()}


def _chunk_key(policy, s: BatchState, aux, use_kernels: bool,
               stop_on_lane_finish: bool) -> tuple:
    """What a chunk's capture depends on: the operands ``prepare`` hands
    the phase (``policy.chunk_key``: the views by identity, delta's f32
    width by value), the state's shapes and optional fields, the loop
    options and the device."""
    return (
        policy.chunk_key(aux), s.num_lanes, s.n, s.criterion,
        s.target is not None, s.dist_true is not None,
        s.attr_trace is not None, s.settled_trace.shape[1],
        bool(stop_on_lane_finish), str(s.device), bool(use_kernels),
    )


class _Chunk:
    """:data:`PHASES_PER_REPLAY` gated phases over static state buffers:
    eager on the CPU and under ``use_kernels=False``, else one eager run on
    a side stream, then a CUDA graph captured once and replayed."""

    def __init__(self, policy, aux, s: BatchState, use_kernels: bool,
                 stop_on_lane_finish: bool, capture: bool = True):
        self.policy, self.aux = policy, aux  # the aux keeps the views alive
        self.use_kernels = use_kernels
        self.stop = stop_on_lane_finish
        dev = s.device
        self.buf = dataclasses.replace(s, **{
            nm: torch.empty_like(getattr(s, nm)) for nm in _CARRIED + _READ
            if getattr(s, nm) is not None})
        self.budget = torch.zeros((), dtype=torch.int32, device=dev)
        self.live0 = torch.zeros((s.num_lanes,), dtype=torch.bool, device=dev)
        # [the predicate of the next phase, the live phases of the chunk]
        self.info = torch.zeros((2,), dtype=torch.int32, device=dev)
        self.cuda = dev.type == "cuda"
        # the device decides: on the card with the kernels, a graph
        self.capture = capture and self.cuda and use_kernels
        self.info_host = (torch.zeros((2,), dtype=torch.int32,
                                      pin_memory=True) if self.cuda else None)
        self.label = (f"{s.criterion} B={s.num_lanes} n={s.n}"
                      + (" target" if s.target is not None else "")
                      + (" telemetry" if s.attr_trace is not None else ""))
        self.graph = None
        self.scratch = None  # #2's and the pair's scratch the graph baked in
        self.replay_counts: dict = {}  # launches a replay adds

    def load(self, s: BatchState, live0, k: int):
        for nm in _CARRIED + _READ:
            dst = getattr(self.buf, nm)
            if dst is not None:
                dst.copy_(getattr(s, nm))
        self.live0.copy_(live0)
        self.budget.fill_(min(k, 2**31 - 1))

    def body(self, g: Graph):
        """The chunk: its phases, the flag, the buffers written back (a
        committed phase writes them in place: the trips at the chunk's
        entry are kept apart)."""
        s, budget = self.buf, self.budget
        trips0 = self.buf.trips.clone()
        for _ in range(PHASES_PER_REPLAY):
            s, budget = _phase(g, self.aux, s, self.policy, self.use_kernels,
                               budget, self.live0, self.stop)
        go = _go(torch.any(s.status == 1, dim=1), budget, self.live0,
                 self.stop)
        self.info.copy_(torch.stack([go.to(torch.int32), s.trips - trips0]))
        self.budget.copy_(budget)
        for nm in _CARRIED:
            dst, src = getattr(self.buf, nm), getattr(s, nm)
            if dst is not None:
                dst.copy_(src)

    def run(self, g: Graph) -> bool:
        """One chunk; returns whether the loop goes on."""
        if self.graph is not None:
            self.graph.replay()
            for nm, n in self.replay_counts.items():
                f, a = _COUNTERS[nm]
                setattr(f, a, getattr(f, a) + n)
            launched = self.replay_counts
            _STATS.replays += 1
        elif self.capture:
            # the first chunk of a key runs eagerly on a side stream (it
            # also builds and loads the libraries), then the capture
            side = _side_stream(self.buf.dist.device)
            side.wait_stream(torch.cuda.current_stream(side.device))
            with torch.cuda.stream(side):
                launched = self._eager(g)
            torch.cuda.current_stream(side.device).wait_stream(side)
        else:
            launched = self._eager(g)
        go, live = self._read()
        if self.graph is None and self.capture:
            self._capture(g)
        dead = PHASES_PER_REPLAY - live
        _STATS.chunks += 1
        _STATS.live_phases += live
        _STATS.dead_phases += dead
        for nm, n in launched.items():
            _STATS.dead_launches[nm] = (_STATS.dead_launches.get(nm, 0)
                                        + n // PHASES_PER_REPLAY * dead)
        return bool(go)

    def _eager(self, g: Graph) -> dict:
        before = _counts()
        self.body(g)
        return {nm: n - before[nm] for nm, n in _counts().items()
                if n != before[nm]}

    def _read(self) -> tuple[int, int]:
        """The one host read of a chunk: the flag, copied to pinned memory
        behind the chunk and read once the copy is done."""
        _STATS.host_reads += 1
        if self.info_host is None:
            return tuple(self.info.tolist())
        self.info_host.copy_(self.info, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return tuple(self.info_host.tolist())

    def _capture(self, g: Graph):
        dev = self.buf.dist.device
        side = _side_stream(dev)
        before = _counts()
        # a capture cannot free cached blocks to grow its pool: hand them
        # back to the device first
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        index = side.device.index
        pool, live = _POOLS.get(index, (None, ()))
        # a live graph of the pool, held until the capture has begun, keeps
        # the pool's id valid
        anchor = next(iter(live), None)
        if anchor is None:
            pool, live = _POOLS[index] = (torch.cuda.graph_pool_handle(),
                                          weakref.WeakSet())
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with Stopwatch() as sw, torch.cuda.stream(side), \
                    capture_scratch() as scratch, \
                    capture_settle_scratch() as settle_scratch:
                began = False
                try:
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    began = True
                    del anchor
                    self.body(g)
                    began = False
                    graph.capture_end()
                except Exception as exc:
                    if began:
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                    # the allocators may still route the stream to the
                    # failed capture's pool: later chunks take new ones
                    _SIDE_STREAMS.pop(index, None)
                    _POOLS.pop(index, None)
                    raise RuntimeError(
                        f"capturing the stepper's chunk ({self.label}) "
                        f"failed: {exc}") from exc
            after = _counts()
        finally:
            # the capture launched nothing: its calls' counts come back
            # with each replay
            for nm, (f, a) in _COUNTERS.items():
                setattr(f, a, before[nm])
        torch.cuda.current_stream(dev).wait_stream(side)
        live.add(graph)
        self.graph, self.scratch = graph, (scratch, settle_scratch)
        self.replay_counts = {nm: n - before[nm] for nm, n in after.items()
                              if n != before[nm]}
        _CAPTURES[0] += 1
        _STATS.captures += 1
        _STATS.capture_s += sw.elapsed

    def result(self, s: BatchState) -> BatchState:
        """A fresh state: clones of the buffers, the caller's read-only
        fields."""
        return dataclasses.replace(s, **{
            nm: getattr(self.buf, nm).clone() for nm in _CARRIED
            if getattr(self.buf, nm) is not None})


def _side_stream(dev):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        stream = _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def _chunk_for(g: Graph, policy, aux, s: BatchState, use_kernels: bool,
               stop_on_lane_finish: bool) -> _Chunk:
    """The memoised chunk of this key on ``g`` (made on a miss, the oldest
    of more than :data:`CHUNKS_PER_GRAPH` freed)."""
    key = _chunk_key(policy, s, aux, use_kernels, stop_on_lane_finish)
    memo = g.__dict__.setdefault("_chunk_memo", collections.OrderedDict())
    chunk = memo.get(key)
    if chunk is None:
        chunk = memo[key] = _Chunk(policy, aux, s, use_kernels,
                                   stop_on_lane_finish)
        while len(memo) > CHUNKS_PER_GRAPH:
            memo.popitem(last=False)
    else:
        memo.move_to_end(key)
    return chunk


def step_batch(
    g: Graph,
    state: BatchState,
    k_phases: int,
    ell=None,
    use_kernels: bool = True,
    stop_on_lane_finish: bool = False,
    ell_out=None,
) -> BatchState:
    """Advance the phase loop by up to ``k_phases`` more trips.

    Returns after ``k_phases`` trips, or earlier when every lane's fringe is
    empty (possibly at once), or, with ``stop_on_lane_finish``, as soon as
    a lane that was live on entry terminates. ``ell`` is the incoming view
    (default the policy's padded ``in_view``: ``to_ell_in(g)``, None for
    delta, which reads none); ``ell_out`` the outgoing one, read by the
    plans whose phase reads it (``needs_out_adjacency``: out-side dynamic
    keys, or the push relax of every plan without in-side keys, the default
    and delta among them; default the policy's memoised ``out_view``:
    ``to_ell_out(g)``, or ``to_ell_out_sliced(g)`` when ``ell`` is sliced,
    its buckets alone for delta). Either may be the padded ``(cols, ws)``
    pair or a degree-sliced ``SlicedEll``: results
    are bit-identical between layouts. Before the loop, even one that runs
    no trip, the policy re-primes carried keys that admission made stale.
    ``use_kernels=False`` runs the plain twins: bit-identical results.
    The loop runs in chunks of :data:`PHASES_PER_REPLAY` gated phases, a
    replayed CUDA graph on the card (see the module docstring), with one
    host read a chunk.
    """
    return _step(g, state, k_phases, ell, use_kernels, stop_on_lane_finish,
                 ell_out, capture=True)


def _step(g: Graph, state: BatchState, k_phases: int, ell, use_kernels: bool,
          stop_on_lane_finish: bool, ell_out, capture: bool) -> BatchState:
    """:func:`step_batch`'s body. ``capture=False`` runs every chunk
    eagerly in a chunk of its own, never memoised or captured: the card's
    checks hold the replayed graph against it."""
    if state.device != g.device:
        raise ValueError(
            f"state lives on {state.device}, the graph on {g.device}"
        )
    policy = P.policy_for(state.criterion)
    if ell is None:
        ell = policy.in_view(g, False)
    if not policy.needs_out_adjacency:
        ell_out = None
    elif ell_out is None:
        ell_out = policy.out_view(g, ell is not None and _is_sliced(ell))
    live0 = torch.any(state.status == 1, dim=1)  # (B,) lanes live at entry
    s = policy.prime(g, ell, state, use_kernels)
    # loop-invariant operands, once a call (delta's degree counts)
    aux = policy.prepare(g, ell, ell_out, s, use_kernels)
    k = max(int(k_phases), 0)
    if k == 0:
        return s
    chunk = (_chunk_for(g, policy, aux, s, use_kernels, stop_on_lane_finish)
             if capture else _Chunk(policy, aux, s, use_kernels,
                                    stop_on_lane_finish, capture=False))
    chunk.load(s, live0, k)
    for _ in range(-(-k // PHASES_PER_REPLAY)):
        if not chunk.run(g):
            break
    return chunk.result(s)


def forget_chunks(g: Graph):
    """Free the chunks memoised on ``g`` and their captures. Call it
    before and after swapping a function of ``kernels.ops`` that ``g``'s
    steps reach: a memoised capture replays the functions it was captured
    with."""
    g.__dict__.pop("_chunk_memo", None)


def reset_lanes(state: BatchState, sources, dist_true=None,
                targets=None) -> BatchState:
    """Re-initialise several lanes in one call.

    ``sources`` is a ``(B,)`` int vector aligned with the lanes: ``-2``
    (:data:`KEEP_LANE`) leaves that lane's bits untouched, ``-1``
    (:data:`EMPTY_LANE`) parks it empty, and a vertex id starts a fresh
    query there, bitwise the same as a fresh :func:`init_batch_state` row.
    On an oracle-plan state, refilling a lane with a real source requires
    fresh per-lane ``dist_true`` rows ``(B, n)`` (touched rows replace the
    stored ones); parking or keeping lanes does not. On a target-enabled
    state, ``targets`` gives each touched lane its new
    target (-1 = full solve, the default when omitted); KEEP_LANE rows keep
    theirs. A target-free state rejects ``targets``. Validation and
    messages are the reference's.
    """
    src_np = validate_sources(
        sources, state.n, KEEP_LANE,
        f"in [0, {state.n}), -1 (park) or -2 (keep)",
        expect_lanes=state.num_lanes,
    )
    if targets is not None and state.target is None:
        raise ValueError(
            "state was initialised without target lanes; pass "
            "init_batch_state(..., targets=...) to enable s->t queries "
            "(the target field is pytree-structural)"
        )
    tg = _validate_targets(targets, state.num_lanes, state.n)
    dt = None
    if state.dist_true is not None:
        if dist_true is None and (src_np >= 0).any():
            raise ValueError(
                "criterion includes 'oracle': refilling lanes requires "
                "dist_true rows (B, n)"
            )
        if dist_true is not None:
            dt = f32_rows(dist_true, state.device)
            if dt.shape != state.dist.shape:
                raise ValueError(
                    f"dist_true must have shape {tuple(state.dist.shape)}; "
                    f"got {tuple(dt.shape)}"
                )
    elif dist_true is not None:
        raise ValueError(
            f"criterion {state.criterion!r} does not read dist_true"
        )
    return _reset_lanes(
        state, torch.from_numpy(src_np).to(state.device),
        bool((src_np >= EMPTY_LANE).any()),
        None if tg is None else torch.from_numpy(tg).to(state.device), dt)


def _reset_lanes(state: BatchState, sources: torch.Tensor, any_touched: bool,
                 targets: torch.Tensor | None = None,
                 dist_true: torch.Tensor | None = None) -> BatchState:
    touch = sources >= EMPTY_LANE  # KEEP_LANE rows pass through unchanged
    fresh_d, fresh_s = _fresh_rows(sources, state.n)
    crit_keys = state.crit_keys
    if crit_keys is not None:
        fresh_k = P.policy_for(state.criterion).fresh_keys(
            state.num_lanes, state.n, state.device)
        crit_keys = torch.where(touch[None, :, None], fresh_k, crit_keys)

    def ctr(old):
        return torch.where(touch, 0, old)

    def ring(old):
        if old is None:
            return None
        return torch.where(touch.reshape((-1,) + (1,) * (old.dim() - 1)),
                           0, old)

    state_dt = state.dist_true
    if state_dt is not None and dist_true is not None:
        state_dt = torch.where(touch[:, None], dist_true, state_dt)

    target = state.target
    if target is not None:
        # touched lanes take their new target (default -1 = full solve)
        if targets is None:
            targets = torch.full_like(target, EMPTY_LANE)
        target = torch.where(touch, targets, target)
    return BatchState(
        dist=torch.where(touch[:, None], fresh_d, state.dist),
        status=torch.where(touch[:, None], fresh_s, state.status),
        trips=state.trips,
        phases=ctr(state.phases),
        sum_fringe=ctr(state.sum_fringe),
        relax_edges=ctr(state.relax_edges),
        out_deg=state.out_deg,
        crit_keys=crit_keys,
        # a touched lane's in-side key slots no longer match its status;
        # the next step_batch re-primes them before its loop
        keys_valid=(None if state.keys_valid is None
                    else state.keys_valid and not any_touched),
        dist_true=state_dt,
        settled_trace=ring(state.settled_trace),
        fringe_trace=ring(state.fringe_trace),
        relax_trace=ring(state.relax_trace),
        attr_trace=ring(state.attr_trace),
        delta=state.delta,
        target=target,
        criterion=state.criterion,
    )


def reset_lane(state: BatchState, lane: int, source: int = EMPTY_LANE,
               target: int = EMPTY_LANE) -> BatchState:
    """Re-initialise one lane's ``(n,)`` slice for a new query (or park
    it), with ``target`` as its s->t target on a target-enabled state; the
    other lanes' bits are untouched."""
    if not 0 <= lane < state.num_lanes:
        raise ValueError(f"lane must be in [0, {state.num_lanes}); got {lane}")
    if not EMPTY_LANE <= source < state.n:
        raise ValueError(f"source must be in [0, {state.n}) or -1; got {source}")
    if state.dist_true is not None and source >= 0:
        raise ValueError(
            "criterion includes 'oracle': use reset_lanes(..., dist_true=...) "
            "to refill a lane with its true-distance row"
        )
    if target != EMPTY_LANE:
        if state.target is None:
            raise ValueError(
                "state was initialised without target lanes; pass "
                "init_batch_state(..., targets=...) to enable s->t queries"
            )
        if not EMPTY_LANE <= target < state.n:
            raise ValueError(
                f"target must be in [0, {state.n}) or -1; got {target}"
            )
    vec = torch.full((state.num_lanes,), KEEP_LANE, dtype=torch.int32,
                     device=state.device)
    vec[lane] = source
    tvec = None
    if state.target is not None:
        tvec = torch.full_like(vec, EMPTY_LANE)
        tvec[lane] = target
    return _reset_lanes(state, vec, True, tvec)


def lanes_active(state: BatchState) -> np.ndarray:
    """(B,) bool host array: which lanes still have a non-empty fringe."""
    return torch.any(state.status == 1, dim=1).cpu().numpy()


def harvest(state: BatchState) -> BatchedResult:
    """Freeze a stepper state into a :class:`BatchedResult`.

    ``settled_per_phase`` is the ring only when tracing was on
    (``trace_len > 1``): a length-1 ring holds just the last phase, which
    must never read as a profile. The telemetry rings follow the same rule.
    """
    traced = state.settled_trace.shape[1] > 1

    def ring(x):
        return x if traced else None

    return BatchedResult(
        dist=state.dist,
        status=state.status.to(torch.int8),
        phases=state.phases,
        sum_fringe=state.sum_fringe.cpu().numpy(),
        relax_edges=state.relax_edges.cpu().numpy(),
        total_phases=state.trips,
        settled_per_phase=ring(state.settled_trace),
        fringe_per_phase=ring(state.fringe_trace),
        relax_per_phase=ring(state.relax_trace),
        settle_attribution=ring(state.attr_trace),
        target=state.target,
    )


def _resolve_views(g: Graph, criterion: str, ell, ell_out, layout: str):
    """The incoming and outgoing views of a solve: each as passed, else the
    one ``layout`` names where the policy reads it (None where it reads
    none; a passed in-view's layout decides the out-view's)."""
    if layout not in ("padded", "sliced"):
        raise ValueError(f"layout must be 'padded' or 'sliced'; got {layout!r}")
    policy = P.policy_for(criterion)
    sliced = layout == "sliced" if ell is None else _is_sliced(ell)
    if ell is None:
        ell = policy.in_view(g, sliced)
    if ell_out is None:
        ell_out = policy.out_view(g, sliced)
    return ell, ell_out


def run_phased_static(
    g: Graph,
    source: int = 0,
    ell=None,
    use_kernels: bool = True,
    max_phases: int | None = None,
    criterion: str = DEFAULT_CRITERION,
    dist_true=None,
    trace_len: int | None = None,
    layout: str = "padded",
    delta: float | None = None,
    target: int | None = None,
    device=None,
    ell_out=None,
) -> PhasedResult:
    """Phased SSSP from one source on the B = 1 stepper.

    ``trace_len`` sizes the settled-per-phase ring; the default (None)
    covers the phase cap, so the result carries the full per-phase
    profile. ``dist_true`` is the (n,) true-distance row an oracle plan
    requires; ``delta`` the bucket width of ``criterion="delta"``.
    ``device`` (None = the CUDA card) must be the graph's device.
    ``layout``, ``ell`` and ``ell_out`` are as in
    :func:`run_phased_static_batch`. ``target`` makes it an s->t query:
    only ``dist[target]`` (bit-exact against the full solve) and the
    vertices nearer than it are final on the returned row.
    """
    ell, ell_out = _resolve_views(g, criterion, ell, ell_out, layout)
    policy = P.policy_for(criterion)
    cap = int(max_phases) if max_phases is not None else policy.phase_cap(g.n)
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source must be in [0, {g.n}); got {source}")
    if trace_len is None:
        trace_len = cap
    if dist_true is not None:
        dist_true = f32_rows(dist_true, g.device).reshape(1, g.n)
    state = init_batch_state(
        g, [int(source)], criterion=criterion, dist_true=dist_true,
        trace_len=trace_len, delta=delta,
        targets=None if target is None else [int(target)], device=device,
    )
    state = step_batch(g, state, cap, ell=ell, use_kernels=use_kernels,
                       ell_out=ell_out)
    return PhasedResult(
        dist=state.dist[0],
        status=state.status[0].to(torch.int8),
        phases=state.phases[0],
        sum_fringe=state.sum_fringe.cpu().numpy()[0],
        settled_per_phase=state.settled_trace[0] if trace_len > 1 else None,
        relax_edges=state.relax_edges.cpu().numpy()[0],
    )


def run_phased_static_batch(
    g: Graph,
    sources,
    ell=None,
    use_kernels: bool = True,
    max_phases: int | None = None,
    criterion: str = DEFAULT_CRITERION,
    dist_true=None,
    trace_len: int = 1,
    layout: str = "padded",
    telemetry: bool = False,
    delta: float | None = None,
    targets=None,
    device=None,
    ell_out=None,
) -> BatchedResult:
    """Batched phased SSSP: B sources, one graph, one phase loop.

    Row ``i`` of the result equals ``run_phased_static(g, sources[i])``
    exactly. ``use_kernels=False`` runs the plain twins (bit-identical);
    ``max_phases`` caps the trips (default the policy's cap: n + 1 for
    criterion plans, 4n + 16 for delta-stepping); ``criterion``,
    ``dist_true`` (B, n), ``delta`` and ``telemetry`` are as in
    :func:`init_batch_state`; ``device`` (None = the
    CUDA card) must be the graph's device; ``layout`` ("padded" or
    "sliced") names the views built when ``ell`` is None, each only where
    the policy reads it; ``ell_out`` is the outgoing view (default: one in
    ``ell``'s layout, for the plans that read it, see :func:`step_batch`,
    and delta's ``out_view``); ``targets`` (B,) gives
    per-lane s->t targets (-1 = full solve), as in :func:`init_batch_state`.
    """
    ell, ell_out = _resolve_views(g, criterion, ell, ell_out, layout)
    src_np = validate_sources(sources, g.n, 0, f"in [0, {g.n})")
    policy = P.policy_for(criterion)
    cap = int(max_phases) if max_phases is not None else policy.phase_cap(g.n)
    state = init_batch_state(
        g, src_np, criterion=criterion, dist_true=dist_true,
        trace_len=trace_len, telemetry=telemetry, delta=delta,
        targets=targets, device=device,
    )
    state = step_batch(g, state, cap, ell=ell, use_kernels=use_kernels,
                       ell_out=ell_out)
    return harvest(state)
