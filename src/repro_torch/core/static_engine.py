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
  * **The trip loop runs on the host**, one device sync per trip (the
    reference runs a ``lax.while_loop`` on the device). It reproduces the
    reference's loop condition exactly: ``trips`` advances only while some
    lane is live, ``stop_on_lane_finish`` ends the chunk on the trip an
    entry-live lane dies, and ``phases``, the counters and the ring slot
    advance only for lanes with a non-empty fringe.
  * **State is never written in place**: every phase makes new tensors, so
    a state handed to :func:`step_batch` stays valid, as a JAX array does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import criteria as C
from repro_torch.core import policies as P
from repro_torch.core.graph import (
    Graph,
    out_degrees,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
)
from repro_torch.core.phased import PhasedResult
from repro_torch.kernels.config import resolve_device
from repro_torch.kernels.ops import _is_sliced

INF = float("inf")

EMPTY_LANE = -1  # sentinel source id: lane holds no query
KEEP_LANE = -2  # sentinel source id for reset_lanes: leave the lane untouched

DEFAULT_CRITERION = "instatic|outstatic"  # the paper's parallel implementation


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
    settled_trace: torch.Tensor  # (B, trace_len) int32 ring of per-phase
    #   settle counts: phase p of a lane's query lands in slot p % trace_len
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
    target: torch.Tensor | None = None  # (B,) int32 per-lane target (-1 =
    #   full solve), only from target-enabled states: on a target lane only
    #   dist[lane, target[lane]] (and nearer vertices) is final


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a mode of the reference that is not ported yet raises."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})"
    )


def graph_device(g: Graph, device) -> torch.device:
    """Resolve ``device`` (None = the CUDA card) and check the graph is on it."""
    dev = resolve_device(device)
    if g.device != dev:
        raise ValueError(f"the graph lives on {g.device}, not on {dev}")
    return dev


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
    ``trace_len`` sizes the per-lane settled-per-phase ring (1 = off).
    ``dist_true`` is read only by oracle plans, which are not ported, so it
    is dropped, as the reference drops it for non-oracle plans. Telemetry
    rings and delta-stepping are not ported yet and raise. ``targets``, a
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
    if delta is not None:
        raise ValueError(
            f"criterion {policy.spec!r} does not take a delta bucket "
            f"width; use criterion='delta' for delta-stepping"
        )
    if telemetry:
        raise not_ported("telemetry=True (the extended rings)",
                          "Queue 1 item 5")
    b = src_np.shape[0]
    tg = _validate_targets(targets, b, g.n)
    d0, status0 = _fresh_rows(torch.from_numpy(src_np).to(dev), g.n)
    zeros_i32 = torch.zeros((b,), dtype=torch.int32, device=dev)
    zeros_i64 = torch.zeros((b,), dtype=torch.int64, device=dev)
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
        settled_trace=torch.zeros((b, int(trace_len)), dtype=torch.int32,
                                  device=dev),
        target=None if tg is None else torch.from_numpy(tg).to(dev),
        criterion=policy.spec,
    )


def _phase(g: Graph, ell_in, ell_out, s: BatchState, policy: P.PhasePolicy,
           use_kernels: bool) -> BatchState:
    """One trip of the loop: the policy's phase plus the chassis' ring and
    counter writes, gated per lane on ``n_fringe > 0``. On a target lane,
    the phase its target settles demotes the remaining fringe to status 0:
    the lane is then a fixed point, and the phase itself still counts."""
    out = policy.phase(g, ell_in, ell_out, s, use_kernels)
    rows = torch.arange(s.num_lanes, device=s.device)
    status = out.status
    if s.target is not None:
        tcol = s.target.clamp(0, s.n - 1).long()
        hit = (s.target >= 0) & (status[rows, tcol] == 2)
        status = torch.where(hit[:, None] & (status == 1), 0, status)
    lane_on = out.n_fringe > 0  # finished/empty lanes stop counting
    idx = (s.phases % s.settled_trace.shape[1]).long()
    trace = s.settled_trace.clone()
    # dead lanes must not write: their stuck slot may hold a wrapped entry
    trace[rows, idx] = torch.where(lane_on, out.n_settled,
                                   s.settled_trace[rows, idx])
    return BatchState(
        dist=out.dist,
        status=status,
        trips=s.trips + 1,
        phases=s.phases + lane_on.to(torch.int32),
        sum_fringe=s.sum_fringe + out.n_fringe.to(torch.int64),
        relax_edges=s.relax_edges + out.relax_inc,
        out_deg=s.out_deg,
        crit_keys=out.crit_keys,
        keys_valid=s.keys_valid,
        settled_trace=trace,
        target=s.target,
        criterion=s.criterion,
    )


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
    (default ``to_ell_in(g)``); ``ell_out`` the outgoing one, read by the
    plans whose phase reads it (``needs_out_adjacency``: out-side dynamic
    keys, or the push relax of every plan without in-side keys, the default
    among them; default the memoised ``to_ell_out(g)``, or
    ``to_ell_out_sliced(g)`` when ``ell`` is sliced). Either may be the
    padded ``(cols, ws)`` pair or a degree-sliced ``SlicedEll``: results
    are bit-identical between layouts. Before the loop, even one that runs
    no trip, the policy re-primes carried keys that admission made stale.
    ``use_kernels=False`` runs the plain twins: bit-identical results.
    """
    if ell is None:
        ell = to_ell_in(g)
    if state.device != g.device:
        raise ValueError(
            f"state lives on {state.device}, the graph on {g.device}"
        )
    policy = P.policy_for(state.criterion)
    if not policy.needs_out_adjacency:
        ell_out = None
    elif ell_out is None:
        ell_out = to_ell_out_sliced(g) if _is_sliced(ell) else to_ell_out(g)
    live0 = torch.any(state.status == 1, dim=1)  # (B,) lanes live at entry
    s = policy.prime(g, ell, state, use_kernels)
    for _ in range(max(int(k_phases), 0)):
        live = torch.any(s.status == 1, dim=1)  # lanes never revive
        go = torch.any(live)
        if stop_on_lane_finish:
            go = go & torch.all(live == live0)
        if not bool(go):  # the one host sync of a trip
            break
        s = _phase(g, ell, ell_out, s, policy, use_kernels)
    return s


def reset_lanes(state: BatchState, sources, dist_true=None,
                targets=None) -> BatchState:
    """Re-initialise several lanes in one call.

    ``sources`` is a ``(B,)`` int vector aligned with the lanes: ``-2``
    (:data:`KEEP_LANE`) leaves that lane's bits untouched, ``-1``
    (:data:`EMPTY_LANE`) parks it empty, and a vertex id starts a fresh
    query there, bitwise the same as a fresh :func:`init_batch_state` row.
    On a target-enabled state, ``targets`` gives each touched lane its new
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
    if dist_true is not None:
        raise ValueError(
            f"criterion {state.criterion!r} does not read dist_true"
        )
    return _reset_lanes(
        state, torch.from_numpy(src_np).to(state.device),
        bool((src_np >= EMPTY_LANE).any()),
        None if tg is None else torch.from_numpy(tg).to(state.device))


def _reset_lanes(state: BatchState, sources: torch.Tensor, any_touched: bool,
                 targets: torch.Tensor | None = None) -> BatchState:
    touch = sources >= EMPTY_LANE  # KEEP_LANE rows pass through unchanged
    fresh_d, fresh_s = _fresh_rows(sources, state.n)
    crit_keys = state.crit_keys
    if crit_keys is not None:
        fresh_k = P.policy_for(state.criterion).fresh_keys(
            state.num_lanes, state.n, state.device)
        crit_keys = torch.where(touch[None, :, None], fresh_k, crit_keys)

    def ctr(old):
        return torch.where(touch, 0, old)

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
        settled_trace=torch.where(touch[:, None], 0, state.settled_trace),
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
    must never read as a profile.
    """
    traced = state.settled_trace.shape[1] > 1
    return BatchedResult(
        dist=state.dist,
        status=state.status.to(torch.int8),
        phases=state.phases,
        sum_fringe=state.sum_fringe.cpu().numpy(),
        relax_edges=state.relax_edges.cpu().numpy(),
        total_phases=state.trips,
        settled_per_phase=state.settled_trace if traced else None,
        target=state.target,
    )


def _resolve_layout(g: Graph, ell, layout: str):
    """The incoming view: ``ell`` as passed, else the one ``layout`` names.
    The outgoing view is left to :func:`step_batch`, which builds one in the
    same layout only for plans that read it."""
    if layout not in ("padded", "sliced"):
        raise ValueError(f"layout must be 'padded' or 'sliced'; got {layout!r}")
    if ell is None:
        ell = to_ell_in_sliced(g) if layout == "sliced" else to_ell_in(g)
    return ell


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
    profile. ``device`` (None = the CUDA card) must be the graph's device.
    ``layout``, ``ell`` and ``ell_out`` are as in
    :func:`run_phased_static_batch`. ``target`` makes it an s->t query:
    only ``dist[target]`` (bit-exact against the full solve) and the
    vertices nearer than it are final on the returned row.
    """
    ell = _resolve_layout(g, ell, layout)
    policy = P.policy_for(criterion)
    cap = int(max_phases) if max_phases is not None else policy.phase_cap(g.n)
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source must be in [0, {g.n}); got {source}")
    if trace_len is None:
        trace_len = cap
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
    ``max_phases`` caps the trips (default n + 1); ``device`` (None = the
    CUDA card) must be the graph's device; ``layout`` ("padded" or
    "sliced") names the incoming view built when ``ell`` is None;
    ``ell_out`` is the outgoing view (default: one in ``ell``'s layout, for
    the plans that read it, see :func:`step_batch`); ``targets`` (B,) gives
    per-lane s->t targets (-1 = full solve), as in :func:`init_batch_state`.
    """
    ell = _resolve_layout(g, ell, layout)
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
