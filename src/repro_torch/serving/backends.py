"""Engine backend adapter: the seam between a scheduler and the stepper
(counterpart of ``repro.serving.backends``).

A scheduler drives an :class:`EngineBackend`, a five-method adapter
(``init`` / ``step`` / ``reset_lanes`` / ``peek`` / ``take_row``) over a
resumable B-lane phase stepper. :class:`StaticBackend` is the
single-device one, over ``repro_torch.core.static_engine``: a lane is a
fixed point when empty or finished, a reset lane is bitwise a fresh solve,
and ``stop_on_lane_finish`` ends a chunk on the first lane termination.
:class:`~repro_torch.serving.scheduler.ContinuousBatcher` drives it. The
portfolio and sharded backends wait for ROADMAP Queue 1 items 8 and 11.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import policies as P
from repro_torch.core.delta_stepping import default_delta
from repro_torch.core.graph import (
    Graph,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
)
from repro_torch.core.static_engine import (
    DEFAULT_CRITERION,
    EMPTY_LANE,
    BatchState,
    graph_device,
    init_batch_state,
    reset_lanes,
    step_batch,
)


def _serving_policy(spec: str) -> P.PhasePolicy:
    """Validate and resolve a serving policy spec (a criterion or
    ``"delta"``), rejecting ``oracle`` plans as the reference does: a
    clairvoyant criterion needs the answer it is supposed to compute as
    input, which no online workload has."""
    pol = P.policy_for(spec)
    if pol.needs_oracle:
        raise ValueError(
            "serving backends cannot run the 'oracle' criterion: it requires "
            "per-query true distances up front"
        )
    return pol


@runtime_checkable
class EngineBackend(Protocol):
    """What a scheduler needs from a resumable B-lane engine."""

    g: Graph
    criterion: str  # canonical criterion string the engine solves with

    @property
    def n(self) -> int:
        """Vertex count queries are validated against."""
        ...

    def init(self, lanes: int):
        """Fresh all-empty state with ``lanes`` lanes."""
        ...

    def step(self, state, k_phases: int, *, stop_on_lane_finish: bool = True,
             donate: bool = False):
        """Advance up to ``k_phases`` trips (early exit on lane finish)."""
        ...

    def reset_lanes(self, state, sources: np.ndarray, *, donate: bool = False,
                    targets: np.ndarray | None = None):
        """Re-init the lanes ``sources`` selects (KEEP_LANE passes through).

        ``targets`` (point-capable backends only) gives each admitted lane
        its s->t target vertex, ``EMPTY_LANE`` for a full solve."""
        ...

    def peek(self, state) -> tuple[int, np.ndarray, np.ndarray]:
        """(trips, (B,) bool live flags, (B,) int phases): one device sync."""
        ...

    def take_row(self, state, lane: int) -> np.ndarray:
        """Lane ``lane``'s (n,) f32 distance row as a host-owned array."""
        ...


class StaticBackend:
    """Adapter over the single-device stepper.

    ``device`` (None = the CUDA card) must be the graph's device.
    ``use_kernels=False`` runs the plain twins. ``donate`` is accepted for
    the :class:`EngineBackend` seam and changes nothing: the port's stepper
    never aliases the state it is given. Plans that read the outgoing ELL
    (out-side dynamic keys, or the push relax of every plan without in-side
    keys, the default among them) build it once, here. ``layout="sliced"``
    builds the degree-sliced in- and out-views instead of the padded ones
    (the same bits). ``point_queries=True`` initialises target-capable lane
    state, so a scheduler can mix full solves and early-exiting s->t lanes
    in one batch; off by default, a target-free backend runs the exact
    pre-target program. ``policy`` (any policy spec, a criterion or
    ``"delta"``) takes precedence over ``criterion``; ``delta`` is the
    bucket width of the delta policy (default ``default_delta(g)``) and is
    rejected for any other. Oracle plans are rejected (``ValueError``).
    """

    def __init__(self, g: Graph, ell=None, use_kernels: bool = True,
                 criterion: str = DEFAULT_CRITERION, layout: str = "padded",
                 policy: str | None = None, delta: float | None = None,
                 point_queries: bool = False, device=None):
        pol = _serving_policy(policy if policy is not None else criterion)
        if layout not in ("padded", "sliced"):
            raise ValueError(
                f"layout must be 'padded' or 'sliced'; got {layout!r}"
            )
        self.delta = None
        if pol.uses_delta:
            self.delta = float(delta) if delta is not None else default_delta(g)
        elif delta is not None:
            raise ValueError(
                f"policy {pol.spec!r} does not take a delta bucket width; "
                "use policy='delta' for delta-stepping"
            )
        self.device = graph_device(g, device)
        self.g = g
        sliced = layout == "sliced"
        if ell is None:
            ell = to_ell_in_sliced(g) if sliced else to_ell_in(g)
        self.ell = ell
        # built once: rebuilding per step would re-sort every arc per chunk
        self.ell_out = None
        if pol.needs_out_adjacency:
            self.ell_out = to_ell_out_sliced(g) if sliced else to_ell_out(g)
        self.use_kernels = bool(use_kernels)
        self.criterion = pol.spec
        self.point_queries = bool(point_queries)

    @property
    def n(self) -> int:
        return self.g.n

    def init(self, lanes: int) -> BatchState:
        empty = np.full(lanes, EMPTY_LANE, np.int32)
        return init_batch_state(
            self.g, empty, criterion=self.criterion, delta=self.delta,
            targets=empty if self.point_queries else None, device=self.device,
        )

    def step(self, state, k_phases, *, stop_on_lane_finish=True, donate=False):
        return step_batch(
            self.g, state, k_phases, ell=self.ell,
            use_kernels=self.use_kernels,
            stop_on_lane_finish=stop_on_lane_finish, ell_out=self.ell_out,
        )

    def reset_lanes(self, state, sources, *, donate=False, targets=None):
        return reset_lanes(state, sources, targets=targets)

    def peek(self, state):
        # one device-to-host copy: [trips, live flags (B), phases (B)]
        b = state.num_lanes
        host = torch.cat([
            state.trips.reshape(1),
            torch.any(state.status == 1, dim=1).to(torch.int32),
            state.phases,
        ]).cpu().numpy()
        return int(host[0]), host[1:1 + b].astype(bool), host[1 + b:]

    def take_row(self, state, lane):
        return state.dist[int(lane)].cpu().numpy().copy()
