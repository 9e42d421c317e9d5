"""Point-to-point (s->t) queries: early-exit lanes and bidirectional search
(counterpart of ``repro.serving.point``; every :class:`PointResult` field
is the reference's).

The *forward* lane is an ordinary target lane: it runs the engine from
``source`` with ``BatchState.target = target``, so it exits the phase its
target settles and relaxes only from settled vertices nearer than the
target's tentative distance. Its ``dist[target]`` is bit-exact against a
full solve.

*Bidirectional* mode couples a second lane: the same engine run from
``target`` on the memoised transpose graph, whose labels satisfy
``d_b[v] == dist_g(v -> t)``. The two lanes share a best-seen meeting
bound ``mu = min_v fl(d_f[v] + d_b[v])``, an upper bound on the s->t
distance, used for two purposes only:

  * **backward retirement**: once the backward fringe's minimum distance
    reaches ``mu``, no further backward phase can improve it, so the
    backward lane stops;
  * **unreachability certification**: if the backward lane exhausts
    ``target``'s in-ball without reaching ``source``, no s->t path exists
    and the query answers ``inf`` at once, where the forward lane alone
    would flood ``source``'s whole out-component.

``mu`` never prunes the forward lane and is never the answer: the sum
``fl(d_f[v] + d_b[v])`` associates the path differently from the forward
evaluation, so it can round below the forward ``dist[t]``. The answer is
always the forward lane's ``dist[target]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import (
    Graph,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
    transpose,
)
from repro_torch.core.static_engine import (
    DEFAULT_CRITERION,
    graph_device,
    init_batch_state,
    step_batch,
)
from repro_torch.serving.backends import _serving_policy

INF = float("inf")


def transpose_memo(g: Graph) -> Graph:
    """``transpose(g)``, memoised on the graph instance. Its tensors are
    views of ``g``'s and its ELL views are ``g``'s, swapped
    (:func:`~repro_torch.core.graph.transpose` shares the memos), so the
    backward lane costs no second copy of the adjacency."""
    tr = g.__dict__.get("_transpose")
    if tr is None:
        tr = transpose(g)
        g.__dict__["_transpose"] = tr
    return tr


def _meet(df: torch.Tensor, db: torch.Tensor) -> tuple[float, int]:
    """Best meeting bound over the current labels: ``(mu, vertex)``, the
    vertex the first minimum of ``fl(df[v] + db[v])``, as ``jnp.argmin``
    chooses it (``torch.argmin`` returns the first minimal index, ties
    and all-+inf rows included). One device-to-host copy."""
    tot = df[0] + db[0]
    v = torch.argmin(tot)
    host = torch.stack([tot[v].double(), v.double()]).cpu().numpy()
    return float(host[0]), int(host[1])


def _lane_stats(state) -> tuple[bool, int, float]:
    """Lane 0's (live, phases, min fringe d) in one device-to-host copy."""
    fringe = state.status[0] == 1
    host = torch.stack([
        fringe.any().double(),
        state.phases[0].double(),
        torch.where(fringe, state.dist[0], INF).min().double(),
    ]).cpu().numpy()
    return bool(host[0]), int(host[1]), float(host[2])


@dataclasses.dataclass(frozen=True)
class PointResult:
    """One answered s->t query.

    ``distance`` (== ``dist[target]``) is bit-exact against the full
    solve; the rest of ``dist`` is partial: the bound only guarantees
    labels at or nearer than the target.
    """

    source: int
    target: int
    distance: float
    dist: np.ndarray  # forward lane's (n,) row; only dist[target] guaranteed
    phases_forward: int
    phases_backward: int  # 0 in forward-only mode
    mu: float  # best meeting bound seen (upper bound on distance)
    meeting_vertex: int | None
    unreachable_certified: bool  # backward lane proved no s->t path exists


class PointBackend:
    """Reusable s->t query engine over one graph (forward + backward views).

    Construction resolves the policy and layout as
    :class:`~repro_torch.serving.backends.StaticBackend` does, on the
    graph's device (``device``: None = the CUDA card, which must be the
    graph's). The backward lane runs on the memoised transpose, whose views
    are the graph's own swapped: a bidirectional query builds at most the
    view the forward lane does not read, once per graph. ``query`` answers one (s, t) pair; :func:`run_point_to_point`
    wraps a per-graph memoised instance. ``policy="delta"`` is not ported
    yet and raises.
    """

    def __init__(self, g: Graph, *, criterion: str = DEFAULT_CRITERION,
                 policy: str | None = None, layout: str = "padded",
                 use_kernels: bool = True, bidirectional: bool = True,
                 phases_per_chunk: int = 8, device=None):
        spec = policy if policy is not None else criterion
        pol = _serving_policy(spec)
        if layout not in ("padded", "sliced"):
            raise ValueError(
                f"layout must be 'padded' or 'sliced'; got {layout!r}"
            )
        if phases_per_chunk < 1:
            raise ValueError(
                f"phases_per_chunk must be >= 1; got {phases_per_chunk}"
            )
        self.device = graph_device(g, device)
        self.g = g
        self.layout = layout
        self.criterion = pol.spec
        self._pol = pol
        self.ell, self.ell_out = self._views(g)
        self.use_kernels = bool(use_kernels)
        self.bidirectional = bool(bidirectional)
        self.phases_per_chunk = int(phases_per_chunk)
        self._bwd_views = None  # (gt, ell, ell_out) built on first use

    def _views(self, g: Graph):
        """The in-view, and the out-view where the policy reads it."""
        sliced = self.layout == "sliced"
        ell = to_ell_in_sliced(g) if sliced else to_ell_in(g)
        ell_out = None
        if self._pol.needs_out_adjacency:
            ell_out = to_ell_out_sliced(g) if sliced else to_ell_out(g)
        return ell, ell_out

    def _backward(self):
        if self._bwd_views is None:
            gt = transpose_memo(self.g)
            self._bwd_views = (gt, *self._views(gt))
        return self._bwd_views

    def _step(self, g, state, ell, ell_out):
        return step_batch(g, state, self.phases_per_chunk, ell=ell,
                          use_kernels=self.use_kernels,
                          stop_on_lane_finish=True, ell_out=ell_out)

    def query(self, source: int, target: int) -> PointResult:
        """Answer one s->t query; ``distance`` is bit-exact against the
        full solve."""
        n = self.g.n
        source, target = int(source), int(target)
        for name, v in (("source", source), ("target", target)):
            if not 0 <= v < n:
                raise ValueError(f"{name} must be in [0, {n}); got {v}")
        fwd = init_batch_state(
            self.g, np.array([source], np.int32), criterion=self.criterion,
            targets=np.array([target], np.int32), device=self.device,
        )
        bwd = bwd_graph = bwd_ell = bwd_ell_out = None
        if self.bidirectional:
            bwd_graph, bwd_ell, bwd_ell_out = self._backward()
            bwd = init_batch_state(
                bwd_graph, np.array([target], np.int32),
                criterion=self.criterion,
                targets=np.array([source], np.int32), device=self.device,
            )
        cap = self._pol.phase_cap(n)
        mu, meet_v = INF, None
        phases_b = 0
        bwd_live = bwd is not None
        unreachable = False
        while True:
            fwd = self._step(self.g, fwd, self.ell, self.ell_out)
            f_live, f_phases, _ = _lane_stats(fwd)
            if not f_live:
                break
            if bwd_live:
                bwd = self._step(bwd_graph, bwd, bwd_ell, bwd_ell_out)
                b_live, phases_b, b_min = _lane_stats(bwd)
                m, v = _meet(fwd.dist, bwd.dist)
                if m < mu:
                    mu, meet_v = m, v
                if not b_live:
                    bwd_live = False
                    if float(bwd.dist[0, source]) == INF:
                        # the backward lane exhausted target's in-ball
                        # without reaching source (its own exit fires
                        # only on a finite settle): no s->t path exists
                        unreachable = True
                        break
                elif b_min >= mu:
                    # no backward fringe vertex can improve mu any more
                    bwd_live = False
            if f_phases >= cap:
                raise RuntimeError(
                    f"s->t query exceeded the policy phase cap {cap}; "
                    "the engine should terminate within it on any input"
                )
        row = fwd.dist[0].cpu().numpy().copy()
        return PointResult(
            source=source,
            target=target,
            distance=float(row[target]),
            dist=row,
            phases_forward=int(fwd.phases[0]),
            phases_backward=phases_b,
            mu=mu,
            meeting_vertex=meet_v,
            unreachable_certified=unreachable,
        )


def run_point_to_point(
    g: Graph,
    source: int,
    target: int,
    *,
    criterion: str = DEFAULT_CRITERION,
    policy: str | None = None,
    layout: str = "padded",
    use_kernels: bool = True,
    bidirectional: bool = True,
    phases_per_chunk: int = 8,
    device=None,
) -> PointResult:
    """One-shot s->t query (memoises one :class:`PointBackend` per config
    on the graph instance, so repeated calls reuse the forward and
    transpose views). ``device`` (None = the CUDA card) must be the
    graph's device."""
    dev = graph_device(g, device)
    cache = g.__dict__.setdefault("_point_backends", {})
    spec = policy if policy is not None else criterion
    key = (spec, layout, bool(use_kernels), bool(bidirectional),
           int(phases_per_chunk))
    backend = cache.get(key)
    if backend is None:
        backend = PointBackend(
            g, criterion=criterion, policy=policy, layout=layout,
            use_kernels=use_kernels, bidirectional=bidirectional,
            phases_per_chunk=phases_per_chunk, device=dev,
        )
        cache[key] = backend
    return backend.query(source, target)
