"""Engine backend adapters: the seam between a scheduler and the stepper
(counterpart of ``repro.serving.backends``).

A scheduler drives an :class:`EngineBackend`, a five-method adapter
(``init`` / ``step`` / ``reset_lanes`` / ``peek`` / ``take_row``) over a
resumable B-lane phase stepper. :class:`StaticBackend` is the
single-device one, over ``repro_torch.core.static_engine``: a lane is a
fixed point when empty or finished, a reset lane is bitwise a fresh solve,
and ``stop_on_lane_finish`` ends a chunk on the first lane termination.
:class:`~repro_torch.serving.scheduler.ContinuousBatcher` drives it.
:class:`ShardedBackend` is the same seam over the sharded stepper of
``repro_torch.core.distributed``, one vertex block a rank of a
``torch.distributed`` group: the batcher runs on rank 0, and each of its
calls first broadcasts a small command that the other ranks, in
:meth:`ShardedBackend.follow`, replay on their blocks.

The engine portfolio routes by measurement: :func:`graph_family` buckets a
graph by degree skew, weight tail and hop depth; :func:`measure_portfolio`
probes each :class:`EngineCandidate` (policy x layout, with a Δ-grid) on
the graph's device and records its walls and settle attribution in the
tuning ledger (``repro_torch.kernels.config``); :func:`pick_engine` reads
the recorded qps argmax; :class:`PortfolioBackend` serves through that
candidate's :class:`StaticBackend`.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import criteria as C
from repro_torch.core import distributed as D
from repro_torch.core import policies as P
from repro_torch.core.delta_stepping import default_delta
from repro_torch.core.graph import (
    Graph,
    out_degrees,
    to_numpy_csr,
)
from repro_torch.core.static_engine import (
    DEFAULT_CRITERION,
    EMPTY_LANE,
    BatchState,
    graph_device,
    init_batch_state,
    reset_lanes,
    run_phased_static_batch,
    step_batch,
)
from repro_torch.kernels import config as kcfg
from repro_torch.obs.timer import timed


_ORACLE_REFUSED = ("serving backends cannot run the 'oracle' criterion: it "
                   "requires per-query true distances up front")


def _serving_policy(spec: str) -> P.PhasePolicy:
    """Validate and resolve a serving policy spec (a criterion or
    ``"delta"``), rejecting ``oracle`` plans as the reference does: a
    clairvoyant criterion needs the answer it is supposed to compute as
    input, which no online workload has."""
    pol = P.policy_for(spec)
    if pol.needs_oracle:
        raise ValueError(_ORACLE_REFUSED)
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
    keys, the default and delta among them) build it once, here; delta
    builds no in-view (``ell`` stays None), since its push reads none.
    ``layout="sliced"``
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
        # built once, each where the policy reads it (delta reads no
        # in-view): rebuilding per step would re-sort every arc per chunk
        self.ell = pol.in_view(g, sliced) if ell is None else ell
        self.ell_out = pol.out_view(g, sliced)
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


class ShardedBackend:
    """Adapter over the sharded batch stepper (``core/distributed.py``).

    Every rank of ``group`` (None = the default world) builds one with the
    same arguments; each shards the graph and keeps its vertex block. The
    scheduler runs on rank 0 only: its clock and deadlines would make SPMD
    copies diverge. There, each of the five methods first broadcasts a
    command (op, ``k``, flags, the reset sources or the lane) to the group;
    ranks 1 and up call :meth:`follow`, which replays the commands on their
    blocks until rank 0's :meth:`close`. ``peek`` reduces the live flags
    over the group; ``take_row`` gathers the lane's ``(n,)`` row.

    ``device`` (None = ``cuda:(rank % device_count)``) must be the graph's
    device. ``use_kernels=False`` runs the plain path. The transpose
    partition is built only for plans with out-side dynamic keys. Oracle
    plans and s->t ``targets`` are refused (``ValueError``), as the
    reference refuses them; ``donate`` changes nothing.
    """

    _INIT, _STEP, _RESET, _PEEK, _ROW, _CLOSE = range(1, 7)

    def __init__(self, g: Graph, group=None,
                 schedule: str = "reduce_scatter", pad_multiple: int = 8,
                 criterion: str = DEFAULT_CRITERION, device=None,
                 use_kernels: bool = True):
        plan = C.plan_for(criterion)
        if plan.needs_oracle:
            raise ValueError(_ORACLE_REFUSED)
        if schedule not in D.SCHEDULES:
            raise ValueError(f"unknown exchange schedule: {schedule!r}")
        self.device = graph_device(g, D.rank_device(group, device))
        self.g = g
        self.group = group
        self.schedule = schedule
        self.criterion = plan.criterion
        self.use_kernels = bool(use_kernels)
        self.rank, size = D.group_rank_size(group)
        self.comm = D.Comm(group, self.device)
        self.sg = D.shard_graph_batch(
            g, size, pad_multiple=pad_multiple,
            with_transpose=plan.needs_out_adjacency, group=group)
        self._state = None  # a follower's own state

    @property
    def n(self) -> int:
        return self.g.n

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def _tell(self, op: int, a: int = 0, b: int = 0) -> None:
        """Rank 0: broadcast one command header ``[op, a, b]``."""
        if not self.leader:
            raise RuntimeError(
                "only rank 0 drives a ShardedBackend; the other ranks call "
                "follow()"
            )
        self.comm.broadcast(torch.tensor([op, a, b], dtype=torch.int64))

    def _sources(self, src: np.ndarray | None, lanes: int) -> np.ndarray:
        """The reset vector (validated on rank 0), rank 0's on every rank."""
        t = (torch.zeros(lanes, dtype=torch.int64) if src is None
             else torch.from_numpy(src.astype(np.int64)))
        return self.comm.broadcast(t).cpu().numpy()

    # the SPMD bodies, run on every rank
    def _do_init(self, lanes: int):
        return D.init_sharded_batch_state(
            self.sg, np.full(lanes, EMPTY_LANE, np.int32),
            criterion=self.criterion)

    def _do_step(self, state, k_phases: int, stop: bool):
        return D.step_sharded_batch(
            self.sg, state, self.group, k_phases, schedule=self.schedule,
            stop_on_lane_finish=stop, use_kernels=self.use_kernels)

    def _do_peek(self, state):
        live = self.comm.sum_((state.status == 1).sum(dim=1)) > 0
        return (int(state.trips), live.cpu().numpy(),
                state.phases.cpu().numpy())

    def _do_row(self, state, lane: int) -> np.ndarray:
        row = self.comm.gather(state.dist[int(lane)])
        return row[: self.g.n].cpu().numpy().copy()

    # the EngineBackend seam, called on rank 0
    def init(self, lanes: int):
        self._tell(self._INIT, lanes)
        return self._do_init(lanes)

    def step(self, state, k_phases, *, stop_on_lane_finish=True, donate=False):
        self._tell(self._STEP, int(k_phases), int(bool(stop_on_lane_finish)))
        return self._do_step(state, int(k_phases), bool(stop_on_lane_finish))

    def reset_lanes(self, state, sources, *, donate=False, targets=None):
        if targets is not None:
            raise ValueError(
                "ShardedBackend does not support s->t target lanes; serve "
                "point queries through a point-capable StaticBackend"
            )
        new = D.reset_sharded_lanes(state, sources)  # raises before a command
        self._tell(self._RESET, state.num_lanes)
        self._sources(np.asarray(sources), state.num_lanes)
        return new

    def peek(self, state):
        self._tell(self._PEEK)
        return self._do_peek(state)

    def take_row(self, state, lane):
        self._tell(self._ROW, int(lane))
        return self._do_row(state, lane)

    def close(self) -> None:
        """Rank 0: release the followers (their :meth:`follow` returns)."""
        self._tell(self._CLOSE)

    def follow(self) -> int:
        """Ranks 1 and up: replay rank 0's commands on this rank's block
        until its :meth:`close`; returns the commands replayed."""
        if self.leader:
            raise RuntimeError("rank 0 drives the backend; it does not follow")
        done = 0
        while True:
            op, a, b = self.comm.broadcast(
                torch.zeros(3, dtype=torch.int64)).tolist()
            if op == self._CLOSE:
                return done
            if op == self._INIT:
                self._state = self._do_init(a)
            elif op == self._STEP:
                self._state = self._do_step(self._state, a, bool(b))
            elif op == self._RESET:
                self._state = D.reset_sharded_lanes(self._state,
                                                    self._sources(None, a))
            elif op == self._PEEK:
                self._do_peek(self._state)
            elif op == self._ROW:
                self._do_row(self._state, a)
            else:
                raise RuntimeError(f"unknown ShardedBackend command {op}")
            done += 1


# ---------------------------------------------------------------------------
# Engine portfolio: measured policy x layout routing
# ---------------------------------------------------------------------------
#
# The family buckets are computed in f64 numpy on the host, as the
# reference computes them: the 4.0 and 0.9 thresholds must fall on the same
# side in both packages.


def _degree_bucket(g: Graph) -> str:
    """``max/mean`` out-degree >= 4 reads as a skewed (power-law-ish) graph,
    where the sliced layout pays off; everything else as flat."""
    deg = out_degrees(g).cpu().numpy().astype(np.float64)
    mean = float(deg.mean()) if deg.size else 0.0
    if mean <= 0.0:
        return "flat"
    return "skew" if float(deg.max()) / mean >= 4.0 else "flat"


def _weight_bucket(g: Graph) -> str:
    """Coefficient of variation of the finite edge weights: >= 0.9 reads as
    heavy-tailed (exponential sits at 1.0, uniform at ~0.58), where Δ's
    bucket width matters."""
    w = g.w.cpu().numpy().astype(np.float64)
    w = w[np.isfinite(w)]
    mean = float(w.mean()) if w.size else 0.0
    if mean <= 0.0:
        return "uniform"
    return "heavy" if float(w.std()) / mean >= 0.9 else "uniform"


def _depth_bucket(g: Graph) -> str:
    """Hop-diameter proxy: one host BFS (out-edges, unweighted) from the
    max-out-degree vertex; an eccentricity above 2*log2(n) reads as deep
    (road- or grid-like), where phase counts follow depth rather than
    log n."""
    n = g.n
    if n <= 1:
        return "shallow"
    indptr, indices, _ = to_numpy_csr(g)
    counts_all = np.diff(indptr)
    start = int(np.argmax(counts_all))
    seen = np.zeros(n, bool)
    seen[start] = True
    frontier = np.array([start], np.int64)
    ecc = 0
    while frontier.size:
        starts = indptr[frontier]
        counts = counts_all[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.repeat(starts, counts) + (
            np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        nbr = np.unique(indices[offs])
        nbr = nbr[~seen[nbr]]
        if nbr.size == 0:
            break
        seen[nbr] = True
        frontier = nbr
        ecc += 1
    return "deep" if ecc > 2.0 * np.log2(n) else "shallow"


def graph_family(g: Graph) -> str:
    """The workload bucket the portfolio ledger keys on,
    ``<deg>-<wt>-<depth>``: degree skew (``flat``/``skew``), weight tail
    (``uniform``/``heavy``) and hop depth (``shallow``/``deep``), each the
    regime boundary of one routing decision (layout, bucket width, criterion
    dynamism). Memoised on the graph instance (the depth proxy copies the
    CSR to the host once)."""
    fam = g.__dict__.get("_graph_family")
    if fam is None:
        fam = f"{_degree_bucket(g)}-{_weight_bucket(g)}-{_depth_bucket(g)}"
        g.__dict__["_graph_family"] = fam
    return fam


def family_fallbacks(family: str) -> tuple[str, ...]:
    """Ledger lookup order for a family: the rich key, then its leading
    degree bucket (the whole family name of records written before the
    weight and depth axes existed)."""
    coarse = family.split("-", 1)[0]
    return (family,) if coarse == family else (family, coarse)


@dataclasses.dataclass(frozen=True)
class EngineCandidate:
    """One engine configuration the portfolio may route a workload to."""

    policy: str  # policy spec ("in|out", "delta", ...)
    layout: str  # "padded" | "sliced"
    delta: float | None = None  # absolute bucket width override (delta only)
    delta_scale: float | None = None  # x default_delta(g): the
    #   graph-relative form a Δ-grid needs

    @property
    def spec(self) -> str:
        return P.canonical_spec(self.policy)

    @property
    def ledger_policy(self) -> str:
        """The policy segment of the portfolio ledger key: a Δ-grid member
        carries its override, the plain spelling stays the bare spec."""
        if self.delta is not None:
            return f"{self.spec}@d{self.delta:g}"
        if self.delta_scale is not None:
            return f"{self.spec}@x{self.delta_scale:g}"
        return self.spec

    def resolve_delta(self, g: Graph) -> float | None:
        """The absolute bucket width this candidate runs ``g`` with (None:
        the policy default, ``default_delta(g)``)."""
        if self.delta is not None:
            return float(self.delta)
        if self.delta_scale is not None:
            return float(self.delta_scale) * default_delta(g)
        return None


DEFAULT_CANDIDATES: tuple[EngineCandidate, ...] = (
    EngineCandidate("instatic|outstatic", "padded"),
    EngineCandidate("in|out", "padded"),
    EngineCandidate("in|out", "sliced"),
    EngineCandidate("delta", "padded"),
    EngineCandidate("delta", "sliced"),
    # a Δ-grid around the Meyer-Sanders default on Δ's strong layout: the
    # best width is a measured property of the family
    EngineCandidate("delta", "sliced", delta_scale=0.5),
    EngineCandidate("delta", "sliced", delta_scale=2.0),
    EngineCandidate("delta", "sliced", delta_scale=4.0),
)


def _attribution_totals(result, spec: str) -> dict[str, int]:
    """The harvested ``settle_attribution`` ring summed over lanes and
    phases, restricted to the policy's share terms."""
    if result.settle_attribution is None:
        return {}
    pol = P.policy_for(spec)
    share = set(pol.share_terms())
    attr = result.settle_attribution  # (B, trace_len, T)
    return {
        t: int(attr[:, :, k].sum())
        for k, t in enumerate(pol.attribution_terms())
        if t in share
    }


def measure_portfolio(
    g: Graph,
    *,
    lanes: int = 8,
    candidates: tuple[EngineCandidate, ...] = DEFAULT_CANDIDATES,
    ledger=None,
    use_kernels: bool = True,
    registry=None,
    repeats: int = 2,
) -> dict[tuple[str, str], dict]:
    """Probe every candidate on ``g`` (on the graph's device) and record
    measured entries.

    Each candidate solves the same ``lanes``-source batch: once with
    telemetry (phase counts and the policy's settle-attribution totals),
    once untimed without it (a warm-up), then timed without it (median of
    ``repeats``, each solve closed by a ``torch.cuda.synchronize()`` on the
    card, so the wall is the solve's and not its enqueue). Entries land in
    the tuning ledger under ``portfolio_ledger_key``, tagged with the
    graph's device (``config.device_tag``); returns (ledger_policy, layout)
    -> entry.
    """
    if ledger is None:
        ledger = kcfg.global_ledger()
    dev = g.device
    family = graph_family(g)
    sources = (np.arange(lanes, dtype=np.int64) * 7919) % g.n
    out: dict[tuple[str, str], dict] = {}
    for cand in candidates:
        spec = cand.spec
        pol = P.policy_for(spec)
        kw: dict = {"criterion": spec, "layout": cand.layout,
                    "use_kernels": use_kernels, "device": dev}
        delta_eff = None
        if pol.uses_delta:
            delta_eff = cand.resolve_delta(g)
            kw["delta"] = delta_eff  # None -> default_delta(g) downstream
        probe = run_phased_static_batch(
            g, sources, trace_len=pol.phase_cap(g.n), telemetry=True, **kw
        )

        def solve(kw=kw):
            res = run_phased_static_batch(g, sources, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return res

        solve()
        wall_s, _ = timed(solve, repeats=repeats)
        entry = kcfg.record_portfolio(
            ledger, family, lanes, cand.ledger_policy, cand.layout,
            wall_s=wall_s,
            phases=int(probe.phases.sum()),
            queries=lanes,
            delta=delta_eff,
            attribution=_attribution_totals(probe, spec),
            device=dev,
        )
        del probe
        out[(cand.ledger_policy, cand.layout)] = entry
        if registry is not None:
            registry.gauge(
                f"portfolio.qps.{cand.ledger_policy}.{cand.layout}",
                "measured queries/s for one portfolio candidate",
            ).set(entry["qps"])
    return out


def pick_engine(
    family: str,
    lanes: int,
    candidates: tuple[EngineCandidate, ...] = DEFAULT_CANDIDATES,
    ledger=None,
    device=None,
) -> EngineCandidate:
    """The measured-best candidate for (family, lanes): the recorded-qps
    argmax over the candidates with entries, under the rich family key or
    else its coarse fallback; with no entries, the first candidate (the
    paper's default criterion), so routing never waits on a probe. Given a
    ``device``, entries measured on another device are not read (an
    untagged entry, as the reference writes them, is)."""
    if ledger is None:
        ledger = kcfg.global_ledger()
    entries: dict = {}
    for fam in family_fallbacks(family):
        entries = kcfg.portfolio_entries(ledger, fam, lanes, device)
        if entries:
            break
    best, best_qps = None, -1.0
    for cand in candidates:
        entry = entries.get((cand.ledger_policy, cand.layout))
        if entry is not None and entry.get("qps", 0.0) > best_qps:
            best, best_qps = cand, float(entry["qps"])
    return best if best is not None else candidates[0]


class PortfolioBackend:
    """An :class:`EngineBackend` that picks its engine from the ledger.

    At construction it resolves ``graph_family(g)``, reads the ledger's
    portfolio records for (family, ``lanes_hint``) and builds the
    measured-best candidate as an inner :class:`StaticBackend` on the
    graph's device; entries measured on another device do not count.
    ``probe=True``, or a ledger with no record of the family, runs
    :func:`measure_portfolio` first: the first server of a
    family pays one probe, later ones route from the records. The five
    protocol methods delegate; ``criterion`` is the routed policy's.
    """

    def __init__(self, g: Graph, lanes_hint: int = 8,
                 candidates: tuple[EngineCandidate, ...] = DEFAULT_CANDIDATES,
                 ledger=None, use_kernels: bool = True, probe: bool = False,
                 registry=None, point_queries: bool = False):
        if not candidates:
            raise ValueError("candidates must be non-empty")
        if ledger is None:
            ledger = kcfg.global_ledger()
        self.family = graph_family(g)
        self.lanes_hint = int(lanes_hint)
        if probe or not any(
            kcfg.portfolio_entries(ledger, fam, self.lanes_hint, g.device)
            for fam in family_fallbacks(self.family)
        ):
            measure_portfolio(
                g, lanes=self.lanes_hint, candidates=candidates,
                ledger=ledger, use_kernels=use_kernels, registry=registry,
            )
        self.choice = pick_engine(self.family, self.lanes_hint, candidates,
                                  ledger, g.device)
        self.inner = StaticBackend(
            g, use_kernels=use_kernels, layout=self.choice.layout,
            policy=self.choice.policy, delta=self.choice.resolve_delta(g),
            point_queries=point_queries, device=g.device,
        )
        self.g = g
        self.criterion = self.inner.criterion
        self.point_queries = self.inner.point_queries

    @property
    def n(self) -> int:
        return self.inner.n

    def init(self, lanes: int) -> BatchState:
        return self.inner.init(lanes)

    def step(self, state, k_phases, *, stop_on_lane_finish=True, donate=False):
        return self.inner.step(state, k_phases,
                               stop_on_lane_finish=stop_on_lane_finish,
                               donate=donate)

    def reset_lanes(self, state, sources, *, donate=False, targets=None):
        return self.inner.reset_lanes(state, sources, donate=donate,
                                      targets=targets)

    def peek(self, state):
        return self.inner.peek(state)

    def take_row(self, state, lane):
        return self.inner.take_row(state, lane)
