"""Engine backend adapters: the seam between a scheduler and the stepper
(counterpart of ``repro.serving.backends``).

A scheduler drives an :class:`EngineBackend`, a five-method adapter
(``init`` / ``step`` / ``reset_lanes`` / ``peek`` / ``take_row``) over a
resumable B-lane phase stepper. :class:`StaticBackend` is the
single-device one, over ``repro_torch.core.static_engine``: a lane is a
fixed point when empty or finished, a reset lane is bitwise a fresh solve,
and ``stop_on_lane_finish`` ends a chunk on the first lane termination.
:class:`~repro_torch.serving.scheduler.ContinuousBatcher` drives it.

The engine portfolio routes by measurement: :func:`graph_family` buckets a
graph by degree skew, weight tail and hop depth; :func:`measure_portfolio`
probes each :class:`EngineCandidate` (policy x layout, with a Δ-grid) on
the graph's device and records its walls and settle attribution in the
tuning ledger (``repro_torch.kernels.config``); :func:`pick_engine` reads
the recorded qps argmax; :class:`PortfolioBackend` serves through that
candidate's :class:`StaticBackend`. The sharded backend waits for ROADMAP
Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import policies as P
from repro_torch.core.delta_stepping import default_delta
from repro_torch.core.graph import (
    Graph,
    out_degrees,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
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
