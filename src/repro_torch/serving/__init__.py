"""Serving layer of the port (counterpart of ``repro.serving``): the
continuous batcher over the engine backend seam, its arrival queue, result
cache and metrics, point-to-point (s->t) queries, the engine portfolio and
the fault-tolerant tier.

A :class:`ContinuousBatcher` keeps B engine lanes busy by refilling
finished rows from an :class:`ArrivalQueue`; duplicate queries short-cut
through a :class:`DistCache` (or coalesce onto an in-flight lane), and
:class:`ServingMetrics` emits the throughput and latency report. The engine
is pluggable behind the :class:`EngineBackend` adapter: the single-device
stepper (:class:`StaticBackend`, default), :class:`PortfolioBackend`,
which routes to the measured-best policy x layout from the tuning ledger's
portfolio records, or :class:`ShardedBackend`, the sharded stepper over a
``torch.distributed`` group (the batcher on rank 0, the other ranks in
``follow()``). Every admitted query's distances are bit-exact against a
standalone solve.

The fault-tolerant tier layers on top: :class:`ResilientBatcher` verifies
every harvested row against the relax-fixed-point certificate
(:func:`verify_row`, on the graph's device), quarantines and retries
corrupted work, and recovers from engine step failures;
:class:`FaultPlan` / :class:`FaultyBackend` / :class:`FaultyDistCache` are
the deterministic chaos seam the guarantees are tested under.
"""
from repro_torch.serving.backends import (
    DEFAULT_CANDIDATES,
    EngineBackend,
    EngineCandidate,
    PortfolioBackend,
    ShardedBackend,
    StaticBackend,
    family_fallbacks,
    graph_family,
    measure_portfolio,
    pick_engine,
)
from repro_torch.serving.cache import DistCache, graph_key
from repro_torch.serving.faults import (
    Fault,
    FaultPlan,
    FaultyBackend,
    FaultyDistCache,
    InjectedFault,
    VirtualClock,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.point import (
    PointBackend,
    PointResult,
    run_point_to_point,
    transpose_memo,
)
from repro_torch.serving.queue import ArrivalQueue, Request
from repro_torch.serving.resilience import ResilientBatcher, verify_row
from repro_torch.serving.scheduler import (
    Backpressure,
    ContinuousBatcher,
    DrainStalled,
    ServerClosed,
)

__all__ = [
    "ContinuousBatcher",
    "ResilientBatcher",
    "DrainStalled",
    "ServerClosed",
    "Backpressure",
    "verify_row",
    "Fault",
    "FaultPlan",
    "FaultyBackend",
    "FaultyDistCache",
    "InjectedFault",
    "VirtualClock",
    "EngineBackend",
    "StaticBackend",
    "PortfolioBackend",
    "ShardedBackend",
    "EngineCandidate",
    "DEFAULT_CANDIDATES",
    "graph_family",
    "family_fallbacks",
    "measure_portfolio",
    "pick_engine",
    "PointBackend",
    "PointResult",
    "run_point_to_point",
    "transpose_memo",
    "ArrivalQueue",
    "Request",
    "DistCache",
    "graph_key",
    "ServingMetrics",
]
