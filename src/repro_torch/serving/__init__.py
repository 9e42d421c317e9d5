"""Serving layer of the port (counterpart of ``repro.serving``): the
continuous batcher over the engine backend seam, its arrival queue, result
cache and metrics, and point-to-point (s->t) queries.

A :class:`ContinuousBatcher` keeps B engine lanes busy by refilling
finished rows from an :class:`ArrivalQueue`; duplicate queries short-cut
through a :class:`DistCache` (or coalesce onto an in-flight lane), and
:class:`ServingMetrics` emits the throughput and latency report. Every
admitted query's distances are bit-exact against a standalone solve. The
portfolio, sharded and fault-tolerant tiers wait for ROADMAP Queue 1
items 8 (part 2) and 11.
"""
from repro_torch.serving.backends import EngineBackend, StaticBackend
from repro_torch.serving.cache import DistCache, graph_key
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.point import (
    PointBackend,
    PointResult,
    run_point_to_point,
    transpose_memo,
)
from repro_torch.serving.queue import ArrivalQueue, Request
from repro_torch.serving.scheduler import (
    Backpressure,
    ContinuousBatcher,
    DrainStalled,
    ServerClosed,
)

__all__ = [
    "ContinuousBatcher",
    "DrainStalled",
    "ServerClosed",
    "Backpressure",
    "EngineBackend",
    "StaticBackend",
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
