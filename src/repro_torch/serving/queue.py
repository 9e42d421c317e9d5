"""Arrival queue and per-request lifecycle bookkeeping for the SSSP server
(counterpart of ``repro.serving.queue``).

A :class:`Request` is the unit of work the serving subsystem tracks: one
source vertex against the server's graph, stamped at every lifecycle edge
(arrival -> admission into a lane -> completion). Timestamps come from the
batcher's injectable clock, so the same code serves wall-clock production
loops and simulated-time benchmarks/tests.

:class:`ArrivalQueue` is a plain FIFO — admission order is arrival order.
Admission *policy* (priorities, deadline shedding, backpressure) lives in
the scheduler, which consumes this queue; the queue itself only adds the
re-enqueue path retries need (:meth:`ArrivalQueue.requeue`) and targeted
removal for overload shedding (:meth:`ArrivalQueue.remove`).

Every request retires with exactly one ``outcome``:

  * ``"ok"`` — answered (``dist`` carries the row; possibly late, see
    :attr:`Request.deadline_missed`).
  * ``"deadline"`` — shed unanswered because its deadline expired while it
    waited for a lane.
  * ``"shed"`` — dropped by overload shedding (a higher-priority arrival
    displaced it) or by server ``close()``.
  * ``"failed"`` — its retry budget ran out under persistent faults.

``None`` means still in flight. The scheduler's completion funnel raises on
any attempt to retire a request twice.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass(eq=False)
class Request:
    """One SSSP query and its lifecycle timestamps (all in clock units).

    Identity semantics (``eq=False``): requests are tracked by object, and a
    generated ``__eq__`` would compare the (n,) ``dist`` arrays elementwise
    — ambiguous-truth errors instead of booleans.
    """

    req_id: int
    source: int
    t_arrival: float
    target: int | None = None  # s->t query: only dist[target] is guaranteed
    #   on the completed row (None = ordinary full solve)
    priority: int = 0  # higher wins a lane first; FIFO within a priority
    deadline: float | None = None  # absolute clock time the answer is due
    stale_ok: bool = False  # accept a cached row older than the server TTL
    max_retries: int | None = None  # per-request retry budget override
    t_admitted: float | None = None
    t_completed: float | None = None
    lane: int | None = None  # None for cache hits (never occupied a lane)
    phases: int | None = None  # engine phases spent on this query (0 = cache hit)
    cache_hit: bool = False
    coalesced: bool = False  # deduplicated onto an in-flight identical query
    outcome: str | None = None  # "ok" | "deadline" | "shed" | "failed"
    retries: int = 0  # re-solves consumed (quarantine / engine recovery)
    not_before: float = 0.0  # backoff gate: not admitted before this time
    downgraded: bool = False  # point query widened to a cacheable full solve
    served_stale: bool = False  # answered from a cache row past the TTL
    fail_reason: str | None = None  # detector detail for non-"ok" outcomes
    dist: np.ndarray | None = dataclasses.field(default=None, repr=False)

    @property
    def effective_target(self) -> int | None:
        """The target the *engine* solves for: a downgraded point query runs
        (and caches/coalesces) as a full solve; ``distance`` still answers
        the original s->t question from the full row."""
        return None if self.downgraded else self.target

    @property
    def distance(self) -> float | None:
        """The query's scalar answer: ``dist[target]`` for an s->t query,
        None for full solves (read ``dist``) or while incomplete."""
        if self.dist is None or self.target is None:
            return None
        return float(self.dist[self.target])

    @property
    def latency(self) -> float | None:
        """Arrival-to-completion time; None while in flight."""
        if self.t_completed is None:
            return None
        return self.t_completed - self.t_arrival

    @property
    def queue_wait(self) -> float | None:
        """Arrival-to-admission time; None while queued."""
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.t_arrival

    @property
    def deadline_missed(self) -> bool:
        """True once the request provably missed its deadline: shed
        unanswered, or answered after the deadline passed."""
        if self.deadline is None:
            return False
        if self.outcome in ("deadline", "shed", "failed"):
            return True
        return self.t_completed is not None and self.t_completed > self.deadline


class ArrivalQueue:
    """FIFO of pending requests with monotonically increasing ids."""

    def __init__(self):
        self._q: deque[Request] = deque()
        self._next_id = 0
        self.total_enqueued = 0
        self.total_requeued = 0

    def push(self, source: int, t_arrival: float,
             target: int | None = None, priority: int = 0,
             deadline: float | None = None, stale_ok: bool = False,
             max_retries: int | None = None) -> Request:
        req = Request(req_id=self._next_id, source=int(source),
                      t_arrival=float(t_arrival),
                      target=None if target is None else int(target),
                      priority=int(priority),
                      deadline=None if deadline is None else float(deadline),
                      stale_ok=bool(stale_ok),
                      max_retries=max_retries)
        self._next_id += 1
        self.total_enqueued += 1
        self._q.append(req)
        return req

    def requeue(self, req: Request) -> Request:
        """Re-enqueue an existing request (retry path): same object, same
        ``req_id`` — its identity is its history; only classification runs
        again."""
        self.total_requeued += 1
        self._q.append(req)
        return req

    def remove(self, req: Request) -> None:
        """Targeted removal (overload shedding); raises if absent."""
        self._q.remove(req)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def __iter__(self):
        return iter(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
