"""Serving metrics: throughput, latency percentiles, lane occupancy
(counterpart of ``repro.serving.metrics``; the report's keys and the
registry's ``serving.*`` names are the reference's).

One :class:`ServingMetrics` instance rides along with a
:class:`~repro_torch.serving.scheduler.ContinuousBatcher`. Two event streams feed
it: per-request completions (latency, queue wait, phases, cache hits) and
per-step occupancy samples (how many of the B lanes held a query while the
engine advanced). ``report()`` distils both into a flat JSON-serialisable
dict — the artifact the benchmarks persist and dashboards would scrape.

Exactness discipline: every *aggregate* the
report exposes — counts, rates, means, maxima — is maintained exactly for
the lifetime of the instance; the bounded deques exist **only** to serve
percentiles, and anything computed from them says so in its name. A
windowed deque that wraps forgets the true max, and a rate whose
denominator mixes populations (cache hits vs coalesced followers vs
engine-served queries) reports a number that answers no question.

Pass ``registry=`` (a :class:`repro_torch.obs.MetricsRegistry`) to additionally
stream every event into the shared observability registry
(``serving.latency_s`` histograms, ``serving.completed`` counters, ...) so
a live dashboard and the end-of-run report read the same data.
"""
from __future__ import annotations

import json
from collections import deque

import numpy as np

from repro_torch.serving.queue import Request


def _pct(xs, q) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.fromiter(xs, dtype=np.float64), q))


class ServingMetrics:
    """Aggregates completion and occupancy events into a serving report."""

    def __init__(self, lanes: int, window: int = 65536, registry=None):
        self.lanes = int(lanes)
        self.completed = 0
        self.cache_hits = 0
        self.coalesced = 0
        self.engine_served = 0  # completions that ran on an engine lane
        self.total_phases = 0  # engine phases attributed to completed queries
        # failure/degradation stream (DESIGN.md Sec. 14) — all exact
        # lifetime counts, disjoint from the completion aggregates above so
        # a shed request never pollutes a latency mean
        self.shed = 0  # dropped by overload shedding or close()
        self.deadline_expired = 0  # shed unanswered past their deadline
        self.deadline_misses = 0  # expired-shed + answered-late
        self.failed = 0  # retry budget exhausted under persistent faults
        self.rejected = 0  # submit() refused at max_pending (no Request)
        self.retries = 0  # re-solves scheduled (quarantine/engine recovery)
        self.quarantines = 0  # harvested rows the verifier rejected
        self.engine_failures = 0  # engine step exceptions recovered from
        self.stale_served = 0  # completions served from an over-TTL row
        self.downgraded = 0  # point queries widened to full solves
        self.steps = 0
        self.engine_trips = 0  # loop trips actually executed across steps
        self._busy_lane_trips = 0
        self._lane_trips = 0
        # exact lifetime aggregates: a wrapped window must never change
        # what the report calls a mean or a max
        self._phases_max = 0
        self._latency_sum = 0.0
        self._latency_max = 0.0
        self._queue_wait_sum = 0.0
        self._queue_wait_max = 0.0
        # percentile windows are bounded so a long-lived server cannot grow
        # host memory per request; they serve ONLY the _p50/_p99 keys
        self._latencies: deque[float] = deque(maxlen=window)
        self._queue_waits: deque[float] = deque(maxlen=window)
        self._phases: deque[int] = deque(maxlen=window)  # engine-served only
        self._t_first_arrival: float | None = None
        self._t_last_completion: float | None = None
        self._registry = registry
        if registry is not None:
            self._h_latency = registry.histogram(
                "serving.latency_s", "request latency, arrival to completion"
            )
            self._h_wait = registry.histogram(
                "serving.queue_wait_s", "queue wait before a lane was assigned"
            )
            self._h_phases = registry.histogram(
                "serving.phases_per_query", "engine phases per served query"
            )
            self._c_done = registry.counter(
                "serving.completed", "requests completed (all paths)"
            )
            self._c_hits = registry.counter(
                "serving.cache_hits", "requests answered from the result cache"
            )
            self._c_coal = registry.counter(
                "serving.coalesced", "requests coalesced onto an in-flight query"
            )
            self._c_trips = registry.counter(
                "serving.engine_trips", "engine loop trips executed"
            )
            self._g_busy = registry.gauge(
                "serving.busy_lanes", "lanes holding a live query at last step"
            )
            self._c_shed = registry.counter(
                "serving.shed", "requests dropped by shedding or close()"
            )
            self._c_deadline = registry.counter(
                "serving.deadline_misses",
                "requests not answered by their deadline (shed or late)"
            )
            self._c_failed = registry.counter(
                "serving.failed", "requests whose retry budget ran out"
            )
            self._c_rejected = registry.counter(
                "serving.rejected", "submissions refused at max_pending"
            )
            self._c_retries = registry.counter(
                "serving.retries", "re-solves scheduled by the recovery path"
            )
            self._c_quar = registry.counter(
                "serving.quarantines", "harvested rows the verifier rejected"
            )
            self._c_engine_fail = registry.counter(
                "serving.engine_failures", "engine step exceptions recovered"
            )

    def record_completion(self, req: Request) -> None:
        self.completed += 1
        if req.served_stale:
            self.stale_served += 1
        if req.deadline is not None and req.t_completed is not None \
                and req.t_completed > req.deadline:
            # answered, but late: the client still sees a deadline miss
            self.deadline_misses += 1
            if self._registry is not None:
                self._c_deadline.inc()
        if req.cache_hit:
            self.cache_hits += 1
        elif req.coalesced:
            self.coalesced += 1
        else:
            self.engine_served += 1
            phases = int(req.phases or 0)
            self._phases.append(phases)
            self.total_phases += phases
            self._phases_max = max(self._phases_max, phases)
            if self._registry is not None:
                self._h_phases.observe(phases)
        self._latencies.append(req.latency)
        self._latency_sum += req.latency
        self._latency_max = max(self._latency_max, req.latency)
        self._queue_waits.append(req.queue_wait)
        self._queue_wait_sum += req.queue_wait
        self._queue_wait_max = max(self._queue_wait_max, req.queue_wait)
        if self._t_first_arrival is None or req.t_arrival < self._t_first_arrival:
            self._t_first_arrival = req.t_arrival
        if self._t_last_completion is None or req.t_completed > self._t_last_completion:
            self._t_last_completion = req.t_completed
        if self._registry is not None:
            self._c_done.inc()
            if req.cache_hit:
                self._c_hits.inc()
            elif req.coalesced:
                self._c_coal.inc()
            self._h_latency.observe(req.latency)
            self._h_wait.observe(req.queue_wait)

    def record_step(self, busy_lanes: int, trips_advanced: int) -> None:
        # occupancy is trip-weighted: a 1-trip chunk (early lane finish) must
        # not count as much utilisation evidence as a 100-trip ride
        self.steps += 1
        self.engine_trips += int(trips_advanced)
        self._busy_lane_trips += int(busy_lanes) * int(trips_advanced)
        self._lane_trips += self.lanes * int(trips_advanced)
        if self._registry is not None:
            self._c_trips.inc(int(trips_advanced))
            self._g_busy.set(int(busy_lanes))

    def record_failure(self, req: Request, outcome: str) -> None:
        """One request retired without an answer. Deliberately touches none
        of the completion aggregates: ``completed``/latency stats answer
        "how fast were the answers", failures answer "what never got one"."""
        if outcome == "deadline":
            self.deadline_expired += 1
            self.deadline_misses += 1
            if self._registry is not None:
                self._c_deadline.inc()
        elif outcome == "failed":
            self.failed += 1
            if self._registry is not None:
                self._c_failed.inc()
        else:  # "shed"
            self.shed += 1
            if self._registry is not None:
                self._c_shed.inc()

    def record_rejection(self) -> None:
        """submit() refused at max_pending (no Request object exists)."""
        self.rejected += 1
        if self._registry is not None:
            self._c_rejected.inc()

    def record_retry(self, req: Request) -> None:
        self.retries += 1
        if self._registry is not None:
            self._c_retries.inc()

    def record_quarantine(self, req: Request) -> None:
        self.quarantines += 1
        if self._registry is not None:
            self._c_quar.inc()

    def record_engine_failure(self) -> None:
        self.engine_failures += 1
        if self._registry is not None:
            self._c_engine_fail.inc()

    def record_downgrade(self, req: Request) -> None:
        self.downgraded += 1

    @property
    def wall_span(self) -> float:
        """First arrival to last completion, in clock units."""
        if self._t_first_arrival is None or self._t_last_completion is None:
            return 0.0
        return self._t_last_completion - self._t_first_arrival

    def report(self) -> dict:
        """Flat JSON-serialisable summary of the serving run so far.

        Rates partition cleanly: ``cache_hit_rate`` is cache hits over the
        requests that *could* have hit the cache (hits + engine-served —
        a coalesced follower never consulted it, it attached to a query
        already in flight), and ``coalesce_rate`` is followers over all
        completions. Means and maxima are exact over the full lifetime;
        only the ``_p50``/``_p99`` keys read the bounded windows.
        """
        span = self.wall_span
        occ = self._busy_lane_trips / self._lane_trips if self._lane_trips else 0.0
        cacheable = self.cache_hits + self.engine_served
        return {
            "lanes": self.lanes,
            "queries_completed": self.completed,
            "cache_hits": self.cache_hits,
            "coalesced": self.coalesced,
            "engine_served": self.engine_served,
            "cache_hit_rate": (self.cache_hits / cacheable
                               if cacheable else 0.0),
            "coalesce_rate": (self.coalesced / self.completed
                              if self.completed else 0.0),
            "throughput_qps": self.completed / span if span > 0 else 0.0,
            "latency_p50_s": _pct(self._latencies, 50),
            "latency_p99_s": _pct(self._latencies, 99),
            "latency_mean_s": (self._latency_sum / self.completed
                               if self.completed else 0.0),
            "latency_max_s": self._latency_max,
            "queue_wait_p50_s": _pct(self._queue_waits, 50),
            "queue_wait_p99_s": _pct(self._queue_waits, 99),
            "queue_wait_mean_s": (self._queue_wait_sum / self.completed
                                  if self.completed else 0.0),
            "queue_wait_max_s": self._queue_wait_max,
            "phases_per_query_mean": (self.total_phases / self.engine_served
                                      if self.engine_served else 0.0),
            "phases_per_query_max": self._phases_max,
            "lane_occupancy": occ,
            "steps": self.steps,
            "engine_trips": self.engine_trips,
            "wall_span_s": span,
            # failure/degradation stream (all exact lifetime counts)
            "shed": self.shed,
            "deadline_expired": self.deadline_expired,
            "deadline_misses": self.deadline_misses,
            "failed": self.failed,
            "rejected": self.rejected,
            "retries": self.retries,
            "quarantines": self.quarantines,
            "engine_failures": self.engine_failures,
            "stale_served": self.stale_served,
            "downgraded": self.downgraded,
        }

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.report(), **dump_kw)
