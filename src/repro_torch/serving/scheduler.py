"""Continuous batching over a resumable phase-stepper engine (counterpart of
``repro.serving.scheduler``; the same admission, coalescing, cache and
metrics semantics, so the same trace gives the same completions, lanes,
rows and report).

:class:`ContinuousBatcher` holds B fixed lanes of SSSP state behind an
:class:`~repro_torch.serving.backends.EngineBackend` adapter (the
single-device stepper, :class:`~repro_torch.serving.backends.StaticBackend`,
by default) and interleaves three moves per ``step()``:

  1. **admit** — pop queued requests into free lanes (one
     :func:`reset_lanes` call rewrites every admitted lane's state slice;
     in-flight lanes pass through bitwise). Requests whose answer is
     already in the :class:`DistCache` complete immediately without
     occupying a lane.
  2. **advance** — one ``step_batch`` call runs up to ``phases_per_step``
     phases over all B lanes (each kernel call serves the whole batch,
     finished/empty lanes ride along as fixed points). The
     chunk ends early the moment any live lane terminates
     (``stop_on_lane_finish``), so finished work never idles in a lane.
  3. **harvest** — lanes whose fringe emptied are read out, their requests
     completed (and inserted into the cache), and the lanes freed for the
     next admission round.

Compared to the static batch front-end (``run_phased_static_batch``), which
holds every lane until the *slowest* row of the batch terminates, a finished
lane here is refilled with zero idle trips. Correctness is
per-lane structural: each phase applies identical
float ops to each row regardless of the other rows, and a reset lane is
bitwise a fresh B=1 solve, so every admitted query's distances are bit-exact
vs ``run_phased_static`` no matter how arrivals and lane assignments
interleave (``tests/test_torch_serving.py`` holds it against the
reference's batcher).

Admission hardening (DESIGN.md Sec. 14) rides on the same loop, all of it
off by default so an unconfigured server behaves byte-identically to the
pre-hardening one:

  * per-request **priorities** (higher wins a lane first; FIFO within a
    priority class) and absolute **deadlines** (a request that expires
    while queued is shed with outcome ``"deadline"`` instead of burning
    engine time on an answer nobody is waiting for);
  * **bounded backlog** (``max_pending``): an arrival past the bound either
    displaces a strictly lower-priority queued request (which is shed) or
    is rejected with :class:`Backpressure` — the queue can't grow without
    bound under overload;
  * **staleness ladder** (``cache_max_age``): cached rows older than the
    TTL count as misses, unless the request set ``stale_ok`` — the
    degraded-mode contract "a slightly old answer now beats a fresh one
    too late";
  * **point-query downgrade** (``point_downgrade_backlog``): under backlog
    pressure an s->t query is widened to a full solve so it can coalesce,
    be coalesced onto, and leave a cacheable row behind;
  * **shutdown discipline**: :meth:`close` sheds all pending work exactly
    once; ``submit``/``step``/``drain`` afterwards raise
    :class:`ServerClosed`, and every request retires through one funnel
    that raises on a duplicate harvest.

Every completion and failure flows through :meth:`_finish` / :meth:`_fail`;
the engine advance and the harvest acceptance are the two protected hooks
(:meth:`_advance_and_peek`, :meth:`_accept_row`) a fault-tolerant subclass
overrides to add verified recovery without duplicating the scheduling loop
(the reference's ``ResilientBatcher``, ROADMAP Queue 1 item 8, part 2).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.policies import canonical_spec
from repro_torch.core.static_engine import EMPTY_LANE, KEEP_LANE
from repro_torch.obs import NULL_TRACER, Observability, timer
from repro_torch.serving.backends import EngineBackend, StaticBackend
from repro_torch.serving.cache import DistCache, graph_key
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import ArrivalQueue, Request


class DrainStalled(RuntimeError):
    """drain() exceeded its step bound; ``.completed`` holds the finished
    requests so a tripped safety bound does not destroy delivered work."""

    def __init__(self, message: str, completed: list[Request]):
        super().__init__(message)
        self.completed = completed


class ServerClosed(RuntimeError):
    """submit()/step()/drain() called on a server after close()."""


class Backpressure(RuntimeError):
    """submit() rejected: the pending backlog is at ``max_pending`` and the
    arrival outranks nothing it could displace."""


class ContinuousBatcher:
    """B-lane continuous-batching SSSP server over one shared graph.

    Args:
      g: the graph every query runs against (ELL built once, memoised).
      lanes: number of concurrent query slots B. The engine state costs
        ~8·B·n bytes of device memory (dist + status).
      phases_per_step: phase-chunk length k between admission/harvest
        points. Chunks already end early on any lane finish, so k only
        bounds how long a *newly arrived* query can wait while all lanes
        are still live; large k amortises the per-step host sync.
      ell: optional precomputed ``to_ell_in(g)`` (default backend only).
      use_kernels: the CUDA kernels (True) vs their plain twins (False);
        bit-identical. (Default backend only; it runs on the graph's
        device.)
      cache: optional :class:`DistCache`; duplicate sources short-circuit
        (completed ones from the cache, in-flight ones by coalescing onto
        the lane already solving that source).
      clock: timestamp source (injectable for simulated-time replay).
      retain_completed: how many completed requests ``self.completed`` keeps
        for inspection; older ones are dropped. Each retained request holds
        its full (n,) f32 dist row, so host memory spends 4·n bytes per
        slot — size it to the graph (or pass 0) on large-n servers. The
        authoritative delivery path is the return value of ``step()`` /
        ``drain()``. ``None`` retains everything.
      backend: the :class:`~repro_torch.serving.backends.EngineBackend`
        that solves the queries — default a :class:`StaticBackend` over
        ``g`` (pass one built with ``layout="sliced"`` to serve on the
        degree-sliced views). All scheduling semantics (admission,
        coalescing, cache, metrics) are backend-independent.
      criterion: the settle criterion the engine solves with (any
        non-oracle string ``run_phased`` accepts). With a default backend it
        is plumbed into the :class:`StaticBackend`; with an explicit backend
        it must agree with the backend's own criterion (pass one or the
        other). Part of the cache key: servers over the same graph but
        different criteria never share cached rows, even though their
        answers coincide in exact arithmetic.
      donate: passed to the backend's ``step`` / ``reset_lanes``, where it
        changes nothing: the port's stepper never aliases the state it is
        given. Kept on the seam so the scheduler's calls are the
        reference's.
      point_queries: enable s->t point queries (``submit(..., target=t)``).
        With a default backend this builds the :class:`StaticBackend` with
        target-capable lane state; with an explicit backend it must already
        be point-capable. Point lanes early-exit the moment their target
        settles and prune relaxations past the target's tentative distance,
        so only ``dist[target]`` is guaranteed on the
        completed row — point results are therefore never inserted into the
        cache, while cached *full* rows for the same source serve point
        queries as zero-phase hits. Off by default: a target-free server
        runs the exact pre-target engine program.
      obs: optional :class:`repro_torch.obs.Observability` bundle. When given,
        serving metrics additionally stream into its registry
        (``serving.*`` counters/gauges/histograms) and its tracer records
        the serving timeline: one thread row per lane carrying each
        query's occupancy span (B/E), per-round ``step`` spans, admission
        instants, and queue-depth/busy-lane counter tracks — export with
        ``obs.tracer.export(path)`` and open in Perfetto. Default None:
        no tracer, no registry traffic, byte-identical scheduling.
      max_pending: bound on the pending backlog (queued + ready). ``None``
        (default) keeps the unbounded pre-hardening behaviour.
      cache_max_age: TTL for served cache rows, in clock units. ``None``
        (default): rows never age out. With a TTL, an over-age row counts
        as a miss (and is re-solved) unless the request set ``stale_ok``.
      point_downgrade_backlog: engine-bound backlog depth at which point
        queries are widened to full solves (``None`` = never downgrade).
    """

    def __init__(
        self,
        g: Graph,
        lanes: int = 8,
        phases_per_step: int = 32,
        ell=None,
        use_kernels: bool = True,
        cache: DistCache | None = None,
        clock=timer.now,
        retain_completed: int | None = 1024,
        backend: EngineBackend | None = None,
        donate: bool = False,
        criterion: str | None = None,
        obs: Observability | None = None,
        point_queries: bool = False,
        max_pending: int | None = None,
        cache_max_age: float | None = None,
        point_downgrade_backlog: int | None = None,
    ):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1; got {lanes}")
        if phases_per_step < 1:
            raise ValueError(f"phases_per_step must be >= 1; got {phases_per_step}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1; got {max_pending}")
        if backend is None:
            kw = {} if criterion is None else {"criterion": criterion}
            backend = StaticBackend(g, ell=ell, use_kernels=use_kernels,
                                    point_queries=point_queries,
                                    device=g.device, **kw)
        elif point_queries and not getattr(backend, "point_queries", False):
            raise ValueError(
                "point_queries=True needs a point-capable backend; build it "
                "with point_queries=True (StaticBackend/PortfolioBackend)"
            )
        elif backend.g is not g:
            raise ValueError(
                "backend was built over a different Graph instance than `g`"
            )
        elif criterion is not None:
            if canonical_spec(criterion) != backend.criterion:
                raise ValueError(
                    f"criterion {criterion!r} disagrees with the backend's "
                    f"{backend.criterion!r}; configure the backend instead"
                )
        self.g = g
        self.backend = backend
        self.criterion = backend.criterion
        self.point_queries = bool(getattr(backend, "point_queries", False))
        self.lanes = int(lanes)
        self.phases_per_step = int(phases_per_step)
        self.cache = cache
        self._gkey = graph_key(g) if cache is not None else None
        self.clock = clock
        self.queue = ArrivalQueue()
        self.obs = obs
        self._tracer = NULL_TRACER if obs is None else obs.tracer
        self.metrics = ServingMetrics(
            lanes, registry=None if obs is None else obs.registry
        )
        self._g_queue = (
            None if obs is None
            else obs.registry.gauge("serving.queue_depth",
                                    "engine-bound requests waiting for a lane")
        )
        self.max_pending = None if max_pending is None else int(max_pending)
        self.cache_max_age = (
            None if cache_max_age is None else float(cache_max_age)
        )
        self.point_downgrade_backlog = (
            None if point_downgrade_backlog is None
            else int(point_downgrade_backlog)
        )
        self.state = backend.init(self.lanes)
        self._donate = bool(donate)
        # host trip counter: a python int accumulated from wrap-safe int32
        # diffs of state.trips (the device counter, int32 as in the
        # reference, may wrap after 2^31 trips of a long-lived server; chunk
        # deltas survive the wrap)
        self._trips = 0
        self._trips_dev = 0  # last observed raw int32 value of state.trips
        self._lane_req: list[Request | None] = [None] * self.lanes
        self._lane_disabled: list[bool] = [False] * self.lanes
        self._inflight: dict[int, int] = {}  # source -> lane solving it
        self._followers: dict[int, list[Request]] = {}  # lane -> coalesced reqs
        # engine-bound backlog: arrivals are classified exactly once (cache /
        # coalesce / engine) and engine-bound ones queue here FIFO, indexed
        # by source so later events touch only the affected requests instead
        # of rescanning the backlog (admission coalesces queued duplicates;
        # dead entries are skipped lazily on pop)
        self._ready: deque[Request] = deque()
        self._ready_live = 0
        self._by_source: dict[int, list[Request]] = {}
        self._closed = False
        self.completed: deque[Request] = deque(maxlen=retain_completed)

    # -- submission ---------------------------------------------------------

    def submit(self, source: int, t_arrival: float | None = None,
               target: int | None = None, *, priority: int = 0,
               deadline: float | None = None, stale_ok: bool = False,
               max_retries: int | None = None) -> Request:
        """Enqueue one query; returns its tracking :class:`Request`.

        ``target`` turns it into an s->t point query: the serving lane
        early-exits once ``target`` settles and only ``dist[target]`` (the
        :attr:`Request.distance` property) is guaranteed on the completed
        row. Requires a point-capable server (``point_queries=True``).

        ``priority``/``deadline``/``stale_ok``/``max_retries`` feed the
        admission policy (class docstring); on a server with
        ``max_pending`` set, an arrival into a full backlog either sheds a
        strictly lower-priority queued request or raises
        :class:`Backpressure`.
        """
        if self._closed:
            raise ServerClosed("submit() on a closed server")
        source = int(source)
        if not 0 <= source < self.backend.n:
            raise ValueError(
                f"source must be in [0, {self.backend.n}); got {source}"
            )
        if target is not None:
            if not self.point_queries:
                raise ValueError(
                    "this server was built without point_queries=True; "
                    "s->t targets need target-capable lane state"
                )
            target = int(target)
            if not 0 <= target < self.backend.n:
                raise ValueError(
                    f"target must be in [0, {self.backend.n}); got {target}"
                )
        t = self.clock() if t_arrival is None else float(t_arrival)
        if self.max_pending is not None and self.pending >= self.max_pending:
            victim = self._shed_candidate(int(priority))
            if victim is None:
                self.metrics.record_rejection()
                self._tracer.instant("backpressure reject", cat="request",
                                     tid="scheduler")
                raise Backpressure(
                    f"{self.pending} requests pending >= max_pending="
                    f"{self.max_pending} and no queued request ranks below "
                    f"priority {priority}"
                )
            self._evict_pending(victim)
            self._fail(victim, "shed", t,
                       "displaced by a higher-priority arrival at max_pending")
        return self.queue.push(source, t, target=target, priority=priority,
                               deadline=deadline, stale_ok=stale_ok,
                               max_retries=max_retries)

    def _shed_candidate(self, priority: int) -> Request | None:
        """The request overload shedding would drop for a ``priority``
        arrival: the newest of the lowest priority class, and only if it
        ranks strictly below the arrival (equal priority is FIFO — the
        incumbent wins)."""
        worst: Request | None = None
        for r in self.queue:
            if r.outcome is None and (worst is None or
                                      (r.priority, -r.req_id) <
                                      (worst.priority, -worst.req_id)):
                worst = r
        for r in self._ready:
            if r.coalesced or r.outcome is not None:
                continue
            if worst is None or (r.priority, -r.req_id) < \
                    (worst.priority, -worst.req_id):
                worst = r
        if worst is None or worst.priority >= priority:
            return None
        return worst

    def _evict_pending(self, req: Request) -> None:
        """Remove a not-yet-admitted request from whichever backlog holds
        it (the caller retires it through :meth:`_fail`)."""
        try:
            self.queue.remove(req)
            return
        except ValueError:
            pass
        self._drop_ready(req)

    # -- introspection ------------------------------------------------------

    @property
    def busy_lanes(self) -> int:
        return sum(r is not None for r in self._lane_req)

    @property
    def pending(self) -> int:
        return len(self.queue) + self._ready_live

    @property
    def idle(self) -> bool:
        return self.pending == 0 and self.busy_lanes == 0

    @property
    def closed(self) -> bool:
        return self._closed

    # -- lifecycle funnels --------------------------------------------------

    def _finish(self, req: Request) -> None:
        """The single success funnel: every answered request retires here
        exactly once. A second retirement is a scheduler bug (duplicate
        harvest) and raises instead of silently double-counting."""
        if req.outcome is not None:
            raise RuntimeError(
                f"request {req.req_id} (source {req.source}) was already "
                f"retired with outcome {req.outcome!r} — duplicate harvest"
            )
        req.outcome = "ok"
        self.completed.append(req)
        self.metrics.record_completion(req)

    def _fail(self, req: Request, outcome: str, now: float,
              reason: str = "") -> None:
        """The single failure funnel (shed / deadline / retry-exhausted)."""
        if req.outcome is not None:
            raise RuntimeError(
                f"request {req.req_id} (source {req.source}) was already "
                f"retired with outcome {req.outcome!r} — duplicate retirement"
            )
        req.outcome = outcome
        req.fail_reason = reason or None
        req.t_completed = now
        self.completed.append(req)
        self.metrics.record_failure(req, outcome)
        self._tracer.instant(f"{outcome}: req {req.req_id} src {req.source}",
                             cat="request", tid="scheduler")

    def close(self) -> list[Request]:
        """Retire the server. All queued and in-flight requests are shed
        (outcome ``"shed"``) exactly once; afterwards ``submit``/``step``/
        ``drain`` raise :class:`ServerClosed`. Returns the shed requests.
        Idempotent: a second close is a no-op returning ``[]``."""
        if self._closed:
            return []
        self._closed = True
        now = self.clock()
        dropped: list[Request] = []

        def shed(r: Request) -> None:
            if r is not None and r.outcome is None:
                self._fail(r, "shed", now, "server closed")
                dropped.append(r)

        while self.queue:
            shed(self.queue.pop())
        for r in list(self._ready):
            if not r.coalesced:
                shed(r)
        self._ready.clear()
        self._ready_live = 0
        self._by_source.clear()
        for lane in range(self.lanes):
            r = self._lane_req[lane]
            if r is not None:  # close the request span the lane opened
                self._tracer.end(f"src {r.source}", cat="request",
                                 tid=f"lane {lane}", shed=True)
            shed(r)
            self._lane_req[lane] = None
            for f in self._followers.pop(lane, ()):
                shed(f)
        self._inflight.clear()
        self._followers.clear()
        return dropped

    # -- the serving loop ---------------------------------------------------

    def _should_downgrade(self, req: Request) -> bool:
        """Whether to widen a point query into a cacheable full solve.
        Base policy: only under configured backlog pressure. The resilient
        subclass also downgrades to keep every served row verifiable."""
        return (self.point_downgrade_backlog is not None
                and self._ready_live + len(self.queue)
                >= self.point_downgrade_backlog)

    def _drop_ready(self, req: Request) -> None:
        """Remove one live entry from the engine-bound backlog + its
        source index (``ValueError`` if absent — callers pass members)."""
        self._ready.remove(req)
        self._ready_live -= 1
        peers = self._by_source.get(req.source)
        if peers is not None:
            peers.remove(req)
            if not peers:
                del self._by_source[req.source]

    def _next_engine_bound(self, now: float,
                           resolved: list[Request]) -> Request | None:
        """Admission winner from the backlog: shed expired-deadline entries
        (into ``resolved``), then pick max (priority, FIFO). With no
        priorities or deadlines in play this is exactly the old FIFO pop."""
        expired: list[Request] = []
        best: Request | None = None
        for r in self._ready:
            if r.coalesced or r.outcome is not None:
                continue
            if r.deadline is not None and now > r.deadline:
                expired.append(r)
                continue
            if best is None or (r.priority, -r.req_id) > \
                    (best.priority, -best.req_id):
                best = r
        for r in expired:
            self._drop_ready(r)
            self._fail(r, "deadline", now,
                       "deadline expired before a lane freed")
            resolved.append(r)
        if best is not None:
            self._drop_ready(best)
        return best

    def _admit(self) -> list[Request]:
        """Classify new arrivals, then fill free lanes from the backlog.

        Lane-free requests — cache hits and duplicates coalescible onto an
        in-flight lane — are served at classification no matter how many
        lanes are busy: they consume no contended resource, so overtaking an
        engine-bound request costs it nothing. Each arrival is classified
        exactly once; engine-bound requests stay strictly FIFO among
        themselves (within a priority class). With the cache enabled, an
        engine-bound queued source is by construction neither cached nor in
        flight (admission coalesces the queued duplicates of the source it
        admits), so no event ever requires rescanning the backlog.
        """
        resolved: list[Request] = []
        now = self.clock()
        admit_vec: np.ndarray | None = None  # lane -> new source, KEEP elsewhere
        tgt_vec: np.ndarray | None = None  # lane -> s->t target, EMPTY for full
        while self.queue:
            req = self.queue.pop()
            if req.outcome is not None:
                continue  # already retired while queued (shed)
            if req.deadline is not None and now > req.deadline:
                self._fail(req, "deadline", now,
                           "deadline expired before classification")
                resolved.append(req)
                continue
            if req.target is not None and not req.downgraded \
                    and self._should_downgrade(req):
                req.downgraded = True
                self.metrics.record_downgrade(req)
            # each arrival is classified exactly once, so this is the one
            # cache lookup of its lifetime — get() owns all hit/miss stats.
            # The key carries no target: a cached FULL row for this source
            # answers s->t queries too (req.distance indexes dist[target]),
            # so point traffic against a warmed source is zero engine phases
            hit = None
            if self.cache is not None:
                max_age = (None if self.cache_max_age is None or req.stale_ok
                           else self.cache_max_age)
                hit = self.cache.get(self._gkey, self.criterion, req.source,
                                     now=now, max_age=max_age)
                if (hit is not None and req.stale_ok
                        and self.cache_max_age is not None):
                    age = self.cache.age(self._gkey, self.criterion,
                                         req.source, now)
                    if age is not None and age > self.cache_max_age:
                        req.served_stale = True
            if hit is not None:
                req.cache_hit = True
                req.t_admitted = now
                req.t_completed = now
                req.phases = 0
                req.dist = hit
                self._finish(req)
                resolved.append(req)
                self._tracer.instant(f"cache hit src {req.source}",
                                     cat="request", tid="scheduler")
                continue
            if self.cache is not None and req.source in self._inflight:
                # a lane is already solving this source IN FULL (point lanes
                # never enter _inflight): ride along instead of burning a
                # second lane — the full row answers point followers too
                req.coalesced = True
                req.t_admitted = now
                self._followers.setdefault(self._inflight[req.source], []).append(req)
                continue
            self._ready.append(req)
            self._by_source.setdefault(req.source, []).append(req)
            self._ready_live += 1
        for lane in range(self.lanes):
            if self._lane_req[lane] is not None or self._lane_disabled[lane]:
                continue
            if not self._ready_live:
                break
            req = self._next_engine_bound(now, resolved)
            if req is None:
                break
            req.t_admitted = now
            req.lane = lane
            self._lane_req[lane] = req
            if self._tracer.enabled:
                tid = f"lane {lane}"
                self._tracer.name_thread(tid, f"serving lane {lane}")
                self._tracer.begin(f"src {req.source}", cat="request",
                                   tid=tid, source=req.source)
            if self.cache is not None and req.effective_target is None:
                # _inflight backs coalescing, which needs the cache's
                # source-per-lane uniqueness invariant — without a cache
                # duplicate sources may legally occupy several lanes and
                # the map would be wrong, so don't maintain it at all.
                # Point lanes never register either: their rows are
                # partial (only dist[target] is guaranteed past the
                # pruning bound), so nothing may ride along on them
                self._inflight[req.source] = lane
                # queued duplicates of this source ride along on the lane
                for dup in self._by_source.pop(req.source, ()):
                    dup.coalesced = True
                    dup.t_admitted = now
                    self._ready_live -= 1
                    self._followers.setdefault(lane, []).append(dup)
            if admit_vec is None:
                admit_vec = np.full(self.lanes, KEEP_LANE, np.int32)
                if self.point_queries:
                    tgt_vec = np.full(self.lanes, EMPTY_LANE, np.int32)
            admit_vec[lane] = req.source
            if tgt_vec is not None and req.effective_target is not None:
                tgt_vec[lane] = req.effective_target
        if admit_vec is not None:
            # one device call resets every admitted lane's (n,) slice,
            # however large the burst; untouched lanes pass through bitwise.
            # The targets kwarg is only passed on point-capable servers so
            # plain backends keep their exact pre-target call signature
            kw = {} if tgt_vec is None else {"targets": tgt_vec}
            self.state = self.backend.reset_lanes(
                self.state, admit_vec, donate=self._donate, **kw
            )
        if not self._ready_live and self._ready:
            # only lazily-skipped dead entries (already-coalesced requests)
            # remain — drop them so they don't outlive the retention bound
            self._ready.clear()
        return resolved

    def _advance_and_peek(self):
        """One engine chunk + host sync. The resilient subclass wraps this
        in recovery; returning ``None`` tells ``step()`` the round was
        aborted (state rebuilt, in-flight work re-queued)."""
        self.state = self.backend.step(
            self.state, self.phases_per_step, stop_on_lane_finish=True,
            donate=self._donate,
        )
        return self.backend.peek(self.state)  # host sync

    def _accept_row(self, req: Request, lane: int, row: np.ndarray,
                    now: float) -> bool:
        """Harvest-acceptance hook. True delivers the row. A False return
        means the override rejected it AND already took ownership of the
        lane bookkeeping (freed the lane, re-queued or failed the request
        and its followers)."""
        return True

    def step(self) -> list[Request]:
        """One scheduling round: admit, advance <= k phases, harvest.

        Returns the requests *retired* during this round — completions
        (cache hits and finished lanes, each carrying its ``dist`` row)
        plus any shed on expiry (``outcome != "ok"``, no row).
        """
        if self._closed:
            raise ServerClosed("step() on a closed server")
        done = self._admit()
        busy = self.busy_lanes
        if self._tracer.enabled:
            self._tracer.counter("scheduler load", {
                "queue_depth": self.pending, "busy_lanes": busy,
            })
        if self._g_queue is not None:
            self._g_queue.set(self.pending)
        if not busy:
            # cache-hit-only round (or empty server): no live lanes means
            # the engine would execute zero trips — skip the dispatch and
            # the blocking device sync entirely
            self.metrics.record_step(0, 0)
            return done
        trips_before = self._trips
        with self._tracer.span("step", cat="step", tid="scheduler", busy=busy):
            peeked = self._advance_and_peek()
        if peeked is None:
            # recovery hook rebuilt the engine: nothing advanced this round
            self.metrics.record_step(busy, 0)
            return done
        trips, active, phases = peeked
        self._trips += (trips - self._trips_dev) % (1 << 32)  # wrap-safe
        self._trips_dev = trips
        finished = [
            lane for lane in range(self.lanes)
            if self._lane_req[lane] is not None and not active[lane]
        ]
        if finished:
            now = self.clock()
            for lane in finished:
                req = self._lane_req[lane]
                row = self.backend.take_row(self.state, lane)
                if row.flags.writeable:  # shared with followers/retention:
                    row.flags.writeable = False  # mutation must fail loudly
                if not self._accept_row(req, lane, row, now):
                    continue  # quarantined: the hook owns the bookkeeping
                req.t_completed = now
                req.phases = int(phases[lane])
                req.dist = row
                if self.cache is not None and req.effective_target is None:
                    # point rows never enter the cache: past the pruning
                    # bound they are partial, and the cache contract is
                    # "full solve for this source". (_inflight holds no
                    # entry for point lanes either — popping here keyed on
                    # source would evict a concurrent full solve's entry.)
                    self.cache.put(self._gkey, self.criterion, req.source,
                                   req.dist, now=now)
                    self._inflight.pop(req.source, None)
                self._lane_req[lane] = None
                self._finish(req)
                done.append(req)
                self._tracer.end(f"src {req.source}", cat="request",
                                 tid=f"lane {lane}", phases=int(phases[lane]))
                for f in self._followers.pop(lane, ()):
                    f.t_completed = now
                    f.phases = 0
                    f.dist = req.dist
                    self._finish(f)
                    done.append(f)
        self.metrics.record_step(busy, self._trips - trips_before)
        return done

    def drain(self, max_steps: int | None = None) -> list[Request]:
        """Step until queue and lanes are empty; returns the completions.

        ``max_steps`` bounds the loop (label-setting guarantees each live
        lane terminates within n phases, so the bound only trips on misuse);
        a tripped bound raises :class:`DrainStalled` carrying the
        completions gathered so far.
        """
        if self._closed:
            raise ServerClosed("drain() on a closed server")
        out: list[Request] = []
        steps = 0
        while not self.idle:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise DrainStalled(
                    f"drain() exceeded max_steps={max_steps} with "
                    f"{self.pending} queued / {self.busy_lanes} busy lanes",
                    out,
                )
        return out
