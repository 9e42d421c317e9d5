"""Fault-tolerant serving: verified harvest, quarantine, retry, recovery
(counterpart of ``repro.serving.resilience``; the same semantics, so one
fault script gives the same outcomes, retries, metrics and trace).

The serving scheduler trusts its engine; this module makes that trust
*checked*. :func:`verify_row` certifies a harvested distance row against
the relax-fixed-point characterisation of a finished solve, and
:class:`ResilientBatcher` extends :class:`ContinuousBatcher` with the
recovery half:

  * a row the verifier rejects is **quarantined** — never cached, never
    delivered; the lane is freed (its next admission is a bitwise-fresh
    ``reset_lanes`` re-solve) and the request re-queued with capped
    exponential backoff + deterministic jitter against a per-request retry
    budget;
  * an engine ``step`` exception is **recovered** — the lane state is
    rebuilt from ``backend.init`` and every in-flight request re-queued
    (followers keep their retry budget: their solve failed, not them);
  * a lane that keeps producing rejected rows can be **retired**
    (``quarantine_lane_after``) so a persistently bad lane stops eating
    retries;
  * with verification on, point queries are downgraded to full solves at
    admission: a pruned point row is *unverifiable* past its pruning bound,
    and "every served answer is certified" is the whole contract here. The
    engine answer is unchanged (``dist[target]`` of the full row is
    bit-exact the point answer) and the row becomes cacheable.

Why the fixed-point check is sound: a finished full solve satisfies, in
exact f32 edge arithmetic, ``d[v] == min over non-self in-edges (u,v) of
fl32(d[u] + w)`` for every ``v != source`` — ``<=`` because no relaxation
can improve a settled row (feasibility), ``>=`` because the final value of
``d[v]`` was produced by some relaxation from a neighbour whose label only
ever decreased afterwards (achievement). Unreachable vertices satisfy it
as ``inf == inf``. Self-loops are excluded because a zero-weight self-loop
certifies any value. The check is criterion- and backend-independent, and
a *single* corrupted entry — NaN, negative, raised, lowered, or
de-infinitied — breaks it.

The check runs on the graph's device: the reference's is O(m) host numpy
a row (``np.minimum.at`` over every arc), which at 10^8 arcs costs more
than the B = 8 solve's share of a row on the card. :func:`verify_row`
uploads the host row it is given (the row handed out is what it
certifies) and computes ``best`` as the dynamic key-min kernel the
engines already run (#5 ``ell_key_min_batch`` on the padded layout, #9 on
the sliced one) with the row as its gate, over the in-view the graph
already holds (:func:`_verify_edges`); the verdict, the first bad vertex
and the count come back in one read-back. f32 min is exact, so only the
sign of a zero ``best`` can differ from ``np.minimum.at``'s, and a
compare never sees it. On a rejection alone, the printed ``min-in-edge``
is recomputed for that one vertex from the COO arcs with the reference's
own ``np.minimum.at`` (the later arc's sign on a tie of -0 and +0), so
every reason string is the reference's.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from repro_torch.core.graph import Graph, to_ell_in, to_ell_in_sliced
from repro_torch.kernels.ops import key_min_batch_any
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import ContinuousBatcher

INF = float("inf")


def _resident_in_view(g: Graph):
    """An in-view the graph already holds: padded first, then sliced.
    With none, the in-view of the layout whose out-view it holds (padded
    when it holds neither; a sliced out-view's buckets alone, as delta
    holds them, count as sliced): a padded view of a skewed graph can be
    far larger than its sliced one."""
    for name in ("_ell_in_cache", "_ell_in_sliced_cache"):
        memo = g.__dict__.get(name)
        if memo:
            return next(iter(memo.values()))
    d = g.__dict__
    if (d.get("_ell_out_sliced_cache") or d.get("_ell_out_buckets_cache")) \
            and not d.get("_ell_out_cache"):
        return to_ell_in_sliced(g)
    return to_ell_in(g)


def _verify_edges(g: Graph):
    """The verifier's in-arcs: an in-view of the graph
    (:func:`_resident_in_view`, finite arcs only) with every self-loop
    given a +inf weight, memoised on the graph instance like the ELL and
    graph-key memos. A graph without finite self-loops shares the view
    itself; with some, only the weights are copied (the index arrays stay
    shared), as ``ops.weight_gated_ell`` does."""
    cached = g.__dict__.get("_verify_edges")
    if cached is not None:
        return cached
    view = _resident_in_view(g)
    if bool((torch.isfinite(g.w) & (g.src == g.dst)).any()):
        def unloop(rows, cols, ws):
            return torch.where(cols == rows[:, None], INF, ws)

        if hasattr(view, "slices"):
            view = view._replace(slices=tuple(
                s._replace(ws=unloop(s.rows, s.cols, s.ws))
                for s in view.slices))
        else:
            cols, ws = view
            rows = torch.arange(g.n, dtype=cols.dtype, device=cols.device)
            view = (cols, unloop(rows, cols, ws))
    g.__dict__["_verify_edges"] = view
    return view


def _min_in_edge(g: Graph, row: torch.Tensor, v: int) -> np.float32:
    """The reference's ``best[v]``: ``np.minimum.at`` over the f32
    ``row[u] + w`` of v's finite non-self-loop in-arcs in COO order (the
    later arc's sign on a tie of -0 and +0). One vertex, for a reason."""
    keep = (g.dst == v) & (g.src != v) & torch.isfinite(g.w)
    vals = (row[g.src[keep].long()] + g.w[keep]).cpu().numpy()
    best = np.full(1, np.inf, np.float32)
    np.minimum.at(best, np.zeros(vals.shape[0], np.intp), vals)
    return best[0]


def verify_row(g: Graph, dist: np.ndarray, source: int,
               target: int | None = None) -> str | None:
    """Certify one harvested distance row; None = accepted, else a short
    rejection reason (the reference's strings).

    Full rows (``target is None``) get the complete relax-fixed-point
    check (module docstring). Point rows are only *sanity*-checked — no
    NaN/negative anywhere, ``dist[source] == 0`` — because entries past
    the pruning bound are legitimately unsettled; a resilient server
    therefore downgrades point queries when it wants full certification.
    """
    d = np.asarray(dist)
    if d.shape != (g.n,):
        return f"shape {d.shape} != ({g.n},)"
    # the row's own dtype, contiguous and in native byte order (what
    # torch.from_numpy takes)
    d = np.ascontiguousarray(d, dtype=d.dtype.newbyteorder("="))
    if not d.flags.writeable:  # torch.from_numpy wants a writeable buffer
        d = d.copy()
    row = torch.from_numpy(d).to(g.device)  # the row as given, its dtype
    checks = [torch.isnan(row).any(), (row < 0).any()]
    full = target is None
    if full:
        row = row.to(torch.float32)
        best = key_min_batch_any(row[None], _verify_edges(g))[0]
        best[source] = 0.0  # the source is axiomatically 0
        bad = row != best  # a compare: the sign of a zero best is unseen
        checks += [bad.sum(), bad.to(torch.int8).argmax()]
    flags = torch.stack([c.to(torch.int64) for c in checks]).tolist()
    if flags[0]:
        return "NaN distance"
    if flags[1]:
        return "negative distance"
    if d[source] != np.float32(0.0):
        return f"dist[source] = {d[source]!r}, expected 0.0"
    if not full:
        return None  # pruned row: the fixed point legitimately fails
    if flags[2]:
        v = int(flags[3])
        dv = d.astype(np.float32, copy=False)[v]
        bv = _min_in_edge(g, row, v)
        return (f"fixed-point violation at vertex {v}: dist={dv!r} vs "
                f"min-in-edge {bv!r} ({flags[2]} vertices total)")
    return None


class ResilientBatcher(ContinuousBatcher):
    """:class:`ContinuousBatcher` + verified harvest and fault recovery.

    Extra args (everything else passes through to the base class):

      verify: certify every harvested row with :func:`verify_row` before
        it can be delivered or cached (default True — a ResilientBatcher
        without verification is just a retry loop). Implies point-query
        downgrade (module docstring).
      retry_budget: default re-solve budget per request; a request's own
        ``max_retries`` (from ``submit``) overrides it.
      backoff_base: first-retry delay, in clock units.
      backoff_cap: upper bound on any single backoff delay.
      backoff_jitter: uniform multiplicative jitter fraction in
        ``[0, backoff_jitter]`` added per delay, from a seeded RNG —
        retries desynchronise, runs replay.
      jitter_seed: seed for that RNG.
      quarantine_lane_after: retire a lane after this many verifier
        rejections (None = never). A retired lane is never admitted into
        again; the server keeps serving on the rest.

    Liveness note: a parked (backing-off) retry is released once its
    ``not_before`` passes — or immediately when the server is otherwise
    completely idle, so backoff (a load-shaping tool) can never deadlock a
    drain under a virtual clock that only moves on injected stalls.
    """

    def __init__(self, *args, verify: bool = True, retry_budget: int = 3,
                 backoff_base: float = 1e-3, backoff_cap: float = 0.25,
                 backoff_jitter: float = 0.25, jitter_seed: int = 0,
                 quarantine_lane_after: int | None = None, **kw):
        super().__init__(*args, **kw)
        self.verify = bool(verify)
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0; got {retry_budget}")
        self.retry_budget = int(retry_budget)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.backoff_jitter = float(backoff_jitter)
        self._jitter = random.Random(jitter_seed)
        self.quarantine_lane_after = (
            None if quarantine_lane_after is None else int(quarantine_lane_after)
        )
        self._lane_rejects = [0] * self.lanes
        self._parked: list[Request] = []  # backing-off retries
        self._terminal: list[Request] = []  # failed mid-round, to report

    # -- admission ----------------------------------------------------------

    @property
    def pending(self) -> int:
        return super().pending + len(self._parked)

    def _should_downgrade(self, req: Request) -> bool:
        # a verified server only serves rows it can certify, and pruned
        # point rows can't be — widen them (answer unchanged, row cacheable)
        return self.verify or super()._should_downgrade(req)

    def _release_parked(self) -> None:
        if not self._parked:
            return
        now = self.clock()
        due = [r for r in self._parked if r.not_before <= now]
        if not due and super().pending == 0 and self.busy_lanes == 0:
            # nothing else to do: waiting out backoff would only stall the
            # drain (and under a virtual clock, stall it forever)
            due = [min(self._parked, key=lambda r: (r.not_before, r.req_id))]
        if due:
            self._parked = [r for r in self._parked if r not in due]
            for r in sorted(due, key=lambda r: (r.not_before, r.req_id)):
                self.queue.requeue(r)

    def _admit(self):
        self._release_parked()
        return super()._admit()

    def step(self):
        done = super().step()
        if self._terminal:
            # budget-exhausted requests retired by the quarantine/recovery
            # hooks this round: they are part of the round's resolutions
            done.extend(self._terminal)
            self._terminal.clear()
        return done

    # -- retry machinery ----------------------------------------------------

    def _requeue_retry(self, req: Request, now: float, reason: str,
                       burn_budget: bool = True) -> bool:
        """Schedule a re-solve; returns False if the budget is exhausted
        (the request is then retired with outcome ``"failed"``)."""
        budget = (self.retry_budget if req.max_retries is None
                  else int(req.max_retries))
        if burn_budget:
            if req.retries >= budget:
                self._fail(req, "failed", now,
                           f"retry budget {budget} exhausted: {reason}")
                self._terminal.append(req)  # step() reports the retirement
                return False
            req.retries += 1
            delay = min(self.backoff_cap,
                        self.backoff_base * (2.0 ** (req.retries - 1)))
            delay *= 1.0 + self._jitter.random() * self.backoff_jitter
            req.not_before = now + delay
            self.metrics.record_retry(req)
        else:
            req.not_before = now
        # back to pre-admission state: classification runs afresh (the
        # retry may now hit the cache or coalesce onto another lane). A
        # lane-fill coalesce leaves the follower parked *inside* _ready
        # (skipped while coalesced, already discounted from _ready_live and
        # _by_source) — purge that entry before the flag reset below
        # revives it, or the request would be admitted twice
        if req.coalesced and req in self._ready:
            self._ready.remove(req)
        req.lane = None
        req.t_admitted = None
        req.coalesced = False
        req.cache_hit = False
        self._parked.append(req)
        self._tracer.instant(
            f"retry {req.retries} req {req.req_id} src {req.source}",
            cat="request", tid="scheduler")
        return True

    # -- verified harvest ---------------------------------------------------

    def _accept_row(self, req: Request, lane: int, row: np.ndarray,
                    now: float) -> bool:
        if not self.verify:
            return True
        reason = verify_row(self.g, row, req.source,
                            target=req.effective_target)
        if reason is None:
            return True
        # quarantine: the row dies here — not cached, not delivered. The
        # lane is freed; its next admission is a bitwise-fresh reset_lanes
        # re-solve (the engine state it leaves behind is never read again).
        self.metrics.record_quarantine(req)
        self._tracer.end(f"src {req.source}", cat="request",
                         tid=f"lane {lane}", quarantined=True)
        self._tracer.instant(f"quarantine lane {lane}: {reason}",
                             cat="request", tid=f"lane {lane}")
        self._lane_req[lane] = None
        self._lane_rejects[lane] += 1
        if (self.quarantine_lane_after is not None
                and self._lane_rejects[lane] >= self.quarantine_lane_after
                and not self._lane_disabled[lane]
                and sum(self._lane_disabled) < self.lanes - 1):
            # persistently bad lane: retire it (keep >= 1 lane serving)
            self._lane_disabled[lane] = True
            self._tracer.instant(f"lane {lane} retired after "
                                 f"{self._lane_rejects[lane]} rejects",
                                 cat="request", tid=f"lane {lane}")
        if self.cache is not None and req.effective_target is None:
            self._inflight.pop(req.source, None)
        followers = self._followers.pop(lane, ())
        self._requeue_retry(req, now, f"verifier rejected row: {reason}")
        for f in followers:
            # their own answers were never corrupted — re-classify them at
            # full budget and no backoff (they may coalesce onto the retry)
            self._requeue_retry(f, now, "primary row quarantined",
                               burn_budget=False)
        return False

    # -- engine-failure recovery --------------------------------------------

    def _advance_and_peek(self):
        try:
            return super()._advance_and_peek()
        except Exception as err:  # noqa: BLE001 — recovery seam: anything
            # the engine throws mid-step is handled by a full rebuild, and
            # persistent failure surfaces as outcome="failed" requests
            self._recover_engine(err)
            return None

    def _recover_engine(self, err: Exception) -> None:
        """Rebuild the engine state and re-queue all in-flight work.

        Deliberately coarse: after a failed step the old state is suspect
        (with donation its buffers may already be aliased), so recovery is
        a fresh ``backend.init`` — every lane's request retries from
        scratch, which keeps the bit-exactness contract trivially intact.
        """
        now = self.clock()
        self.metrics.record_engine_failure()
        self._tracer.instant(f"engine failure: {err}", cat="step",
                             tid="scheduler")
        inflight = [(lane, r) for lane, r in enumerate(self._lane_req)
                    if r is not None]
        for lane, r in inflight:
            self._tracer.end(f"src {r.source}", cat="request",
                             tid=f"lane {lane}", aborted=True)
        followers = self._followers
        self._followers = {}
        self._lane_req = [None] * self.lanes
        self._inflight.clear()
        self.state = self.backend.init(self.lanes)
        trips, _, _ = self.backend.peek(self.state)
        self._trips_dev = int(trips)  # fresh device counter: re-baseline
        for _, r in inflight:
            self._requeue_retry(r, now, f"engine step failed: {err}")
        for fs in followers.values():
            for f in fs:
                self._requeue_retry(f, now, "engine step failed",
                                    burn_budget=False)

    # -- shutdown -----------------------------------------------------------

    def close(self):
        dropped = super().close()
        now = self.clock()
        for r in self._parked:
            if r.outcome is None:
                self._fail(r, "shed", now, "server closed")
                dropped.append(r)
        self._parked = []
        return dropped
