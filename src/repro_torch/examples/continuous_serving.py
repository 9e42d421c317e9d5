"""Continuous-batching SSSP server demo: asynchronous arrivals, B lanes
(counterpart of ``examples/continuous_serving.py``).

A long-lived process holds one road graph, queries trickle in (including
repeated popular sources), and a ``ContinuousBatcher`` keeps its lanes
busy by refilling each finished lane from the queue instead of waiting
for the slowest row of a static batch. Duplicate sources short-circuit
through the distance cache. Every completed answer is checked bit for bit
against a standalone ``run_phased_static`` solve, and the run ends by
printing the JSON metrics report.

    PYTHONPATH=src python -m repro_torch.examples.continuous_serving
        [--n 2500] [--lanes 8] [--queries 48] [--phases-per-step 32]
        [--seed 0] [--trace serving_trace.json] [--report report.json]
        [--chaos SEED] [--device cpu]

``--trace PATH`` turns on the observability layer: the run also writes a
Chrome trace-event file (one timeline row per lane, a queue-depth counter
track; ``python -m repro_torch.obs validate PATH`` checks it) and prints
the metrics-registry dashboard. ``--chaos SEED`` serves through a
``ResilientBatcher`` behind a seeded random fault plan (``FaultyBackend``
+ ``FaultyDistCache``): rows get corrupted at harvest, engine steps fail,
the device stalls, cached rows rot, and every completed answer is still
checked bit for bit; the run ends by printing which faults fired and what
the recovery did about them.
"""
from __future__ import annotations

import argparse
import io

import numpy as np

from repro_torch.core.static_engine import run_phased_static
from repro_torch.examples import Record, add_device_arg, sync
from repro_torch.graphs import grid_road
from repro_torch.kernels.config import resolve_device
from repro_torch.obs import Observability
from repro_torch.obs.timer import now
from repro_torch.serving import (
    ContinuousBatcher,
    DistCache,
    FaultPlan,
    FaultyBackend,
    FaultyDistCache,
    ResilientBatcher,
    StaticBackend,
    VirtualClock,
)


def arrivals(n: int, lanes: int, queries: int, hot_frac: float,
             seed: int) -> np.ndarray:
    """The arrival trace: mostly unique sources plus a hot set that
    exercises the cache (popular origins recur in any real serving mix)."""
    rng = np.random.default_rng(seed + 1)
    hot = rng.integers(0, n, size=max(1, lanes // 2))
    return np.where(
        rng.random(queries) < hot_frac,
        hot[rng.integers(0, len(hot), queries)],
        rng.integers(0, n, queries),
    )


def serve_and_check(server, g, sources, out: Record, what: str) -> list:
    """Feed ``sources`` a burst at a time between scheduling rounds, check
    every completion bit for bit against a solo solve (memoised by
    source) and print it; returns the completions as
    ``(req_id, source, tag)``."""
    arrived = 0
    done = []
    solo_memo = {}
    burst = max(1, len(sources) // 8)
    while arrived < len(sources) or not server.idle:
        for s in sources[arrived:arrived + burst]:
            server.submit(int(s))
        arrived = min(arrived + burst, len(sources))
        for req in server.step():
            # hot sources recur by design: the server dedups them, and the
            # validator pays one solve per distinct source too
            if req.source not in solo_memo:
                solo_memo[req.source] = run_phased_static(
                    g, req.source, device=g.device).dist.cpu().numpy()
            if not np.array_equal(req.dist, solo_memo[req.source]):
                raise RuntimeError(f"request {req.req_id} (source "
                                   f"{req.source}) diverged from {what}")
            tag = ("cache" if req.cache_hit else
                   "coalesced" if req.coalesced else
                   f"lane {req.lane}, {req.phases} phases")
            done.append((req.req_id, req.source, tag))
            out.say(f"  req {req.req_id:>3} src={req.source:<6} done in "
                    f"{req.latency*1e3:7.1f} ms ({tag})")
    return done


def main(argv=None) -> Record:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2500,
                    help="~vertex count (grid side is sqrt)")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--phases-per-step", type=int, default=32)
    ap.add_argument("--hot-frac", type=float, default=0.25,
                    help="fraction of queries drawn from a small popular set")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="capture a Chrome trace-event file here (also "
                         "enables the metrics registry + dashboard)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the registry snapshot JSON here "
                         "(with --trace)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="serve through a ResilientBatcher under a seeded "
                         "random fault plan (faults fire, answers stay "
                         "bit-exact)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = Record()

    side = max(2, int(np.sqrt(args.n)))
    g = grid_road(side, side, seed=args.seed, device=dev)
    out.say(f"serving road grid {side}x{side}: n={g.n}, "
            f"m={g.num_real_edges}, "
            f"lanes={args.lanes}, k={args.phases_per_step}")

    obs = Observability.enabled() if args.trace else None
    if args.chaos is not None:
        plan = FaultPlan.random(args.chaos, n_faults=5,
                                horizon=4 * args.queries, lanes=args.lanes)
        clock = VirtualClock()
        out.say(f"chaos plan (seed {args.chaos}):")
        for f in plan.faults:
            out.say(f"  {f.kind:<12} at step {f.at}"
                    + (f" lane {f.lane}" if f.lane is not None else "")
                    + f" magnitude {f.magnitude:.2f}")
        server = ResilientBatcher(
            g, lanes=args.lanes, phases_per_step=args.phases_per_step,
            cache=FaultyDistCache(DistCache(capacity=256), plan),
            backend=FaultyBackend(StaticBackend(g, device=dev), plan,
                                  clock=clock),
            clock=clock.now, obs=obs,
        )
    else:
        server = ContinuousBatcher(
            g, lanes=args.lanes, phases_per_step=args.phases_per_step,
            cache=DistCache(capacity=256), obs=obs,
        )

    sources = arrivals(g.n, args.lanes, args.queries, args.hot_frac,
                       args.seed)
    t0 = now()
    done = serve_and_check(server, g, sources, out, "the solo solve")
    sync(dev)
    wall = now() - t0
    validated = len(done)

    out.say(f"\nall {validated} answers bit-exact vs run_phased_static")
    if args.chaos is not None:
        fired = server.backend.fired
        poisoned = server.cache.poisoned
        m = server.metrics
        out.say(f"chaos: {len(fired)} backend fault(s) fired "
                f"({', '.join(f.kind for f in fired) or 'none'}), "
                f"{len(poisoned)} cache row(s) poisoned")
        out.say(f"recovery: {m.quarantines} quarantine(s), {m.retries} "
                f"retr{'y' if m.retries == 1 else 'ies'}, "
                f"{m.engine_failures} engine rebuild(s), "
                f"{server.cache.corrupt_dropped} rotten cache row(s) dropped")
        if validated != args.queries:
            raise RuntimeError(
                f"chaos run completed {validated}/{args.queries}")
    out.say(server.metrics.to_json(indent=1))
    out.fields.update(n=g.n, m=g.num_real_edges, completions=done,
                      seconds=wall, metrics=server.metrics.report())

    if obs is not None:
        from repro_torch.obs.__main__ import render_dashboard
        from repro_torch.obs.tracer import validate_events

        errors = validate_events(obs.tracer.events())
        if errors:
            raise RuntimeError("\n".join(errors))
        obs.tracer.export(args.trace)
        out.say(f"\ntrace: {len(obs.tracer.events())} events -> {args.trace} "
                f"(open in https://ui.perfetto.dev)")
        if args.report:
            with open(args.report, "w") as f:
                f.write(obs.registry.to_json())
            out.say(f"report: {args.report}")
        out.say()
        board = io.StringIO()
        render_dashboard(obs.registry.snapshot(), out=board)
        out.say(board.getvalue().rstrip("\n"))
    return out


if __name__ == "__main__":
    main()
