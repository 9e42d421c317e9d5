"""Span tracer emitting Chrome trace-event JSON (counterpart of
``repro.obs.tracer``; the events are the reference's, key for key).

:class:`Tracer` collects trace events in memory and exports the Chrome
``traceEvents`` JSON format (Perfetto / ``chrome://tracing``): serving
lanes render as one timeline row each (thread = lane), ``step`` spans from
the serving scheduler, ``request`` spans covering each query's occupancy of
a lane, ``C`` counter samples (queue depth, busy lanes) and ``i`` instants
(admissions, cache hits, shedding).

A disabled tracer is safe to leave plumbed through hot loops: every
recording method returns on one attribute check, and ``span()`` returns a
shared no-op context manager. Timestamps come from an injectable clock
(seconds) and are exported as microseconds since the tracer's construction.
"""
from __future__ import annotations

import json

from repro_torch.obs import timer

# every ph this tracer emits; the validator additionally accepts a few
# common Chrome phases so foreign traces can be checked too
_EMITTED_PH = ("X", "B", "E", "i", "C", "M")
_KNOWN_PH = frozenset(_EMITTED_PH) | {"I"}  # legacy spelling of instant

DEFAULT_PID = "repro"


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """Open span handle: records one complete ('X') event on exit."""

    __slots__ = ("_tracer", "name", "cat", "tid", "args", "_t0")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now_us()
        self._tracer._emit({
            "ph": "X", "name": self.name, "cat": self.cat,
            "pid": self._tracer.pid, "tid": self.tid,
            "ts": self._t0, "dur": t1 - self._t0,
            **({"args": self.args} if self.args else {}),
        })
        return None


class Tracer:
    """In-memory Chrome trace-event collector.

    Args:
      enabled: recording switch; a disabled tracer's methods are no-ops.
      clock: timestamp source in *seconds* (injectable for simulated time);
        exported ``ts`` are microseconds since tracer construction.
      pid: the trace's process id/name (one logical process per tracer).
      max_events: bound on retained events; once full, further events are
        dropped and counted in ``dropped`` (a truncated trace stays a valid
        trace — silent unbounded growth in a long-lived server would not).
    """

    def __init__(self, enabled: bool = True, clock=timer.now,
                 pid: str | int = DEFAULT_PID,
                 max_events: int | None = None):
        self.enabled = bool(enabled)
        self.clock = clock
        self.pid = pid
        self.max_events = max_events
        self.dropped = 0
        self._t0 = clock()
        self._meta: list[dict] = []  # ph='M' naming events, exported first
        self._events: list[dict] = []
        self._named_tids: set = set()

    # -- internals ----------------------------------------------------------

    def _now_us(self) -> float:
        return round((self.clock() - self._t0) * 1e6, 3)

    def _emit(self, ev: dict) -> None:
        if self.max_events is not None and len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    # -- recording API ------------------------------------------------------

    def span(self, name: str, cat: str = "default", tid: str | int = "main",
             **args):
        """Context manager recording one complete ('X') event for the block."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, tid, args)

    def begin(self, name: str, cat: str = "default", tid: str | int = "main",
              **args) -> None:
        """Open a duration ('B') event; pair with :meth:`end` on the same
        tid. Use for spans that outlive one ``with`` block (a query
        occupying a serving lane)."""
        if not self.enabled:
            return
        self._emit({
            "ph": "B", "name": name, "cat": cat, "pid": self.pid, "tid": tid,
            "ts": self._now_us(), **({"args": args} if args else {}),
        })

    def end(self, name: str, cat: str = "default", tid: str | int = "main",
            **args) -> None:
        """Close the innermost open 'B' event on ``tid`` (names must match —
        the validator enforces proper nesting)."""
        if not self.enabled:
            return
        self._emit({
            "ph": "E", "name": name, "cat": cat, "pid": self.pid, "tid": tid,
            "ts": self._now_us(), **({"args": args} if args else {}),
        })

    def instant(self, name: str, cat: str = "default",
                tid: str | int = "main", **args) -> None:
        if not self.enabled:
            return
        self._emit({
            "ph": "i", "name": name, "cat": cat, "pid": self.pid, "tid": tid,
            "ts": self._now_us(), "s": "t",
            **({"args": args} if args else {}),
        })

    def counter(self, name: str, values: dict, cat: str = "default",
                tid: str | int = "counters") -> None:
        """One sample of a counter track (``values``: series name -> number)."""
        if not self.enabled:
            return
        self._emit({
            "ph": "C", "name": name, "cat": cat, "pid": self.pid, "tid": tid,
            "ts": self._now_us(), "args": dict(values),
        })

    def name_thread(self, tid: str | int, name: str) -> None:
        """Label a tid's timeline row in the viewer (idempotent)."""
        if not self.enabled or tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._meta.append({
            "ph": "M", "name": "thread_name", "pid": self.pid, "tid": tid,
            "ts": 0, "args": {"name": str(name)},
        })

    # -- export -------------------------------------------------------------

    def events(self) -> list[dict]:
        """Export-ordered copy: metadata first, then events by ``ts``."""
        body = sorted(self._events, key=lambda e: e["ts"])  # stable
        return [dict(e) for e in self._meta + body]

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON file; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def __len__(self) -> int:
        return len(self._events) + len(self._meta)


NULL_TRACER = Tracer(enabled=False)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def load_trace(path: str) -> list[dict]:
    """Load a trace file, accepting both the object form
    (``{"traceEvents": [...]}``) and the bare JSON-array form."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(
                f"{path}: object form must carry a 'traceEvents' list"
            )
        return events
    if isinstance(data, list):
        return data
    raise ValueError(f"{path}: neither object nor array trace form")


def validate_events(events) -> list[str]:
    """Chrome trace-event structural validation; returns error strings.

    Checks (the golden-file contract in ``tests/test_obs.py``): every event
    is a dict carrying a known ``ph``, a ``name``, and ``pid``/``tid``;
    non-metadata events carry numeric non-negative ``ts`` and are globally
    sorted by it; 'X' events carry non-negative ``dur``; 'B'/'E' events nest
    properly per (pid, tid) with matching names and none left open; 'C'
    events carry a dict of numeric series. An empty list of errors means
    Perfetto will accept the file.
    """
    errors: list[str] = []
    if not isinstance(events, list):
        return ["trace is not a list of events"]
    stacks: dict[tuple, list[tuple[int, str]]] = {}
    last_ts: float | None = None
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing/empty name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), (str, int)):
                errors.append(f"{where}: missing {key}")
        if ph == "M":
            continue  # metadata carries no meaningful timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) or ts < 0:
            errors.append(f"{where}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(
                f"{where}: ts {ts} < previous {last_ts} — events not sorted"
            )
        last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float)) or isinstance(dur, bool)
                    or dur < 0):
                errors.append(f"{where}: 'X' event with bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (i, ev.get("name", ""))
            )
        elif ph == "E":
            stack = stacks.get((ev.get("pid"), ev.get("tid")))
            if not stack:
                errors.append(f"{where}: 'E' with no open 'B' on this tid")
            else:
                j, open_name = stack.pop()
                if open_name != ev.get("name"):
                    errors.append(
                        f"{where}: 'E' name {ev.get('name')!r} does not match "
                        f"open 'B' {open_name!r} (event[{j}])"
                    )
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in args.values()
            ):
                errors.append(f"{where}: 'C' event needs numeric args series")
    for (pid, tid), stack in stacks.items():
        for j, name in stack:
            errors.append(
                f"event[{j}]: 'B' {name!r} on ({pid}, {tid}) never closed"
            )
    return errors


def validate_trace_file(path: str) -> list[str]:
    """Load + validate; file-level problems come back as errors too."""
    try:
        events = load_trace(path)
    except (OSError, ValueError) as e:
        return [str(e)]
    return validate_events(events)
