"""``python -m repro_torch.obs`` — inspect and validate observability
artifacts (counterpart of ``python -m repro.obs``; the same output).

Subcommands:

  * ``validate TRACE [TRACE ...]`` — structural Chrome-trace-event
    validation (sorted ts, matched B/E nesting, well-formed X/C events,
    pid/tid naming); exit 1 with one line per problem if any file fails.
  * ``export TRACE -o OUT`` — load a trace (object or bare-array form),
    normalise it (metadata first, events sorted by ts), validate the
    result, and write the canonical object form.
  * ``dashboard REPORT`` — render a registry snapshot JSON (from
    ``MetricsRegistry.to_json()``) as a text dashboard: counters/gauges as
    aligned key-values, histograms as exact aggregates + windowed
    percentiles with a unicode spark-bar over p50/p90/p99/max. A saved
    tuning ledger (or any JSON carrying ``portfolio:...`` keys) instead
    renders the portfolio view: per graph family, each candidate engine's
    routed win rate over the recorded lane counts, measured qps, its
    ``settle_attribution`` shares, and each share's drift from that
    engine's fleet-wide mean — the "why did this family route there"
    answer at a glance.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.tracer import load_trace, validate_events, validate_trace_file

_BAR = " ▏▎▍▌▋▊▉█"


def _fmt(v) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, int):
        return f"{v:,}"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) < 1e-3 or abs(v) >= 1e6:
            return f"{v:.3e}"
        return f"{v:,.4f}".rstrip("0").rstrip(".")
    return str(v)


def _spark(vals, width: int = 24) -> str:
    top = max(vals) or 1.0
    cells = []
    for v in vals:
        frac = max(0.0, min(1.0, v / top))
        cells.append(_BAR[round(frac * (len(_BAR) - 1))])
    return "".join(c * (width // len(vals)) for c in cells)


def cmd_validate(args) -> int:
    rc = 0
    for path in args.trace:
        errors = validate_trace_file(path)
        if errors:
            rc = 1
            for e in errors:
                print(f"{path}: {e}")
            print(f"{path}: INVALID ({len(errors)} problem(s))")
        else:
            n = len(load_trace(path))
            print(f"{path}: ok ({n} events)")
    return rc


def cmd_export(args) -> int:
    events = load_trace(args.trace)
    meta = [e for e in events if isinstance(e, dict) and e.get("ph") == "M"]
    body = [e for e in events if not (isinstance(e, dict)
                                      and e.get("ph") == "M")]
    body.sort(key=lambda e: e.get("ts", 0) if isinstance(e, dict) else 0)
    normalised = meta + body
    errors = validate_events(normalised)
    if errors:
        for e in errors:
            print(f"{args.trace}: {e}")
        print(f"{args.trace}: not exportable ({len(errors)} problem(s))")
        return 1
    with open(args.out, "w") as f:
        json.dump({"traceEvents": normalised, "displayTimeUnit": "ms"}, f)
    print(f"{args.out}: {len(normalised)} events")
    return 0


def render_dashboard(report: dict, out=None) -> None:
    """Text dashboard from a registry snapshot dict (testable core)."""
    out = out or sys.stdout
    w = max((len(nm) for nm in report), default=0)

    def line(s=""):
        print(s, file=out)

    simple = {nm: m for nm, m in report.items()
              if m.get("kind") in ("counter", "gauge")}
    hists = {nm: m for nm, m in report.items() if m.get("kind") == "histogram"}
    if simple:
        line("== counters / gauges " + "=" * max(0, w - 2))
        for nm, m in simple.items():
            line(f"  {nm:<{w}}  {_fmt(m.get('value')):>14}  ({m['kind']})")
    if hists:
        line("== histograms (exact aggregates | windowed percentiles) ==")
        for nm, m in hists.items():
            vals = [m.get("p50") or 0, m.get("p90") or 0,
                    m.get("p99") or 0, m.get("max") or 0]
            line(f"  {nm:<{w}}  n={_fmt(m.get('count'))} "
                 f"sum={_fmt(m.get('sum'))} mean={_fmt(m.get('mean'))} "
                 f"min={_fmt(m.get('min'))} max={_fmt(m.get('max'))}")
            line(f"  {'':<{w}}  p50={_fmt(m.get('p50'))} "
                 f"p90={_fmt(m.get('p90'))} p99={_fmt(m.get('p99'))} "
                 f"[window {m.get('window_count')}/{m.get('window')}]  "
                 f"{_spark(vals)}")
    if not report:
        line("(empty report)")


def _parse_portfolio(entries: dict) -> dict:
    """``portfolio:<family>:b<B>:<policy>:<layout>`` keys, nested:
    family -> lane count -> "policy:layout" -> entry. Policy specs contain
    ``|``/``@`` but never ``:``, so the layout is the final segment."""
    out: dict = {}
    for key, e in entries.items():
        if not (isinstance(key, str) and key.startswith("portfolio:")
                and isinstance(e, dict)):
            continue
        try:
            family, btok, rest = key[len("portfolio:"):].split(":", 2)
            policy, layout = rest.rsplit(":", 1)
            b = int(btok.removeprefix("b"))
        except ValueError:
            continue
        out.setdefault(family, {}).setdefault(b, {})[f"{policy}:{layout}"] = e
    return out


def _attr_shares(entry: dict) -> dict[str, float]:
    attr = entry.get("settle_attribution") or {}
    total = sum(attr.values())
    if not total:
        return {}
    return {term: v / total for term, v in sorted(attr.items())}


def render_portfolio(entries: dict, out=None) -> None:
    """Portfolio view over ledger entries: win rates + attribution drift."""
    out = out or sys.stdout

    def line(s=""):
        print(s, file=out)

    fams = _parse_portfolio(entries)
    if not fams:
        return
    # fleet-wide mean share per (engine, term): the drift baseline — a
    # family whose shares sit far from it is settling for different
    # reasons than the fleet, a routing-review signal
    fleet: dict[str, dict[str, list[float]]] = {}
    for lanes in fams.values():
        for engines in lanes.values():
            for eng, e in engines.items():
                for term, s in _attr_shares(e).items():
                    fleet.setdefault(eng, {}).setdefault(term, []).append(s)
    fleet_mean = {
        eng: {term: sum(v) / len(v) for term, v in terms.items()}
        for eng, terms in fleet.items()
    }
    line("== portfolio (measured routing ledger) ==")
    for family in sorted(fams):
        lanes = fams[family]
        wins: dict[str, int] = {}
        for engines in lanes.values():
            best = max(engines, key=lambda k: engines[k].get("qps", 0.0))
            wins[best] = wins.get(best, 0) + 1
        rounds = len(lanes)
        line(f"  family {family}  "
             f"(lane counts: {', '.join(str(b) for b in sorted(lanes))})")
        engs = sorted({e for engines in lanes.values() for e in engines})
        w = max(len(e) for e in engs)
        for eng in engs:
            qps = [engines[eng].get("qps", 0.0)
                   for engines in lanes.values() if eng in engines]
            mean_qps = sum(qps) / len(qps)
            rate = wins.get(eng, 0) / rounds
            seg = (f"    {eng:<{w}}  win {rate:>4.0%}  "
                   f"qps {_fmt(mean_qps):>10}")
            shares = {}
            for engines in lanes.values():
                if eng in engines and _attr_shares(engines[eng]):
                    shares = _attr_shares(engines[eng])
            if shares:
                base = fleet_mean.get(eng, {})
                drift = max(
                    (abs(s - base.get(term, s)) for term, s in shares.items()),
                    default=0.0,
                )
                seg += "  shares " + " ".join(
                    f"{term}={s:.2f}" for term, s in shares.items()
                )
                seg += f"  drift {drift:.2f}"
            line(seg)


def cmd_dashboard(args) -> int:
    with open(args.report) as f:
        report = json.load(f)
    if not isinstance(report, dict):
        print(f"{args.report}: not a registry snapshot (expected an object)")
        return 1
    portfolio = {k: v for k, v in report.items()
                 if isinstance(k, str) and k.startswith("portfolio:")}
    metrics = {k: v for k, v in report.items()
               if isinstance(v, dict) and v.get("kind") in
               ("counter", "gauge", "histogram")}
    if metrics or not portfolio:
        render_dashboard(metrics if portfolio else report)
    render_portfolio(portfolio)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate", help="validate Chrome trace-event files")
    v.add_argument("trace", nargs="+")
    v.set_defaults(fn=cmd_validate)

    e = sub.add_parser("export", help="normalise + re-export a trace file")
    e.add_argument("trace")
    e.add_argument("-o", "--out", required=True)
    e.set_defaults(fn=cmd_export)

    d = sub.add_parser("dashboard", help="render a registry snapshot as text")
    d.add_argument("report")
    d.set_defaults(fn=cmd_dashboard)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
