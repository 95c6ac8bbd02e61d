"""Phase-attribution viewer: ``python -m ...obs.dump <target>...``.

Each ``target`` is either a live endpoint (``http://host:port`` — its
``/stats.json`` is fetched) or a JSONL event-log path (``DBX_OBS_JSONL``
output; also acceptable via ``--jsonl``). All JSONL inputs aggregate
into ONE phase table (a fleet writes one log per process); malformed
lines are skipped and counted, and a run that parses ZERO events exits
non-zero — an empty table from a typo'd path must not read as a healthy
quiet fleet. The output is a phase table: where wall-clock went, by
span/histogram, share-ranked — the live counterpart of bench.py's
roofline stage accounting. For per-JOB lifecycle timelines and
critical-path stage attribution, see :mod:`.timeline`.

A copy of the reference's ``obs/dump.py`` on the port's ``obs.timeline``,
held byte for byte to its output by ``tests/test_torch_obs_cli.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from .timeline import _fmt_s, _table, parse_events, stats_url


def _phase_rows(digests: dict) -> list[tuple]:
    """(name, count, total_s, avg, p50, p99, max, share%) rows from
    ``{label: histogram-summary}`` digests, share-ranked."""
    total = sum(d.get("sum", 0.0) for d in digests.values()) or 1.0
    rows = []
    for label, d in sorted(digests.items(),
                           key=lambda kv: -kv[1].get("sum", 0.0)):
        if not d.get("count"):
            continue
        rows.append((label, d["count"], _fmt_s(d["sum"]),
                     _fmt_s(d.get("avg", 0.0)),
                     _fmt_s(d.get("p50", 0.0)), _fmt_s(d.get("p99", 0.0)),
                     _fmt_s(d.get("max", 0.0)),
                     f"{100.0 * d['sum'] / total:.1f}%"))
    return rows


_PHASE_HEADER = ("phase", "count", "total", "avg", "p50", "p99", "max",
                 "share")


def render_snapshot(snap: dict) -> str:
    """Registry snapshot (``/stats.json`` shape) -> report text."""
    out: list[str] = []
    hists = {name: fam["values"] for name, fam in snap.items()
             if fam.get("type") == "histogram"}
    for name, values in sorted(hists.items()):
        rows = _phase_rows(values)
        if rows:
            out.append(f"== {name} ==")
            out.append(_table(rows, _PHASE_HEADER))
            out.append("")
    scalars = []
    for name, fam in sorted(snap.items()):
        if fam.get("type") in ("counter", "gauge"):
            for label, v in sorted(fam["values"].items()):
                key = f"{name}{{{label}}}" if label else name
                scalars.append((key, fam["type"],
                                round(v, 6) if isinstance(v, float) else v))
    if scalars:
        out.append("== counters / gauges ==")
        out.append(_table(scalars, ("metric", "type", "value")))
        out.append("")
    return "\n".join(out) if out else "(no metrics recorded)\n"


def render_jsonl(paths) -> tuple[str, int, int]:
    """Aggregate one or more span event logs into the phase table.

    Returns ``(text, n_events, n_malformed)`` — malformed lines (torn
    tails, truncated writes) are skipped and counted, never fatal and
    never silent."""
    if isinstance(paths, str):
        paths = [paths]
    events, malformed = parse_events(paths)
    agg: dict[str, dict] = {}
    for rec in events:
        if rec.get("ev") != "span":
            continue
        name = rec.get("name", "?")
        if rec.get("parent"):
            name = f"{rec['parent']}/{name}"
        dur = float(rec.get("dur_s", 0.0))
        d = agg.setdefault(name, {"count": 0, "sum": 0.0, "max": 0.0,
                                  "durs": []})
        d["count"] += 1
        d["sum"] += dur
        d["max"] = max(d["max"], dur)
        d["durs"].append(dur)
    digests = {}
    for name, d in agg.items():
        durs = sorted(d["durs"])
        digests[name] = {
            "count": d["count"], "sum": d["sum"],
            "avg": d["sum"] / d["count"], "max": d["max"],
            "p50": durs[len(durs) // 2],
            "p99": durs[min(len(durs) - 1, int(len(durs) * 0.99))]}
    rows = _phase_rows(digests)
    head = (f"{len(events)} events, {len(agg)} span phases from "
            + ", ".join(paths))
    if malformed:
        head += f" ({malformed} malformed line(s) skipped)"
    if not rows:
        return head + "\n(no span events)\n", len(events), malformed
    return (head + "\n" + _table(rows, _PHASE_HEADER) + "\n",
            len(events), malformed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="pretty-print dbx obs endpoints and/or JSONL event "
                    "logs as a phase-attribution table")
    ap.add_argument("targets", nargs="*", default=[],
                    help="http://host:port of a live /metrics server, or "
                         "JSONL event-log path(s)")
    ap.add_argument("--jsonl", nargs="+", action="extend", default=[],
                    metavar="PATH",
                    help="additional JSONL event log(s); all JSONL inputs "
                         "aggregate into one table")
    ap.add_argument("--url", nargs="+", action="extend", default=[],
                    metavar="URL",
                    help="live snapshot endpoint(s) (http://host:port or "
                         "the full .../stats.json) — same as a positional "
                         "http target, spelled like obs.timeline's flag")
    args = ap.parse_args(argv)
    urls = [t for t in args.targets
            if t.startswith(("http://", "https://"))] + args.url
    jsonl = [t for t in args.targets
             if not t.startswith(("http://", "https://"))] + args.jsonl
    if not urls and not jsonl:
        ap.error("no targets: pass an endpoint URL (--url) and/or JSONL "
                 "path(s)")
    for target in urls:
        with urllib.request.urlopen(stats_url(target), timeout=10) as resp:
            snap = json.loads(resp.read())
        sys.stdout.write(render_snapshot(snap))
    if jsonl:
        text, n_events, _malformed = render_jsonl(jsonl)
        sys.stdout.write(text)
        if not n_events:
            # A zero-event run is a broken pipeline (wrong path, log never
            # enabled), not a quiet fleet — fail loudly for CI wrappers.
            print("obs.dump: no parseable events in "
                  + ", ".join(jsonl), file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
