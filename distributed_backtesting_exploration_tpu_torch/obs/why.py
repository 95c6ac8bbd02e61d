"""``dbxwhy``: why did job J land on worker W, and what did it cost?

The decision plane (obs/decisions.py) records one explain document per
dispatched job — the WFQ pick context (sched/explain.py), the payload
route, the polling worker's fleet-view age, the LIVE placement stage's
rank (chosen vs best-placed worker, score gap, deferrals spent against
``DBX_PLACEMENT_DEFER_CAP``), and the shadow placement scorer's
per-candidate cost ranking with its measured regret. The timeline
(obs/timeline.py) records what then actually happened —
queue-wait, dispatch, transport, compile/execute, d2h, report. This CLI
stitches the two into one report per job:

    dbxwhy <job-id> --jsonl dispatcher.jsonl [worker.jsonl ...]
    dbxwhy <job-id> --url http://dispatcher:9100

Both streams ride the same JSONL event log (``DBX_OBS_JSONL`` — spans
as ``ev="span"``, decisions as ``ev="decision"`` lines), so the merge
contract is obs.timeline's verbatim: any number of ``--jsonl`` files,
malformed lines skipped and counted, an unreadable FILE an error.
``--url`` scrapes a live dispatcher instead: ``/decisions.json`` for
the record tail and ``/stats.json`` for the span ring — no log
shipping. A job dispatched more than once (requeue, journal-replay
restart) has one record per dispatch; all are shown, oldest first —
the decision CHAIN, not just the last word.

Exit codes: 0 with a report, 2 when no decision record matches the job
(or no inputs parse) — the obs.timeline contract.

A copy of the reference's ``obs/why.py`` on the port's ``obs.timeline``,
held byte for byte to its output by ``tests/test_torch_obs_cli.py``: it
reads the logs of JAX and PyTorch workers alike.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import timeline


def split_events(events) -> tuple[list[dict], list[dict]]:
    """One merged JSONL stream -> (decision records, span events)."""
    decisions = [e for e in events if e.get("ev") == "decision"]
    spans = [e for e in events if e.get("ev") == "span"]
    return decisions, spans


def fetch_decisions(urls) -> tuple[list[dict], int]:
    """Scrape live ``/decisions.json`` tails. Mirrors
    ``timeline.fetch_events``: malformed entries skip-and-count, an
    unreachable URL raises (operator error, not log corruption)."""
    import urllib.request

    out: list[dict] = []
    malformed = 0
    for url in urls:
        doc_url = timeline.stats_url(url, "decisions.json")
        with urllib.request.urlopen(doc_url, timeout=10) as resp:
            try:
                doc = json.loads(resp.read())
            except json.JSONDecodeError:
                malformed += 1
                continue
        recent = doc.get("recent") if isinstance(doc, dict) else None
        for rec in recent or ():
            if isinstance(rec, dict):
                out.append(rec)
            else:
                malformed += 1
    return out, malformed


def match_job(decisions, spans, job: str):
    """Filter both streams to one job id (or trace-id prefix)."""
    hits = [d for d in decisions
            if d.get("jid") == job
            or str(d.get("trace_id", "")).startswith(job)]
    timelines = {
        t: tl for t, tl in timeline.reconstruct(spans).items()
        if tl.job_id == job or t.startswith(job)}
    return hits, timelines


def _fmt_cost(c: dict) -> str:
    parts = [f"exec {timeline._fmt_s(c.get('exec_s', 0.0))}"]
    if c.get("transfer_s"):
        parts.append(f"h2d {timeline._fmt_s(c['transfer_s'])}")
    if c.get("compile_s"):
        parts.append(f"compile {timeline._fmt_s(c['compile_s'])}")
    flags = [f for f in ("carry_hit", "resident") if c.get(f)]
    if flags:
        parts.append("+".join(flags))
    return ", ".join(parts)


def render_decision(d: dict, idx: int, total: int) -> str:
    out = []
    head = f"== decision {idx + 1}/{total}: job {d.get('jid', '?')} -> " \
           f"worker {d.get('worker', '?')} =="
    out.append(head)
    out.append(f"route={d.get('route', '?')}  "
               f"tenant={d.get('tenant', '?')}  "
               f"strategy={d.get('strategy', '?')}  "
               f"combos={d.get('combos', 0)}  "
               f"affinity_skips={d.get('affinity_skips', 0)}")
    age = d.get("fleet_age_s")
    out.append("fleet-view age at decision: "
               + (f"{age:.3f}s" if isinstance(age, (int, float))
                  else "(no telemetry)"))
    wfq = d.get("wfq")
    if isinstance(wfq, dict) and wfq.get("affinity_held"):
        out.append("wfq: served from the placement-held list (locality "
                   "deferral; no pick-time scheduler state)")
    elif isinstance(wfq, dict):
        out.append(
            f"wfq: tag={wfq.get('tag')} vtime={wfq.get('vtime')} "
            f"vfinish={wfq.get('vfinish')} cost={wfq.get('cost')} "
            f"weight={wfq.get('weight')}"
            + (" OVER-QUOTA" if wfq.get("over_quota") else ""))
        heads = wfq.get("heads") or {}
        if heads:
            out.append("  competing heads: " + ", ".join(
                f"{t}={v}" for t, v in sorted(heads.items())))
        if wfq.get("demoted"):
            out.append("  quota-demoted this pick: "
                       + ", ".join(wfq["demoted"]))
    placement = d.get("placement")
    if isinstance(placement, dict):
        best = str(placement.get("best", "?"))
        actual = str(d.get("worker", ""))
        verdict = ("best-placed worker" if best == actual else
                   f"best-placed was {best}, "
                   f"gap {timeline._fmt_s(placement.get('gap_s', 0.0))}")
        out.append(
            f"placement: outcome={placement.get('outcome', '?')}  "
            f"cost={timeline._fmt_s(placement.get('cost_s', 0.0))} "
            f"vs best={timeline._fmt_s(placement.get('best_cost_s', 0.0))}  "
            f"defers={placement.get('defers', 0)}/{placement.get('cap', 0)}  "
            f"({verdict}; table: "
            f"{placement.get('table_workers', 0)} worker(s))")
    shadow = d.get("shadow") or {}
    costs = shadow.get("costs") or {}
    if costs:
        actual = str(d.get("worker", ""))
        rows = []
        for wid, c in sorted(costs.items(),
                             key=lambda kv: kv[1].get("cost_s", 0.0)):
            marks = ("<- actual" if wid == actual else "") + \
                (" (shadow pick)" if wid == shadow.get("best")
                 and wid != actual else "")
            rows.append((wid, timeline._fmt_s(c.get("cost_s", 0.0)),
                         _fmt_cost(c), marks.strip()))
        out.append("shadow ranking "
                   f"({shadow.get('candidates', 0)} candidate(s)):")
        out.append(timeline._table(
            rows, ("worker", "cost", "breakdown", "")))
    if "regret_s" in shadow:
        verdict = ("shadow agrees with the placement"
                   if shadow.get("agree") else
                   f"shadow preferred {shadow.get('best', '?')}")
        out.append(f"regret: {timeline._fmt_s(shadow['regret_s'])} "
                   f"({verdict})")
    elif not costs:
        out.append("shadow: no live candidates at scoring time")
    return "\n".join(out)


def render(job: str, decisions: list, timelines: dict) -> str:
    out = []
    for i, d in enumerate(decisions):
        if i:
            out.append("")
        out.append(render_decision(d, i, len(decisions)))
    if timelines:
        out.append("")
        out.append("== what actually happened ==")
        summary = timeline.summarize(timelines)
        out.append(timeline.render_text(summary).rstrip("\n"))
    else:
        out.append("")
        out.append("(no span timeline for this job in the inputs)")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dbxwhy",
        description="stitch a job's dispatch decision records (WFQ pick "
                    "context, payload route, live placement rank, shadow "
                    "placement ranking, regret) with its span timeline")
    ap.add_argument("job", help="job id (or trace-id prefix)")
    ap.add_argument("--jsonl", nargs="+", action="extend", default=[],
                    metavar="PATH",
                    help="JSONL event log(s) (DBX_OBS_JSONL output) "
                         "carrying ev=decision and ev=span lines; "
                         "repeatable, merged")
    ap.add_argument("--url", nargs="+", action="extend", default=[],
                    metavar="URL",
                    help="live dispatcher metrics endpoint(s): "
                         "/decisions.json is scraped for the record "
                         "tail and /stats.json for the span ring")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)
    if not args.jsonl and not args.url:
        ap.error("no inputs: pass --jsonl path(s) and/or --url "
                 "endpoint(s)")

    events, malformed = timeline.parse_events(args.jsonl)
    decisions, spans = split_events(events)
    if args.url:
        url_decisions, url_malformed = fetch_decisions(args.url)
        decisions.extend(url_decisions)
        malformed += url_malformed
        try:
            url_spans, span_malformed = timeline.fetch_events(args.url)
        except OSError:
            url_spans, span_malformed = [], 0   # decisions-only endpoint
        spans.extend(url_spans)
        malformed += span_malformed
    if malformed:
        print(f"dbxwhy: skipped {malformed} malformed "
              "line(s)/record(s)", file=sys.stderr)
    if not decisions and not spans:
        print("dbxwhy: no parseable events in "
              + ", ".join(args.jsonl + args.url), file=sys.stderr)
        return 2
    hits, timelines = match_job(decisions, spans, args.job)
    if not hits:
        print(f"dbxwhy: no decision record matches {args.job!r} "
              "(is DBX_DECISIONS on, and the dispatcher's DBX_OBS_JSONL "
              "among the inputs?)", file=sys.stderr)
        return 2
    hits.sort(key=lambda d: d.get("t_take", 0.0))
    if args.format == "json":
        doc = {"job": args.job, "decisions": hits}
        if timelines:
            doc["timeline"] = timeline.summarize(timelines)
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        sys.stdout.write(render(args.job, hits, timelines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
