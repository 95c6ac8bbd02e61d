"""Per-job lifecycle timelines from merged JSONL span logs.

``python -m ...obs.timeline --jsonl dispatcher.jsonl worker1.jsonl ...``

The trace layer (:mod:`.trace`) gives every span a
``(trace_id, span_id, parent_id)`` triple and the dispatcher mints one
trace per job, so the JSONL event logs of any number of processes —
dispatcher, workers, slice leaders — merge into one timeline per job:

    queue-wait -> dispatch -> [transport] -> decode -> compile/execute
    -> d2h -> [transport] -> report

This module reconstructs those timelines, computes **critical-path stage
attribution** (every instant of the job's end-to-end wall is charged to
exactly one stage, so the stages sum to the measured e2e by
construction), aggregates per-stage and per-worker totals, and flags
**stragglers** — jobs whose time in some stage exceeds the fleet's p95
for that stage.

Attribution model: each span name maps to a stage with a priority;
walking the job's e2e window, each instant is charged to the
highest-priority span covering it (ties to the later-starting, i.e.
innermost, span), and instants no span covers are charged to
``transport`` — the wire/queue gaps between processes that no process
can time directly. Generic envelope spans (``worker.submit``,
``worker.collect``) act as low-priority fallbacks for their halves of
the pipeline, so time inside submit but outside the decode span still
lands in ``execute`` rather than vanishing into transport.

Wall-clock timestamps (``t0``) anchor the merge: logs from one host
share a clock; cross-host merging inherits NTP-grade skew, which shifts
the transport buckets but never the in-process stage durations.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# The canonical stage order of the job lifecycle (report tables and the
# acceptance contract both use it). `panel_cache_hit` is the
# dispatch-by-digest pseudo-stage: a worker serving a panel from its
# digest cache emits its decode span with a truthy `cache_hit` attr, and
# that window is charged here — without it the (near-zero) hit window
# would read as decode work that never happened, and timelines from
# workers that skip the span entirely would silently mis-charge the gap
# to transport.
# `push` is the live fan-out stage (serve/): the dispatcher-side window
# from a completion landing to the result fanned out onto every
# subscriber queue — emitted BEFORE the job's e2e span closes, so it
# lands inside the attribution window (delivery to the client socket is
# the subscriber generator's own wall, visible on the tick-to-push
# histogram instead).
STAGES = ("queue_wait", "dispatch", "transport", "panel_cache_hit",
          "carry_hit", "decode", "compile", "execute", "d2h", "report",
          "push")

# span name -> (stage, priority). Priority 2 = stage-specific span wins
# its interval outright; priority 1 = envelope fallback (charged only
# where no specific span covers). The "job" span is the e2e window, not
# a stage.
SPAN_STAGE = {
    "job.queue_wait": ("queue_wait", 2),
    "job.dispatch": ("dispatch", 2),
    "worker.decode": ("decode", 2),
    "worker.compile": ("compile", 2),
    "worker.execute": ("execute", 2),
    "worker.d2h": ("d2h", 2),
    "worker.report": ("report", 2),
    # The digest-miss recovery RPC (can fire inside the decode window on
    # the compute-thread race leg): network wall, charged to transport —
    # same priority as the specific spans, so innermost-wins beats the
    # enclosing decode span over the fetch's own interval.
    "worker.payload_fetch": ("transport", 2),
    # Streaming appends: the whole carry advance/rebuild window. With a
    # truthy `carry_hit` attr it charges to the `carry_hit` pseudo-stage
    # (the streaming twin of panel_cache_hit — an O(ΔT) advance is not
    # execute work at full-reprice scale); a checkpoint-miss full reprice
    # stays execute.
    "worker.append": ("execute", 2),
    # Live fan-out (serve/): the completion->fanned-out window on the
    # dispatcher. Priority 2: it overlaps only envelope spans (the
    # worker's report fallback), and those instants ARE push work.
    "job.push": ("push", 2),
    # Pipelined executor (round 14): the submit-return -> collect-start
    # window — the batch is in flight on the device while the submit
    # thread stages the NEXT batch. Envelope priority: any specific span
    # inside it wins, but an otherwise-uncovered in-flight window is
    # device execute, NOT the transport the uncovered-gap rule would
    # charge it to.
    "worker.inflight": ("execute", 1),
    # Control-loop payload warm-up (DBX_PREFETCH): decode work done
    # early, so the compute-side decode span can report a cache hit
    # without the real decode wall vanishing from the decode stage.
    "worker.prefetch": ("decode", 2),
    "worker.submit": ("execute", 1),
    "worker.collect": ("d2h", 1),
    "worker.process": ("execute", 1),
    "slice.run_group": ("execute", 1),
    "slice.run_ts_group": ("execute", 1),
}

# Pipeline lanes of the overlap-aware mode: the submit half (host decode
# / page-table build / compile / launch) vs the collect half (device
# drain + d2h). A serial worker alternates lanes, so their coverages
# tile the busy wall (overlap factor ~1); the pipelined executor runs
# them concurrently on two threads, so one wall second carries up to two
# lane seconds (factor -> 2 at perfect double-buffered overlap).
# `worker.inflight` joins neither lane: its window is queue/device wait,
# and counting it would inflate the factor without any host work
# actually overlapping.
_LANE_SPANS = {
    "worker.prefetch": "submit", "worker.decode": "submit",
    "worker.compile": "submit", "worker.execute": "submit",
    "worker.append": "submit", "worker.submit": "submit",
    "worker.d2h": "collect", "worker.collect": "collect",
}
# worker.process (the serial loop's whole-batch envelope) joins NEITHER
# lane: it covers both halves of its batch, so counting it as submit
# would read every serial d2h as overlapped.

E2E_SPAN = "job"


@dataclasses.dataclass
class JobTimeline:
    """All spans of one trace (one job), plus its identity anchors."""

    trace_id: str
    job_id: str = ""
    worker: str = ""
    e2e_t0: float = 0.0
    e2e_dur: float = 0.0
    spans: list = dataclasses.field(default_factory=list)

    @property
    def window(self) -> tuple[float, float]:
        """The attribution window: the dispatcher's measured end-to-end
        span when present, else the span cover (partial logs)."""
        if self.e2e_dur > 0:
            return (self.e2e_t0, self.e2e_t0 + self.e2e_dur)
        if not self.spans:
            return (0.0, 0.0)
        return (min(s["t0"] for s in self.spans),
                max(s["t0"] + s["dur_s"] for s in self.spans))


def parse_events(paths) -> tuple[list[dict], int]:
    """Merge JSONL files into one event list; malformed lines (torn tails,
    truncated writes, non-JSON noise) are skipped AND counted — a
    diagnostic log must never crash its own analyzer, but silent drops
    would misread a corrupt log as a quiet fleet. An unreadable FILE is an
    error (raises OSError): naming a wrong path is operator error, not log
    corruption."""
    events: list[dict] = []
    malformed = 0
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    malformed += 1
                    continue
                if not isinstance(rec, dict) or "ev" not in rec:
                    malformed += 1
                    continue
                events.append(rec)
    return events, malformed


def stats_url(url: str, doc: str = "stats.json") -> str:
    """Normalize an endpoint to its ``doc`` document URL (a full
    ``.../<doc>`` passes through) — shared by the ``--url`` CLIs here
    and in obs.dump plus obs.fleet's ``/fleet.json`` fetch."""
    if url.rstrip("/").endswith("/" + doc):
        return url
    return url.rstrip("/") + "/" + doc


def fetch_events(urls) -> tuple[list[dict], int]:
    """Scrape live ``/stats.json`` snapshots and return their
    ``dbx_spans_recent`` ring records as span events — the no-log-
    shipping twin of :func:`parse_events`, with the same skip-and-count
    contract for malformed entries. An unreachable URL raises (operator
    error, like an unreadable file)."""
    import urllib.request

    events: list[dict] = []
    malformed = 0
    for url in urls:
        with urllib.request.urlopen(stats_url(url), timeout=10) as resp:
            try:
                snap = json.loads(resp.read())
            except json.JSONDecodeError:
                malformed += 1
                continue
        fam = snap.get("dbx_spans_recent")
        vals = fam.get("values", []) if isinstance(fam, dict) else []
        for rec in vals:
            if not isinstance(rec, dict) or "ev" not in rec:
                malformed += 1
                continue
            events.append(rec)
    return events, malformed


def _span_t0(rec: dict) -> float:
    # t0 is stamped by the trace layer; older logs carry only the write
    # timestamp — the span ENDED at ts, so start = ts - dur.
    if "t0" in rec:
        return float(rec["t0"])
    return float(rec.get("ts", 0.0)) - float(rec.get("dur_s", 0.0))


def reconstruct(events) -> dict[str, JobTimeline]:
    """Group span events into one :class:`JobTimeline` per trace id.

    A span carrying a ``traces`` list (one compute batch serving several
    jobs) is fanned out to every listed trace — the batch's wall is part
    of EACH job's timeline (the jobs shared the device; attribution is
    wall-clock, not device-second, by design)."""
    out: dict[str, JobTimeline] = {}
    for rec in events:
        if rec.get("ev") != "span":
            continue
        dur = float(rec.get("dur_s", 0.0))
        t0 = _span_t0(rec)
        # (trace_id, parent_id) per destination trace: a multi-job batch
        # span stores its local stack parent in ``parent_id`` ("" when it
        # is the context's outermost span) and each trace's REMOTE parent
        # in its ``traces`` pair — losing the pair's half would leave the
        # fanned-out copies parentless.
        tids = []
        if rec.get("trace_id"):
            tids.append((rec["trace_id"], rec.get("parent_id", "")))
        tids.extend((t, rec.get("parent_id") or p)
                    for t, p in rec.get("traces", []) if t)
        for tid, parent_id in tids:
            tl = out.get(tid)
            if tl is None:
                tl = out[tid] = JobTimeline(trace_id=tid)
            name = rec.get("name", "?")
            tl.spans.append({
                "name": name, "t0": t0, "dur_s": dur,
                "span_id": rec.get("span_id", ""),
                "parent_id": parent_id,
                "pid": rec.get("pid"), "ok": rec.get("ok", True),
                "worker": rec.get("worker", ""),
                "cache_hit": bool(rec.get("cache_hit", False)),
                "carry_hit": bool(rec.get("carry_hit", False))})
            if name == E2E_SPAN:
                tl.e2e_t0, tl.e2e_dur = t0, dur
            if rec.get("job") and not tl.job_id:
                tl.job_id = str(rec["job"])
            if rec.get("worker") and name in (E2E_SPAN, "job.dispatch"):
                tl.worker = str(rec["worker"])
    for tl in out.values():
        tl.spans.sort(key=lambda s: (s["t0"], -s["dur_s"]))
    return out


def critical_path(tl: JobTimeline) -> dict[str, float]:
    """Charge every instant of the job's window to exactly one stage.

    Boundary sweep over the clipped span intervals: per segment, the
    highest-priority covering span's stage wins (ties to the later start
    — the innermost span); uncovered segments are ``transport``. The
    returned stage seconds therefore sum EXACTLY to the window length —
    the property the acceptance check ("stages within 10% of measured
    e2e") rides on; the 10% slack only absorbs clock jitter between the
    dispatcher's two window timestamps and span timestamps taken on
    other threads."""
    lo, hi = tl.window
    out = {s: 0.0 for s in STAGES}
    if hi <= lo:
        return out
    ivals = []
    for s in tl.spans:
        staged = SPAN_STAGE.get(s["name"])
        if staged is None:
            continue
        stage, prio = staged[0], staged[1]
        if s["name"] == "worker.decode" and s.get("cache_hit"):
            # Dispatch by digest: every panel of this group came from the
            # worker's digest cache — the window is a cache HIT, not
            # decode work. (d2h spans also carry cache_hit — the group's
            # panel upload was device-cached — but the result drain they
            # time is real work and stays attributed to d2h.)
            stage = "panel_cache_hit"
        if s["name"] == "worker.append" and s.get("carry_hit"):
            # Streaming append served from the carry checkpoint: the
            # O(ΔT) advance window, not full-reprice execute work.
            stage = "carry_hit"
        a = max(s["t0"], lo)
        b = min(s["t0"] + s["dur_s"], hi)
        if b > a:
            ivals.append((a, b, prio, s["t0"], stage))
    points = sorted({lo, hi, *(a for a, *_ in ivals),
                     *(b for _, b, *_ in ivals)})
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        best = None
        for ia, ib, prio, t0, stage in ivals:
            if ia <= mid < ib:
                key = (prio, t0)
                if best is None or key > best[0]:
                    best = (key, stage)
        out[best[1] if best else "transport"] += b - a
    return out


def _merge_ivals(ivals) -> list:
    """Union of ``(a, b)`` intervals: sorted, coalesced, as tuples."""
    out: list = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _coverage(merged, lo: float, hi: float) -> float:
    """Seconds of a merged interval union inside ``[lo, hi]``."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def overlap_lanes(timelines) -> dict:
    """Per-worker pipeline-lane interval unions for the overlap-aware
    mode: ``worker -> {"submit": [...], "collect": [...], "both": [...]}``
    (merged, non-overlapping intervals each).

    Spans are deduped by span id across timelines first — a multi-job
    batch's span is fanned out to every member's timeline, and counting
    the one decode wall once per job would read co-batching as
    pipelining. The per-JOB wall-clock attribution (:func:`critical_path`)
    deliberately keeps the fan-out; the lanes measure the WORKER's
    thread-level concurrency instead."""
    per: dict = {}
    for tl in timelines.values():
        lanes = per.setdefault(tl.worker or "?",
                               {"submit": {}, "collect": {}})
        for s in tl.spans:
            lane = _LANE_SPANS.get(s["name"])
            if lane is None or s["dur_s"] <= 0:
                continue
            key = s["span_id"] or (s["name"], s["t0"], s["dur_s"])
            lanes[lane][key] = (s["t0"], s["t0"] + s["dur_s"])
    out = {}
    for w, lanes in per.items():
        submit = _merge_ivals(list(lanes["submit"].values()))
        collect = _merge_ivals(list(lanes["collect"].values()))
        out[w] = {"submit": submit, "collect": collect,
                  "both": _merge_ivals(submit + collect)}
    return out


def overlap_factor(lanes: dict, lo: float, hi: float) -> float:
    """Pipelining factor of one worker's lanes inside a window: lane
    seconds per covered wall second. 1.0 = fully serial (lanes tile the
    busy wall); 2.0 = the submit and collect halves fully overlapped
    (perfect double buffering). Windows with no covered wall (a worker
    that never ran compute spans) report 1.0 — no evidence of overlap is
    not evidence of idleness."""
    union = _coverage(lanes["both"], lo, hi)
    if union <= 0:
        return 1.0
    return (_coverage(lanes["submit"], lo, hi)
            + _coverage(lanes["collect"], lo, hi)) / union


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    i = int(pos)
    frac = pos - i
    if i + 1 >= len(sorted_vals):
        return sorted_vals[-1]
    return sorted_vals[i] + (sorted_vals[i + 1] - sorted_vals[i]) * frac


# Straggler flagging needs a population: with fewer jobs than this, p95
# is within noise of the max and every run would "find" one straggler.
MIN_STRAGGLER_JOBS = 8


def summarize(timelines: dict[str, JobTimeline], *,
              min_straggler_jobs: int = MIN_STRAGGLER_JOBS,
              overlap: bool = False) -> dict:
    """Fleet digest: per-stage totals/quantiles, per-worker attribution,
    per-job stage seconds, and stragglers (jobs > p95 in a stage).

    ``overlap=True`` adds the overlap-aware mode (round 14): a per-job
    ``overlap_factor`` — the worker's submit+collect lane seconds per
    covered wall second inside the job's window — and a summary
    ``overlap`` block with per-worker and fleet factors. The per-instant
    stage attribution is unchanged (it charges wall clock and must keep
    summing to e2e); the factor is the separate answer to "how much
    pipeline concurrency did this wall second carry"."""
    lanes = overlap_lanes(timelines) if overlap else {}
    jobs = []
    per_stage: dict[str, list] = {s: [] for s in STAGES}
    per_worker: dict[str, dict] = {}
    for tid, tl in sorted(timelines.items()):
        stages = critical_path(tl)
        lo, hi = tl.window
        row = {"trace_id": tid, "job": tl.job_id,
               "worker": tl.worker, "t0": lo,
               "e2e_s": round(hi - lo, 9),
               "measured_e2e_s": round(tl.e2e_dur, 9),
               "stages": {k: round(v, 9) for k, v in stages.items()},
               "spans": len(tl.spans)}
        if overlap:
            row["overlap_factor"] = round(overlap_factor(
                lanes[tl.worker or "?"], lo, hi), 4)
        jobs.append(row)
        for k, v in stages.items():
            per_stage[k].append(v)
        w = per_worker.setdefault(tl.worker or "?",
                                  {"jobs": 0, "e2e_s": 0.0,
                                   **{s: 0.0 for s in STAGES}})
        w["jobs"] += 1
        w["e2e_s"] += hi - lo
        for k, v in stages.items():
            w[k] += v

    stage_stats = {}
    for k, vals in per_stage.items():
        sv = sorted(vals)
        stage_stats[k] = {
            "total_s": round(sum(sv), 9),
            "mean_s": round(sum(sv) / len(sv), 9) if sv else 0.0,
            "p95_s": round(_quantile(sv, 0.95), 9),
            "max_s": round(sv[-1], 9) if sv else 0.0}

    stragglers = []
    if len(jobs) >= min_straggler_jobs:
        for stage in STAGES:
            p95 = stage_stats[stage]["p95_s"]
            if p95 <= 0:
                continue
            for j in jobs:
                if j["stages"][stage] > p95:
                    stragglers.append({
                        "job": j["job"], "trace_id": j["trace_id"],
                        "worker": j["worker"], "stage": stage,
                        "seconds": j["stages"][stage], "p95_s": p95})
    stragglers.sort(key=lambda s: -(s["seconds"] - s["p95_s"]))

    out = {"jobs": len(jobs),
           "e2e_total_s": round(sum(j["e2e_s"] for j in jobs), 9),
           "stages": stage_stats,
           "workers": {k: {kk: (vv if kk == "jobs" else round(vv, 9))
                           for kk, vv in v.items()}
                       for k, v in sorted(per_worker.items())},
           "stragglers": stragglers,
           "per_job": jobs}
    if overlap:
        lane_s = {ln: 0.0 for ln in ("submit", "collect")}
        union_s = 0.0
        workers = {}
        for w, wl in sorted(lanes.items()):
            cov = {ln: _coverage(wl[ln], float("-inf"), float("inf"))
                   for ln in ("submit", "collect")}
            union = _coverage(wl["both"], float("-inf"), float("inf"))
            for ln in lane_s:
                lane_s[ln] += cov[ln]
            union_s += union
            workers[w] = round((cov["submit"] + cov["collect"])
                               / union if union > 0 else 1.0, 4)
        out["overlap"] = {
            "overlap_factor": round((lane_s["submit"] + lane_s["collect"])
                                    / union_s if union_s > 0 else 1.0, 4),
            "lane_seconds": {ln: round(v, 9) for ln, v in lane_s.items()},
            "covered_wall_s": round(union_s, 9),
            "workers": workers}
    return out


def summarize_spans(spans, **kw) -> dict:
    """Summarize in-memory span records (the obs ring) — bench.py's hook:
    the e2e configs run dispatcher+worker in-process, so the completed
    spans land in the ring without any JSONL file.

    The ring is bounded, and eviction tears the OLDEST jobs first: a
    job's earliest record (``job.queue_wait``, written at take time)
    falls off while its later worker spans and e2e ``job`` span survive,
    so the missing stages would be silently charged to transport. A
    job's ring records are appended in completion order, so the presence
    of its first-written span implies the rest survived too — timelines
    missing ``job.queue_wait`` are dropped from the digest and counted
    as ``torn_jobs`` instead of skewing the stage shares."""
    timelines = reconstruct(spans)
    torn = [t for t, tl in timelines.items()
            if not any(s["name"] == "job.queue_wait" for s in tl.spans)]
    for t in torn:
        del timelines[t]
    if not timelines:
        return {}
    out = summarize(timelines, **kw)
    out.pop("per_job", None)   # BENCH JSON carries the digest, not N rows
    n_strag = len(out["stragglers"])
    if n_strag > 50:
        # Same digest-not-rows discipline: stragglers are sorted worst
        # first, so the tail past 50 is noise a 400 KB BENCH blob would
        # otherwise carry; the total survives as a count.
        out["stragglers"] = out["stragglers"][:50]
        out["stragglers_total"] = n_strag
    if torn:
        out["torn_jobs"] = len(torn)
    return out


# ---------------------------------------------------------------------------
# Rendering + CLI
# ---------------------------------------------------------------------------

def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.0f}us"


def _table(rows: list[tuple], header: tuple) -> str:
    rows = [tuple(str(c) for c in r) for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]

    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()

    out = [line(header), line(tuple("-" * w for w in widths))]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def render_text(summary: dict) -> str:
    out = [f"{summary['jobs']} job(s), "
           f"{_fmt_s(summary['e2e_total_s'])} end-to-end wall"]
    if "overlap" in summary:
        ov = summary["overlap"]
        out.append(
            f"pipeline overlap {ov['overlap_factor']:.2f}x "
            f"(submit {_fmt_s(ov['lane_seconds']['submit'])} + collect "
            f"{_fmt_s(ov['lane_seconds']['collect'])} over "
            f"{_fmt_s(ov['covered_wall_s'])} covered wall)")
    rows = []
    total = summary["e2e_total_s"] or 1.0
    for stage in STAGES:
        st = summary["stages"][stage]
        if not st["total_s"]:
            continue
        rows.append((stage, _fmt_s(st["total_s"]), _fmt_s(st["mean_s"]),
                     _fmt_s(st["p95_s"]), _fmt_s(st["max_s"]),
                     f"{100.0 * st['total_s'] / total:.1f}%"))
    out.append("")
    out.append("== critical-path stage attribution ==")
    out.append(_table(rows, ("stage", "total", "mean/job", "p95", "max",
                             "share")))
    if len(summary["workers"]) > 1 or "?" not in summary["workers"]:
        out.append("")
        out.append("== per worker ==")
        wrows = [(w, v["jobs"], _fmt_s(v["e2e_s"]),
                  _fmt_s(v["execute"] + v["compile"]),
                  _fmt_s(v["transport"]), _fmt_s(v["report"]))
                 for w, v in summary["workers"].items()]
        out.append(_table(wrows, ("worker", "jobs", "e2e", "compute",
                                  "transport", "report")))
    if summary["stragglers"]:
        out.append("")
        out.append("== stragglers (stage time > fleet p95) ==")
        srows = [(s["job"] or s["trace_id"][:12], s["stage"],
                  _fmt_s(s["seconds"]), _fmt_s(s["p95_s"]), s["worker"])
                 for s in summary["stragglers"][:20]]
        out.append(_table(srows, ("job", "stage", "seconds", "p95",
                                  "worker")))
    for j in summary.get("per_job", []):
        out.append("")
        top = sorted(j["stages"].items(), key=lambda kv: -kv[1])
        out.append(f"-- job {j['job'] or j['trace_id'][:12]} "
                   f"(worker {j['worker'] or '?'}): "
                   f"e2e {_fmt_s(j['e2e_s'])}, "
                   + ", ".join(f"{k} {_fmt_s(v)}"
                               for k, v in top if v > 0))
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs.timeline",
        description="merge JSONL span logs from any number of processes "
                    "into per-job lifecycle timelines with critical-path "
                    "stage attribution and straggler flags")
    ap.add_argument("--jsonl", nargs="+", action="extend", default=[],
                    metavar="PATH",
                    help="JSONL event log(s) (DBX_OBS_JSONL output); "
                         "repeatable, merged on trace ids")
    ap.add_argument("--url", nargs="+", action="extend", default=[],
                    metavar="URL",
                    help="live /stats.json endpoint(s) "
                         "(http://host:port or the full .../stats.json): "
                         "the snapshot's recent-span ring is merged in "
                         "beside --jsonl, so an operator can point at a "
                         "running fleet without shipping logs")
    ap.add_argument("--job", default=None,
                    help="restrict to one job id (or trace-id prefix)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--min-straggler-jobs", type=int,
                    default=MIN_STRAGGLER_JOBS,
                    help="minimum fleet size before stragglers are "
                         "flagged (p95 of a tiny sample is noise)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap-aware mode: per-job and per-worker "
                         "pipeline overlap factors (submit+collect lane "
                         "seconds per covered wall second)")
    args = ap.parse_args(argv)
    if not args.jsonl and not args.url:
        ap.error("no inputs: pass --jsonl path(s) and/or --url "
                 "endpoint(s)")

    events, malformed = parse_events(args.jsonl)
    if args.url:
        url_events, url_malformed = fetch_events(args.url)
        events.extend(url_events)
        malformed += url_malformed
    if malformed:
        print(f"obs.timeline: skipped {malformed} malformed "
              "line(s)/record(s)", file=sys.stderr)
    if not events:
        print("obs.timeline: no parseable events in "
              + ", ".join(args.jsonl + args.url), file=sys.stderr)
        return 2
    timelines = reconstruct(events)
    if args.job:
        timelines = {t: tl for t, tl in timelines.items()
                     if tl.job_id == args.job or t.startswith(args.job)}
        if not timelines:
            print(f"obs.timeline: no trace matches --job {args.job}",
                  file=sys.stderr)
            return 2
    if not timelines:
        print("obs.timeline: events parsed but none carry trace ids "
              "(pre-tracing logs?)", file=sys.stderr)
        return 2
    summary = summarize(timelines,
                        min_straggler_jobs=args.min_straggler_jobs,
                        overlap=args.overlap)
    if args.format == "json":
        print(json.dumps(summary, indent=2))
    else:
        sys.stdout.write(render_text(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
