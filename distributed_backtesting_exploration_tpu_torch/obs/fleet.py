"""Fleet telemetry plane: staleness-bounded worker-state gossip + `dbxtop`.

Every obs surface before this round is per-process — the dispatcher can
describe its queue and a worker its caches, but nobody answers "what is
the fleet doing right now, and which worker is the problem?". This
module closes that gap with the gossip discipline (piggyback
compact deltas on the polls that already flow, merge deterministically
on the dispatcher, no extra coordinator):

- **worker side** (:class:`WorkerTelemetry`): each poll attaches a
  compact telemetry frame to ``JobsRequest.telemetry_json`` — monotone
  counters, per-stage cost EWMAs + fixed-bucket histograms (fed by a
  span listener over the existing ``worker.decode`` /
  ``worker.compile`` / ``worker.execute`` / ``worker.d2h``
  instrumentation), cache residency summaries (counts + byte totals + a
  small top-K digest sketch, never full key lists), pipeline depth and
  backend capability flags. A frame rides only when something changed
  or the heartbeat interval elapsed (``DBX_FLEET_HEARTBEAT_S``) — the
  schedule-gossip dirty-bit style, so a clean poll costs zero wire
  bytes.

- **dispatcher side** (:class:`FleetView`): merges frames under a
  staleness bound (``DBX_FLEET_STALE_S``; stale workers are flagged,
  then evicted by the maintenance loop's prune path), folds per-worker
  stage histograms into fleet-wide fixed-bucket histograms (the bucket
  bounds are shared — the merge is EXACT, tested against a
  single-process registry), computes fleet rollups (jobs/s, stage
  p50/p95, cache hit ratios) and straggler flags (per-stage EWMA above
  the fleet p95 — the timeline rule applied live), and serves
  everything on ``/fleet.json``, GetStats ``obs_json`` and the
  :func:`main` CLI (``dbxtop``: one-shot table or ``--watch`` refresh).

**Merge determinism contract**: a :meth:`FleetView.snapshot` is a pure
function of (latest frame per worker, now) — frames carry their own
worker-computed rates and a total order (``gen``/``seq``/``t``), so the
same frame set arriving in ANY order yields byte-identical snapshots.
This is what lets ROADMAP item 3's placement scorer (and any future
shard-to-shard gossip) trust the view.

**Cardinality bounds**: worker identity on metric labels goes through
``sched.tenancy.worker_bucket`` (first ``DBX_WORKER_LABEL_MAX`` workers
keep their name, the rest share ``other``) — the dbxlint
obs-cardinality sanctioned source; the JSON surfaces (frames,
``/fleet.json``) carry full ids, which are per-document, not
per-series.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import threading
import time
import uuid

from .registry import LATENCY_BUCKETS_S, get_registry, histogram_quantile
from . import costmodel as costmodel_mod
from . import trace

# ---------------------------------------------------------------------------
# Knobs (all read lazily — never at import)
# ---------------------------------------------------------------------------


def telemetry_enabled() -> bool:
    """``DBX_FLEET_TELEMETRY`` (default on): workers attach telemetry
    frames to their polls. ``0`` is the kill switch (the bench A/B's
    off arm)."""
    return os.environ.get("DBX_FLEET_TELEMETRY", "1").lower() not in (
        "0", "off", "false")


def heartbeat_s() -> float:
    """``DBX_FLEET_HEARTBEAT_S`` (default 2.0): the longest a worker
    stays frame-silent while nothing changes. Bounds frame age on an
    idle fleet, so dispatcher-side staleness is always a liveness
    signal, never just quiet."""
    return float(os.environ.get("DBX_FLEET_HEARTBEAT_S", 2.0))


def frame_min_s() -> float:
    """``DBX_FLEET_FRAME_MIN_S`` (default 0.2): minimum seconds between
    frames from one worker. A SATURATED worker is dirty on every poll
    (its job counter moved), and rebuilding cache residency summaries
    per 4 ms poll would burn the control plane for telemetry nobody can
    read that fast — this floor caps gossip at ~5 frames/s/worker while
    keeping frame age far inside the staleness bound. 0 restores
    frame-per-dirty-poll."""
    return float(os.environ.get("DBX_FLEET_FRAME_MIN_S", 0.2))


def stale_s() -> float:
    """``DBX_FLEET_STALE_S`` (default 10.0): frame age past which a
    worker's fleet-view entry is flagged stale (rollups exclude it);
    past 3x the bound the prune path evicts the entry entirely. The
    default matches the peer registry's prune window — a worker whose
    frames stopped is a worker whose polls stopped."""
    return float(os.environ.get("DBX_FLEET_STALE_S", 10.0))


def slo_burn_threshold() -> float:
    """``DBX_FLEET_SLO_BURN`` (default 0.1): queue-wait SLO breach
    fraction over a burn window above which that window's
    ``dbx_fleet_slo_burn_total`` counter ticks."""
    return float(os.environ.get("DBX_FLEET_SLO_BURN", 0.1))


#: The stages a telemetry frame costs out — exactly the span names the
#: worker instrumentation already emits, folded onto the timeline
#: analyzer's stage vocabulary.
TELEMETRY_STAGES = ("decode", "compile", "execute", "d2h")

_SPAN_TO_STAGE = {
    "worker.decode": "decode",
    "worker.prefetch": "decode",
    "worker.compile": "compile",
    "worker.execute": "execute",
    "worker.append": "execute",
    "worker.d2h": "d2h",
}

#: Shared fixed bucket bounds: worker-side accumulation and the
#: dispatcher-side fold use the SAME bounds, which is what makes the
#: fleet histogram merge exact (summing per-bucket counts commutes).
STAGE_BUCKETS_S = LATENCY_BUCKETS_S

# Straggler rule (the timeline rule applied live): a worker whose
# per-stage EWMA exceeds the fleet p95 for that stage, once the merged
# stage has a real population. The margin absorbs the fixed-bucket
# quantile's interpolation granularity — a worker sitting exactly AT
# the fleet p95 (the bulk of a healthy uniform fleet) must not flap in
# and out of the flag on bucket-boundary noise.
MIN_STRAGGLER_OBS = 8
MIN_STRAGGLER_WORKERS = 2
STRAGGLER_MARGIN = 1.25

_EWMA_ALPHA = 0.25

# Multi-window SLO burn (the SRE fast/slow-burn pair) over the
# queue-wait SLO: breach fraction per window vs DBX_FLEET_SLO_BURN.
SLO_WINDOWS = {"5m": 300.0, "1h": 3600.0}
_SLO_BUCKET_S = 10.0


# ---------------------------------------------------------------------------
# Worker side: process stage stats + per-worker frames
# ---------------------------------------------------------------------------


class _StageStats:
    """Per-stage cost accumulators fed by the completed-span stream.

    PROCESS-scoped (one span listener, however many Workers the process
    hosts — the registry-histogram precedent): frames from co-hosted
    workers carry identical stage stats plus their process identity
    (``pid`` + the host-unique ``proc_id`` token), and the fleet fold
    dedupes per process so co-hosting never double-counts.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stats = {
            s: {"n": 0, "sum_s": 0.0, "ewma_s": 0.0,
                "buckets": [0] * (len(STAGE_BUCKETS_S) + 1)}
            for s in TELEMETRY_STAGES}
        self.version = 0      # bumps per observation — the dirty signal

    def observe(self, rec: dict) -> None:
        stage = _SPAN_TO_STAGE.get(rec.get("name", ""))
        if stage is None:
            return
        dur = float(rec.get("dur_s", 0.0))
        i = 0
        while i < len(STAGE_BUCKETS_S) and dur > STAGE_BUCKETS_S[i]:
            i += 1
        with self._lock:
            st = self._stats[stage]
            st["n"] += 1
            st["sum_s"] += dur
            st["ewma_s"] = (dur if st["n"] == 1 else
                            _EWMA_ALPHA * dur
                            + (1.0 - _EWMA_ALPHA) * st["ewma_s"])
            st["buckets"][i] += 1
            self.version += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {s: {"n": st["n"], "sum_s": round(st["sum_s"], 9),
                        "ewma_s": round(st["ewma_s"], 9),
                        "buckets": list(st["buckets"])}
                    for s, st in self._stats.items()}


_stage_stats: _StageStats | None = None
_stage_stats_lock = threading.Lock()

#: Host/boot-unique process token carried in every frame beside ``pid``:
#: the dispatcher's per-process dedupe of process-scope data (stage
#: streams, cache hit counters) keys on THIS, because bare OS pids
#: collide across hosts — in a containerized fleet every worker process
#: is pid 1, and pid-keyed dedupe would silently collapse the whole
#: fleet's stats into one worker's stream.
_PROC_TOKEN = uuid.uuid4().hex[:16]


def stage_stats() -> _StageStats:
    """The process-wide stage collector, listener installed on first use
    (bounded state: 4 stages x one bucket list — kept for the process
    lifetime, like the registry's span histograms)."""
    global _stage_stats
    with _stage_stats_lock:
        if _stage_stats is None:
            _stage_stats = _StageStats()
            trace.add_span_listener("fleet-stages", _stage_stats.observe)
        return _stage_stats


# Process-scope cache hit/miss counter families sampled into frames
# (read-only peeks — a worker that never created a family reports
# nothing, and no zero-valued series is minted).
_PROC_HIT_COUNTERS = {
    "panel_host": (("dbx_panel_cache_hits_total", {"level": "host"}),
                   ("dbx_panel_cache_misses_total", {"level": "host"})),
    "panel_device": (("dbx_panel_cache_hits_total", {"level": "device"}),
                     ("dbx_panel_cache_misses_total", {"level": "device"})),
    "carry_device": (("dbx_carry_cache_hits_total", {"level": "device"}),
                     ("dbx_carry_cache_misses_total", {"level": "device"})),
    "carry_host": (("dbx_carry_cache_hits_total", {"level": "host"}),
                   ("dbx_carry_cache_misses_total", {"level": "host"})),
}
_PAGE_FIELDS = ("open", "high", "low", "close", "volume")


class WorkerTelemetry:
    """Builds one worker's telemetry frames (the ``telemetry_json`` leg).

    ``stats_fn`` is the owning worker's counter snapshot hook (a dict of
    ``jobs_completed`` / ``completions_dropped`` / ``polls`` / ``busy``
    / ``inflight`` / ``pipeline_on`` / ``pipeline_depth``); ``backend``
    supplies capability flags + cache residency via its optional
    ``telemetry()``. Frames are canonical (sorted keys, rounded floats)
    so the dispatcher's merge can be byte-deterministic.
    """

    # Windowed rate: frames carry a worker-computed jobs/s over roughly
    # this many seconds, so the fleet view needs no cross-frame state
    # (the merge-determinism contract).
    RATE_WINDOW_S = 10.0

    def __init__(self, worker_id: str, *, stats_fn=None, backend=None,
                 registry=None, stages=None, costmodel=None):
        self.worker_id = worker_id
        self.gen = uuid.uuid4().hex[:16]
        self._stats_fn = stats_fn
        self._backend = backend
        self._reg = registry or get_registry()
        # `stages` overrides the process-wide span-fed collector — for
        # probes/tests that carry their own stage stream (a bench's
        # artificially slowed worker). The frame marks which scope its
        # stage stats describe, so the dispatcher's per-pid fold knows
        # whether co-hosted frames share one stream.
        self._stages_scope = "proc" if stages is None else "worker"
        self._stages = stages if stages is not None else stage_stats()
        # The cost-model drift accumulator rides the same frames
        # (process-scoped by default, like the stage stats; an injected
        # tracker follows the `stages` probe discipline). A probe-scoped
        # frame (scope="worker") bypasses the dispatcher's per-process
        # dedupe, so it may only carry costmodel data it owns — the
        # shared process tracker would double-count in the fleet fold.
        self._costmodel_own = costmodel is not None
        self._costmodel = (costmodel if costmodel is not None
                           else costmodel_mod.tracker())
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.time()
        self._last_sent = 0.0
        self._last_fingerprint = None
        self._rate_ring: collections.deque = collections.deque(maxlen=64)
        self._c_frames = self._reg.counter(
            "dbx_worker_telemetry_frames_total",
            help="telemetry frames attached to polls")
        self._c_bytes = self._reg.counter(
            "dbx_worker_telemetry_bytes_total",
            help="serialized telemetry frame bytes attached to polls")

    def _worker_stats(self) -> dict:
        base = {"jobs_completed": 0, "completions_dropped": 0, "polls": 0,
                "busy": 0, "inflight": 0, "pipeline_on": False,
                "pipeline_depth": 0}
        if self._stats_fn is not None:
            base.update(self._stats_fn())
        return base

    def _backend_telemetry(self) -> dict:
        b = self._backend
        if b is None:
            return {"caps": {}, "caches": {}}
        tel = getattr(b, "telemetry", None)
        if callable(tel):
            try:
                out = tel()
                return {"caps": dict(out.get("caps", {})),
                        "caches": dict(out.get("caches", {}))}
            except Exception:
                pass   # a backend's telemetry must never fail a poll
        return {"caps": {"backend": type(b).__name__,
                         "chips": int(getattr(b, "chips", 0) or 0)},
                "caches": {}}

    def _proc_counters(self) -> dict:
        out = {}
        for key, ((hname, hlabels),
                  (mname, mlabels)) in _PROC_HIT_COUNTERS.items():
            h = self._reg.peek(hname, **hlabels)
            m = self._reg.peek(mname, **mlabels)
            if h is None and m is None:
                continue
            out[key] = [int(h or 0), int(m or 0)]
        ph = pm = None
        for f in _PAGE_FIELDS:
            h = self._reg.peek("dbx_page_pool_hits_total", field=f)
            m = self._reg.peek("dbx_page_pool_misses_total", field=f)
            if h is not None or m is not None:
                ph = (ph or 0) + int(h or 0)
                pm = (pm or 0) + int(m or 0)
        if ph is not None:
            out["page_pool"] = [ph, pm or 0]
        return out

    def _jobs_per_s(self, now: float, jobs: int) -> float:
        """Windowed completion rate, computed worker-side so the frame
        is self-contained (see RATE_WINDOW_S)."""
        ring = self._rate_ring
        ring.append((now, jobs))
        t_lo, j_lo = ring[0]
        for t, j in ring:
            if now - t <= self.RATE_WINDOW_S:
                t_lo, j_lo = t, j
                break
        if now - t_lo <= 0:
            return 0.0
        return max(jobs - j_lo, 0) / (now - t_lo)

    def frame(self, now: float | None = None) -> dict:
        """One full telemetry frame (the ``telemetry_json`` payload)."""
        now = time.time() if now is None else now
        return self._build_frame(now, self._worker_stats(),
                                 self._backend_telemetry())

    def _build_frame(self, now: float, ws: dict, bt: dict) -> dict:
        with self._lock:
            self._seq += 1
            seq = self._seq
        cm = (self._costmodel.frame()
              if self._stages_scope == "proc" or self._costmodel_own
              else {})
        frame = {
            "v": 1,
            "gen": self.gen,
            "pid": os.getpid(),
            "proc_id": _PROC_TOKEN,
            "scope": self._stages_scope,
            "seq": seq,
            "t": round(now, 3),
            "uptime_s": round(now - self._t0, 3),
            "busy": int(ws["busy"]),
            "inflight": int(ws["inflight"]),
            "pipeline": {"on": bool(ws["pipeline_on"]),
                         "depth": int(ws["pipeline_depth"])},
            "jobs_completed": int(ws["jobs_completed"]),
            "completions_dropped": int(ws["completions_dropped"]),
            "polls": int(ws["polls"]),
            "jobs_per_s": round(self._jobs_per_s(
                now, int(ws["jobs_completed"])), 4),
            "caps": bt["caps"],
            "caches": bt["caches"],
            "proc": self._proc_counters(),
            "stages": self._stages.snapshot(),
        }
        if cm:
            # Only when residuals exist — a drift-silent worker's frame
            # carries zero extra wire bytes (the dirty-bit budget).
            frame["costmodel"] = cm
        return frame

    @staticmethod
    def _fingerprint(ws: dict, bt: dict, stage_version: int,
                     cm_version: int = 0) -> tuple:
        """The change detector behind the dirty bit: worker counters +
        stage-stat version + cost-model residual version + cache
        residency. Deliberately EXCLUDES the poll count (every poll
        polls — counting it as change would defeat the dirty bit) and
        wall-clock-derived fields."""
        return (ws["jobs_completed"], ws["completions_dropped"],
                ws["busy"], ws["inflight"], stage_version, cm_version,
                json.dumps(bt["caches"], sort_keys=True, default=str))

    def take_frame_json(self, now: float | None = None) -> str:
        """The poll hook: a canonical-JSON frame when dirty or the
        heartbeat elapsed — rate-floored at ``DBX_FLEET_FRAME_MIN_S`` —
        else ``""`` (zero wire cost). The worker and backend stats are
        sampled ONCE and shared by the fingerprint and the frame — this
        runs on the poll path, inside the <=5% telemetry-overhead
        budget. The caller re-marks with :meth:`remark_dirty` when the
        poll RPC fails."""
        now = time.time() if now is None else now
        with self._lock:
            # Rate floor FIRST, before any stats are sampled: on a
            # saturated fleet every poll is dirty, and this early exit
            # is what keeps the suppressed-poll path at ~a lock acquire
            # (the <=5% overhead budget's real guardian).
            if now - self._last_sent < frame_min_s():
                return ""
        ws = self._worker_stats()
        bt = self._backend_telemetry()
        fp = self._fingerprint(ws, bt, self._stages.version,
                               self._costmodel.version)
        hb = heartbeat_s()
        with self._lock:
            if (fp == self._last_fingerprint
                    and now - self._last_sent < hb):
                return ""
        payload = json.dumps(self._build_frame(now, ws, bt),
                             sort_keys=True,
                             separators=(",", ":"), default=str)
        with self._lock:
            # Double-checked under the second acquisition: a racing
            # caller (only the control thread calls this in the worker,
            # but the class makes no such assumption) that committed the
            # same fingerprint meanwhile wins; this frame stays unsent.
            if (fp == self._last_fingerprint
                    and now - self._last_sent < hb):
                return ""
            self._last_fingerprint = fp
            self._last_sent = now
        self._c_frames.inc()
        self._c_bytes.inc(len(payload))
        return payload

    def remark_dirty(self) -> None:
        """The drained frame never reached the dispatcher (RPC failure):
        resend on the next successful poll — the schedule registry's
        ``remark_dirty`` twin."""
        with self._lock:
            self._last_fingerprint = None


# ---------------------------------------------------------------------------
# Dispatcher side: the fleet view
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("frame", "last_seen", "flagged")

    def __init__(self, frame: dict, last_seen: float):
        self.frame = frame
        self.last_seen = last_seen
        self.flagged: set = set()    # stages already counted as straggler


def _frame_order(frame: dict) -> tuple:
    """Cross-generation precedence: wall stamp then generation id (a
    total order — merge outcome independent of arrival order)."""
    return (float(frame.get("t", 0.0)), str(frame.get("gen", "")))


def _finite(x) -> float:
    """``float(x)``, rejecting NaN/Infinity — Python's json.loads parses
    bare NaN tokens, a NaN would defeat ``_frame_order`` (every
    comparison False) and re-serialize as invalid JSON on /fleet.json."""
    v = float(x)
    if not math.isfinite(v):
        raise ValueError(f"non-finite frame value {x!r}")
    return v


#: Every frame key this build knows how to read. Anything else is a
#: FUTURE field from a newer worker (the mixed-fleet rollout case):
#: skipped and counted, never a malformed frame — forward compat is
#: what let this build's own ``costmodel`` key roll out.
_KNOWN_FRAME_KEYS = frozenset({
    "v", "gen", "pid", "proc_id", "scope", "seq", "t", "uptime_s",
    "busy", "inflight", "pipeline", "jobs_completed",
    "completions_dropped", "polls", "jobs_per_s", "caps", "caches",
    "proc", "stages", "costmodel"})


def _sanitize_frame(frame: dict) -> dict:
    """Coerce a decoded frame's typed fields AT INGEST, so one
    JSON-valid frame with an ill-typed or non-finite field (a hostile
    or buggy worker's ``"busy": "yes"`` or ``"jobs_per_s": NaN``) lands
    in the malformed path instead of being adopted and poisoning every
    later :meth:`FleetView.snapshot` — the "malformed frames teach
    nothing, never an RPC error" contract applies to types, not just
    JSON syntax. Raises (caught by the caller) on anything
    uncoercible. Keys outside ``_KNOWN_FRAME_KEYS`` (a NEWER worker's
    fields) are skipped-and-counted, not errors."""
    out = dict(frame)
    unknown = sorted(str(k) for k in frame if k not in _KNOWN_FRAME_KEYS)
    if unknown:
        out["unknown_fields"] = unknown
    out["gen"] = str(frame["gen"])
    out["pid"] = int(frame.get("pid", 0))
    out["proc_id"] = str(frame.get("proc_id", ""))
    out["scope"] = str(frame.get("scope", "proc"))
    out["seq"] = int(frame.get("seq", 0))
    out["t"] = _finite(frame.get("t", 0.0))
    out["uptime_s"] = _finite(frame.get("uptime_s", 0.0))
    for k in ("busy", "inflight", "jobs_completed",
              "completions_dropped", "polls"):
        out[k] = int(frame.get(k, 0))
    out["jobs_per_s"] = _finite(frame.get("jobs_per_s", 0.0))
    for k in ("pipeline", "caps", "caches", "proc"):
        out[k] = dict(frame.get(k) or {})
    stages = {}
    for s, st in dict(frame.get("stages") or {}).items():
        st = dict(st)
        stages[str(s)] = {
            "n": int(st.get("n", 0)),
            "sum_s": _finite(st.get("sum_s", 0.0)),
            "ewma_s": _finite(st.get("ewma_s", 0.0)),
            "buckets": [int(c) for c in st.get("buckets", [])],
        }
    out["stages"] = stages
    cm = frame.get("costmodel")
    if cm:
        cm = dict(cm)
        out["costmodel"] = {
            "n": int(cm.get("n", 0)),
            "ewma": _finite(cm.get("ewma", 0.0)),
            "buckets": [int(c) for c in cm.get("buckets", [])],
            "blowouts": int(cm.get("blowouts", 0)),
        }
    else:
        out.pop("costmodel", None)
    return out


def _hist_quantile(buckets: list, q: float) -> float:
    """Quantile estimate over per-bucket counts with the shared
    STAGE_BUCKETS_S bounds — the registry Histogram's ONE interpolation
    (`registry.histogram_quantile`), on the wire form (no tracked max,
    so the overflow bucket caps at the last finite bound)."""
    return histogram_quantile(buckets, STAGE_BUCKETS_S, q)


class FleetView:
    """The dispatcher's staleness-bounded merged view of worker state.

    Entries are keyed by worker id and superseded by frame precedence
    (same generation: higher ``seq``; across generations: higher wall
    stamp, ties to generation id) — a deterministic total order, so the
    merged view is independent of frame arrival order. ``snapshot`` is
    a pure function of (retained frames, now): it mutates nothing.

    Staleness: a worker whose newest frame is older than the bound
    (``DBX_FLEET_STALE_S``; dispatcher clock) is flagged ``stale`` and
    excluded from fleet rollups; :meth:`prune` (called from the
    dispatcher's maintenance loop beside the peer prune) evicts entries
    older than 3x the bound, and :meth:`forget` drops a pruned peer's
    entry immediately.
    """

    EVICT_MULTIPLE = 3.0

    def __init__(self, *, registry=None, stale_s_override: float | None = None,
                 clock=time.monotonic):
        self._reg = registry or get_registry()
        self._clock = clock
        self._stale_override = stale_s_override
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        # Worker-label buckets whose per-worker gauges were set by the
        # last collect() — the removal set for evicted/forgotten workers
        # (a dead series must not serve its last value forever).
        self._gauge_buckets: set = set()
        # (clock stamp, snapshot) from the last collect(): GetStats
        # reuses it instead of building the full merged view twice per
        # call (summaries() already ran the collector).
        self._last_collect: tuple | None = None
        self._frame_sizes: collections.deque = collections.deque(
            maxlen=4096)
        # SLO burn ring: fixed-width time buckets of (ok, breach) counts
        # covering the largest burn window.
        self._slo_buckets: collections.deque = collections.deque(
            maxlen=int(max(SLO_WINDOWS.values()) / _SLO_BUCKET_S) + 1)
        self._c_frames = {
            o: self._reg.counter("dbx_fleet_frames_total",
                                 help="telemetry frames received, by "
                                      "outcome",
                                 outcome=o)
            for o in ("ok", "superseded", "malformed")}
        self._c_evicted = self._reg.counter(
            "dbx_fleet_workers_evicted_total",
            help="fleet-view entries evicted for staleness")
        self._c_unknown = self._reg.counter(
            "dbx_fleet_frame_unknown_fields_total",
            help="frame fields this build did not recognize (newer "
                 "workers in a mixed fleet) — skipped, not malformed")
        self._c_straggler = {
            s: self._reg.counter("dbx_fleet_straggler_flags_total",
                                 help="workers newly flagged as stage "
                                      "stragglers (EWMA > fleet p95)",
                                 stage=s)
            for s in TELEMETRY_STAGES}
        self._c_slo_burn = {
            w: self._reg.counter("dbx_fleet_slo_burn_total",
                                 help="scrapes that found the queue-wait "
                                      "SLO breach fraction over this "
                                      "window above DBX_FLEET_SLO_BURN",
                                 window=w)
            for w in SLO_WINDOWS}

    def _stale_bound(self) -> float:
        return (self._stale_override if self._stale_override is not None
                else stale_s())

    # -- ingest ------------------------------------------------------------

    def update(self, worker_id: str, frame_json: str) -> bool:
        """Merge one worker's frame (the RequestJobs gossip leg).
        Malformed payloads teach nothing — counted, never an RPC error.
        Returns True when the frame was adopted."""
        if not frame_json:
            return False
        try:
            frame = json.loads(frame_json)
            if not isinstance(frame, dict) or "gen" not in frame:
                raise ValueError("not a telemetry frame")
            frame = _sanitize_frame(frame)
        except (ValueError, TypeError, AttributeError, KeyError,
                OverflowError):   # int(Infinity) overflows, not ValueErrors
            self._c_frames["malformed"].inc()
            return False
        now = self._clock()
        with self._lock:
            self._frame_sizes.append(len(frame_json))
            cur = self._entries.get(worker_id)
            if cur is not None:
                if frame.get("gen") == cur.frame.get("gen"):
                    newer = (int(frame.get("seq", 0))
                             > int(cur.frame.get("seq", 0)))
                else:
                    # Cross-generation wall-stamp precedence — with one
                    # escape hatch: a live restarted worker whose clock
                    # stepped BACKWARD across the restart must not be
                    # wedged behind its dead generation. Once the
                    # retained entry is itself past the staleness bound,
                    # any differing-generation frame supersedes it (the
                    # old gen stopped gossiping; the new one is talking
                    # right now).
                    newer = (_frame_order(frame) > _frame_order(cur.frame)
                             or now - cur.last_seen > self._stale_bound())
                if not newer:
                    self._c_frames["superseded"].inc()
                    return False
                cur.frame = frame
                cur.last_seen = now
            else:
                self._entries[worker_id] = _Entry(frame, now)
        self._c_frames["ok"].inc()
        unknown = frame.get("unknown_fields")
        if unknown:
            self._c_unknown.inc(len(unknown))
        return True

    def forget(self, worker_id: str) -> None:
        """Drop a pruned peer's entry (the dispatcher's peer-prune path
        — silence already proved the worker gone)."""
        with self._lock:
            self._entries.pop(worker_id, None)

    def prune(self) -> list[str]:
        """Evict entries whose frame age passed ``EVICT_MULTIPLE`` x the
        staleness bound; returns the evicted worker ids. Called from the
        dispatcher's maintenance loop beside the peer prune (a stale
        entry survives flagged until then — visible decay, then gone)."""
        cutoff = self._clock() - self.EVICT_MULTIPLE * self._stale_bound()
        with self._lock:
            dead = [wid for wid, e in self._entries.items()
                    if e.last_seen < cutoff]
            for wid in dead:
                del self._entries[wid]
        if dead:
            self._c_evicted.inc(len(dead))
        return dead

    def observe_slo(self, breach: bool) -> None:
        """One queue-wait SLO observation (the per-tenant burn
        pair's fleet-wide feed) into the burn-window ring."""
        now = self._clock()
        bucket = int(now / _SLO_BUCKET_S)
        with self._lock:
            if not self._slo_buckets or self._slo_buckets[-1][0] != bucket:
                self._slo_buckets.append([bucket, 0, 0])
            self._slo_buckets[-1][2 if breach else 1] += 1

    def frame_sizes(self) -> list[int]:
        """Recent received-frame byte sizes (bounded) — the bench's
        ``frame_bytes_p50`` instrument."""
        with self._lock:
            return list(self._frame_sizes)

    # -- the merged view ---------------------------------------------------

    def _copy_entries(self) -> dict[str, tuple[dict, float]]:
        with self._lock:
            return {wid: (e.frame, e.last_seen)
                    for wid, e in self._entries.items()}

    @staticmethod
    def _dedupe_by_pid(frames: list[tuple[str, dict]]) -> list[dict]:
        """One frame per process for process-scope data (stage stats
        and cache hit counters are shared by co-hosted workers): per
        process keep the frame with the largest monotone stage
        population (ties to worker id — deterministic). The process key
        is the frame's host/boot-unique ``proc_id`` token — bare OS
        pids collide across hosts (containers all run pid 1), and a
        pid-keyed dedupe would collapse a multi-host fleet's stats into
        one worker's stream; pid stays the fallback for frames predating
        the token. Frames whose ``scope`` is ``worker`` carry their OWN
        stage stream (probe-injected) and pass through undeduped."""
        own: list[tuple[str, dict]] = []
        best: dict = {}
        for wid, f in frames:
            if f.get("scope") == "worker":
                own.append((wid, f))
                continue
            proc = f.get("proc_id") or f"pid:{f.get('pid', 0)}"
            total = sum(st.get("n", 0)
                        for st in f.get("stages", {}).values())
            key = (total, wid)
            if proc not in best or key > best[proc][0]:
                best[proc] = (key, f)
        return ([f for _, f in sorted(own)]
                + [v[1] for _, v in sorted(
                    best.items(), key=lambda kv: str(kv[0]))])

    def _slo_snapshot(self, now: float) -> dict:
        with self._lock:
            buckets = [list(b) for b in self._slo_buckets]
        nb = int(now / _SLO_BUCKET_S)
        out = {}
        for name, win in sorted(SLO_WINDOWS.items()):
            lo = nb - int(win / _SLO_BUCKET_S)
            ok = sum(b[1] for b in buckets if b[0] > lo)
            breach = sum(b[2] for b in buckets if b[0] > lo)
            total = ok + breach
            out[name] = {"ok": ok, "breach": breach,
                         "burn_rate": round(breach / total, 6)
                         if total else 0.0}
        return out

    def snapshot(self, now: float | None = None) -> dict:
        """The merged fleet document (``/fleet.json``, GetStats
        ``obs_json``'s ``dbx_fleet``, `dbxtop`'s feed). Pure function of
        the retained frames + ``now`` — mutates nothing, so arrival
        order can never leak into the bytes."""
        now = self._clock() if now is None else now
        bound = self._stale_bound()
        entries = self._copy_entries()
        workers: dict = {}
        live: list[tuple[str, dict]] = []
        for wid in sorted(entries):
            frame, last_seen = entries[wid]
            age = max(now - last_seen, 0.0)
            is_stale = age > bound
            if not is_stale:
                live.append((wid, frame))
            workers[wid] = {
                "gen": str(frame.get("gen", "")),
                "pid": int(frame.get("pid", 0)),
                "proc_id": str(frame.get("proc_id", "")),
                "scope": str(frame.get("scope", "proc")),
                "seq": int(frame.get("seq", 0)),
                "age_s": round(age, 3),
                "stale": is_stale,
                "busy": int(frame.get("busy", 0)),
                "inflight": int(frame.get("inflight", 0)),
                "pipeline": frame.get("pipeline", {}),
                "jobs_completed": int(frame.get("jobs_completed", 0)),
                "completions_dropped": int(
                    frame.get("completions_dropped", 0)),
                "jobs_per_s": float(frame.get("jobs_per_s", 0.0)),
                "uptime_s": float(frame.get("uptime_s", 0.0)),
                "caps": frame.get("caps", {}),
                "caches": frame.get("caches", {}),
                "stages": {
                    s: {"n": int(st.get("n", 0)),
                        "sum_s": round(float(st.get("sum_s", 0.0)), 9),
                        "ewma_s": float(st.get("ewma_s", 0.0)),
                        "p50_s": round(_hist_quantile(
                            st.get("buckets", []), 0.5), 9)}
                    for s, st in frame.get("stages", {}).items()},
                "stragglers": [],
            }
            cm = frame.get("costmodel")
            if cm:
                workers[wid]["costmodel"] = {
                    "n": int(cm.get("n", 0)),
                    "ewma": float(cm.get("ewma", 0.0)),
                    "p50": round(costmodel_mod.residual_quantile(
                        cm.get("buckets", []), 0.5), 4),
                    "blowouts": int(cm.get("blowouts", 0)),
                }
            unknown = frame.get("unknown_fields")
            if unknown:
                workers[wid]["unknown_fields"] = len(unknown)
        # Fleet-wide merged stage histograms: process-scope stats fold
        # once per process (co-hosted workers share one span stream;
        # keyed by the host-unique proc_id token, not bare pid).
        merged = {s: {"n": 0, "sum_s": 0.0,
                      "buckets": [0] * (len(STAGE_BUCKETS_S) + 1)}
                  for s in TELEMETRY_STAGES}
        deduped = self._dedupe_by_pid(live)
        for f in deduped:
            for s, st in f.get("stages", {}).items():
                m = merged.get(s)
                if m is None:
                    continue
                m["n"] += int(st.get("n", 0))
                m["sum_s"] += float(st.get("sum_s", 0.0))
                for i, c in enumerate(st.get("buckets", [])):
                    if i < len(m["buckets"]):
                        m["buckets"][i] += int(c)
        fleet_stages = {}
        for s, m in merged.items():
            fleet_stages[s] = {
                "n": m["n"], "sum_s": round(m["sum_s"], 9),
                "p50_s": round(_hist_quantile(m["buckets"], 0.5), 9),
                "p95_s": round(_hist_quantile(m["buckets"], 0.95), 9)}
        # Straggler flags: per-stage EWMA above the fleet p95, with a
        # real population behind the p95 (the rule, applied live).
        if len(live) >= MIN_STRAGGLER_WORKERS:
            for wid, frame in live:
                for s in TELEMETRY_STAGES:
                    fs = fleet_stages[s]
                    if fs["n"] < MIN_STRAGGLER_OBS or fs["p95_s"] <= 0:
                        continue
                    ewma = float(frame.get("stages", {})
                                 .get(s, {}).get("ewma_s", 0.0))
                    if ewma > fs["p95_s"] * STRAGGLER_MARGIN:
                        workers[wid]["stragglers"].append(s)
        # Cache hit ratios, over the same per-process dedupe (the hit
        # counters share the stage streams' co-hosting semantics).
        agg: dict = {}
        for f in deduped:
            for key, hm in f.get("proc", {}).items():
                try:
                    h, m = int(hm[0]), int(hm[1])
                except (TypeError, ValueError, IndexError):
                    continue
                a = agg.setdefault(key, [0, 0])
                a[0] += h
                a[1] += m
        hit_ratio = {key: round(h / (h + m), 6)
                     for key, (h, m) in sorted(agg.items()) if h + m}
        # Cost-model residual fold: exact histogram-count sums over the
        # same per-process dedupe (the accumulator is process-scoped,
        # like the stage stats).
        cm_n = cm_blow = 0
        cm_buckets = [0] * (len(costmodel_mod.RESIDUAL_BUCKETS_LOG2) + 1)
        for f in deduped:
            cm = f.get("costmodel")
            if not cm:
                continue
            cm_n += int(cm.get("n", 0))
            cm_blow += int(cm.get("blowouts", 0))
            for i, c in enumerate(cm.get("buckets", [])):
                if i < len(cm_buckets):
                    cm_buckets[i] += int(c)
        fleet_costmodel = {
            "n": cm_n,
            "blowouts": cm_blow,
            "residual_p50": round(costmodel_mod.residual_quantile(
                cm_buckets, 0.5), 4),
            "residual_p95": round(costmodel_mod.residual_quantile(
                cm_buckets, 0.95), 4),
        }
        return {
            "stale_s": bound,
            "workers": workers,
            "fleet": {
                "workers": len(workers),
                "live": len(live),
                "stale": len(workers) - len(live),
                "busy": sum(1 for _, f in live if f.get("busy")),
                "jobs_per_s": round(sum(
                    float(f.get("jobs_per_s", 0.0))
                    for _, f in live), 4),
                "jobs_completed": sum(
                    int(f.get("jobs_completed", 0)) for _, f in live),
                "stages": fleet_stages,
                "costmodel": fleet_costmodel,
                "cache_hit_ratio": hit_ratio,
                "slo": self._slo_snapshot(now),
            },
        }

    def placement_view(self, now: float | None = None) -> dict:
        """Score-table export (round 20): the per-worker scoring inputs
        the decision plane's placement table is built from, and nothing
        else — staleness/straggler verdicts (score-down signals, never
        exclusion), frame age, and the cache-residency digest sketch as
        a flat prefix tuple. Derived from :meth:`snapshot` so the
        straggler rule (fleet p95 with a real population behind it)
        stays single-sourced; runs on the plane's daemon tick, never
        under the take lock."""
        out: dict = {}
        for wid, w in self.snapshot(now)["workers"].items():
            topk = (w.get("caches") or {}).get("panel_topk") or ()
            out[wid] = {
                "stale": bool(w.get("stale")),
                "age_s": float(w.get("age_s", 0.0)),
                "stragglers": tuple(w.get("stragglers") or ()),
                "resident": tuple(
                    str(e.get("d", "")) for e in topk
                    if isinstance(e, dict) and e.get("d")),
            }
        return out

    def collected_snapshot(self, max_age_s: float = 1.0):
        """The snapshot the last :meth:`collect` built, when fresh —
        ``None`` otherwise. GetStats' ``obs_json`` path runs the
        registry collectors (which snapshot) and then needs the merged
        document itself; this hands it the one just built instead of
        folding the whole fleet twice per call."""
        with self._lock:
            if self._last_collect is None:
                return None
            t, snap = self._last_collect
        if self._clock() - t > max_age_s:
            return None
        return snap

    # -- metric surface ----------------------------------------------------

    def collect(self, reg) -> None:
        """Scrape-time gauges + transition counters (called from the
        dispatcher's registry collector). Worker identity on labels
        goes through the bounded ``worker_bucket`` map — the
        obs-cardinality sanctioned source."""
        from ..sched.tenancy import worker_bucket

        snap = self.snapshot()
        fleet = snap["fleet"]
        reg.gauge("dbx_fleet_workers",
                  help="fleet-view entries by staleness state",
                  state="live").set(fleet["live"])
        reg.gauge("dbx_fleet_workers", state="stale").set(fleet["stale"])
        reg.gauge("dbx_fleet_jobs_per_sec",
                  help="sum of live workers' self-reported completion "
                       "rates").set(fleet["jobs_per_s"])
        reg.gauge("dbx_fleet_cost_drift_p95",
                  help="fleet-merged |log2 measured/predicted| stage "
                       "cost residual p95").set(
            snap["fleet"]["costmodel"]["residual_p95"])
        buckets: set = set()
        drift_buckets: set = set()
        for wid, w in snap["workers"].items():
            b = worker_bucket(wid)
            buckets.add(b)
            reg.gauge("dbx_fleet_worker_jobs_per_sec",
                      help="per-worker self-reported completion rate "
                           "(bounded worker-bucket labels)",
                      worker=b).set(w["jobs_per_s"])
            reg.gauge("dbx_fleet_worker_stale",
                      help="1 when the worker bucket's newest frame is "
                           "older than DBX_FLEET_STALE_S",
                      worker=b).set(1 if w["stale"] else 0)
            cm = w.get("costmodel")
            if cm:
                drift_buckets.add(b)
                reg.gauge("dbx_fleet_worker_cost_drift",
                          help="per-worker cost-model residual EWMA "
                               "(log2 measured/predicted; bounded "
                               "worker-bucket labels)",
                          worker=b).set(cm["ewma"])
        with self._lock:
            dead = self._gauge_buckets - buckets
            dead_drift = (self._gauge_buckets | buckets) - drift_buckets
            self._gauge_buckets = buckets
            self._last_collect = (self._clock(), snap)
        for b in dead:
            # Evicted/forgotten workers' series go away with them — the
            # per-worker-gauge lifecycle discipline (worker.py's run()
            # finally is the precedent). A bucket is only removed when
            # NO retained worker maps to it ("other" stays while shared).
            reg.remove_child("dbx_fleet_worker_jobs_per_sec", worker=b)
            reg.remove_child("dbx_fleet_worker_stale", worker=b)
        for b in dead_drift:
            reg.remove_child("dbx_fleet_worker_cost_drift", worker=b)
        # Straggler TRANSITIONS (not levels): count a worker's stage
        # flag once per episode, cleared when it drops below the p95.
        with self._lock:
            for wid, w in snap["workers"].items():
                e = self._entries.get(wid)
                if e is None:
                    continue
                cur = set(w["stragglers"])
                for s in cur - e.flagged:
                    self._c_straggler[s].inc()
                e.flagged = cur
        for win, st in fleet["slo"].items():
            if (st["ok"] + st["breach"]
                    and st["burn_rate"] > slo_burn_threshold()):
                self._c_slo_burn[win].inc()


# ---------------------------------------------------------------------------
# dbxtop: the live fleet table
# ---------------------------------------------------------------------------


def _fetch_fleet(url: str) -> dict:
    import urllib.request

    from .timeline import stats_url

    with urllib.request.urlopen(stats_url(url, doc="fleet.json"),
                                timeout=10) as resp:
        return json.loads(resp.read())


def render_text(snap: dict) -> str:
    """The `dbxtop` table: fleet rollup header + one row per worker."""
    from .timeline import _fmt_s, _table

    fleet = snap.get("fleet", {})
    out = [
        f"fleet: {fleet.get('live', 0)} live / {fleet.get('stale', 0)} "
        f"stale worker(s), {fleet.get('busy', 0)} busy, "
        f"{fleet.get('jobs_per_s', 0.0):.1f} jobs/s, "
        f"{fleet.get('jobs_completed', 0)} completed "
        f"(staleness bound {snap.get('stale_s', 0.0):.1f}s)"]
    stages = fleet.get("stages", {})
    srows = [(s, st["n"], _fmt_s(st["sum_s"]), _fmt_s(st["p50_s"]),
              _fmt_s(st["p95_s"]))
             for s, st in stages.items() if st.get("n")]
    if srows:
        out.append("")
        out.append("== fleet stage costs (merged histograms) ==")
        out.append(_table(srows, ("stage", "n", "total", "p50", "p95")))
    cm = fleet.get("costmodel", {})
    if cm.get("n"):
        out.append(
            f"cost-model drift: {cm['n']} obs, residual p50 "
            f"{cm.get('residual_p50', 0.0):+.2f} / p95 "
            f"{cm.get('residual_p95', 0.0):+.2f} log2, "
            f"{cm.get('blowouts', 0)} blowout(s)")
    ratios = fleet.get("cache_hit_ratio", {})
    if ratios:
        out.append("cache hit ratios: " + ", ".join(
            f"{k} {100 * v:.1f}%" for k, v in ratios.items()))
    slo = fleet.get("slo", {})
    if any(st["ok"] + st["breach"] for st in slo.values()):
        out.append("queue-wait SLO burn: " + ", ".join(
            f"{w} {100 * st['burn_rate']:.1f}% "
            f"({st['breach']}/{st['ok'] + st['breach']})"
            for w, st in sorted(slo.items())))
    rows = []
    for wid, w in snap.get("workers", {}).items():
        flags = []
        if w.get("stale"):
            flags.append("STALE")
        flags += [f"straggler:{s}" for s in w.get("stragglers", [])]
        st = w.get("stages", {})

        def ew(s):
            v = st.get(s, {}).get("ewma_s", 0.0)
            return _fmt_s(v) if v else "-"

        caches = w.get("caches", {})
        cache_mb = sum(
            v for k, v in _iter_bytes(caches)) / (1024 * 1024)
        wcm = w.get("costmodel") or {}
        if w.get("unknown_fields"):
            flags.append(f"+{w['unknown_fields']}fields")
        rows.append((
            wid, w.get("gen", "")[:6],
            "busy" if w.get("busy") else "idle",
            f"{w.get('jobs_per_s', 0.0):.1f}",
            w.get("jobs_completed", 0),
            ew("decode"), ew("compile"), ew("execute"), ew("d2h"),
            f"{wcm['ewma']:+.2f}" if wcm.get("n") else "-",
            str(wcm.get("blowouts", 0)) if wcm.get("n") else "-",
            f"{cache_mb:.1f}", f"{w.get('age_s', 0.0):.1f}s",
            " ".join(flags) or "-"))
    out.append("")
    out.append(_table(rows, ("worker", "gen", "state", "jobs/s", "done",
                             "decode", "compile", "execute", "d2h",
                             "drift", "blow", "cacheMB", "age",
                             "flags")))
    return "\n".join(out) + "\n"


def _iter_bytes(node, prefix=""):
    """Yield every ``*_bytes``/``bytes`` leaf of a residency dict."""
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from _iter_bytes(v, f"{prefix}{k}.")
            elif isinstance(v, (int, float)) and (
                    k == "bytes" or k.endswith("_bytes")):
                yield f"{prefix}{k}", float(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs.fleet",
        description="dbxtop: live fleet telemetry table from a "
                    "dispatcher's /fleet.json")
    ap.add_argument("--url", required=True,
                    help="dispatcher metrics endpoint "
                         "(http://host:port, or the full /fleet.json)")
    ap.add_argument("--watch", type=float, default=None, metavar="SECS",
                    help="refresh every SECS seconds until interrupted "
                         "(one-shot when omitted)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)
    try:
        while True:
            snap = _fetch_fleet(args.url)
            if args.format == "json":
                body = json.dumps(snap, indent=2, sort_keys=True) + "\n"
            else:
                body = render_text(snap)
            if args.watch is not None:
                # Clear + home, like top: the table repaints in place.
                sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(body)
            sys.stdout.flush()
            if args.watch is None:
                return 0
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0
    except OSError as e:
        print(f"obs.fleet: cannot reach {args.url}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
