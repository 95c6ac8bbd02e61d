"""Flight recorder: anomaly-triggered black-box capture.

The fleet's steady-state telemetry (metrics registry, span ring,
FleetView gossip) is rich but EPHEMERAL: the 512-entry span ring rolls
over in seconds at floor throughput, gauges move on, and by the time an
operator looks at an incident the evidence is gone. This module is the
black-box counterpart — always armed, near-zero cost until a trigger
fires, and on a trigger it snapshots everything the process knows into
one content-addressed JSON bundle:

- the full span ring (``trace.recent_spans()``),
- every registered source's scrape (metrics text, FleetView snapshot,
  queue/journal stats, schedule registry, lockdep edge table — sources
  are keyed callables registered by the owning subsystem),
- a stitched fleet timeline (``timeline.summarize_spans``) plus the
  end-to-end timeline + critical path of the offending job(s).

Trigger catalogue (the ``_KINDS`` tuple): job failure, SLO queue-wait
breach, straggler flag, requeue-expiry, lockdep violation, cost-model
residual blowout, worker collect failure, explicit ``TriggerDump``
admin RPC, SIGUSR2, sustained placement regret (obs/decisions.py).

Operational posture, in order of importance:

1. **Never block the hot path.** ``trigger()`` takes the recorder's own
   small lock for a dedupe-map probe and a deque append, then returns;
   the capture itself (scrapes + JSON + fsync-free atomic write) runs
   on a daemon thread. No source is scraped under the recorder lock —
   each source callable takes only its own scrape-path locks, which is
   exactly what the lockdep gate (``DBX_LOCKDEP=1``) verifies in tests.
2. **Never fail a job.** Unwritable ``DBX_FLIGHT_DIR``, a crashing
   source, a full disk — all degrade to a counter
   (``dbx_flight_dropped_total``) and a log line.
3. **Bounded everything.** Bundles are retention-bounded by count and
   size (``DBX_FLIGHT_MAX_BUNDLES`` / ``DBX_FLIGHT_MAX_MB``, oldest
   evicted first); a crash loop dedupes by (kind, subject) within
   ``DBX_FLIGHT_DEDUPE_S`` to ONE bundle; the pending queue is 8 deep;
   the dedupe map is capped.

Bundles are content-addressed: the filename embeds a blake2b digest of
the serialized bundle, so a byte-identical capture (same ring, same
sources) is free, and ``dbxflight diff`` can compare two bundles by
name alone. ``dbxflight`` (console script) lists/inspects/diffs bundles
and renders embedded timelines via ``obs.timeline``'s renderer.
"""

from __future__ import annotations

import argparse
import collections
import difflib
import hashlib
import json
import logging
import os
import queue
import sys
import threading
import time

from . import timeline, trace
from .registry import get_registry

log = logging.getLogger("dbx.flight")

#: The trigger catalogue. ``trigger_bucket`` folds anything else into
#: "other" so the ``trigger`` metric label (and bundle filenames) stay
#: bounded — the obs-cardinality lint sanctions this call the same way
#: it sanctions ``tenant_bucket``.
_KINDS = ("job_fail", "slo_breach", "straggler", "requeue_expired",
          "lockdep", "residual", "collect_fail", "admin", "signal",
          "regret")

#: Lock-free trigger inbox for hostile acquire-site contexts. The
#: lockdep violation hook fires while the offending locks are still
#: held — any ``threading.Lock`` taken there (the recorder's, the
#: registry's) would stitch the recorder into the caller's lock-order
#: graph and distort the very edge table being reported.
#: ``queue.SimpleQueue`` is C-level and untouched by lockdep's
#: ``threading.Lock`` factory patch, so ``trigger_deferred`` acquires
#: nothing; items drain through the normal ``trigger()`` path on the
#: capture thread (or a ``flush()``) where no caller locks are held.
_DEFERRED: "queue.SimpleQueue" = queue.SimpleQueue()


def trigger_bucket(kind: str) -> str:
    """Bounded bucket for a trigger kind: one of ``_KINDS`` or
    ``"other"``. Used for metric labels and bundle filenames."""
    return kind if kind in _KINDS else "other"


def known_kinds() -> frozenset:
    """The bundle-kind vocabulary THIS binary understands — the
    ``dbxflight`` CLI's forward-compat gate (the skip-and-count
    seam extended to kinds): a bundle written by a newer binary with a
    kind outside this set is skipped-and-counted by ``list`` and
    rendered generically by ``show``, never a crash."""
    return frozenset(_KINDS + ("other",))


def flight_dir() -> str:
    """``DBX_FLIGHT_DIR``: where bundles land. Unset/empty means the
    recorder counts triggers but writes nothing (safe default — no
    surprise files)."""
    return os.environ.get("DBX_FLIGHT_DIR", "")


def max_mb() -> float:
    """``DBX_FLIGHT_MAX_MB`` (default 64): total bundle bytes kept;
    oldest evicted first."""
    try:
        return max(float(os.environ.get("DBX_FLIGHT_MAX_MB", 64.0)), 0.0)
    except ValueError:
        return 64.0


def max_bundles() -> int:
    """``DBX_FLIGHT_MAX_BUNDLES`` (default 32): bundle count kept;
    oldest evicted first."""
    try:
        return max(int(os.environ.get("DBX_FLIGHT_MAX_BUNDLES", 32)), 1)
    except ValueError:
        return 32


def dedupe_s() -> float:
    """``DBX_FLIGHT_DEDUPE_S`` (default 60): window within which a
    repeated (kind, subject) trigger is dropped — a crash loop yields
    one bundle, not hundreds."""
    try:
        return max(float(os.environ.get("DBX_FLIGHT_DEDUPE_S", 60.0)), 0.0)
    except ValueError:
        return 60.0


class FlightRecorder:
    """Always-armed bounded black-box. One per process in practice
    (module singleton below); tests construct their own against a fresh
    registry."""

    QUEUE_MAX = 8           # pending triggers; beyond this they drop
    _RECENT_MAX = 256       # dedupe map bound (hostile subject storm)

    def __init__(self, *, registry=None, clock=time.monotonic):
        self._reg = registry or get_registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._pending = collections.deque()
        self._recent: dict[tuple[str, str], float] = {}
        self._sources: dict[str, object] = {}
        self._thread = None
        self._wake = threading.Event()
        self._capturing = False
        self._closed = False
        self._c_bundles = self._reg.counter(
            "dbx_flight_bundles_total",
            help="flight bundles written to DBX_FLIGHT_DIR")
        self._c_dropped = {
            r: self._reg.counter(
                "dbx_flight_dropped_total",
                help="triggers that produced no new bundle, by reason",
                reason=r)
            for r in ("dedupe", "disabled", "queue_full", "error")}
        self._c_triggers = {
            b: self._reg.counter(
                "dbx_flight_triggers_total",
                help="flight triggers fired, by bounded trigger bucket",
                trigger=b)
            for b in _KINDS + ("other",)}

    # -- sources ------------------------------------------------------

    def add_source(self, name: str, fn) -> None:
        """Register a keyed zero-arg scrape callable (last-wins, the
        registry ``add_collector`` discipline). The callable runs on
        the capture thread and may take only its own scrape-path locks."""
        with self._lock:
            self._sources[str(name)] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(str(name), None)

    # -- triggering ---------------------------------------------------

    def trigger(self, kind: str, subject: str = "", **detail) -> None:
        """Fire-and-forget: count, dedupe, enqueue for async capture.
        Never raises, never blocks beyond one small-lock probe."""
        try:
            self._trigger(kind, subject, detail)
        except Exception:
            log.exception("flight trigger failed (kind=%s)", kind)

    def _trigger(self, kind: str, subject: str, detail: dict) -> None:
        self._c_triggers[trigger_bucket(kind)].inc()
        now = self._clock()
        drop = None
        with self._lock:
            if self._closed:
                drop = "disabled"
            else:
                key = (str(kind), str(subject))
                stamp = self._recent.get(key)
                if stamp is not None and now - stamp < dedupe_s():
                    drop = "dedupe"
                elif not flight_dir():
                    drop = "disabled"
                elif len(self._pending) >= self.QUEUE_MAX:
                    drop = "queue_full"
                else:
                    self._remember(key, now)
                    self._pending.append(
                        (str(kind), str(subject), dict(detail)))
                    self._ensure_thread()
        if drop is not None:
            self._c_dropped[drop].inc()
        else:
            self._wake.set()

    def _remember(self, key, now) -> None:
        # Called under self._lock.
        if len(self._recent) >= self._RECENT_MAX:
            for old in sorted(self._recent,
                              key=self._recent.get)[:self._RECENT_MAX // 2]:
                del self._recent[old]
        self._recent[key] = now

    def capture_now(self, kind: str, subject: str = "",
                    detail: dict | None = None) -> str | None:
        """Synchronous capture (admin RPC / SIGUSR2 / tests): bypasses
        dedupe and the queue, returns the bundle path or None."""
        self._c_triggers[trigger_bucket(kind)].inc()
        if not flight_dir():
            self._c_dropped["disabled"].inc()
            return None
        return self._capture(str(kind), str(subject), dict(detail or {}))

    def _drain_deferred(self) -> None:
        """Route deferred (lock-free inbox) triggers through the normal
        path. Runs only where no caller locks are held: the capture
        thread's loop and ``flush``. The inbox is process-global, so
        only the process singleton drains it — a test-private recorder
        must not adopt incidents deposited for (or by) another
        generation."""
        if _recorder is not self:
            return
        while True:
            try:
                kind, subject, detail = _DEFERRED.get_nowait()
            except queue.Empty:
                return
            self.trigger(kind, subject, **detail)

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for pending async captures to land (test helper)."""
        self._drain_deferred()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending and not self._capturing:
                    return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._pending.clear()
        self._wake.set()

    # -- capture thread ----------------------------------------------

    def _ensure_thread(self) -> None:
        # Called under self._lock.
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="dbx-flight", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=5.0)
            self._wake.clear()
            self._drain_deferred()
            while True:
                with self._lock:
                    if self._closed:
                        return
                    if not self._pending:
                        break
                    kind, subject, detail = self._pending.popleft()
                    self._capturing = True
                try:
                    self._capture(kind, subject, detail)
                finally:
                    with self._lock:
                        self._capturing = False

    # -- bundle assembly ---------------------------------------------

    def _capture(self, kind: str, subject: str,
                 detail: dict) -> str | None:
        try:
            doc = self._build_bundle(kind, subject, detail)
            return self._write_bundle(doc)
        except Exception:
            log.exception("flight capture failed (kind=%s)", kind)
            self._c_dropped["error"].inc()
            return None

    def _build_bundle(self, kind: str, subject: str,
                      detail: dict) -> dict:
        spans = trace.recent_spans()
        with self._lock:
            sources = dict(self._sources)
        scraped = {}
        for name, fn in sorted(sources.items()):
            try:
                scraped[name] = fn()
            except Exception as e:  # a broken source must not void the rest
                scraped[name] = {"error": repr(e)}
        doc = {
            "v": 1,
            "kind": str(kind),
            "subject": str(subject),
            "detail": detail,
            "t_wall": time.time(),
            "pid": os.getpid(),
            "spans": spans,
            "sources": scraped,
        }
        try:
            doc["timeline"] = timeline.summarize_spans(spans)
        except Exception as e:
            doc["timeline"] = {"error": repr(e)}
        doc["jobs"] = self._job_timelines(
            spans, str(detail.get("job") or subject))
        return doc

    @staticmethod
    def _job_timelines(spans, job: str) -> list:
        """End-to-end stitch of the offending job(s): reconstructed
        timelines whose job id (or trace id prefix) matches, with the
        per-stage critical path — no torn-job filter, a failed job's
        partial timeline is exactly the evidence we want."""
        if not job:
            return []
        out = []
        try:
            for tid, tl in sorted(timeline.reconstruct(spans).items()):
                if tl.job_id != job and not tid.startswith(job):
                    continue
                t0, t1 = tl.window
                out.append({
                    "trace_id": tid,
                    "job_id": tl.job_id,
                    "worker": tl.worker,
                    "t0": t0,
                    "dur_s": max(t1 - t0, 0.0),
                    "stages": timeline.critical_path(tl),
                    "spans": [dict(s) for s in tl.spans],
                })
        except Exception as e:
            return [{"error": repr(e)}]
        return out

    def _write_bundle(self, doc: dict) -> str | None:
        d = flight_dir()
        payload = json.dumps(doc, sort_keys=True, default=str)
        digest = hashlib.blake2b(
            payload.encode(), digest_size=8).hexdigest()
        stamp = time.strftime("%Y%m%dT%H%M%S",
                              time.gmtime(doc.get("t_wall", 0.0)))
        name = f"{stamp}-{trigger_bucket(doc['kind'])}-{digest}.json"
        path = os.path.join(d, name)
        try:
            os.makedirs(d, exist_ok=True)
            if os.path.exists(path):
                # Content-addressed: identical capture already on disk.
                self._c_dropped["dedupe"].inc()
                return path
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
            self._c_bundles.inc()
            self._retain(d)
            log.info("flight bundle %s (%s/%s)", name, doc["kind"],
                     doc["subject"])
            return path
        except OSError:
            log.exception("flight dir %r unwritable; dropping bundle", d)
            self._c_dropped["error"].inc()
            return None

    @staticmethod
    def _retain(d: str) -> None:
        """Evict oldest bundles past the count/size caps. Best-effort —
        racing evictors (two processes, one dir) tolerate ENOENT."""
        try:
            entries = []
            for name in os.listdir(d):
                if not name.endswith(".json"):
                    continue
                p = os.path.join(d, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, name, st.st_size, p))
            entries.sort()
            total = sum(e[2] for e in entries)
            cap_b = max_mb() * 1024 * 1024
            cap_n = max_bundles()
            while entries and (len(entries) > cap_n or total > cap_b):
                _, _, size, p = entries.pop(0)
                try:
                    os.remove(p)
                except OSError:
                    pass
                total -= size
        except OSError:
            pass


# -- module singleton (the get_registry() discipline) -----------------

_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def reset(registry=None) -> None:
    """Replace the singleton (test isolation: bind a fresh recorder to
    a given registry so counter assertions don't see prior state)."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = FlightRecorder(registry=registry) \
            if registry is not None else None
    while True:  # stale deferred triggers die with the generation
        try:
            _DEFERRED.get_nowait()
        except queue.Empty:
            break


def trigger(kind: str, subject: str = "", **detail) -> None:
    """Module-level convenience: fire the process recorder."""
    get_recorder().trigger(kind, subject, **detail)


def trigger_deferred(kind: str, subject: str = "", **detail) -> None:
    """Lock-free trigger for callers holding instrumented locks (the
    lockdep violation hook). See the ``_DEFERRED`` note."""
    _DEFERRED.put((str(kind), str(subject), dict(detail)))


def capture_now(kind: str, subject: str = "",
                detail: dict | None = None) -> str | None:
    return get_recorder().capture_now(kind, subject, detail)


def add_source(name: str, fn) -> None:
    get_recorder().add_source(name, fn)


def remove_source(name: str) -> None:
    get_recorder().remove_source(name)


# -- dbxflight CLI ----------------------------------------------------

def _load_bundle(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _bundle_paths(d: str) -> list:
    try:
        names = [n for n in os.listdir(d) if n.endswith(".json")]
    except OSError:
        return []
    return [os.path.join(d, n) for n in sorted(names)]


def _fmt_row(cols, widths) -> str:
    return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths)).rstrip()


def _cmd_list(d: str) -> int:
    paths = _bundle_paths(d)
    if not paths:
        print(f"dbxflight: no bundles in {d or '(no dir)'}",
              file=sys.stderr)
        return 2
    rows = []
    unknown = 0
    for p in paths:
        try:
            doc = _load_bundle(p)
        except (OSError, ValueError):
            rows.append((os.path.basename(p), "?", "?", "?", "?"))
            continue
        if doc.get("kind", "?") not in known_kinds():
            # Forward-compat: a newer binary's bundle kind. Skip and
            # count — an old CLI must not crash on (or misrender) a
            # schema it predates.
            unknown += 1
            continue
        rows.append((os.path.basename(p), doc.get("kind", "?"),
                     doc.get("subject", "") or "-",
                     len(doc.get("spans", ())),
                     len(doc.get("jobs", ()))))
    if unknown:
        print(f"dbxflight: skipped {unknown} bundle(s) with unknown "
              "kind (written by a newer binary?)", file=sys.stderr)
    if not rows:
        print(f"dbxflight: no listable bundles in {d}", file=sys.stderr)
        return 2
    header = ("bundle", "kind", "subject", "spans", "jobs")
    widths = [max(len(str(r[i])) for r in rows + [header])
              for i in range(len(header))]
    print(_fmt_row(header, widths))
    for r in rows:
        print(_fmt_row(r, widths))
    return 0


def _resolve(d: str, ref: str) -> str | None:
    """A bundle ref: a path, a basename, or a unique name prefix."""
    if os.path.isfile(ref):
        return ref
    hits = [p for p in _bundle_paths(d)
            if os.path.basename(p).startswith(ref)]
    return hits[0] if len(hits) == 1 else None


def _cmd_show(d: str, ref: str, as_json: bool) -> int:
    path = _resolve(d, ref)
    if path is None:
        print(f"dbxflight: no unique bundle matches {ref!r}",
              file=sys.stderr)
        return 2
    try:
        doc = _load_bundle(path)
    except (OSError, ValueError) as e:
        print(f"dbxflight: unreadable bundle {path}: {e}",
              file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    if doc.get("kind", "?") not in known_kinds():
        # The kind seam, show-side: render only the generic envelope —
        # the kind-specific body belongs to a newer schema.
        print(f"bundle   {os.path.basename(path)}")
        print(f"kind     {doc.get('kind', '?')} (unknown to this "
              "binary; use --json for the raw bundle)")
        return 0
    print(f"bundle   {os.path.basename(path)}")
    print(f"kind     {doc.get('kind', '?')}  subject "
          f"{doc.get('subject', '') or '-'}")
    print(f"captured {time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime(float(doc.get('t_wall', 0.0))))}Z"
          f"  pid {doc.get('pid', '?')}  spans {len(doc.get('spans', ()))}")
    if doc.get("detail"):
        print(f"detail   {json.dumps(doc['detail'], sort_keys=True)}")
    sources = doc.get("sources", {})
    if sources:
        print("sources  " + ", ".join(sorted(sources)))
    for job in doc.get("jobs", ()):
        if "error" in job:
            continue
        stages = ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                           sorted(job.get("stages", {}).items()))
        print(f"\njob {job.get('job_id') or job.get('trace_id', '?')}"
              f"  worker={job.get('worker') or '-'}"
              f"  dur={job.get('dur_s', 0.0) * 1e3:.1f}ms")
        if stages:
            print(f"  critical path: {stages}")
    summary = doc.get("timeline")
    if isinstance(summary, dict) and "error" not in summary \
            and summary.get("jobs"):
        print()
        try:
            print(timeline.render_text(summary))
        except Exception as e:
            print(f"(timeline render failed: {e!r})")
    return 0


def _source_text(doc: dict, name: str) -> str:
    v = doc.get("sources", {}).get(name)
    if isinstance(v, str):
        return v
    return json.dumps(v, indent=2, sort_keys=True, default=str)


def _cmd_diff(d: str, ref_a: str, ref_b: str) -> int:
    pa, pb = _resolve(d, ref_a), _resolve(d, ref_b)
    if pa is None or pb is None:
        missing = ref_a if pa is None else ref_b
        print(f"dbxflight: no unique bundle matches {missing!r}",
              file=sys.stderr)
        return 2
    try:
        a, b = _load_bundle(pa), _load_bundle(pb)
    except (OSError, ValueError) as e:
        print(f"dbxflight: unreadable bundle: {e}", file=sys.stderr)
        return 2
    for key in ("kind", "subject", "t_wall", "pid"):
        va, vb = a.get(key), b.get(key)
        marker = " " if va == vb else "*"
        print(f"{marker} {key:8s} {va!r} -> {vb!r}")
    print(f"  spans    {len(a.get('spans', ()))} -> "
          f"{len(b.get('spans', ()))}")
    names = sorted(set(a.get("sources", {})) | set(b.get("sources", {})))
    for name in names:
        in_a, in_b = (name in a.get("sources", {}),
                      name in b.get("sources", {}))
        if not (in_a and in_b):
            print(f"* source {name}: "
                  f"{'present' if in_a else 'absent'} -> "
                  f"{'present' if in_b else 'absent'}")
    if "metrics" in a.get("sources", {}) and \
            "metrics" in b.get("sources", {}):
        diff = difflib.unified_diff(
            _source_text(a, "metrics").splitlines(),
            _source_text(b, "metrics").splitlines(),
            fromfile=os.path.basename(pa), tofile=os.path.basename(pb),
            lineterm="", n=0)
        lines = list(diff)
        if lines:
            print()
            print("\n".join(lines))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dbxflight",
        description="list/inspect/diff flight-recorder bundles")
    ap.add_argument("--dir", default=None,
                    help="bundle dir (default: $DBX_FLIGHT_DIR)")
    sub = ap.add_subparsers(dest="cmd")
    sub.add_parser("list", help="list bundles")
    p_show = sub.add_parser("show", help="inspect one bundle")
    p_show.add_argument("bundle", help="path, basename, or name prefix")
    p_show.add_argument("--json", action="store_true",
                        help="dump the raw bundle JSON")
    p_diff = sub.add_parser("diff", help="compare two bundles")
    p_diff.add_argument("bundle_a")
    p_diff.add_argument("bundle_b")
    args = ap.parse_args(argv)
    d = args.dir if args.dir is not None else flight_dir()
    if args.cmd in (None, "list"):
        return _cmd_list(d)
    if args.cmd == "show":
        return _cmd_show(d, args.bundle, args.json)
    return _cmd_diff(d, args.bundle_a, args.bundle_b)


if __name__ == "__main__":
    sys.exit(main())
