"""Versioned, journal-style substrate schedule registry (the autotuner's
persistence half — DESIGN.md "Substrate autotuner & shared compile cache").

A copy of the reference's ``tune/registry.py``: the journal and the wire
JSON are byte-identical to its, so that one fleet serves workers of both
packages (``tests/test_torch_tune.py`` holds the two to the same bytes).
Entries are keyed by platform, and the port's platform strings
(``torch-cuda-sm90``, ``torch-cpu``) never name a JAX backend, so neither
kind of worker adopts the other's winners.

Every performance substrate in the fleet used to be a hand-set env knob
(``DBX_EPILOGUE`` scan block, per-family ``DBX_*_TABLE``, ``DBX_LANES_CAP``,
``DBX_PAGE_BARS``). The TVM discipline (PAPERS.md) is: measure the schedule
cross-product once per shape class, persist the winner, serve it everywhere.
This module is the "persist" and "everywhere" parts:

- an entry maps ``(kernel family, shape-bucket, backend platform)`` to a
  tuned substrate tuple (``{"epilogue": "scan:32", "table_sma": "inline",
  "lanes_cap": "256", ...}``) plus its measurement provenance
  (trial count, best wall);
- persistence is a JSONL *journal* under ``DBX_SCHEDULE_DIR`` (file
  ``schedule.v1.jsonl``): appends only, later entries win on replay, a
  corrupt line is skipped AND counted, never fatal. The serialization is
  canonical (sorted keys, fixed separators, no timestamps), so the same
  measurements always produce the same registry bytes — restart- and
  diff-stable by construction;
- ``to_json``/``merge_json`` are the fleet wire format: workers push
  newly-tuned entries up on ``JobsRequest.schedule_json``; the dispatcher
  merges them into its fleet registry and ships the union back on
  ``StatsReply.schedule_json`` — the Nth worker inherits the first
  worker's tuning without re-measuring. Merge conflicts resolve
  deterministically (more trials wins; ties by canonical line order), so
  every peer converges to the same registry regardless of arrival order.

The CONSUMPTION side lives in :mod:`..ops.fused` (the tuned-schedule
resolution layer: explicit arg > env > tuned schedule > hardcoded default)
and :mod:`..rpc.compute` (group-submit consultation). Nothing here ever
raises into a job: a missing/corrupt/unwritable registry degrades to
today's hardcoded defaults.
"""

from __future__ import annotations

import json
import os
import threading

from .. import obs

SCHEMA_VERSION = 1
_FILENAME = f"schedule.v{SCHEMA_VERSION}.jsonl"

# Bound on journal entries queued while the file is unopenable (kept for
# the next flush's retry; beyond this the oldest drop — an unwritable
# path already degrades to memory-only, the queue must stay bounded).
_MAX_PENDING_IO = 1024

# The substrate keys a schedule entry may carry. Unknown keys are dropped
# at record/merge time so a newer peer's extended schema cannot poison an
# older consumer's resolution chain (it simply will not see the new knob).
KNOWN_SUBSTRATES = frozenset(
    {"epilogue", "lanes_cap", "page_bars"}
    | {f"table_{fam}" for fam in ("sma", "boll", "mom", "don", "obv")})

# Shape buckets are CLAMPED power-of-two rails so the set of possible
# bucket strings is finite — bounded enough to ride a metric label
# (dbxlint obs-cardinality: raw dims would mint one series per shape).
_T_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
              65536)
_P_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def _rail(v: int, rail: tuple) -> int:
    for r in rail:
        if v <= r:
            return r
    return rail[-1]


def shape_bucket(n_bars: int, n_combos: int) -> str:
    """Bounded shape-bucket label for ``(T, P)``: each dimension rounds up
    to a clamped power-of-two rail (``t64..t65536`` x ``p128..p4096`` —
    at most ``len(_T_BUCKETS) * len(_P_BUCKETS)`` distinct strings ever).
    Kernels compile and tune per padded shape class, not per exact shape,
    so this is also the right granularity for schedule reuse."""
    return (f"t{_rail(max(int(n_bars), 1), _T_BUCKETS)}"
            f"_p{_rail(max(int(n_combos), 1), _P_BUCKETS)}")


# The rows rail of :func:`group_bucket`.
_N_BUCKETS = tuple(2 ** i for i in range(3, 13))      # 8 .. 4096


def group_bucket(n_bars: int, n_combos: int, n_rows: int) -> str:
    """The port's bucket of a fused group: the reference's
    :func:`shape_bucket` of ``(T, P)`` and ``_n<rows>``, the rows one card
    sweeps rounded up on a power-of-two rail (``n8..n4096``). A tile's
    fastest CTA width moves with rows x ceil(P / width) against the card's
    SMs (the bench's ``autotune`` part (c)), so a winner measured on 32
    rows must not serve 500. Only entries under a ``torch-*`` platform
    carry it; the entry's journal and wire format stay the reference's."""
    return (f"{shape_bucket(n_bars, n_combos)}"
            f"_n{_rail(max(int(n_rows), 1), _N_BUCKETS)}")


def schedule_dir() -> str | None:
    """``DBX_SCHEDULE_DIR`` (read lazily, never at import): the directory
    holding the schedule journal, or None = in-memory only."""
    return os.environ.get("DBX_SCHEDULE_DIR") or None


def entry_line(entry: dict) -> str:
    """THE canonical serialization of one registry entry — a pure function
    of its content (sorted keys, fixed separators, no timestamps), so
    identical measurements produce identical registry bytes everywhere.
    Both the journal file and the fleet wire format are built from it."""
    return json.dumps(entry, sort_keys=True, separators=(",", ":"))


def _valid_entry(e) -> bool:
    if not isinstance(e, dict) or e.get("v") != SCHEMA_VERSION:
        return False
    if not (isinstance(e.get("family"), str)
            and isinstance(e.get("bucket"), str)
            and isinstance(e.get("platform"), str)):
        return False
    subs = e.get("substrates")
    if not isinstance(subs, dict) or not subs:
        return False
    return all(isinstance(k, str) and isinstance(v, str)
               for k, v in subs.items())


class ScheduleRegistry:
    """Thread-safe tuned-schedule map with an append-only JSONL journal.

    ``path`` is the journal file (None = memory-only). All file IO is
    best-effort: an unreadable journal loads what it can (corrupt lines
    counted in ``corrupt_entries``), an unwritable one degrades to
    memory-only — tuning must never fail a job.
    """

    def __init__(self, path: str | None = None,
                 registry: "obs.Registry | None" = None,
                 scope: str = "local"):
        self._lock = threading.Lock()
        # Journal IO never runs under ``_lock`` (dbxlint lock-blocking:
        # a slow append — NFS, a full disk retry — would stall every
        # lookup() on the worker submit hot path and every gossip
        # merge). Mutations enqueue their entry on ``_pending_io``
        # under ``_lock``; ``_flush_io`` drains it to the file under
        # the dedicated leaf ``_io_lock`` — which both serializes
        # appends and preserves journal order == mutation order (the
        # queue is filled in ``_lock`` order), so replay's later-wins
        # semantics still reconstruct the in-memory state.
        self._io_lock = threading.Lock()
        self._pending_io: list[dict] = []
        self.path = path
        self._entries: dict[tuple, dict] = {}
        self._dirty: set[tuple] = set()
        self.corrupt_entries = 0
        self.io_errors = 0
        reg = registry or obs.get_registry()
        # gauge_fn: the entry count is read at scrape time, so every
        # surface (/metrics, /stats.json, GetStats obs_json) sees the
        # live registry size without a write hook per record(). ``scope``
        # ({"local", "fleet"} — bounded) keeps a worker's registry and an
        # in-process dispatcher's fleet registry on separate series.
        reg.gauge_fn("dbx_schedule_registry_entries", lambda: len(self),
                     help="tuned (family, shape-bucket, platform) entries "
                          "resident in the schedule registry",
                     scope=scope)
        self._c_corrupt = reg.counter(
            "dbx_schedule_corrupt_entries_total",
            help="schedule journal/wire entries skipped as corrupt")
        if path:
            self._load(path)

    @classmethod
    def open_default(cls, registry: "obs.Registry | None" = None,
                     scope: str = "local") -> "ScheduleRegistry":
        """Registry at ``DBX_SCHEDULE_DIR`` (journal created lazily on the
        first record), or memory-only when the knob is unset."""
        d = schedule_dir()
        path = os.path.join(d, _FILENAME) if d else None
        return cls(path, registry=registry, scope=scope)

    # -- journal -----------------------------------------------------------

    def _load(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except FileNotFoundError:
            return
        except OSError:
            self.io_errors += 1
            return
        entries: list[dict] = []
        bad = 0
        for line in lines:
            if not line.strip():
                continue
            try:
                e = json.loads(line)
            except ValueError:
                e = None
            if e is None or not _valid_entry(e):
                bad += 1
                continue
            # Journal replay: later entries win (append-only semantics).
            entries.append(self._scrub(e))
        if bad:
            self.corrupt_entries += bad
            self._c_corrupt.inc(bad)
        # ONE lock hold for the whole replay merge (__init__-only today,
        # but a future reload path racing a gossip merge must not
        # interleave: a per-line lock would let an older journal line
        # land AFTER — and silently overwrite — a fresher merged entry).
        with self._lock:
            for e in entries:
                self._entries[self._key(e)] = e

    def _open_journal(self):
        """Open the journal for appending, OUTSIDE every lock; None on
        failure (memory-only degradation, never a raise)."""
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            return open(self.path, "a", encoding="utf-8")
        except OSError:
            self.io_errors += 1
            return None

    def _flush_io(self) -> None:
        """Drain ``_pending_io`` to the journal (constructor docstring:
        called after ``_lock`` is RELEASED, never nested inside it). A
        concurrent flusher holding ``_io_lock`` will drain this
        thread's enqueued entries too — the queue swap under ``_lock``
        is the only moment both locks are held (io -> lock order,
        acquisition-cheap on both sides). The file handle lives for ONE
        flush (O_APPEND, writes serialized by ``_io_lock``): no fd
        outlives the call, matching the pre-round-12 per-append cost
        profile without its under-lock open."""
        if not self.path:
            return   # memory-only registry: nothing is ever enqueued
        with self._lock:
            if not self._pending_io:
                return
        fh = self._open_journal()
        if fh is None:
            # Transient open failure: keep the queue for the next
            # flush's retry — clearing here would drop entries OTHER
            # threads just enqueued whose own flush would succeed.
            # Bounded (oldest dropped) so a permanently unwritable
            # path cannot grow it without limit.
            with self._lock:
                if len(self._pending_io) > _MAX_PENDING_IO:
                    del self._pending_io[:-_MAX_PENDING_IO]
            return
        failed = 0
        try:
            with self._io_lock:
                while True:
                    with self._lock:
                        if not self._pending_io:
                            break
                        batch = self._pending_io[:]
                        self._pending_io.clear()
                    try:
                        for e in batch:
                            fh.write(entry_line(e) + "\n")
                        fh.flush()
                    except OSError:
                        failed += 1
        finally:
            fh.close()
        if failed:
            # Counted outside both locks (io_errors is a best-effort
            # diagnostic, never guarded state): degrade, don't raise.
            self.io_errors += failed

    # -- core map ----------------------------------------------------------

    @staticmethod
    def _key(e: dict) -> tuple:
        return (e["family"], e["bucket"], e["platform"])

    @staticmethod
    def _scrub(e: dict) -> dict:
        subs = {k: v for k, v in e["substrates"].items()
                if k in KNOWN_SUBSTRATES}
        return {"v": SCHEMA_VERSION, "family": e["family"],
                "bucket": e["bucket"], "platform": e["platform"],
                "substrates": subs,
                "trials": int(e.get("trials", 0)),
                "best_us": (float(e["best_us"])
                            if e.get("best_us") is not None else None)}

    def lookup(self, family: str, bucket: str, platform: str
               ) -> dict | None:
        """The tuned substrate dict for the key, or None (copy — callers
        may not mutate registry state)."""
        with self._lock:
            e = self._entries.get((family, bucket, platform))
            return dict(e["substrates"]) if e else None

    def record(self, family: str, bucket: str, platform: str,
               substrates: dict, *, trials: int = 0,
               best_us: float | None = None) -> bool:
        """Persist a tuned winner (journal append + memory). Returns False
        when an identical entry is already resident (no journal growth on
        re-tuning the same answer)."""
        e = self._scrub({"family": family, "bucket": bucket,
                         "platform": platform,
                         "substrates": {k: str(v)
                                        for k, v in substrates.items()},
                         "trials": trials, "best_us": best_us})
        if not _valid_entry(e):
            return False
        with self._lock:
            key = self._key(e)
            if self._entries.get(key) == e:
                return False
            self._entries[key] = e
            self._dirty.add(key)
            if self.path:
                self._pending_io.append(e)
        self._flush_io()
        return True

    def entries(self) -> list[dict]:
        """Every resident entry in canonical (sorted-line) order."""
        with self._lock:
            out = [dict(e, substrates=dict(e["substrates"]))
                   for e in self._entries.values()]
        return sorted(out, key=entry_line)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- fleet exchange ----------------------------------------------------

    def to_json(self) -> str:
        """Canonical wire form of the whole registry (deterministic: the
        same entries serialize to the same bytes on every peer)."""
        return "[" + ",".join(entry_line(e) for e in self.entries()) + "]"

    def take_dirty_json(self) -> str:
        """Entries recorded/adopted since the last take, as wire JSON —
        empty string when clean (the worker's JobsRequest push: a clean
        poll adds zero wire bytes)."""
        with self._lock:
            if not self._dirty:
                return ""
            dirty = [self._entries[k] for k in self._dirty
                     if k in self._entries]
            self._dirty.clear()
        return "[" + ",".join(entry_line(e)
                              for e in sorted(dirty, key=entry_line)) + "]"

    def remark_dirty(self, payload: str) -> None:
        """Re-mark previously-taken wire entries as dirty (the push-retry
        path: a poll that drained ``take_dirty_json`` but never reached
        the dispatcher must not lose its entries from the gossip)."""
        try:
            items = json.loads(payload)
        except ValueError:
            return
        if not isinstance(items, list):
            return
        with self._lock:
            for e in items:
                if _valid_entry(e):
                    key = self._key(e)
                    if key in self._entries:
                        self._dirty.add(key)

    def merge_json(self, payload: str, *, mark_dirty: bool = False) -> int:
        """Merge a peer's wire JSON; returns entries adopted. Malformed
        payloads/entries are skipped and counted — a hostile or
        version-skewed peer can at worst teach nothing."""
        if not payload:
            return 0
        try:
            items = json.loads(payload)
        except ValueError:
            items = None
        if not isinstance(items, list):
            self.corrupt_entries += 1
            self._c_corrupt.inc()
            return 0
        adopted = 0
        for e in items:
            if not _valid_entry(e):
                self.corrupt_entries += 1
                self._c_corrupt.inc()
                continue
            if self._adopt(self._scrub(e), mark_dirty=mark_dirty):
                adopted += 1
        return adopted

    def _adopt(self, e: dict, *, mark_dirty: bool) -> bool:
        """Deterministic conflict resolution: an incoming entry replaces
        the resident one iff it measured MORE trials, or ties and sorts
        earlier in canonical line order — every peer applying the same
        rule converges to the same registry regardless of gossip order."""
        with self._lock:
            key = self._key(e)
            cur = self._entries.get(key)
            if cur is not None:
                if cur == e:
                    return False
                if e["trials"] < cur["trials"]:
                    return False
                if (e["trials"] == cur["trials"]
                        and entry_line(e) >= entry_line(cur)):
                    return False
            self._entries[key] = e
            if mark_dirty:
                self._dirty.add(key)
            if self.path:
                self._pending_io.append(e)
        self._flush_io()
        return True
