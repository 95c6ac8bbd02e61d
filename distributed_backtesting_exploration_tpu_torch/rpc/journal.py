"""Crash-durable job journal: append-only JSONL with replay (the
reference's ``rpc/journal.py``).

The dispatcher appends every queue transition to a JSONL journal and
fsyncs it; a restarting dispatcher, and the result read path
(:mod:`.aggregate`), replay it: ``pending = enqueued - completed -
failed``. Leases are deliberately not journaled: a lease lost to a crash
leaves the job pending again, and completion is idempotent, so replay
needs no lease bookkeeping. The lines are the reference's, so each
package's dispatcher restores from the other's journal.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

from ..obs import get_registry


class JournalCorruptError(ValueError):
    """An interior (non-tail) journal line failed to decode."""


@dataclass
class ReplayState:
    """Result of replaying a journal file."""

    jobs: dict = field(default_factory=dict)        # id -> job record (dict)
    completed: set = field(default_factory=set)     # job ids
    failed: set = field(default_factory=set)        # job ids
    corrupt_lines: int = 0                          # interior decode failures
    total_lines: int = 0                            # non-empty lines seen
    # Streaming append chain: extended-panel digest -> its `delta` event
    # (parent digest, base length, delta payload). Restarts rebuild
    # extended panels by replaying the chain instead of re-journaling
    # O(T) payloads per append (last event per digest wins — the splice
    # is deterministic, so duplicates are identical anyway).
    deltas: dict = field(default_factory=dict)
    # Raw complete/fail records in order, first occurrence per id — they
    # carry worker ids and failure reasons that the id sets drop, and
    # compaction must not erase that post-mortem record.
    terminal_events: list = field(default_factory=list)

    @property
    def pending(self) -> list[str]:
        done = self.completed | self.failed
        return [j for j in self.jobs if j not in done]


class Journal:
    """Append-only JSONL journal; thread-safe; no-op when ``path`` is None.

    ``fsync=False`` trades durability for speed, for harnesses that run
    many short-lived journals and simulate crashes by copying the file at
    append boundaries. Production paths never pass it.

    ``crash_hook`` is such a harness's fork point: when set, it is
    called as ``hook("pre", event, rec)`` before the record reaches the
    file and ``hook("post", event, rec)`` after the write lands —
    i.e. on either side of the exact boundary a real crash would
    partition. Called OUTSIDE ``self._lock`` (and every dispatcher
    journal append already happens outside ``JobQueue._lock``), so the
    hook may safely replay the file and interrogate live queue state.
    """

    def __init__(self, path: str | None, *, fsync: bool = True):
        self._path = path
        self._fsync = fsync
        self.crash_hook = None
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8") if path else None
        # fsync dominates append latency and gates every durable queue
        # transition, so it gets its own histogram. Resolved once; zero
        # cost on the no-op journal.
        reg = get_registry()
        self._h_append = reg.histogram(
            "dbx_journal_append_seconds",
            help="journal append wall (write + flush + fsync)")
        self._h_fsync = reg.histogram(
            "dbx_journal_fsync_seconds", help="journal fsync wall alone")
        self._c_appends = reg.counter(
            "dbx_journal_appends_total", help="journal records appended")

    @property
    def enabled(self) -> bool:
        """False for the no-op journal — callers can skip building
        expensive payloads (``journal_form`` b64-encodes the OHLCV block)."""
        return self._fh is not None

    def append(self, event: str, **payload) -> None:
        if self._fh is None:
            return
        rec = {"ev": event, **payload}
        line = json.dumps(rec, separators=(",", ":"))
        hook = self.crash_hook
        if hook is not None:
            hook("pre", event, rec)
        t0 = time.perf_counter()
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            t1 = time.perf_counter()
            if self._fsync:
                os.fsync(self._fh.fileno())
        t2 = time.perf_counter()
        if hook is not None:
            hook("post", event, rec)
        self._h_fsync.observe(t2 - t1)
        self._h_append.observe(t2 - t0)
        self._c_appends.inc()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # Journal keys that carry bulk payloads; dropped from terminal jobs'
    # records at compaction (identity/grid/path survive for restart dedupe
    # and result aggregation).
    _PAYLOAD_KEYS = ("ohlcv_b64", "ohlcv2_b64")

    @staticmethod
    def compact(path: str) -> tuple[int, int]:
        """Rewrite the journal to its live state; returns (before, after)
        line counts.

        An append-only journal grows without bound across restarts and
        replay cost grows with it. Compaction keeps exactly what recovery
        and tooling need: full enqueue records for PENDING jobs, slim
        enqueue records (payload fields dropped) for completed/failed jobs
        — their ids keep completions idempotent, their paths keep restart
        dedupe working, and their grids keep ``rpc.aggregate`` joins alive
        — plus the original terminal complete/fail records (first
        occurrence per id: worker ids and failure reasons survive for
        post-mortems). A journal with nothing to shrink (no terminal jobs,
        no duplicate/torn/corrupt lines) is left untouched. The rewrite is
        atomic (tmp + fsync + rename), and MUST run before an appending
        :class:`Journal` opens the path (the open handle would keep
        writing to the replaced inode).
        """
        if not path or not os.path.exists(path):
            return (0, 0)
        state = Journal.replay(path)
        before = state.total_lines
        if (not state.completed and not state.failed
                and not state.corrupt_lines
                and before == len(state.jobs) + len(state.deltas)):
            return (before, before)   # nothing to shrink: skip the rewrite
        done = state.completed | state.failed
        tmp = f"{path}.compact.{os.getpid()}"
        after = 0
        with open(tmp, "w", encoding="utf-8") as fh:
            # Append-chain links first (each ~ΔT bars): materializing a
            # restored append job needs its chain, and chain nodes can be
            # shared by several jobs (or by future appends), so they
            # survive compaction whole.
            for rec in state.deltas.values():
                fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
                after += 1
            # Streaming chain ROOTS — parent digests that are not
            # themselves rebuilt by a delta event — must keep their
            # payloads even on completed jobs: every extended panel in
            # the chain re-materializes from a root + the ΔT deltas, so
            # slimming a root would orphan the whole chain after restart.
            chain_roots = ({r.get("pdig") for r in state.deltas.values()}
                           - set(state.deltas))
            # Scenario BASES the same way: a pending scenario job
            # re-materializes after restart by regenerating from its
            # base digest (the blob store starts empty), walking
            # scenario-of-scenario specs down to a payload-carrying
            # record — slimming that record's inline payload would fail
            # every pending scenario job at first take.
            by_digest: dict = {}
            for r in state.jobs.values():
                for dkey in ("pdig", "pdig2"):
                    if r.get(dkey):
                        by_digest.setdefault(r[dkey], r)
            scn_roots: set = set()
            stack = [state.jobs[j].get("scn", {}).get("base")
                     for j in state.pending if state.jobs[j].get("scn")]
            seen: set = set()
            while stack:
                d = stack.pop()
                if not d or d in seen:
                    continue
                seen.add(d)
                r = by_digest.get(d)
                if r is None:
                    continue
                if r.get("scn") and r.get("pdig") == d:
                    stack.append(r["scn"].get("base"))
                else:
                    scn_roots.add(d)
            protected = chain_roots | scn_roots
            for jid, rec in state.jobs.items():
                if jid in done:
                    keep = set()
                    if rec.get("pdig") in protected:
                        keep.add("ohlcv_b64")
                    if rec.get("pdig2") in protected:
                        keep.add("ohlcv2_b64")
                    rec = {k: v for k, v in rec.items()
                           if k not in Journal._PAYLOAD_KEYS or k in keep}
                fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
                after += 1
            for rec in state.terminal_events:
                fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
                after += 1
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return (before, after)

    @staticmethod
    def replay(path: str, *, strict: bool = True) -> ReplayState:
        """Reconstruct queue state from a journal file (missing file = empty).

        Tolerates a torn *final* line (crash mid-append) — that is the only
        corruption an append+fsync discipline can produce. An undecodable
        interior line means real damage (a silently dropped ``enqueue`` would
        lose a job from recovery), so it raises :class:`JournalCorruptError`
        by default; ``strict=False`` instead counts it loudly in
        ``ReplayState.corrupt_lines``.
        """
        state = ReplayState()
        if not path or not os.path.exists(path):
            return state
        with open(path, encoding="utf-8") as fh:
            lines = [ln.strip() for ln in fh]
        while lines and not lines[-1]:
            lines.pop()
        for i, line in enumerate(lines):
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if i == len(lines) - 1:
                    continue  # torn tail write from a crash
                if strict:
                    raise JournalCorruptError(
                        f"{path}:{i + 1}: undecodable interior journal "
                        f"line ({e}); refusing to silently drop state"
                    ) from e
                state.corrupt_lines += 1
                continue
            state.total_lines += 1
            ev = rec.get("ev")
            if ev == "enqueue":
                state.jobs[rec["id"]] = rec
            elif ev == "digest":
                # Content-address stamp from a file-backed job's first
                # materialization: merged into the enqueue record, so a
                # restart keeps dispatching by the same digest and
                # compaction folds the stamp into the rewritten enqueue
                # line (no separate event survives).
                job = state.jobs.get(rec.get("id"))
                if job is not None:
                    for k in ("pdig", "pdig2"):
                        if rec.get(k):
                            job[k] = rec[k]
            elif ev == "delta":
                # Streaming append-chain link (AppendBars): keyed by the
                # EXTENDED panel's digest so materialization can walk
                # parents back to a journaled payload source.
                if rec.get("ndig"):
                    state.deltas[rec["ndig"]] = rec
            elif ev == "complete":
                if rec["id"] not in state.completed:
                    state.terminal_events.append(rec)
                state.completed.add(rec["id"])
            elif ev == "fail":
                if rec["id"] not in state.failed:
                    state.terminal_events.append(rec)
                state.failed.add(rec["id"])
        return state
