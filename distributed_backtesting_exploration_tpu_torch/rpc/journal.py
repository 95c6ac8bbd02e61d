"""Reader of the dispatcher's job journal (the reference's
``rpc/journal.py``, its replay half).

The dispatcher appends every queue transition to a JSONL journal; a
restarting dispatcher, and the result read path (:mod:`.aggregate`), replay
it: ``pending = enqueued - completed - failed``. The writer belongs with
the dispatcher; this module holds only what a reader needs.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


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
    # (last event per digest wins; the splice is deterministic).
    deltas: dict = field(default_factory=dict)
    # Raw complete/fail records in order, first occurrence per id: they
    # carry the worker ids and failure reasons that the id sets drop.
    terminal_events: list = field(default_factory=list)

    @property
    def pending(self) -> list[str]:
        done = self.completed | self.failed
        return [j for j in self.jobs if j not in done]


class Journal:
    """The journal's reader: :meth:`replay`."""

    @staticmethod
    def replay(path: str, *, strict: bool = True) -> ReplayState:
        """Reconstruct queue state from a journal file (missing file = empty).

        Tolerates a torn *final* line (a crash mid-append), the only
        corruption an append+fsync discipline can produce. An undecodable
        interior line means real damage, so it raises
        :class:`JournalCorruptError` by default; ``strict=False`` instead
        counts it in ``ReplayState.corrupt_lines``.
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
                # A content-address stamp, merged into the enqueue record.
                job = state.jobs.get(rec.get("id"))
                if job is not None:
                    for k in ("pdig", "pdig2"):
                        if rec.get(k):
                            job[k] = rec[k]
            elif ev == "delta":
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
