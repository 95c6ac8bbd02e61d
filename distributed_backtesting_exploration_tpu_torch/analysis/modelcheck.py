"""dbxmc: interleaving + crash-point model checker over the dispatcher's
journaled state machines.

The reference's ``analysis/modelcheck.py`` over the port's dispatcher.
dbxcert machine-checks the reference's NUMERICS contract; this module
checks the CONTROL-PLANE contract — the crash-recovery and scheduling
invariants federated dispatch leans on. It runs the port's REAL
``JobQueue`` / ``Journal`` / ``WfqScheduler`` / ``PanelStore`` code, never
an abstract model:

- :mod:`.schedules` enumerates distinct interleavings of per-thread op
  programs (enqueue / take / complete / requeue / append), pruning
  schedules equivalent under commutation of independent ops
  (DPOR-lite canonical forms); ``--depth > 0`` additionally preempts
  INSIDE ops at instrumented-lock acquire points via the lockdep seam;
- every journal append is a crash boundary: the ``Journal.crash_hook``
  seam fires on both sides of the write, where the checker replays the
  journal as a restarting dispatcher would and diffs the restored state
  against a canonical projection of the live queue;
- sampled boundaries fork a FULL crash replay — copy the journal
  (optionally ``Journal.compact`` it first), restore into a fresh
  ``JobQueue`` on the same substrate, then drive the restored queue to
  completion, checking the declared invariant table
  (:data:`INVARIANTS`) along the way;
- a violation is reported as a minimized, REPLAYABLE op script
  (greedy delta-debugging over the schedule, re-run deterministically)
  — `dbxmc --replay script.json` reproduces it exactly.

Exit codes mirror dbxcert: 0 clean / 1 violations / 2 config error.
Env knobs: ``DBX_MC_OPS`` (program size), ``DBX_MC_SEED``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np

from . import lockdep
from . import schedules as sched_mod
from .schedules import Op, make_op

# The declared invariant catalogue (``dbxmc --list-invariants`` prints
# this table). Adding
# an invariant = add a row here + a check in _Run/_fork that reports
# violations under the new name.
INVARIANTS = {
    "replay-integrity":
        "strict journal replay succeeds at every crash boundary "
        "(a torn line is legal only as the final record)",
    "journal-append-first":
        "every live registered job id is covered by a journaled enqueue "
        "record — the publish-side append-first discipline",
    "completion-durability":
        "journaled completions never LEAD live state (state completes "
        "first; the journal may lag — that window only re-runs a job "
        "idempotently)",
    "job-conservation":
        "journaled jobs partition exactly into pending/completed/failed; "
        "restore re-enqueues precisely the pending set",
    "exactly-once-completion":
        "completion outcomes are idempotent: first 'new', repeats 'dup', "
        "never-enqueued 'unknown' — live, and again after restore",
    "drained-monotonic":
        "`drained` is exactly 'no live work': never True while work is "
        "pending/leased/in-take, True after a full drain",
    "lane-fifo-consistency":
        "the state FIFO is empty between public calls (WFQ lanes own all "
        "pending work) and queue stats equal the op ledger",
    "quota-balance":
        "per-tenant in-flight quota charges equal the combos of currently "
        "leased jobs; zero once drained",
    "chain-reachability":
        "append-chain digests re-materialize after restore, including "
        "post-compaction (chain ROOT payloads survive slimming)",
    "scenario-base-reachability":
        "pending scenario jobs' base-digest chains reach a "
        "payload-carrying record, including post-compaction",
    "digest-soundness":
        "every delivered payload hashes to the job's journaled digest",
    "wedged":
        "a controlled (--depth) schedule stopped making progress — the "
        "runtime shape of a real deadlock",
}


@dataclasses.dataclass
class MCConfig:
    """One exploration's knobs (CLI flags map 1:1)."""

    ops: int = 12                # program size (total ops, ~)
    depth: int = 0               # intra-op preemption bound (0 = op-grain)
    seed: int = 0
    schedules: int = 500         # distinct schedules to explore
    substrate: str = "python"    # python | native
    lease_s: float = -1.0        # already-expired leases: requeue_expired
                                 # is deterministic on BOTH substrates
    crash_every: int = 3         # arm a full crash fork every N schedules
    fork_all: bool = False       # fork at every boundary (minimizer mode)
    max_violations: int = 3      # stop exploring after this many
    minimize: bool = True
    timeout_s: float = 20.0      # controlled-run wedge bound


class _Violation(Exception):
    """Internal control flow: first invariant violation aborts the
    schedule (the queue under test is in a state the invariant says is
    unreachable — further ops would only cascade)."""

    def __init__(self, invariant: str, detail: str):
        super().__init__(f"[{invariant}] {detail}")
        self.invariant = invariant
        self.detail = detail


def _panel_bytes(key: str, n_bars: int = 6) -> bytes:
    """Deterministic tiny DBX1 panel for job ``key`` (real wire bytes —
    append splices and digest checks parse them)."""
    from ..utils import data as data_mod

    base = 1.0 + (zlib.crc32(key.encode()) % 997) / 10.0
    close = base + 0.1 * np.arange(n_bars, dtype=np.float32)
    return data_mod.to_wire_bytes(data_mod.OHLCV(
        open=close - 0.05, high=close + 0.1, low=close - 0.1,
        close=close,
        volume=np.full(n_bars, 100.0, dtype=np.float32)))


class _Ledger:
    """The checker's own transition ledger — what the queue SHOULD hold,
    derived purely from op outcomes (never from queue internals)."""

    def __init__(self):
        self.enqueued: dict[str, tuple[str, int]] = {}  # id->(tenant,combos)
        self.completed: set[str] = set()
        self.failed: set[str] = set()
        self.leases: dict[str, str] = {}                # id -> worker
        self.taken: dict[str, list[str]] = {}           # worker -> open ids
        self.done_by: dict[str, list[str]] = {}         # worker -> completed
        self.deltas: list[str] = []                     # extended digests

    def pending(self) -> set[str]:
        return (set(self.enqueued) - self.completed - self.failed
                - set(self.leases))

    def lease_drop(self, jid: str) -> None:
        self.leases.pop(jid, None)
        for ids in self.taken.values():
            if jid in ids:
                ids.remove(jid)


class _Run:
    """One schedule executed against a fresh queue + journal."""

    def __init__(self, cfg: MCConfig, workdir: str, index: int,
                 fork_at: int | None, compact_fork: bool):
        from ..rpc.dispatcher import JobQueue
        from ..rpc.journal import Journal

        self.cfg = cfg
        self.index = index
        self.path = os.path.join(workdir, f"mc{index}.jsonl")
        if os.path.exists(self.path):
            os.remove(self.path)
        self.journal = Journal(self.path, fsync=False)
        self.vclock = [0.0]
        clock = (lambda: self.vclock[0]) \
            if cfg.substrate == "python" else None
        # The queue's one device step (materializing scenario panels) is
        # never driven here: the checker runs on the CPU.
        self.q = JobQueue(self.journal, lease_s=cfg.lease_s,
                          use_native=(cfg.substrate == "native"),
                          clock=clock, device="cpu")
        if self.q.substrate != cfg.substrate:
            raise RuntimeError(
                f"substrate {cfg.substrate} requested but queue came up "
                f"{self.q.substrate}")
        self.ledger = _Ledger()
        self.payloads: dict[str, bytes] = {}   # jid -> inline wire bytes
        self.boundaries = 0
        self.crash_points = 0
        self.fork_at = fork_at                 # boundary index to fork at
        self.fork_fired = False
        self.compact_fork = compact_fork
        self.strict = True        # ledger expectations (off when depth>0)
        self.preemptions = 0
        # Native substrate: count C-ABI state-machine crossings through
        # the runtime step_hook seam — the native twin of the journal
        # boundary counter (each crossing is an atomic transition the
        # schedule explorer is permuting around).
        self.native_steps = 0
        if cfg.substrate == "native":
            self.q._state.step_hook = self._native_step
        self._final = False       # final drain in progress: no more forks
        self.scheduler = None     # ControlledScheduler when depth>0
        self.executed: list[Op] = []
        self.journal.crash_hook = self._crash_hook

    def _native_step(self, name: str, n: int) -> None:
        self.native_steps += 1

    # -- op execution ------------------------------------------------------

    def execute(self, ops: list[Op]) -> None:
        try:
            for op in ops:
                self.do_op(op)
                if self.strict:
                    self._boundary_checks(op)
            if self.fork_at is not None and not self.fork_fired:
                self._fork()              # schedule had fewer boundaries
            self._final_checks()
        finally:
            self.journal.crash_hook = None
            self.journal.close()

    def execute_controlled(self, programs: dict[str, list[Op]],
                           rng) -> None:
        """--depth mode: ops on real threads, preempted at lock points.
        Ledger expectations are relaxed (ops genuinely interleave) — the
        crash-boundary and final-state invariants carry the checking."""
        self.strict = False
        installed_here = not lockdep.active()
        if installed_here:
            lockdep.install()
        self.scheduler = sched_mod.ControlledScheduler(
            programs, self.do_op, depth=self.cfg.depth, rng=rng,
            timeout_s=self.cfg.timeout_s)
        try:
            self.preemptions = self.scheduler.run()
            self._final_checks()
        except sched_mod.Wedged as e:
            raise _Violation("wedged", str(e)) from e
        finally:
            self.scheduler = None
            self.journal.crash_hook = None
            self.journal.close()
            if installed_here:
                lockdep.uninstall()

    def do_op(self, op: Op) -> None:
        self.executed.append(op)
        getattr(self, f"_op_{op.name}")(op)

    def _op_enqueue(self, op: Op) -> None:
        from ..rpc.dispatcher import JobRecord

        ids = list(op.arg("ids", ()))
        combos = list(op.arg("combos", ())) or [2.0] * len(ids)
        tenant = op.arg("tenant", "default")
        recs = []
        for jid, c in zip(ids, combos):
            payload = self.payloads.setdefault(jid, _panel_bytes(jid))
            recs.append(JobRecord(
                id=jid, strategy="sma_crossover",
                grid={"p": np.arange(int(c), dtype=np.float32)},
                ohlcv=payload, tenant=tenant))
        self.q.enqueue_many(recs)
        for jid, c in zip(ids, combos):
            self.ledger.enqueued[jid] = (tenant, int(c))

    def _op_append(self, op: Op) -> None:
        from ..rpc import panel_store as panel_store_mod

        src = op.arg("src")
        base = self.payloads.get(src)
        if base is None:
            return       # src removed by the minimizer: benign no-op
        parent = panel_store_mod.panel_digest(base)
        delta = _panel_bytes(f"{src}:delta", n_bars=int(op.arg("bars", 2)))
        rec, outcome, ndig, _n = self.q.append_bars(
            parent, 0, delta, strategy="", grid={})
        if outcome == "extended":
            self.ledger.deltas.append(ndig)
        elif self.strict:
            raise _Violation(
                "chain-reachability",
                f"append onto live inline panel {parent[:12]} rejected "
                f"with {outcome!r}")

    def _op_take(self, op: Op) -> None:
        from ..rpc import panel_store as panel_store_mod

        worker = op.arg("worker")
        got = self.q.take(int(op.arg("n", 1)), worker)
        for rec, payload in got:
            if rec.panel_digest and (panel_store_mod.panel_digest(payload)
                                     != rec.panel_digest):
                raise _Violation(
                    "digest-soundness",
                    f"take({worker}) delivered bytes for {rec.id} that "
                    f"hash differently from its digest {rec.panel_digest}")
            self.ledger.leases[rec.id] = worker
            self.ledger.taken.setdefault(worker, []).append(rec.id)

    def _complete(self, worker: str, ids: list[str],
                  journal: bool = True) -> list[str]:
        outcomes = self.q.complete_batch(ids, worker, journal=journal)
        new = [j for j, o in zip(ids, outcomes) if o == "new"]
        for jid, outcome in zip(ids, outcomes):
            expect = ("unknown" if jid not in self.ledger.enqueued
                      else "dup" if jid in self.ledger.completed
                      else "new")
            if self.strict and outcome != expect:
                raise _Violation(
                    "exactly-once-completion",
                    f"complete({jid}) by {worker} returned {outcome!r}, "
                    f"ledger expected {expect!r}")
            if outcome == "new":
                self.ledger.completed.add(jid)
                self.ledger.lease_drop(jid)
                self.ledger.done_by.setdefault(worker, []).append(jid)
        return new

    def _op_complete_taken(self, op: Op) -> None:
        worker = op.arg("worker")
        ids = list(self.ledger.taken.get(worker, ()))
        self._complete(worker, ids)

    def _op_complete_deferred(self, op: Op) -> None:
        # The persist-results-first protocol: state completes now, the
        # durable records land in a second step — the crash window in
        # between is LEGAL (re-run idempotently), and the hook forks
        # right inside it.
        worker = op.arg("worker")
        ids = list(self.ledger.taken.get(worker, ()))
        new = self._complete(worker, ids, journal=False)
        self.q.journal_completions(new, worker)

    def _op_complete_dup(self, op: Op) -> None:
        worker = op.arg("worker")
        ids = self.ledger.done_by.get(worker, [])[-2:]
        if ids:
            self._complete(worker, ids)

    def _op_complete_ids(self, op: Op) -> None:
        worker = op.arg("worker")
        for jid in op.arg("ids", ()):
            outcome = self.q.complete(jid, worker)
            expect = ("unknown" if jid not in self.ledger.enqueued
                      else "dup" if jid in self.ledger.completed
                      else "new")
            if self.strict and outcome != expect:
                raise _Violation(
                    "exactly-once-completion",
                    f"complete({jid}) by {worker} returned {outcome!r}, "
                    f"ledger expected {expect!r}")
            if outcome == "new":
                self.ledger.completed.add(jid)
                self.ledger.lease_drop(jid)
                self.ledger.done_by.setdefault(worker, []).append(jid)

    def _op_requeue_expired(self, op: Op) -> None:
        jids = self.q.requeue_expired()
        # lease_s < 0: every live lease is expired by construction.
        if self.strict and set(jids) != set(self.ledger.leases):
            raise _Violation(
                "job-conservation",
                f"requeue_expired returned {sorted(jids)}, ledger holds "
                f"leases {sorted(self.ledger.leases)}")
        for jid in jids:
            self.ledger.lease_drop(jid)

    def _op_requeue_worker(self, op: Op) -> None:
        worker = op.arg("worker")
        jids = self.q.requeue_worker(worker)
        held = {j for j, w in self.ledger.leases.items() if w == worker}
        if self.strict and set(jids) != held:
            raise _Violation(
                "job-conservation",
                f"requeue_worker({worker}) returned {sorted(jids)}, "
                f"ledger holds {sorted(held)}")
        for jid in jids:
            self.ledger.lease_drop(jid)

    def _op_advance_clock(self, op: Op) -> None:
        self.vclock[0] += float(op.arg("dt", 1.0))

    def _op_stats(self, op: Op) -> None:
        self.q.stats()
        _ = self.q.drained

    # -- per-op boundary invariants (op-granularity mode only) -------------

    def _boundary_checks(self, op: Op) -> None:
        led = self.ledger
        s = self.q.stats()
        pending = led.pending()
        if (s["jobs_pending"] != len(pending)
                or s["jobs_leased"] != len(led.leases)
                or s["jobs_completed"] != len(led.completed)):
            raise _Violation(
                "lane-fifo-consistency",
                f"after {op.name}: stats pending/leased/completed = "
                f"{s['jobs_pending']}/{s['jobs_leased']}/"
                f"{s['jobs_completed']}, ledger = {len(pending)}/"
                f"{len(led.leases)}/{len(led.completed)}")
        if self.q._state.stats()["pending"] != 0:
            raise _Violation(
                "lane-fifo-consistency",
                f"after {op.name}: state FIFO not empty between public "
                "calls (WFQ lanes must own all pending work)")
        want_drained = not pending and not led.leases
        if self.q.drained != want_drained:
            raise _Violation(
                "drained-monotonic",
                f"after {op.name}: drained={self.q.drained} but ledger "
                f"has {len(pending)} pending / {len(led.leases)} leased")
        ts = self.q.tenant_stats()
        charge: dict[str, float] = {}
        for jid, worker in led.leases.items():
            t, c = led.enqueued[jid]
            charge[t] = charge.get(t, 0.0) + float(c)
        for t, expect in charge.items():
            got = ts.get(t, {}).get("inflight_combos", 0.0)
            if abs(got - expect) > 1e-9:
                raise _Violation(
                    "quota-balance",
                    f"after {op.name}: tenant {t} inflight charge {got} "
                    f"!= leased combo total {expect}")
        for t, row in ts.items():
            if t not in charge and row["inflight_combos"]:
                raise _Violation(
                    "quota-balance",
                    f"after {op.name}: tenant {t} charged "
                    f"{row['inflight_combos']} with nothing leased")

    # -- crash boundaries --------------------------------------------------

    def _crash_hook(self, phase: str, event: str, rec: dict) -> None:
        if self._final:
            return
        if self.scheduler is not None:
            self.scheduler.pause()
        try:
            self.boundaries += 1
            self._light_checks(phase, event)
            if self.cfg.fork_all and phase == "post":
                self._fork()
            elif (self.fork_at is not None and not self.fork_fired
                    and self.boundaries >= self.fork_at):
                self._fork()
        finally:
            if self.scheduler is not None:
                self.scheduler.resume()

    def _light_checks(self, phase: str, event: str) -> None:
        from ..rpc.journal import Journal, JournalCorruptError

        try:
            replay = Journal.replay(self.path)
        except JournalCorruptError as e:
            raise _Violation("replay-integrity", str(e)) from e
        live_ids = set(self.q._records)
        extra = live_ids - set(replay.jobs)
        if extra:
            raise _Violation(
                "journal-append-first",
                f"at {phase}-append({event}) boundary {self.boundaries}: "
                f"live state holds {sorted(extra)} with no journaled "
                "enqueue record — a crash here loses them")
        ahead = replay.completed - self.q.completed_ids()
        if ahead:
            raise _Violation(
                "completion-durability",
                f"at {phase}-append({event}): journal records completions "
                f"{sorted(ahead)} that live state never saw")

    def _fork(self) -> None:
        self.fork_fired = True
        self._check_restore(compact=False)
        if self.compact_fork:
            self._check_restore(compact=True)

    def _check_restore(self, compact: bool) -> None:
        from ..rpc.dispatcher import JobQueue
        from ..rpc.journal import Journal

        self.crash_points += 1
        fork = f"{self.path}.fork"
        shutil.copyfile(self.path, fork)
        try:
            if compact:
                Journal.compact(fork)
            replay = Journal.replay(fork)
            tag = "post-compaction " if compact else ""
            jobs = set(replay.jobs)
            if (replay.completed | replay.failed) - jobs:
                raise _Violation(
                    "job-conservation",
                    f"{tag}replay has terminal records for jobs with no "
                    "enqueue record")
            q2 = JobQueue(use_native=(self.cfg.substrate == "native"),
                          device="cpu")
            n = q2.restore(fork)
            if n != len(replay.pending):
                raise _Violation(
                    "job-conservation",
                    f"{tag}restore re-enqueued {n} jobs, replay says "
                    f"{len(replay.pending)} pending")
            for jid in sorted(replay.completed)[:2]:
                if q2.complete(jid, "mc-probe") != "dup":
                    raise _Violation(
                        "exactly-once-completion",
                        f"{tag}restored queue re-recorded completed job "
                        f"{jid} as new — a retrying worker double-counts")
            if q2.complete("mc-never-enqueued", "mc-probe") != "unknown":
                raise _Violation(
                    "exactly-once-completion",
                    f"{tag}restored queue answered an id it never saw")
            self._check_chains(q2, replay, tag)
            _check_scenario_roots(replay, tag)
            self._drain(q2, replay, tag)
        finally:
            if os.path.exists(fork):
                os.remove(fork)

    def _check_chains(self, q2, replay, tag: str) -> None:
        from ..rpc import panel_store as panel_store_mod

        for ndig in replay.deltas:
            blob = q2.payload_for_digest(ndig)
            if blob is None:
                raise _Violation(
                    "chain-reachability",
                    f"{tag}append-chain digest {ndig[:12]} is unservable "
                    "after restore (orphaned root or slimmed payload)")
            if panel_store_mod.panel_digest(blob) != ndig:
                raise _Violation(
                    "digest-soundness",
                    f"{tag}chain splice for {ndig[:12]} produced bytes "
                    "with a different digest")

    def _drain(self, q2, replay, tag: str) -> None:
        from ..rpc import panel_store as panel_store_mod

        expected = len(replay.pending)
        drained_n = 0
        for _ in range(expected + 4):
            got = q2.take(4, "mc-restore")
            if not got:
                break
            for rec, payload in got:
                if rec.panel_digest and (
                        panel_store_mod.panel_digest(payload)
                        != rec.panel_digest):
                    raise _Violation(
                        "digest-soundness",
                        f"{tag}restored dispatch of {rec.id} delivered "
                        "bytes that hash differently from its journaled "
                        "digest")
                drained_n += 1
            q2.complete_batch([rec.id for rec, _ in got], "mc-restore")
        if drained_n != expected:
            raise _Violation(
                "job-conservation",
                f"{tag}drain dispatched {drained_n} jobs, replay says "
                f"{expected} were pending")
        if not q2.drained:
            raise _Violation(
                "drained-monotonic",
                f"{tag}restored queue not drained after completing every "
                "pending job")
        for t, row in q2.tenant_stats().items():
            if row["inflight_combos"] or row["pending"]:
                raise _Violation(
                    "quota-balance",
                    f"{tag}tenant {t} still charged/parked after a full "
                    f"drain: {row}")

    # -- end of schedule ---------------------------------------------------

    def _final_checks(self) -> None:
        self._final = True
        from ..rpc.journal import Journal

        replay = Journal.replay(self.path)
        live_ids = set(self.q._records)
        if live_ids - set(replay.jobs):
            raise _Violation(
                "journal-append-first",
                f"end of schedule: live ids "
                f"{sorted(live_ids - set(replay.jobs))} never journaled")
        # Drive the LIVE queue to completion: every enqueued job must be
        # dispatchable and completable exactly once, after which drained
        # and the quota ledger must both read empty.
        self.q.requeue_expired()
        for _ in range(len(live_ids) + 4):
            got = self.q.take(8, "mc-final")
            if not got:
                break
            self.q.complete_batch([rec.id for rec, _ in got], "mc-final")
        if not self.q.drained:
            raise _Violation(
                "drained-monotonic",
                "end of schedule: queue not drained after completing "
                "every dispatchable job")
        for t, row in self.q.tenant_stats().items():
            if row["inflight_combos"] or row["pending"]:
                raise _Violation(
                    "quota-balance",
                    f"end of schedule: tenant {t} still charged/parked "
                    f"after full drain: {row}")


def _check_scenario_roots(replay, tag: str = "") -> None:
    """Every PENDING scenario job's base chain must end at a record that
    still carries a payload source (inline bytes or a path) — the walk
    ``Journal.compact`` protects; checked here so a compaction bug that
    slims a scenario root is a dbxmc finding, not a first-take failure
    after the next restart."""
    by_digest: dict = {}
    for r in replay.jobs.values():
        for dkey in ("pdig", "pdig2"):
            if r.get(dkey):
                by_digest.setdefault(r[dkey], r)
    for jid in replay.pending:
        rec = replay.jobs[jid]
        scn = rec.get("scn")
        if not scn:
            continue
        d = scn.get("base")
        seen: set = set()
        while d and d not in seen:
            seen.add(d)
            r = by_digest.get(d)
            if r is None:
                if d in replay.deltas:
                    break      # served through the append chain
                raise _Violation(
                    "scenario-base-reachability",
                    f"{tag}pending scenario job {jid} walks base "
                    f"{d[:12]} that no journaled record carries")
            if r.get("scn") and r.get("pdig") == d:
                d = r["scn"].get("base")
                continue
            if not (r.get("ohlcv_b64") or r.get("path")):
                raise _Violation(
                    "scenario-base-reachability",
                    f"{tag}scenario root {d[:12]} for pending job {jid} "
                    "has no payload source (slimmed at compaction?)")
            break


# ---------------------------------------------------------------------------
# Exploration driver
# ---------------------------------------------------------------------------

def run_ops(cfg: MCConfig, ops: list[Op], workdir: str, index: int = 0,
            fork_all: bool | None = None) -> _Run:
    """Execute one explicit op list (replay / minimizer path). Violations
    surface as ``_Violation`` on the returned run's ``.violation``."""
    eff = dataclasses.replace(
        cfg, fork_all=cfg.fork_all if fork_all is None else fork_all)
    run = _Run(eff, workdir, index, fork_at=None, compact_fork=True)
    run.violation = None
    try:
        run.execute(ops)
    except _Violation as v:
        run.violation = v
    return run


def _minimize(cfg: MCConfig, ops: list[Op], invariant: str,
              workdir: str) -> list[Op]:
    """Greedy delta-debugging: drop ops one at a time while the same
    invariant still trips on a deterministic re-run."""
    def trips(cand: list[Op]) -> bool:
        run = run_ops(cfg, cand, workdir, index=999983, fork_all=True)
        return (run.violation is not None
                and run.violation.invariant == invariant)

    cur = list(ops)
    changed = True
    while changed:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            if trips(cand):
                cur = cand
                changed = True
                break
    return cur


def _violation_record(cfg: MCConfig, v: _Violation, ops: list[Op],
                      minimized: list[Op] | None) -> dict:
    rec = {
        "invariant": v.invariant,
        "detail": v.detail,
        "substrate": cfg.substrate,
        "schedule_ops": len(ops),
        "script": script_dump(cfg, minimized if minimized is not None
                              else ops, v.invariant),
    }
    if minimized is not None:
        rec["minimized_ops"] = len(minimized)
    return rec


def explore_substrate(cfg: MCConfig) -> dict:
    """Bounded exploration on one substrate; returns the telemetry +
    violation summary dict the CLI/bench/tests consume."""
    t0 = time.perf_counter()
    rng = random.Random(cfg.seed)
    programs = sched_mod.build_programs(cfg.ops, rng)
    out = {"substrate": cfg.substrate, "schedules": 0, "crash_points": 0,
           "boundaries": 0, "preemptions": 0, "native_steps": 0,
           "violations": [], "depth": cfg.depth}
    with tempfile.TemporaryDirectory(prefix="dbxmc-") as workdir:
        if cfg.depth > 0:
            _explore_controlled(cfg, programs, rng, workdir, out)
        else:
            _explore_opgrain(cfg, programs, rng, workdir, out)
    out["wall_s"] = round(time.perf_counter() - t0, 3)
    out["clean"] = not out["violations"]
    return out


def _explore_opgrain(cfg, programs, rng, workdir, out) -> None:
    gen = sched_mod.generate_schedules(programs, rng, cfg.schedules)
    for i, (_key, sched) in enumerate(gen):
        armed = (i % cfg.crash_every == 0)
        fork_at = 1 + (i // cfg.crash_every) % 11 if armed else None
        run = _Run(cfg, workdir, i, fork_at=fork_at,
                   compact_fork=armed and (i // cfg.crash_every) % 2 == 0)
        try:
            run.execute(sched)
        except _Violation as v:
            minimized = (_minimize(cfg, run.executed, v.invariant, workdir)
                         if cfg.minimize else None)
            out["violations"].append(
                _violation_record(cfg, v, run.executed, minimized))
        out["schedules"] += 1
        out["crash_points"] += run.crash_points
        out["boundaries"] += run.boundaries
        out["native_steps"] += run.native_steps
        if len(out["violations"]) >= cfg.max_violations:
            break


def _explore_controlled(cfg, programs, rng, workdir, out) -> None:
    # Install lockdep BEFORE any queue exists: preemption points are the
    # instrumented-lock acquires, and only locks created while lockdep is
    # active are instrumented.
    installed_here = not lockdep.active()
    if installed_here:
        lockdep.install()
    try:
        _controlled_loop(cfg, programs, rng, workdir, out)
    finally:
        if installed_here:
            lockdep.uninstall()


def _controlled_loop(cfg, programs, rng, workdir, out) -> None:
    seen: set = set()
    for i in range(cfg.schedules):
        armed = (i % cfg.crash_every == 0)
        run = _Run(cfg, workdir, i,
                   fork_at=1 + i % 7 if armed else None,
                   compact_fork=armed and i % 2 == 0)
        try:
            run.execute_controlled(programs, random.Random(cfg.seed + i))
        except _Violation as v:
            out["violations"].append(
                _violation_record(cfg, v, run.executed, None))
        seen.add(sched_mod.canonical_key(run.executed))
        out["schedules"] = len(seen)
        out["crash_points"] += run.crash_points
        out["boundaries"] += run.boundaries
        out["preemptions"] += getattr(run, "preemptions", 0)
        out["native_steps"] += run.native_steps
        if len(out["violations"]) >= cfg.max_violations:
            break


def available_substrates() -> list[str]:
    from ..runtime import _core as native_core

    subs = ["python"]
    if native_core.available():
        subs.append("native")
    return subs


def explore(cfg: MCConfig, substrates: list[str]) -> dict:
    results = [explore_substrate(dataclasses.replace(cfg, substrate=s))
               for s in substrates]
    return {
        "substrates": {r["substrate"]: r for r in results},
        "schedules": sum(r["schedules"] for r in results),
        "crash_points": sum(r["crash_points"] for r in results),
        "boundaries": sum(r["boundaries"] for r in results),
        "wall_s": round(sum(r["wall_s"] for r in results), 3),
        "violations": [v for r in results for v in r["violations"]],
        "clean": all(r["clean"] for r in results),
    }


# ---------------------------------------------------------------------------
# Replayable op scripts
# ---------------------------------------------------------------------------

def script_dump(cfg: MCConfig, ops: list[Op], invariant: str = "") -> dict:
    return {"dbxmc": 1, "substrate": cfg.substrate,
            "lease_s": cfg.lease_s, "invariant": invariant,
            "ops": [op.to_json() for op in ops]}


def script_load(rec: dict) -> tuple[MCConfig, list[Op], str]:
    if rec.get("dbxmc") != 1:
        raise ValueError("not a dbxmc op script (missing `dbxmc: 1`)")
    cfg = MCConfig(substrate=rec.get("substrate", "python"),
                   lease_s=float(rec.get("lease_s", -1.0)),
                   minimize=False)
    ops = [Op.from_json(o) for o in rec.get("ops", [])]
    return cfg, ops, str(rec.get("invariant", ""))


def replay_script(rec: dict) -> dict:
    """Re-execute a violation script deterministically; returns a result
    dict with ``reproduced`` set when the named invariant trips again."""
    cfg, ops, invariant = script_load(rec)
    with tempfile.TemporaryDirectory(prefix="dbxmc-replay-") as workdir:
        run = run_ops(cfg, ops, workdir, fork_all=True)
    v = run.violation
    return {
        "substrate": cfg.substrate,
        "ops": len(ops),
        "invariant_expected": invariant,
        "violation": (None if v is None
                      else {"invariant": v.invariant, "detail": v.detail}),
        "reproduced": bool(v is not None
                           and (not invariant or v.invariant == invariant)),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbxmc",
        description="interleaving + crash-point model checker over the "
                    "dispatcher's journaled state machines")
    p.add_argument("--ops", type=int,
                   default=int(os.environ.get("DBX_MC_OPS", "12")),
                   help="program size: ~total ops across the four "
                        "logical threads (env DBX_MC_OPS)")
    p.add_argument("--depth", type=int, default=0,
                   help="intra-op preemption bound at instrumented-lock "
                        "acquire points (0 = op-granularity)")
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("DBX_MC_SEED", "0")),
                   help="exploration seed (env DBX_MC_SEED)")
    p.add_argument("--schedules", type=int, default=500,
                   help="distinct schedules to explore per substrate")
    p.add_argument("--substrate", default="auto",
                   choices=["auto", "python", "native", "both"],
                   help="queue substrate(s); auto = python + native "
                        "when the C++ core is loadable")
    p.add_argument("--format", default="text", choices=["text", "json"])
    p.add_argument("--replay", metavar="FILE",
                   help="re-run a violation op script instead of "
                        "exploring")
    p.add_argument("--no-minimize", action="store_true",
                   help="report raw violating schedules (skip "
                        "delta-debugging)")
    p.add_argument("--list-invariants", action="store_true")
    return p


def _resolve_substrates(choice: str) -> list[str]:
    avail = available_substrates()
    if choice == "auto":
        return avail
    if choice == "both":
        if "native" not in avail:
            raise SystemExit(2)
        return ["python", "native"]
    if choice == "native" and "native" not in avail:
        raise SystemExit(2)
    return [choice]


def exit_code(result: dict) -> int:
    return 0 if result.get("clean") else 1


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.list_invariants:
        for name, doc in INVARIANTS.items():
            print(f"{name}: {doc}")
        return 0
    if args.replay:
        try:
            with open(args.replay, encoding="utf-8") as fh:
                rec = json.load(fh)
            result = replay_script(rec)
        except (OSError, ValueError) as e:
            print(f"dbxmc: bad replay script: {e}", file=sys.stderr)
            return 2
        if args.format == "json":
            print(json.dumps(result, indent=2, sort_keys=True))
        else:
            v = result["violation"]
            print(f"dbxmc replay: {result['ops']} ops on "
                  f"{result['substrate']}: "
                  + (f"violated [{v['invariant']}] {v['detail']}" if v
                     else "clean"))
        return 1 if result["violation"] else 0
    try:
        substrates = _resolve_substrates(args.substrate)
    except SystemExit:
        print(f"dbxmc: substrate {args.substrate!r} requested but the "
              "native core is not loadable", file=sys.stderr)
        return 2
    cfg = MCConfig(ops=args.ops, depth=args.depth, seed=args.seed,
                   schedules=args.schedules,
                   minimize=not args.no_minimize)
    result = explore(cfg, substrates)
    if args.format == "json":
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        for s, r in result["substrates"].items():
            print(f"dbxmc [{s}] schedules={r['schedules']} "
                  f"crash_points={r['crash_points']} "
                  f"boundaries={r['boundaries']} depth={r['depth']} "
                  f"wall={r['wall_s']}s "
                  f"violations={len(r['violations'])}")
        for v in result["violations"]:
            print(f"\nVIOLATION [{v['invariant']}] on {v['substrate']}: "
                  f"{v['detail']}")
            print("replayable script (dbxmc --replay <file>):")
            print(json.dumps(v["script"], indent=2))
        if result["clean"]:
            print(f"dbxmc: clean — {result['schedules']} schedules, "
                  f"{result['crash_points']} crash points, all "
                  f"{len(INVARIANTS)} invariants hold")
    return exit_code(result)


if __name__ == "__main__":
    raise SystemExit(main())
