"""The dispatcher: job queue with leases, peer liveness, durable journal.

Capability superset of the reference's server (queue of file-backed jobs,
batch sizing by advertised capacity, peer registry with a liveness-pruning
thread, completion recording — reference ``src/server/main.rs``), with its
recorded defects designed out:

- peers are keyed by the worker-chosen ``worker_id``, not a socket address
  (the reference keyed by ``local_addr()`` — its own address — so all peers
  collapsed into one entry; reference ``src/server/main.rs:84,109``);
- batching is take-*n* (the reference's ``split_off(n)`` handed out
  ``len-n`` jobs — inverted semantics; reference ``src/server/main.rs:151-162``);
- every RPC refreshes liveness (the reference refreshed only on RequestJobs,
  so a busy worker that stopped polling was pruned while computing);
- an empty queue returns an empty reply, not an error with an OK code
  (reference ``src/server/main.rs:139-141``);
- handed-out jobs carry a lease; lease expiry or peer prune re-queues them
  (the retry the reference names as missing, reference ``README.md:82``);
- unreadable files are recorded as failed jobs, not silently dropped
  (reference ``src/server/main.rs:164-180`` filter_maps them away);
- the queue + completions journal to disk and replay on restart
  (reference ``README.md:80``: server crash loses everything).

This module is the JAX package's ``rpc/dispatcher.py`` in the port: the
same queue, RPCs, journal lines and CLI, serving JAX and PyTorch workers
alike. Its one device step is materializing scenario panels, on the
``device`` that :class:`JobQueue` takes (the card by default;
``--device`` on the command line).
"""

from __future__ import annotations

import argparse
import base64
import collections
import dataclasses
import functools
import glob as glob_mod
import json
import logging
import os
import threading
import time
import uuid
from concurrent import futures
from typing import Mapping

import numpy as np

from . import backtesting_pb2 as pb
from . import panel_store as panel_store_mod
from . import service, wire
from .journal import Journal
from .. import device as device_mod
from .. import obs
from ..obs import decisions as obs_decisions
from ..obs import fleet as obs_fleet
from ..obs import flight as obs_flight
from ..runtime import _core as native_core
from ..sched import (DEFAULT_TENANT, WfqScheduler, held_explain,
                     placement as sched_placement, tenant_bucket)
from ..utils import data as data_mod

log = logging.getLogger("dbx.dispatcher")


def _lockdep_report() -> dict:
    """Flight-bundle source: the lockdep edge table + violations (empty
    shape when lockdep was never installed). Lazy import — analysis is
    a tooling package the serving path must not load eagerly."""
    from ..analysis import lockdep

    return lockdep.report()


# ---------------------------------------------------------------------------
# Job records and the leased queue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JobRecord:
    """One dispatchable backtest job (a ticker's history x a param grid)."""

    id: str
    strategy: str
    grid: Mapping[str, np.ndarray]
    cost: float = 0.0
    periods_per_year: int = 252
    path: str | None = None       # file-backed source (CSV or DBX1)
    ohlcv: bytes | None = None    # inline source (already-encoded DBX1)
    ohlcv2: bytes | None = None   # second leg for two-legged strategies
    path2: str | None = None      # file-backed second leg (pairs --data2)
    # Walk-forward mode (proto JobSpec.wf_*): train/test bars per refit
    # window; 0 train = plain sweep. The DBXM result is then one stitched
    # out-of-sample metrics row, not a per-combo matrix.
    wf_train: int = 0
    wf_test: int = 0
    wf_metric: str = ""
    # On-device result reduction (proto JobSpec.top_k): when > 0 the worker
    # ships only the top-k param rows by rank_metric instead of the full
    # per-combo matrix — the DCN-diet mode for huge grids.
    top_k: int = 0
    rank_metric: str = ""
    # Fleet-portfolio mode (proto JobSpec.best_returns): the worker ships a
    # DBXP block — best combo by rank_metric + its net-return series — so
    # `aggregate --portfolio` can compose the true fleet book.
    best_returns: bool = False
    # Distributed tracing (proto JobSpec.trace_id): minted at enqueue time
    # (JobQueue.enqueue_many) and journaled, so a job keeps ONE trace id
    # across dispatcher restarts. enqueue_ts (wall clock) anchors the
    # queue-wait and end-to-end spans; deliberately NOT journaled — a
    # restart restarts the queue-wait clock rather than attributing the
    # outage to the queue.
    trace_id: str = ""
    enqueue_ts: float = 0.0
    # Content addresses (proto JobSpec.panel_digest/panel_digest2): the
    # blake2b-128 hex digest of each leg's DBX1 bytes, stamped at enqueue
    # (inline payloads) or first materialization (file-backed — a later
    # "digest" journal event merges into the enqueue record on replay).
    # Journaled so a restart keeps dispatching by the SAME address the
    # first run delivered; the blob store repopulates lazily from the
    # payload source.
    panel_digest: str = ""
    panel_digest2: str = ""
    # Streaming append jobs (proto AppendBars / JobSpec.append_*): the
    # base panel's content address, its bar count, and the appended
    # ΔT-bar DBX1 slice. The record carries NO full payload — the
    # extended panel materializes through the delta chain
    # (``JobQueue._splice_from_chain``), so enqueue records and journal
    # growth stay O(ΔT) per append.
    append_parent: str = ""
    append_base_len: int = 0
    delta: bytes | None = None
    # Placement-deferral bookkeeping (NOT journaled — locality evidence
    # dies with the process, so restarts restart locality cold): how many
    # times take() deferred this job for a better-scored worker (round
    # 20, sched.placement). At DBX_PLACEMENT_DEFER_CAP any worker serves
    # it. The field name survives from the round-6 one-shot append
    # affinity this budget generalized (record/decision-schema
    # stability).
    affinity_skips: int = 0
    # Multi-tenant serving (proto JobSpec.tenant_id): the weighted-fair-
    # queueing identity. proto3's default empty string — and a journal
    # record without the key — map to the `default` tenant, so legacy
    # clients and pre-tenancy journals keep exactly their old (FIFO)
    # behavior. Journaled so replay rebuilds per-tenant backlogs.
    tenant: str = DEFAULT_TENANT
    # Digest-seeded scenario synthesis (proto ScenarioSpec): when set,
    # this job's panel is a pure function of (scenario["base"] digest,
    # generator params) and materializes through the panel store like a
    # file-backed payload — the record itself stays payload-free.
    scenario: dict | None = None

    @property
    def combos(self) -> int:
        n = 1
        for v in self.grid.values():
            n *= max(int(np.asarray(v).size), 1)
        return n

    def journal_form(self) -> dict:
        rec = {"id": self.id, "strategy": self.strategy,
               "grid": {k: np.asarray(v).tolist() for k, v in self.grid.items()},
               "cost": self.cost, "ppy": self.periods_per_year}
        if self.path is not None:
            rec["path"] = self.path
        elif self.ohlcv is not None:
            # Inline payloads must be journaled too, or a restart would
            # restore a job with nothing to dispatch.
            rec["ohlcv_b64"] = base64.b64encode(self.ohlcv).decode("ascii")
        if self.path2 is not None:
            rec["path2"] = self.path2
        if self.ohlcv2 is not None:
            rec["ohlcv2_b64"] = base64.b64encode(self.ohlcv2).decode("ascii")
        if self.wf_train:
            rec["wf"] = [self.wf_train, self.wf_test, self.wf_metric]
        if self.top_k:
            rec["topk"] = [self.top_k, self.rank_metric]
        if self.best_returns:
            rec["ret"] = [True, self.rank_metric]
        if self.trace_id:
            rec["trace"] = self.trace_id
        if self.panel_digest:
            rec["pdig"] = self.panel_digest
        if self.panel_digest2:
            rec["pdig2"] = self.panel_digest2
        if self.append_parent:
            # The delta payload itself is journaled once as the chain's
            # `delta` event (keyed by pdig); the enqueue record carries
            # only the O(1) linkage.
            rec["apdig"] = self.append_parent
            rec["abase"] = self.append_base_len
        if self.tenant != DEFAULT_TENANT:
            # Default-tenant records stay slim (and byte-identical to
            # pre-tenancy journals); compaction drops only payload keys,
            # so the tenant survives onto slim terminal records too.
            rec["tenant"] = self.tenant
        if self.scenario is not None:
            rec["scn"] = self.scenario
        return rec

    @staticmethod
    def from_journal(rec: dict) -> "JobRecord":
        ohlcv = rec.get("ohlcv_b64")
        ohlcv2 = rec.get("ohlcv2_b64")
        wf = rec.get("wf") or [0, 0, ""]
        topk = rec.get("topk") or [0, ""]
        return JobRecord(
            id=rec["id"], strategy=rec["strategy"],
            grid={k: np.asarray(v, np.float32)
                  for k, v in rec.get("grid", {}).items()},
            cost=rec.get("cost", 0.0), periods_per_year=rec.get("ppy", 252),
            path=rec.get("path"), path2=rec.get("path2"),
            ohlcv=base64.b64decode(ohlcv) if ohlcv else None,
            ohlcv2=base64.b64decode(ohlcv2) if ohlcv2 else None,
            wf_train=int(wf[0]), wf_test=int(wf[1]), wf_metric=str(wf[2]),
            top_k=int(topk[0]),
            rank_metric=str(topk[1]) or str((rec.get("ret") or [0, ""])[1]),
            best_returns=bool((rec.get("ret") or [False])[0]),
            trace_id=str(rec.get("trace", "")),
            panel_digest=str(rec.get("pdig", "")),
            panel_digest2=str(rec.get("pdig2", "")),
            append_parent=str(rec.get("apdig", "")),
            append_base_len=int(rec.get("abase", 0)),
            tenant=str(rec.get("tenant", "")) or DEFAULT_TENANT,
            scenario=rec.get("scn"))


@dataclasses.dataclass
class Lease:
    worker_id: str
    deadline: float


class _PyQueueState:
    """Pure-Python fallback of the native job-queue state machine.

    Mirrors ``cpp/dbx_core.h``'s ``DbxJobQueue`` contract exactly (the
    same contract :class:`runtime._core.NativeJobQueue` binds); the parity
    tests in ``tests/test_rpc_unit.py`` run both substrates through
    identical scenarios. Not itself thread-safe — every call arrives under
    ``JobQueue._lock`` (single-lock discipline, matching how the native
    side is driven).
    """

    def __init__(self, clock=time.monotonic):
        # Injectable lease clock (defaults to the real monotonic clock):
        # the model checker drives lease expiry deterministically by
        # advancing a virtual clock instead of sleeping past deadlines.
        # The native substrate keeps its C-side clock — mc gets the same
        # determinism there with lease_s=0 (already-expired leases).
        self._clock = clock
        self._pending: collections.deque[str] = collections.deque()
        # Ids completed while still in the pending FIFO (late completions
        # from a previous lease): the FIFO supports no interior removal, so
        # take_begin skips tombstoned ids on pop. Invariant: every
        # tombstone refers to an id currently in the FIFO.
        self._tombstones: set[str] = set()
        self._combos: dict[str, float] = {}      # id -> combo credit
        self._leases: dict[str, Lease] = {}
        self._completed: dict[str, float] = {}   # id -> combos credited
        self._failed: set[str] = set()
        self._requeued = 0
        self._combos_done = 0.0

    def register(self, jid: str, combos: float) -> None:
        self._combos[jid] = float(combos)

    def push_pending(self, jid: str) -> None:
        self._pending.append(jid)

    def mark_completed(self, jid: str) -> None:
        # Journal-restore path: completed in a prior run, no throughput
        # credit for this run's combos_done.
        self._completed.setdefault(jid, 0.0)

    def mark_failed(self, jid: str) -> None:
        self._failed.add(jid)

    def take_begin(self) -> str | None:
        while self._pending:
            jid = self._pending.popleft()
            if jid in self._tombstones:     # completed while pending
                self._tombstones.discard(jid)
                continue
            return jid
        return None

    def take_commit(self, jid: str, worker_id: str, lease_s: float) -> bool:
        """False when the job completed in the take window (not leased)."""
        if self._discard_if_completed(jid):
            return False
        self._leases[jid] = Lease(worker_id, self._clock() + lease_s)
        return True

    def fail(self, jid: str) -> bool:
        """False when the job completed in the take window (not failed)."""
        if self._discard_if_completed(jid):
            return False
        self._failed.add(jid)
        return True

    def _discard_if_completed(self, jid: str) -> bool:
        """True if ``jid`` completed while take() held it outside the lock;
        clears the orphan tombstone complete() installed."""
        if jid in self._completed:
            self._tombstones.discard(jid)
            return True
        return False

    def complete(self, jid: str) -> str:
        if jid not in self._combos:
            return "unknown"
        had_lease = self._leases.pop(jid, None) is not None
        if jid in self._completed:
            return "dup"
        if (not had_lease and jid not in self._failed
                and jid not in self._tombstones):
            # Rare path: completion for a job sitting in the pending FIFO
            # (e.g. a completion RPC that straddled a lease expiry or
            # restart). The FIFO has no interior removal; tombstone the id
            # so take skips it instead of re-dispatching.
            self._tombstones.add(jid)
        combos = self._combos[jid]
        self._completed[jid] = combos
        self._combos_done += combos
        return "new"

    # Batch surface (one call per RPC-sized batch): trivial loops here —
    # the point of batching is the native substrate's ctypes crossing, but
    # both substrates expose the same methods so JobQueue stays agnostic.

    def enqueue_n(self, jids: list[str], combos: list[float]) -> None:
        for jid, c in zip(jids, combos):
            self.register(jid, c)
            self.push_pending(jid)

    def take_begin_n(self, n: int) -> list[str]:
        out = []
        while len(out) < n:
            jid = self.take_begin()
            if jid is None:
                break
            out.append(jid)
        return out

    def take_commit_n(self, jids: list[str], worker_id: str,
                      lease_s: float) -> list[bool]:
        return [self.take_commit(j, worker_id, lease_s) for j in jids]

    def complete_n(self, jids: list[str]) -> list[str]:
        return [self.complete(j) for j in jids]

    def requeue_expired(self) -> list[str]:
        now = self._clock()
        expired = [jid for jid, l in self._leases.items()
                   if l.deadline <= now]
        for jid in expired:
            del self._leases[jid]
            self._pending.appendleft(jid)
        self._requeued += len(expired)
        return expired

    def requeue_worker(self, worker_id: str) -> list[str]:
        held = [jid for jid, l in self._leases.items()
                if l.worker_id == worker_id]
        for jid in held:
            del self._leases[jid]
            self._pending.appendleft(jid)
        self._requeued += len(held)
        return held

    def stats(self) -> dict:
        return {"pending": len(self._pending) - len(self._tombstones),
                "leased": len(self._leases),
                "completed": len(self._completed),
                "requeued": self._requeued,
                "failed": len(self._failed),
                "combos_done": self._combos_done}

    def drained(self) -> bool:
        live_pending = len(self._pending) - len(self._tombstones)
        return live_pending == 0 and not self._leases


# Strategies AppendBars accepts: the streaming families that fit a
# one-panel wire (``streaming.recurrent._STREAM_FAMILIES`` minus pairs,
# whose second leg cannot ride an AppendRequest). A LITERAL set — the
# dispatcher process must not import the torch-backed streaming package
# just to validate a name; tests/test_streaming.py pins it against the
# real registry so the two cannot drift.
STREAMABLE_STRATEGIES = frozenset({
    "sma_crossover", "momentum", "bollinger", "bollinger_touch",
    "obv_trend", "stochastic", "vwap_reversion", "keltner", "rsi",
    "macd", "trix", "donchian", "donchian_hl"})


class JobQueue:
    """Thread-safe FIFO of JobRecords with leases and a durable journal.

    ``take`` materializes file-backed payloads at dispatch time (so enqueue
    is cheap and restarts don't re-read anything); a job whose file cannot
    be read is marked failed and journaled, never silently dropped.

    The id-state machine (pending FIFO + tombstones + lease table +
    completion idempotency) has two substrates passing identical parity
    tests: the pure-Python one (DEFAULT when driven from Python — at
    Python-call grain CPython's C-implemented dict/deque are already a
    native hash map with zero marshalling; the JAX package's measurement
    is in DESIGN.md "queue state machine alone"), and the native C++ core
    (``cpp/dbx_core.h`` ``DbxJobQueue`` — the reference's whole dispatcher
    state is native, reference ``src/server/main.rs:20-190``), opt-in here
    via ``use_native=True`` / ``DBX_NATIVE_QUEUE=1`` and the ONLY
    substrate when driven from a native shell through the C ABI. gRPC serving stays in Python (no grpc++
    in this environment). Full job records (grids, payloads, paths) stay
    Python-side keyed by the same ids.
    """

    def __init__(self, journal: Journal | None = None, *,
                 lease_s: float = 60.0, use_native: bool | None = None,
                 clock=None,
                 device: str = device_mod.DEFAULT_DEVICE):
        self._lock = threading.Lock()
        # Where scenario panels are materialized (the queue's one device
        # step): the card by default, so a materialized rung has the bits
        # of the spec route the worker runs there.
        self.device = device
        self._records: dict[str, JobRecord] = {}
        state = None
        if use_native is None:
            use_native = (os.environ.get("DBX_NATIVE_QUEUE") == "1"
                          and native_core.available())
        if use_native:
            try:
                state = native_core.NativeJobQueue()
            except RuntimeError:
                state = None
        self.substrate = "native" if state is not None else "python"
        if state is not None:
            self._state = state
        else:
            # ``clock`` (model-checker seam): virtual lease clock for the
            # python substrate; ignored on native (C-side clock — mc uses
            # lease_s=0 there for the same determinism).
            self._state = (_PyQueueState(clock=clock) if clock is not None
                           else _PyQueueState())
        # Content-addressed blob store of materialized DBX1 panels: hot
        # panels and requeued jobs never touch disk (or re-transcode CSV)
        # twice, and FetchPayload serves cache-missing workers from it.
        # digest -> job id of SOME record carrying that digest (last
        # stamped wins): the lazy-repopulation index — an evicted blob
        # re-materializes from that record's source.
        self.panel_store = panel_store_mod.PanelStore()
        self._digest_jobs: dict[str, str] = {}
        # Streaming append chain: extended-panel digest -> (parent digest,
        # delta bytes, base bar count). Populated by append_bars() and by
        # journal replay (`delta` events); an evicted extended panel
        # re-materializes by walking parents back to a payload source and
        # re-splicing (deterministic, so digests stay stable).
        self._delta_chain: dict[str, tuple[str, bytes, int]] = {}
        # Python-side mirror of completed ids (the native core keeps only
        # counts): maintained on every "new" completion + restore, read by
        # observers (chaos tests, operators) via completed_ids().
        self._completed_ids: set[str] = set()
        self._journal = journal or Journal(None)
        self.known_paths: set[str] = set()
        # Journaled (leg-y path -> leg-x path) pairings for two-legged jobs:
        # the journal is the authority on which x file a y file was paired
        # with, so restart intake can keep new pairings disjoint from old
        # ones instead of trusting sort position (y-glob
        # churn with equal counts silently re-assigns x legs).
        self.known_pairings: dict[str, str] = {}
        self.journaled_jobs = 0
        self.lease_s = lease_s
        self._t0 = time.monotonic()
        # Jobs popped by take_begin but not yet committed/failed (payload
        # materialization runs outside the lock): drained must stay False
        # through that window or an observer could tear the dispatcher down
        # with a job mid-dispatch.
        self._in_take = 0
        # Placement-deferred jobs, held OUT of the FIFO so the next
        # take() serves them FIRST (front of line — a tail re-push would
        # park a latency-critical live update behind the whole batch
        # backlog). Journaled-pending either way, so a crash loses
        # nothing; held ids re-enter through the admit filter each
        # round, which is what lets a job wait up to the deferral cap.
        self._placement_held: list[str] = []
        # Pending-digest refcounts for the placement stage's chain-
        # settling rule: digest -> how many NOT-YET-DISPATCHED jobs
        # carry it as their panel digest. An append link whose parent
        # is still in here has no carry holder anywhere yet, so the
        # score table cannot route it — the admit gate defers it
        # (within the same affinity_skips budget) until the parent
        # settles. Counts move under self._lock: incremented at
        # intake, decremented at lease commit or intake-side failure.
        # NOT journaled (restarts restart locality cold, like the rest
        # of the placement state); rare refcount drift (requeue after
        # lease expiry re-leases without re-incrementing) is bounded
        # harm — the cap bounds any wait either way.
        self._pending_digests: dict[str, int] = {}
        # Weighted-fair-queueing index (sched.wfq): EVERY pending job is
        # parked in a per-tenant lane, held OUT of the state machine's
        # FIFO under the same discipline as _placement_held — enqueue
        # pushes through the state machine (register + FIFO) and
        # immediately drains the FIFO into the lanes under the same
        # lock, so the FIFO is empty between public calls and the WFQ
        # pick alone decides dispatch order. `drained`/stats fold the
        # parked count back in, so the accounting stays exact. Weights/
        # quotas read from DBX_TENANT_WEIGHTS / DBX_TENANT_QUOTA here
        # (one scheduler per queue, lazily — never at import).
        self._sched = WfqScheduler()
        # Scenario memo: (base digest, canonical params) -> generated
        # panel digest, so N jobs sharing one scenario spec regenerate
        # once, and re-materialization after eviction skips straight to
        # a store probe. Bounded LRU — specs are wire-controlled input,
        # and nothing may grow per spec ever seen; an evicted memo entry
        # merely costs one regeneration (same digest by construction).
        self._scenario_digests: collections.OrderedDict = \
            collections.OrderedDict()
        # Per-spec in-flight generation guard: concurrent takes of
        # scenario jobs sharing one spec must not each run the
        # generator (the gRPC pool could burn 16x duplicate work per
        # spec); losers wait for the winner's event and re-probe.
        self._scn_inflight: dict[tuple[str, str], threading.Event] = {}
        # Per-thread scenario resolution chain (scenario-of-scenario
        # bases are legal; a corrupted spec graph must degrade loudly,
        # not recurse forever).
        self._scn_tl = threading.local()

    # Native substrate cap (cpp/dbx_core.h DBX_JOBQ_MAX_ID); enforced at
    # intake on BOTH substrates so behavior cannot diverge at the edge.
    MAX_ID_BYTES = 511

    # Scenario spec -> digest memo bound (entries are ~150 B; eviction
    # costs one deterministic regeneration, never a different digest).
    MAX_SCENARIO_MEMO = 4096

    # -- intake ------------------------------------------------------------

    def enqueue(self, rec: JobRecord, *, journal: bool = True) -> None:
        self.enqueue_many([rec], journal=journal)

    def enqueue_many(self, recs: list[JobRecord], *,
                     journal: bool = True) -> None:
        """Intake a batch with ONE state-machine crossing (register + push
        for the whole batch); journal appends stay per record. Same
        semantics as per-record :meth:`enqueue`, batched for the same
        reason as take/complete: per-job ctypes crossings dominated the
        native substrate's cost."""
        for rec in recs:
            if len(rec.id.encode()) > self.MAX_ID_BYTES:
                raise ValueError(
                    f"job id exceeds {self.MAX_ID_BYTES} bytes (native "
                    f"substrate cap, enforced on both substrates): "
                    f"{rec.id[:64]!r}...")
            if "\0" in rec.id:
                # The native batch pack is NUL-separated; an embedded NUL
                # would desynchronize the id<->index mirror from the C
                # intern table (enforced on both substrates).
                raise ValueError(f"job id contains NUL: {rec.id[:64]!r}")
        # Trace minting happens HERE — before the journal append — so the
        # id a restart restores is the id the first run's spans carried.
        # enqueue_ts is re-stamped per process (see JobRecord).
        now = time.time()
        for rec in recs:
            if not rec.tenant:
                # Legacy intake (empty tenant anywhere) normalizes HERE,
                # before the journal append — records and lanes agree.
                rec.tenant = DEFAULT_TENANT
            if not rec.trace_id:
                rec.trace_id = obs.new_trace_id()
            if not rec.enqueue_ts:
                rec.enqueue_ts = now
            # Content-address inline payloads HERE — before the journal
            # append — so the digest a restart restores is the address the
            # first run delivered to workers. File-backed payloads stamp at
            # first materialization (take) via a "digest" journal event.
            if rec.ohlcv is not None and not rec.panel_digest:
                rec.panel_digest = self.panel_store.put(rec.ohlcv)
            if rec.ohlcv2 is not None and not rec.panel_digest2:
                rec.panel_digest2 = self.panel_store.put(rec.ohlcv2)
        if journal and self._journal.enabled:
            # enabled-guarded: journal_form b64-encodes the payload, which
            # the no-op journal would throw away. Journal BEFORE the state
            # push makes the batch takeable: a worker can lease a job the
            # instant it is published, and a crash before its enqueue
            # record landed would orphan that in-flight job (restore would
            # not know it existed — a batch-wide loss window). A
            # journaled-but-unpublished job is merely re-enqueued by
            # replay, so this order bounds the loss at zero.
            for rec in recs:
                self._journal.append("enqueue", **rec.journal_form())
        with self._lock:
            for rec in recs:
                self._records[rec.id] = rec
                # Lazy-repopulation index: restored records arrive with
                # journaled digests but an empty store; FetchPayload and
                # take() re-materialize through this map.
                if rec.panel_digest:
                    self._digest_jobs[rec.panel_digest] = rec.id
                    self._pending_digests[rec.panel_digest] = \
                        self._pending_digests.get(rec.panel_digest, 0) + 1
                if rec.panel_digest2:
                    self._digest_jobs[rec.panel_digest2] = rec.id
            self._state.enqueue_n([rec.id for rec in recs],
                                  [float(rec.combos) for rec in recs])
            # Drain the batch straight out of the state FIFO into the
            # per-tenant WFQ lanes (same lock, so the FIFO is never
            # observably non-empty): the state machine keeps owning
            # register/lease/completion, the lanes own dispatch ORDER.
            for jid in self._state.take_begin_n(len(recs)):
                r = self._records[jid]
                self._sched.push(jid, r.tenant, float(r.combos))

    def restore(self, journal_path: str) -> int:
        """Replay a journal; re-enqueue pending jobs. Returns count restored.

        Also records what the journal already covers — ``known_paths`` (every
        file path ever enqueued, completed or not) and ``journaled_jobs`` —
        so a restarted ``main()`` can skip re-enqueueing work the previous
        run already dispatched (rerunning the documented
        command line after a crash must not duplicate completed jobs).
        """
        state = Journal.replay(journal_path)
        with self._lock:
            # Chain BEFORE jobs: a restored append job's first take
            # materializes through it.
            for ndig, rec in state.deltas.items():
                self._delta_chain[ndig] = (
                    str(rec.get("pdig", "")),
                    base64.b64decode(rec.get("delta_b64", "")),
                    int(rec.get("base_len", 0)))
        n = 0
        for jid in state.pending:
            self.enqueue(JobRecord.from_journal(state.jobs[jid]),
                         journal=False)
            n += 1
        with self._lock:
            for jid in state.completed:
                self._state.mark_completed(jid)
                self._completed_ids.add(jid)
            for jid in state.failed:
                self._state.mark_failed(jid)
            # Register terminal jobs' (slim) records too: a late duplicate
            # completion arriving after a restart must be answered as an
            # idempotent "dup", not "unknown".
            for jid, rec in state.jobs.items():
                if jid not in self._records:
                    r = JobRecord.from_journal(rec)
                    self._records[jid] = r
                    self._state.register(jid, float(r.combos))
                    if r.panel_digest:
                        self._digest_jobs.setdefault(r.panel_digest, jid)
                    if r.panel_digest2:
                        self._digest_jobs.setdefault(r.panel_digest2, jid)
        with self._lock:
            # Rehydrate restored append jobs' delta bytes from the chain:
            # without them a post-restart dispatch would ship empty
            # ohlcv AND empty append_delta to a base-holding worker,
            # forcing a full-panel FetchPayload — undoing the O(ΔT) wire
            # saving the delta-only leg exists for.
            for rec in self._records.values():
                if rec.append_parent and rec.delta is None:
                    link = self._delta_chain.get(rec.panel_digest)
                    if link is not None:
                        rec.delta = link[1]
        self.known_paths |= {rec["path"] for rec in state.jobs.values()
                             if rec.get("path")}
        self.known_pairings.update(
            {rec["path"]: rec["path2"] for rec in state.jobs.values()
             if rec.get("path") and rec.get("path2")})
        self.journaled_jobs += len(state.jobs)
        return n

    # -- dispatch ----------------------------------------------------------

    def take(self, n: int, worker_id: str, admit=None,
             scenario_spec: dict | None = None,
             explain: dict | None = None
             ) -> list[tuple[JobRecord, bytes]]:
        """Pop up to ``n`` jobs, lease them to ``worker_id``, return payloads.

        Batched against the state machine: ONE ``take_begin_n`` crossing
        pops the batch, payloads materialize outside every lock, then ONE
        ``take_commit_n`` crossing leases the readable ones (per-id
        re-check inside: a job completed in the unlocked window is
        dropped, not leased and recomputed — the single-id race model,
        batch-wide). Per-job crossings made the native substrate slower
        than the dict fallback (DESIGN.md's 42k-vs-85k row); one crossing
        per RPC is the fix.

        ``admit`` is the placement hook (``rec -> bool``, consulted for
        EVERY popped record — round 20 generalized the append-only
        affinity special case away): a False verdict defers the job —
        held OUT of the FIFO (front of line: the NEXT take() call, from
        any worker, sees held jobs before the FIFO and runs them
        through its own admit again) — so a better-scored worker gets
        first claim without the job losing its place behind a batch
        backlog. The callback MUST bound its own deferrals
        (``JobRecord.affinity_skips`` is the budget the round-20
        placement gate spends, capped at ``DBX_PLACEMENT_DEFER_CAP``);
        a held job whose budget is spent is served to ANYONE, so
        placement can delay a job by a bounded number of poll rounds,
        never starve it. WFQ fairness is untouched: the pick (and its
        quota charge) happened before the hook runs, and a deferred job
        keeps its place at the front.

        ``scenario_spec`` (a dict, or None) opts the caller into the
        scenario-megakernel spec dispatch: an eligible scenario record
        whose BASE panel is servable skips materialization entirely —
        its returned payload is the BASE panel's bytes and the dict
        gains ``record id -> base digest`` so the caller can coalesce
        the records into spec-batch JobSpecs (the worker regenerates
        each panel in-trace). ``None`` (every legacy caller) keeps the
        materialized path verbatim, and so does any record that fails
        the eligibility gate — the fallback ladder is "don't coalesce",
        nothing else changes.

        ``explain`` (a dict, or None) opts into the round-19 decision
        plane: the WFQ pick-time explain record of every popped job
        lands under its id (a ``sched.explain.PickExplain``; jobs
        served from the affinity-held list get the minimal
        ``held_explain`` dict). Captured under the same lock as the
        pick itself, from the pick's own values — the record cannot
        drift from the decision, and ``None`` (every legacy caller)
        pays nothing. Serialization (``as_dict()``) is the consumer's
        job, off this path — the decision plane does it on its scoring
        thread.
        """
        out: list[tuple[JobRecord, bytes]] = []
        deferred: list[str] = []
        try:
            return self._take_inner(n, worker_id, admit, out, deferred,
                                    scenario_spec, explain)
        finally:
            if deferred:
                with self._lock:
                    # Held OUT of the FIFO, counted as in-take: `drained`
                    # must not flicker True with a live job in neither
                    # pending nor leased, and the next take() drains the
                    # held list before popping the FIFO.
                    self._placement_held.extend(deferred)

    def _digest_settled(self, digest: str) -> None:
        """Release one pending-digest refcount (caller holds ``_lock``):
        a job carrying this panel digest just left the pending pool —
        leased (the digest now HAS a holder the score table can route
        on) or failed at intake (it never will). ``get``-guarded: file-
        backed payloads stamp their digest at first materialization,
        AFTER intake counted nothing for them."""
        if not digest:
            return
        left = self._pending_digests.get(digest, 0) - 1
        if left > 0:
            self._pending_digests[digest] = left
        else:
            self._pending_digests.pop(digest, None)

    def _take_inner(self, n, worker_id, admit, out, deferred,
                    scenario_spec=None, explain=None):
        first = True
        while len(out) < n:
            with self._lock:
                jids = []
                if first:
                    # Previously placement-deferred jobs go first — they
                    # were at (or near) the FIFO head when deferred.
                    # They re-enter the admit loop below, so a job keeps
                    # deferring until its budget caps out.
                    first = False
                    k = min(len(self._placement_held), n - len(out))
                    if k:
                        jids = self._placement_held[:k]
                        self._placement_held = self._placement_held[k:]
                        # Already counted in _in_take while held; the
                        # per-iteration accounting below re-counts every
                        # id in `jids`, so release the held count here.
                        self._in_take -= k
                        if explain is not None:
                            for j in jids:
                                explain[j] = held_explain(j)
                # The WFQ pick replaces the FIFO pop: lowest virtual
                # start tag across tenant lanes, quota-demoted tenants
                # behind everyone else (sched.wfq).
                exp_list = [] if explain is not None else None
                jids += self._sched.pick(n - len(out) - len(jids),
                                         explain=exp_list)
                if exp_list:
                    for e in exp_list:
                        explain[e.jid] = e
                if not jids:
                    break
                # A popped id with no record is a state/record desync
                # (cannot happen through the public intake path, which
                # registers the record first) — fail it loudly instead of
                # crashing with the whole batch in limbo.
                desynced = [j for j in jids if j not in self._records]
                for j in desynced:
                    self._state.fail(j)
                    self._sched.release(j)
                jids = [j for j in jids if j not in desynced]
                recs = [self._records[j] for j in jids]
                n_deferred0 = len(deferred)
                if admit is not None:
                    kept_j, kept_r = [], []
                    for j, r in zip(jids, recs):
                        # ONE admit call per rec: the callback counts its
                        # own deferrals on the record.
                        if not admit(r):
                            deferred.append(j)
                        else:
                            kept_j.append(j)
                            kept_r.append(r)
                    jids, recs = kept_j, kept_r
                # Deferred ids count as in-take for as long as they sit
                # in _placement_held (neither pending nor leased); the
                # count releases when a later take() re-serves them.
                self._in_take += len(jids) + len(deferred) - n_deferred0
            good: list[tuple[str, JobRecord, bytes]] = []
            # id, path, err, stored record (the record rides along so the
            # fail path can close the job's trace and hand the flight
            # recorder a stitchable subject).
            failed: list[tuple[str, str, Exception, JobRecord]] = []
            resolved: set[str] = set()   # leased, failed, or completed
            stamped: list[tuple[str, JobRecord]] = []  # first-materialized
            try:
                # Inside the try: a journal error here must still reach
                # the push-back handler / _in_take decrement below, or
                # the rest of the popped batch is stranded.
                for j in desynced:
                    log.error("job %s: popped with no record (state "
                              "desync) -> failed", j)
                    self._journal.append("fail", id=j,
                                         reason="no job record")
                    obs_flight.trigger("job_fail", subject=j,
                                       reason="no job record")
                for jid, stored in zip(jids, recs):
                    rec = stored
                    payload = stored.ohlcv
                    try:
                        if (payload is None and scenario_spec is not None
                                and self._scenario_spec_eligible(stored)):
                            # Scenario megakernel spec dispatch: serve
                            # the BASE panel's bytes instead of
                            # generating the scenario panel — the worker
                            # regenerates it in-trace inside the fused
                            # sweep. An unservable base simply drops
                            # through to the materialized rung below
                            # (whose own triage decides loud-fail vs
                            # serve), so eligibility can never turn a
                            # dispatchable job into a failed one.
                            base_d = str(stored.scenario.get("base", ""))
                            blob = self.payload_for_digest(base_d)
                            if blob is not None:
                                scenario_spec[jid] = base_d
                                good.append((jid, stored, blob))
                                continue
                        if payload is None:
                            # Store-first materialization: a hot panel or
                            # a requeued/retried job never re-reads (or
                            # re-transcodes) the file. The digest stamps
                            # the STORED record on first materialization
                            # and is journaled below, so restarts keep the
                            # address stable.
                            payload, d = self._materialize(
                                stored.panel_digest, stored.path,
                                scenario=stored.scenario)
                            if d != stored.panel_digest:
                                stored.panel_digest = d
                                stamped.append((jid, stored))
                        if stored.ohlcv2 is None and stored.path2 is not None:
                            # File-backed second leg (pairs --data2):
                            # materialize at dispatch time like leg 1,
                            # onto a COPY handed to the caller — the
                            # stored record stays slim, and RequestJobs
                            # reads rec.ohlcv2 either way.
                            blob2, d2 = self._materialize(
                                stored.panel_digest2, stored.path2)
                            if d2 != stored.panel_digest2:
                                stored.panel_digest2 = d2
                                stamped.append((jid, stored))
                            rec = dataclasses.replace(stored, ohlcv2=blob2)
                    except (OSError, ValueError) as e:
                        # Leg 1 read fine -> the unreadable file was leg 2.
                        failed.append((
                            jid,
                            stored.path2 if payload is not None
                            else stored.path,
                            e, stored))
                        continue
                    good.append((jid, rec, payload))
                with self._lock:
                    for jid, r in stamped:
                        if r.panel_digest:
                            self._digest_jobs[r.panel_digest] = jid
                        if r.panel_digest2:
                            self._digest_jobs[r.panel_digest2] = jid
                    committed = self._state.take_commit_n(
                        [jid for jid, _, _ in good], worker_id,
                        self.lease_s)
                    # The quota charge landed at PICK (so concurrent
                    # takes can't both read a stale zero); here it is
                    # confirmed for leased ids and released for ids
                    # that fell out (completed mid-take — complete()
                    # already released, release is idempotent).
                    for ok, (jid, r, _) in zip(committed, good):
                        if ok:
                            self._sched.on_lease(jid, r.tenant,
                                                 float(r.combos))
                            # The digest has a holder now: any chain
                            # child waiting on it can route on the next
                            # table refresh instead of burning polls.
                            self._digest_settled(r.panel_digest)
                        else:
                            self._sched.release(jid)
                    # Every triaged id is resolved — including a failed-
                    # triage id whose fail() returns False below because
                    # a completion landed mid-take: that job is DONE, and
                    # the push-back handler must not return it to pending.
                    resolved = {jid for jid, _, _ in good}
                    resolved.update(jid for jid, _, _, _ in failed)
                    # Unreadable payloads fail under the same lock (the
                    # per-id re-check drops jobs completed mid-take);
                    # either way the pick-time quota charge releases.
                    for jid, _, _, _ in failed:
                        self._sched.release(jid)
                    failed = [(jid, path, e, r)
                              for jid, path, e, r in failed
                              if self._state.fail(jid)]
                    for _, _, _, r in failed:
                        # A failed job's digest will never be held —
                        # release the refcount so chain children stop
                        # waiting on it before their cap runs out.
                        self._digest_settled(r.panel_digest)
                for jid, path, e, r in failed:
                    log.error("job %s: unreadable %s (%s) -> failed",
                              jid, path, e)
                    self._journal.append("fail", id=jid, reason=str(e))
                    # Close the job's trace before the black-box fires:
                    # the flight bundle's stitched timeline must cover
                    # the job end-to-end even though it never dispatched
                    # (enqueue -> failure is its whole life).
                    if r.trace_id and r.enqueue_ts:
                        now_w = time.time()
                        wait = max(now_w - r.enqueue_ts, 0.0)
                        obs.emit_span("job.queue_wait", r.enqueue_ts,
                                      wait, trace_id=r.trace_id, job=jid)
                        obs.emit_span("job", r.enqueue_ts, wait,
                                      trace_id=r.trace_id, job=jid,
                                      ok=False)
                    obs_flight.trigger("job_fail", subject=jid,
                                       job=jid, path=str(path),
                                       reason=str(e))
                # Durable digest stamps (first materialization only — one
                # event per job, merged into its enqueue record on replay
                # and at compaction): a restarted dispatcher keeps
                # addressing the panel a prior run already delivered.
                for jid, r in dict(stamped).items():
                    self._journal.append(
                        "digest", id=jid, pdig=r.panel_digest,
                        **({"pdig2": r.panel_digest2}
                           if r.panel_digest2 else {}))
                out.extend((rec, payload)
                           for ok, (_, rec, payload) in zip(committed, good)
                           if ok)
            except BaseException:
                # Anything unexpected between the pop and the commit would
                # otherwise strand the WHOLE popped batch — neither
                # pending, leased, completed, nor failed, and invisible to
                # lease expiry — while drained() flips True. Push the
                # unresolved ids back to pending before propagating.
                with self._lock:
                    unresolved = [j for j in jids if j not in resolved]
                    for jid in unresolved:
                        self._sched.release(jid)
                    self._sched.requeue_front([
                        (jid, self._records[jid].tenant,
                         float(self._records[jid].combos))
                        for jid in unresolved])
                raise
            finally:
                with self._lock:
                    self._in_take -= len(jids)
        return out

    def _scenario_spec_eligible(self, rec: "JobRecord") -> bool:
        """Can this record ride the scenario-megakernel spec dispatch?
        Plain single-asset scenario sweeps of a fused-supported family
        only — any reduction/windowing mode, a second leg, or a
        digestless base keeps the record on the materialized rung (the
        degradation ladder's "don't coalesce" answer, never an error).
        The kernel-family probe imports ops.fused lazily: the dispatcher
        stays kernel-free until a spec-capable worker actually polls with
        scenario records queued — the same moment the alternative was a
        full generator run."""
        if (rec.scenario is None or rec.append_parent or rec.wf_train
                or rec.top_k or rec.best_returns
                or rec.ohlcv2 is not None or rec.path2 is not None):
            return False
        if not str(rec.scenario.get("base", "")):
            return False
        try:
            from ..ops import fused
        except Exception:          # noqa: BLE001 — kernel stack absent
            return False
        return bool(fused.scenario_supported(rec.strategy))

    def _materialize(self, digest: str, path: str | None,
                     scenario: dict | None = None) -> tuple[bytes, str]:
        """One leg's payload bytes + content digest, blob store first.

        Only reads (and CSV/Parquet-transcodes) ``path`` — or regenerates
        a ``scenario`` panel — when the store cannot serve ``digest``:
        the second and every later take of a hot panel, and every
        requeue/retry, never touch disk (or the generator) again. The
        returned digest is always the digest OF THE RETURNED BYTES (a file
        whose content changed between materializations re-addresses; the
        caller re-stamps and journals)."""
        if digest:
            blob = self.panel_store.get(digest)
            if blob is not None:
                return blob, digest
        if path is None:
            if scenario is not None:
                # Digest-seeded synthesis: the panel is a pure function
                # of (base digest, params) — regeneration under the same
                # spec re-derives the same bytes, hence the same address.
                return self._scenario_payload(scenario, digest)
            if digest:
                # Streaming append jobs carry no payload source of their
                # own: the extended panel rebuilds from the delta chain.
                blob = self._splice_from_chain(digest)
                if blob is not None:
                    return blob, digest
            raise ValueError("job has neither payload nor path")
        blob = _read_payload(path)
        return blob, self.panel_store.put(blob)

    def _scenario_payload(self, scn: dict,
                          digest_hint: str = "") -> tuple[bytes, str]:
        """Materialize a scenario job's panel: memo/store first, else
        resolve the base panel (any payload source, incl. the append
        chain and nested scenario specs) and run the generator. Raises
        ``ValueError`` when the base is unservable or the spec invalid —
        the take() triage then fails the ONE job loudly, exactly like an
        unreadable file."""
        from .. import scenarios as scenarios_mod

        params = scenarios_mod.ScenarioParams.from_dict(scn)
        base_digest = str(scn.get("base", ""))
        key = (base_digest, params.canonical())
        # Cycle check BEFORE the single-flight gate: a corrupt
        # self-referential spec chain re-enters this method on the same
        # thread — it must raise loudly here, not wait on its own event.
        if base_digest in getattr(self._scn_tl, "seen", ()):
            raise ValueError(
                f"scenario base chain cycles at {base_digest[:16]}")
        while True:
            with self._lock:
                digest = self._scenario_digests.get(key, "") or digest_hint
                if key in self._scenario_digests:
                    self._scenario_digests.move_to_end(key)
            if digest:
                blob = self.panel_store.get(digest)
                if blob is not None:
                    return blob, digest
            # Single-flight per spec: the first thread generates, racers
            # wait on its event and re-probe (a failed/evicted result
            # makes the waiter take over — never a hang; spec references
            # form a DAG, so cross-thread waits cannot cycle).
            with self._lock:
                ev = self._scn_inflight.get(key)
                if ev is None:
                    ev = self._scn_inflight[key] = threading.Event()
                    break
            ev.wait(timeout=120.0)
        try:
            return self._scenario_generate(scn, key, params, base_digest)
        finally:
            with self._lock:
                self._scn_inflight.pop(key, None)
            ev.set()

    def _scenario_generate(self, scn: dict, key, params,
                           base_digest: str) -> tuple[bytes, str]:
        """The generation half of :meth:`_scenario_payload` (runs as the
        per-spec single-flight winner)."""
        from .. import scenarios as scenarios_mod

        seen = getattr(self._scn_tl, "seen", None)
        if seen is None:
            seen = self._scn_tl.seen = set()
        if base_digest in seen:
            raise ValueError(
                f"scenario base chain cycles at {base_digest[:16]}")
        seen.add(base_digest)
        try:
            base = self._payload_from_source(base_digest)
            if base is None:
                base = self._splice_from_chain(base_digest)
            if base is None:
                raise ValueError(
                    f"scenario base {base_digest[:16]} not servable "
                    "(store evicted and no job carries its source)")
        finally:
            seen.discard(base_digest)
        blob = scenarios_mod.scenario_panel_bytes(base, params,
                                                  device=self.device)
        d = self.panel_store.put(blob)
        with self._lock:
            self._scenario_digests[key] = d
            self._scenario_digests.move_to_end(key)
            while len(self._scenario_digests) > self.MAX_SCENARIO_MEMO:
                self._scenario_digests.popitem(last=False)
        return blob, d

    def _splice_from_chain(self, digest: str) -> bytes | None:
        """Rebuild an extended panel from its journaled append chain:
        walk parents down to the nearest servable payload source, then
        splice every delta back up, storing each level — so the NEXT
        lookup anywhere on the chain is a store hit. Iterative with a
        visited-set guard (content digests cannot cycle by construction,
        but a corrupted journal must degrade, not hang): an arbitrarily
        long live stream stays servable after a restart. None when the
        chain is broken (no ancestor has a payload source) — the caller
        degrades exactly like an evicted ordinary digest."""
        chain: list[tuple[str, bytes]] = []
        seen: set[str] = set()
        d = digest
        base = None
        while True:
            if d in seen:
                log.error("append chain for %s cycles at %s; unservable",
                          digest[:16], d[:16])
                return None
            seen.add(d)
            with self._lock:
                link = self._delta_chain.get(d)
            if link is None:
                return None          # broken before any payload source
            parent, delta, _base_len = link
            chain.append((d, delta))
            base = self._payload_from_source(parent)
            if base is not None:
                break
            d = parent
        for d, delta in reversed(chain):
            try:
                base = data_mod.splice_wire_bytes(base, delta)
            except ValueError as e:
                log.error("append chain for %s does not splice (%s); "
                          "unservable", digest[:16], e)
                return None
            self.panel_store.put(base, d)
        return base

    def payload_for_digest(self, digest: str) -> bytes | None:
        """Serve a FetchPayload request: blob store first, then lazy
        re-materialization from the indexed record's source (inline bytes,
        file, or the streaming delta chain — the restart path: journaled
        digests arrive before any blob does). None when the digest is not
        servable at all (store evicted AND source gone or changed) — the
        dispatcher then forgets it was delivered so the next dispatch
        ships full bytes."""
        blob = self._payload_from_source(digest)
        if blob is not None:
            return blob
        # Append jobs have no payload source of their own — the extended
        # panel rebuilds from the journaled delta chain.
        return self._splice_from_chain(digest)

    def _payload_from_source(self, digest: str) -> bytes | None:
        """Store + record-source half of :meth:`payload_for_digest` (NO
        chain fallback — the chain walk calls this per ancestor)."""
        if not digest:
            return None
        blob = self.panel_store.get(digest)
        if blob is not None:
            return blob
        with self._lock:
            jid = self._digest_jobs.get(digest)
            rec = self._records.get(jid) if jid else None
        if rec is None:
            return None
        for inline, path, d in ((rec.ohlcv, rec.path, rec.panel_digest),
                                (rec.ohlcv2, rec.path2,
                                 rec.panel_digest2)):
            if d != digest:
                continue
            if inline is not None:
                self.panel_store.put(inline, digest)
                return inline
            if path is not None:
                try:
                    blob = _read_payload(path)
                except (OSError, ValueError):
                    return None
                if panel_store_mod.panel_digest(blob) != digest:
                    return None   # source changed under the address
                self.panel_store.put(blob, digest)
                return blob
        if rec.scenario is not None and rec.panel_digest == digest:
            # Evicted scenario panel: re-derive it from the spec (pure
            # function of base digest + params — the regenerated bytes
            # carry the SAME address, verified before serving).
            try:
                blob, d = self._scenario_payload(rec.scenario, digest)
            except ValueError:
                return None
            return blob if d == digest else None
        return None

    def extend_chain(self, parent_digest: str, base_len: int,
                     delta: bytes) -> tuple[str, str, int]:
        """Splice ``delta`` onto the stored base panel and journal the
        chain link — the tick half of AppendBars, shared by the job
        template AND the subscription tier's per-stream advances (one
        splice per tick, however many streams fan out of it).

        Returns ``(outcome, new_digest, new_len)``; a reject outcome
        (``base_missing`` / ``bad_delta`` / ``base_len_mismatch``)
        carries an empty digest (``base_len_mismatch`` reports the REAL
        base length in ``new_len`` for caller re-sync). Journal order:
        the ``delta`` event lands BEFORE any job's enqueue record, so a
        restored append job always finds its chain; a crash in between
        merely leaves a harmless orphan link."""
        base = self.payload_for_digest(parent_digest)
        if base is None:
            return "base_missing", "", 0
        base_series = data_mod.from_wire_bytes(base)
        if base_len and base_len != base_series.n_bars:
            # Stale feed guard, checked BEFORE any splice work: the
            # caller believes a different history length than the stored
            # base — appending would silently misalign every later bar.
            # Reject near-free; the caller re-syncs off the reply's
            # digest/new_len.
            return "base_len_mismatch", "", base_series.n_bars
        try:
            d_series = data_mod.from_wire_bytes(delta)
            if d_series.n_bars < 1:
                raise ValueError("empty delta slice")
        except ValueError:
            return "bad_delta", "", 0
        # One decode each + one encode (splice_wire_bytes would re-decode
        # both blobs — the live-serving hot path skips that).
        blob = data_mod.to_wire_bytes(data_mod.OHLCV(*(
            np.concatenate([np.asarray(b), np.asarray(d)])
            for b, d in zip(base_series, d_series))))
        ndig = self.panel_store.put(blob)
        new_len = base_series.n_bars + d_series.n_bars
        if self._journal.enabled:
            self._journal.append(
                "delta", ndig=ndig, pdig=parent_digest,
                base_len=base_series.n_bars,
                delta_b64=base64.b64encode(delta).decode("ascii"))
        with self._lock:
            self._delta_chain[ndig] = (parent_digest, delta,
                                       base_series.n_bars)
        return "extended", ndig, new_len

    def make_append_record(self, ndig: str, *, strategy: str, grid,
                           cost: float = 0.0, periods_per_year: int = 252,
                           tenant: str = DEFAULT_TENANT
                           ) -> JobRecord | None:
        """A repricing JobRecord for the extended panel ``ndig`` (NOT
        enqueued — the caller may need to index the id first, e.g. the
        subscription hub's register-before-enqueue discipline). The
        append linkage (parent, base length, delta bytes) comes from the
        chain ``extend_chain`` just recorded; None when ``ndig`` has no
        chain link (caller bug or a raced restart)."""
        with self._lock:
            link = self._delta_chain.get(ndig)
        if link is None:
            return None
        parent, delta, base_n = link
        return JobRecord(
            id=str(uuid.uuid4()), strategy=strategy, grid=grid,
            cost=float(cost), periods_per_year=int(periods_per_year),
            panel_digest=ndig, append_parent=parent,
            append_base_len=base_n, delta=delta,
            tenant=tenant or DEFAULT_TENANT)

    def append_bars(self, parent_digest: str, base_len: int, delta: bytes,
                    *, strategy: str, grid, cost: float = 0.0,
                    periods_per_year: int = 252,
                    tenant: str = DEFAULT_TENANT
                    ) -> tuple[JobRecord | None, str, str, int]:
        """Streaming live-bar ingest (the AppendBars RPC's queue half):
        :meth:`extend_chain` + one enqueued repricing job for the
        extended panel. An EMPTY ``strategy`` is a tick-only append —
        the chain extends (and the subscription tier's advances ride
        it, dispatcher-side) but no template job enqueues.

        Returns ``(record, outcome, new_digest, new_len)`` — record None
        with a reject outcome (``unsupported_strategy`` /
        ``base_missing`` / ``bad_delta`` / ``base_len_mismatch``) when
        nothing was enqueued, and None with ``extended`` for tick-only
        appends.
        """
        if strategy and strategy not in STREAMABLE_STRATEGIES:
            # Reject synchronously — enqueueing would burn a dispatch
            # round trip only for the worker to complete it loudly empty
            # (pairs cannot stream over a one-panel wire; unknown
            # families have no carry).
            return None, "unsupported_strategy", "", 0
        outcome, ndig, new_len = self.extend_chain(parent_digest,
                                                   base_len, delta)
        if outcome != "extended":
            return None, outcome, ndig, new_len
        rec = None
        if strategy:
            rec = self.make_append_record(
                ndig, strategy=strategy, grid=grid, cost=cost,
                periods_per_year=periods_per_year, tenant=tenant)
            self.enqueue(rec)
        return rec, "extended", ndig, new_len

    def complete(self, jid: str, worker_id: str) -> str:
        """Record a completion (idempotent). Returns ``"new"`` for a first
        completion, ``"dup"`` for a known-and-already-completed id, and
        ``"unknown"`` for ids the queue has never seen. (The new/dup split
        lets batched-completion replies report only newly-recorded jobs, so
        a worker retrying a deadline-expired-but-processed RPC does not
        over-count its own jobs_completed.)

        Handles late/duplicate completions from retrying workers: the lease is
        always cleared (a re-leased job completed twice must not pin a ghost
        lease), and a job completed while still pending (e.g. a completion
        RPC that straddled a dispatcher restart) is pulled out of the queue so
        it is not dispatched again.
        """
        with self._lock:
            outcome = self._state.complete(jid)
            if outcome != "new":
                return outcome
            self._completed_ids.add(jid)
            self._finish_complete(jid)
        self._journal.append("complete", id=jid, worker=worker_id)
        return "new"

    def _finish_complete(self, jid: str) -> None:
        """Scheduler bookkeeping for a first ("new") completion; caller
        holds ``self._lock``. A completion for a job still PARKED in a
        WFQ lane (a late completion that straddled a requeue or restart)
        leaves the state machine with an orphan tombstone — its FIFO is
        empty under the lane discipline. Discard the lane entry and
        drive the state's documented completed-in-the-take-window path
        (``take_commit`` on a completed id returns False and clears the
        tombstone) so pending counts and ``drained`` stay exact instead
        of waiting for the next worker poll to sweep it. The quota
        charge releases either way (idempotent). No suppression needed:
        interprocedural lock-discipline proves every caller holds the
        lock."""
        if self._sched.discard(jid):
            self._state.take_commit(jid, "wfq", self.lease_s)
        self._sched.release(jid)

    def complete_batch(self, jids: list[str], worker_id: str, *,
                       journal: bool = True) -> list[str]:
        """Batched :meth:`complete`: one state-machine crossing for a
        whole CompleteJobs RPC (per-id outcomes identical — the batch
        exists because per-job ctypes crossings made the native substrate
        slower than the dict fallback).

        ``journal=False`` defers the durable 'complete' records so the
        caller can persist the result blocks FIRST and then call
        :meth:`journal_completions` — a journaled-complete whose .dbxm
        block never landed is unrecoverable (the job is never
        re-dispatched), and with batched RPCs that window would span a
        whole batch, not one job. A crash in the
        state-complete-but-unjournaled window merely re-runs the batch
        after restart (idempotent overwrite).
        """
        if not jids:
            return []
        with self._lock:
            outcomes = self._state.complete_n(jids)
            for jid, outcome in zip(jids, outcomes):
                if outcome == "new":
                    self._completed_ids.add(jid)
                    self._finish_complete(jid)
        if journal:
            for jid, outcome in zip(jids, outcomes):
                if outcome == "new":
                    self._journal.append("complete", id=jid,
                                         worker=worker_id)
        return outcomes

    def journal_completions(self, jids: list[str], worker_id: str) -> None:
        """Durable 'complete' records for ids whose result blocks the
        caller has already persisted (the deferred half of
        ``complete_batch(journal=False)``)."""
        for jid in jids:
            self._journal.append("complete", id=jid, worker=worker_id)

    def completed_ids(self) -> set[str]:
        """Snapshot of completed job ids (restored + this run's)."""
        with self._lock:
            return set(self._completed_ids)

    def job_trace(self, jid: str) -> tuple[str, float]:
        """``(trace_id, enqueue_ts)`` of a known job, ``("", 0.0)`` for
        unknown ids — the completion handlers' lookup for closing the
        job's end-to-end span (the queue's record is authoritative; the
        wire echo on CompleteItem is advisory)."""
        with self._lock:
            rec = self._records.get(jid)
            return (rec.trace_id, rec.enqueue_ts) if rec else ("", 0.0)

    # -- recovery ----------------------------------------------------------

    def requeue_expired(self) -> list[str]:
        """Re-queue jobs whose lease deadline passed (front of the queue)."""
        with self._lock:
            jids = self._state.requeue_expired()
            self._repark_requeued(jids)
            self._restart_queue_wait(jids)
            return jids

    def requeue_worker(self, worker_id: str) -> list[str]:
        """Re-queue every job leased to a (pruned) worker."""
        with self._lock:
            jids = self._state.requeue_worker(worker_id)
            self._repark_requeued(jids)
            self._restart_queue_wait(jids)
            return jids

    def _repark_requeued(self, jids: list[str]) -> None:
        """Move just-requeued ids from the state FIFO (where requeue_*
        push-fronts them) into their tenants' WFQ lanes, preserving the
        FIFO's service order at the lane FRONTS — a retried job keeps
        its requeue-at-front latency class instead of re-waiting behind
        the tenant's whole backlog. Also releases the quota charge
        (the lease is gone). Caller holds ``self._lock``; the FIFO is
        empty outside this window, so the drain pops exactly ``jids``."""
        if not jids:
            return
        for jid in jids:
            self._sched.release(jid)
        self._sched.requeue_front([
            (jid, rec.tenant if rec else DEFAULT_TENANT,
             float(rec.combos) if rec else 1.0)
            for jid in self._state.take_begin_n(len(jids))
            for rec in (self._records.get(jid),)])

    def _restart_queue_wait(self, jids: list[str]) -> None:
        # A requeued job re-enters the pending pool NOW: restart its
        # queue-wait clock (same semantics as a journal restore) so the
        # re-dispatch's queue_wait span covers the second wait — not the
        # failed first attempt's whole lifetime, which would override
        # the attempt's own spans in timeline attribution.
        now = time.time()
        for jid in jids:
            rec = self._records.get(jid)
            if rec is not None:
                rec.enqueue_ts = now

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            s = self._state.stats()
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            return {
                # Pending = WFQ-parked jobs (the state FIFO is empty
                # between calls under the lane discipline; the sum keeps
                # the count exact through transient windows).
                "jobs_pending": s["pending"] + self._sched.pending(),
                "jobs_leased": s["leased"],
                "jobs_completed": s["completed"],
                "jobs_requeued": s["requeued"],
                "jobs_failed": s["failed"],
                "backtests_per_sec": s["combos_done"] / elapsed,
            }

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant scheduling snapshot (parked backlog, in-flight
        combo charge, virtual finish, demotions) — the source behind the
        ``dbx_tenant_queue_jobs{tenant=...}`` gauge family."""
        with self._lock:
            return self._sched.stats()

    @property
    def drained(self) -> bool:
        with self._lock:
            # _in_take covers jobs popped but not yet leased/failed (payload
            # read in flight); WFQ-parked jobs are live pending work held
            # out of the state FIFO: drained must not flicker True while
            # either is non-zero.
            return (self._in_take == 0 and self._sched.pending() == 0
                    and self._state.drained())


def _read_payload(path: str) -> bytes:
    """Read a job's OHLCV payload; CSV and Parquet files are transcoded to
    DBX1 binary (format sniffed by magic: ``PAR1`` = Parquet, ``DBX1`` =
    already wire-ready, anything else = CSV)."""
    t0 = time.perf_counter()
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:4] == b"PAR1":
        raw = data_mod.to_wire_bytes(data_mod.from_parquet_bytes(raw))
    elif raw[:4] != b"DBX1":
        series = data_mod.from_csv_bytes(raw)
        raw = data_mod.to_wire_bytes(series)
    log.info("read %s (%d bytes) in %.1fms",
             path, len(raw), 1e3 * (time.perf_counter() - t0))
    return raw


# ---------------------------------------------------------------------------
# Peer registry + liveness pruning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Peer:
    status: int = pb.WORKER_STATUS_IDLE
    chips: int = 0
    last_seen: float = 0.0


class PeerRegistry:
    """Live workers keyed by stable worker_id; any RPC refreshes liveness.

    Liveness timing (last-seen stamping + windowed pruning — the hot path
    touched by every RPC and the maintenance thread) runs on the native C++
    registry when available (SURVEY.md §2.2 native ledger; the reference's
    pruning loop is native, reference ``src/server/main.rs:39-52``); the
    Python side keeps only per-peer metadata (status, chips). Falls back to
    a pure-Python clock map when the core is absent.
    """

    def __init__(self, *, prune_window_s: float = 10.0,
                 use_native: bool | None = None):
        self._lock = threading.Lock()
        self._peers: dict[str, Peer] = {}
        self.prune_window_s = prune_window_s
        self._native = None
        if use_native is None:
            use_native = native_core.available()
        if use_native:
            try:
                self._native = native_core.NativeRegistry(prune_window_s)
            except RuntimeError:
                self._native = None
        self.substrate = "native" if self._native is not None else "python"

    def touch(self, worker_id: str, *, chips: int | None = None,
              status: int | None = None) -> bool:
        """Refresh a peer; returns True if this is a new registration."""
        now = time.monotonic()
        with self._lock:
            if self._native is not None:
                is_new = self._native.touch(worker_id)
            else:
                is_new = worker_id not in self._peers
            peer = self._peers.setdefault(worker_id, Peer())
            peer.last_seen = now
            if chips is not None:
                peer.chips = chips
            if status is not None and peer.status != status:
                log.info("worker %s: %s -> %s", worker_id,
                         pb.WorkerStatus.Name(peer.status),
                         pb.WorkerStatus.Name(status))
                peer.status = status
        return is_new

    def prune(self) -> list[str]:
        """Drop peers silent for longer than the window; return their ids."""
        with self._lock:
            if self._native is not None:
                dead = self._native.prune()
            else:
                cutoff = time.monotonic() - self.prune_window_s
                dead = [wid for wid, p in self._peers.items()
                        if p.last_seen < cutoff]
            for wid in dead:
                self._peers.pop(wid, None)
        return dead

    def alive(self) -> int:
        with self._lock:
            if self._native is not None:
                return self._native.alive()
            return len(self._peers)


# ---------------------------------------------------------------------------
# The gRPC servicer + server lifecycle
# ---------------------------------------------------------------------------

def _scenario_fused_enabled() -> bool:
    """Twin of ``ops.fused.scenario_fused_enabled`` (the
    ``DBX_SCENARIO_FUSED`` kill switch), inlined so the dispatcher never
    imports the kernel module just to read an env flag. Read per
    RPC: flipping the switch stops NEW spec batches on the next poll."""
    return os.environ.get("DBX_SCENARIO_FUSED", "1") != "0"


class _PlacementGate:
    """One poll's live placement verdicts (``Dispatcher._placement_gate``):
    the admit closure plus the state it accumulates under the queue lock
    — per-job placement info for the decision records and outcome counts
    for the metrics — both drained by RequestJobs after take() returns."""

    __slots__ = ("admit", "info", "counts", "served_digests")

    def __init__(self):
        self.admit = None
        self.info: dict = {}
        self.counts = {"served": 0, "deferred": 0, "cap": 0}
        # Panel digests served THIS poll: the pending-digest refcount
        # only drops at lease commit (a later lock block), so without
        # this a chain child popped in the same batch as its parent
        # would still see the parent "pending" and burn a deferral.
        self.served_digests: set = set()


def _timed_rpc(method: str):
    """Record the handler's wall into ``dbx_rpc_seconds{method=...}``.

    The histogram child is pre-resolved in ``__init__``; ``obs.timer`` is
    the shared observe-on-exit contract (same one the worker-side RPC
    timings use)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, request, context):
            with obs.timer(self._h_rpc[method]):
                return fn(self, request, context)
        return wrapper
    return deco


class Dispatcher(service.DispatcherServicer):
    """Wires the queue + registry behind the 5-RPC contract."""

    # In-memory DBXM blocks kept when no results_dir is configured. Beyond
    # this, the oldest block is evicted with a loud warning — an unbounded
    # dict would grow forever over a long fleet run (each block is
    # n_params x 9 float32s; 4096 blocks of a 2k-param grid ~ 300 MB).
    MAX_RESIDENT_RESULTS = 4096

    # Per-worker delivered-digest sets are bounded: past this many digests
    # the set is cleared (the worker merely re-receives full bytes once per
    # panel) instead of growing one entry per panel forever.
    MAX_DELIVERED_DIGESTS = 1 << 16

    # FetchCompiled payload bytes per reply: keeps one bulk fetch safely
    # under the channel's 256 MB message cap even when the fleet compile
    # store is full.
    COMPILED_REPLY_BUDGET = 64 * 1024 * 1024

    def __init__(self, queue: JobQueue, peers: PeerRegistry | None = None, *,
                 default_jobs_per_chip: int = 1,
                 results_dir: str | None = None,
                 registry: "obs.Registry | None" = None,
                 panel_dedupe: bool | None = None):
        self.queue = queue
        self.peers = peers or PeerRegistry()
        self.default_jobs_per_chip = default_jobs_per_chip
        # Dispatch by digest: send a panel's bytes to a worker generation
        # ONCE; every later job carrying the same digest ships digest-only
        # and the worker serves its cache (miss -> FetchPayload). The env
        # knob is read lazily per Dispatcher, not at import.
        if panel_dedupe is None:
            panel_dedupe = os.environ.get("DBX_PANEL_DEDUPE", "1") != "0"
        self.panel_dedupe = panel_dedupe
        # worker_id -> digests this worker's CURRENT registration has been
        # sent in full. Reset when a worker (re-)registers — a restarted
        # worker starts with an empty cache and must never wedge on a
        # phantom hit; dropped when the peer is pruned.
        self._delivered: dict[str, set[str]] = {}
        self._delivered_lock = threading.Lock()
        self.results_dir = results_dir
        self.results: dict[str, bytes] = {}
        self.results_evicted = 0
        # Guards results insert+evict: completions run on the gRPC thread
        # pool, and the eviction loop's iterate+delete must not race a
        # concurrent insert.
        self._results_lock = threading.Lock()
        if results_dir:
            os.makedirs(results_dir, exist_ok=True)
        # Observability (DESIGN.md "Observability"): per-RPC latency
        # histograms pre-resolved here, queue/peer gauges refreshed by a
        # scrape-time collector (zero steady-state cost), maintenance
        # counters incremented by the server's prune/requeue loop.
        self.obs = registry or obs.get_registry()
        self._h_rpc = {
            m: self.obs.histogram("dbx_rpc_seconds",
                                  help="dispatcher RPC handler wall",
                                  method=m)
            for m in ("RequestJobs", "SendStatus", "CompleteJob",
                      "CompleteJobs", "GetStats", "FetchPayload",
                      "AppendBars", "FetchCompiled", "OfferCompiled",
                      "TriggerDump")}
        self._c_dispatched = self.obs.counter(
            "dbx_jobs_dispatched_total", help="jobs handed to workers")
        self._c_scn_coalesced = self.obs.counter(
            "dbx_scenario_specs_coalesced_total",
            help="scenario records dispatched as spec-batch members "
                 "(megakernel route) instead of materialized panels")
        self._c_completions = {
            o: self.obs.counter("dbx_completions_total",
                                help="completion outcomes recorded",
                                outcome=o)
            for o in ("new", "dup", "unknown")}
        self._c_pruned = self.obs.counter(
            "dbx_peers_pruned_total", help="workers pruned for silence")
        self._c_requeued_prune = self.obs.counter(
            "dbx_requeued_jobs_total",
            help="jobs re-queued by recovery", reason="peer_pruned")
        self._c_requeued_lease = self.obs.counter(
            "dbx_requeued_jobs_total",
            help="jobs re-queued by recovery", reason="lease_expired")
        # Dispatch-by-digest accounting: full vs digest-only payload legs
        # and the wire bytes digest-only dispatch did NOT ship (the panel
        # lengths of every deduped leg).
        self._c_payloads = {
            mode: self.obs.counter(
                "dbx_dispatch_payloads_total",
                help="payload legs dispatched, by transport mode",
                mode=mode)
            for mode in ("full", "digest_only")}
        self._c_bytes_saved = self.obs.counter(
            "dbx_dispatch_bytes_saved_total",
            help="payload bytes NOT shipped thanks to digest-only "
                 "dispatch")
        self._c_fetches = {
            outcome: self.obs.counter(
                "dbx_payload_fetches_total",
                help="FetchPayload requests served, by outcome",
                outcome=outcome)
            for outcome in ("hit", "gone")}
        # Streaming appends (AppendBars): accepted extensions vs the
        # reject reasons, plus the delta-only dispatch leg (an append job
        # shipped as ΔT bars because the polling worker holds the base).
        self._c_appends = {
            outcome: self.obs.counter(
                "dbx_stream_appends_total",
                help="AppendBars requests, by outcome",
                outcome=outcome)
            for outcome in ("extended", "base_missing", "bad_delta",
                            "base_len_mismatch", "unsupported_strategy")}
        self._c_payloads["delta"] = self.obs.counter(
            "dbx_dispatch_payloads_total",
            help="payload legs dispatched, by transport mode",
            mode="delta")
        # Multi-tenant serving obs (DESIGN.md "Multi-tenant serving"):
        # per-tenant queue-wait distribution + SLO burn counters, labeled
        # through the BOUNDED tenant-bucket map (sched.tenancy — the
        # dbxlint obs-cardinality sanctioned source), riding the existing
        # /metrics + /stats.json + GetStats obs_json surfaces. The SLO
        # threshold is read lazily per Dispatcher, never at import.
        self.tenant_slo_s = float(os.environ.get("DBX_TENANT_SLO_S", 60.0))
        # Buckets whose per-tenant gauges this dispatcher has emitted: a
        # fully idle tenant's scheduler state is pruned, so its bucket
        # vanishes from tenant_stats() — the NEXT scrape must zero the
        # gauges instead of freezing them at the last live value.
        # Bounded by the tenant-bucket cap.
        self._tenant_buckets_emitted: set[str] = set()
        # Substrate autotuner fleet registry (tune/, round 11): workers
        # push newly tuned entries on JobsRequest.schedule_json; the
        # deterministic merge keeps the union, and GetStats ships it back
        # so the Nth worker inherits the first worker's tuning. Persists
        # through DBX_SCHEDULE_DIR when set (restarts keep the fleet's
        # schedules without re-gossip).
        from .. import tune as tune_mod

        self.fleet_schedule = tune_mod.ScheduleRegistry.open_default(
            registry=self.obs, scope="fleet")
        # Fleet-shared compile cache: byte-bounded store of workers'
        # persistent-compile-cache entries (DBX_COMPILE_CACHE_MB), served
        # by FetchCompiled / fed by OfferCompiled. Entries are opaque —
        # the dispatcher never builds a kernel.
        self.compile_store = tune_mod.CompileStore(registry=self.obs)
        # Live signal fan-out (serve/, round 13): the subscription
        # registry + result cache + push fan-out behind the
        # server-streaming Subscribe RPC. In-memory only — restart
        # semantics are "streams terminate, clients re-subscribe against
        # the journal-replayed chain". Imported lazily like tune above:
        # serve sits on rpc.panel_store/rpc.wire, and a module-level
        # import here would cycle through the rpc package __init__.
        from .. import serve as serve_mod

        self._serve = serve_mod
        self.hub = serve_mod.SubscriptionHub(
            registry=self.obs, streamable=STREAMABLE_STRATEGIES)
        # Fleet telemetry plane (obs/fleet.py, round 15): worker frames
        # gossiped on JobsRequest.telemetry_json merge here under the
        # staleness bound; the rollup rides /fleet.json, GetStats
        # obs_json (dbx_fleet) and the `dbxtop` CLI — and is the
        # worker-state view ROADMAP item 3's placement scorer ranks.
        self.fleet = obs_fleet.FleetView(registry=self.obs)
        # Dispatch decision plane (obs/decisions.py, round 19): every
        # take() resolution becomes one bounded decision record — WFQ
        # pick context, payload route, fleet-view age — scored off the
        # hot path by the placement ranker against THIS fleet view.
        # DBX_DECISIONS=0 kills record assembly entirely.
        self.decisions = obs_decisions.DecisionPlane(
            fleet=self.fleet, registry=self.obs)
        # Live locality placement (round 20): arm the plane's score
        # table — rebuilt on its daemon tick from the fleet view, the
        # delivered-digest ground truth, and completion calibration —
        # and the take-path gate reads it lock-free per poll
        # (_placement_gate). DBX_PLACEMENT=0 at construction keeps the
        # plane in round-19 pure-shadow mode; the per-poll gate checks
        # the knob again, so flipping it later also works (table
        # refreshes are cheap and verdict-free). Placement state is
        # deliberately NOT journaled: locality evidence (delivered
        # sets, calibration) dies with the process, so restarts restart
        # locality cold and replay stays byte-identical.
        if sched_placement.enabled():
            self.decisions.attach_placement(self._delivered_snapshot)
        self._c_placement = {
            o: self.obs.counter(
                "dbx_placement_total",
                help="live placement verdicts at take time: served "
                     "(best here or no better worker), deferred (held "
                     "for a better-scored worker), cap (better worker "
                     "exists but the deferral budget is spent)",
                outcome=o)
            for o in ("served", "deferred", "cap")}
        # Thread-local: concurrent GetStats calls on the gRPC pool must
        # each lend their OWN snapshot to the collector, not race on one
        # shared slot.
        self._pending_stats = threading.local()
        # Per-instance collector key: a second Dispatcher in the same
        # process (bench harnesses, restart overlap) must not be clobbered
        # by the first one's removal. Removal is owned by close() —
        # DispatcherServer.stop() calls it; a serverless Dispatcher should
        # call it directly when done.
        self._collector_key = f"dispatcher-{id(self)}"
        self.obs.add_collector(self._collector_key, self._collect_gauges)
        # Flight recorder sources (obs/flight.py, round 17): everything
        # a bundle snapshots beyond the span ring. Keyed last-wins like
        # registry collectors — the live dispatcher owns the names, and
        # close() releases them. Each callable runs on the capture
        # thread and takes only its own scrape-path locks (the lockdep
        # gate's contract).
        self._flight_sources = (
            ("metrics", self.obs.render_prometheus),
            ("fleet", self.fleet.snapshot),
            ("queue", self.queue.stats),
            ("schedule", self.fleet_schedule.to_json),
            ("lockdep", _lockdep_report),
            ("decisions", self.decisions.snapshot),
        )
        for name, fn in self._flight_sources:
            obs_flight.add_source(name, fn)

    def close(self) -> None:
        """Unhook this dispatcher from the obs registry: one final gauge
        refresh, then remove the collector so a stopped dispatcher neither
        publishes stale queue gauges nor pins its JobQueue alive. Also
        closes the subscription hub — every live Subscribe stream's pull
        loop wakes, sees its subscription closed, and ends."""
        self.hub.close()
        try:
            self._collect_gauges(self.obs)
        except Exception:
            pass
        self.obs.remove_collector(self._collector_key)
        for name, _ in self._flight_sources:
            obs_flight.remove_source(name)
        self.decisions.close()

    def _collect_gauges(self, reg: "obs.Registry") -> None:
        """Scrape-time refresh of queue-depth / liveness gauges (one
        ``queue.stats()`` read per scrape, none between scrapes). GetStats
        injects its own fresh read via ``_pending_stats`` so one queue-lock
        crossing serves both its reply and this collector."""
        s = getattr(self._pending_stats, "s", None)
        if s is None:
            s = self.queue.stats()
        reg.gauge("dbx_queue_jobs", pool="pending").set(s["jobs_pending"])
        reg.gauge("dbx_queue_jobs", pool="leased").set(s["jobs_leased"])
        reg.gauge("dbx_queue_jobs", pool="completed").set(
            s["jobs_completed"])
        reg.gauge("dbx_queue_jobs", pool="requeued").set(s["jobs_requeued"])
        reg.gauge("dbx_queue_jobs", pool="failed").set(s["jobs_failed"])
        reg.gauge("dbx_backtests_per_sec",
                  help="completed combos/s since dispatcher start").set(
            s["backtests_per_sec"])
        reg.gauge("dbx_workers_alive").set(self.peers.alive())
        reg.gauge("dbx_results_evicted").set(self.results_evicted)
        # Per-tenant queue depth + quota charge, SUMMED per bucket (the
        # overflow bucket aggregates every tenant past the label cap —
        # a set per tenant would leave last-writer-wins garbage there).
        pend: collections.Counter = collections.Counter()
        infl: collections.Counter = collections.Counter()
        demoted: collections.Counter = collections.Counter()
        for t, ts in self.queue.tenant_stats().items():
            b = tenant_bucket(t)
            pend[b] += ts["pending"]
            infl[b] += ts["inflight_combos"]
            demoted[b] += ts["demoted"]
        for b in self._tenant_buckets_emitted - set(pend):
            # Pruned (fully idle) bucket: zero its gauges rather than
            # freezing them at the last live reading.
            pend[b] = 0
        self._tenant_buckets_emitted |= set(pend)
        for b in pend:
            # Own family, NOT extra labels on dbx_queue_jobs: a
            # PromQL sum over dbx_queue_jobs{pool="pending"} also
            # matches children with extra labels, so per-tenant series
            # under the same family would double-count the backlog.
            reg.gauge("dbx_tenant_queue_jobs",
                      help="pending jobs by tenant bucket",
                      tenant=b).set(pend[b])
            reg.gauge("dbx_tenant_inflight_combos",
                      help="leased combo charge by tenant bucket "
                           "(DBX_TENANT_QUOTA's unit)",
                      tenant=b).set(infl[b])
            reg.gauge("dbx_tenant_demotions",
                      help="WFQ pops that pushed this tenant bucket's "
                           "over-quota head behind other tenants",
                      tenant=b).set(demoted[b])
        ps = self.queue.panel_store.stats()
        reg.gauge("dbx_panel_store_bytes",
                  help="bytes resident in the content-addressed panel "
                       "store").set(ps["bytes"])
        reg.gauge("dbx_panel_store_panels",
                  help="distinct panels resident in the store").set(
            ps["panels"])
        reg.gauge("dbx_panel_store_evictions",
                  help="LRU evictions from the panel store").set(
            ps["evictions"])
        cs = self.compile_store.stats()
        reg.gauge("dbx_compile_store_bytes",
                  help="bytes resident in the fleet compile-cache "
                       "store").set(cs["bytes"])
        reg.gauge("dbx_compile_store_entries",
                  help="compile-cache entries resident in the fleet "
                       "store").set(cs["entries"])
        # Fleet telemetry gauges + straggler/SLO-burn counters (bounded
        # worker-bucket labels inside).
        self.fleet.collect(reg)

    def obs_summary(self) -> dict:
        """The extended-stats payload: registry summaries (histogram
        digests + counters/gauges) plus the tail of the completed-span
        ring under ``dbx_spans_recent``, as carried by GetStats
        ``obs_json`` — the same window ``/stats.json`` ships."""
        out = self.obs.summaries(prefix="dbx_")
        out["dbx_spans_recent"] = obs.recent_spans(
            obs.http.STATS_SPAN_WINDOW)
        # The merged fleet telemetry document (same shape as
        # /fleet.json) — so a GetStats client needs no second endpoint.
        # summaries() above already ran the registry collectors, whose
        # fleet.collect built a snapshot: reuse it instead of folding
        # the whole fleet a second time per GetStats.
        out["dbx_fleet"] = (self.fleet.collected_snapshot()
                            or self.fleet.snapshot())
        return out

    # -- dispatch-by-digest bookkeeping ------------------------------------

    def forget_worker(self, worker_id: str) -> None:
        """Drop a pruned worker's delivered-digest set (its next
        registration starts cacheless anyway) and its fleet-telemetry
        entry (silence already proved the worker gone)."""
        with self._delivered_lock:
            self._delivered.pop(worker_id, None)
        self.fleet.forget(worker_id)

    def _forget_digest(self, digest: str) -> None:
        """Erase every record of having delivered ``digest``: after an
        unservable FetchPayload the next dispatch must ship full bytes,
        never point at the phantom address again."""
        with self._delivered_lock:
            for s in self._delivered.values():
                s.discard(digest)

    def _payload_leg(self, delivered: set | None, digest: str,
                     payload: bytes) -> bytes:
        """One leg's wire bytes: empty (digest-only dispatch) when this
        worker generation already received the digest in full, the full
        bytes (marked delivered) otherwise. ``delivered`` is None when
        dedupe is disabled. Mutates the per-worker set without the
        delivered lock: the set is only ever replaced under the lock, and
        add/discard from concurrent RPCs of one worker are atomic under
        the GIL (worst case a panel ships in full twice)."""
        if not digest or not payload:
            return payload
        if delivered is not None and digest in delivered:
            self._c_payloads["digest_only"].inc()
            self._c_bytes_saved.inc(len(payload))
            return b""
        if delivered is not None:
            if len(delivered) >= self.MAX_DELIVERED_DIGESTS:
                delivered.clear()
            delivered.add(digest)
        self._c_payloads["full"].inc()
        return payload

    def _append_leg(self, delivered: set | None, rec: JobRecord,
                    payload: bytes) -> bytes:
        """An append job's ``ohlcv`` leg: EMPTY (delta-only dispatch — the
        worker splices ``JobSpec.append_delta`` onto its cached base) when
        this worker generation holds the base or the extended panel
        itself; the full extended bytes otherwise. Either way the
        extended digest is marked delivered so follow-on appends chain
        delta-only."""
        if delivered is None:
            self._c_payloads["full"].inc()
            return payload
        has_base = (rec.append_parent in delivered
                    or rec.panel_digest in delivered)
        if len(delivered) >= self.MAX_DELIVERED_DIGESTS:
            delivered.clear()
            has_base = False
        delivered.add(rec.panel_digest)
        if has_base:
            self._c_payloads["delta"].inc()
            self._c_bytes_saved.inc(max(len(payload)
                                        - len(rec.delta or b""), 0))
            return b""
        self._c_payloads["full"].inc()
        return payload

    def _delivered_snapshot(self) -> dict:
        """Per-worker delivered-digest sets for the placement table
        builder (``DecisionPlane.attach_placement``). A shallow copy:
        the SETS ride by reference — membership reads are GIL-atomic,
        and a racy read is at worst one poll stale, which is exactly
        the staleness the table itself has."""
        with self._delivered_lock:
            return dict(self._delivered)

    def _placement_gate(self, worker_id: str):
        """The take() placement stage for ONE poll (round 20, replacing
        the round-6 append-affinity special case): rank every popped
        candidate across the pre-computed score table and defer a job —
        up to ``DBX_PLACEMENT_DEFER_CAP`` polls — when a better-scored
        worker should serve it instead. Returns ``None`` (no admit hook
        at all, pure WFQ order) when the stage is killed
        (``DBX_PLACEMENT=0``) or no fresh table exists (empty fleet,
        cold start, wedged scorer — the degradation ladder's floor).

        The returned gate's ``admit`` runs under the queue lock: pure
        dict/math over the frozen table (the table build did every
        fleet fold off this path). Verdicts accumulate on the gate —
        ``info`` (per-job, for the decision records) and ``counts``
        (for the ``dbx_placement_total`` counters) — and are flushed
        by RequestJobs AFTER take() returns, so no metric locks are
        ever taken under the queue lock."""
        if not sched_placement.enabled():
            return None
        table = self.decisions.placement_table()
        if table is None or not table.workers:
            return None
        cap = sched_placement.defer_cap()
        gate = _PlacementGate()
        # Chain-settling input, captured by reference: admit runs under
        # the queue lock, where these counts are mutated — a membership
        # read here can never tear.
        pending = self.queue._pending_digests

        def admit(rec: JobRecord) -> bool:
            try:
                ctx = obs_decisions.placement_ctx(rec)
                mine, best_wid, best = table.rank(ctx, worker_id)
            except Exception:
                # A scoring failure must never defer (or fail) a job.
                gate.counts["served"] += 1
                return True
            better = (best_wid != worker_id
                      and sched_placement.should_defer(
                          mine["cost_s"], best["cost_s"], 0, 1))
            # Chain settling: an append link whose parent job has not
            # dispatched yet scores holderless (equal costs everywhere,
            # `better` never fires) — wait for the parent to settle so
            # the table can route the whole chain, within the same
            # deferral budget. A parent served earlier in THIS poll
            # counts as settled (it is going to this very worker).
            base = str(ctx.get("base_digest") or "")
            wait_parent = (not better and bool(base)
                           and base not in gate.served_digests
                           and pending.get(base, 0) > 0
                           and sched_placement.should_wait_for_parent(
                               rec.affinity_skips, cap))
            if (better and rec.affinity_skips < cap) or wait_parent:
                rec.affinity_skips += 1
                gate.counts["deferred"] += 1
                return False
            gate.counts["cap" if better else "served"] += 1
            if rec.panel_digest:
                gate.served_digests.add(rec.panel_digest)
            gate.info[rec.id] = {
                "live": True,
                "best": best_wid,
                "cost_s": round(mine["cost_s"], 9),
                "best_cost_s": round(best["cost_s"], 9),
                "gap_s": round(mine["cost_s"] - best["cost_s"], 9),
                "defers": int(rec.affinity_skips),
                "cap": cap,
                "outcome": "cap" if better else "served",
                "table_workers": len(table.workers),
            }
            return True

        gate.admit = admit
        return gate

    # -- RPC handlers ------------------------------------------------------

    @_timed_rpc("RequestJobs")
    def RequestJobs(self, request: pb.JobsRequest, context) -> pb.JobsReply:
        is_new = self.peers.touch(request.worker_id, chips=request.chips)
        if request.schedule_json:
            # Tuned-schedule gossip (up leg): merge this worker's new
            # entries into the fleet registry. Malformed payloads teach
            # nothing (skip-and-count inside) — never an RPC error.
            self.fleet_schedule.merge_json(request.schedule_json)
        if request.telemetry_json:
            # Fleet telemetry gossip: adopt this worker's frame into the
            # staleness-bounded view (malformed frames counted, never an
            # RPC error — the schedule-gossip contract).
            self.fleet.update(request.worker_id, request.telemetry_json)
        if is_new:
            log.info("new worker %s with %d chips",
                     request.worker_id, request.chips)
        with self._delivered_lock:
            if is_new:
                # A (re-)registering worker starts cacheless: a stale
                # delivered set would dispatch digest-only panels the new
                # process never saw (FetchPayload would recover, but the
                # reset keeps the common restart case on the fast path).
                self._delivered[request.worker_id] = set()
            # Capability-gated: only workers that declared they resolve
            # digest-only payloads (JobsRequest.accepts_digest_only) ever
            # get bytes withheld — an older worker binary (proto3 default
            # false) always receives full payloads and cannot wedge on an
            # empty ohlcv it has no FetchPayload to recover.
            delivered = (self._delivered.setdefault(request.worker_id,
                                                    set())
                         if (self.panel_dedupe
                             and request.accepts_digest_only) else None)
        per_chip = request.jobs_per_chip or self.default_jobs_per_chip
        n = max(request.chips, 1) * max(per_chip, 1)
        t_disp0 = time.time()
        # Scenario megakernel opt-in: only a worker that declared the
        # spec-batch capability (proto3 default false — old binaries
        # never see a batch shape) and only while the kill switch is up.
        spec_jids: dict[str, str] | None = (
            {} if (request.accepts_scenario_batch
                   and _scenario_fused_enabled()) else None)
        # Decision plane (round 19): collect the pick-time WFQ context
        # only while recording is armed AND the scoring budget has
        # tokens (decisions.want) — with DBX_DECISIONS=0 or the budget
        # spent, neither the explain hook nor the record tuples below
        # are ever built and this path is the kill-switch path.
        explain: dict | None = (
            {} if obs_decisions.enabled() and self.decisions.want()
            else None)
        dec_batch: list[dict] = []
        # Live placement stage (round 20): gate verdicts accumulate on
        # the gate object under the queue lock; counters flush AFTER
        # take() returns (no metric locks under the queue lock).
        gate = self._placement_gate(request.worker_id)
        taken = self.queue.take(n, request.worker_id,
                                admit=(gate.admit if gate is not None
                                       else None),
                                scenario_spec=spec_jids,
                                explain=explain)
        if gate is not None:
            for o, v in gate.counts.items():
                if v:
                    self._c_placement[o].inc(v)
        if taken:
            self._c_dispatched.inc(len(taken))
        reply = pb.JobsReply()
        now = time.time()
        # Spec-dispatch records coalesce by everything the fused launch
        # compiles against (base, family, grid, static generator shape,
        # cost basis, tenant) — one carrier JobSpec per group, K specs
        # inside. vol_scale/shock/seed ride per-spec (traced values).
        scn_batches: dict[tuple, list] = {}
        for rec, payload in taken:
            # Per-job trace stitching: close the queue-wait span (enqueue
            # -> this take) and open/close the dispatch span (take +
            # payload materialization); the dispatch span's id rides the
            # JobSpec so the worker's chain parents onto it. Both are
            # root-level spans of the job's trace.
            parent_sid = ""
            if rec.trace_id and rec.enqueue_ts:
                obs.emit_span("job.queue_wait", rec.enqueue_ts,
                              t_disp0 - rec.enqueue_ts,
                              trace_id=rec.trace_id, job=rec.id)
                parent_sid = obs.emit_span(
                    "job.dispatch", t_disp0, now - t_disp0,
                    trace_id=rec.trace_id, job=rec.id,
                    worker=request.worker_id)
            if rec.enqueue_ts:
                # Per-tenant fairness instrumentation: queue wait under
                # the bounded tenant-bucket label + the SLO burn pair
                # (ok/breach vs DBX_TENANT_SLO_S) — burn rate is
                # breach/(ok+breach) over any scrape window.
                tb = tenant_bucket(rec.tenant)
                wait_s = max(t_disp0 - rec.enqueue_ts, 0.0)
                self.obs.histogram(
                    "dbx_tenant_queue_wait_seconds",
                    help="queue wait (enqueue -> take) by tenant bucket",
                    tenant=tb).observe(wait_s)
                self.obs.counter(
                    "dbx_tenant_slo_queue_wait_total",
                    help="queue-wait SLO burn by tenant bucket "
                         "(threshold DBX_TENANT_SLO_S)",
                    tenant=tb,
                    outcome=("breach" if wait_s > self.tenant_slo_s
                             else "ok")).inc()
                # Fleet-wide multi-window burn feed (the same SLO, the
                # dbx_fleet_slo_burn_total{window} counters).
                breach = wait_s > self.tenant_slo_s
                self.fleet.observe_slo(breach)
                if breach:
                    # The breach IS the incident: black-box the queue +
                    # fleet state while the offending job's spans are
                    # still in the ring. Deduped by (kind, tenant
                    # bucket) — one SLO storm, one bundle.
                    obs_flight.trigger(
                        "slo_breach", subject=tb, job=rec.id,
                        wait_s=round(wait_s, 3),
                        slo_s=self.tenant_slo_s)
            if spec_jids and rec.id in spec_jids:
                if explain is not None:
                    # Deferred decision record (tuple; see
                    # DecisionPlane.submit): the dict view assembles on
                    # the plane's thread, never on this path.
                    dec_batch.append((rec, "scenario",
                                      spec_jids[rec.id], len(payload),
                                      explain.get(rec.id),
                                      gate.info.get(rec.id)
                                      if gate is not None else None))
                scn_batches.setdefault(
                    (spec_jids[rec.id], rec.strategy,
                     tuple(sorted(
                         (k, np.asarray(v, np.float32).tobytes())
                         for k, v in rec.grid.items())),
                     int(rec.scenario.get("n_bars", 0)),
                     int(rec.scenario.get("block", 0)),
                     int(rec.scenario.get("regimes", 0)),
                     float(rec.cost), int(rec.periods_per_year),
                     rec.tenant),
                    []).append((rec, payload, parent_sid))
                continue
            payload2 = rec.ohlcv2 or b""
            leg1 = (self._append_leg(delivered, rec, payload)
                    if rec.append_parent else
                    self._payload_leg(delivered, rec.panel_digest,
                                      payload))
            if explain is not None:
                # The route the payload leg ACTUALLY took, derived from
                # the leg bytes the counters above just classified.
                if rec.append_parent:
                    route = "delta" if not leg1 else "full"
                else:
                    route = ("digest_only" if payload and not leg1
                             else "full")
                dec_batch.append((rec, route, rec.panel_digest,
                                  len(payload), explain.get(rec.id),
                                  gate.info.get(rec.id)
                                  if gate is not None else None))
            reply.jobs.append(pb.JobSpec(
                id=rec.id, strategy=rec.strategy,
                ohlcv=leg1,
                grid=wire.grid_to_proto(rec.grid), cost=rec.cost,
                periods_per_year=rec.periods_per_year,
                ohlcv2=self._payload_leg(delivered, rec.panel_digest2,
                                         payload2),
                wf_train=rec.wf_train, wf_test=rec.wf_test,
                wf_metric=rec.wf_metric,
                top_k=rec.top_k, rank_metric=rec.rank_metric,
                best_returns=rec.best_returns,
                trace_id=rec.trace_id, parent_span_id=parent_sid,
                panel_digest=rec.panel_digest,
                panel_bytes_len=len(payload),
                panel_digest2=rec.panel_digest2,
                panel_bytes_len2=len(payload2),
                append_parent_digest=rec.append_parent,
                append_base_len=rec.append_base_len,
                append_delta=rec.delta or b"",
                tenant_id=rec.tenant,
                scenario=(pb.ScenarioSpec(
                    base_digest=str(rec.scenario.get("base", "")),
                    n_bars=int(rec.scenario.get("n_bars", 0)),
                    block=int(rec.scenario.get("block", 0)),
                    regimes=int(rec.scenario.get("regimes", 0)),
                    vol_scale=float(rec.scenario.get("vol_scale", 0.0)),
                    shock=float(rec.scenario.get("shock", 0.0)),
                    seed=int(rec.scenario.get("seed", 0)))
                    if rec.scenario else None)))
        if scn_batches:
            # Lazy: only spec-capable polls with scenario records taken
            # pay the scenarios (torch) import — the same processes that
            # would otherwise have paid a full generator run per record.
            from .. import scenarios as scenarios_mod

            for members in scn_batches.values():
                rec0, payload0, sid0 = members[0]
                base_d = spec_jids[rec0.id]
                spec = pb.JobSpec(
                    id=rec0.id, strategy=rec0.strategy,
                    ohlcv=self._payload_leg(delivered, base_d, payload0),
                    grid=wire.grid_to_proto(rec0.grid), cost=rec0.cost,
                    periods_per_year=rec0.periods_per_year,
                    trace_id=rec0.trace_id, parent_span_id=sid0,
                    panel_digest=base_d, panel_bytes_len=len(payload0),
                    tenant_id=rec0.tenant)
                for rec, _, _ in members:
                    # The EFFECTIVE seed derives dispatcher-side from the
                    # record's host-precision params — the float32 wire
                    # roundtrip of vol_scale/shock can never skew the
                    # hash the worker would otherwise recompute.
                    eff = scenarios_mod.scenario_seed(
                        base_d,
                        scenarios_mod.ScenarioParams.from_dict(
                            rec.scenario))
                    spec.scenario_batch.append(pb.ScenarioSpec(
                        base_digest=base_d,
                        n_bars=int(rec.scenario.get("n_bars", 0)),
                        block=int(rec.scenario.get("block", 0)),
                        regimes=int(rec.scenario.get("regimes", 0)),
                        vol_scale=float(
                            rec.scenario.get("vol_scale", 0.0)),
                        shock=float(rec.scenario.get("shock", 0.0)),
                        seed=scenarios_mod.seed_to_int64(eff),
                        id=rec.id, trace_id=rec.trace_id))
                self._c_scn_coalesced.inc(len(members))
                reply.jobs.append(spec)
        if dec_batch:
            # One small-lock append for the whole poll; scoring (fleet
            # snapshot, shadow ranking) happens on the plane's thread.
            self.decisions.submit(dec_batch, worker=request.worker_id,
                                  t_take=t_disp0)
        if taken:
            log.info("dispatched %d jobs to %s", len(taken), request.worker_id)
        return reply

    @_timed_rpc("SendStatus")
    def SendStatus(self, request: pb.StatusRequest, context) -> pb.Ack:
        self.peers.touch(request.worker_id, status=request.status)
        return pb.Ack(ok=True)

    def _record_result(self, jid: str, metrics: bytes) -> None:
        if self.results_dir:
            # Persist to disk only — keeping every DBXM block resident
            # would grow without bound over a long run.
            with open(os.path.join(self.results_dir,
                                   f"{jid}.dbxm"), "wb") as fh:
                fh.write(metrics)
        else:
            with self._results_lock:
                self.results[jid] = metrics
                while len(self.results) > self.MAX_RESIDENT_RESULTS:
                    evicted = next(iter(self.results))
                    del self.results[evicted]
                    if self.results_evicted == 0:
                        log.warning(
                            "in-memory results exceeded %d blocks; "
                            "evicting oldest (job %s). Pass "
                            "--results-dir to persist every result to "
                            "disk.",
                            self.MAX_RESIDENT_RESULTS, evicted)
                    self.results_evicted += 1

    def _close_job_trace(self, jid: str, worker_id: str) -> None:
        """Emit the job's end-to-end span (enqueue ts -> completion
        recorded) — the wall the timeline analyzer's per-stage critical
        path must account for. First completion only ("new"); dups would
        re-close an already-closed trace."""
        tid, ets = self.queue.job_trace(jid)
        if tid and ets:
            obs.emit_span("job", ets, time.time() - ets, trace_id=tid,
                          job=jid, worker=worker_id)

    def _complete_one(self, jid: str, worker_id: str, metrics: bytes,
                      elapsed_s: float) -> str:
        # Same persist-then-journal order as CompleteJobs (see there).
        outcome = self.queue.complete_batch([jid], worker_id,
                                            journal=False)[0]
        if outcome == "unknown":
            return outcome
        if outcome == "new" and obs_decisions.enabled():
            # Decision-plane spu calibration: the measured end-to-end
            # worker wall against the units the shadow scorer parked.
            self.decisions.observe_completion(worker_id, jid, elapsed_s)
        if metrics:
            self._record_result(jid, metrics)
        if outcome == "new":
            # Live fan-out BEFORE the e2e span closes (its `push` span
            # must land inside the job's attribution window); the hub
            # probe is lock-free for the zero-subscription fleet, and a
            # dup can never re-push (the advance index pops on first
            # completion).
            if metrics and self.hub.has_advances():
                self.hub.on_result(jid, metrics,
                                   trace_id=self.queue.job_trace(jid)[0])
            self._close_job_trace(jid, worker_id)
        log.info("job %s completed by %s in %.3fs", jid, worker_id, elapsed_s)
        if outcome == "new" or (outcome == "dup" and metrics):
            # Journal metric-carrying dups too: the redelivery of a
            # delivery whose block landed but whose journal append never
            # ran (same rationale as CompleteJobs).
            self.queue.journal_completions([jid], worker_id)
        return outcome

    @_timed_rpc("CompleteJob")
    def CompleteJob(self, request: pb.CompleteRequest, context) -> pb.Ack:
        self.peers.touch(request.worker_id)
        outcome = self._complete_one(request.id, request.worker_id,
                                     request.metrics, request.elapsed_s)
        self._c_completions[outcome].inc()
        if outcome == "unknown":
            return pb.Ack(ok=False, detail=f"unknown job {request.id}")
        return pb.Ack(ok=True)

    @_timed_rpc("CompleteJobs")
    def CompleteJobs(self, request: pb.CompleteBatch,
                     context) -> pb.CompleteBatchReply:
        """Batched completions: one round trip for a whole drained batch
        AND one state-machine crossing for the batch (queue.complete_batch;
        the per-item semantics are identical to CompleteJob and remain
        idempotent; see backtesting.proto for the motivation numbers)."""
        self.peers.touch(request.worker_id)
        reply = pb.CompleteBatchReply()
        items = list(request.items)
        # journal=False: persist every .dbxm block BEFORE the durable
        # 'complete' records land. The reverse order loses a whole
        # batch's results on a crash in between (journaled-complete jobs
        # are never re-dispatched); this order merely re-runs the batch.
        outcomes = self.queue.complete_batch(
            [item.id for item in items], request.worker_id, journal=False)
        journal_ids: list[str] = []
        record_errors: list[tuple[str, Exception]] = []
        dec_comps: list[tuple] | None = (
            [] if obs_decisions.enabled() else None)
        for item, outcome in zip(items, outcomes):
            if outcome == "unknown":
                reply.unknown_ids.append(item.id)
                continue
            if outcome == "new":
                if dec_comps is not None:
                    dec_comps.append(
                        (request.worker_id, item.id, item.elapsed_s))
                # Live fan-out first (see _complete_one): the pushed
                # block is the completion payload, valid regardless of
                # whether the persist below succeeds — a redelivered
                # batch is "dup" and cannot double-push.
                if item.metrics and self.hub.has_advances():
                    self.hub.on_result(
                        item.id, item.metrics,
                        trace_id=self.queue.job_trace(item.id)[0])
                # Close the e2e span NOW: the state machine just recorded
                # the completion, which is the trace's end regardless of
                # whether the result block persists below — a persist
                # failure redelivers the batch as "dup", which would
                # never close it.
                self._close_job_trace(item.id, request.worker_id)
            if item.metrics:
                try:
                    self._record_result(item.id, item.metrics)
                except OSError as e:
                    # One item's disk failure must not forfeit the
                    # durable records of the OTHER items whose blocks
                    # landed. Skip this item's journal record and error
                    # the RPC below so the worker redelivers the batch
                    # ("dup" redeliveries re-record + re-journal — the
                    # journal tolerates duplicate 'complete' records).
                    record_errors.append((item.id, e))
                    log.error("job %s: result block not persisted (%s); "
                              "batch will be redelivered", item.id, e)
                    continue
            # Journal dups too: a dup may be the redelivery of exactly
            # this case (completed in state, block recorded now, durable
            # record still missing).
            journal_ids.append(item.id)
            log.info("job %s completed by %s in %.3fs", item.id,
                     request.worker_id, item.elapsed_s)
            if outcome == "new":
                reply.accepted += 1
            # "dup" (a retried delivery the dispatcher already recorded) is
            # deliberately neither accepted nor unknown: the worker already
            # counted it on the attempt the dispatcher processed.
        if dec_comps:
            # One decision-plane lock crossing for the whole batch (spu
            # calibration input; see observe_completions).
            self.decisions.observe_completions(dec_comps)
        for outcome, n in collections.Counter(outcomes).items():
            self._c_completions[outcome].inc(n)
        self.queue.journal_completions(journal_ids, request.worker_id)
        if record_errors:
            raise RuntimeError(
                f"{len(record_errors)} result block(s) not persisted "
                f"(first: job {record_errors[0][0]}: "
                f"{record_errors[0][1]}); redeliver the batch")
        return reply

    @_timed_rpc("GetStats")
    def GetStats(self, request: pb.StatsRequest, context) -> pb.StatsReply:
        # Direct stats() read FIRST — a queue failure must surface as an
        # RPC error the client can see (the collector path swallows
        # exceptions). The snapshot is then lent to the gauge collector
        # via _pending_stats so the obs_summary() call below does not
        # cross the queue lock a second time.
        s = self.queue.stats()
        self._pending_stats.s = s
        try:
            obs_json = json.dumps(self.obs_summary(), default=str)
        finally:
            self._pending_stats.s = None
        return pb.StatsReply(workers_alive=self.peers.alive(),
                             substrate=self.queue.substrate,
                             obs_json=obs_json,
                             schedule_json=self.fleet_schedule.to_json(),
                             **{
            k: (int(v) if k != "backtests_per_sec" else v)
            for k, v in s.items()})

    @_timed_rpc("FetchPayload")
    def FetchPayload(self, request: pb.PayloadRequest,
                     context) -> pb.PayloadReply:
        """Panel-cache miss recovery: serve a digest's bytes from the blob
        store (lazy re-materialization behind it). An unservable digest
        returns an EMPTY payload and is erased from every delivered set,
        so the job's next dispatch ships full bytes — miss -> fetch ->
        full job, never a failed job."""
        self.peers.touch(request.worker_id)
        blob = self.queue.payload_for_digest(request.digest)
        if blob is None:
            self._forget_digest(request.digest)
            self._c_fetches["gone"].inc()
            log.warning(
                "FetchPayload %s from %s: digest not servable (store "
                "evicted and source gone); forgetting its deliveries",
                request.digest[:16], request.worker_id)
            return pb.PayloadReply(digest=request.digest)
        self._c_fetches["hit"].inc()
        return pb.PayloadReply(digest=request.digest, payload=blob)

    @_timed_rpc("AppendBars")
    def AppendBars(self, request: pb.AppendRequest,
                   context) -> pb.AppendReply:
        """Streaming live-bar ingest: extend a content-addressed panel by
        a ΔT-bar DBX1 slice, enqueue one repricing job on the extended
        panel (when the request carries a job template — an EMPTY
        strategy is a tick-only append: chain extension for the
        subscription tier with no template job), and schedule the live
        fan-out: exactly ONE O(ΔT) advance job per unique subscribed
        stream of this chain, each registered with the hub BEFORE it is
        enqueued so its completion cannot outrun the push index. A
        rejected append is an explicit ok=false reply with the reason —
        the caller re-syncs; nothing is enqueued and nothing fails
        dispatcher-side."""
        self.peers.touch(request.worker_id)
        t_tick = time.time()
        strategy = request.job.strategy
        grid = wire.grid_from_proto(request.job.grid)
        cost = request.job.cost
        ppy = request.job.periods_per_year or 252
        tenant = request.job.tenant_id or DEFAULT_TENANT
        if strategy and strategy not in STREAMABLE_STRATEGIES:
            outcome, ndig, new_len = "unsupported_strategy", "", 0
        else:
            outcome, ndig, new_len = self.queue.extend_chain(
                request.panel_digest, int(request.base_len),
                request.delta)
        self._c_appends[outcome].inc()
        if outcome != "extended":
            log.warning("AppendBars %s from %s rejected: %s",
                        request.panel_digest[:16], request.worker_id,
                        outcome)
            return pb.AppendReply(ok=False, detail=outcome,
                                  panel_digest=ndig, new_len=new_len)
        # The tick hook: one dict probe for the non-serving case; on a
        # subscribed chain, the plan names every unique live stream
        # whose advance the template job does not already cover.
        tmpl_key = (self._serve.stream_key(strategy, grid, cost, ppy)
                    if strategy else None)
        plan = self.hub.on_tick(request.panel_digest, ndig, new_len,
                                template_key=tmpl_key)
        recs: list[JobRecord] = []
        rec = None
        if strategy:
            rec = self.queue.make_append_record(
                ndig, strategy=strategy, grid=grid, cost=cost,
                periods_per_year=ppy, tenant=tenant)
            recs.append(rec)
            if plan is not None and plan.template_live:
                self.hub.register_advance(rec.id, plan.chain, tmpl_key,
                                          ndig, new_len, t_tick)
        if plan is not None:
            for spec in plan.advances:
                r = self.queue.make_append_record(
                    ndig, strategy=spec.strategy, grid=spec.grid,
                    cost=spec.cost, periods_per_year=spec.ppy,
                    tenant=spec.tenant)
                self.hub.register_advance(r.id, plan.chain, spec.key,
                                          ndig, new_len, t_tick)
                recs.append(r)
        if recs:
            self.queue.enqueue_many(recs)
        log.info("AppendBars %s -> %s (%d bars): %d job(s)%s",
                 request.panel_digest[:16], ndig[:16], new_len,
                 len(recs),
                 f", {len(plan.advances)} stream advance(s)"
                 if plan is not None else "")
        return pb.AppendReply(ok=True,
                              job_id=rec.id if rec is not None else "",
                              panel_digest=ndig, new_len=new_len)

    # NOT @_timed_rpc: a streaming handler's "latency" is its lifetime —
    # timing the generator's construction would record ~0 and timing the
    # stream would poison the RPC histogram with hours-long samples.
    # Delivery latency has its own instrument (dbx_tick_to_push_seconds).
    def Subscribe(self, request: pb.SubscribeRequest, context):
        """Live signal fan-out (serve/): register this connection's
        interests and stream result pushes until the client drops the
        call, the dispatcher shuts down, or the handler's context dies.
        Invalid interests (unstreamable strategy) abort the RPC with
        INVALID_ARGUMENT — a client bug, answered loudly. The generator
        parks on the subscription's wake-up event between pushes (its
        own dedicated stream slot, never a shared unary one — see
        service.py on sizing max_workers), holding no locks while it
        waits. Deliberately NOT registered in the peer registry:
        subscribers are readers, not workers — 10k dashboards must not
        inflate workers_alive or churn the prune loop (their liveness
        IS the stream; the hub's dbx_subscriptions gauge counts them)."""
        interests = [
            self._serve.StreamSpec(
                strategy=js.strategy,
                grid=wire.grid_from_proto(js.grid),
                cost=js.cost,
                ppy=js.periods_per_year or 252,
                tenant=request.tenant_id or DEFAULT_TENANT,
                digest=js.panel_digest)
            for js in request.interests]
        try:
            sub = self.hub.subscribe(request.subscriber_id,
                                     request.tenant_id or DEFAULT_TENANT,
                                     interests)
        except ValueError as e:
            if context is not None:
                import grpc

                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            raise
        log.info("subscriber %s: %d interest(s), tenant %s%s",
                 request.subscriber_id, len(interests),
                 request.tenant_id or DEFAULT_TENANT,
                 " (demoted: over DBX_TENANT_SUB_QUOTA)"
                 if sub.demoted else "")
        try:
            while not sub.closed and (context is None
                                      or context.is_active()):
                for item in sub.pull(timeout=0.25):
                    self.hub.observe_delivery(item)
                    yield pb.PushUpdate(
                        panel_digest=item.digest,
                        stream_key=item.key,
                        seq=item.seq,
                        metrics=item.metrics,
                        new_len=item.new_len,
                        tick_unix=item.tick_unix,
                        changed=item.changed,
                        dropped=item.dropped,
                        catch_up=item.catch_up)
        finally:
            self.hub.unsubscribe(sub)

    @_timed_rpc("FetchCompiled")
    def FetchCompiled(self, request: pb.CompiledRequest,
                      context) -> pb.CompiledReply:
        """Fleet compile-cache fetch: empty ``keys`` = the listing only
        (the cheap poll — known_keys, no payloads); otherwise the
        requested entries still resident. A missing key is simply absent
        from the reply — the worker compiles locally and offers the
        result, never a failed job."""
        self.peers.touch(request.worker_id)
        reply = pb.CompiledReply()
        if not request.keys:
            reply.known_keys.extend(self.compile_store.keys())
            return reply
        budget = self.COMPILED_REPLY_BUDGET
        for key in request.keys:
            if budget <= 0:
                # Reply size guard (the worker also chunks its key
                # lists): entries past the budget simply stay missing
                # and ride the worker's next sync tick.
                break
            v = self.compile_store.get(key)
            if v is not None:
                reply.entries.append(pb.CompiledEntry(
                    key=key, name=v[0], payload=v[1]))
                budget -= len(v[1])
        return reply

    @_timed_rpc("OfferCompiled")
    def OfferCompiled(self, request: pb.CompiledOffer,
                      context) -> pb.Ack:
        """Fleet compile-cache offer: adopt a worker's freshly compiled
        cache entries (byte-bounded LRU; oversized/duplicate entries are
        silently ignored)."""
        self.peers.touch(request.worker_id)
        n = 0
        for e in request.entries:
            if self.compile_store.offer(e.key, e.name, e.payload):
                n += 1
        if n:
            log.info("adopted %d compile-cache entries from %s",
                     n, request.worker_id)
        return pb.Ack(ok=True, detail=str(n))

    @_timed_rpc("TriggerDump")
    def TriggerDump(self, request: pb.DumpRequest,
                    context) -> pb.DumpReply:
        """Admin black-box capture: synchronous, dedupe-bypassing flight
        bundle (the operator asked; they get a bundle or the reason
        why not)."""
        path = obs_flight.capture_now(
            "admin", subject=request.subject,
            detail={"reason": request.reason} if request.reason else {})
        if path is None:
            return pb.DumpReply(
                ok=False,
                detail="no bundle (DBX_FLIGHT_DIR unset or unwritable)")
        return pb.DumpReply(ok=True, bundle=os.path.basename(path),
                            detail=path)


class DispatcherServer:
    """Owns the grpc.Server plus the prune/requeue maintenance thread.

    ``metrics_port`` (None = off, 0 = ephemeral) additionally serves the
    dispatcher's obs registry as Prometheus text on
    ``http://<host>:<metrics_port>/metrics`` (+ ``/stats.json``)."""

    def __init__(self, dispatcher: Dispatcher, *, bind: str = "[::]:50051",
                 prune_interval_s: float = 1.0, max_workers: int = 16,
                 metrics_port: int | None = None,
                 metrics_host: str = "0.0.0.0"):
        self.dispatcher = dispatcher
        self._grpc = None
        self._bind = bind
        self._prune_interval_s = prune_interval_s
        self._max_workers = max_workers
        self._metrics_port = metrics_port
        self._metrics_host = metrics_host
        self.metrics: obs.MetricsServer | None = None
        self._stop = threading.Event()
        self._maint: threading.Thread | None = None
        self.port: int | None = None

    def start(self) -> "DispatcherServer":
        import grpc

        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers),
            options=service.default_channel_options(),
            compression=grpc.Compression.Gzip)
        service.add_dispatcher_to_server(self.dispatcher, self._grpc)
        self.port = self._grpc.add_insecure_port(self._bind)
        if self.port == 0:
            raise RuntimeError(f"could not bind {self._bind}")
        self._grpc.start()
        if self._metrics_port is not None:
            self.metrics = obs.MetricsServer(
                self._metrics_port, registry=self.dispatcher.obs,
                bind=self._metrics_host,
                routes={
                    # The merged fleet telemetry document (obs/fleet.py;
                    # `dbxtop --url` scrapes this).
                    "/fleet.json": self.dispatcher.fleet.snapshot,
                    # The decision-plane tail + aggregate regret
                    # (obs/decisions.py; `dbxwhy --url` scrapes this).
                    "/decisions.json": self.dispatcher.decisions.snapshot,
                }).start()
        self._maint = threading.Thread(
            target=self._maintenance_loop, name="dbx-maint", daemon=True)
        self._maint.start()
        log.info("dispatcher serving on %s (port %d)", self._bind, self.port)
        return self

    def _maintenance_loop(self) -> None:
        # The reference runs this as a 100 ms hot loop cloning the peer map
        # (reference src/server/main.rs:41-52); an event-wait tick is enough.
        d = self.dispatcher
        while not self._stop.wait(self._prune_interval_s):
            for wid in d.peers.prune():
                held = d.queue.requeue_worker(wid)
                d._c_pruned.inc()
                d._c_requeued_prune.inc(len(held))
                d.forget_worker(wid)
                log.warning("pruned silent worker %s; requeued %d jobs",
                            wid, len(held))
            expired = d.queue.requeue_expired()
            if expired:
                d._c_requeued_lease.inc(len(expired))
                log.warning("requeued %d expired leases", len(expired))
                # A lease expiring means a worker went quiet mid-batch —
                # exactly the evidence the span ring is about to roll
                # over. Deduped by the first expired job id.
                obs_flight.trigger("requeue_expired",
                                   subject=str(expired[0]),
                                   jobs=len(expired),
                                   job=str(expired[0]))
            for wid in d.fleet.prune():
                # Telemetry-entry eviction rides the same maintenance
                # tick as peer pruning: flagged stale first (visible
                # decay), evicted past 3x the staleness bound.
                log.info("evicted stale fleet-telemetry entry for %s",
                         wid)
            # Straggler flags from the merged fleet view are flight
            # triggers too: dedupe by worker id keeps a persistently
            # slow worker at one bundle per dedupe window.
            try:
                snap = (d.fleet.collected_snapshot()
                        or d.fleet.snapshot())
                for wid, w in snap.get("workers", {}).items():
                    for s in w.get("stragglers", ()):
                        obs_flight.trigger("straggler", subject=wid,
                                           stage=s)
            except Exception:
                log.exception("straggler flight-trigger sweep failed")

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        if self._maint is not None:
            self._maint.join(timeout=5.0)
        if self.metrics is not None:
            self.metrics.stop()
            self.metrics = None
        if self._grpc is not None:
            self._grpc.stop(grace=grace).wait()
        # Unhook the dispatcher's obs collector (final refresh inside):
        # the Worker side does the same cleanup in run()'s finally.
        self.dispatcher.close()


# ---------------------------------------------------------------------------
# Job construction + CLI
# ---------------------------------------------------------------------------

def parse_grid(spec: str) -> dict[str, np.ndarray]:
    """``"fast=5:25,slow=30:130:5"`` -> axis dict (start:stop[:step] or CSV)."""
    grid: dict[str, np.ndarray] = {}
    if not spec:
        return grid
    for part in spec.split(","):
        name, _, rng = part.partition("=")
        if ":" in rng:
            pieces = [float(x) for x in rng.split(":")]
            start, stop = pieces[0], pieces[1]
            step = pieces[2] if len(pieces) > 2 else 1.0
            grid[name.strip()] = np.arange(start, stop, step, dtype=np.float32)
        else:
            grid[name.strip()] = np.asarray(
                [float(x) for x in rng.split(";")], np.float32)
    return grid


def jobs_from_paths(paths, strategy: str, grid, *, cost: float = 0.0,
                    periods_per_year: int = 252, wf_train: int = 0,
                    wf_test: int = 0, wf_metric: str = "", top_k: int = 0,
                    rank_metric: str = "", best_returns: bool = False,
                    paths2=None,
                    tenant: str = DEFAULT_TENANT) -> list[JobRecord]:
    """File-backed jobs; two-legged strategies pass ``paths2`` (leg x
    files, positionally matched with ``paths``). Payloads are read at
    dispatch time, so enqueue stays cheap and restarts re-read nothing."""
    if paths2 is not None and len(paths2) != len(paths):
        raise ValueError(
            f"paths/paths2 length mismatch: {len(paths)} vs {len(paths2)}")
    paths2 = paths2 if paths2 is not None else [None] * len(paths)
    return [JobRecord(id=str(uuid.uuid4()), strategy=strategy, grid=grid,
                      cost=cost, periods_per_year=periods_per_year, path=p,
                      path2=p2,
                      wf_train=wf_train, wf_test=wf_test, wf_metric=wf_metric,
                      top_k=top_k, rank_metric=rank_metric,
                      best_returns=best_returns, tenant=tenant)
            for p, p2 in zip(paths, paths2)]


def scenario_jobs(base_digest: str, n: int, strategy: str, grid, *,
                  params: dict | None = None, cost: float = 0.0,
                  periods_per_year: int = 252,
                  tenant: str = DEFAULT_TENANT) -> list[JobRecord]:
    """``n`` digest-seeded scenario-sweep jobs over one real base panel.

    Each job's spec is ``(base_digest, params, seed=i)`` — scenario ``i``
    of the diversity sweep — and carries NO payload: the panel
    materializes dispatcher-side through the panel store at first take
    (``JobQueue._materialize``'s scenario leg) and dispatches like any
    other content-addressed panel. ``base_digest`` must be servable on
    this dispatcher (some enqueued job carries the base panel, or the
    store holds it); an unservable base fails the scenario job loudly at
    take, never silently.

    ``params`` are :class:`~..scenarios.ScenarioParams` fields
    (``n_bars``/``block``/``regimes``/``vol_scale``/``shock``; ``seed``
    is the sweep offset added per job)."""
    if strategy == "pairs":
        # Same up-front rejection as every other intake path (--data2,
        # STREAMABLE_STRATEGIES): a scenario spec generates ONE panel,
        # so a two-legged job would dispatch with no leg 2 and the
        # whole sweep would complete loudly empty worker-side.
        raise ValueError("scenario_jobs supports single-asset "
                         "strategies only (a spec generates one panel; "
                         "pairs needs a second leg)")
    # Normalize to the FULL effective parameter set (generator defaults
    # applied) before anything is journaled or dispatched: the record,
    # the journal and the wire ScenarioSpec echo must all describe the
    # panel that actually generates — a sparse dict echoed with proto
    # zero-defaults would not re-derive the same digest. Imported
    # lazily: only processes that create scenario jobs pay the
    # generator's import.
    from .. import scenarios as scenarios_mod

    p = dict(params or {})
    seed0 = int(p.pop("seed", 0))
    known = {f.name for f in dataclasses.fields(
        scenarios_mod.ScenarioParams)}
    unknown = set(p) - known
    if unknown:
        raise ValueError(f"unknown scenario params: {sorted(unknown)} "
                         f"(known: {sorted(known)})")
    full = scenarios_mod.ScenarioParams.from_dict(p).to_dict()
    out = []
    for i in range(n):
        scn = {"base": base_digest, **full, "seed": seed0 + i}
        out.append(JobRecord(
            id=str(uuid.uuid4()), strategy=strategy, grid=grid, cost=cost,
            periods_per_year=periods_per_year, scenario=scn,
            tenant=tenant))
    return out


def synthetic_jobs(n: int, n_bars: int, strategy: str, grid, *,
                   cost: float = 0.0, seed: int = 0, wf_train: int = 0,
                   wf_test: int = 0, wf_metric: str = "", top_k: int = 0,
                   rank_metric: str = "", best_returns: bool = False,
                   tenant: str = DEFAULT_TENANT) -> list[JobRecord]:
    """Inline synthetic-OHLCV jobs (benchmarks / demos without data files).

    ``strategy="pairs"`` jobs carry two legs (``ohlcv`` = y, ``ohlcv2`` = x).
    """
    two_legged = strategy == "pairs"
    batch = data_mod.synthetic_ohlcv(n * (2 if two_legged else 1), n_bars,
                                     seed=seed)
    out = []
    for i in range(n):
        series = type(batch)(*(np.asarray(f[i]) for f in batch))
        ohlcv2 = None
        if two_legged:
            leg_x = type(batch)(*(np.asarray(f[n + i]) for f in batch))
            ohlcv2 = data_mod.to_wire_bytes(leg_x)
        out.append(JobRecord(
            id=str(uuid.uuid4()), strategy=strategy, grid=grid, cost=cost,
            ohlcv=data_mod.to_wire_bytes(series), ohlcv2=ohlcv2,
            wf_train=wf_train, wf_test=wf_test, wf_metric=wf_metric,
            top_k=top_k, rank_metric=rank_metric,
            best_returns=best_returns, tenant=tenant))
    return out


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="dbx dispatcher: serve backtest jobs to polling workers")
    ap.add_argument("--bind", default="[::]:50051")
    ap.add_argument("--data", default=None,
                    help="glob of OHLCV files (CSV or DBX1) to enqueue")
    ap.add_argument("--data2", default=None,
                    help="pairs only: glob of leg-x OHLCV files, matched "
                         "positionally (both globs sorted) with --data's "
                         "leg-y files")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="enqueue N synthetic tickers instead of files")
    ap.add_argument("--bars", type=int, default=1260,
                    help="bars per synthetic ticker")
    ap.add_argument("--strategy", default="sma_crossover")
    ap.add_argument("--grid", default="fast=5:25,slow=30:130:5")
    ap.add_argument("--cost", type=float, default=0.0)
    ap.add_argument("--journal", default=None,
                    help="JSONL journal path (enables crash recovery)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (+ /stats.json) on this "
                         "port (0 = ephemeral; omit to disable)")
    ap.add_argument("--metrics-host", default="0.0.0.0",
                    help="interface for the /metrics server (use 127.0.0.1 "
                         "to scope the scrape surface to this host)")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--lease-s", type=float, default=60.0)
    ap.add_argument("--prune-window-s", type=float, default=10.0)
    ap.add_argument("--jobs-per-chip", type=int, default=1)
    ap.add_argument("--device", default=device_mod.DEFAULT_DEVICE,
                    help="device that materializes scenario panels "
                         "(cuda, or cpu where the host has no card)")
    ap.add_argument("--wf-train", type=int, default=0,
                    help="walk-forward mode: train bars per refit window "
                         "(0 = plain sweep)")
    ap.add_argument("--wf-test", type=int, default=0,
                    help="walk-forward mode: out-of-sample bars per window")
    ap.add_argument("--wf-metric", default="sharpe",
                    help="walk-forward selection metric")
    ap.add_argument("--top-k", type=int, default=0,
                    help="workers reduce results on-device to the top-k "
                         "param rows (0 = ship the full per-combo matrix)")
    ap.add_argument("--rank-metric", default="sharpe",
                    help="ranking metric for --top-k / --best-returns")
    ap.add_argument("--tenant", default=DEFAULT_TENANT,
                    help="tenant identity stamped on every enqueued job "
                         "(weighted fair queueing; weights/quotas via "
                         "DBX_TENANT_WEIGHTS / DBX_TENANT_QUOTA)")
    ap.add_argument("--best-returns", action="store_true",
                    help="fleet-portfolio mode: workers ship each job's "
                         "best combo (by --rank-metric) plus its net-return "
                         "series (DBXP block); compose the book afterwards "
                         "with `aggregate --portfolio`")
    return ap


def build_dispatcher(args) -> Dispatcher:
    """Queue construction + journal restore + restart-safe job intake.

    Restart discipline (rerunning the same command line after a crash must
    not re-dispatch finished work): file paths the journal already knows are
    skipped, and synthetic seed jobs are only created when the journal holds
    no jobs at all — otherwise the restored pending set IS the remaining
    synthetic workload (synthetic payloads are journaled inline).
    """
    # Check the device before any file is touched: a start that cannot
    # run must leave the journal as it found it.
    device_mod.resolve(args.device)
    if args.journal:
        # Compact BEFORE opening the appending journal handle (the rewrite
        # replaces the inode): terminal jobs' payload blobs are dropped so
        # replay cost stops growing across restarts. Progress is reported
        # in bytes — stripping payloads usually preserves the LINE count.
        size_before = (os.path.getsize(args.journal)
                       if os.path.exists(args.journal) else 0)
        Journal.compact(args.journal)
        size_after = (os.path.getsize(args.journal)
                      if os.path.exists(args.journal) else 0)
        if size_after < size_before:
            log.info("compacted journal %s: %d -> %d bytes", args.journal,
                     size_before, size_after)
    queue = JobQueue(Journal(args.journal), lease_s=args.lease_s,
                     device=args.device)
    restored = queue.restore(args.journal) if args.journal else 0
    if restored:
        log.info("restored %d pending jobs from journal", restored)

    grid = parse_grid(args.grid)
    # Walk-forward fields travel together, gated on --wf-train: a stray
    # --wf-test without --wf-train must not silently stamp inert fields on
    # records (they would split worker co-batching across a restart).
    if args.wf_train:
        wf_kw = dict(wf_train=args.wf_train, wf_test=args.wf_test,
                     wf_metric=args.wf_metric)
    else:
        if args.wf_test:
            log.warning("--wf-test %d ignored: walk-forward mode needs "
                        "--wf-train > 0", args.wf_test)
        wf_kw = dict(wf_train=0, wf_test=0, wf_metric="")
    wf_kw["tenant"] = args.tenant or DEFAULT_TENANT
    if args.top_k or args.best_returns:
        from ..ops.metrics import Metrics

        if args.rank_metric not in Metrics._fields:
            raise SystemExit(
                f"--rank-metric {args.rank_metric!r} unknown; one of "
                f"{', '.join(Metrics._fields)}")
    if args.top_k:
        if args.top_k < 0:
            raise SystemExit(f"--top-k {args.top_k} must be positive "
                             "(0 disables the reduction)")
        if args.wf_train:
            raise SystemExit("--top-k is a sweep-mode option; walk-forward "
                             "jobs already complete with one stitched OOS "
                             "row (drop --top-k or --wf-train)")
        wf_kw.update(top_k=args.top_k, rank_metric=args.rank_metric)
    if args.best_returns:
        if args.wf_train:
            raise SystemExit("--best-returns is a sweep-mode option; "
                             "walk-forward jobs have no single best combo "
                             "(drop --best-returns or --wf-train)")
        if args.top_k:
            raise SystemExit("--best-returns and --top-k are mutually "
                             "exclusive completion payloads (DBXP vs DBXS)")
        if args.strategy == "pairs":
            raise SystemExit("--best-returns supports single-asset "
                             "strategies only (the spread book needs both "
                             "legs' series)")
        wf_kw.update(best_returns=True, rank_metric=args.rank_metric)
    if args.data and args.strategy == "pairs" and not args.data2:
        raise SystemExit(
            "--strategy pairs with --data needs --data2: file-backed pairs "
            "jobs take leg-y files from --data and leg-x files from "
            "--data2, matched positionally (both globs sorted)")
    if args.data2 and args.strategy != "pairs":
        raise SystemExit("--data2 is pairs-only (two-legged jobs); "
                         f"--strategy is {args.strategy!r}")
    if args.data2 and not args.data:
        raise SystemExit("--data2 without --data: leg-y files are missing")
    if args.data:
        paths = sorted(glob_mod.glob(args.data))
        paths2 = sorted(glob_mod.glob(args.data2)) if args.data2 else None
        # Restart dedupe keys on the leg-y path (a pair is identified by
        # its y file). The journal — not sort position — is the authority
        # on which x file a journaled y was paired with: if the y-glob set
        # churns between runs with EQUAL counts (one y deleted, one added),
        # positional pairing would silently re-assign x legs that belong to
        # already-journaled pairs. New y files therefore
        # pair with the x files no journaled pair has claimed.
        path_set = set(paths)
        new_paths = [p for p in paths if p not in queue.known_paths]
        new_paths2 = None
        if paths2 is not None:
            gone_ys = {y for y in queue.known_pairings
                       if y not in path_set}
            if gone_ys and new_paths:
                # The churn signature (journaled ys vanished AND new ys
                # appeared) is exactly when positional pairing would have
                # silently re-assigned x legs; routine additions (no ys
                # gone) must not cry wolf.
                log.warning(
                    "pairs glob churn: %d journaled leg-y files no longer "
                    "match --data while %d new leg-y files appeared; "
                    "journaled pairings are kept and new files pair with "
                    "unclaimed leg-x files", len(gone_ys), len(new_paths))
            claimed_x = set(queue.known_pairings.values())
            unclaimed_x = [x for x in paths2 if x not in claimed_x]
            if new_paths and len(unclaimed_x) != len(new_paths):
                # Only fatal when something NEW would be enqueued with an
                # ambiguous pairing: on a pure crash-restart (every pair
                # already journaled) a since-vanished leg file must not
                # block serving the restored queue — restartability first.
                raise SystemExit(
                    f"--data matched {len(new_paths)} new leg-y files but "
                    f"--data2 has {len(unclaimed_x)} unclaimed leg-x files "
                    f"({len(paths2)} matched, "
                    f"{len(paths2) - len(unclaimed_x)} already paired in "
                    "the journal); pairs need one leg-x file per leg-y "
                    "file")
            if not new_paths and unclaimed_x:
                # Pure crash-restart with a stray unclaimed x file: nothing
                # new needs a pairing, so the restored queue is served and
                # the stray leg is merely noted (restartability first).
                log.info("ignoring %d unclaimed --data2 leg-x files: no "
                         "new leg-y files to pair them with", len(unclaimed_x))
            new_paths2 = unclaimed_x if new_paths else []
        if len(new_paths) < len(paths):
            log.info("skipping %d already-journaled paths",
                     len(paths) - len(new_paths))
        for rec in jobs_from_paths(new_paths, args.strategy, grid,
                                   cost=args.cost, paths2=new_paths2,
                                   **wf_kw):
            queue.enqueue(rec)
        log.info("enqueued %d file jobs", len(new_paths))
    if args.synthetic:
        if queue.journaled_jobs:
            log.info("journal already holds %d jobs; not re-seeding "
                     "%d synthetic jobs", queue.journaled_jobs,
                     args.synthetic)
        else:
            for rec in synthetic_jobs(args.synthetic, args.bars,
                                      args.strategy, grid, cost=args.cost,
                                      **wf_kw):
                queue.enqueue(rec)
            log.info("enqueued %d synthetic jobs", args.synthetic)

    results_dir = args.results_dir
    if not results_dir:
        # Spill by default: an in-memory-only dispatcher run would cap (and
        # then drop) results after MAX_RESIDENT_RESULTS blocks.
        import tempfile

        results_dir = tempfile.mkdtemp(prefix="dbx-results-")
        log.warning("no --results-dir given; persisting DBXM results to %s "
                    "(aggregate them with python -m "
                    "distributed_backtesting_exploration_tpu_torch.rpc.aggregate)",
                    results_dir)
    return Dispatcher(
        queue, PeerRegistry(prune_window_s=args.prune_window_s),
        default_jobs_per_chip=args.jobs_per_chip,
        results_dir=results_dir)


def main(argv=None) -> None:
    import signal

    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # Runtime lockdep (DBX_LOCKDEP=1): install BEFORE the queue/stores
    # are built so every package lock created below is instrumented.
    from ..analysis import lockdep

    lockdep.maybe_install()
    if os.environ.get("DBX_COMPILE_CACHE_DIR"):
        # Operator opted the dispatcher host into the compile cache
        # directory (a dispatcher that also runs local kernel work —
        # bench, a colocated worker). Gated on the env knob: a pure
        # control-plane process has no kernels to build.
        from .. import tune as tune_mod

        tune_mod.configure()
    dispatcher = build_dispatcher(args)
    queue = dispatcher.queue
    server = DispatcherServer(dispatcher, bind=args.bind,
                              metrics_port=args.metrics_port,
                              metrics_host=args.metrics_host).start()
    # Graceful shutdown on SIGTERM too (k8s/systemd stop), not just ^C —
    # the journal is append-only so either way nothing is lost, but a clean
    # stop flushes in-flight RPCs (the reference had no shutdown path at
    # all; its own limitations list, reference README.md:75-88).
    stopping = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    # SIGUSR2 = operator-requested black-box capture (the signal twin of
    # the TriggerDump RPC). The handler only enqueues — capture runs on
    # the recorder's own thread, never in signal context.
    if hasattr(signal, "SIGUSR2"):
        signal.signal(signal.SIGUSR2,
                      lambda *_: obs_flight.trigger("signal",
                                                    subject="SIGUSR2"))
    try:
        while not stopping.wait(timeout=5):
            log.info("stats: %s", queue.stats())
    except KeyboardInterrupt:
        pass
    log.info("shutting down")
    server.stop()


if __name__ == "__main__":
    main()
