"""Polling gRPC worker of the port (reference ``rpc/worker.py``).

Three kinds of thread. A heartbeat thread sends ``SendStatus`` every
``status_interval_s`` (so a long batch does not get the worker pruned).
The control thread (:meth:`Worker.run`) polls ``RequestJobs`` with
``accepts_digest_only=True`` while the compute queue has room, resolves
each digest-only payload its backend's panel cache does not hold through
``FetchPayload`` (at most once a digest a batch) before the batch crosses
to the compute side, hands the batch to the backend's ``prefetch`` on a
prefetch thread (``DBX_PREFETCH``, default on, read when :meth:`run`
starts; ``0`` leaves every decode to the compute side), and reports the
completions with ``CompleteJobs``. The compute side is an
:class:`~.executor.Executor`: one serial thread, or with
``DBX_PIPELINE=1`` and a two-phase backend a submit thread and a collector
thread (``DBX_PIPELINE_DEPTH``).

The control and compute sides meet in two bounded channels
(:class:`_Channel`, the reference's): on the native core's MPMC queue
(``runtime._core.NativeQueue``), each batch and completion crossing as
proto bytes, and on ``queue.Queue`` only where the core cannot load;
``_Channel.backend`` reads ``native`` or ``python`` (:meth:`Worker.stats`).
Completions are reported in ``CompleteJobs`` batches of up to
``_COMPLETION_BATCH``; a failed batch parks its items with a due time
(``_COMPLETION_BACKOFF_S``, the control thread never sleeps on it) and
each is retried when due, dropped after its last retry
(``dbx_worker_completions_dropped_total``; the lease re-queues the job).
The dispatcher going unreachable and coming back each log one line, on
the edge. The heartbeat runs on its own thread, so unlike the
reference's the report loop never yields to an overdue status.

The backend serves top-k, best-returns, walk-forward, digest-only,
streaming append and scenario spec-batch jobs (the poll declares
``accepts_scenario_batch`` as the backend does); a delta-only append (the
appended bars alone, ``append_delta``) whose base panel the backend's
cache holds is left for the backend to splice, not fetched in full. A job
it refuses (a field the port does not serve) gets no completion and stays
leased, and the dispatcher re-queues it when the lease expires; the other
jobs of its batch are reported. A batch whose submit or collect raises is
logged, fires the flight recorder's ``collect_fail`` trigger and is left
leased the same way. On exit the worker drains in order: every batch
taken is submitted, collected and reported before it returns.

Tuning (the reference's tune legs), for a backend with a
``schedule_registry``: each poll carries the schedule entries tuned or
adopted since the last (``JobsRequest.schedule_json``; put back when the
poll fails), and every ``tune_sync_interval_s`` (10 s) the control thread
offers the kernel libraries its own builds wrote (``OfferCompiled``),
fetches and installs those it lacks in chunks (``FetchCompiled``, through
a :class:`~..tune.CacheSync` on the build directory) and adopts the
fleet's merged schedule (``GetStats.schedule_json``). Each leg is
best-effort: a failed one costs a tick, never a job.

Observability, the reference's names in the worker's registry (the
process's by default): ``dbx_worker_rpc_seconds`` and
``dbx_worker_rpc_errors_total{method}`` for every RPC;
``dbx_worker_wire_bytes_total{method,direction}``, the serialized bytes
of ``RequestJobs``, ``CompleteJobs`` and ``FetchPayload`` requests and
replies, counted by the channel's serializers as the request is
serialized and as the reply is parsed (before gzip); the polls, idle
polls, jobs received, payload fetches and dropped completions; and, made
in :meth:`run` and removed when it ends, the gauges of this worker
(``dbx_worker_jobs_per_sec``, ``dbx_worker_channel_depth{channel}``,
``dbx_worker_deferred_completions``, ``dbx_worker_busy``). Spans on each
job's trace: ``worker.prefetch`` (a warm-up that decoded something),
``worker.report`` (a ``CompleteJobs`` attempt), the executor's and the
backend's. Fleet telemetry (``DBX_FLEET_TELEMETRY``, default on): each
poll carries an ``obs.fleet.WorkerTelemetry`` frame on
``JobsRequest.telemetry_json`` when something changed or the heartbeat
elapsed, sent again after a failed poll; the dispatcher's fleet view
merges it.

Run it (``--backend torch``, the default, or the control plane's fakes
``instant`` and ``sleep``; ``--fused``, ``--mesh`` ``auto|on|off`` and
``--param-chunk`` as :func:`make_backend` maps them):

    python -m distributed_backtesting_exploration_tpu_torch.rpc.worker \\
        --connect localhost:50051 --device cuda --metrics-port 9100

or through the native shell, ``runtime._core.build_worker_shell()``'s
``_build/dbx_worker_native`` with the same arguments.
"""

from __future__ import annotations

import argparse
import logging
import os
import queue
import signal
import threading
import time
import uuid

import grpc

from .. import obs, tune
from ..obs import fleet as obs_fleet
from ..runtime import _core as native_core
from . import backtesting_pb2 as pb
from . import compute, service
from .executor import Executor, pipeline_depth

log = logging.getLogger("dbx.torch.worker")

# Compile-cache entries fetched a FetchCompiled RPC (a reply stays under
# the channel's message cap even when the fleet store is full).
_COMPILE_FETCH_BATCH = 32
_RPC_METHODS = ("RequestJobs", "SendStatus", "CompleteJobs", "FetchPayload",
                "FetchCompiled", "OfferCompiled", "GetStats")
# The RPCs whose serialized bytes count as the worker's wire bytes.
_WIRE_METHODS = ("RequestJobs", "CompleteJobs", "FetchPayload")


def prefetch_enabled() -> bool:
    """``DBX_PREFETCH`` (default on): the prefetch thread decodes queued
    batches' payloads into the backend's cache ahead of the compute side.
    Any of ``0``, ``off``, ``false`` turns it off."""
    return os.environ.get("DBX_PREFETCH", "1").lower() not in (
        "0", "off", "false")


class _Channel:
    """A bounded channel between the control and compute threads (the
    reference worker's): the native core's MPMC queue where the core
    loads, items crossing as bytes through ``enc`` and ``dec``, else
    ``queue.Queue``. A ``capacity`` of None is unbounded; the native queue
    is always bounded, so it gets ``_UNBOUNDED``, past which a producer
    blocks where ``queue.Queue(0)`` would not (2**20 undrained items, far
    past the dispatcher's prune window). :meth:`get_nowait` raises
    ``queue.Empty``, as ``queue.Queue``'s does."""

    _UNBOUNDED = 1 << 20

    def __init__(self, capacity: int | None, enc, dec):
        self._enc, self._dec = enc, dec
        self._capacity = capacity
        self._nq = None
        if native_core.available():
            try:
                self._nq = native_core.NativeQueue(capacity or self._UNBOUNDED)
            except RuntimeError:
                self._nq = None
        self._pq: queue.Queue | None = (
            None if self._nq is not None else queue.Queue(capacity or 0))
        self.backend = "native" if self._nq is not None else "python"

    def put(self, item) -> None:
        if self._nq is not None:
            self._nq.push(self._enc(item))
        else:
            self._pq.put(item)

    def get(self):
        if self._nq is not None:
            return self._dec(self._nq.pop())
        return self._pq.get()

    def get_nowait(self):
        if self._nq is not None:
            b = self._nq.pop(timeout_ms=0)
            if b is None:
                raise queue.Empty
            return self._dec(b)
        return self._pq.get_nowait()

    def full(self) -> bool:
        if self._nq is not None:
            return (self._capacity is not None
                    and len(self._nq) >= self._capacity)
        return self._pq.full()

    def empty(self) -> bool:
        if self._nq is not None:
            return len(self._nq) == 0
        return self._pq.empty()

    def qsize(self) -> int:
        """Occupancy now (a gauge's reading; racy by nature)."""
        if self._nq is not None:
            return len(self._nq)
        return self._pq.qsize()


_BATCH_SENTINEL = b"S"


def _encode_batch(batch) -> bytes:
    """A job batch as ``b"B"`` and a serialized ``JobsReply``; None (the
    executor's shutdown sentinel) as ``b"S"``."""
    if batch is None:
        return _BATCH_SENTINEL
    return b"B" + pb.JobsReply(jobs=batch).SerializeToString()


def _decode_batch(data: bytes):
    if data[:1] == _BATCH_SENTINEL:
        return None
    reply = pb.JobsReply()
    reply.ParseFromString(data[1:])
    return list(reply.jobs)


def _encode_completion(c: compute.Completion) -> bytes:
    # The wire's CompleteRequest is the envelope, trace id included, so a
    # completion comes out of the queue still joined to its trace.
    return pb.CompleteRequest(id=c.job_id, metrics=c.metrics,
                              elapsed_s=c.elapsed_s,
                              trace_id=c.trace_id).SerializeToString()


def _decode_completion(data: bytes) -> compute.Completion:
    req = pb.CompleteRequest()
    req.ParseFromString(data)
    return compute.Completion(req.id, req.metrics, req.elapsed_s,
                              trace_id=req.trace_id)


class _WireCountingChannel:
    """A gRPC channel whose ``_WIRE_METHODS`` count their serialized
    request and reply bytes into ``counters[(method, direction)]``, in the
    serializers the call runs anyway. Every other attribute is the
    channel's own."""

    def __init__(self, channel, counters: dict):
        self._channel = channel
        self._counters = counters

    def __getattr__(self, name):
        return getattr(self._channel, name)

    def unary_unary(self, method, request_serializer=None,
                    response_deserializer=None, **kw):
        name = method.rsplit("/", 1)[-1]
        if name in _WIRE_METHODS:
            sent = self._counters[(name, "request")]
            got = self._counters[(name, "reply")]

            def serialize(msg, _ser=request_serializer):
                b = _ser(msg)
                sent.inc(len(b))
                return b

            def deserialize(b, _de=response_deserializer):
                got.inc(len(b))
                return _de(b)

            request_serializer, response_deserializer = serialize, deserialize
        return self._channel.unary_unary(
            method, request_serializer=request_serializer,
            response_deserializer=response_deserializer, **kw)


class _SyncLegFailed(Exception):
    """One tune-sync RPC failed (counted under its method); the tick
    ends and the next retries."""


class Worker:
    """Poll ``target`` for jobs and run them on ``backend``; metrics go to
    ``registry`` (the process's by default). At most
    ``max_inflight_batches`` batches wait for the compute side; while they
    do the worker polls for no more."""

    # Seconds after a failed CompleteJobs before each of an item's retries;
    # a failure after the last drops it and its lease re-queues the job.
    _COMPLETION_BACKOFF_S = (0.5, 1.0, 2.0)
    # Completions per CompleteJobs RPC.
    _COMPLETION_BATCH = 256

    def __init__(self, target: str, backend, *, worker_id: str | None = None,
                 poll_interval_s: float = 0.25,
                 status_interval_s: float = 1.0, jobs_per_chip: int = 1,
                 max_inflight_batches: int = 2,
                 registry: obs.Registry | None = None):
        self.target = target
        self.backend = backend
        self.worker_id = worker_id or str(uuid.uuid4())
        self.poll_interval_s = poll_interval_s
        self.status_interval_s = status_interval_s
        self.jobs_per_chip = jobs_per_chip
        self.jobs_completed = 0
        self.completions_dropped = 0
        self.payload_fetches = 0
        # Seconds between tune sync ticks (libraries offered and fetched,
        # the fleet's schedule adopted); the push leg rides every poll.
        self.tune_sync_interval_s = 10.0
        self._compile_sync = None
        self._next_tune_sync = 0.0
        self._stop = threading.Event()
        self._executor: Executor | None = None
        self._in = _Channel(max_inflight_batches, _encode_batch,
                            _decode_batch)
        self._out = _Channel(None, _encode_completion, _decode_completion)
        # Completions whose CompleteJobs failed: (due, attempts, completion),
        # touched by the control thread alone.
        self._deferred: list[tuple[float, int, compute.Completion]] = []
        # The dispatcher's reachability as last seen, for one log line an
        # edge; the heartbeat thread and the control thread both see RPCs.
        self._connected = True
        self._conn_lock = threading.Lock()
        reg = self.obs = registry or obs.get_registry()
        self._h_rpc = {m: reg.histogram(
            "dbx_worker_rpc_seconds",
            help="worker-side RPC wall (incl. wire)", method=m)
            for m in _RPC_METHODS}
        self._c_rpc_errors = {m: reg.counter(
            "dbx_worker_rpc_errors_total",
            help="failed worker RPC attempts", method=m)
            for m in _RPC_METHODS}
        self._c_wire = {(m, d): reg.counter(
            "dbx_worker_wire_bytes_total",
            help="serialized proto bytes over worker RPCs",
            method=m, direction=d)
            for m in _WIRE_METHODS for d in ("request", "reply")}
        self._c_fetches = reg.counter(
            "dbx_worker_payload_fetches_total",
            help="FetchPayload recoveries for digest-only jobs")
        self._c_polls = reg.counter(
            "dbx_worker_polls_total", help="RequestJobs polls sent")
        self._c_idle_polls = reg.counter(
            "dbx_worker_idle_polls_total", help="polls answered empty")
        self._c_jobs_in = reg.counter(
            "dbx_worker_jobs_received_total", help="jobs received")
        self._c_dropped = reg.counter(
            "dbx_worker_completions_dropped_total",
            help="completions dropped after retry exhaustion")
        # The per-worker gauges are made in run() and removed when it
        # ends: a worker made and never run leaves no series behind.
        self._jobs_rate = obs.StepTimer()
        self._gauges: dict | None = None
        self._telemetry: obs_fleet.WorkerTelemetry | None = None

    def stop(self) -> None:
        self._stop.set()

    def _channel(self) -> grpc.Channel:
        """The channel :meth:`run` opens to the dispatcher, counting the
        wire bytes of its calls."""
        return _WireCountingChannel(grpc.insecure_channel(
            self.target, options=service.default_channel_options(),
            compression=grpc.Compression.Gzip), self._c_wire)

    def _telemetry_stats(self) -> dict:
        """The worker's counts for its fleet telemetry frame."""
        ex = self._executor
        return {"jobs_completed": self.jobs_completed,
                "completions_dropped": self.completions_dropped,
                "polls": int(self._c_polls.value),
                "busy": int(ex is not None and ex.busy.is_set()),
                "inflight": ex.inflight if ex is not None else 0,
                "pipeline_on": bool(ex is not None and ex.pipelined),
                "pipeline_depth": (ex.depth if ex is not None
                                   else pipeline_depth())}

    def stats(self) -> dict:
        """The worker's counts and its channels' backend (``native`` or
        ``python``)."""
        return {"jobs_completed": self.jobs_completed,
                "completions_dropped": self.completions_dropped,
                "payload_fetches": self.payload_fetches,
                "deferred_completions": len(self._deferred),
                "channel": self._in.backend}

    def _collect_gauges(self, reg) -> None:
        # Sets the children made in run(): a scrape racing run()'s cleanup
        # sets detached objects and registers nothing again.
        g, ex = self._gauges, self._executor
        if g is None:
            return
        g["in"].set(self._in.qsize())
        g["out"].set(self._out.qsize())
        g["deferred"].set(len(self._deferred))
        g["busy"].set(1 if ex is not None and ex.busy.is_set() else 0)

    def _start_gauges(self) -> None:
        wid, reg = self.worker_id, self.obs
        self._jobs_rate = obs.StepTimer(reg.gauge(
            "dbx_worker_jobs_per_sec",
            help="accepted completions/s since worker start", worker=wid))
        self._gauges = {
            "in": reg.gauge("dbx_worker_channel_depth", worker=wid,
                            channel="in"),
            "out": reg.gauge("dbx_worker_channel_depth", worker=wid,
                             channel="out"),
            "deferred": reg.gauge("dbx_worker_deferred_completions",
                                  worker=wid),
            "busy": reg.gauge("dbx_worker_busy", worker=wid)}
        reg.add_collector(f"worker-{wid}", self._collect_gauges)

    def _stop_gauges(self) -> None:
        wid, reg = self.worker_id, self.obs
        reg.remove_collector(f"worker-{wid}")
        self._jobs_rate.bind_gauge(None)
        self._gauges = None
        reg.remove_child("dbx_worker_jobs_per_sec", worker=wid)
        for ch in ("in", "out"):
            reg.remove_child("dbx_worker_channel_depth", worker=wid,
                             channel=ch)
        reg.remove_child("dbx_worker_deferred_completions", worker=wid)
        reg.remove_child("dbx_worker_busy", worker=wid)

    def run(self, *, max_idle_polls: int | None = None) -> None:
        """Run until stopped, or until ``max_idle_polls`` consecutive empty
        polls with nothing in flight once at least one job was seen; then
        drain what was taken."""
        channel = self._channel()
        stub = service.DispatcherStub(channel)
        fetches = hasattr(self.backend, "payload_fetcher")
        if fetches:
            # Recovery on the compute thread for a panel evicted between
            # the control thread's probe and the decode (gRPC channels are
            # thread-safe).
            self.backend.payload_fetcher = (
                lambda digest: self._fetch_payload(stub, digest))
        tunes = getattr(self.backend, "schedule_registry", None) is not None
        if tunes:
            self._compile_sync = tune.attach()
        if obs_fleet.telemetry_enabled():
            # A new frame generation a run: a restarted worker's frames
            # supersede its predecessor's at the dispatcher.
            self._telemetry = obs_fleet.WorkerTelemetry(
                self.worker_id, stats_fn=self._telemetry_stats,
                backend=self.backend, registry=self.obs)
        ex = self._executor = Executor(self.backend, inbox=self._in,
                                       outbox=self._out,
                                       worker_id=self.worker_id)
        self._start_gauges()
        prefetch_q: queue.Queue | None = None
        prefetcher = None
        if hasattr(self.backend, "prefetch") and prefetch_enabled():
            prefetch_q = queue.Queue()
            prefetcher = threading.Thread(target=self._prefetch_loop,
                                          args=(prefetch_q,),
                                          name="dbx-torch-prefetch",
                                          daemon=True)
            prefetcher.start()
        done = threading.Event()
        beat = threading.Thread(target=self._heartbeat, args=(stub, done),
                                name="dbx-torch-heartbeat", daemon=True)
        beat.start()
        ex.start()
        idle_polls = 0
        saw_work = False
        try:
            while not self._stop.is_set():
                now = time.monotonic()
                if tunes and now >= self._next_tune_sync:
                    self._next_tune_sync = now + self.tune_sync_interval_s
                    self._sync_tune(stub)
                if not self._in.full():
                    jobs = self._poll(stub)
                    if jobs:
                        saw_work = True
                        idle_polls = 0
                        self._resolve_payloads(stub, jobs)
                        if prefetch_q is not None:
                            prefetch_q.put(jobs)
                        self._in.put(jobs)
                    elif (jobs is not None and not ex.busy.is_set()
                          and self._in.empty() and self._out.empty()
                          and not self._deferred):
                        idle_polls += 1
                self._drain_completions(stub)
                if (max_idle_polls is not None and saw_work
                        and idle_polls >= max_idle_polls):
                    log.info("idle for %d polls; draining and exiting",
                             idle_polls)
                    break
                self._stop.wait(self.poll_interval_s)
            self._shutdown(stub, ex, prefetch_q, prefetcher)
        finally:
            if fetches:
                # The fetcher closes over this run's channel; a backend
                # that outlives the run must not keep calling it.
                self.backend.payload_fetcher = None
            done.set()
            # dbxlint: disable=blocking-call -- bounded heartbeat join at exit
            beat.join(timeout=10.0)
            channel.close()
            self._stop_gauges()

    def _heartbeat(self, stub, done: threading.Event) -> None:
        while not done.is_set():
            ex = self._executor
            status = (pb.WORKER_STATUS_RUNNING
                      if ex is not None and ex.busy.is_set()
                      else pb.WORKER_STATUS_IDLE)
            try:
                with obs.timer(self._h_rpc["SendStatus"]):
                    stub.SendStatus(pb.StatusRequest(
                        worker_id=self.worker_id, status=status),
                        timeout=5.0)
                self._log_reconnected()
            except grpc.RpcError as e:
                self._c_rpc_errors["SendStatus"].inc()
                self._log_disconnected(e)
            done.wait(self.status_interval_s)

    def _call(self, method: str, fn, *args, **kw):
        """One timed RPC; a failure counts under ``method`` and raises
        :class:`_SyncLegFailed`."""
        try:
            with obs.timer(self._h_rpc[method]):
                return fn(*args, **kw)
        except grpc.RpcError as e:
            self._c_rpc_errors[method].inc()
            raise _SyncLegFailed(f"{method}: {e.code()}") from e

    def _sync_tune(self, stub) -> None:
        """One tune sync tick (control thread): offer the libraries this
        worker's builds wrote, fetch and install the fleet's that it lacks,
        adopt the fleet's merged schedule. A failed leg ends the tick; the
        next tick retries."""
        sync = self._compile_sync
        try:
            if sync is not None:
                fresh = sync.poll_new()
                if fresh:
                    try:
                        self._call("OfferCompiled", stub.OfferCompiled,
                                   pb.CompiledOffer(
                                       worker_id=self.worker_id,
                                       entries=[pb.CompiledEntry(
                                           key=k, name=n, payload=p)
                                           for k, n, p in fresh]),
                                   timeout=30.0)
                    except _SyncLegFailed:
                        # Offered again on the next tick.
                        sync.unmark(fresh)
                        raise
                listing = self._call("FetchCompiled", stub.FetchCompiled,
                                     pb.CompiledRequest(
                                         worker_id=self.worker_id),
                                     timeout=10.0)
                miss = sync.missing(listing.known_keys)
                for i in range(0, len(miss), _COMPILE_FETCH_BATCH):
                    chunk = miss[i:i + _COMPILE_FETCH_BATCH]
                    got = self._call("FetchCompiled", stub.FetchCompiled,
                                     pb.CompiledRequest(
                                         worker_id=self.worker_id,
                                         keys=chunk), timeout=60.0)
                    installed = sync.install(
                        (e.key, e.name, e.payload) for e in got.entries)
                    sync.count_fleet_misses(len(chunk) - installed)
            stats = self._call("GetStats", stub.GetStats, pb.StatsRequest(),
                               timeout=10.0)
            if stats.schedule_json:
                self.backend.schedule_registry.merge_json(
                    stats.schedule_json)
            self._log_reconnected()
        except _SyncLegFailed as e:
            self._log_disconnected(e.__cause__)
        except Exception:
            log.exception("tune sync tick failed; retrying next tick")

    def _poll(self, stub):
        """One ``RequestJobs``: the jobs (maybe none), or None on an RPC
        error. It carries the schedule entries tuned since the last poll
        and the telemetry frame; a failed poll marks both to be sent
        again."""
        self._c_polls.inc()
        reg = getattr(self.backend, "schedule_registry", None)
        schedule_json = reg.take_dirty_json() if reg is not None else ""
        telemetry_json = (self._telemetry.take_frame_json()
                          if self._telemetry is not None else "")
        req = pb.JobsRequest(
            worker_id=self.worker_id, chips=self.backend.chips,
            jobs_per_chip=self.jobs_per_chip, accepts_digest_only=True,
            accepts_scenario_batch=getattr(self.backend,
                                           "accepts_scenario_batch", False),
            schedule_json=schedule_json, telemetry_json=telemetry_json)
        try:
            with obs.timer(self._h_rpc["RequestJobs"]):
                jobs = list(stub.RequestJobs(req, timeout=30.0).jobs)
            self._log_reconnected()
        except grpc.RpcError as e:
            self._c_rpc_errors["RequestJobs"].inc()
            self._log_disconnected(e)
            if schedule_json:
                reg.remark_dirty(schedule_json)
            if telemetry_json:
                self._telemetry.remark_dirty()
            return None
        if jobs:
            log.info("received %d jobs", len(jobs))
            self._c_jobs_in.inc(len(jobs))
        else:
            self._c_idle_polls.inc()
        return jobs

    def _resolve_payloads(self, stub, jobs) -> None:
        """Give each digest-only leg whose panel the backend's cache does
        not hold its bytes before the batch reaches the compute side: from
        a sibling job of the batch that carries them, else by one
        ``FetchPayload`` a digest. A delta-only append whose base panel the
        cache holds is skipped: the backend splices base and delta, and
        fetching the extended panel would undo the O(ΔT) wire. An
        unfetchable digest leaves the leg empty; the backend then fails the
        batch and the lease re-queues it, by when the dispatcher
        re-dispatches full bytes."""
        cache = getattr(self.backend, "panel_cache", None)
        if cache is None:
            return
        blobs: dict[str, bytes] = {}
        for job in jobs:
            if job.panel_digest and job.ohlcv:
                blobs.setdefault(job.panel_digest, job.ohlcv)
            if job.panel_digest2 and job.ohlcv2:
                blobs.setdefault(job.panel_digest2, job.ohlcv2)
        for job in jobs:
            for digest, field in ((job.panel_digest, "ohlcv"),
                                  (job.panel_digest2, "ohlcv2")):
                if (not digest or getattr(job, field)
                        or cache.contains_series(digest)):
                    continue
                if (field == "ohlcv" and job.append_parent_digest
                        and job.append_delta
                        and cache.contains_series(job.append_parent_digest)):
                    continue
                blob = blobs.get(digest)
                if blob is None:
                    blob = self._fetch_payload(stub, digest)
                    if blob:
                        blobs[digest] = blob
                if blob:
                    setattr(job, field, blob)

    def _fetch_payload(self, stub, digest: str) -> bytes:
        """One ``FetchPayload``; empty bytes when the dispatcher cannot
        serve the digest or the RPC fails."""
        req = pb.PayloadRequest(worker_id=self.worker_id, digest=digest)
        try:
            with obs.timer(self._h_rpc["FetchPayload"]):
                reply = stub.FetchPayload(req, timeout=30.0)
            self._log_reconnected()
        except grpc.RpcError as e:
            self._c_rpc_errors["FetchPayload"].inc()
            self._log_disconnected(e)
            return b""
        if not reply.payload:
            log.warning("payload fetch for digest %s came back empty; the "
                        "jobs will be re-dispatched with full bytes",
                        digest[:16])
            return b""
        self.payload_fetches += 1
        self._c_fetches.inc()
        return reply.payload

    def _prefetch_loop(self, jobs_q: queue.Queue) -> None:
        """Best-effort decode of queued batches into the backend's cache,
        off the control thread; the compute side re-resolves through the
        same cache, so a failure costs only the overlap. A warm-up that
        decoded something is the span ``worker.prefetch`` (decode work done
        early, so obs.timeline still sees it when the compute side's decode
        is a cache hit)."""
        while True:
            jobs = jobs_q.get()
            if jobs is None:
                return
            t0_wall, t0 = time.time(), time.perf_counter()
            try:
                warmed = self.backend.prefetch(jobs)
            except Exception:
                log.exception("backend prefetch failed; the compute thread "
                              "will decode inline")
                continue
            if warmed:
                obs.emit_span("worker.prefetch", t0_wall,
                              time.perf_counter() - t0,
                              pairs=obs.job_trace_pairs(jobs),
                              jobs=len(jobs), warmed=warmed)

    def _drain_completions(self, stub, *, due_all: bool = False) -> None:
        """Report the completions the compute side produced and the parked
        ones now due (``due_all``: every parked one), in ``CompleteJobs``
        batches of up to ``_COMPLETION_BATCH``. Never sleeps."""
        now = time.monotonic()
        ready = [(a, c) for due, a, c in self._deferred
                 if due_all or due <= now]
        self._deferred = [d for d in self._deferred
                          if not (due_all or d[0] <= now)]
        while True:
            while len(ready) < self._COMPLETION_BATCH:
                try:
                    ready.append((0, self._out.get_nowait()))
                except queue.Empty:
                    break
            if not ready:
                return
            chunk = ready[:self._COMPLETION_BATCH]
            ready = ready[self._COMPLETION_BATCH:]
            self._report_completions(stub, chunk)

    def _shutdown(self, stub, ex, prefetch_q, prefetcher,
                  budget_s: float = 8.0) -> None:
        """On exit: stop the prefetch thread, drain the compute side
        (``ex.close``), then report everything, retrying the parked
        completions at once, for up to ``budget_s`` seconds; what is left
        stays leased and the dispatcher re-queues it."""
        if prefetch_q is not None:
            prefetch_q.put(None)
            prefetcher.join(timeout=5.0)
        if not ex.close():
            log.error("compute pipeline did not drain within the exit "
                      "budget; in-flight batches stay leased and will "
                      "be re-queued by lease expiry")
        deadline = time.monotonic() + budget_s
        self._drain_completions(stub, due_all=True)
        while self._deferred and time.monotonic() < deadline:
            time.sleep(0.1)
            self._drain_completions(stub, due_all=True)
        if self._deferred:
            log.error("exiting with %d undelivered completions (leases "
                      "will re-queue them)", len(self._deferred))

    def _report_completions(self, stub, chunk) -> None:
        """One ``CompleteJobs`` attempt for ``chunk``, a list of
        (attempts so far, completion). Where it fails each item parks
        until its next backoff is due, or is dropped after its last."""
        req = pb.CompleteBatch(worker_id=self.worker_id, items=[
            pb.CompleteItem(id=c.job_id, metrics=c.metrics,
                            elapsed_s=c.elapsed_s, trace_id=c.trace_id)
            for _, c in chunk])
        # The report joins each completion's trace as a root-level stage.
        pairs = [(c.trace_id, "") for _, c in chunk]
        try:
            with obs.trace_context(pairs), \
                    obs.span("worker.report", jobs=len(chunk),
                             worker=self.worker_id), \
                    obs.timer(self._h_rpc["CompleteJobs"]):
                reply = stub.CompleteJobs(req, timeout=8.0)
            self._log_reconnected()
        except grpc.RpcError as e:
            self._c_rpc_errors["CompleteJobs"].inc()
            self._log_disconnected(e)
            for attempts, c in chunk:
                if attempts >= len(self._COMPLETION_BACKOFF_S):
                    self.completions_dropped += 1
                    self._c_dropped.inc()
                    log.error("dropping completion %s after %d attempts "
                              "(its lease will re-queue it)", c.job_id,
                              attempts + 1)
                else:
                    due = (time.monotonic()
                           + self._COMPLETION_BACKOFF_S[attempts])
                    self._deferred.append((due, attempts + 1, c))
            return
        self.jobs_completed += reply.accepted
        self._jobs_rate.add(reply.accepted)
        for jid in reply.unknown_ids:
            log.warning("completion %s rejected: unknown job", jid)

    def _log_disconnected(self, err) -> None:
        with self._conn_lock:
            edge, self._connected = self._connected, False
        if edge:
            log.error("dispatcher unreachable: %s",
                      getattr(err, "code", lambda: err)())

    def _log_reconnected(self) -> None:
        with self._conn_lock:
            edge, self._connected = not self._connected, True
        if edge:
            log.info("dispatcher reachable again")


def make_backend(name: str, **kw):
    """The worker CLI's backend by name (the reference's ``make_backend``):
    ``torch``, a :class:`~.compute.TorchSweepBackend` on ``device`` with
    ``param_chunk``, ``use_fused`` and ``use_mesh``; ``instant``,
    :class:`~.compute.InstantBackend`; ``sleep``,
    :class:`~.compute.SleepBackend` with ``delay_s``."""
    if name == "torch":
        return compute.TorchSweepBackend(
            device=kw.get("device"), param_chunk=kw.get("param_chunk"),
            use_fused=kw.get("use_fused"), use_mesh=kw.get("use_mesh"))
    if name == "instant":
        return compute.InstantBackend()
    if name == "sleep":
        return compute.SleepBackend(kw.get("delay_s", 0.05))
    raise ValueError(f"unknown backend {name!r}")


def _count_launches(reg) -> None:
    """The process's kernel launch counts (``ops._kernels.LAUNCHES``, each
    wrapper's own) as the gauges ``dbx_kernel_launches{kernel}``, set when
    the registry is scraped: a worker process's launches are readable
    from outside it, on ``/metrics``."""
    from ..ops import _kernels

    for name, n in list(_kernels.LAUNCHES.items()):
        reg.gauge("dbx_kernel_launches", help="kernel launches by this "
                  "process's wrappers", kernel=name).set(n)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="dbx PyTorch worker: poll a dispatcher and run backtest "
                    "jobs on one device. Environment: DBX_PIPELINE, "
                    "DBX_PIPELINE_DEPTH, DBX_PREFETCH, DBX_FLEET_TELEMETRY, "
                    "DBX_OBS_JSONL (span event log), DBX_FLIGHT_DIR (flight "
                    "bundles), DBX_LOCKDEP.")
    ap.add_argument("--connect", default="localhost:50051")
    ap.add_argument("--id", default=None, help="stable worker id")
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "instant", "sleep"))
    ap.add_argument("--device", default="cuda",
                    help="the torch backend's device: 'cuda' (default) or "
                         "'cpu'; cuda without a GPU is an error")
    ap.add_argument("--param-chunk", type=int, default=None,
                    help="run generic sweeps in chunks of this many combos "
                         "(where they divide the grid)")
    ap.add_argument("--fused", choices=("auto", "on", "off"), default="auto",
                    help="the fused kernels (auto: on); off sends every "
                         "group down the generic sweep")
    ap.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                    help="shard job groups over the local GPUs (auto: on "
                         "where there are two or more)")
    ap.add_argument("--poll-s", type=float, default=0.25)
    ap.add_argument("--status-s", type=float, default=1.0)
    ap.add_argument("--jobs-per-chip", type=int, default=1)
    ap.add_argument("--exit-after-idle", type=int, default=None,
                    help="exit after N consecutive empty polls (batch mode)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (and /stats.json) on this "
                         "port (0 = ephemeral; omit to disable), the "
                         "process's kernel launches among them "
                         "(dbx_kernel_launches{kernel})")
    ap.add_argument("--metrics-host", default="0.0.0.0",
                    help="interface of the /metrics server (127.0.0.1 keeps "
                         "the scrape surface on this host)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # Runtime lockdep (DBX_LOCKDEP=1): installed before the backend and its
    # caches make their locks, so that every one is instrumented.
    from ..analysis import lockdep

    lockdep.maybe_install()
    tristate = {"auto": None, "on": True, "off": False}
    backend = make_backend(args.backend, device=args.device,
                           param_chunk=args.param_chunk,
                           use_fused=tristate[args.fused],
                           use_mesh=tristate[args.mesh])
    worker = Worker(args.connect, backend, worker_id=args.id,
                    poll_interval_s=args.poll_s,
                    status_interval_s=args.status_s,
                    jobs_per_chip=args.jobs_per_chip)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: worker.stop())
    metrics_srv = None
    if args.metrics_port is not None:
        obs.get_registry().add_collector("kernel-launches", _count_launches)
        metrics_srv = obs.MetricsServer(args.metrics_port,
                                        bind=args.metrics_host).start()
    log.info("worker %s -> %s (backend=%s, device=%s, chips=%d, "
             "channel=%s)", worker.worker_id, args.connect, args.backend,
             getattr(backend, "device", None), backend.chips,
             worker.stats()["channel"])
    try:
        worker.run(max_idle_polls=args.exit_after_idle)
    finally:
        if metrics_srv is not None:
            metrics_srv.stop()


if __name__ == "__main__":
    main()
