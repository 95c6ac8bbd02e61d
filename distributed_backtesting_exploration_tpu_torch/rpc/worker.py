"""Polling gRPC worker of the port (reference ``rpc/worker.py``).

Three kinds of thread. A heartbeat thread sends ``SendStatus`` every
``status_interval_s`` (so a long batch does not get the worker pruned).
The control thread (:meth:`Worker.run`) polls ``RequestJobs`` with
``accepts_digest_only=True`` while the compute queue has room, resolves
each digest-only payload its backend's panel cache does not hold through
``FetchPayload`` (at most once a digest a batch) before the batch crosses
to the compute side, hands the batch to the backend's ``prefetch`` on a
prefetch thread, and reports the completions with ``CompleteJobs``. The
compute side is an :class:`~.executor.Executor`: one serial thread, or
with ``DBX_PIPELINE=1`` and a two-phase backend a submit thread and a
collector thread (``DBX_PIPELINE_DEPTH``).

The backend serves top-k, best-returns, walk-forward, digest-only,
streaming append and scenario spec-batch jobs (the poll declares
``accepts_scenario_batch`` as the backend does); a delta-only append (the
appended bars alone, ``append_delta``) whose base panel the backend's
cache holds is left for the backend to splice, not fetched in full. A job
it refuses (a field the port does not serve) gets no completion and stays
leased, and the dispatcher re-queues it when the lease expires; the other
jobs of its batch are reported. A batch whose submit or collect raises is
logged and left leased the same way. On exit the worker drains in order:
every batch taken is submitted, collected and reported before it
returns.

Run it:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.worker \
        --connect localhost:50051 --device cuda
"""

from __future__ import annotations

import argparse
import logging
import queue
import signal
import threading
import uuid

import grpc

from . import backtesting_pb2 as pb
from . import compute, service
from .executor import Executor

log = logging.getLogger("dbx.torch.worker")

# Seconds between the attempts to report one batch of completions; after
# the last the batch is dropped and its leases re-queue the jobs.
_REPORT_BACKOFF_S = (0.2, 1.0, 3.0)
# Completions per CompleteJobs RPC.
_REPORT_BATCH = 256


class Worker:
    """Poll ``target`` for jobs and run them on ``backend``."""

    def __init__(self, target: str, backend, *, worker_id: str | None = None,
                 poll_interval_s: float = 0.25,
                 status_interval_s: float = 1.0, jobs_per_chip: int = 1):
        self.target = target
        self.backend = backend
        self.worker_id = worker_id or str(uuid.uuid4())
        self.poll_interval_s = poll_interval_s
        self.status_interval_s = status_interval_s
        self.jobs_per_chip = jobs_per_chip
        self.jobs_completed = 0
        self.completions_dropped = 0
        self.payload_fetches = 0
        self._stop = threading.Event()
        self._executor: Executor | None = None

    def stop(self) -> None:
        self._stop.set()

    def run(self, *, max_idle_polls: int | None = None) -> None:
        """Run until stopped, or until ``max_idle_polls`` consecutive empty
        polls with nothing in flight once at least one job was seen; then
        drain what was taken."""
        channel = grpc.insecure_channel(
            self.target, options=service.default_channel_options(),
            compression=grpc.Compression.Gzip)
        stub = service.DispatcherStub(channel)
        fetches = hasattr(self.backend, "payload_fetcher")
        if fetches:
            # Recovery on the compute thread for a panel evicted between
            # the control thread's probe and the decode (gRPC channels are
            # thread-safe).
            self.backend.payload_fetcher = (
                lambda digest: self._fetch_payload(stub, digest))
        ex = self._executor = Executor(self.backend)
        prefetch_q: queue.Queue | None = None
        prefetcher = None
        if hasattr(self.backend, "prefetch"):
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
                if not ex.inbox.full():
                    jobs = self._poll(stub)
                    if jobs:
                        saw_work = True
                        idle_polls = 0
                        self._resolve_payloads(stub, jobs)
                        if prefetch_q is not None:
                            prefetch_q.put(jobs)
                        ex.inbox.put(jobs)
                    elif (jobs is not None and not ex.busy.is_set()
                          and ex.inbox.empty() and ex.outbox.empty()):
                        idle_polls += 1
                self._report(stub, ex.take_completions())
                if (max_idle_polls is not None and saw_work
                        and idle_polls >= max_idle_polls):
                    log.info("idle for %d polls; draining and exiting",
                             idle_polls)
                    break
                self._stop.wait(self.poll_interval_s)
            if prefetch_q is not None:
                prefetch_q.put(None)
                prefetcher.join(timeout=5.0)
            if not ex.close():
                log.error("compute pipeline did not drain within the exit "
                          "budget; in-flight batches stay leased and will "
                          "be re-queued by lease expiry")
            self._report(stub, ex.take_completions())
        finally:
            if fetches:
                # The fetcher closes over this run's channel; a backend
                # that outlives the run must not keep calling it.
                self.backend.payload_fetcher = None
            done.set()
            beat.join(timeout=10.0)
            channel.close()

    def _heartbeat(self, stub, done: threading.Event) -> None:
        while not done.is_set():
            ex = self._executor
            status = (pb.WORKER_STATUS_RUNNING
                      if ex is not None and ex.busy.is_set()
                      else pb.WORKER_STATUS_IDLE)
            try:
                stub.SendStatus(pb.StatusRequest(
                    worker_id=self.worker_id, status=status), timeout=5.0)
            except grpc.RpcError as e:
                log.warning("SendStatus failed: %s", e.code())
            done.wait(self.status_interval_s)

    def _poll(self, stub):
        """One ``RequestJobs``: the jobs (maybe none), or None on an RPC
        error."""
        req = pb.JobsRequest(
            worker_id=self.worker_id, chips=self.backend.chips,
            jobs_per_chip=self.jobs_per_chip, accepts_digest_only=True,
            accepts_scenario_batch=getattr(self.backend,
                                           "accepts_scenario_batch", False))
        try:
            jobs = list(stub.RequestJobs(req, timeout=30.0).jobs)
        except grpc.RpcError as e:
            log.warning("RequestJobs failed: %s", e.code())
            return None
        if jobs:
            log.info("received %d jobs", len(jobs))
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
            reply = stub.FetchPayload(req, timeout=30.0)
        except grpc.RpcError as e:
            log.warning("FetchPayload failed: %s", e.code())
            return b""
        if not reply.payload:
            log.warning("payload fetch for digest %s came back empty; the "
                        "jobs will be re-dispatched with full bytes",
                        digest[:16])
            return b""
        self.payload_fetches += 1
        return reply.payload

    def _prefetch_loop(self, jobs_q: queue.Queue) -> None:
        """Best-effort decode of queued batches into the backend's cache,
        off the control thread; the compute side re-resolves through the
        same cache, so a failure costs only the overlap."""
        while True:
            jobs = jobs_q.get()
            if jobs is None:
                return
            try:
                self.backend.prefetch(jobs)
            except Exception:
                log.exception("backend prefetch failed; the compute thread "
                              "will decode inline")

    def _report(self, stub, completions) -> None:
        for lo in range(0, len(completions), _REPORT_BATCH):
            self._report_chunk(stub, completions[lo:lo + _REPORT_BATCH])

    def _report_chunk(self, stub, completions) -> None:
        req = pb.CompleteBatch(worker_id=self.worker_id, items=[
            pb.CompleteItem(id=c.job_id, metrics=c.metrics,
                            elapsed_s=c.elapsed_s, trace_id=c.trace_id)
            for c in completions])
        for attempt, backoff in enumerate((0.0,) + _REPORT_BACKOFF_S):
            if backoff and self._stop.wait(backoff):
                break
            try:
                reply = stub.CompleteJobs(req, timeout=8.0)
            except grpc.RpcError as e:
                log.warning("CompleteJobs attempt %d failed: %s", attempt + 1,
                            e.code())
                continue
            self.jobs_completed += reply.accepted
            for jid in reply.unknown_ids:
                log.warning("completion %s rejected: unknown job", jid)
            return
        self.completions_dropped += len(completions)
        log.error("dropping %d completions (leases will re-queue them)",
                  len(completions))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="dbx PyTorch worker: poll a dispatcher and run backtest "
                    "jobs on one device")
    ap.add_argument("--connect", default="localhost:50051")
    ap.add_argument("--id", default=None, help="stable worker id")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; cuda without a GPU "
                         "is an error")
    ap.add_argument("--poll-s", type=float, default=0.25)
    ap.add_argument("--status-s", type=float, default=1.0)
    ap.add_argument("--jobs-per-chip", type=int, default=1)
    ap.add_argument("--exit-after-idle", type=int, default=None,
                    help="exit after N consecutive empty polls (batch mode)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    backend = compute.TorchSweepBackend(device=args.device)
    worker = Worker(args.connect, backend, worker_id=args.id,
                    poll_interval_s=args.poll_s,
                    status_interval_s=args.status_s,
                    jobs_per_chip=args.jobs_per_chip)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: worker.stop())
    log.info("worker %s -> %s (device=%s)", worker.worker_id, args.connect,
             backend.device)
    worker.run(max_idle_polls=args.exit_after_idle)


if __name__ == "__main__":
    main()
