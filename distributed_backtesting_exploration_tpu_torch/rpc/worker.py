"""Polling gRPC worker of the port (reference ``rpc/worker.py``, minimal).

The loop: a heartbeat thread sends ``SendStatus`` every
``status_interval_s`` (so a long batch does not get the worker pruned),
and the main loop polls ``RequestJobs`` with ``accepts_digest_only=False``
(payloads arrive inline, no ``FetchPayload`` needed), runs the batch
through the backend's ``process`` and reports the results with
``CompleteJobs``. A job the backend refuses (a field the port does not
serve yet) gets no completion and stays leased, and the dispatcher
re-queues it when the lease expires; the other jobs of its batch are
reported. A batch whose ``process`` raises is logged and left leased the
same way.

Run it:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.worker \
        --connect localhost:50051 --device cuda
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import uuid

import grpc

from . import backtesting_pb2 as pb
from . import compute, service

log = logging.getLogger("dbx.torch.worker")

# Seconds between the attempts to report one batch of completions; after
# the last the batch is dropped and its leases re-queue the jobs.
_REPORT_BACKOFF_S = (0.2, 1.0, 3.0)


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
        self._stop = threading.Event()
        self._busy = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self, *, max_idle_polls: int | None = None) -> None:
        """Run until stopped, or until ``max_idle_polls`` consecutive empty
        polls once at least one job was seen."""
        channel = grpc.insecure_channel(
            self.target, options=service.default_channel_options(),
            compression=grpc.Compression.Gzip)
        stub = service.DispatcherStub(channel)
        done = threading.Event()
        beat = threading.Thread(target=self._heartbeat, args=(stub, done),
                                name="dbx-torch-heartbeat", daemon=True)
        beat.start()
        idle_polls = 0
        saw_work = False
        try:
            while not self._stop.is_set():
                jobs = self._poll(stub)
                if jobs:
                    saw_work = True
                    idle_polls = 0
                    self._run_batch(stub, jobs)
                    continue
                if jobs is not None:
                    idle_polls += 1
                if (max_idle_polls is not None and saw_work
                        and idle_polls >= max_idle_polls):
                    log.info("idle for %d polls; exiting", idle_polls)
                    break
                self._stop.wait(self.poll_interval_s)
        finally:
            done.set()
            beat.join(timeout=10.0)
            channel.close()

    def _heartbeat(self, stub, done: threading.Event) -> None:
        while not done.is_set():
            status = (pb.WORKER_STATUS_RUNNING if self._busy.is_set()
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
            jobs_per_chip=self.jobs_per_chip, accepts_digest_only=False)
        try:
            return list(stub.RequestJobs(req, timeout=30.0).jobs)
        except grpc.RpcError as e:
            log.warning("RequestJobs failed: %s", e.code())
            return None

    def _run_batch(self, stub, jobs) -> None:
        log.info("received %d jobs", len(jobs))
        self._busy.set()
        try:
            completions = self.backend.process(jobs)
        except Exception:
            # The boundary that must keep running: the jobs stay leased
            # and are re-queued by the dispatcher when the lease expires.
            log.exception("batch of %d jobs failed; leaving the leases to "
                          "re-queue them", len(jobs))
            return
        finally:
            self._busy.clear()
        if len(completions) < len(jobs):
            log.info("%d of %d jobs refused; leaving their leases to "
                     "re-queue them", len(jobs) - len(completions), len(jobs))
        if completions:
            self._report(stub, completions)

    def _report(self, stub, completions) -> None:
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
