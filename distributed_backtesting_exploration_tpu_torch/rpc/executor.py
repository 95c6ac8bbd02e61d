"""The worker's compute side: job batches in, completions out (the
reference worker's ``_compute_loop``, ``_compute_loop_pipelined`` and
``_collect_loop``, apart from its gRPC loop so that it runs without
``grpc``).

By default the executor runs the serial loop: one ``process`` call a
batch. ``DBX_PIPELINE=1`` runs a two-phase backend (``submit`` and
``collect``) as a pipeline of two threads instead: the submit thread
resolves, stacks and launches batch N+1 while the collector thread waits
for batch N's device-to-host copy and packs its blocks. Depth counts
submitted-but-uncollected batches, the one being collected included, and
is enforced by reserving a slot before each submit: at depth 2 one batch
is on the card while the next is staged. The serial loop is the
pipeline's bit-identity reference, and the default because on the H100
the pipeline ran fewer batches a second than it (PERF.md §6): both
threads spend most of a batch in Python under the interpreter lock, and
the card's share of a batch is a few milliseconds. The reference's
worker defaults to the pipeline; a backend with ``process`` only always
runs serially.

Shutdown is an ordered drain: the sentinel :meth:`Executor.close` puts
behind the queued batches passes through both stages in order, so every
batch taken before it is submitted and collected before the threads exit.
A batch whose submit or collect raises is logged and gets no completions:
its jobs stay leased and the dispatcher re-queues them; it also fires the
flight recorder's ``collect_fail`` trigger (``obs.flight``), which writes
a bundle where ``DBX_FLIGHT_DIR`` is set.

Spans, the reference worker's, each on the batch's traces and carrying
``jobs`` and ``worker``: ``worker.process`` around a serial batch;
``worker.submit`` and ``worker.collect`` around the pipeline's two halves,
and ``worker.inflight`` for the window between a batch's submit and the
start of its collect, when it is on the card while the submit thread
stages the next.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time

from .. import obs
from ..obs import flight as obs_flight

log = logging.getLogger("dbx.torch.executor")


def pipeline_enabled() -> bool:
    """``DBX_PIPELINE`` (default off): any value but ``0``, ``off`` or
    ``false`` runs a two-phase backend through the submit/collect
    pipeline. Read when an executor is made, never at import."""
    return os.environ.get("DBX_PIPELINE", "0").lower() not in (
        "0", "off", "false")


def pipeline_depth() -> int:
    """``DBX_PIPELINE_DEPTH`` (default 2, at least 1): batches submitted
    and not yet collected before the submit thread waits."""
    return max(int(os.environ.get("DBX_PIPELINE_DEPTH", "2")), 1)


class Executor:
    """Runs batches put into :attr:`inbox` on ``backend`` and puts each
    :class:`~.compute.Completion` into :attr:`outbox`.

    ``pipelined`` and ``depth`` default to ``DBX_PIPELINE`` and
    ``DBX_PIPELINE_DEPTH``; a backend without ``submit`` and ``collect``
    always runs serially. :attr:`busy` is set while any batch is in flight.
    ``worker_id`` names the worker in spans and flight triggers.
    ``inbox`` and ``outbox`` default to a ``queue.Queue`` of
    ``max_queued`` batches and an unbounded one; the worker passes its
    channels (anything with ``put``, ``get``, ``get_nowait`` raising
    ``queue.Empty``, and ``qsize``).
    """

    def __init__(self, backend, *, max_queued: int = 2,
                 pipelined: bool | None = None, depth: int | None = None,
                 worker_id: str = "", inbox=None, outbox=None):
        self.backend = backend
        self.worker_id = worker_id
        two_phase = (hasattr(backend, "submit")
                     and hasattr(backend, "collect"))
        self.pipelined = two_phase and (pipeline_enabled() if pipelined
                                        is None else pipelined)
        self.depth = pipeline_depth() if depth is None else max(int(depth), 1)
        self.inbox = queue.Queue(max_queued) if inbox is None else inbox
        self.outbox = queue.Queue() if outbox is None else outbox
        self.busy = threading.Event()
        self._lock = threading.Lock()
        self._inflight = 0
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        run = self._run_pipelined if self.pipelined else self._run_serial
        self._thread = threading.Thread(target=run, name="dbx-torch-compute",
                                        daemon=True)
        self._thread.start()

    def close(self, timeout: float = 60.0) -> bool:
        """Put the shutdown sentinel behind the queued batches and wait for
        the drain; False when it did not finish within ``timeout``
        seconds (its batches stay leased)."""
        self.inbox.put(None)
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def take_completions(self) -> list:
        """The completions produced so far, without waiting."""
        out = []
        while True:
            try:
                out.append(self.outbox.get_nowait())
            except queue.Empty:
                return out

    @property
    def inflight(self) -> int:
        """Batches taken and not yet fully collected."""
        with self._lock:
            return self._inflight

    @contextlib.contextmanager
    def _span(self, name: str, batch):
        """The span ``name`` inside ``obs.trace_context`` of the batch's
        dispatcher-minted traces: it joins each job's trace."""
        with obs.trace_context(obs.job_trace_pairs(batch)), \
                obs.span(name, jobs=len(batch), worker=self.worker_id):
            yield

    def _failed(self, what: str, batch, err: Exception) -> None:
        """The boundary that must keep running: the batch's jobs stay
        leased and the dispatcher re-queues them."""
        log.error("%s a batch of %d jobs failed; leaving the leases to "
                  "re-queue them", what, len(batch), exc_info=err)
        obs_flight.trigger("collect_fail", subject=self.worker_id,
                           jobs=len(batch), reason=repr(err))

    def _begin(self) -> None:
        with self._lock:
            self._inflight += 1
            self.busy.set()

    def _end(self) -> None:
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                self.busy.clear()

    def _emit(self, batch, completions) -> None:
        if len(completions) < len(batch):
            log.info("%d of %d jobs refused; leaving their leases to "
                     "re-queue them", len(batch) - len(completions),
                     len(batch))
        for c in completions:
            self.outbox.put(c)

    def _run_serial(self) -> None:
        while True:
            batch = self.inbox.get()
            if batch is None:
                return
            self._begin()
            try:
                with self._span("worker.process", batch):
                    completions = self.backend.process(batch)
                self._emit(batch, completions)
            except Exception as e:
                self._failed("processing", batch, e)
            finally:
                self._end()

    def _run_pipelined(self) -> None:
        handoff: queue.Queue = queue.Queue()
        # The slot is reserved BEFORE the submit launches device work:
        # bounding the handoff queue instead would let depth + 2 batches
        # live on the card.
        slots = threading.BoundedSemaphore(self.depth)
        collector = threading.Thread(target=self._collect_loop,
                                     args=(handoff, slots),
                                     name="dbx-torch-collect", daemon=True)
        collector.start()
        try:
            while True:
                batch = self.inbox.get()
                if batch is None:
                    return
                slots.acquire()
                self._begin()
                try:
                    with self._span("worker.submit", batch):
                        handle = self.backend.submit(batch)
                except Exception as e:
                    self._failed("submitting", batch, e)
                    self._end()
                    slots.release()
                    continue
                handoff.put((handle, batch, time.time()))
        finally:
            # The sentinel lands behind every submitted batch, so the
            # collector finishes them all before it exits.
            handoff.put(None)
            collector.join()

    def _collect_loop(self, handoff: queue.Queue, slots) -> None:
        while True:
            item = handoff.get()
            if item is None:
                return
            handle, batch, submitted = item
            # Without a span, obs.timeline would charge the window in which
            # the batch is on the card to transport.
            wait_s = time.time() - submitted
            if wait_s > 0:
                obs.emit_span("worker.inflight", submitted, wait_s,
                              pairs=obs.job_trace_pairs(batch),
                              jobs=len(batch))
            try:
                with self._span("worker.collect", batch):
                    completions = self.backend.collect(handle)
                self._emit(batch, completions)
            except Exception as e:
                self._failed("collecting", batch, e)
            finally:
                self._end()
                slots.release()

