"""Span/trace API + timing utilities: the reference's ``obs/trace.py``.

A :func:`span` is the unit of phase attribution: it times a named phase,
records the duration into the shared registry's ``dbx_span_seconds``
histogram (labeled by span name), tracks nesting per thread, and — when the
JSONL event log is configured — emits one event per span with its parent,
so a post-mortem reader can rebuild the per-batch chain
(``decode -> submit -> collect -> report``) from the log alone.

Distributed traces (round 7): every span now carries a
``(trace_id, span_id, parent_id)`` triple. The ambient trace is a
``contextvars.ContextVar`` holding the remote parent(s) a span chain
should join — the dispatcher mints one trace_id per job at enqueue time,
ships it over the wire (``JobSpec.trace_id`` / ``parent_span_id``), and
the worker adopts it with :func:`trace_context` so its local span chain
becomes children of the dispatcher's dispatch span. A compute batch can
serve SEVERAL jobs (several traces) at once; a multi-trace context makes
spans carry a ``traces`` list of ``[trace_id, parent_span_id]`` pairs
instead of one ``trace_id`` — the timeline analyzer (:mod:`.timeline`)
fans such spans out to every listed trace.

Completed spans land in three places: the ``dbx_span_seconds`` histogram
(aggregate), the JSONL event log when configured (durable), and a bounded
in-memory ring (:func:`recent_spans`) exported via ``/stats.json`` and
GetStats ``obs_json`` so a live process can be asked "what just ran"
without any log file.

``timed`` (log-only), ``StepTimer`` (running throughput meter) and
``device_profile`` (a ``torch.profiler`` wrapper) complete the module.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import logging
import os
import random
import threading
import time

from . import events
from .registry import get_registry

log = logging.getLogger("dbx.trace")

_tls = threading.local()

# Ambient remote-trace context: a tuple of (trace_id, parent_span_id)
# pairs the NEXT outermost span on this thread should join. Contextvars
# are per-thread for plain threads, so the worker's control and compute
# threads each set their own.
_trace_ctx: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "dbx_trace_ctx", default=())

# ID minting: 128-bit trace ids / 64-bit span ids as lowercase hex.
# random.getrandbits is ~3x cheaper than uuid4 and these ids only need
# collision resistance within one fleet run, not global uniqueness.
_rand = random.Random()


def new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def current_span() -> str | None:
    """Name of the innermost active span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1][0] if stack else None


def current_trace() -> str | None:
    """The ambient trace id when exactly one trace is adopted, else None."""
    pairs = _trace_ctx.get()
    return pairs[0][0] if len(pairs) == 1 else None


@contextlib.contextmanager
def trace_context(trace_id, parent_span_id: str = ""):
    """Adopt a remote trace for the duration of the block.

    ``trace_id`` is either one id string (with its ``parent_span_id``) or
    a list of ``(trace_id, parent_span_id)`` pairs — the multi-job batch
    case. Pairs with empty trace ids are dropped (jobs enqueued by a
    pre-tracing dispatcher); an all-empty context leaves spans untraced,
    exactly the old behavior.
    """
    if isinstance(trace_id, str):
        pairs = ((trace_id, parent_span_id or ""),) if trace_id else ()
    else:
        pairs = tuple((t, p or "") for t, p in trace_id if t)
    token = _trace_ctx.set(pairs)
    try:
        yield
    finally:
        _trace_ctx.reset(token)


def job_trace_pairs(jobs) -> list:
    """``(trace_id, parent_span_id)`` pairs of a job batch (JobSpec or any
    object exposing ``trace_id`` / ``parent_span_id``), traceless jobs
    skipped — the argument :func:`trace_context` takes for a batch."""
    out = []
    for j in jobs:
        tid = getattr(j, "trace_id", "")
        if tid:
            out.append((tid, getattr(j, "parent_span_id", "")))
    return out


# ---------------------------------------------------------------------------
# Bounded in-memory span ring
# ---------------------------------------------------------------------------

SPAN_RING_CAPACITY = 512

_ring_lock = threading.Lock()
# Created lazily at first use so the capacity knob (DBX_SPAN_RING) is
# read when the ring is first needed, not at import time — the
# DBX_OBS_JSONL discipline: tests and operators can set it after import.
_ring: collections.deque | None = None


def _ring_capacity() -> int:
    """``DBX_SPAN_RING`` (default 512): completed spans retained for
    /stats.json, GetStats ``obs_json`` and bench's end-of-run timeline
    digest. 0 disables the ring entirely."""
    try:
        return max(int(os.environ.get("DBX_SPAN_RING",
                                      SPAN_RING_CAPACITY)), 0)
    except ValueError as e:
        raise ValueError(
            f"DBX_SPAN_RING={os.environ['DBX_SPAN_RING']!r} is not an "
            "integer") from e


def _get_ring() -> collections.deque:
    """The ring, created at first use (caller holds ``_ring_lock``)."""
    global _ring
    if _ring is None:
        _ring = collections.deque(maxlen=_ring_capacity())
    return _ring


def configure_ring(capacity: int | None = None) -> None:
    """Resize (and clear) the completed-span ring. 0 disables it; None
    re-reads ``DBX_SPAN_RING`` — the reset path for tests/benches that
    flip the env knob after the ring already materialized."""
    global _ring
    with _ring_lock:
        _ring = collections.deque(
            maxlen=_ring_capacity() if capacity is None
            else max(int(capacity), 0))


def recent_spans(n: int | None = None) -> list[dict]:
    """The last ``n`` (default: all retained) completed span records,
    oldest first — the same dicts the JSONL event log would carry.

    Copies only the requested tail under the ring lock: every span
    completion appends under the same lock, so a stats scrape of a large
    ring (bench sizes it to 32k via DBX_SPAN_RING) must not stall the
    hot path for a full-ring copy."""
    with _ring_lock:
        ring = _get_ring()
        if n is None:
            return list(ring)
        if n <= 0:
            return []
        return list(itertools.islice(ring, max(len(ring) - n, 0), None))


# In-process completed-span taps: keyed callables invoked (outside every
# lock) with each completed span record. The empty-tuple steady state
# keeps the hot path at one truthiness check; the tuple is rebuilt under
# the lock on add/remove so iteration never races a mutation.
_listeners: tuple = ()
_listeners_by_key: dict = {}
_listeners_lock = threading.Lock()


def add_span_listener(key: str, fn) -> None:
    """Register ``fn(record)`` to observe every completed span (the
    fleet-telemetry stage collector's feed). Keyed so a re-registered
    component replaces its predecessor instead of stacking."""
    global _listeners
    with _listeners_lock:
        _listeners_by_key[key] = fn
        _listeners = tuple(_listeners_by_key.values())


def remove_span_listener(key: str) -> None:
    global _listeners
    with _listeners_lock:
        _listeners_by_key.pop(key, None)
        _listeners = tuple(_listeners_by_key.values())


# Span histograms are get-or-create per distinct name; cache the children so
# repeated spans cost a dict lookup, not a registry resolution.
_span_hists: dict = {}
_span_hists_lock = threading.Lock()


def _span_hist(name: str):
    h = _span_hists.get(name)
    if h is None:
        with _span_hists_lock:
            h = _span_hists.get(name)
            if h is None:
                h = get_registry().histogram(
                    "dbx_span_seconds",
                    help="wall-clock duration of named phases (span API)",
                    span=name)
                _span_hists[name] = h
    return h


def _record_span(name: str, t0_wall: float, dur: float, *, span_id: str,
                 stack_parent, pairs: tuple, ok: bool = True,
                 **attrs) -> dict:
    """The one completed-span sink: histogram + ring + JSONL event.

    ``stack_parent`` is the enclosing local span as ``(name, span_id)`` or
    None; ``pairs`` the ambient (or explicit) remote-trace pairs. A nested
    span parents onto its local enclosing span; only the OUTERMOST span of
    a context parents onto the remote ``parent_span_id``.
    """
    _span_hist(name).observe(dur)
    rec = {"ev": "span", "name": name, "t0": round(t0_wall, 6),
           "dur_s": round(dur, 9), "span_id": span_id,
           "parent": stack_parent[0] if stack_parent else None,
           "thread": threading.current_thread().name, "ok": ok}
    if len(pairs) == 1:
        rec["trace_id"] = pairs[0][0]
        rec["parent_id"] = (stack_parent[1] if stack_parent
                            else pairs[0][1])
    elif pairs:
        rec["traces"] = [[t, p] for t, p in pairs]
        rec["parent_id"] = stack_parent[1] if stack_parent else ""
    elif stack_parent:
        rec["parent_id"] = stack_parent[1]
    rec.update(attrs)
    with _ring_lock:
        ring = _get_ring()
        if ring.maxlen:
            ring.append(rec)
    if events.enabled():
        events.emit_record(rec)
    for fn in _listeners:
        # In-process span taps (the fleet telemetry collector): called
        # OUTSIDE every lock with the already-built record; a listener
        # failure must never break the instrumented code path.
        try:
            fn(rec)
        except Exception:
            log.exception("span listener failed")
    return rec


def emit_span(name: str, t0_wall: float, dur_s: float, *,
              trace_id: str = "", parent_id: str = "", pairs=None,
              span_id: str | None = None, ok: bool = True,
              **attrs) -> str:
    """Record an already-measured span (histogram + ring + event log) and
    return its span id.

    The synthesized-span entry point for phases that are not ``with``
    blocks — the dispatcher's queue-wait (enqueue ts -> dispatch ts) and
    the job's end-to-end wall (enqueue ts -> completion recorded) exist
    only as two timestamps, never as one open stack frame. ``pairs``
    (a list of ``(trace_id, parent_span_id)``) overrides ``trace_id`` for
    the multi-job-batch case. An enclosing local span on this thread, if
    any, becomes the local parent — the compute backend emits its
    compile/execute spans from inside the worker's submit span.
    """
    sid = span_id or new_span_id()
    if pairs is None:
        pairs = ((trace_id, parent_id),) if trace_id else ()
    else:
        pairs = tuple((t, p or "") for t, p in pairs if t)
    stack = getattr(_tls, "stack", None)
    _record_span(name, t0_wall, max(float(dur_s), 0.0), span_id=sid,
                 stack_parent=stack[-1] if stack else None, pairs=pairs,
                 ok=ok, **attrs)
    return sid


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a named phase: ``with span("decode", jobs=32): ...``.

    Durations land in ``dbx_span_seconds{span=name}``; the completed span
    (with its ``trace_id``/``span_id``/``parent_id`` triple, ``t0`` wall
    start, and ``dur_s``) goes to the in-memory ring and — when the JSONL
    event log is configured — to the log. Exceptions propagate; the span
    records either way (``ok`` marks it).
    """
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
    sid = new_span_id()
    stack.append((name, sid))
    pairs = _trace_ctx.get()
    t0_wall = time.time()
    t0 = time.perf_counter()
    ok = True
    try:
        yield
    except BaseException:
        ok = False
        raise
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        _record_span(name, t0_wall, dur, span_id=sid, stack_parent=parent,
                     pairs=pairs, ok=ok, **attrs)


@contextlib.contextmanager
def timer(hist):
    """Observe the block's wall into a pre-resolved histogram — in a
    ``finally``, so failures and timeouts are measured too (an RPC
    latency histogram that excludes the 30 s deadline-exceeded calls
    reads healthy while throughput is zero)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist.observe(time.perf_counter() - t0)


@contextlib.contextmanager
def timed(name: str, *, logger: logging.Logger = log, level=logging.INFO):
    """Log the wall-clock duration of a phase: ``with timed("decode"): ...``"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s took %.1fms", name,
                   1e3 * (time.perf_counter() - t0))


@contextlib.contextmanager
def device_profile(logdir: str):
    """Capture a ``torch.profiler`` trace (host ops and, where CUDA is
    available, the card's kernels) and write it as a Chrome trace,
    ``trace.json``, under ``logdir``. View it in ``chrome://tracing`` or
    Perfetto."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Running throughput meter: the ``backtests/sec`` counter surfaced by
    the dispatcher's GetStats — usable worker-side for per-batch logs.

    Pass ``gauge`` (an :class:`~.registry.Gauge`) to publish the running
    rate on every :meth:`add`."""

    def __init__(self, gauge=None):
        self.t0 = time.monotonic()
        self.units = 0.0
        self._gauge = gauge

    def bind_gauge(self, gauge) -> None:
        """Attach (or detach, with None) the published-rate gauge after
        construction — for owners whose metric lifecycle starts later
        than their own (e.g. a Worker binds in run(), not __init__)."""
        self._gauge = gauge

    def add(self, n: float) -> None:
        self.units += n
        if self._gauge is not None:
            self._gauge.set(self.rate)

    @property
    def rate(self) -> float:
        return self.units / max(time.monotonic() - self.t0, 1e-9)
