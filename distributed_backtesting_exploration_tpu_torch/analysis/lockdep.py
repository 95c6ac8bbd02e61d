"""Runtime lockdep (``DBX_LOCKDEP=1``): the reference's
``analysis/lockdep.py``.

Static analysis sees every PATH; it cannot see which paths actually run,
and it cannot see locks that meet only through dynamic dispatch. This
module records what the fleet's threads really do, Linux-lockdep style:

- ``install()`` replaces ``threading.Lock``/``RLock`` with factories
  that wrap locks CREATED FROM THIS PACKAGE's modules in an
  instrumented shim (the creating frame's ``__name__`` decides — third
  party and stdlib locks pass through untouched, so gRPC/torch/logging
  internals cost nothing and cannot pollute the tables). A lock's
  *class* is its creation site (``module.Class:line``) — all instances
  of one site share one node in the order graph, exactly the
  granularity the static rules reason at;
- every **blocking** acquire taken while other instrumented locks are
  held records an acquisition-order edge into a bounded table
  (``DBX_LOCKDEP_MAX_EDGES``, default 4096; overflow is counted, never
  silently dropped). A new edge that closes a cycle in the class graph
  is an ``order-cycle`` violation — reported at the first offending
  acquire, BEFORE any thread actually deadlocks. Non-blocking
  (``acquire(False)``) probes record nothing: a trylock cannot
  deadlock. Re-acquiring the same *instance* of a plain Lock is a
  ``self-deadlock`` violation (reported, then the real acquire is
  allowed to proceed — surfacing the hang's cause is the job);
- blocking calls are sanitized too: ``time.sleep``, the card's waits
  (``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize``,
  ``torch.cuda.Stream.synchronize``) and
  ``concurrent.futures.Future.result`` are patched (plus gRPC's unary-unary client call, best-effort) to
  flag a ``blocking`` violation when the calling thread holds any
  instrumented lock — the runtime form of the ``lock-blocking`` rule;
- per-lock-class **held durations** (max/total/count) accumulate in a
  bounded table keyed by the same creation sites.

Findings land on three surfaces: the obs JSONL event log
(``lockdep_violation`` events), the metrics registry
(``dbx_lockdep_edges`` gauge, ``dbx_lockdep_violations_total{kind}``)
and :func:`report` (what the tests assert on).

**Exemptions** (``_EXEMPT_MODULES``): locks created by ``obs.registry``
and ``obs.events`` stay raw. Every counter increment and every JSONL
line takes one of those locks — instrumenting them would put a
metrics-path edge under every lock in the package (self-edges flooding
the table from lockdep's OWN reporting), and a Counter/Gauge lock is a
two-instruction leaf by construction.

Zero cost when off: nothing is patched until :func:`install` runs, and
``uninstall()`` restores every patched symbol (already-created shims
keep working but stop recording — ``_active`` gates every hook).

**Coverage boundary**: only locks created AFTER install are wrapped.
Instance locks are — the queue/store/cache locks all construct inside
``main()``/fixtures, after the hook — but the package's few
MODULE-LEVEL locks (``sched.tenancy._BUCKET_LOCK``, ``obs.trace``'s
ring locks, ``runtime._core._lock``) are created at import, which
precedes every install hook, and stay raw. Those are exactly the locks
the STATIC rules see best (module locks need no type inference), so
the division of labor is deliberate: static analysis owns module-level
orderings, lockdep owns the instance locks dynamic dispatch hides.

The reference package has a lockdep of its own that patches the same
``threading`` factories: never install both in one process. This one
wraps only locks created by this package's modules (the creator frame).
"""

from __future__ import annotations

import os
import sys
import threading
import time

PACKAGE_PREFIX = "distributed_backtesting_exploration_tpu_torch"

# Modules whose locks stay raw (module docstring): the metrics/event
# reporting path itself.
_EXEMPT_MODULES = ("obs.registry", "obs.events")

_DEFAULT_MAX_EDGES = 4096
_MAX_VIOLATIONS = 256

# Real factories/functions captured at import, before any patching.
_RealLock = threading.Lock
_RealRLock = threading.RLock
_real_sleep = time.sleep

_active = False
_installed = False
_saved: dict = {}

# Model-checker seam (analysis/modelcheck): when set, every instrumented
# lock crossing reports to the controlled scheduler — ``hook("acquire",
# key)`` BEFORE a blocking acquire (the preemption point: the scheduler
# may park this thread and run another), ``hook("acquired", key)`` after
# the acquire succeeds and ``hook("release", key)`` after the release
# (ownership tracking — the scheduler must never switch to a thread that
# would block on a parked thread's lock). None (the default) costs one
# global read per crossing.
_schedule_hook = None


def set_schedule_hook(fn) -> None:
    """Install (or with None, remove) the controlled-scheduler hook."""
    global _schedule_hook
    _schedule_hook = fn


def max_edges() -> int:
    return int(os.environ.get("DBX_LOCKDEP_MAX_EDGES",
                              _DEFAULT_MAX_EDGES))


def enabled() -> bool:
    """The ``DBX_LOCKDEP`` opt-in knob (read lazily, never at import)."""
    return os.environ.get("DBX_LOCKDEP") == "1"


class _State:
    """All lockdep bookkeeping, guarded by one RAW lock."""

    def __init__(self):
        self.lock = _RealLock()
        self.edges: dict = {}          # (a, b) -> count
        self.adj: dict = {}            # a -> set of b
        self.edge_sites: dict = {}     # (a, b) -> first (thread, when)
        self.dropped_edges = 0
        self.violations: list = []     # bounded list of dicts
        self.violation_keys: set = set()
        self.held_stats: dict = {}     # class -> [count, total_s, max_s]
        self.local = threading.local()  # .held = [(class, instance, t0)]


_state = _State()
_counters: dict = {}


def _held(create: bool = True):
    held = getattr(_state.local, "held", None)
    if held is None:
        if not create:
            return []
        held = _state.local.held = []
    return held


def _class_key_from_frame(depth: int) -> str | None:
    """Creation-site lock class for the factory caller, or None when the
    creator is not this package (or is exempt)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    mod = frame.f_globals.get("__name__", "")
    if not (mod == PACKAGE_PREFIX or mod.startswith(PACKAGE_PREFIX + ".")):
        return None
    short = mod[len(PACKAGE_PREFIX):].lstrip(".") or "<pkg>"
    if short in _EXEMPT_MODULES:
        return None
    owner = frame.f_locals.get("self")
    cls = type(owner).__name__ if owner is not None else None
    return (f"{short}.{cls}:{frame.f_lineno}" if cls
            else f"{short}:{frame.f_lineno}")


def _record_violation(kind: str, **detail) -> None:
    key = (kind, tuple(sorted(str(v) for v in detail.values())))
    with _state.lock:
        if key in _state.violation_keys:
            return
        _state.violation_keys.add(key)
        if len(_state.violations) < _MAX_VIOLATIONS:
            _state.violations.append(
                {"kind": kind, "thread": threading.current_thread().name,
                 **detail})
    c = _counters.get(kind)
    if c is not None:
        c.inc()
    try:
        from .. import obs

        obs.events.emit("lockdep_violation", kind=kind, **detail)
    except Exception:
        pass   # reporting must never take the process down
    try:
        from ..obs import flight

        # A lock-order violation is a latent-deadlock incident: capture
        # the black box while the offending acquire's context is still
        # in the ring. The DEFERRED path is mandatory here — this hook
        # runs at the acquire site with the offending locks held, so a
        # plain trigger() would add the recorder's own lock to the
        # order graph being reported.
        flight.trigger_deferred("lockdep", subject=kind, **detail)
    except Exception:
        pass


def _find_path(src: str, dst: str) -> list | None:
    """DFS over the class adjacency for a path src -> dst (caller holds
    ``_state.lock``)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _state.adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _before_blocking_acquire(lock: "_LockdepLock") -> None:
    held = _held(create=False)
    if not held:
        return
    for hcls, hobj, _t0 in held:
        if hobj is lock and not lock._reentrant:
            _record_violation("self-deadlock", lock=lock.key)
            continue
        if hobj is lock:
            continue
        key = (hcls, lock.key)
        with _state.lock:
            n = _state.edges.get(key)
            if n is not None:
                _state.edges[key] = n + 1
                continue
            if len(_state.edges) >= max_edges():
                _state.dropped_edges += 1
                continue
            # New edge: does the REVERSE direction already have a path?
            cycle = _find_path(lock.key, hcls)
            _state.edges[key] = 1
            _state.adj.setdefault(hcls, set()).add(lock.key)
            _state.adj.setdefault(lock.key, set())
        if cycle is not None:
            _record_violation(
                "order-cycle",
                path=" -> ".join([hcls] + cycle),
                acquiring=lock.key, holding=hcls)


def _push(lock: "_LockdepLock") -> None:
    _held().append((lock.key, lock, time.monotonic()))


def _pop(lock: "_LockdepLock") -> None:
    held = _held(create=False)
    for i in range(len(held) - 1, -1, -1):
        if held[i][1] is lock:
            _cls, _obj, t0 = held.pop(i)
            dur = time.monotonic() - t0
            with _state.lock:
                s = _state.held_stats.setdefault(lock.key, [0, 0.0, 0.0])
                s[0] += 1
                s[1] += dur
                if dur > s[2]:
                    s[2] = dur
            return


class _LockdepLock:
    """Instrumented wrapper around one real lock instance."""

    __slots__ = ("_lock", "key", "_reentrant")

    def __init__(self, real, key: str, reentrant: bool):
        self._lock = real
        self.key = key
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _active and blocking:
            if _schedule_hook is not None:
                _schedule_hook("acquire", self.key)
            _before_blocking_acquire(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok and _active:
            _push(self)
            if blocking and _schedule_hook is not None:
                _schedule_hook("acquired", self.key)
        return ok

    def release(self):
        self._lock.release()
        if _active:
            _pop(self)
            if _schedule_hook is not None:
                _schedule_hook("release", self.key)

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        # Condition/queue interop: delegate anything else to the real
        # lock (and let AttributeError propagate for probes like
        # _release_save so callers take their documented fallbacks).
        return getattr(self._lock, name)


def _lock_factory():
    if not _active:
        return _RealLock()
    key = _class_key_from_frame(2)
    if key is None:
        return _RealLock()
    return _LockdepLock(_RealLock(), key, reentrant=False)


def _rlock_factory():
    if not _active:
        return _RealRLock()
    key = _class_key_from_frame(2)
    if key is None:
        return _RealRLock()
    return _LockdepLock(_RealRLock(), key, reentrant=True)


def check_blocking(what: str) -> None:
    """Flag a ``blocking`` violation when the calling thread holds any
    instrumented lock — the public hook the patched blocking calls (and
    any subsystem wanting explicit coverage) funnel through."""
    if not _active:
        return
    held = _held(create=False)
    if held:
        _record_violation(
            "blocking", call=what,
            locks=", ".join(sorted({h[0] for h in held})))


def _sleep_patched(secs):
    check_blocking("time.sleep")
    return _real_sleep(secs)


def install() -> None:
    """Patch the factories and blocking calls (idempotent). Instances
    created BEFORE install stay raw — install early (the conftest hook
    runs before any fixture constructs a queue/worker; the dispatcher
    and worker mains install before building anything)."""
    global _active, _installed
    if _installed:
        _active = True
        return
    _installed = True
    _active = True
    _saved["Lock"] = threading.Lock
    _saved["RLock"] = threading.RLock
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _saved["sleep"] = time.sleep
    time.sleep = _sleep_patched
    try:
        import concurrent.futures as cf

        real_result = cf.Future.result
        _saved["future_result"] = real_result

        def result_patched(self, timeout=None):
            check_blocking("Future.result")
            return real_result(self, timeout)

        cf.Future.result = result_patched
    except Exception:
        pass
    _patch_cuda_waits()
    grpc_channel = sys.modules.get("grpc._channel")
    if grpc_channel is not None:
        try:
            multi = grpc_channel._UnaryUnaryMultiCallable
            real_call = multi.__call__
            _saved["grpc_call"] = (multi, real_call)

            def grpc_patched(self, *a, **k):
                check_blocking("grpc.unary_unary")
                return real_call(self, *a, **k)

            multi.__call__ = grpc_patched
        except AttributeError:
            pass   # private API moved: gRPC coverage is best-effort
    _register_metrics()


def _patch_cuda_waits() -> None:
    """Patch the card's blocking waits (``torch.cuda.synchronize`` and the
    ``synchronize`` of ``torch.cuda.Event`` and ``torch.cuda.Stream``) to
    funnel through :func:`check_blocking`; :func:`uninstall` restores
    them. Only where torch is already imported: installing imports
    nothing."""
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    if cuda is None:
        return
    saved = []
    targets = [(cuda, "synchronize", "torch.cuda.synchronize")]
    for cls in ("Event", "Stream"):
        owner = getattr(cuda, cls, None)
        if owner is not None:
            targets.append((owner, "synchronize",
                            f"torch.cuda.{cls}.synchronize"))
    for owner, name, label in targets:
        real = getattr(owner, name, None)
        if real is None:
            continue
        saved.append((owner, name, real))

        def patched(*a, _real=real, _label=label, **k):
            check_blocking(_label)
            return _real(*a, **k)

        setattr(owner, name, patched)
    _saved["cuda_waits"] = saved


def _register_metrics() -> None:
    try:
        from .. import obs
    except Exception:
        return
    reg = obs.get_registry()
    reg.gauge_fn(
        "dbx_lockdep_edges",
        lambda: len(_state.edges),
        help="distinct lock-acquisition-order edges recorded by the "
             "runtime lockdep shim")
    for kind in ("order-cycle", "blocking", "self-deadlock"):
        _counters[kind] = reg.counter(
            "dbx_lockdep_violations_total",
            help="lockdep violations by kind (order-cycle = ABBA risk, "
                 "blocking = blocking call under a lock, self-deadlock "
                 "= plain Lock re-acquired by its holder)",
            kind=kind)


def maybe_install() -> None:
    """The env hook: install iff ``DBX_LOCKDEP=1`` (zero work otherwise)."""
    if enabled():
        install()


def uninstall() -> None:
    """Restore every patched symbol and stop recording. Shims created
    while installed keep functioning as plain locks."""
    global _active, _installed
    _active = False
    if not _installed:
        return
    _installed = False
    threading.Lock = _saved.pop("Lock", _RealLock)
    threading.RLock = _saved.pop("RLock", _RealRLock)
    time.sleep = _saved.pop("sleep", _real_sleep)
    real_result = _saved.pop("future_result", None)
    if real_result is not None:
        import concurrent.futures as cf

        cf.Future.result = real_result
    for owner, name, real in _saved.pop("cuda_waits", ()):
        setattr(owner, name, real)
    grpc_saved = _saved.pop("grpc_call", None)
    if grpc_saved is not None:
        multi, real_call = grpc_saved
        multi.__call__ = real_call


def reset() -> None:
    """Clear the tables (patches stay); the test-harness seam."""
    with _state.lock:
        _state.edges.clear()
        _state.adj.clear()
        _state.edge_sites.clear()
        _state.violations.clear()
        _state.violation_keys.clear()
        _state.held_stats.clear()
        _state.dropped_edges = 0


def active() -> bool:
    return _active


def report() -> dict:
    """Snapshot: edge count, per-edge acquire counts, violations, and
    per-class held-duration stats."""
    with _state.lock:
        return {
            "edges": len(_state.edges),
            "edge_counts": {f"{a} -> {b}": n
                            for (a, b), n in sorted(_state.edges.items())},
            "dropped_edges": _state.dropped_edges,
            "violations": list(_state.violations),
            "held": {cls: {"acquires": s[0],
                           "held_total_s": round(s[1], 6),
                           "held_max_s": round(s[2], 6)}
                     for cls, s in sorted(_state.held_stats.items())},
        }
