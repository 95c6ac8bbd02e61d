"""dbxmc schedule layer: ops, interleavings, DPOR-lite pruning, and the
lock-boundary controlled scheduler.

The model checker (:mod:`.modelcheck`) runs the REAL dispatcher code, so
"a schedule" here is not an abstract trace — it is a concrete order in
which per-thread op programs (enqueue / take / complete / requeue /
append) are executed against a live :class:`rpc.dispatcher.JobQueue`.
This module owns the combinatorics:

- the op vocabulary (:class:`Op`) with a declared *footprint* per op —
  the static job-id set it may touch plus whether it reorders the
  shared pending pool. The footprint is deliberately over-approximate
  (ops with dynamic id sets, like ``take``, get the wildcard): an
  over-declared conflict only costs pruning, an under-declared one
  would merge genuinely different schedules;
- interleaving generation (:func:`generate_schedules`): seeded random
  topological merges of the per-thread programs, deduplicated through a
  Foata-style canonical form (:func:`canonical_key`) — adjacent
  independent ops are bubbled into a fixed thread order until fixpoint,
  so two interleavings that differ only by commuting independent ops
  count as ONE explored schedule. This is the DPOR idea run in
  normalize-and-dedupe form: cheaper than persistent-set bookkeeping,
  and sound for *counting* and for not re-executing equivalent
  schedules (:func:`enumerate_schedules` is the exhaustive DFS twin for
  small programs);
- the controlled scheduler (:class:`ControlledScheduler`) for
  ``--depth > 0``: ops run on real threads serialized by a token, and
  the lockdep instrumentation seam (``lockdep.set_schedule_hook``)
  turns every instrumented-lock acquire into a potential preemption
  point — bounded by ``depth`` preemptions per schedule, CHESS-style.
  Lock ownership is tracked from the hook events so the scheduler
  never parks a lock holder while running a thread that needs that
  lock; every wait is bounded, so a real deadlock reports ``wedged``
  instead of hanging the suite.
"""

from __future__ import annotations

import dataclasses
import threading

from . import lockdep

# Canonical thread order for Foata normalization (also the order the
# program builder assigns roles). Stable across runs by construction.
THREADS = ("client", "workerA", "workerB", "maint")

# Footprint wildcard: the op's id set is dynamic (depends on queue state
# at execution time) — conflicts with every non-observer op.
WILD = "*"


@dataclasses.dataclass(frozen=True)
class Op:
    """One schedulable operation of a thread's program.

    ``ids`` / ``pool`` / ``readonly`` are the conflict footprint;
    ``args`` is the op-specific payload the harness interprets. Ops are
    value objects (frozen) so schedules hash and replay scripts
    round-trip through JSON losslessly.
    """

    thread: str
    name: str
    args: tuple = ()           # flat (key, value) pairs, JSON-safe
    ids: frozenset = frozenset()
    pool: bool = False         # reorders the shared pending pool
    readonly: bool = True      # observer op (stats/drained probes)

    def arg(self, key, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default

    def to_json(self) -> dict:
        return {"thread": self.thread, "name": self.name,
                "args": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in self.args}}

    @staticmethod
    def from_json(rec: dict) -> "Op":
        return make_op(rec["thread"], rec["name"],
                       **{k: tuple(v) if isinstance(v, list) else v
                          for k, v in rec.get("args", {}).items()})


# name -> (pool, readonly, id-args) — the footprint table. Ops not in
# the table are rejected loudly (a replay script with a typo'd op name
# must be a config error, not a silent no-op).
_OP_KINDS = {
    # intake: static ids, adds to the pending pool
    "enqueue": dict(pool=True, readonly=False, id_args=("ids",)),
    # tick-only AppendBars onto the digest of a previously enqueued job:
    # journals a `delta` chain link, enqueues nothing
    "append": dict(pool=False, readonly=False, id_args=("src",)),
    # dispatch/completion: dynamic id sets -> wildcard footprint
    "take": dict(pool=True, readonly=False, id_args=None),
    "complete_taken": dict(pool=False, readonly=False, id_args=None),
    "complete_deferred": dict(pool=False, readonly=False, id_args=None),
    "complete_dup": dict(pool=False, readonly=False, id_args=None),
    # completion of STATIC ids regardless of lease state (exercises the
    # completed-while-pending tombstone path and the unknown-id reply);
    # touches the pool (tombstone install / parked-lane discard)
    "complete_ids": dict(pool=True, readonly=False, id_args=("ids",)),
    # recovery: dynamic (whatever is leased) -> wildcard
    "requeue_expired": dict(pool=True, readonly=False, id_args=None),
    "requeue_worker": dict(pool=True, readonly=False, id_args=None),
    # python-substrate virtual lease clock (no-op on native)
    "advance_clock": dict(pool=True, readonly=False, id_args=None),
    # observer: reads stats()/drained, mutates nothing
    "stats": dict(pool=False, readonly=True, id_args=()),
}


def make_op(thread: str, name: str, **args) -> Op:
    """Construct an op with its footprint derived from the kind table."""
    kind = _OP_KINDS.get(name)
    if kind is None:
        raise ValueError(f"unknown op {name!r}")
    ids: frozenset = frozenset()
    if kind["id_args"] is None:
        ids = frozenset([WILD])
    else:
        for key in kind["id_args"]:
            v = args.get(key)
            if isinstance(v, str):
                ids |= {v}
            elif v is not None:
                ids |= frozenset(v)
    return Op(thread=thread, name=name,
              args=tuple(sorted(args.items())),
              ids=ids, pool=kind["pool"], readonly=kind["readonly"])


def conflict(a: Op, b: Op) -> bool:
    """True when the two ops may NOT commute (same thread, or footprints
    intersect). Over-approximate by design — see the module docstring."""
    if a.thread == b.thread:
        return True
    if a.readonly or b.readonly:
        return False
    if a.pool and b.pool:
        return True
    if WILD in a.ids or WILD in b.ids:
        return True
    return bool(a.ids & b.ids)


# ---------------------------------------------------------------------------
# Program generation
# ---------------------------------------------------------------------------

def build_programs(n_ops: int, rng) -> dict[str, list[Op]]:
    """Deterministic per-thread op programs totalling ~``n_ops`` ops.

    The shape covers every queue transition family the invariants talk
    about: batched intake across two tenants, an append-chain link, two
    competing workers (take / complete / deferred-journal complete /
    duplicate complete / static-id completes hitting the tombstone
    path), and a maintenance thread running both requeue flavors. Sizes
    and orderings vary with the seed; ids are ``j0..jN`` so traces read
    and replay deterministically.
    """
    n_ops = max(int(n_ops), 8)
    n_jobs = max(2, n_ops // 3)
    jids = [f"j{i}" for i in range(n_jobs)]
    tenants = ["default", "tenantB"]

    client: list[Op] = []
    i = 0
    while i < n_jobs:
        k = min(rng.choice([1, 1, 2, 3]), n_jobs - i)
        client.append(make_op(
            "client", "enqueue", ids=tuple(jids[i:i + k]),
            tenant=tenants[(i // 2) % 2],
            combos=tuple(float(2 + (i + j) % 3) for j in range(k))))
        i += k
    # One tick-only append onto the first job's panel, somewhere after
    # its enqueue: exercises the delta-event/enqueue-record crash window
    # and the chain-reachability invariant at every later crash point.
    client.insert(rng.randrange(1, len(client) + 1),
                  make_op("client", "append", src=jids[0], bars=2))

    def worker(name: str, other: str) -> list[Op]:
        ops = [make_op(name, "take", worker=name,
                       n=rng.choice([1, 2, 3]))]
        for _ in range(max(1, n_ops // 6)):
            ops.append(make_op(name, "take", worker=name,
                               n=rng.choice([1, 2])))
            ops.append(make_op(
                name,
                rng.choice(["complete_taken", "complete_taken",
                            "complete_deferred"]),
                worker=name))
        if rng.random() < 0.7:
            ops.append(make_op(name, "complete_dup", worker=name))
        if rng.random() < 0.6:
            # Static-id completes: a pending (never-taken) id hits the
            # tombstone path, an unknown id the "unknown" reply; either
            # may race the other worker's take of the same id.
            ops.append(make_op(name, "complete_ids", worker=name,
                               ids=(rng.choice(jids), "never-enqueued")))
        ops.append(make_op(name, "complete_taken", worker=name))
        return ops

    maint = [make_op("maint", "stats")]
    for _ in range(max(1, n_ops // 8)):
        maint.append(make_op("maint", rng.choice(
            ["requeue_expired", "requeue_expired", "requeue_worker"]),
            worker=rng.choice(["workerA", "workerB"])))
    maint.append(make_op("maint", "stats"))

    return {"client": client,
            "workerA": worker("workerA", "workerB"),
            "workerB": worker("workerB", "workerA"),
            "maint": maint}


# ---------------------------------------------------------------------------
# Canonical form + schedule generation
# ---------------------------------------------------------------------------

def _thread_rank(op: Op) -> int:
    try:
        return THREADS.index(op.thread)
    except ValueError:
        return len(THREADS)


def canonical_key(schedule: list[Op]) -> tuple:
    """Foata-style normal form: bubble adjacent INDEPENDENT ops into the
    fixed thread order until fixpoint, then key by (thread, per-thread
    op index). Two interleavings with the same key are reachable from
    each other by commuting independent ops — equivalent executions."""
    seq = list(schedule)
    changed = True
    while changed:
        changed = False
        for i in range(len(seq) - 1):
            a, b = seq[i], seq[i + 1]
            if (not conflict(a, b)
                    and _thread_rank(a) > _thread_rank(b)):
                seq[i], seq[i + 1] = b, a
                changed = True
    counters: dict[str, int] = {}
    key = []
    for op in seq:
        k = counters.get(op.thread, 0)
        counters[op.thread] = k + 1
        key.append((op.thread, k))
    return tuple(key)


def merge_for_key(threads: dict[str, list[Op]], key: tuple) -> list[Op]:
    """Rebuild the concrete op list for a canonical key (replay path)."""
    counters: dict[str, int] = {}
    out = []
    for thread, _idx in key:
        i = counters.get(thread, 0)
        counters[thread] = i + 1
        out.append(threads[thread][i])
    return out


def random_merge(threads: dict[str, list[Op]], rng) -> list[Op]:
    """One seeded topological merge preserving per-thread order."""
    cursors = {t: 0 for t in threads}
    live = [t for t in threads if threads[t]]
    out: list[Op] = []
    while live:
        t = rng.choice(live)
        out.append(threads[t][cursors[t]])
        cursors[t] += 1
        if cursors[t] >= len(threads[t]):
            live.remove(t)
    return out


def generate_schedules(threads: dict[str, list[Op]], rng, limit: int,
                       max_attempts: int | None = None):
    """Yield up to ``limit`` DISTINCT schedules (distinct canonical
    forms) as ``(canonical_key, ops)`` pairs. Seeded-random merges with
    canonical dedupe: every yielded schedule is a genuinely inequivalent
    interleaving; commuting-only variants are pruned, never re-run."""
    seen: set = set()
    attempts = 0
    budget = max_attempts if max_attempts is not None else limit * 40
    while len(seen) < limit and attempts < budget:
        attempts += 1
        sched = random_merge(threads, rng)
        key = canonical_key(sched)
        if key in seen:
            continue
        seen.add(key)
        yield key, sched


def enumerate_schedules(threads: dict[str, list[Op]], limit: int):
    """Exhaustive DFS twin of :func:`generate_schedules` for small
    programs (the `slow` deep-exploration config): yields every distinct
    canonical class, deterministically, up to ``limit``."""
    seen: set = set()
    names = sorted(threads)

    def rec(cursors: dict[str, int], prefix: list[Op]):
        if len(seen) >= limit:
            return
        done = all(cursors[t] >= len(threads[t]) for t in names)
        if done:
            key = canonical_key(prefix)
            if key not in seen:
                seen.add(key)
                yield key, list(prefix)
            return
        for t in names:
            if cursors[t] < len(threads[t]):
                cursors[t] += 1
                prefix.append(threads[t][cursors[t] - 1])
                yield from rec(cursors, prefix)
                prefix.pop()
                cursors[t] -= 1

    yield from rec({t: 0 for t in names}, [])


# ---------------------------------------------------------------------------
# Controlled scheduler (--depth > 0): intra-op preemption at lock points
# ---------------------------------------------------------------------------

class Wedged(RuntimeError):
    """A controlled run stopped making progress (real deadlock or a
    hook wait past the bound) — reported, never hung."""


class ControlledScheduler:
    """Run per-thread op programs on REAL threads, serialized by a token,
    preempting at instrumented-lock acquire points (lockdep seam).

    At most one managed thread runs at a time; at every ``acquire``
    hook event the scheduler may (seeded, bounded by ``depth``) park the
    runner and wake another. Ownership is tracked from the
    ``acquired``/``release`` events: a thread about to block on a lock
    a PARKED thread holds hands the token to the holder instead (and
    gets it back at the release), so the controlled run explores
    genuine in-critical-section interleavings without self-inflicted
    deadlock. All waits are bounded: exceeding ``timeout_s`` raises
    :class:`Wedged` with the stuck thread set — a finding, not a hang.
    """

    def __init__(self, threads: dict[str, list[Op]], runner, *,
                 depth: int, rng, timeout_s: float = 20.0):
        self._programs = threads
        self._runner = runner          # callable(op) -> None
        self._depth = int(depth)
        self._rng = rng
        self._timeout = float(timeout_s)
        self._events = {t: threading.Event() for t in threads}
        # RAW lock (never the lockdep factory): the scheduler's own
        # bookkeeping must not become an instrumented scheduling point —
        # the hook would re-enter itself on its own mutex.
        self._mutex = lockdep._RealLock()
        self._current: str | None = None
        self._finished: set[str] = set()
        self._lock_owner: dict[str, str] = {}   # lock key -> thread name
        self._want: dict[str, str] = {}         # thread -> lock key waited
        self._preemptions = 0
        self._paused = 0               # crash-check reentrancy guard
        self._error: BaseException | None = None

    # -- public -----------------------------------------------------------

    def run(self) -> int:
        """Execute every program to completion; returns the number of
        preemptions taken. Raises :class:`Wedged` on a stuck run and
        re-raises the first op exception otherwise."""
        names = [t for t in THREADS if t in self._programs]
        names += [t for t in self._programs if t not in names]
        workers = [threading.Thread(target=self._thread_main, args=(t,),
                                    name=f"mc-{t}", daemon=True)
                   for t in names]
        lockdep.set_schedule_hook(self._hook)
        try:
            for w in workers:
                w.start()
            with self._mutex:
                self._current = names[0]
            self._events[names[0]].set()
            deadline = self._timeout
            for w in workers:
                w.join(timeout=deadline)
                if w.is_alive():
                    raise Wedged(
                        f"controlled schedule wedged: thread {w.name} "
                        f"still running; waiting-on={self._want}, "
                        f"owners={self._lock_owner}")
        finally:
            lockdep.set_schedule_hook(None)
            # Release any survivors so daemon threads can exit.
            for ev in self._events.values():
                ev.set()
        if self._error is not None:
            raise self._error
        return self._preemptions

    def pause(self) -> None:
        """Disable preemption (crash-check reentrancy: replay/restore
        work creates and takes fresh locks that must not become
        scheduling points)."""
        with self._mutex:
            self._paused += 1

    def resume(self) -> None:
        with self._mutex:
            self._paused -= 1

    # -- thread body -------------------------------------------------------

    def _thread_main(self, name: str) -> None:
        try:
            self._wait_for_token(name)
            for op in self._programs[name]:
                self._runner(op)
            with self._mutex:
                self._finished.add(name)
                nxt = self._pick_runnable(exclude=name)
            if nxt is not None:
                self._events[nxt].set()
        except BaseException as e:   # first error wins, run must unwind
            with self._mutex:
                if self._error is None:
                    self._error = e
                self._finished.add(name)
                nxt = self._pick_runnable(exclude=name)
            if nxt is not None:
                self._events[nxt].set()

    def _wait_for_token(self, name: str) -> None:
        if not self._events[name].wait(timeout=self._timeout):
            raise Wedged(f"thread {name} never received the token")
        with self._mutex:
            self._current = name

    # -- the lockdep hook --------------------------------------------------

    def _hook(self, phase: str, key: str) -> None:
        name = threading.current_thread().name
        if not name.startswith("mc-"):
            return
        name = name[3:]
        if name not in self._events:
            return
        if phase == "acquired":
            with self._mutex:
                self._lock_owner[key] = name
            return
        if phase == "release":
            self._switch_after_release(name, key)
            return
        # phase == "acquire": the preemption point.
        self._before_acquire(name, key)

    def _before_acquire(self, name: str, key: str) -> None:
        while True:
            with self._mutex:
                if self._paused or self._error is not None:
                    return
                owner = self._lock_owner.get(key)
                if owner is not None and owner != name:
                    # The holder is parked (only one thread runs at a
                    # time): hand it the token until it releases.
                    self._want[name] = key
                    self._events[name].clear()
                    nxt = owner
                elif (self._preemptions < self._depth
                        and self._rng.random() < 0.5):
                    nxt = self._pick_runnable(exclude=name)
                    if nxt is None:
                        return
                    self._preemptions += 1
                    self._events[name].clear()
                else:
                    return
                self._current = nxt
            self._events[nxt].set()
            if not self._events[name].wait(timeout=self._timeout):
                raise Wedged(
                    f"thread {name} starved waiting to acquire {key} "
                    f"(owner={self._lock_owner.get(key)})")
            with self._mutex:
                self._current = name
                self._want.pop(name, None)
                if self._lock_owner.get(key) in (None, name):
                    return   # free now — proceed into the real acquire

    def _switch_after_release(self, name: str, key: str) -> None:
        with self._mutex:
            if self._lock_owner.get(key) == name:
                del self._lock_owner[key]
            waiter = next((t for t, k in self._want.items() if k == key),
                          None)
            if waiter is None or self._paused:
                return
            self._events[name].clear()
            self._current = waiter
        self._events[waiter].set()
        if not self._events[name].wait(timeout=self._timeout):
            raise Wedged(f"thread {name} starved after releasing {key}")
        with self._mutex:
            self._current = name

    def _pick_runnable(self, exclude: str) -> str | None:
        """A thread that can make progress: not finished, not waiting on
        a lock someone still owns (caller holds ``self._mutex``)."""
        held = set(self._lock_owner.values())
        cands = [t for t in self._programs
                 if t != exclude and t not in self._finished
                 and (t not in self._want
                      or self._lock_owner.get(self._want[t]) is None)
                 and t not in held - {exclude}]
        # Threads currently holding a lock are parked mid-critical-
        # section; they stay eligible (they must eventually run to
        # release), but prefer lock-free threads for diversity.
        if not cands:
            cands = [t for t in self._programs
                     if t != exclude and t not in self._finished]
        if not cands:
            return None
        return self._rng.choice(sorted(cands))
