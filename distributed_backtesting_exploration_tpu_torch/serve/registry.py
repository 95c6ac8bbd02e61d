"""Subscription registry, result cache and push fan-out (package doc in
``__init__``).

Concurrency contract (dbxlint lock-order / lock-blocking / atomicity,
and the DBX_LOCKDEP=1 runtime harness, all hold it):

- ``SubscriptionHub._lock`` guards ONLY the registry maps (chains,
  streams, subscribers, in-flight advance index). Nothing is pushed,
  cached, diffed or waited on while it is held — every mutation phase
  snapshots what it needs under the lock and does the work after
  release.
- each :class:`Subscription` has its own leaf mutex around its bounded
  queue; the wake-up signal is a ``threading.Event`` set AFTER the
  mutex releases. The hub lock and a subscription mutex are never held
  together, so no ordering between them can ever form.
- :class:`ResultCache` wraps its ByteLRU in its own leaf lock; cache
  calls happen outside the hub lock.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import os
import threading
import time

import numpy as np

from .. import obs
from ..rpc.panel_store import ByteLRU
from ..sched import (DEFAULT_TENANT, parse_tenant_map, stream_bucket,
                     tenant_bucket)
from ..streaming.delta import metric_delta

log = logging.getLogger("dbx.serve")

_DEFAULT_RESULT_CACHE_MB = 64
_DEFAULT_SUB_QUEUE_MAX = 256


def result_cache_max_bytes() -> int:
    """Result-cache budget, read lazily (import-time env capture would
    pin the knob before tests/operators can set it)."""
    return int(float(os.environ.get("DBX_RESULT_CACHE_MB",
                                    _DEFAULT_RESULT_CACHE_MB)) * 1024 * 1024)


def sub_queue_max() -> int:
    """Per-subscriber push-queue bound (items, not bytes: each item is
    one small DBXM block + metadata; the bound exists to cap a slow
    consumer's memory and staleness, not its byte rate)."""
    return int(os.environ.get("DBX_SUB_QUEUE_MAX", _DEFAULT_SUB_QUEUE_MAX))


def stream_key(strategy: str, grid, cost: float, ppy: int) -> str:
    """Content key of a stream's parameter block.

    EXACT mirror of ``streaming.recurrent.stream_key`` — the digest
    that, together with the panel digest, addresses a worker carry
    checkpoint — duplicated here so the dispatcher's subscription path
    never imports the carry machinery just to hash a grid
    (the ``STREAMABLE_STRATEGIES`` literal-set precedent; pinned
    against the real implementation in tests/test_serve.py).
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(strategy.encode())
    for name in sorted(grid):
        h.update(name.encode())
        h.update(np.ascontiguousarray(np.asarray(grid[name],
                                                 np.float32)).tobytes())
    h.update(np.float32(cost).tobytes())
    h.update(str(int(ppy)).encode())
    return h.hexdigest()


@dataclasses.dataclass
class StreamSpec:
    """One stream's identity: the sweep a tick must advance."""

    strategy: str
    grid: dict                      # axis name -> float32 array
    cost: float = 0.0
    ppy: int = 252
    tenant: str = DEFAULT_TENANT    # tenant charged for the advance job
    digest: str = ""                # chain link the subscriber named

    @property
    def key(self) -> str:
        return stream_key(self.strategy, self.grid, self.cost, self.ppy)


@dataclasses.dataclass
class PushItem:
    """One queued push (the wire PushUpdate, pre-serialization)."""

    digest: str
    key: str
    seq: int
    metrics: bytes
    new_len: int
    tick_unix: float
    changed: int
    dropped: int
    catch_up: bool = False


@dataclasses.dataclass
class _TickPlan:
    """What one chain tick must do (returned by :meth:`
    SubscriptionHub.on_tick` under no lock): the advances to enqueue —
    one per unique live stream whose spec the tick's own job template
    does not already cover — plus whether the template's stream itself
    has subscribers (its job id should then be registered for fan-out
    too)."""

    chain: str
    advances: list
    template_live: bool


@dataclasses.dataclass
class _Advance:
    """An in-flight advance job's fan-out address."""

    chain: str
    key: str
    digest: str
    new_len: int
    tick_unix: float


class ResultCache:
    """Byte-bounded LRU of ``(panel_digest, stream_key) -> DBXM block``.

    The serving tier's memo: a new subscriber catches up from here
    without any compute, and the push path diffs against the previous
    entry. Invalidated by chain extension — when a stream's result for
    the extended digest lands, its superseded entry is dropped (entries
    are digest-keyed and immutable, so "invalidation" is the head
    moving, not a mutate-in-place). Eviction is never an error: the
    next tick repopulates, and a catch-up miss merely means the client
    waits one tick.
    """

    def __init__(self, max_bytes: int | None = None,
                 registry: "obs.Registry | None" = None):
        self.max_bytes = (result_cache_max_bytes() if max_bytes is None
                          else int(max_bytes))
        self._lock = threading.Lock()
        self._lru = ByteLRU(self.max_bytes)
        reg = registry or obs.get_registry()
        self._c_hits = reg.counter(
            "dbx_result_cache_hits_total",
            help="result-cache hits (catch-up pushes + delta diffs)")
        self._c_misses = reg.counter(
            "dbx_result_cache_misses_total",
            help="result-cache misses (evicted or never computed)")
        self._g_bytes = reg.gauge(
            "dbx_result_cache_bytes",
            help="bytes resident in the push result cache")

    def get(self, key) -> bytes | None:
        with self._lock:
            blob = self._lru.get(key)
        if blob is None:
            self._c_misses.inc()
        else:
            self._c_hits.inc()
        return blob

    def put(self, key, blob: bytes, *, drop=None) -> None:
        """Store ``key``; ``drop`` (the superseded chain link's key, if
        any) is removed under the same acquisition so the cache never
        holds two generations of one stream."""
        with self._lock:
            if drop is not None:
                self._lru.pop(drop)
            self._lru.put(key, blob)
            self._g_bytes.set(self._lru.bytes)

    def pop(self, key) -> None:
        with self._lock:
            self._lru.pop(key)
            self._g_bytes.set(self._lru.bytes)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self._lru.bytes,
                    "max_bytes": self.max_bytes}


class Subscription:
    """One Subscribe connection: a bounded push queue + wake-up event.

    The queue is the degradation ladder's middle rung: a slow consumer
    fills it, after which the OLDEST item is dropped and counted — a
    live client wants the freshest result, and the tick path must never
    block on (or allocate unboundedly for) a stalled socket. ``pull``
    waits on the event OUTSIDE the mutex (no wait-under-lock), drains
    everything queued, and returns; the gRPC handler turns each item
    into a PushUpdate.
    """

    def __init__(self, subscriber_id: str, tenant: str, *,
                 queue_max: int | None = None):
        self.subscriber_id = subscriber_id
        self.tenant = tenant
        self.demoted = False
        self.queue_max = sub_queue_max() if queue_max is None \
            else int(queue_max)
        self.dropped = 0          # cumulative, rides every PushUpdate
        self.closed = False
        # Interests this connection was charged for against
        # DBX_TENANT_SUB_QUOTA (may exceed len(streams) when interests
        # duplicate); unsubscribe releases exactly this charge.
        self.n_interests = 0
        self._seq = 0
        self._mutex = threading.Lock()
        self._ready = threading.Event()
        self._items: collections.deque = collections.deque()
        # (chain, key) memberships, maintained by the hub UNDER ITS lock
        # (the hub owns registry state; this is just the reverse index
        # unsubscribe walks).
        self.streams: set = set()

    def push(self, item: PushItem) -> bool:
        """Queue one push; returns False when it displaced an older item
        (bounded-queue overflow) or the subscription is closed."""
        ok = True
        with self._mutex:
            if self.closed:
                return False
            if len(self._items) >= self.queue_max:
                self._items.popleft()
                self.dropped += 1
                ok = False
            self._seq += 1
            item = dataclasses.replace(item, seq=self._seq,
                                       dropped=self.dropped)
            self._items.append(item)
        # Set AFTER the mutex releases: the waiter re-takes the mutex to
        # drain, and the event itself is stdlib-internal (lockdep passes
        # it through raw).
        self._ready.set()
        return ok

    def pull(self, timeout: float = 0.25) -> list[PushItem]:
        """Drain queued pushes, waiting up to ``timeout`` for the first.
        Returns [] on timeout or close (the caller re-checks liveness).
        The event clears BEFORE the drain (same mutex hold): a push
        racing the drain must itself take the mutex to append, so its
        set() lands after our clear and the next pull wakes immediately
        — clearing after the drain would park that item for a full
        timeout."""
        self._ready.wait(timeout)
        with self._mutex:
            self._ready.clear()
            items = list(self._items)
            self._items.clear()
        return items

    def close(self) -> None:
        with self._mutex:
            self.closed = True
            self._items.clear()
        self._ready.set()


class SubscriptionHub:
    """The dispatcher's subscription registry + fan-out engine.

    Maps ``(chain, stream_key)`` to its subscriber set; chains are
    identified by the FIRST digest the hub saw for them (a subscribe or
    the parent of a tick) and follow ``AppendBars`` extensions. The hub
    never touches the job queue — the dispatcher asks it what a tick
    implies (:meth:`on_tick`), enqueues the advance jobs itself, tells
    the hub their ids (:meth:`register_advance`, BEFORE the enqueue so
    a completion can never outrun its registration), and reports
    completions (:meth:`on_result`).
    """

    #: Chain links kept addressable per chain (a subscriber naming any
    #: recent link — e.g. the head it learned before a tick raced it —
    #: still lands on the chain; older links age out of the alias map).
    CHAIN_ALIAS_KEEP = 8

    #: In-flight advance index bound. Entries normally pop at completion
    #: (every append-job rung COMPLETES, never fails — the ladder),
    #: but a job failed at materialization (corrupted chain) never
    #: completes and would pin its entry forever; past the bound the
    #: OLDEST entry drops — that push is lost (counted), the stream's
    #: next tick serves fresh.
    MAX_INFLIGHT_ADVANCES = 1 << 16

    def __init__(self, *, registry: "obs.Registry | None" = None,
                 streamable: frozenset | None = None,
                 queue_max: int | None = None,
                 cache_bytes: int | None = None):
        self._lock = threading.Lock()
        self.obs = registry or obs.get_registry()
        self.streamable = streamable
        self._queue_max = queue_max
        # digest -> chain id (the chain's first-seen digest).
        self._chain_of: dict[str, str] = {}
        # chain id -> (head digest, head bars).
        self._heads: dict[str, tuple[str, int]] = {}
        # chain id -> recent link digests (alias-map aging, oldest first).
        self._links: dict[str, collections.deque] = {}
        # (chain, stream_key) -> stream state.
        self._streams: dict[tuple, "_Stream"] = {}
        # live Subscription objects (identity set; sized gauge source).
        self._subs: set = set()
        self._tenant_subs: collections.Counter = collections.Counter()
        # advance job id -> fan-out address (insertion-ordered: the
        # MAX_INFLIGHT_ADVANCES overflow drops oldest-first).
        self._advances: collections.OrderedDict = collections.OrderedDict()
        # (digest, stream_key) advances already enqueued (a duplicate
        # tick of the same delta must not double-advance one stream).
        self._inflight: set = set()
        self.cache = ResultCache(cache_bytes, registry=self.obs)
        self._quotas = parse_tenant_map(
            os.environ.get("DBX_TENANT_SUB_QUOTA", ""))
        self._c_ticks = self.obs.counter(
            "dbx_sub_ticks_total",
            help="AppendBars ticks that touched a subscribed chain")
        self._c_advances = self.obs.counter(
            "dbx_stream_advances_total",
            help="advance-job completions fanned out (one per unique "
                 "live stream per tick — the O(unique streams) cost)")
        self._c_pushes = {
            o: self.obs.counter(
                "dbx_sub_pushes_total",
                help="pushes by outcome (queued = handed to a "
                     "subscriber queue; dropped = displaced an older "
                     "item past DBX_SUB_QUEUE_MAX or unusable "
                     "completion bytes; catch_up = served from the "
                     "result cache at subscribe time; stale = a raced "
                     "advance completing after a longer chain link "
                     "already fanned out, suppressed)",
                outcome=o)
            for o in ("queued", "dropped", "catch_up", "stale")}
        self._c_demotions = self.obs.counter(
            "dbx_sub_demotions_total",
            help="subscriptions admitted over DBX_TENANT_SUB_QUOTA "
                 "(demoted: fan-out-last, never rejected)")
        self._h_push_latency = self.obs.histogram(
            "dbx_tick_to_push_seconds",
            help="AppendBars tick -> push handed to the subscriber "
                 "stream (dispatcher-side delivery wall)")
        self.obs.gauge_fn("dbx_subscriptions", self._n_subs,
                          help="live Subscribe connections")
        self.obs.gauge_fn("dbx_streams_live", self._n_streams,
                          help="unique live (chain, param-block) streams")

    def _n_subs(self) -> int:
        with self._lock:
            return len(self._subs)

    def _n_streams(self) -> int:
        with self._lock:
            return len(self._streams)

    def _quota(self, tenant: str) -> float:
        return self._quotas.get(tenant,
                                self._quotas.get("*", float("inf")))

    # -- subscribe / unsubscribe ------------------------------------------

    def subscribe(self, subscriber_id: str, tenant: str,
                  interests: list[StreamSpec]) -> Subscription:
        """Register one connection's interests; returns its live
        :class:`Subscription` (already receiving). Unknown digests are
        accepted — the stream activates when its chain first ticks —
        and unsupported strategies raise ``ValueError`` (the handler
        turns that into INVALID_ARGUMENT). Catch-up: interests whose
        stream already has a cached head result receive it immediately
        (seq 1, ``catch_up`` flag) so a reconnecting dashboard renders
        without waiting a tick."""
        tenant = tenant or DEFAULT_TENANT
        if self.streamable is not None:
            for spec in interests:
                if spec.strategy not in self.streamable:
                    raise ValueError(
                        f"strategy {spec.strategy!r} is not streamable "
                        "(no carry form; pairs cannot ride a one-panel "
                        "chain)")
        sub = Subscription(subscriber_id, tenant,
                           queue_max=self._queue_max)
        catch_up: list[tuple] = []   # (digest, key, n_bars)
        with self._lock:
            # Quota check counts INTERESTS (a connection carrying 500
            # interests is 500 subscriptions), demotes the whole
            # connection, never rejects: demoted subscriptions are
            # fanned out last and their drops bite first under
            # pressure, but they stay live — the
            # demotion-not-blocking semantics.
            n_before = self._tenant_subs[tenant]
            if n_before + len(interests) > self._quota(tenant):
                sub.demoted = True
            sub.n_interests = len(interests)
            self._tenant_subs[tenant] += sub.n_interests
            self._subs.add(sub)
            for spec in interests:
                chain = self._chain_of.get(spec.digest, spec.digest)
                self._register_link(chain, spec.digest)
                self._heads.setdefault(chain, (spec.digest, 0))
                skey = (chain, spec.key)
                stream = self._streams.get(skey)
                if stream is None:
                    stream = self._streams[skey] = _Stream(
                        spec=spec, chain=chain)
                stream.members[id(sub)] = sub
                sub.streams.add(skey)
                if stream.last_digest:
                    catch_up.append((stream.last_digest, spec.key,
                                     stream.last_len))
        if sub.demoted:
            self._c_demotions.inc()
        # Cache reads + pushes OUTSIDE the registry lock.
        for digest, key, n_bars in catch_up:
            blob = self.cache.get((digest, key))
            if blob is None:
                continue
            sub.push(PushItem(digest=digest, key=key, seq=0,
                              metrics=blob, new_len=n_bars, tick_unix=0.0,
                              changed=-1, dropped=0, catch_up=True))
            self._c_pushes["catch_up"].inc()
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        """Drop a connection: remove it from every stream, prune
        streams with no members left, and age the chain bookkeeping out
        once its last stream goes (wire-controlled input must not
        accumulate — the WfqScheduler pruning discipline)."""
        with self._lock:
            if sub not in self._subs:
                return
            self._subs.discard(sub)
            self._tenant_subs[sub.tenant] -= sub.n_interests
            if self._tenant_subs[sub.tenant] <= 0:
                del self._tenant_subs[sub.tenant]
            for skey in sub.streams:
                stream = self._streams.get(skey)
                if stream is None:
                    continue
                stream.members.pop(id(sub), None)
                if not stream.members:
                    del self._streams[skey]
            live_chains = {c for c, _ in self._streams}
            for chain in list(self._heads):
                if chain not in live_chains:
                    self._drop_chain(chain)
        sub.close()

    def close(self) -> None:
        """Close every subscription (dispatcher shutdown): their pull
        loops wake and exit, the registry empties."""
        with self._lock:
            subs = list(self._subs)
            self._subs.clear()
            self._streams.clear()
            self._tenant_subs.clear()
            for chain in list(self._heads):
                self._drop_chain(chain)
            self._advances.clear()
            self._inflight.clear()
        for sub in subs:
            sub.close()

    def _drop_chain(self, chain: str) -> None:
        """Caller holds ``self._lock``."""
        self._heads.pop(chain, None)
        for d in self._links.pop(chain, ()):
            self._chain_of.pop(d, None)

    def _register_link(self, chain: str, digest: str) -> None:
        """Caller holds ``self._lock``: digest joins the chain's alias
        map, aging the oldest link out past CHAIN_ALIAS_KEEP."""
        if self._chain_of.get(digest) == chain:
            return
        self._chain_of[digest] = chain
        links = self._links.setdefault(chain, collections.deque())
        links.append(digest)
        while len(links) > self.CHAIN_ALIAS_KEEP:
            old = links.popleft()
            if old != chain:      # the chain id itself stays addressable
                self._chain_of.pop(old, None)
            else:
                links.append(old)  # rotate: keep id, age the next-oldest
                if len(links) <= self.CHAIN_ALIAS_KEEP:
                    break

    # -- the tick path -----------------------------------------------------

    def on_tick(self, parent_digest: str, new_digest: str, new_len: int,
                *, template_key: str | None = None) -> _TickPlan | None:
        """An AppendBars tick extended ``parent -> new``. Returns the
        tick's plan — the unique live streams needing an advance job
        (minus the one the tick's own job template covers, minus any
        already in flight for this digest) — or None when the chain has
        no subscribers (the overwhelming non-serving case: one dict
        probe under the lock)."""
        with self._lock:
            chain = self._chain_of.get(parent_digest)
            if chain is None:
                return None
            self._register_link(chain, new_digest)
            self._heads[chain] = (new_digest, int(new_len))
            advances = []
            template_live = False
            for (c, key), stream in self._streams.items():
                if c != chain:
                    continue
                if template_key is not None and key == template_key:
                    template_live = True
                    continue
                if (new_digest, key) in self._inflight:
                    continue
                self._inflight.add((new_digest, key))
                advances.append(stream.spec)
        self._c_ticks.inc()
        return _TickPlan(chain=chain, advances=advances,
                         template_live=template_live)

    def register_advance(self, job_id: str, chain: str, key: str,
                         digest: str, new_len: int,
                         tick_unix: float) -> None:
        """Index an advance job for fan-out. MUST run before the job is
        enqueued: a worker can take and complete a job the instant it is
        published, and an unregistered completion would drop the push on
        the floor."""
        dropped = 0
        with self._lock:
            self._advances[job_id] = _Advance(
                chain=chain, key=key, digest=digest, new_len=int(new_len),
                tick_unix=tick_unix)
            self._inflight.add((digest, key))
            while len(self._advances) > self.MAX_INFLIGHT_ADVANCES:
                _, old = self._advances.popitem(last=False)
                self._inflight.discard((old.digest, old.key))
                dropped += 1
        if dropped:
            self._c_pushes["dropped"].inc(dropped)

    def has_advances(self) -> bool:
        """Lock-free fast-path probe for the completion hot path: a
        dispatcher serving zero subscriptions pays one attribute read
        per completion batch, not a lock acquisition per item. (A racy
        False is impossible for a registered job: registration happens
        before enqueue, so the dict is non-empty by the time any
        completion for it can arrive.)"""
        return bool(self._advances)

    def on_result(self, job_id: str, metrics: bytes,
                  trace_id: str = "") -> int:
        """An advance job completed: cache its block, diff against the
        stream's previous result, and fan out to every subscriber.
        Returns the number of pushes queued (0 for non-advance jobs).

        Fan-out never blocks: each subscriber queue is bounded with
        drop-oldest-and-count, and nothing here runs under the registry
        lock. Demoted (over-quota) subscriptions are fanned out LAST —
        under equal queue pressure their staleness grows first.

        Ordering: chain lengths strictly grow, so ``new_len`` totally
        orders a stream's advances. A completion arriving AFTER a
        longer chain link already fanned out (two quick ticks, the
        advances raced on different workers) is STALE — suppressed and
        counted, never pushed: delivering it would regress every
        subscriber's view (seq grows while the panel shrinks) and
        caching it would evict the newer block new subscribers catch up
        from."""
        t0 = time.time()
        with self._lock:
            adv = self._advances.pop(job_id, None)
            if adv is None:
                return 0
            self._inflight.discard((adv.digest, adv.key))
            stream = self._streams.get((adv.chain, adv.key))
            if stream is None:      # everyone unsubscribed mid-flight
                return 0
            if adv.new_len <= stream.last_len:
                stale = True
            else:
                stale = False
                prev_digest = stream.last_digest
                stream.last_digest = adv.digest
                stream.last_len = adv.new_len
                members = sorted(stream.members.values(),
                                 key=lambda s: s.demoted)
        if stale:
            self._c_pushes["stale"].inc()
            return 0
        try:
            prev = (self.cache.get((prev_digest, adv.key))
                    if prev_digest and prev_digest != adv.digest else None)
            changed, _total = metric_delta(prev, metrics)
        except ValueError as e:
            # Worker-supplied bytes that do not parse as a DBXM block:
            # nothing a subscriber could use, and an exception here
            # would fail the whole CompleteJobs batch. The completion
            # itself stays recorded (the queue's concern); the push is
            # dropped loudly.
            log.warning("advance %s: completion bytes not a DBXM block "
                        "(%s); push dropped", job_id, e)
            self._c_pushes["dropped"].inc()
            return 0
        self.cache.put((adv.digest, adv.key), metrics,
                       drop=((prev_digest, adv.key)
                             if prev_digest and prev_digest != adv.digest
                             else None))
        self._c_advances.inc()
        item = PushItem(digest=adv.digest, key=adv.key, seq=0,
                        metrics=metrics, new_len=adv.new_len,
                        tick_unix=adv.tick_unix, changed=changed,
                        dropped=0)
        queued = dropped = 0
        for sub in members:
            if sub.push(item):
                queued += 1
            else:
                dropped += 1
        self._c_pushes["queued"].inc(queued)
        if dropped:
            self._c_pushes["dropped"].inc(dropped)
        if trace_id:
            # The dispatcher-side `push` timeline stage: completion
            # recorded -> fanned onto every subscriber queue. Emitted
            # before the caller closes the job's e2e span so the window
            # lands inside the attribution.
            obs.emit_span("job.push", t0, time.time() - t0,
                          trace_id=trace_id, job=job_id, n_subs=queued,
                          dropped=dropped,
                          stream=stream_bucket(adv.key))
        return queued

    def observe_delivery(self, item: PushItem) -> None:
        """Tick-to-push latency at the moment a push is handed to the
        subscriber's stream (the Subscribe generator calls this per
        yielded item; catch-up pushes carry no tick to measure from)."""
        if item.tick_unix:
            self._h_push_latency.observe(
                max(time.time() - item.tick_unix, 0.0))

    def stats(self) -> dict:
        """Registry snapshot (tests + /stats.json consumers)."""
        with self._lock:
            return {
                "subscriptions": len(self._subs),
                "interests": int(sum(self._tenant_subs.values())),
                "streams": len(self._streams),
                "chains": len(self._heads),
                "advances_inflight": len(self._advances),
                "tenants": {tenant_bucket(t): int(n)
                            for t, n in self._tenant_subs.items()},
            }


@dataclasses.dataclass
class _Stream:
    """One unique (chain, param-block) stream's registry state."""

    spec: StreamSpec
    chain: str
    members: dict = dataclasses.field(default_factory=dict)
    last_digest: str = ""    # newest chain link with a fanned-out result
    last_len: int = 0
