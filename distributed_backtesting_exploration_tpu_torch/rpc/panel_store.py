"""Content-addressed panel blobs (reference ``rpc/panel_store.py``).

A grid sweep ships the same DBX1 panel in every job of the sweep. The
dispatcher therefore content-addresses each panel (``JobSpec.panel_digest``)
and, once a worker has received the bytes, ships later jobs of that panel
digest-only; the worker keeps decoded panels keyed by the same digest
(``compute.PanelCache``).

- :func:`panel_digest` is the digest of the whole feature. It must equal
  the reference's for the same bytes, or the caches of a mixed fleet of
  JAX and PyTorch workers would miss.
- :class:`ByteLRU` is the byte-bounded LRU map of both levels of the
  worker's panel cache and of its carry store
  (``streaming.store.CarryStore``).

- :class:`PanelStore` is the dispatcher's bounded LRU store of DBX1
  bytes keyed by that digest (``DBX_PANEL_STORE_MB``, default 256): hot
  panels and requeued jobs are materialized once, and ``FetchPayload``
  serves cache-missing workers straight from it. An evicted digest is not
  an error: the job record still knows its source, and a worker fetching
  an unservable digest gets an empty reply.

Thread-safe where the dispatcher needs it: :class:`PanelStore` takes its
own lock (takes run on the gRPC pool, ``FetchPayload`` on another thread).
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading

from .. import obs

_DEFAULT_STORE_MB = 256


def panel_digest(data: bytes) -> str:
    """blake2b-128 hex digest of a panel's wire bytes: the content address
    carried by ``JobSpec.panel_digest`` and every cache key."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def store_max_bytes() -> int:
    """The store bound, read lazily (import-time env capture would pin
    the knob before tests/operators can set it)."""
    return int(float(os.environ.get("DBX_PANEL_STORE_MB",
                                    _DEFAULT_STORE_MB)) * 1024 * 1024)


class ByteLRU:
    """Byte-bounded LRU map of ``digest -> value``.

    Not thread-safe: every owner wraps its calls in its own lock.
    ``nbytes_of`` prices a value once at insert; ``put`` can pass
    ``nbytes`` instead, for values whose size the caller knows more
    cheaply. An entry larger than the whole bound is inserted and then
    evicted at once: the insert is valid, the map just does not keep it.
    """

    def __init__(self, max_bytes: int, nbytes_of=len):
        self.max_bytes = int(max_bytes)
        self._nbytes_of = nbytes_of
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.bytes = 0
        self.evictions = 0

    def get(self, key):
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        return entry[0]

    def put(self, key, value, nbytes: int | None = None) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old[1]
        nb = int(self._nbytes_of(value) if nbytes is None else nbytes)
        self._entries[key] = (value, nb)
        self.bytes += nb
        while self.bytes > self.max_bytes and self._entries:
            _, (_, ev_nb) = self._entries.popitem(last=False)
            self.bytes -= ev_nb
            self.evictions += 1

    def pop(self, key) -> None:
        """Drop one entry (no error if absent); the byte count follows."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.bytes -= entry[1]

    def sizes(self) -> list[tuple]:
        """``[(key, nbytes), ...]`` in LRU order, values untouched — the
        fleet telemetry sketch's feed (caller holds the owner's lock,
        like every other method here)."""
        return [(k, e[1]) for k, e in self._entries.items()]

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)


class PanelStore:
    """Bounded LRU map of ``digest -> DBX1 bytes``.

    ``put`` stores a reference to the caller's (immutable) bytes object —
    no copy; for inline job payloads the "store" therefore costs only the
    index entry while the record already pins the bytes. Accounting still
    charges the blob's full length against the bound: the bound is about
    what the store RETAINS for digest-only dispatch, not process RSS.
    """

    def __init__(self, max_bytes: int | None = None,
                 registry: "obs.Registry | None" = None):
        self._lock = threading.Lock()
        self._lru = ByteLRU(store_max_bytes() if max_bytes is None
                            else int(max_bytes))
        reg = registry or obs.get_registry()
        self._c_hits = reg.counter(
            "dbx_panel_store_hits_total",
            help="panel-store lookups served from memory")
        self._c_misses = reg.counter(
            "dbx_panel_store_misses_total",
            help="panel-store lookups that fell through to the source")

    @property
    def max_bytes(self) -> int:
        return self._lru.max_bytes

    @max_bytes.setter
    def max_bytes(self, v: int) -> None:
        self._lru.max_bytes = int(v)

    @property
    def evictions(self) -> int:
        return self._lru.evictions

    def put(self, data: bytes, digest: str | None = None) -> str:
        """Insert (or refresh) a blob; returns its digest."""
        d = digest or panel_digest(data)
        with self._lock:
            self._lru.put(d, data)
        return d

    def get(self, digest: str) -> bytes | None:
        """The blob for ``digest`` (LRU-touched), or None after eviction."""
        with self._lock:
            blob = self._lru.get(digest)
        if blob is not None:
            self._c_hits.inc()
        else:
            self._c_misses.inc()
        return blob

    def __contains__(self, digest: str) -> bool:
        with self._lock:
            return digest in self._lru

    def stats(self) -> dict:
        with self._lock:
            return {"panels": len(self._lru), "bytes": self._lru.bytes,
                    "evictions": self._lru.evictions,
                    "max_bytes": self._lru.max_bytes}
