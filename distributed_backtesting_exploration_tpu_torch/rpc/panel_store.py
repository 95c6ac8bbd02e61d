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

The reference module's ``PanelStore`` is the dispatcher's store of DBX1
bytes; the port has no dispatcher, so it has no copy of it.
"""

from __future__ import annotations

import collections
import hashlib


def panel_digest(data: bytes) -> str:
    """blake2b-128 hex digest of a panel's wire bytes: the content address
    carried by ``JobSpec.panel_digest`` and every cache key."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


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

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)
