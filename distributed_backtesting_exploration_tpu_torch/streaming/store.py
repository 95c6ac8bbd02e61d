"""Digest-keyed carry-checkpoint store (the reference's
``streaming/store.py``; the streaming twin of ``rpc.compute.PanelCache``).

Two levels, each a ``rpc.panel_store.ByteLRU`` bounded by
``DBX_CARRY_CACHE_MB`` (default 64, read when a store is made):

- **device level**: the live :class:`~.recurrent.StreamCarry`, its tensors
  on the store's device; a hit advances in O(ΔT) with no host work;
- **host level**: the serialized checkpoint
  (:func:`~.recurrent.carry_to_bytes`), which outlives a device-level
  eviction; a hit deserializes onto the device and re-primes the device
  level. Restoring is lossless: an append after an eviction and restore
  gives the bits of an append to the carry never evicted.

Keys are ``(panel_digest, stream_key)``: the panel state the carry
summarizes and its parameter block (:func:`~.recurrent.stream_key`), so a
checkpoint never serves another grid, cost or strategy. An eviction is not
an error: the worker reprices in full and checkpoints again. Hits and
misses by level are plain attributes that :meth:`CarryStore.stats`
returns, the store's own; the same events count into the registry (the
process's by default) as the reference's ``dbx_carry_cache_hits_total``
and ``dbx_carry_cache_misses_total{level}``, with both levels' bytes in
the gauge ``dbx_carry_cache_bytes``. Thread-safe.
"""

from __future__ import annotations

import os
import threading

import torch

from .. import device as device_mod
from .. import obs
from ..rpc.panel_store import ByteLRU
from . import recurrent

_DEFAULT_CARRY_MB = 64


def carry_cache_max_bytes() -> int:
    """The store's budget per level in bytes, ``DBX_CARRY_CACHE_MB``
    (default 64), read when a store is made, not at import."""
    return int(float(os.environ.get("DBX_CARRY_CACHE_MB",
                                    _DEFAULT_CARRY_MB)) * 1024 * 1024)


class CarryStore:
    """Two-level LRU of ``(panel_digest, stream_key) -> StreamCarry`` on
    ``device`` (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, max_bytes: int | None = None, *,
                 device: str | torch.device = device_mod.DEFAULT_DEVICE,
                 registry: obs.Registry | None = None):
        self.max_bytes = (carry_cache_max_bytes() if max_bytes is None
                          else int(max_bytes))
        self.device = device_mod.resolve(device)
        self._lock = threading.Lock()
        self._device = ByteLRU(self.max_bytes)    # put() passes nbytes
        self._host = ByteLRU(self.max_bytes)      # serialized bytes
        self.hits = {"host": 0, "device": 0}
        self.misses = {"host": 0, "device": 0}
        reg = registry or obs.get_registry()
        self._c_hits = {
            lvl: reg.counter("dbx_carry_cache_hits_total",
                             help="carry-checkpoint cache hits by level "
                                  "(device=resident carry, host="
                                  "deserialized checkpoint)", level=lvl)
            for lvl in ("host", "device")}
        self._c_misses = {
            lvl: reg.counter("dbx_carry_cache_misses_total",
                             help="carry-checkpoint cache misses by level",
                             level=lvl)
            for lvl in ("host", "device")}
        self._g_bytes = reg.gauge(
            "dbx_carry_cache_bytes",
            help="approximate bytes resident in the carry cache "
                 "(device + host levels)")

    def _count(self, hit: bool, level: str) -> None:
        """One lookup of ``level`` (``_lock`` held)."""
        (self.hits if hit else self.misses)[level] += 1
        (self._c_hits if hit else self._c_misses)[level].inc()

    def _publish_bytes(self) -> None:
        self._g_bytes.set(self._device.bytes + self._host.bytes)

    def get(self, key) -> "recurrent.StreamCarry | None":
        with self._lock:
            carry = self._device.get(key)
            self._count(carry is not None, "device")
            if carry is not None:
                return carry
            blob = self._host.get(key)
            self._count(blob is not None, "host")
            if blob is None:
                return None
        carry = recurrent.carry_from_bytes(blob, self.device)
        with self._lock:
            if key in self._device:
                # A racer re-primed (or a fresh append re-checkpointed) the
                # key while this thread deserialized: the resident carry is
                # the same or newer, and overwriting it with this older
                # copy would lose its advance.
                return self._device.get(key)
            # Re-prime the device level so the next append skips the
            # deserialize too.
            self._device.put(key, carry, carry.nbytes)
            self._publish_bytes()
        return carry

    def put(self, key, carry: "recurrent.StreamCarry") -> None:
        blob = recurrent.carry_to_bytes(carry)
        with self._lock:
            self._device.put(key, carry, carry.nbytes)
            self._host.put(key, blob)
            self._publish_bytes()

    def evict_device(self, key) -> None:
        """Drop the device copy only (memory pressure, tests); the host
        checkpoint keeps the state restorable."""
        with self._lock:
            self._device.pop(key)
            self._publish_bytes()

    def drop(self, key) -> None:
        """Drop both levels' copies: a checkpoint its stream has moved past
        (the backend drops an append's parent once it has advanced it, so
        a live stream holds one checkpoint, its tip)."""
        with self._lock:
            self._device.pop(key)
            self._host.pop(key)
            self._publish_bytes()

    def stats(self) -> dict:
        with self._lock:
            return {"device_carries": len(self._device),
                    "device_bytes": self._device.bytes,
                    "host_carries": len(self._host),
                    "host_bytes": self._host.bytes,
                    "max_bytes": self.max_bytes,
                    "hits": dict(self.hits), "misses": dict(self.misses)}
