"""Device page pool of OHLCV fields (reference ``rpc/page_pool.py``).

The panel cache's device level holds a whole ``(5, T)`` block a digest, so
an append-extended panel duplicates its base's history and overlapping
histories share nothing. The page pool stores field data as fixed-size
pages of ``DBX_PAGE_BARS`` bars (default 512) in one ``(slots, page_bars)``
f32 tensor on the device, and describes a sweep group by a slot table a
field. A page is keyed by the blake2b-64 hash of its bytes, the last,
partial page repeat-last padded (:func:`paginate`), so:

- an append-extended panel reuses every full page of its base: only the
  boundary page and the new ones upload, at most ⌈ΔT / page_bars⌉ + 1;
- two digests with overlapping histories share every aligned page.

A ``(digest, field)`` memo keeps each panel's key list, so a warm panel is
not hashed again. Slots are reused in LRU order; the tensor grows
geometrically up to ``DBX_PAGE_POOL_MB`` (default 64). A group whose pages
cannot all be resident at once is rejected (:meth:`PagePool.prepare`
returns None) and the caller falls back to the dense stacks. All of a
group's missing pages upload in one pinned copy and one ``index_copy_``.

Unlike the reference's functional array, the pool is written in place.
:attr:`PagePool.lock` (re-entrant) serializes the writers, the compute
thread's submit and the prefetch thread's warm-up, and a caller that
gathers from the pool holds it from :meth:`~PagePool.prepare` until its
gathers are enqueued: a later writer's eviction and upload then queue
behind those gathers on the same stream. A pool that grows is a new
tensor; ``prepare`` returns the newest.

Hits and misses by field, rejects and the pad bars of new pages are plain
attributes that :meth:`PagePool.stats` returns, the pool's own. The same
events count into the registry (the process's by default) under the
reference's names: ``dbx_page_pool_hits_total`` and
``dbx_page_pool_misses_total{field}``, ``dbx_page_pool_rejects_total``,
and the gauges ``dbx_page_pool_bytes`` and ``dbx_page_pool_pages``.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading

import numpy as np
import torch

from .. import device as device_mod
from .. import obs
from ..ops.fused import resolve_page_bars
from ..utils import data as data_mod

_DEFAULT_POOL_MB = 64
_MIN_SLOTS = 8              # the smallest pool (growth floor)
_PANEL_MEMO_CAP = 16384     # (digest, field) -> page-key lists kept


def pool_max_bytes() -> int:
    """The pool's byte bound, ``DBX_PAGE_POOL_MB`` (default 64), read when
    a pool is made."""
    return int(float(os.environ.get("DBX_PAGE_POOL_MB",
                                    _DEFAULT_POOL_MB)) * 1024 * 1024)


def page_key(page_bytes: bytes) -> str:
    """blake2b-64 hex of a page's padded bytes: the pool's content
    address."""
    return hashlib.blake2b(page_bytes, digest_size=8).hexdigest()


def paginate(values: np.ndarray, page_bars: int) -> list[np.ndarray]:
    """A 1-D f32 series split into ``page_bars``-bar pages, the last one
    repeat-last padded to full width (canonical content: two panels with a
    common full-page prefix hash alike)."""
    v = np.ascontiguousarray(np.asarray(values, np.float32))
    out = []
    for s in range(0, v.shape[0], page_bars):
        page = v[s:s + page_bars]
        if page.shape[0] < page_bars:
            page = np.concatenate(
                [page, np.full(page_bars - page.shape[0], page[-1],
                               np.float32)])
        out.append(page)
    return out


class PagePool:
    """Byte-bounded device pool of fixed-size f32 pages and its host
    index."""

    def __init__(self, *, device: str | torch.device =
                 device_mod.DEFAULT_DEVICE, page_bars: int | None = None,
                 max_bytes: int | None = None,
                 registry: obs.Registry | None = None):
        self.device = device_mod.resolve(device)
        self.page_bars = int(page_bars if page_bars is not None
                             else resolve_page_bars())
        self.max_bytes = (pool_max_bytes() if max_bytes is None
                          else int(max_bytes))
        self.capacity = max(1, self.max_bytes // (self.page_bars * 4))
        # Writers (prepare and the caller's gathers) hold `lock`; `_lock`
        # guards the host index for stats(). Order: lock, then _lock.
        self.lock = threading.RLock()
        self._lock = threading.Lock()
        self._pool: torch.Tensor | None = None   # (alloc, page_bars) f32
        self._alloc = 0
        self._slots: collections.OrderedDict = collections.OrderedDict()
        #   page key -> slot, least recently used first
        self._free: list[int] = []
        self._panel_memo: collections.OrderedDict = collections.OrderedDict()
        #   (digest, field) -> (n_bars, [page key])
        self.hits = {f: 0 for f in data_mod._FIELDS}
        self.misses = {f: 0 for f in data_mod._FIELDS}
        self.rejects = 0
        self.pad_bars_new = 0
        reg = registry or obs.get_registry()
        # Made for every OHLCV field up front, so that /metrics shows them
        # from the first scrape.
        help_ = ("page-pool page lookups by OHLCV field (hit = page already "
                 "device-resident)")
        self._c_hits = {f: reg.counter("dbx_page_pool_hits_total",
                                       help=help_, field=f)
                        for f in data_mod._FIELDS}
        self._c_misses = {f: reg.counter("dbx_page_pool_misses_total",
                                         help=help_, field=f)
                          for f in data_mod._FIELDS}
        self._c_rejects = reg.counter(
            "dbx_page_pool_rejects_total",
            help="groups the page pool could not hold (caller fell back "
                 "to the dense path)")
        self._g_bytes = reg.gauge(
            "dbx_page_pool_bytes",
            help="bytes of live pages in the device page pool")
        self._g_pages = reg.gauge(
            "dbx_page_pool_pages", help="live pages in the device page pool")

    def _keys_for(self, digest: str, field: str, values) -> list[str]:
        """Page keys of one panel's field, memoized per ``(digest,
        field)``; a digestless panel is hashed every time."""
        memo_key = (digest, field) if digest else None
        if memo_key is not None:
            keys = self._panel_memo.get(memo_key)
            if keys is not None and keys[0] == len(values):
                self._panel_memo.move_to_end(memo_key)
                return keys[1]
        keys = [page_key(p.tobytes()) for p in paginate(values,
                                                        self.page_bars)]
        if memo_key is not None:
            self._panel_memo[memo_key] = (len(values), keys)
            while len(self._panel_memo) > _PANEL_MEMO_CAP:
                self._panel_memo.popitem(last=False)
        return keys

    def _ensure_alloc(self, n_slots: int) -> None:
        """Grow the tensor geometrically up to ``capacity`` (a new tensor,
        the live pages copied in)."""
        if n_slots <= self._alloc:
            return
        new_alloc = max(_MIN_SLOTS, self._alloc or _MIN_SLOTS)
        while new_alloc < n_slots:
            new_alloc *= 2
        new_alloc = min(new_alloc, self.capacity)
        new = torch.zeros((new_alloc, self.page_bars), dtype=torch.float32,
                          device=self.device)
        if self._pool is not None and self._alloc:
            new[:self._alloc] = self._pool
        self._free.extend(range(self._alloc, new_alloc))
        self._pool = new
        self._alloc = new_alloc

    def _take_slot(self, pinned: set) -> int | None:
        """A free slot, from growth or by evicting the least recently used
        page not in ``pinned``; None when every live page is pinned."""
        if not self._free and self._alloc < self.capacity:
            self._ensure_alloc(self._alloc + 1)
        if self._free:
            return self._free.pop()
        victim = next((k for k in self._slots if k not in pinned), None)
        if victim is None:
            return None
        return self._slots.pop(victim)

    def prepare(self, digests, series_list, fields):
        """Resolve a group against the pool: ``digests`` and
        ``series_list`` are the jobs' panel digests and decoded panels,
        ``fields`` the OHLCV fields the kernel consumes.

        Returns ``(pool, tables, info)``: the newest pool tensor,
        ``tables[field]`` an ``(n, max_pages)`` int32 slot table (a short
        row padded with its own last slot) and ``info`` the count of pages
        uploaded (``pages_new``) and their pad bars (``pad_bars_new``); or
        None when the group's pages cannot all be resident at once."""
        with self.lock:
            with self._lock:
                plan = self._plan(digests, series_list, fields)
                if plan is None:
                    self.rejects += 1
                    self._c_rejects.inc()
                    return None
                tables, new_slots, new_pages, pad_new = plan
                self.pad_bars_new += pad_new
                self._g_pages.set(len(self._slots))
                self._g_bytes.set(len(self._slots) * self.page_bars * 4)
                if self._pool is None:
                    self._ensure_alloc(_MIN_SLOTS)
                pool = self._pool
            if new_slots:
                # The upload runs outside the index lock: stats() never
                # waits on the device.
                pool.index_copy_(
                    0, device_mod.upload(np.asarray(new_slots, np.int64),
                                         self.device),
                    device_mod.upload(np.stack(new_pages), self.device))
            return pool, tables, {"pages_new": len(new_slots),
                                  "pad_bars_new": int(pad_new)}

    def _plan(self, digests, series_list, fields):
        """The index half of :meth:`prepare` (``_lock`` held): keys, hits
        and misses, slots for the misses; None to reject."""
        per_field: dict[str, list[list[str]]] = {f: [] for f in fields}
        needed: collections.OrderedDict = collections.OrderedDict()
        #   key -> (values, page index), the first panel that has it
        hits = {f: 0 for f in fields}
        miss = {f: 0 for f in fields}
        for d, s in zip(digests, series_list):
            for f in fields:
                values = np.asarray(getattr(s, f), np.float32)
                keys = self._keys_for(d, f, values)
                per_field[f].append(keys)
                for pi, key in enumerate(keys):
                    if key not in needed:
                        if key in self._slots:
                            hits[f] += 1
                        else:
                            miss[f] += 1
                        needed[key] = (values, pi)
        if len(needed) > self.capacity:
            return None
        pinned = set(needed)
        new_slots, new_keys, new_pages = [], [], []
        pad_new = 0
        B = self.page_bars
        for key, (values, pi) in needed.items():
            if key in self._slots:
                self._slots.move_to_end(key)
                continue
            slot = self._take_slot(pinned)
            if slot is None:       # not after the capacity check; unwind
                for k in new_keys:
                    self._free.append(self._slots.pop(k))
                return None
            lo = pi * B
            new_pages.append(paginate(values[lo:lo + B], B)[0])
            pad_new += B - min(B, len(values) - lo)
            self._slots[key] = slot
            new_slots.append(slot)
            new_keys.append(key)
        for f in fields:
            self.hits[f] += hits[f]
            self.misses[f] += miss[f]
            if hits[f]:
                self._c_hits[f].inc(hits[f])
            if miss[f]:
                self._c_misses[f].inc(miss[f])
        max_pages = max((len(k) for ks in per_field.values() for k in ks),
                        default=1)
        tables = {}
        for f in fields:
            tbl = np.zeros((len(series_list), max_pages), np.int32)
            for i, keys in enumerate(per_field[f]):
                row = [self._slots[k] for k in keys]
                tbl[i, :len(row)] = row
                tbl[i, len(row):] = row[-1]
            tables[f] = tbl
        return tables, new_slots, new_pages, pad_new

    def stats(self) -> dict:
        with self._lock:
            return {"pages": len(self._slots),
                    "bytes": len(self._slots) * self.page_bars * 4,
                    "page_bars": self.page_bars,
                    "alloc_slots": self._alloc,
                    "capacity_slots": self.capacity,
                    "max_bytes": self.max_bytes,
                    "hits": dict(self.hits), "misses": dict(self.misses),
                    "rejects": self.rejects,
                    "pad_bars_new": self.pad_bars_new}
