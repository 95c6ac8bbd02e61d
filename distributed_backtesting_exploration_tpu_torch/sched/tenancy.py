"""Tenant identity + the bounded tenant-bucket metric label map.

Tenant ids are operator-chosen strings and therefore UNBOUNDED runtime
data from the metric registry's point of view: one gauge child per
distinct tenant, forever, in every ``/metrics`` scrape and every
``obs_json`` payload — exactly what dbxlint's obs-cardinality rule
exists to reject. Per-tenant observability still matters (a starved
tenant must be visible), so the label value goes through ONE process-
wide bounded map: the first ``DBX_TENANT_LABEL_MAX`` distinct tenants
keep their own name as the label, every later tenant shares the
``other`` bucket. The mapping is sticky for the process lifetime (a
tenant never changes buckets mid-run — its time series stays one
series) and the rule recognizes ``tenant_bucket(...)`` as a sanctioned
label source.
"""

from __future__ import annotations

import os
import threading

#: The tenant every legacy client lands in: proto3's default empty
#: ``JobSpec.tenant_id``, journal records without a ``tenant`` key, and
#: CLI runs without ``--tenant`` all map here — single-tenant dispatch
#: order through the WFQ lane is bit-identical to the pre-tenancy FIFO.
DEFAULT_TENANT = "default"

#: Shared label for every tenant past the bucket cap.
OVERFLOW_BUCKET = "other"

_DEFAULT_LABEL_MAX = 16

_BUCKET_LOCK = threading.Lock()
_BUCKETS: dict[str, str] = {}


def _label_max() -> int:
    """Bucket cap, read lazily (import-time capture would pin the knob
    before tests/operators can set it)."""
    return int(os.environ.get("DBX_TENANT_LABEL_MAX", _DEFAULT_LABEL_MAX))

def _sticky_bucket(store: dict, lock: threading.Lock, cap: int,
                   key: str, label: str) -> str:
    """The shared sticky-map core behind both bucket maps: first ``cap``
    distinct keys keep ``label`` (first-contact sticky — a series never
    splits), later ones share :data:`OVERFLOW_BUCKET` with NOTHING
    stored (both maps bound wire-controlled input; one dict entry per
    id ever seen would be an unbounded leak in exactly the components
    built to bound label cardinality). Overflow keys recompute to the
    same answer every call; only a mid-run cap raise could re-home one
    — an explicit operator action."""
    with lock:
        hit = store.get(key)
        if hit is not None:
            return hit
        if len(store) < cap:
            store[key] = label
            return label
    return OVERFLOW_BUCKET


def tenant_bucket(tenant: str) -> str:
    """The bounded metric label for ``tenant``.

    First ``DBX_TENANT_LABEL_MAX`` distinct tenants map to themselves,
    later ones to :data:`OVERFLOW_BUCKET`. This is THE sanctioned way
    to put tenant identity on a metric label (dbxlint obs-cardinality
    treats ``tenant_bucket(...)`` as bounded by construction).
    """
    t = tenant or DEFAULT_TENANT
    return _sticky_bucket(_BUCKETS, _BUCKET_LOCK, _label_max(), t, t)


def reset_tenant_buckets() -> None:
    """Drop all sticky assignments (tests; a fresh process equivalent)."""
    with _BUCKET_LOCK:
        _BUCKETS.clear()
    with _STREAM_BUCKET_LOCK:
        _STREAM_BUCKETS.clear()
    with _WORKER_BUCKET_LOCK:
        _WORKER_BUCKETS.clear()


# -- stream buckets ---------------------------------------------------------
#
# Stream keys (serve.stream_key — blake2b over strategy + grid + cost +
# ppy) are exactly as unbounded as tenant ids: one live fleet serves
# thousands of distinct param blocks, and a per-stream metric label would
# mint a permanent time series each. Same sticky core, own namespace +
# cap: the first DBX_STREAM_LABEL_MAX distinct keys keep a short
# recognizable prefix (a 32-hex digest is a terrible label; its first 12
# chars identify it in any log), later ones share ``other``.

_DEFAULT_STREAM_LABEL_MAX = 16
_STREAM_PREFIX_CHARS = 12

_STREAM_BUCKET_LOCK = threading.Lock()
_STREAM_BUCKETS: dict[str, str] = {}


def _stream_label_max() -> int:
    """Bucket cap, read lazily like :func:`_label_max`."""
    return int(os.environ.get("DBX_STREAM_LABEL_MAX",
                              _DEFAULT_STREAM_LABEL_MAX))


def stream_bucket(key: str) -> str:
    """The bounded metric label for a stream key.

    First ``DBX_STREAM_LABEL_MAX`` distinct keys map to their first 12
    hex chars, later ones to :data:`OVERFLOW_BUCKET`. This is THE
    sanctioned way to put stream identity on a metric label (dbxlint
    obs-cardinality treats ``stream_bucket(...)`` as bounded by
    construction, beside ``tenant_bucket``/``shape_bucket``).
    """
    k = key or "?"
    return _sticky_bucket(_STREAM_BUCKETS, _STREAM_BUCKET_LOCK,
                          _stream_label_max(), k,
                          k[:_STREAM_PREFIX_CHARS])


# -- worker buckets ---------------------------------------------------------
#
# Worker ids are worker-chosen wire strings (uuid-suffixed by default) and
# exactly as unbounded as tenant ids: a churning fleet registers a fresh id
# per restart, so a raw per-worker metric label would mint a permanent
# time series per registration. The fleet telemetry plane's label
# surfaces (obs/fleet.py FleetView.collect) route through this map; the
# full ids stay on the per-document JSON surfaces (/fleet.json frames),
# which are per-snapshot, not per-series.

_DEFAULT_WORKER_LABEL_MAX = 16

_WORKER_BUCKET_LOCK = threading.Lock()
_WORKER_BUCKETS: dict[str, str] = {}


def _worker_label_max() -> int:
    """Bucket cap, read lazily like :func:`_label_max`."""
    return int(os.environ.get("DBX_WORKER_LABEL_MAX",
                              _DEFAULT_WORKER_LABEL_MAX))


def worker_bucket(worker_id: str) -> str:
    """The bounded metric label for a worker id.

    First ``DBX_WORKER_LABEL_MAX`` distinct ids keep their own name
    (sticky — a worker's series never splits mid-run), later ones share
    :data:`OVERFLOW_BUCKET`. This is THE sanctioned way to put worker
    identity on a metric label (dbxlint obs-cardinality treats
    ``worker_bucket(...)`` as bounded by construction, beside
    ``tenant_bucket``/``shape_bucket``/``stream_bucket``).
    """
    w = worker_id or "?"
    return _sticky_bucket(_WORKER_BUCKETS, _WORKER_BUCKET_LOCK,
                          _worker_label_max(), w, w)
