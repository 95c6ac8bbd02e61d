"""Live signal fan-out: the streaming subscription tier over append chains.

The north star serves millions of users, and millions of users are
READERS — until this package the control plane had only write-shaped
RPCs (enqueue, append, complete). :mod:`.registry` owns the read path:
clients register interests keyed by (panel chain, strategy, param-block
grid, tenant) over the server-streaming ``Subscribe`` RPC, and every
``AppendBars`` tick on a subscribed chain schedules exactly ONE O(ΔT)
carry advance per unique live stream — riding the ordinary append-job
dispatch and the workers' CarryStore machinery — then fans the
resulting metric block out to every subscriber of that stream from a
result cache keyed ``(digest, stream_key)``. N followers of a hot
symbol cost one advance: serving cost is O(unique streams), not
O(subscribers) — the cached-recurrent-state serving discipline of
PAPERS.md "Compiler-First State Space Duality and Portable O(1)
Autoregressive Caching" applied to a fleet instead of a decoder.

Degradation ladder (never block the tick path): slow subscriber ->
bounded per-subscriber queue (``DBX_SUB_QUEUE_MAX``) -> drop-oldest-and-
count (the client sees the gap in ``PushUpdate.dropped`` and in its
``seq`` holes). Tenancy rides the machinery: per-tenant
subscription quotas (``DBX_TENANT_SUB_QUOTA``) demote, never reject,
and fan-out order + per-subscriber isolation keep a whale subscriber
from moving small tenants' push latency. Subscriptions are in-memory
only — a dispatcher restart drops them cleanly and a re-subscribe
resumes from the journal-replayed chain.
"""

from .registry import (  # noqa: F401
    PushItem, ResultCache, StreamSpec, Subscription, SubscriptionHub,
    result_cache_max_bytes, stream_key, sub_queue_max)
