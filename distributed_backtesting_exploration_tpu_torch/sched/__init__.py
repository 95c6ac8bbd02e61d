"""Multi-tenant scheduling: weighted fair queueing, quotas, tenant labels.

"Millions of users" (ROADMAP item 5) breaks the single-FIFO abstraction:
one whale tenant's 100k-combo grid sweep parks everyone else's latency
behind it. This package owns the two pieces the dispatcher composes:

- :mod:`.wfq` — a virtual-time weighted-fair-queueing index over the
  round-5 batched queue state machine (one per-tenant pending lane per
  pop), with per-tenant weights (``DBX_TENANT_WEIGHTS``) and in-flight
  quotas (``DBX_TENANT_QUOTA``) that demote over-quota *pending* work
  behind other tenants' virtual time — leased jobs are never yanked;
- :mod:`.tenancy` — the ``default`` tenant constant (proto3-default
  mapping for legacy clients) and the BOUNDED tenant-bucket label map
  that makes ``dbx_queue_jobs{tenant=...}`` safe under dbxlint's
  obs-cardinality rule;
- :mod:`.explain` — the pick-time explain records (round 19) the
  dispatch decision plane (obs/decisions.py) stitches into per-job
  "why this worker" reports;
- :mod:`.placement` — the locality-placement deferral budget (round
  20): pure policy (``should_defer`` + the ``DBX_PLACEMENT`` /
  ``DBX_PLACEMENT_DEFER_CAP`` knobs) over the stage costs the decision
  plane's score table computes off the take lock.
"""

from . import placement  # noqa: F401
from .explain import PickExplain, held_explain  # noqa: F401
from .tenancy import (  # noqa: F401
    DEFAULT_TENANT, OVERFLOW_BUCKET, reset_tenant_buckets,
    stream_bucket, tenant_bucket, worker_bucket)
from .wfq import WfqScheduler, parse_tenant_map  # noqa: F401
