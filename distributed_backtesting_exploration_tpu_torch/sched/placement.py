"""Locality-scored placement: the deferral budget (round 20).

The decision plane scored every take against the fleet for a full round
in shadow (obs/decisions.py, round 19) — regret told us what dispatch
was leaving on the table: a carry-store hit prices only the ΔT fraction
of an append sweep, panel residency skips the h2d leg, a compile-cache
hit skips a cold build. This
module is the LIVE half's policy core: given the polling worker's
expected stage cost and the best candidate's, decide whether a job may
wait one more poll for a better-placed worker.

Design split (the no-coordinator-on-the-hot-path bar):

- **Scoring** lives in obs/decisions.py — ONE op-model implementation
  (``placement_cost``) shared by the shadow scorer and the live score
  table, which the plane's daemon refreshes off the take lock.
- **Policy** lives HERE, in the scheduling package, as pure functions
  over two numbers and a counter: :func:`should_defer` is the entire
  deferral budget. The dispatcher's admit hook composes the two.

Deferral semantics (generalizing — and replacing — the round-6 one-shot
append-affinity special case):

- A job is deferred only while the best-scored worker beats the polling
  worker by at least ``PLACEMENT_RATIO`` (a *relative* bar: the op
  model's absolute seconds are calibration-dependent, but the ratio
  between a carry hit and a full reprice, or resident vs h2d, is not).
- Each deferral increments ``JobRecord.affinity_skips`` (NOT journaled
  — restarts restart locality cold); at ``DBX_PLACEMENT_DEFER_CAP``
  the job is served to whoever polls. Work-conserving by construction:
  a better worker that never polls costs at most ``cap`` poll rounds,
  never a starved job.
- Stale or straggler-flagged workers are scored DOWN by the table
  (penalty multipliers), never excluded — a flapping telemetry frame
  must degrade placement quality, not dispatch liveness.
- ``DBX_PLACEMENT=0`` kills the whole stage: the dispatcher passes no
  admit hook and take() degrades to pure WFQ order, bit-identical to
  round 19.

Chain settling (:func:`should_wait_for_parent`): an append link whose
PARENT job has not yet dispatched scores "no holder anywhere" — every
worker prices the same full reprice, the ratio bar never clears, and
the link is served blind to whoever polls first, pinning the rest of
the chain to the wrong worker. The dispatcher therefore also defers a
link while its parent's digest is still pending in the queue
(``JobQueue._pending_digests``), charged against the SAME
``affinity_skips`` budget — a chain can wait for its parent to settle,
but never past the cap, so a parent that fails or never dispatches
costs at most ``cap`` poll rounds before the child serves anyway.
"""

from __future__ import annotations

import os

#: The best candidate must beat the polling worker's expected stage cost
#: by this factor before a deferral is worth a poll round. Relative on
#: purpose: pre-calibration the op model only ranks (shared default
#: seconds-per-unit), and shared terms (e.g. a family cold on every
#: worker) cancel out of the ratio's discriminating power but would
#: swamp any absolute threshold.
PLACEMENT_RATIO = 1.5


def enabled() -> bool:
    """``DBX_PLACEMENT`` (default on): locality-scored placement in the
    live take path. ``0`` is the kill switch — the dispatcher passes no
    admit hook at all and dispatch order is pure WFQ (round-19
    behavior, bit-identical)."""
    return os.environ.get("DBX_PLACEMENT", "1").lower() not in (
        "0", "off", "false")


def defer_cap() -> int:
    """``DBX_PLACEMENT_DEFER_CAP`` (default 2): how many polls a job may
    wait for its best-scored worker before anyone serves it. ``0``
    keeps scoring live (records, counters, dbxwhy rank) but never
    defers."""
    try:
        return max(int(os.environ.get("DBX_PLACEMENT_DEFER_CAP", 2)), 0)
    except ValueError:
        return 2


def should_defer(my_cost_s: float, best_cost_s: float,
                 skips: int, cap: int) -> bool:
    """The entire deferral budget: wait for the better worker iff the
    budget has room AND the best candidate wins by the relative bar.
    Ties (and any non-finite garbage from a poisoned model) serve
    immediately — placement may only ever *delay* a job, by at most
    ``cap`` polls, never park it."""
    if skips >= cap:
        return False
    if not (my_cost_s >= 0.0 and best_cost_s >= 0.0):   # NaN-safe
        return False
    return best_cost_s * PLACEMENT_RATIO < my_cost_s


def should_wait_for_parent(skips: int, cap: int) -> bool:
    """Chain-settling deferral: may an append link wait one more poll
    for its still-pending parent to dispatch (and so MINT the carry
    state the score table would route on)? Same budget as
    :func:`should_defer` — the two draw on one ``affinity_skips``
    counter, so waiting on a parent spends polls a locality deferral
    could have used, and the cap bounds the sum."""
    return skips < cap
