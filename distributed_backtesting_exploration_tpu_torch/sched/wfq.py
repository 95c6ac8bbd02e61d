"""Virtual-time weighted fair queueing over per-tenant pending lanes.

The dispatcher's queue state machine (round 5: batched register / lease /
tombstone / completion transitions, native or pure-Python) stays the
authority on what a job's lifecycle state IS; this module decides WHICH
pending job is served next. Jobs are parked in per-tenant FIFO lanes (one
more per-tenant index per pop) and each pop runs start-time fair queueing
over the lane heads:

- a tenant's next job carries the virtual start tag
  ``max(F_t, V)`` where ``F_t`` is the tenant's virtual finish time and
  ``V`` the tag of the job served last;
- the lowest tag wins (ties broken by arrival sequence — deterministic,
  and single-tenant order is exactly the FIFO);
- serving a job of cost ``c`` (its combo count — the unit of backtest
  service) advances ``F_t`` by ``c / weight(t)``.

Weights come from ``DBX_TENANT_WEIGHTS`` (``"whale:4,small:1"``; ``*``
sets the default, otherwise 1.0). ``DBX_TENANT_QUOTA`` caps a tenant's
IN-FLIGHT combos (leased, not yet completed): while a tenant is at
quota its pending jobs are demoted behind every other tenant's virtual
time — skipped, not reordered within the lane, and never starved: the
discipline is work-conserving (an over-quota tenant is still served
when no one else has pending work), and leased jobs are never yanked.

NOT thread-safe on its own — every call arrives under ``JobQueue._lock``,
the same single-lock discipline the state machine itself is driven with.
"""

from __future__ import annotations

import collections
import os

from .explain import PickExplain
from .tenancy import DEFAULT_TENANT


def parse_tenant_map(spec: str) -> dict[str, float]:
    """``"whale:4,small:1,*:2"`` -> ``{"whale": 4.0, "small": 1.0,
    "*": 2.0}``. ``*`` is the default for unlisted tenants. A malformed
    entry raises ``ValueError`` — a typo'd env knob must fail the
    dispatcher loudly at construction, not silently schedule unfairly."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.rpartition(":")
        if not sep or not name.strip():
            raise ValueError(
                f"malformed tenant map entry {part!r} (want name:number)")
        try:
            out[name.strip()] = float(val)
        except ValueError:
            raise ValueError(
                f"malformed tenant map entry {part!r}: {val!r} is not a "
                "number") from None
    return out


class WfqScheduler:
    """Per-tenant pending lanes + the virtual-time pop (module docstring).

    ``weights``/``quotas`` default to the ``DBX_TENANT_WEIGHTS`` /
    ``DBX_TENANT_QUOTA`` env knobs, read lazily at construction (one
    scheduler per ``JobQueue``)."""

    def __init__(self, *, weights: dict[str, float] | None = None,
                 quotas: dict[str, float] | None = None):
        if weights is None:
            weights = parse_tenant_map(
                os.environ.get("DBX_TENANT_WEIGHTS", ""))
        if quotas is None:
            quotas = parse_tenant_map(
                os.environ.get("DBX_TENANT_QUOTA", ""))
        for t, w in weights.items():
            if w <= 0:
                # Same loud-failure policy as parse_tenant_map: silently
                # coercing a zero/negative weight to the default would
                # schedule the one tenant the operator meant to throttle
                # at full rate.
                raise ValueError(
                    f"tenant weight must be > 0 (got {t!r}: {w}); use a "
                    "small weight or DBX_TENANT_QUOTA to throttle")
        self._weights = weights
        self._quotas = quotas
        # tenant -> FIFO lane of (seq, jid, cost). Entries for discarded
        # (completed-while-parked) jobs are tombstoned in _gone and
        # skipped lazily at the next head read — a deque has no interior
        # removal, the same discipline as the state machine's FIFO.
        self._lanes: dict[str, collections.deque] = {}
        self._parked: dict[str, str] = {}        # jid -> tenant
        self._npend: collections.Counter = collections.Counter()
        self._gone: set[str] = set()
        self._finish: dict[str, float] = {}      # tenant -> virtual finish
        self._vtime = 0.0
        self._seq = 0          # arrival order (FIFO tie-break)
        self._front_seq = 0    # decreasing: requeued jobs sort first
        # jid -> (tenant, cost): every job charged against its tenant's
        # quota. The charge lands AT PICK TIME (under the caller's
        # lock), not at lease commit: the commit only happens after
        # take()'s unlocked payload-materialization window, and a
        # concurrent worker's pick in that window would otherwise read
        # a stale zero charge and hand an at-quota tenant another
        # batch. Every non-lease resolution (materialization failure,
        # completed-mid-take, exception re-park, requeue) releases.
        self._charged: dict[str, tuple[str, float]] = {}
        self._inflight: collections.Counter = collections.Counter()
        self._demoted: collections.Counter = collections.Counter()

    # -- config ------------------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self._weights.get("*", 1.0))

    def quota(self, tenant: str) -> float | None:
        return self._quotas.get(tenant, self._quotas.get("*"))

    # -- parked-lane surface (all calls under JobQueue._lock) --------------

    def push(self, jid: str, tenant: str, cost: float) -> None:
        """Park a pending job at the tail of its tenant's lane."""
        t = tenant or DEFAULT_TENANT
        self._lanes.setdefault(t, collections.deque()).append(
            (self._seq, jid, float(cost)))
        self._seq += 1
        self._parked[jid] = t
        self._npend[t] += 1

    def requeue_front(self, items: list[tuple[str, str, float]]) -> None:
        """Re-park jobs at the FRONT of their lanes, preserving ``items``
        service order (requeue-at-front: a retried job must not re-wait
        behind the whole backlog — the pre-tenancy FIFO's appendleft)."""
        for jid, tenant, cost in reversed(items):
            t = tenant or DEFAULT_TENANT
            self._front_seq -= 1
            self._lanes.setdefault(t, collections.deque()).appendleft(
                (self._front_seq, jid, float(cost)))
            self._parked[jid] = t
            self._npend[t] += 1

    def discard(self, jid: str) -> bool:
        """Drop a parked job (completed while pending). True when ``jid``
        was parked — the caller then clears the state machine's orphan
        tombstone so ``drained``/``pending`` accounting stays exact."""
        t = self._parked.pop(jid, None)
        if t is None:
            return False
        self._gone.add(jid)
        self._npend[t] -= 1
        return True

    def _live_head(self, lane: collections.deque):
        while lane and lane[0][1] in self._gone:
            self._gone.discard(lane.popleft()[1])
        return lane[0] if lane else None

    def pick(self, n: int,
             explain: list[PickExplain] | None = None) -> list[str]:
        """Pop up to ``n`` jids in virtual-time order (module docstring).
        Picked jobs are immediately charged against their tenant's quota
        (see ``_charged``) — the caller releases any that fail to
        lease.

        ``explain`` (a list, or None) is the decision plane's hook: one
        :class:`~.explain.PickExplain` is appended per served job, built
        from the very values this pop used — the record cannot disagree
        with the decision, and assembly is fully gated on the argument
        so unobserved picks pay nothing."""
        out: list[str] = []
        while len(out) < n:
            heads = []   # (tag, seq, tenant, jid, cost, over_quota)
            drained_lanes: list[str] = []
            any_over = False
            for t, lane in self._lanes.items():
                head = self._live_head(lane)
                if head is None:
                    drained_lanes.append(t)
                    continue
                seq, jid, cost = head
                q = self.quota(t)
                over = q is not None and self._inflight[t] + cost > q
                any_over = any_over or over
                heads.append((max(self._finish.get(t, 0.0), self._vtime),
                              seq, t, jid, cost, over))
            for t in drained_lanes:
                # Drop drained lanes — the head scan must stay
                # proportional to tenants with LIVE work — and, once a
                # tenant is fully idle (nothing parked, nothing leased),
                # its per-tenant bookkeeping too: tenant ids are
                # wire-controlled strings, and one entry per id ever
                # seen would be an unbounded leak (same refusal as
                # tenancy's bucket map). Discarding an idle tenant's
                # virtual finish merely re-admits it at the current
                # virtual time later — exactly what a fresh tenant id
                # would get anyway.
                del self._lanes[t]
                if not self._npend.get(t) and not self._inflight.get(t):
                    self._npend.pop(t, None)
                    self._inflight.pop(t, None)
                    self._finish.pop(t, None)
                    self._demoted.pop(t, None)
            if not heads:
                break
            in_quota = [h for h in heads if not h[5]]
            demoted_now: list[str] = []
            if in_quota and any_over:
                # The demotion event: an at-quota tenant's head was
                # pushed behind every in-quota tenant this pop.
                for h in heads:
                    if h[5]:
                        self._demoted[h[2]] += 1
                        demoted_now.append(h[2])
            # Work-conserving: quota demotes behind OTHER tenants' work,
            # it never idles the fleet when only over-quota work remains.
            tag, seq, t, jid, cost, over = min(
                in_quota or heads, key=lambda h: (h[0], h[1]))
            self._lanes[t].popleft()
            # pop-with-default: a duplicate enqueue of one id (already a
            # documented-undefined intake) must double-dispatch like the
            # pre-tenancy FIFO did, not crash the pop.
            if self._parked.pop(jid, None) is not None:
                self._npend[t] -= 1
            self._charged[jid] = (t, cost)
            self._inflight[t] += cost
            vtime_before = self._vtime
            self._finish[t] = tag + cost / self.weight(t)
            self._vtime = tag
            if explain is not None:
                explain.append(PickExplain(
                    jid=jid, tenant=t, tag=tag, vtime=vtime_before,
                    vfinish=self._finish[t], cost=cost,
                    weight=self.weight(t), over_quota=over,
                    demoted=demoted_now,
                    heads={h[2]: h[0] for h in heads}))
            out.append(jid)
        return out

    # -- quota bookkeeping -------------------------------------------------

    def on_lease(self, jid: str, tenant: str, cost: float) -> None:
        """Confirm a leased job's quota charge. Normally a no-op — the
        charge landed at pick time — but charges defensively for a jid
        this scheduler never picked (direct callers, tests)."""
        if jid in self._charged:
            return
        t = tenant or DEFAULT_TENANT
        self._charged[jid] = (t, float(cost))
        self._inflight[t] += float(cost)

    def release(self, jid: str) -> None:
        """Uncharge a leased job (completed / requeued). Idempotent —
        a late duplicate completion after a requeue already released.
        A tenant whose last charge releases while it has nothing parked
        drops ALL its per-tenant state here: the lane prune in pick()
        runs before leases land, so without this a one-shot tenant id
        would leave a zeroed entry behind forever (tenant ids are
        wire-controlled — nothing may grow per id ever seen)."""
        hit = self._charged.pop(jid, None)
        if hit is None:
            return
        t, cost = hit
        left = max(self._inflight[t] - cost, 0.0)
        if left > 0.0:
            self._inflight[t] = left
            return
        self._inflight.pop(t, None)
        if not self._npend.get(t) and not self._lanes.get(t):
            self._npend.pop(t, None)
            self._finish.pop(t, None)
            self._demoted.pop(t, None)

    # -- observability -----------------------------------------------------

    def pending(self) -> int:
        return len(self._parked)

    def tenants(self) -> list[str]:
        return sorted(set(self._npend) | set(self._inflight))

    def stats(self) -> dict[str, dict]:
        """Per-tenant scheduling state: parked backlog, in-flight combo
        charge, virtual finish time, quota-demotion count."""
        return {t: {"pending": int(self._npend.get(t, 0)),
                    "inflight_combos": float(self._inflight.get(t, 0.0)),
                    "vfinish": float(self._finish.get(t, 0.0)),
                    "demoted": int(self._demoted.get(t, 0)),
                    "weight": self.weight(t),
                    "quota": self.quota(t)}
                for t in self.tenants()}
