"""Pick-time explain records for the WFQ scheduler (round 19).

The dispatch decision plane (obs/decisions.py) answers "why did job J
land on worker W" — and the first half of that answer is scheduler
state: which tenant lane heads competed for this pop, what virtual tags
they carried, who got quota-demoted, and where the served tenant's
virtual finish landed. That state lives only inside
``WfqScheduler.pick`` and is gone the instant the pop returns, so the
scheduler exposes it through an explain hook: ``pick(n, explain=[...])``
appends one :class:`PickExplain` per served job, built from exactly the
values the pick itself used (no re-derivation — the record can never
disagree with the decision).

Determinism contract: the record is a pure function of the scheduler's
logical state (lanes, finish tags, quota charges) — never of wall
clocks, ids(), or map iteration order (competing heads are sorted by
tenant). Two queues with the same intake history produce bit-identical
explain dicts on BOTH state-machine substrates (the WFQ index is shared
Python either way), and a journal-replayed queue reproduces the original
run's records with virtual time restarting at 0 (the replay
semantics). Tested in tests/test_decisions.py.

The hook costs nothing when unused: ``pick`` takes ``explain=None`` by
default and the record assembly is gated on it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PickExplain:
    """Scheduler state behind one served job, captured at pop time.

    ``heads`` is the competing-lane snapshot: tenant -> the virtual
    start tag its head carried this pop (the winner included), sorted by
    tenant name and bounded by tenants with live work. ``demoted`` lists
    the tenants whose over-quota heads were pushed behind every in-quota
    tenant on this pop (empty when no demotion happened). ``vtime`` is
    the scheduler's virtual time BEFORE the pop; ``tag`` the winning
    head's virtual start tag (which becomes the new virtual time);
    ``vfinish`` the served tenant's virtual finish AFTER the charge
    (``tag + cost / weight``)."""

    jid: str
    tenant: str
    tag: float
    vtime: float
    vfinish: float
    cost: float
    weight: float
    over_quota: bool
    demoted: list[str] = dataclasses.field(default_factory=list)
    heads: dict[str, float] = dataclasses.field(default_factory=dict)

    #: Competing-head snapshot bound: tenants beyond this many (sorted
    #: by tenant name) are dropped from ``heads`` and counted in
    #: ``heads_dropped`` — tenant ids are wire-controlled strings and a
    #: decision record must stay O(1), not O(tenants).
    MAX_HEADS = 8

    def as_dict(self) -> dict:
        """JSON-able form, floats rounded to stable widths (the span
        ring's ``round`` discipline — reproducible bytes, not 17-digit
        float noise)."""
        heads = dict(sorted(self.heads.items())[:self.MAX_HEADS])
        out = {
            "jid": self.jid,
            "tenant": self.tenant,
            "tag": round(self.tag, 9),
            "vtime": round(self.vtime, 9),
            "vfinish": round(self.vfinish, 9),
            "cost": round(self.cost, 9),
            "weight": round(self.weight, 9),
            "over_quota": bool(self.over_quota),
            "demoted": sorted(self.demoted),
            "heads": {t: round(v, 9) for t, v in heads.items()},
        }
        dropped = len(self.heads) - len(heads)
        if dropped > 0:
            out["heads_dropped"] = dropped
        return out


def held_explain(jid: str) -> dict:
    """The explain record of a job served from the placement-held list:
    it skipped the WFQ pop entirely this round (front-of-line service
    after a locality deferral — round 20's generalization of the old
    one-shot append-affinity hold), so there is no pick-time scheduler
    state to report — only the fact of the hold. The ``affinity_held``
    key name survives from round 6 for record-schema stability."""
    return {"jid": jid, "affinity_held": True}
