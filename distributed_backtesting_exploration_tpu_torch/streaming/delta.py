"""Metric-delta extraction between successive stream results.

The live fan-out tier (``serve/``) pushes each stream's full DBXM block
— the bit-matching contract is on the block, and at ``n_params x 9``
float32s it is already small — but a thin client following thousands of
streams wants to know WHICH ticks actually moved something before it
diffs anything. This module computes that summary dispatcher-side, from
the result cache's previous block: the number of param lanes whose
metrics changed under the appended bars. It rides on the carry-advance
output (every pushed block is a finalized carry), hence its home in
``streaming/``; the diff itself is plain numpy over the DBXM codec the
dispatcher already speaks, so the push path never touches the
recurrent/fused kernel machinery (``streaming/__init__`` lazy-loads
those halves for the same reason).

NaN-aware: a lane that stays NaN (e.g. sharpe of an all-flat param
combo) is UNCHANGED — the naive ``a != b`` would report every NaN lane
as moved on every tick.
"""

from __future__ import annotations

import numpy as np

from ..rpc import wire


def metric_delta(prev: bytes | None, new: bytes) -> tuple[int, int]:
    """``(changed, total)`` param lanes between two DBXM blocks.

    ``changed`` is the count of param lanes where ANY metric differs
    bitwise-as-values (NaN == NaN counts as equal); ``total`` is the
    lane count of ``new``. With no ``prev`` block — a stream's first
    result, or the previous entry evicted from the result cache —
    ``changed`` is -1 (the wire's "nothing to diff against" marker,
    distinct from 0 = "tick moved nothing"). A ``prev`` block whose
    shape no longer matches (the stream was rebuilt under a different
    grid) also reports -1 rather than a fabricated diff.
    """
    m_new = wire.metrics_from_bytes(new)
    total = int(np.asarray(m_new[0]).size)
    if prev is None:
        return -1, total
    try:
        m_prev = wire.metrics_from_bytes(prev)
    except ValueError:
        return -1, total
    if int(np.asarray(m_prev[0]).size) != total:
        return -1, total
    moved = np.zeros(total, dtype=bool)
    for a, b in zip(m_prev, m_new):
        a = np.asarray(a)
        b = np.asarray(b)
        moved |= (a != b) & ~(np.isnan(a) & np.isnan(b))
    return int(moved.sum()), total
