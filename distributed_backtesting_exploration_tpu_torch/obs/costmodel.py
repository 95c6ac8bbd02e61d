"""Cost-model drift plane: predicted-vs-measured stage cost residuals.

``tune/`` and ``bench.py`` share one op model (``tune.autotune
.modeled_cost`` — VPU ladder rounds, table streams, lane overhead), and
the autotuner already trusts it as a pruning PRIOR. Nobody checks it
against reality: a worker whose measured execute wall drifts from the
model's prediction (thermal throttling, a pathological shape, a stale
tuned schedule, an outright model bug) is invisible until it surfaces
as a straggler flag with no cause attached. This module closes the loop
(the TVM cost-model discipline from PAPERS.md: learn from measured
schedules, TRACK THE RESIDUALS):

- a span listener over the ``worker.execute`` stream (the submit
  spans now carry ``bars``/``combos`` shape attrs beside ``kernel`` and
  ``jobs``) converts each measured group wall into a **residual**
  against the op model's prediction for its (family, route);
- the model is *relative* (VPU-op equivalents per cell-bar), so a
  per-(family, route) **calibration EWMA** of measured
  seconds-per-model-unit anchors it to this process's silicon first
  (``DBX_COSTMODEL_WARMUP`` observations); after warmup the residual is
  ``log2(measured / predicted)`` — 0 = the model nailed it, +1 = twice
  as slow as predicted, symmetric in log space so over- and
  under-prediction fold into one histogram;
- residuals accumulate into a signed EWMA + a fixed log2-bucket
  histogram with a ``version`` dirty bit, riding the telemetry
  frames as a ``costmodel`` key (~tens of bytes) into FleetView's
  order-independent merge, ``/fleet.json``, GetStats and `dbxtop`;
- a single observation past ``DBX_COSTMODEL_BLOWOUT`` (log2; default
  3.0 ≈ 8x off) is a **blowout**: counted, and fired into the flight
  recorder (obs/flight.py) as a ``residual`` trigger — a mis-modeled
  stage is an incident worth a black-box bundle, not just a number.

``worker.compile`` spans are deliberately excluded: a cold compile's
wall is the compiler's, not the op model's, and one compile residual would
poison the calibration for hundreds of execute observations.

``DBX_COSTMODEL=0`` is the kill switch (observations become no-ops and
frames carry no ``costmodel`` key). Everything degrades to counting:
a model error, a missing attr, a zero-unit shape — skipped, never a
failed job.
"""

from __future__ import annotations

import math
import os
import threading

from . import trace
from .registry import get_registry

#: Residual histogram bounds, in log2(measured/predicted) — shared by
#: the worker-side accumulator and the dispatcher-side fold (same
#: exactness argument as fleet.STAGE_BUCKETS_S: summing per-bucket
#: counts commutes). The last bucket is the +inf overflow.
RESIDUAL_BUCKETS_LOG2 = (-4.0, -2.0, -1.0, -0.5, -0.25,
                         0.25, 0.5, 1.0, 2.0, 4.0)

_EWMA_ALPHA = 0.25          # residual EWMA (matches fleet's stage EWMAs)
_CALIB_ALPHA = 0.1          # seconds-per-unit calibration (slower: the
#                             calibration must not absorb a drift episode
#                             before the residuals can report it)


def enabled() -> bool:
    """``DBX_COSTMODEL`` (default on): track predicted-vs-measured
    residuals worker-side. ``0`` is the kill switch."""
    return os.environ.get("DBX_COSTMODEL", "1").lower() not in (
        "0", "off", "false")


def warmup_n() -> int:
    """``DBX_COSTMODEL_WARMUP`` (default 8): observations per (family,
    route) spent calibrating seconds-per-model-unit before residuals
    are scored — a residual against an uncalibrated constant would just
    measure the platform."""
    try:
        return max(int(os.environ.get("DBX_COSTMODEL_WARMUP", 8)), 1)
    except ValueError:
        return 8


def blowout_log2() -> float:
    """``DBX_COSTMODEL_BLOWOUT`` (default 3.0): |log2 residual| at or
    past which one observation counts as a blowout and fires the flight
    recorder's ``residual`` trigger (3.0 ≈ 8x off the prediction)."""
    try:
        return float(os.environ.get("DBX_COSTMODEL_BLOWOUT", 3.0))
    except ValueError:
        return 3.0


def residual_quantile(counts, q: float) -> float:
    """Rank-interpolated quantile over RESIDUAL_BUCKETS_LOG2 per-bucket
    counts. The registry's ``histogram_quantile`` assumes buckets start
    at 0 (latency); residuals are signed, so the underflow bucket
    collapses to the first bound and interpolation runs between real
    bound pairs."""
    bounds = RESIDUAL_BUCKETS_LOG2
    count = sum(counts)
    if not count:
        return 0.0
    rank = q * count
    acc = 0
    lo = bounds[0]
    for i, c in enumerate(counts):
        hi = bounds[i] if i < len(bounds) else bounds[-1]
        if acc + c >= rank:
            if c == 0 or i == 0:
                return hi if i == 0 else lo
            return lo + (hi - lo) * (rank - acc) / c
        acc += c
        if i < len(bounds):
            lo = bounds[i]
    return bounds[-1]


def _model_units(family: str, bars: int, combos: int) -> float:
    """Total predicted model units for one group: the shared op model's
    per-cell-bar relative cost x the cell-bar count. In the port that
    model is the card's prior (``tune.autotune.modeled_cost``: fp32
    operations a cell-bar on the H100), so the units, and the residuals
    built on them, are not the reference's. Lazy import — tune imports
    obs at module level, so the reverse edge must not exist at import
    time."""
    from ..tune.autotune import default_substrates, modeled_cost

    per_cellbar = modeled_cost(family, default_substrates(family),
                               n_bars=bars, n_combos=combos)
    return per_cellbar * float(bars) * float(combos)


class CostModelTracker:
    """Process-scoped residual accumulator fed by the completed-span
    stream (the ``_StageStats`` twin in obs/fleet.py — one listener,
    however many Workers the process hosts; the fleet fold dedupes per
    process)."""

    def __init__(self, *, registry=None, on_blowout=None):
        self._reg = registry or get_registry()
        self._on_blowout = on_blowout
        self._lock = threading.Lock()
        # (family, route) -> [n_obs, ewma seconds-per-model-unit].
        # Bounded in practice by the fused strategy registry x the
        # route vocabulary; the hard cap guards hostile span attrs.
        self._calib: dict[tuple[str, str], list] = {}
        self._n = 0
        self._ewma = 0.0
        self._buckets = [0] * (len(RESIDUAL_BUCKETS_LOG2) + 1)
        self._blowouts = 0
        self.version = 0      # bumps per scored residual — the dirty bit
        self._c_obs = self._reg.counter(
            "dbx_costmodel_observations_total",
            help="execute spans scored against the op model "
                 "(post-warmup)")
        self._c_blowout = self._reg.counter(
            "dbx_costmodel_blowouts_total",
            help="single observations past DBX_COSTMODEL_BLOWOUT "
                 "(|log2 measured/predicted|) — each also fires the "
                 "flight recorder's residual trigger")

    _CALIB_MAX = 256

    def observe(self, rec: dict) -> None:
        """Span listener: score one ``worker.execute`` span against the
        op model. Anything unusable (missing shape attrs, zero units, a
        model error) is skipped — drift tracking must never cost a job."""
        if rec.get("name") != "worker.execute" or not enabled():
            return
        kernel = str(rec.get("kernel", ""))
        if ":" not in kernel:
            return
        route, family = kernel.split(":", 1)
        try:
            dur = float(rec.get("dur_s", 0.0))
            bars = int(rec.get("bars", 0))
            combos = int(rec.get("combos", 0))
            jobs = int(rec.get("jobs", 1)) or 1
        except (TypeError, ValueError):
            return
        if dur <= 0.0 or bars <= 0 or combos <= 0:
            return
        try:
            units = _model_units(family, bars, combos) * jobs
        except Exception:
            return            # an unmodelable family teaches nothing
        if units <= 0.0 or not math.isfinite(units):
            return
        spu = dur / units
        blow = None
        with self._lock:
            cal = self._calib.get((family, route))
            if cal is None:
                if len(self._calib) >= self._CALIB_MAX:
                    return   # hostile attr storm: stop minting keys
                self._calib[(family, route)] = [1, spu]
                return
            n, ewma_spu = cal
            if n < warmup_n():
                cal[0] = n + 1
                cal[1] = (_CALIB_ALPHA * spu
                          + (1.0 - _CALIB_ALPHA) * ewma_spu)
                return
            residual = math.log2(dur / (ewma_spu * units))
            # Score against the PRE-update calibration, then let the
            # calibration track (slowly) so a permanent platform shift
            # re-centers instead of burning forever.
            cal[0] = n + 1
            cal[1] = (_CALIB_ALPHA * spu
                      + (1.0 - _CALIB_ALPHA) * ewma_spu)
            i = 0
            while (i < len(RESIDUAL_BUCKETS_LOG2)
                   and residual > RESIDUAL_BUCKETS_LOG2[i]):
                i += 1
            self._buckets[i] += 1
            self._n += 1
            self._ewma = (residual if self._n == 1 else
                          _EWMA_ALPHA * residual
                          + (1.0 - _EWMA_ALPHA) * self._ewma)
            if abs(residual) >= blowout_log2():
                self._blowouts += 1
                blow = (family, route, residual)
            self.version += 1
        self._c_obs.inc()
        if blow is not None:
            self._c_blowout.inc()
            if self._on_blowout is not None:
                try:
                    self._on_blowout(*blow)
                except Exception:
                    pass   # a capture hook must never cost a job

    def frame(self) -> dict:
        """The ``costmodel`` key of a telemetry frame (obs/fleet.py):
        compact, order-independently mergeable (histogram counts sum;
        EWMA is advisory per worker). Empty before the first scored
        residual — no key, no wire bytes."""
        with self._lock:
            if not self._n:
                return {}
            return {"n": self._n, "ewma": round(self._ewma, 4),
                    "buckets": list(self._buckets),
                    "blowouts": self._blowouts}

    def snapshot(self) -> dict:
        """Local debug view: calibration table + residual accumulators."""
        with self._lock:
            return {
                "calibration": {
                    f"{fam}:{route}": {"n": n, "spu": ewma}
                    for (fam, route), (n, ewma)
                    in sorted(self._calib.items())},
                "n": self._n, "ewma": round(self._ewma, 6),
                "buckets": list(self._buckets),
                "blowouts": self._blowouts}


_tracker: CostModelTracker | None = None
_tracker_lock = threading.Lock()


def _fire_residual_trigger(family: str, route: str,
                           residual: float) -> None:
    from . import flight

    flight.trigger("residual", subject=f"{family}:{route}",
                   residual=round(residual, 3))


def tracker() -> CostModelTracker:
    """The process-wide residual tracker, span listener installed on
    first use (the ``fleet.stage_stats`` pattern); blowouts fire the
    flight recorder's ``residual`` trigger."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = CostModelTracker(
                on_blowout=_fire_residual_trigger)
            trace.add_span_listener("costmodel", _tracker.observe)
        return _tracker


def reset_tracker() -> None:
    """Drop the singleton + its listener (test isolation — the
    ``configure_ring`` / ``reset_tenant_buckets`` precedent)."""
    global _tracker
    with _tracker_lock:
        if _tracker is not None:
            trace.remove_span_listener("costmodel")
            _tracker = None
