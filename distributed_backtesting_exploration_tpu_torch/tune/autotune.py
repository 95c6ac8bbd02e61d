"""Substrate autotuner of the port: measure the live schedule candidates of
a (kernel family, shape bucket) on the card, prune them with a prior,
record the winner (the reference's ``tune/autotune.py``).

Search space: only the knobs that select different code on Hopper.

- ``lanes_cap``: the CTA width of the tile entries (K1 ``dbx_fused_sma``,
  K2 ``dbx_band_inline``, K4 ``dbx_macd``, K5 ``dbx_trix``, K6 ``dbx_obv``,
  K7 ``dbx_pairs``), the reference's candidates ``"0"`` (the shipped width),
  ``"256"`` and ``"512"``, a cap on the shipped width
  (:func:`..ops.fused.tile_lanes`). A cap at or above the shipped width runs
  the shipped code and is left out. Every width gives the same bits.
- ``page_bars``: the page size of paged groups, scored by the prior only
  (it binds when the page pool is built, so the runs of one group cannot
  tell its candidates apart), as in the reference.

The reference also searches ``epilogue`` and the ``table_*`` knobs; the
port runs one design for every value of those, so a measured search would
record timing noise as a winner, and they are not searched.

``DBX_AUTOTUNE`` picks the mode: unset, ``0`` or ``off`` (no tuning, the
shipped defaults; the default), ``model`` (the prior's argmin, nothing
measured), anything else measures the pruned candidates on the caller's
harness (``DBX_AUTOTUNE_TRIALS`` of them beside the incumbent,
``DBX_AUTOTUNE_REPS`` interleaved rounds, 3 by default). A challenger
replaces the incumbent only when its median beats the incumbent's by more
than the incumbent's own spread, and by at least ``_MIN_GAIN``: a width
that wins by noise would be recorded and gossiped to the whole fleet.
Every failure degrades to the defaults: tuning never fails a job.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .. import obs, roofline
from ..ops import fused
from .registry import ScheduleRegistry, entry_line

_TRIALS_DEFAULT = 4
_REPS_DEFAULT = 3
# The least gain, a share of the incumbent's median, for which a measured
# challenger replaces it.
_MIN_GAIN = 0.03

_LANES_CANDIDATES = ("0", "256", "512")
_PAGE_BARS_CANDIDATES = ("256", "512", "1024")

# The grid axes whose distinct values (tuples, within one group) a tile
# entry's CTA forms once per bar for all its lanes
# (``ops/fused.py`` ``window_tiles``: K1 the fast and the slow windows, K4
# each (fast, slow) pair's macd line, K5 each span's rate of change, K7
# each lookback's z and hedged return).
_TILE_KEYS = {
    "sma_crossover": (("fast",), ("slow",)),
    "bollinger": (("window",),),
    "bollinger_touch": (("window",),),
    "macd": (("fast", "slow"),),
    "trix": (("span",),),
    "obv_trend": (("window",),),
    "pairs": (("lookback",),),
}
# Per distinct window and bar, beside the entry's own work
# (roofline.OPS_WINDOW): the value's store to shared memory and its read.
_OPS_STAGE = 1.0
# Most resident CTAs an SM (compute capability 9.0).
_MAX_CTAS_PER_SM = 32


def autotune_mode() -> str:
    """``DBX_AUTOTUNE`` (read when called): ``"off"`` (default),
    ``"model"`` (the prior's argmin, nothing measured) or ``"measure"``."""
    raw = os.environ.get("DBX_AUTOTUNE", "").strip().lower()
    if raw in ("", "0", "off"):
        return "off"
    if raw == "model":
        return "model"
    return "measure"


def autotune_trials() -> int:
    """Measured candidates a (family, bucket) beside the incumbent."""
    try:
        return max(int(os.environ.get("DBX_AUTOTUNE_TRIALS",
                                      _TRIALS_DEFAULT)), 1)
    except ValueError:
        return _TRIALS_DEFAULT


def env_pinned_keys(family: str) -> frozenset:
    """The substrate keys pinned by env (for any ``family``): env beats a
    tuned schedule, so those axes are left out of the search (their
    candidates would all run one substrate) and out of the recorded
    winner."""
    pinned = set()
    if os.environ.get("DBX_LANES_CAP"):
        pinned.add("lanes_cap")
    if os.environ.get("DBX_PAGE_BARS"):
        pinned.add("page_bars")
    return frozenset(pinned)


def default_substrates(family: str) -> dict:
    """The incumbent: the shipped width of ``family``'s tile entry
    (``{"lanes_cap": "0"}``), or ``{}`` for a family whose entry runs no
    tiles. Always measured first among the pruned candidates, and kept
    unless a challenger beats it by more than the noise (:meth:`Autotuner.
    _measure`)."""
    return {"lanes_cap": "0"} if fused.shipped_lanes(family) else {}


def _lanes_candidates(family: str) -> tuple:
    """``lanes_cap`` values that run other code for ``family``: ``"0"`` and
    the caps below its shipped width; none where it runs no tiles."""
    shipped = fused.shipped_lanes(family)
    if shipped is None:
        return ()
    return tuple(v for v in _LANES_CANDIDATES
                 if v == "0" or int(v) < shipped)


def candidate_space(family: str, *, paged: bool = False) -> list[dict]:
    """The live substrate candidates of ``family`` (lanes [x page_bars]),
    in a fixed order; empty where no knob selects other code."""
    lanes = _lanes_candidates(family) or (None,)
    pages = _PAGE_BARS_CANDIDATES if paged else (None,)
    out = []
    for lc in lanes:
        for pb in pages:
            c = {}
            if lc is not None:
                c["lanes_cap"] = lc
            if pb is not None:
                c["page_bars"] = pb
            if c:
                out.append(c)
    return out


def _tile_windows(family: str, grid: dict | None, lanes: int,
                  P: int) -> float:
    """The mean count of distinct window values a CTA of ``lanes`` lanes
    forms for ``family`` over the flat per-combo ``grid``; without a grid,
    ``lanes`` (every lane its own window, the most there can be)."""
    groups = _TILE_KEYS.get(family)
    if grid is None or groups is None:
        return float(min(lanes, P))
    n_tiles = -(-P // lanes)
    total = 0.0
    for group in groups:
        keys = np.stack([np.asarray(grid[a], np.float64).reshape(-1)
                         for a in group], axis=1)
        _, ids = np.unique(keys, axis=0, return_inverse=True)
        ids = ids.reshape(-1)
        pad = n_tiles * lanes - P
        ids = np.concatenate([ids, np.repeat(ids[-1:], pad)])
        srt = np.sort(ids.reshape(n_tiles, lanes), axis=1)
        total += float((1 + (np.diff(srt, axis=1) != 0).sum(axis=1)).mean())
    return total


def modeled_cost(family: str, substrates: dict, *, n_bars: int,
                 n_combos: int, n_rows: int = 1,
                 grid: dict | None = None) -> float:
    """The prior: modeled fp32 operations a (cell, bar) of one sweep of
    ``family`` under ``substrates`` on the H100, a deterministic function
    of its arguments. It counts, from the port's own counts:

    - each lane's work a bar: the metric update, the entry's signal and its
      per-bar extras (``roofline.OPS_PER_BAR``, ``OPS_SIGNAL``,
      ``OPS_EACH_BAR``);
    - each CTA's shared work a bar: the values of the distinct windows its
      tile forms (``roofline.OPS_WINDOW`` and a store and read each), their
      count taken from ``grid`` per tile (:func:`_tile_windows`), so a
      narrower tile forms more of them a lane;
    - wave quantization: ``n_rows`` x ceil(P / width) CTAs in waves of
      ``roofline.SMS`` x the CTAs an SM holds (``THREADS_PER_SM`` / width,
      at most 32), each wave charged in full;
    - ``page_bars``: the pad of half a page a row, over ``n_bars``.

    Entries without tiles run 128 lanes a CTA, each lane forming its own
    window value. A prior for ordering candidates, not a time: the measured
    trials rank the survivors.
    """
    entry = roofline.ENTRY.get(family, "")
    ops_lane = (roofline.OPS_PER_BAR + roofline.OPS_SIGNAL.get(entry, 0)
                + roofline.OPS_EACH_BAR.get(entry, 0))
    ops_win = roofline.OPS_WINDOW.get(entry, 0) + _OPS_STAGE
    P = max(int(n_combos), 1)
    rows = max(int(n_rows), 1)
    shipped = fused.shipped_lanes(family)
    if shipped is None:
        lanes = fused._KERNEL_THREADS
        wins = float(min(lanes, P))
    else:
        try:
            cap = int(substrates.get("lanes_cap", "0") or 0)
        except ValueError:
            cap = 0
        lanes = min(shipped, cap) if cap > 0 else shipped
        wins = _tile_windows(family, grid, lanes, P)
    resident = max(1, min(_MAX_CTAS_PER_SM, roofline.THREADS_PER_SM // lanes))
    slots = roofline.SMS * resident
    waves = math.ceil(rows * math.ceil(P / lanes) / slots)
    cost = waves * slots * (lanes * ops_lane + wins * ops_win) / (rows * P)
    pb = substrates.get("page_bars")
    if pb:
        try:
            cost *= 1.0 + float(pb) / (2.0 * max(int(n_bars), 1))
        except ValueError:
            pass
    return cost


class Autotuner:
    """First-contact tuner: consult the prior, measure the survivors,
    record the winner in the schedule registry."""

    def __init__(self, schedule: ScheduleRegistry,
                 registry: "obs.Registry | None" = None):
        self.schedule = schedule
        self._obs = registry or obs.get_registry()
        self._c_trials: dict[str, obs.Counter] = {}

    def _count_trials(self, family: str, n: int) -> None:
        c = self._c_trials.get(family)
        if c is None:
            # family is bounded: the fused strategy registry's key set.
            c = self._c_trials[family] = self._obs.counter(
                "dbx_autotune_trials_total",
                help="live autotune measurements run, by kernel family",
                family=family)
        c.inc(n)

    def tune(self, family: str, bucket: str, platform: str, *,
             n_bars: int, n_combos: int, measure=None,
             paged: bool = False, n_rows: int = 1,
             grid: dict | None = None) -> dict | None:
        """Tune one (family, bucket, platform) and record the winner.

        ``measure(substrates) -> seconds`` runs the family's sweep under the
        candidate (the caller owns shapes and data); None, or the mode
        ``model``, takes the prior's argmin (``n_rows`` and ``grid`` are
        the prior's, :func:`modeled_cost`). Returns the winner, or None
        when the mode is off, no knob selects other code, or every
        measurement failed: the caller then serves the defaults."""
        mode = autotune_mode()
        if mode == "off":
            return None
        cands = candidate_space(family, paged=paged)
        pinned = env_pinned_keys(family)
        if pinned:
            cands = [{k: v for k, v in c.items() if k not in pinned}
                     for c in cands]
            seen: set = set()
            cands = [c for c in cands
                     if c and entry_line(c) not in seen
                     and not seen.add(entry_line(c))]
        if not cands:
            return None
        scored = sorted(
            cands,
            key=lambda c: (modeled_cost(family, c, n_bars=n_bars,
                                        n_combos=n_combos, n_rows=n_rows,
                                        grid=grid),
                           entry_line(c)))
        if mode == "model" or measure is None:
            winner, best_us, trials = scored[0], None, 0
        else:
            winner, best_us, trials = self._measure(
                family, self._pruned(family, scored, autotune_trials(),
                                     pinned=pinned),
                measure)
            if winner is None:
                return None
        if pinned:
            winner = {k: v for k, v in winner.items() if k not in pinned}
            if not winner:
                return None
        self.schedule.record(family, bucket, platform, winner,
                             trials=trials, best_us=best_us)
        return winner

    @staticmethod
    def _pruned(family: str, scored: list[dict], n: int,
                pinned: frozenset = frozenset()) -> list[dict]:
        """The measured candidates: the incumbent first, then the prior's
        order up to ``n`` beyond it."""
        out: list[dict] = []
        seen: set[str] = set()
        for c in ([{k: v for k, v in default_substrates(family).items()
                    if k not in pinned}] + scored):
            k = entry_line(c)
            if c and k not in seen and len(out) <= n:
                seen.add(k)
                out.append(c)
        return out

    def _measure(self, family: str, cands: list[dict], measure):
        """Measure ``cands`` (the incumbent first, :meth:`_pruned`) in
        ``DBX_AUTOTUNE_REPS`` interleaved rounds, one run of each candidate
        a round, so a drift of the card's clock falls on all of them alike.
        The winner is the fastest challenger by median whose median beats
        the incumbent's by more than the incumbent's interquartile distance
        and by ``_MIN_GAIN`` of it; otherwise the incumbent. Returns
        ``(winner, its median in us, candidates that ran)``."""
        reps = _REPS_DEFAULT
        try:
            reps = max(int(os.environ.get("DBX_AUTOTUNE_REPS", reps)), 1)
        except ValueError:
            pass
        times: list[list[float]] = [[] for _ in cands]
        failed: set[int] = set()
        for _ in range(reps):
            for i, c in enumerate(cands):
                if i in failed:
                    continue
                try:
                    times[i].append(float(measure(dict(c))))
                except Exception:
                    failed.add(i)   # a failing candidate is not the winner
        ran = [i for i in range(len(cands)) if i not in failed]
        self._count_trials(family, len(ran))
        if not ran:
            return None, None, 0
        med = {i: float(np.median(times[i])) for i in ran}
        incumbent = entry_line(default_substrates(family))
        inc = next((i for i in ran if entry_line(cands[i]) == incumbent),
                   None)
        if inc is None:
            best = min(ran, key=lambda i: med[i])
        else:
            q1, q3 = np.percentile(times[inc], [25, 75])
            bar = med[inc] - max(float(q3 - q1), _MIN_GAIN * med[inc])
            best = min((i for i in ran if med[i] < bar),
                       key=lambda i: med[i], default=inc)
        return cands[best], round(med[best] * 1e6, 3), len(ran)
