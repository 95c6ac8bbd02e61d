"""Dispatch decision plane: per-take explainability + shadow placement.

Every ``JobQueue.take()`` resolution is a layered placement decision —
a WFQ virtual-time pick, possibly an affinity deferral, a
payload route (digest-only / full / delta; scenario-coalesced) — and none of it was observable: "why did job J land on worker W,
and what would it have cost elsewhere?" had no answer. This module is
that answer, built to the flight-recorder posture (obs/flight.py):

- the dispatcher hands :meth:`DecisionPlane.submit` one small tuple per
  dispatched job (the record object plus the four values only the
  dispatch loop knows — no dict assembly, no snapshot, no model math on
  the take path), a single small-lock deque append per poll; the
  scoring budget (``DBX_DECISIONS_RATE``) is spent right there, and
  :meth:`DecisionPlane.want` lets an over-budget poll skip explain
  assembly and the submit entirely — past the budget the hot path is
  byte-identical to the kill-switch path;
- a daemon thread scores each batch against ONE ``FleetView.snapshot()``:
  for every live worker it estimates the job's stage cost from the op
  model ``obs/costmodel.py`` and ``bench.py`` already share — execute
  wall from model units x a per-worker seconds-per-unit EWMA (calibrated
  by completions), **carry-hit vs reprice** (an append job on a worker
  whose top-K digest sketch holds the base panel pays only the delta
  fraction), **page residency vs h2d** (payload bytes over a nominal
  link rate unless the panel digest is resident), **compile-cache hit
  vs cold wall** (first sighting of a strategy family on a worker pays
  the cold-compile constant);
- ``regret = cost(actual) − cost(best_shadow)`` is recorded per decision
  (>= 0 — the actual worker is always a candidate); round 19 ran this
  in pure shadow mode, the measure-before-commit discipline the
  locality scorer was held to.

Round 20 promotes the scorer to DUAL live/shadow mode. The same cost
model (ONE implementation: :func:`placement_cost`) now also feeds the
live dispatch path through a pre-computed :class:`PlacementTable` this
plane's daemon rebuilds every tick — off the take lock — from the
fleet's ``placement_view()`` export, the dispatcher's delivered-digest
ground truth, and the spu/family calibration below. The dispatcher's
take-path admit hook reads the table lock-free and defers a job (at
most ``DBX_PLACEMENT_DEFER_CAP`` polls, policy in ``sched.placement``)
when another worker's expected stage cost wins by the relative bar.
Stale or straggler-flagged workers are scored DOWN (penalty
multipliers), never excluded, so degraded telemetry degrades placement
quality, not liveness. The shadow scorer keeps running over the same
inputs, so measured regret now *validates* the live policy: live-mode
regret on a workload should sit strictly below the shadow-mode regret
the same workload records with ``DBX_PLACEMENT=0``.

Storage follows the span-ring discipline (obs/trace.py): a bounded
in-memory ring (``DBX_DECISIONS_RING``, default 256) serves
``/decisions.json`` and ``dbxwhy``'s live path, and each record also
lands in the opt-in JSONL event log (``DBX_OBS_JSONL``) as an
``ev="decision"`` line beside the spans it explains — one file,
``dbxwhy`` stitches both. Metrics stay bounded:
``dbx_dispatch_regret_seconds`` (no labels),
``dbx_decisions_total{route=...}`` over the fixed route vocabulary, and
agree/disagree shadow counters. Sustained high regret (EWMA past
``DBX_DECISIONS_REGRET_S`` for ``DBX_DECISIONS_REGRET_N`` consecutive
scored decisions) fires the flight recorder's ``regret`` trigger — a
fleet that keeps paying for placement is an incident, not a number.

``DBX_DECISIONS=0`` is the kill switch: the dispatcher stops building
raw dicts entirely (checked per RequestJobs, before any work).
Everything degrades to counting — a scoring error, an empty fleet, a
full queue, a dispatch rate past the ``DBX_DECISIONS_RATE`` scoring
budget — never a failed or delayed job.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time

from . import costmodel, events
from ..sched import placement as sched_placement
from .registry import get_registry, histogram_quantile

#: Payload-route vocabulary (bounded — metric label + record field).
#: ``held`` marks affinity-held jobs served outside the WFQ pop;
#: anything else folds to ``other``.
ROUTES = ("digest_only", "full", "delta", "scenario", "held")

#: Regret histogram bounds in seconds (one-sided latency-style; the
#: last bucket is +inf overflow). Finer than LATENCY_BUCKETS_S at the
#: low end — placement regret on a warm fleet is mostly milliseconds.
REGRET_BUCKETS_S = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0)

_SPU_ALPHA = 0.2      # per-worker seconds-per-model-unit EWMA
_REGRET_ALPHA = 0.25  # regret EWMA feeding the sustained-regret trigger
_DEFAULT_SPU = 1e-8   # pre-calibration seconds-per-unit (relative
#                       ranking only needs a shared starting point)


def route_bucket(route: str) -> str:
    """Bounded bucket for a payload route: one of ``ROUTES`` or
    ``"other"`` (the ``trigger_bucket`` discipline)."""
    return route if route in ROUTES else "other"


def enabled() -> bool:
    """``DBX_DECISIONS`` (default on): record dispatch decisions.
    ``0`` is the kill switch — the dispatcher skips record assembly
    entirely."""
    return os.environ.get("DBX_DECISIONS", "1").lower() not in (
        "0", "off", "false")


def ring_capacity() -> int:
    """``DBX_DECISIONS_RING`` (default 256): decision records retained
    in memory for ``/decisions.json`` and ``dbxwhy``."""
    try:
        return max(int(os.environ.get("DBX_DECISIONS_RING", 256)), 1)
    except ValueError:
        return 256


def h2d_rate_bps() -> float:
    """``DBX_DECISIONS_H2D_GBPS`` (default 2.0): nominal payload
    transfer rate used to price a non-resident panel's host-to-device
    (and wire) leg in the shadow score."""
    try:
        gbps = float(os.environ.get("DBX_DECISIONS_H2D_GBPS", 2.0))
    except ValueError:
        gbps = 2.0
    return max(gbps, 1e-3) * 1e9


def compile_wall_s() -> float:
    """``DBX_DECISIONS_COMPILE_S``: cost charged when a strategy family
    has never been seen on a candidate worker. The default, 0.531 s, is
    the reference's (the JAX package's cold compile), kept so the two
    packages score alike; the port's kernel builds were not measured for
    it."""
    try:
        return max(float(os.environ.get("DBX_DECISIONS_COMPILE_S",
                                        0.531)), 0.0)
    except ValueError:
        return 0.531


def score_rate() -> float:
    """``DBX_DECISIONS_RATE`` (default 50): scored decision records per
    second (token bucket, burst = one second of budget, floor 32).
    Scoring is pure-Python work on the
    plane's thread, and on a saturated small-core box an unbounded
    scorer would steal GIL time from the serving loop in proportion to
    the dispatch rate — so beyond the budget records degrade to a
    ``throttled`` counter (the flight posture: telemetry samples, it
    never taxes the fleet). ``0`` or negative disables the throttle
    (score everything — fine off the hot path on a multi-core box)."""
    try:
        return float(os.environ.get("DBX_DECISIONS_RATE", 50.0))
    except ValueError:
        return 50.0


def regret_bar_s() -> float:
    """``DBX_DECISIONS_REGRET_S`` (default 1.0): regret EWMA (seconds)
    past which the sustained-regret flight trigger arms."""
    try:
        return float(os.environ.get("DBX_DECISIONS_REGRET_S", 1.0))
    except ValueError:
        return 1.0


def regret_window() -> int:
    """``DBX_DECISIONS_REGRET_N`` (default 32): consecutive scored
    decisions the regret EWMA must stay past the bar before the flight
    trigger fires (one noisy decision is not an incident)."""
    try:
        return max(int(os.environ.get("DBX_DECISIONS_REGRET_N", 32)), 1)
    except ValueError:
        return 32


#: Score-down multipliers for degraded-but-live workers. Stale frames
#: mean the residency/warmth evidence is old; a straggler flag means the
#: worker is measurably slow this window. Multiplicative on the total
#: cost so a degraded worker loses ties and close calls but still wins
#: when it is the only one holding the state — scored down, never
#: excluded (the round-20 liveness rule).
STALE_PENALTY = 4.0
STRAGGLER_PENALTY = 2.0

#: (family, bars, combos) -> model units, module-wide: the op-model walk
#: is the expensive third of a score and shapes repeat across jobs,
#: planes, and the take-path ctx builder. Plain dict on purpose — every
#: operation is a single GIL-atomic get/set, a racy miss merely
#: recomputes the same value, and the bound clears wholesale (shapes are
#: wire-controlled input; nothing may grow per shape ever seen).
_UNITS_MEMO_MAX = 512
_units_memo: dict = {}


def model_units(family: str, bars: int, combos: int) -> float:
    """Model units for one job shape via the shared op model
    (``obs/costmodel.py``), memoized module-wide; falls back to raw
    cell-bars when the family is unmodelable. Pure Python/math (the op
    model imports no accelerator code), so the take-path ctx builder
    may call it under the queue lock."""
    family = str(family)
    bars = max(int(bars), 1)
    combos = max(int(combos), 1)
    key = (family, bars, combos)
    units = _units_memo.get(key)
    if units is not None:
        return units
    try:
        units = costmodel._model_units(family, bars, combos)
    except Exception:
        units = 0.0
    if units <= 0.0 or not math.isfinite(units):
        units = float(bars) * float(combos)
    if len(_units_memo) >= _UNITS_MEMO_MAX:
        _units_memo.clear()
    _units_memo[key] = units
    return units


def placement_cost(*, units: float, spu: float, panel_b: int = 0,
                   frac: float = 1.0, carry_hit: bool = False,
                   resident: bool = False, family_warm: bool = True,
                   rate: float | None = None, cold: float | None = None,
                   penalty: float = 1.0) -> dict:
    """THE op-model stage-cost estimate for (job shape, worker state) —
    the single implementation both the shadow scorer and the live
    placement table price with (the round-20 single-source rule; no
    second copy in ``sched/``):

    - execute wall: model ``units`` x the worker's seconds-per-unit
      ``spu``, times the delta fraction ``frac`` on a carry-store hit
      (an append job on the base holder prices only the new bars);
    - transfer: ``panel_b`` over the nominal h2d/wire ``rate`` unless
      the panel is resident (a carry hit implies the base is);
    - compile: the cold wall unless the strategy family is warm there;
    - ``penalty``: the stale/straggler score-down multiplier.
    """
    if rate is None:
        rate = h2d_rate_bps()
    if cold is None:
        cold = compile_wall_s()
    exec_s = units * spu
    if carry_hit:
        exec_s *= frac
    resident = bool(resident or carry_hit)
    transfer_s = 0.0 if resident else panel_b / rate
    compile_s = 0.0 if family_warm else cold
    return {"cost_s": (exec_s + transfer_s + compile_s) * penalty,
            "exec_s": exec_s, "transfer_s": transfer_s,
            "compile_s": compile_s, "carry_hit": carry_hit,
            "resident": resident, "penalty": penalty}


def placement_ctx(rec) -> dict:
    """Per-job scoring context for :meth:`PlacementTable.rank`, built
    from a dispatcher ``JobRecord`` (duck-typed — only plain field
    reads). Cheap enough for the take path: one memoized op-model
    lookup plus arithmetic; bars unknown at dispatch are estimated from
    the base length (appends) or panel bytes (~40 B/bar, the DBX1
    float64 row) exactly like the shadow scorer's raw view."""
    family = str(rec.strategy)
    combos = max(int(rec.combos), 1)
    base = str(rec.append_parent or "")
    base_len = int(rec.append_base_len or 0)
    panel_b = len(rec.ohlcv) if rec.ohlcv is not None else 0
    bars = int((rec.scenario or {}).get("n_bars", 0) or 0)
    if bars <= 0:
        bars = base_len if base_len > 0 else max(panel_b // 40, 1)
    if panel_b <= 0:
        panel_b = bars * 40
    frac = 1.0
    if base:
        frac = (bars - base_len) / bars if bars > base_len > 0 else 0.25
        frac = min(max(frac, 1e-3), 1.0)
    return {"units": model_units(family, bars, combos),
            "family": family,
            "digest": str(rec.panel_digest or ""),
            "base_digest": base,
            "panel_b": int(panel_b),
            "frac": frac,
            "rate": h2d_rate_bps(),
            "cold": compile_wall_s()}


class PlacementTable:
    """One immutable locality score table: everything the live
    placement stage needs to rank a job across the fleet, pre-computed
    OFF the take lock on the plane's daemon tick
    (:meth:`DecisionPlane.refresh_placement_table`). The dispatcher's
    admit hook reads the latest table with a single attribute load and
    calls :meth:`rank` under the queue lock — pure dict/math work over
    this frozen state, no locks, no I/O, no fleet folds.

    Per-worker state: calibrated seconds-per-unit, the stale/straggler
    score-down ``penalty``, the telemetry residency sketch (12-hex
    prefixes), the dispatcher's delivered-digest set (ground truth —
    held by reference; membership reads are GIL-atomic and a racy read
    is at worst one poll stale), and the compile-warm family set.

    ``any_warmth``: before ANY completion has calibrated a family
    anywhere, family warmth is unknown — charging everyone the cold
    wall would only drown the residency terms a fresh fleet CAN know
    (delivered digests), so an uncalibrated table treats every worker
    as warm. Once any family is known, unknown workers pay cold."""

    __slots__ = ("workers", "built_s", "default_spu", "any_warmth")

    def __init__(self, workers: dict, *, built_s: float,
                 default_spu: float):
        self.workers = workers
        self.built_s = built_s
        self.default_spu = default_spu
        self.any_warmth = any(w["fams"] for w in workers.values())

    _DEFAULT_W = {"spu": None, "penalty": 1.0, "prefixes": frozenset(),
                  "delivered": (), "fams": frozenset(),
                  "stale": False, "stragglers": ()}

    def score(self, ctx: dict, wid: str) -> dict:
        """Expected stage cost of ``ctx``'s job on one worker, via the
        shared :func:`placement_cost` (cross-pinned against the shadow
        scorer by test)."""
        w = self.workers.get(wid, self._DEFAULT_W)
        spu = w["spu"] if w["spu"] is not None else self.default_spu
        delivered = w["delivered"]
        base = ctx["base_digest"]
        digest = ctx["digest"]
        carry_hit = bool(base) and (base in delivered
                                    or base[:12] in w["prefixes"])
        resident = bool(digest) and (digest in delivered
                                     or digest[:12] in w["prefixes"])
        warm = (ctx["family"] in w["fams"]) if self.any_warmth else True
        return placement_cost(
            units=ctx["units"], spu=spu, panel_b=ctx["panel_b"],
            frac=ctx["frac"], carry_hit=carry_hit, resident=resident,
            family_warm=warm, rate=ctx["rate"], cold=ctx["cold"],
            penalty=w["penalty"])

    def rank(self, ctx: dict, polling: str) -> tuple:
        """Score ``ctx`` on every table worker plus the polling worker
        (which may be absent from the table — a worker's very first
        poll predates any frame or delivery); returns
        ``(my_cost, best_wid, best_cost)`` with ties by sorted wid."""
        mine = None
        best_wid = None
        best = None
        wids = set(self.workers)
        wids.add(polling)
        for wid in sorted(wids):
            c = self.score(ctx, wid)
            if wid == polling:
                mine = c
            if best is None or c["cost_s"] < best["cost_s"]:
                best_wid, best = wid, c
        return mine, best_wid, best


class DecisionPlane:
    """Per-dispatcher decision recorder + shadow placement scorer.

    Construction wires nothing global: the owning ``Dispatcher`` passes
    its ``FleetView`` and closes the plane in its own ``close()``. The
    scoring thread starts lazily on the first submit (the flight
    recorder's ``_ensure_thread`` discipline)."""

    QUEUE_MAX = 64        # pending decision batches; beyond this they drop
    _COMPLETIONS_MAX = 4096   # pending calibration obs (one per job)
    _SPU_MAX = 256        # per-worker calibration entries (hostile ids)
    _FAM_MAX = 64         # families remembered per worker
    _PENDING_UNITS_MAX = 2048   # jid -> units awaiting completion

    def __init__(self, *, fleet=None, registry=None,
                 clock=time.monotonic):
        self._fleet = fleet
        self._reg = registry or get_registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        # Completion side lane: appended without waking the thread (the
        # serving loop completes one job per call; per-job wakeups are a
        # GIL tax on a small-core box), drained whenever the score queue
        # goes idle or on the 5s housekeeping tick.
        self._completions: collections.deque = collections.deque()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_capacity())
        self._wake = threading.Event()
        self._thread = None
        self._scoring = False
        self._closed = False
        # wid -> [n_obs, ewma seconds-per-model-unit]; completions feed
        # it (observe_completion), the shadow score reads it.
        self._spu: dict[str, list] = {}
        self._spu_global = [0, _DEFAULT_SPU]
        # wid -> set of strategy families completed there (compile-cache
        # hit proxy: first sighting pays the cold wall).
        self._fams: dict[str, set] = {}
        # jid -> (wid, family, model units) parked at scoring time so a
        # later completion can calibrate spu without re-deriving units.
        self._units_pending: "collections.OrderedDict" = \
            collections.OrderedDict()
        # Scoring-budget token bucket (score_rate): scoring-thread-only
        # state, no lock. Starts full (burst) so tests/short bursts are
        # never sampled.
        self._rate = score_rate()
        self._burst = max(self._rate, 32.0)
        self._tokens = self._burst
        self._t_refill = clock()
        # Live placement (round 20): armed by the owning dispatcher via
        # attach_placement; the daemon tick republishes _table (one
        # attribute swap — readers never lock) from the fleet view, the
        # dispatcher's delivered-digest callback, and the calibration
        # maps above.
        self._placement_armed = False
        self._delivered_fn = None
        self._table: PlacementTable | None = None
        self._n_scored = 0
        self._regret_sum = 0.0
        self._regret_ewma = 0.0
        self._regret_buckets = [0] * (len(REGRET_BUCKETS_S) + 1)
        self._hot_streak = 0
        self._agree = 0
        self._disagree = 0
        self._h_regret = self._reg.histogram(
            "dbx_dispatch_regret_seconds",
            help="shadow placement regret per dispatch decision: "
                 "cost(actual worker) - cost(best shadow candidate)",
            buckets=REGRET_BUCKETS_S)
        self._c_routes = {
            r: self._reg.counter(
                "dbx_decisions_total",
                help="dispatch decisions recorded, by payload route",
                route=r)
            for r in ROUTES + ("other",)}
        self._c_shadow = {
            o: self._reg.counter(
                "dbx_decisions_shadow_total",
                help="shadow scorer outcomes: did the actual placement "
                     "match the scorer's pick?",
                outcome=o)
            for o in ("agree", "disagree", "no_candidates")}
        self._c_dropped = {
            r: self._reg.counter(
                "dbx_decisions_dropped_total",
                help="decision batches/records not scored, by reason",
                reason=r)
            for r in ("queue_full", "closed", "error", "throttled")}

    # -- hot-path surface (dispatcher's RequestJobs) -------------------

    def want(self) -> bool:
        """Should the dispatcher bother recording the NEXT take()?
        True while the scoring budget (:func:`score_rate`) plausibly
        has a token. Read-only and lock-free — tokens are spent by
        :meth:`submit` on this same serving thread, so the estimate is
        exact between submits and a racy read is at worst one poll
        stale. This is the source-level throttle: an unarmed poll
        skips explain assembly, record tuples, and the submit
        entirely, so past the budget the hot path is byte-identical
        to the kill-switch path."""
        return (self._rate <= 0.0
                or self._tokens + (self._clock() - self._t_refill)
                * self._rate >= 1.0)

    def submit(self, batch: list, *, worker: str = "",
               t_take: float = 0.0) -> None:
        """Queue one take()'s decision records for async scoring.
        Items are either full raw dicts (tests, synthetic streams) or
        the dispatcher's deferred tuples ``(rec, route, digest,
        panel_b, wfq[, placement])`` — the record object plus the
        values only the dispatch loop knows, with ``worker``/``t_take``
        shared batch-wide. Tuple items cost the hot path one small allocation;
        the dict view is assembled on the scoring thread
        (:meth:`_raw_of`). The scoring budget is spent HERE, under the
        same lock the append needs anyway: records past the budget are
        dropped as ``throttled`` before they cost a queue slot, and
        the bucket state stays exact for :meth:`want`. Never raises,
        never blocks beyond that one small-lock crossing — the
        no-coordinator-on-the-hot-path bar applies verbatim."""
        if not batch:
            return
        if self._rate > 0.0:
            with self._lock:
                now = self._clock()
                self._tokens = min(
                    self._burst,
                    self._tokens + (now - self._t_refill) * self._rate)
                self._t_refill = now
                keep = min(len(batch), int(self._tokens))
                self._tokens -= keep
            if keep < len(batch):
                self._c_dropped["throttled"].inc(len(batch) - keep)
                if keep == 0:
                    return
                batch = batch[:keep]
        self._enqueue(("score", (list(batch), str(worker),
                                 float(t_take))), len(batch))

    def observe_completion(self, worker_id: str, jid: str,
                           elapsed_s: float) -> None:
        """Calibrate the per-worker seconds-per-unit EWMA from a real
        completion (measured end-to-end worker wall over the units the
        scorer parked for this jid) and mark the job's strategy family
        compile-warm on that worker. Completions ride a no-wake side
        lane the thread drains only once the score queue is idle — so a
        completion can never outrun its own decision's scoring, and the
        (per-job!) completion path never thrashes the scoring thread
        awake on a small-core box."""
        if elapsed_s <= 0.0:
            return
        self.observe_completions([(worker_id, jid, elapsed_s)])

    def observe_completions(self, batch: list[tuple]) -> None:
        """Batch form of :meth:`observe_completion` — one lock crossing
        for a whole CompleteJobs RPC's worth of ``(worker_id, jid,
        elapsed_s)`` tuples."""
        items = [(str(w), str(j), float(e)) for w, j, e in batch
                 if e > 0.0]
        if not items:
            return
        dropped = 0
        with self._lock:
            if self._closed:
                dropped = len(items)
            else:
                room = self._COMPLETIONS_MAX - len(self._completions)
                if room < len(items):
                    dropped = len(items) - max(room, 0)
                    items = items[:max(room, 0)]
                if items:
                    self._completions.extend(items)
                    self._ensure_thread()
        if dropped:
            self._c_dropped["queue_full"].inc(dropped)

    def _enqueue(self, item: tuple, weight: int) -> None:
        # No wake: the thread's own _TICK_S poll picks the batch up.
        # Event.set from the serving thread makes the scorer runnable
        # mid-RPC, and on a small-core box the forced context switch
        # costs the poll more than the whole record did; 50ms of
        # scoring latency costs telemetry nothing.
        drop = None
        with self._lock:
            if self._closed:
                drop = "closed"
            elif len(self._pending) >= self.QUEUE_MAX:
                drop = "queue_full"
            else:
                self._pending.append(item)
                self._ensure_thread()
        if drop is not None:
            self._c_dropped[drop].inc(weight)

    def _calibrate(self, worker_id: str, jid: str,
                   elapsed_s: float) -> None:
        with self._lock:
            hit = self._units_pending.pop(jid, None)
            if hit is None:
                return
            _, family, units = hit
            if units <= 0.0:
                return
            spu = elapsed_s / units
            per_worker = self._spu.get(worker_id)
            if per_worker is None:
                if len(self._spu) < self._SPU_MAX:
                    per_worker = self._spu[worker_id] = [
                        0, self._spu_global[1]]
                else:
                    per_worker = self._spu_global  # hostile-id cap
            cals = [per_worker]
            if per_worker is not self._spu_global:
                cals.append(self._spu_global)
            for cal in cals:
                n, ewma = cal
                cal[0] = n + 1
                cal[1] = spu if n == 0 else (
                    _SPU_ALPHA * spu + (1.0 - _SPU_ALPHA) * ewma)
            fams = self._fams.setdefault(worker_id, set())
            if len(fams) < self._FAM_MAX:
                fams.add(family)

    # -- live placement table (round 20) -------------------------------

    #: A table older than this is not served to the take path: a wedged
    #: scorer thread must degrade placement to pure WFQ, never freeze a
    #: view of a fleet that has moved on.
    TABLE_MAX_AGE_S = 2.0

    def attach_placement(self, delivered_fn=None) -> None:
        """Arm the live placement table: the daemon tick (the same 50 ms
        cadence that scores shadow batches) starts rebuilding the score
        table from the fleet's ``placement_view()`` export, the
        dispatcher's delivered-digest ground truth (``delivered_fn`` ->
        ``{wid: set-of-digests}``, sets held by REFERENCE — membership
        reads are GIL-atomic and at worst one poll stale), and this
        plane's spu/family calibration. Called once by the owning
        dispatcher while ``DBX_PLACEMENT`` is live; idempotent."""
        # Prime the op model's lazy tune.autotune import HERE, off every
        # lock: the take-path ctx builder calls model_units under the
        # queue lock, and a first-call import there would nest the
        # interpreter's import machinery inside it.
        model_units("sma_crossover", 2, 1)
        with self._lock:
            if self._closed:
                return
            self._delivered_fn = delivered_fn
            self._placement_armed = True
            self._ensure_thread()

    def refresh_placement_table(self) -> "PlacementTable":
        """Build and publish a fresh placement table NOW — the daemon
        tick's body, also the deterministic hook tests and bench call
        directly. Runs entirely off the take lock: one fleet fold, one
        delivered-map read, one pass over the calibration maps. The
        worker universe is fleet-view ∪ delivered-map: a worker with no
        telemetry frame (raw pollers, fresh fleets) still places by the
        dispatcher's own delivery ground truth."""
        view: dict = {}
        if self._fleet is not None:
            try:
                view = self._fleet.placement_view()
            except Exception:
                view = {}
        delivered: dict = {}
        fn = self._delivered_fn
        if fn is not None:
            try:
                delivered = fn() or {}
            except Exception:
                delivered = {}
        with self._lock:
            spu_of = {w: cal[1] for w, cal in self._spu.items()}
            default_spu = self._spu_global[1]
            fams = {w: frozenset(f) for w, f in self._fams.items()}
        workers = {}
        for wid in sorted(set(view) | set(delivered)):
            v = view.get(wid) or {}
            stale = bool(v.get("stale"))
            stragglers = tuple(v.get("stragglers") or ())
            penalty = 1.0
            if stale:
                penalty *= STALE_PENALTY
            if stragglers:
                penalty *= STRAGGLER_PENALTY
            workers[wid] = {
                "spu": spu_of.get(wid, default_spu),
                "penalty": penalty,
                "prefixes": frozenset(v.get("resident") or ()),
                "delivered": delivered.get(wid) or (),
                "fams": fams.get(wid, frozenset()),
                "stale": stale,
                "stragglers": stragglers,
            }
        table = PlacementTable(workers, built_s=self._clock(),
                               default_spu=default_spu)
        self._table = table
        return table

    def placement_table(self, max_age_s: float | None = None):
        """The latest placement table, or ``None`` when placement is
        unarmed, nothing has been built yet, or the builder has not
        ticked within ``max_age_s`` (degrade to pure WFQ). Lock-free:
        one attribute load plus a clock read."""
        t = self._table
        if t is None:
            return None
        bound = self.TABLE_MAX_AGE_S if max_age_s is None else max_age_s
        if self._clock() - t.built_s > bound:
            return None
        return t

    # -- scoring thread ------------------------------------------------

    def _ensure_thread(self) -> None:
        # Called under self._lock.
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="dbx-decisions", daemon=True)
            self._thread.start()

    _TICK_S = 0.05   # scoring-thread poll cadence (no hot-path wakes)

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self._TICK_S)
            self._wake.clear()
            if self._placement_armed and not self._closed:
                # Live placement table refresh rides the same tick the
                # shadow scorer wakes on — "off the take lock" is this
                # thread, one attribute swap publishes the result.
                try:
                    self.refresh_placement_table()
                except Exception:
                    self._c_dropped["error"].inc()
            while True:
                completions = None
                payload = None
                with self._lock:
                    if self._closed:
                        return
                    if self._pending:
                        _op, payload = self._pending.popleft()
                        self._scoring = True
                    elif self._completions:
                        # Score queue idle: every decision enqueued
                        # before these completions has been scored (or
                        # dropped), so calibration can't outrun it.
                        completions = tuple(self._completions)
                        self._completions.clear()
                        self._scoring = True
                    else:
                        break
                try:
                    if payload is not None:
                        self._score_batch(payload)
                    else:
                        # One lock to discard completions the scorer
                        # never parked units for (throttled/unscored
                        # jobs — most of them under load).
                        with self._lock:
                            completions = [
                                c for c in completions
                                if c[1] in self._units_pending]
                        for comp in completions:
                            self._calibrate(*comp)
                except Exception:
                    self._c_dropped["error"].inc()
                finally:
                    with self._lock:
                        self._scoring = False

    @staticmethod
    def _raw_of(item, worker: str, t_take: float) -> dict:
        """Dict view of one submitted item — a raw dict verbatim, or
        the dispatcher's deferred ``(rec, route, digest, panel_b,
        wfq[, placement])`` tuple expanded from the job record's own
        fields HERE, on the scoring thread, so the take path never
        builds it. The optional 6th element is the live placement
        verdict the round-20 admit hook stashed for this job."""
        if isinstance(item, dict):
            return dict(item)
        rec, route, digest, panel_b, wfq = item[:5]
        placement = item[5] if len(item) > 5 else None
        return {
            **({"placement": placement} if placement else {}),
            "jid": rec.id, "trace_id": rec.trace_id,
            "worker": worker, "tenant": rec.tenant,
            "strategy": rec.strategy, "combos": float(rec.combos),
            "affinity_skips": int(rec.affinity_skips),
            "wfq": wfq, "digest": digest, "panel_b": int(panel_b),
            "append_parent": rec.append_parent,
            "base_len": int(rec.append_base_len),
            "bars": int((rec.scenario or {}).get("n_bars", 0)),
            "route": route, "t_take": t_take,
        }

    def _score_batch(self, payload) -> None:
        # Throttling happened at submit(); everything queued is scored.
        batch, worker, t_take = payload
        snap = None   # (workers, spu_of, spu_default, fams) per batch
        for item in batch:
            if snap is None:
                workers = {}
                if self._fleet is not None:
                    try:
                        workers = self._fleet.snapshot().get("workers",
                                                             {})
                    except Exception:
                        workers = {}
                delivered = {}
                if self._delivered_fn is not None:
                    try:
                        delivered = self._delivered_fn() or {}
                    except Exception:
                        delivered = {}
                with self._lock:
                    spu_of = {w: cal[1] for w, cal in self._spu.items()}
                    spu_default = self._spu_global[1]
                    fams = {w: set(f) for w, f in self._fams.items()}
                snap = (workers, spu_of, spu_default, fams, delivered)
            try:
                rec = self._score_one(self._raw_of(item, worker, t_take),
                                      *snap)
            except Exception:
                self._c_dropped["error"].inc()
                continue
            with self._lock:
                self._ring.append(rec)
            events.emit_record({"ev": "decision", **rec})

    @staticmethod
    def _resident(wentry: dict, digest: str) -> bool:
        """Panel residency by the worker's top-K digest sketch (the
        telemetry frame's ``caches.panel_topk`` 12-hex prefixes)."""
        if not digest:
            return False
        topk = (wentry.get("caches") or {}).get("panel_topk") or ()
        prefix = digest[:12]
        return any(str(e.get("d", "")) == prefix for e in topk
                   if isinstance(e, dict))

    def _units_for(self, raw: dict) -> tuple[float, str]:
        """Model units for this job via the shared module-wide memo
        (:func:`model_units`). Bars not known at dispatch are estimated
        from the full panel byte size (DBX1 ~ 5 float64 columns =>
        ~40 B/bar)."""
        family = str(raw.get("strategy", ""))
        combos = max(int(raw.get("combos", 0) or 0), 1)
        bars = int(raw.get("bars", 0) or 0)
        if bars <= 0:
            bars = max(int(int(raw.get("panel_b", 0) or 0) / 40), 1)
        return model_units(family, bars, combos), family

    def _score_one(self, raw: dict, workers: dict, spu_of: dict,
                   spu_default: float, fams: dict,
                   delivered: dict | None = None) -> dict:
        actual = str(raw.get("worker", ""))
        route = route_bucket(str(raw.get("route", "")))
        self._c_routes[route].inc()
        units, family = self._units_for(raw)
        digest = str(raw.get("digest", ""))
        base_digest = str(raw.get("append_parent", ""))
        panel_b = int(raw.get("panel_b", 0) or 0)
        # Delta fraction: the share of the sweep an append carry-hit
        # still has to price (new bars over total). Unknown => 0.25.
        frac = 1.0
        if base_digest:
            bars = int(raw.get("bars", 0) or 0)
            base_len = int(raw.get("base_len", 0) or 0)
            frac = ((bars - base_len) / bars
                    if bars > base_len > 0 else 0.25)
            frac = min(max(frac, 1e-3), 1.0)
        rate = h2d_rate_bps()
        cold = compile_wall_s()
        delivered = delivered or {}

        def score(wid: str, wentry: dict) -> dict:
            dlv = delivered.get(wid) or ()
            carry_hit = False
            if base_digest:
                # Carry-hit vs reprice: ground truth for the actual
                # worker (a delta route means the dispatcher verified
                # the base is held) and for any delivered-set holder;
                # the digest sketch for the rest of the shadows.
                carry_hit = (wid == actual and route == "delta") or \
                    self._resident(wentry, base_digest) or \
                    base_digest in dlv
            resident = (wid == actual and route in
                        ("digest_only", "delta", "scenario")) or \
                self._resident(wentry, digest) or \
                (bool(digest) and digest in dlv)
            # Degraded-but-live workers are scored down, never dropped
            # from the candidate set (the round-20 liveness rule).
            penalty = 1.0
            if wentry.get("stale"):
                penalty *= STALE_PENALTY
            if wentry.get("stragglers"):
                penalty *= STRAGGLER_PENALTY
            return placement_cost(
                units=units, spu=spu_of.get(wid, spu_default),
                panel_b=panel_b, frac=frac, carry_hit=carry_hit,
                resident=resident,
                family_warm=family in fams.get(wid, ()),
                rate=rate, cold=cold, penalty=penalty)

        candidates = dict(workers)
        for wid in delivered:
            candidates.setdefault(wid, {})
        if actual and actual not in candidates:
            candidates[actual] = {}
        scored = {wid: score(wid, e) for wid, e in
                  sorted(candidates.items())}
        shadow: dict = {"candidates": len(scored)}
        regret = None
        if scored:
            actual_cost = scored.get(actual, {}).get("cost_s")
            best = min(scored, key=lambda w: (scored[w]["cost_s"], w))
            if actual_cost is not None and \
                    actual_cost <= scored[best]["cost_s"]:
                best = actual   # ties go to the placement that happened
            shadow["best"] = best
            shadow["best_cost_s"] = round(scored[best]["cost_s"], 9)
            if actual_cost is not None:
                regret = max(actual_cost - scored[best]["cost_s"], 0.0)
                shadow["actual_cost_s"] = round(actual_cost, 9)
                shadow["regret_s"] = round(regret, 9)
                shadow["agree"] = best == actual
            # Bounded per-candidate breakdown: cheapest 8, always
            # including the actual worker.
            keep = sorted(scored, key=lambda w: (scored[w]["cost_s"], w))
            keep = list(dict.fromkeys(keep[:8] + [actual]))
            shadow["costs"] = {
                w: {k: (round(v, 9) if isinstance(v, float) else v)
                    for k, v in scored[w].items()}
                for w in keep if w in scored}
        age = workers.get(actual, {}).get("age_s")
        rec = {
            "jid": str(raw.get("jid", "")),
            "trace_id": str(raw.get("trace_id", "")),
            "worker": actual,
            "tenant": str(raw.get("tenant", "")),
            "route": route,
            "strategy": family,
            "combos": int(raw.get("combos", 0) or 0),
            "affinity_skips": int(raw.get("affinity_skips", 0) or 0),
            "fleet_age_s": age,
            "units": round(units, 3),
            "shadow": shadow,
            "t_take": float(raw.get("t_take", 0.0)),
        }
        placement = raw.get("placement")
        if placement:
            # The live placement verdict the admit hook stashed at
            # take time (round 20): chosen-vs-best worker, score gap,
            # defers spent. Shadow ranking above stays independent —
            # dual mode is the point (regret validates the policy).
            rec["placement"] = dict(placement)
        wfq = raw.get("wfq")
        if wfq is not None:
            # take() hands back live PickExplain objects; serializing
            # them (sort + round per pick) happens HERE, off the take
            # path. held_explain entries are already plain dicts.
            rec["wfq"] = (wfq.as_dict()
                          if hasattr(wfq, "as_dict") else wfq)
        self._account(rec, regret, family, units)
        return rec

    def _account(self, rec: dict, regret, family: str,
                 units: float) -> None:
        fire = None
        with self._lock:
            self._n_scored += 1
            jid = rec["jid"]
            if jid and units > 0.0:
                while len(self._units_pending) >= self._PENDING_UNITS_MAX:
                    self._units_pending.popitem(last=False)
                self._units_pending[jid] = (rec["worker"], family, units)
            if regret is None:
                self._c_shadow["no_candidates"].inc()
                return
            if rec["shadow"].get("agree"):
                self._agree += 1
            else:
                self._disagree += 1
            self._regret_sum += regret
            self._regret_ewma = (
                regret if self._n_scored == 1 else
                _REGRET_ALPHA * regret
                + (1.0 - _REGRET_ALPHA) * self._regret_ewma)
            i = 0
            while (i < len(REGRET_BUCKETS_S)
                   and regret > REGRET_BUCKETS_S[i]):
                i += 1
            self._regret_buckets[i] += 1
            if self._regret_ewma > regret_bar_s():
                self._hot_streak += 1
                if self._hot_streak >= regret_window():
                    fire = (rec["worker"], self._regret_ewma)
                    self._hot_streak = 0
            else:
                self._hot_streak = 0
        self._h_regret.observe(regret)
        self._c_shadow["agree" if rec["shadow"].get("agree")
                       else "disagree"].inc()
        if fire is not None:
            from . import flight

            flight.trigger(
                "regret", subject=fire[0],
                regret_ewma_s=round(fire[1], 4),
                window=regret_window(), bar_s=regret_bar_s())

    # -- read surface --------------------------------------------------

    def recent(self, n: int | None = None) -> list[dict]:
        """Newest-last tail of the decision ring."""
        with self._lock:
            if n is None or n >= len(self._ring):
                return list(self._ring)
            return list(self._ring)[len(self._ring) - n:]

    def snapshot(self, tail: int = 32) -> dict:
        """The ``/decisions.json`` document (and the flight recorder's
        ``decisions`` source): aggregate regret/agreement plus the
        record tail."""
        with self._lock:
            n = self._n_scored
            agree, disagree = self._agree, self._disagree
            buckets = list(self._regret_buckets)
            scored = sum(buckets)
            doc = {
                "enabled": enabled(),
                "n_scored": n,
                "ring": len(self._ring),
                "regret": {
                    "n": scored,
                    "sum_s": round(self._regret_sum, 9),
                    "ewma_s": round(self._regret_ewma, 9),
                    "p50_s": round(histogram_quantile(
                        buckets, REGRET_BUCKETS_S, 0.5), 9),
                    "p95_s": round(histogram_quantile(
                        buckets, REGRET_BUCKETS_S, 0.95), 9),
                },
                "calibrated_workers": len(self._spu),
                "recent": list(self._ring)[-max(tail, 0):],
            }
            table = self._table
            doc["placement"] = {
                "live": sched_placement.enabled(),
                "armed": self._placement_armed,
                "defer_cap": sched_placement.defer_cap(),
                "table": ({"workers": len(table.workers),
                           "age_s": round(max(
                               self._clock() - table.built_s, 0.0), 3)}
                          if table is not None else None),
            }
        judged = agree + disagree
        doc["agreement"] = {
            "agree": agree, "disagree": disagree,
            "pct": round(100.0 * agree / judged, 2) if judged else 0.0}
        return doc

    # -- lifecycle -----------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for queued batches to score (tests / bench)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if (not self._pending and not self._completions
                        and not self._scoring):
                    return True
            self._wake.set()   # completions don't wake the thread
            time.sleep(0.005)
        return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._pending.clear()
            self._completions.clear()
        self._wake.set()
