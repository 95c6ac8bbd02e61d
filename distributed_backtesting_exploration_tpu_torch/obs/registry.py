"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

A copy of the reference's ``obs/registry.py`` (which imports no JAX; the
port may not import the reference package), held to its outputs by
``tests/test_torch_obs_registry.py``. The port's tune layer counts into it.

The observability substrate every layer records into (dispatcher RPC
latencies, worker batch spans, kernel wall-times). Design constraints, in
order:

- **Lock-cheap hot path.** A counter increment is one ``threading.Lock``
  acquire + a float add; a histogram observation adds one bisect. Callers
  on hot paths (per-RPC, per-batch) pre-resolve their metric objects once
  and hold direct references — name/label resolution never happens per
  event. Measured <2 µs per observation, which keeps the dispatcher's
  direct-dispatch ceiling (~16 ms per batch-32 RPC) well under the 2%
  instrumentation budget.
- **No external deps.** Renders the Prometheus text exposition format
  (v0.0.4) itself; no client library.
- **Pull-friendly.** Gauges that mirror existing state (queue depth, channel
  occupancy) register as callbacks/collectors evaluated at scrape time, so
  steady-state cost is zero when nobody is looking.
"""

from __future__ import annotations

import bisect
import math
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default histogram buckets: wall-clock seconds from 50 µs (a queue state
# transition) to 30 s (a cold jit compile), roughly x2.5 per step.
LATENCY_BUCKETS_S = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_help(text: str) -> str:
    """HELP-line escaping (exposition format v0.0.4): backslash and
    newline only — a raw newline would terminate the HELP line mid-text
    and feed the remainder to the scraper as a garbage sample line."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _render_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in pairs)
    return "{" + body + "}"


class Counter:
    """Monotonic float counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Instantaneous value; ``set`` or a scrape-time callback."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn=None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        # Under the lock like inc/dec (dbxlint lock-discipline): a set
        # racing an inc on another thread must not lose the increment to
        # a stale read-modify-write interleaving.
        with self._lock:
            self._value = float(v)

    def set_fn(self, fn) -> None:
        """Evaluate ``fn()`` at scrape time instead of a stored value."""
        self._fn = fn

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return math.nan
        return self._value


def histogram_quantile(counts, bounds, q: float,
                       upper: float | None = None) -> float:
    """Rank-interpolated quantile over per-bucket counts — the ONE
    scrape-side estimate, shared by :class:`Histogram` and the fleet
    telemetry fold (obs.fleet), whose wire-form frames carry the same
    per-bucket counts over the same bounds. ``upper`` bounds the
    overflow (+inf) bucket: a tracked max when the caller has one,
    ``None`` caps at the last finite bound (a merged wire histogram has
    no max to offer)."""
    count = sum(counts)
    if not count:
        return 0.0
    rank = q * count
    acc = 0
    lo = 0.0
    for i, c in enumerate(counts):
        if acc + c >= rank:
            if i < len(bounds):
                hi = bounds[i]
            else:
                hi = upper if upper is not None else lo
            if c == 0:
                return hi
            return lo + (hi - lo) * (rank - acc) / c
        acc += c
        if i < len(bounds):
            lo = bounds[i]
    return upper if upper is not None else lo


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` buckets, Prometheus-style).

    Tracks count, sum, max, and per-bucket counts. Quantiles in
    :meth:`summary` are estimated by linear interpolation inside the
    bucket that crosses the rank — the standard scrape-side estimate,
    computed here so ``stats()``/JSON consumers need no PromQL.
    """

    __slots__ = ("_lock", "buckets", "_counts", "count", "sum", "max")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)   # +inf bucket last
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v

    def _quantile(self, counts, q: float, count: int, mx: float) -> float:
        # counts must be a locked snapshot (count/mx ride along for the
        # callers' convenience; the shared estimator re-derives the
        # total from the same snapshot). `mx or None`: a zero max means
        # nothing real landed in the overflow bucket — cap at the last
        # finite bound like the wire-form fold does.
        return histogram_quantile(counts, self.buckets, q,
                                  upper=mx or None)

    def summary(self) -> dict:
        """JSON-able digest: count/sum/avg/max + estimated p50/p90/p99."""
        with self._lock:
            counts = list(self._counts)
            count, total, mx = self.count, self.sum, self.max
        if not count:
            return {"count": 0, "sum": 0.0}
        out = {"count": count, "sum": round(total, 9),
               "avg": round(total / count, 9), "max": round(mx, 9)}
        for q, name in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[name] = round(self._quantile(counts, q, count, mx), 9)
        return out

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le_bound, cumulative_count), ...] ending with (+inf, count)."""
        with self._lock:
            counts = list(self._counts)
        out = []
        acc = 0
        for bound, c in zip(self.buckets, counts):
            acc += c
            out.append((bound, acc))
        out.append((math.inf, acc + counts[-1]))
        return out


class _Family:
    """One metric name: kind, help text, and children keyed by label set."""

    __slots__ = ("kind", "help", "buckets", "children")

    def __init__(self, kind: str, help: str, buckets=None):
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: dict[tuple, object] = {}


class Registry:
    """Named metric families with label-keyed children.

    ``counter``/``gauge``/``histogram`` are get-or-create and return the
    child object directly — hold the reference on hot paths. Collectors
    (``add_collector``) run once per render/snapshot to refresh gauges
    that mirror external state.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._collectors: dict[str, object] = {}

    # -- construction ------------------------------------------------------

    def _child(self, kind: str, name: str, help: str, labels: dict,
               factory, buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in labels:
            if not _LABEL_RE.match(str(k)):
                raise ValueError(f"invalid label name {k!r}")
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind, help, buckets)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = factory()
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, help, labels, Gauge)

    def gauge_fn(self, name: str, fn, help: str = "", **labels) -> Gauge:
        """Gauge whose value is ``fn()`` at scrape time (replaces any
        previous callback on the same name+labels — re-registration is how
        a restarted component takes over its gauge)."""
        g = self.gauge(name, help, **labels)
        g.set_fn(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS_S, **labels) -> Histogram:
        return self._child("histogram", name, help, labels,
                           lambda: Histogram(buckets), buckets)

    def peek(self, name: str, **labels):
        """Read one labeled counter/gauge value WITHOUT creating it
        (None when the family or child does not exist, AND for
        histogram children — a histogram has no single value; use
        its ``summary()`` via the family accessor instead) — the
        read-only probe for consumers (the fleet telemetry frame) that
        must not mint zero-valued series on processes that never
        recorded them."""
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            child = fam.children.get(key) if fam is not None else None
        if child is None:
            return None
        return child.value if not isinstance(child, Histogram) else None

    def remove_child(self, name: str, **labels) -> None:
        """Drop one labeled child (and its family once empty) — lifecycle
        hygiene for per-instance label sets (e.g. per-worker gauges) in
        long-lived processes that construct many instances."""
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return
            fam.children.pop(key, None)
            if not fam.children:
                del self._families[name]

    def add_collector(self, key: str, fn) -> None:
        """Run ``fn(registry)`` once per render/snapshot, BEFORE reading
        metrics — the hook for refreshing gauges that mirror external
        state (queue depth, channel occupancy). Keyed so a restarted
        component replaces its predecessor instead of stacking stale
        closures."""
        with self._lock:
            self._collectors[key] = fn

    def remove_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    # -- reading -----------------------------------------------------------

    def _run_collectors(self) -> None:
        with self._lock:
            items = list(self._collectors.items())
        for key, fn in items:
            with self._lock:
                # Skip collectors removed since the snapshot: a component
                # tearing down mid-scrape must not have its collector run
                # after its cleanup.
                if self._collectors.get(key) is not fn:
                    continue
            try:
                fn(self)
            except Exception:
                pass   # a dead component's collector must not kill scrapes

    def _families_snapshot(self) -> list:
        """(name, kind, help, children-items) copied under the lock: a
        worker thread first-observing a new label set mid-scrape must not
        blow up the iteration (dict-changed-size)."""
        with self._lock:
            return [(name, fam.kind, fam.help,
                     sorted(fam.children.items()))
                    for name, fam in sorted(self._families.items())]

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        self._run_collectors()
        lines: list[str] = []
        for name, kind, help_, children in self._families_snapshot():
            if help_:
                lines.append(f"# HELP {name} {_escape_help(help_)}")
            lines.append(f"# TYPE {name} {kind}")
            for key, child in children:
                if kind == "histogram":
                    for bound, acc in child.cumulative():
                        le = "+Inf" if math.isinf(bound) else repr(bound)
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(key, (('le', le),))} {acc}")
                    lines.append(
                        f"{name}_sum{_render_labels(key)} {child.sum}")
                    lines.append(
                        f"{name}_count{_render_labels(key)} {child.count}")
                else:
                    v = child.value
                    lines.append(f"{name}{_render_labels(key)} {v}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Full JSON-able state: every family, every labeled child.

        Counters/gauges map to values; histograms to :meth:`summary`
        digests. Child keys render as ``name`` or ``name{k=v,...}``.
        """
        self._run_collectors()
        out: dict = {}
        for name, kind, _help, children in self._families_snapshot():
            entry: dict = {}
            for key, child in children:
                label = ",".join(f"{k}={v}" for k, v in key)
                if kind == "histogram":
                    entry[label] = child.summary()
                else:
                    entry[label] = child.value
            out[name] = {"type": kind, "values": entry}
        return out

    def summaries(self, prefix: str = "") -> dict:
        """Compact digest for the wire (GetStats ``obs_json``): flat
        ``name{labels}`` keys, values for counters/gauges, summary dicts
        for histograms. ``prefix`` filters by metric-name prefix."""
        snap = self.snapshot()
        out: dict = {}
        for name, fam in snap.items():
            if prefix and not name.startswith(prefix):
                continue
            for label, v in fam["values"].items():
                key = f"{name}{{{label}}}" if label else name
                out[key] = v
        return out


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-global default registry."""
    return _REGISTRY
