"""The port's metrics registry (``obs/registry.py``) against the reference's:
the same operations give the same Prometheus text, snapshot and summaries.

The port's module is a copy (the port may not import the reference
package); these tests pin it to the reference's outputs.
"""

import math

import pytest

from distributed_backtesting_exploration_tpu.obs import registry as ref_reg
from distributed_backtesting_exploration_tpu_torch import obs
from distributed_backtesting_exploration_tpu_torch.obs import registry


def _drive(mod):
    """One sequence of operations on a fresh registry of module ``mod``."""
    reg = mod.Registry()
    c = reg.counter("dbx_jobs_total", help="jobs\nserved \\ done",
                    outcome="ok")
    c.inc()
    c.inc(2.5)
    reg.counter("dbx_jobs_total", outcome='bad "quoted"\nline').inc(4)
    g = reg.gauge("dbx_depth", help="queue depth", queue="a")
    g.set(7)
    g.inc(3)
    g.dec(1.5)
    reg.gauge_fn("dbx_live", lambda: 42, help="live", scope="local")
    reg.gauge_fn("dbx_broken", lambda: 1 / 0, help="raises")
    h = reg.histogram("dbx_latency_seconds", help="latency", rpc="Fetch")
    for v in (0.00003, 0.0004, 0.002, 0.002, 0.04, 0.7, 3.0, 45.0):
        h.observe(v)
    reg.histogram("dbx_small", buckets=(1.0, 2.0, 5.0)).observe(1.5)
    reg.histogram("dbx_empty", help="never observed")
    reg.counter("dbx_gone_total", who="x").inc()
    reg.remove_child("dbx_gone_total", who="x")
    reg.counter("dbx_kept_total", who="y").inc()
    reg.counter("dbx_kept_total", who="z").inc(2)
    reg.remove_child("dbx_kept_total", who="y")

    def collect(r):
        r.gauge("dbx_collected", help="by a collector").set(11)
    reg.add_collector("c1", collect)
    reg.add_collector("dead", lambda r: 1 / 0)
    return reg


@pytest.fixture(scope="module")
def both():
    return _drive(ref_reg), _drive(registry)


def test_render_prometheus_is_the_references(both):
    ref, port = both
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert 'outcome="bad \\"quoted\\"\\nline"' in text
    assert "# HELP dbx_jobs_total jobs\\nserved \\\\ done" in text
    assert "dbx_broken NaN" in text or "dbx_broken nan" in text


def test_snapshot_and_summaries_are_the_references(both):
    ref, port = both
    a, b = ref.snapshot(), port.snapshot()
    nan = b["dbx_broken"]["values"].pop("")
    assert math.isnan(nan) and math.isnan(a["dbx_broken"]["values"].pop(""))
    assert a == b
    sa, sb = ref.summaries("dbx_l"), port.summaries("dbx_l")
    assert sa == sb and set(sb) == {
        "dbx_latency_seconds{rpc=Fetch}", "dbx_live{scope=local}"}
    assert "dbx_gone_total" not in b
    assert set(b["dbx_kept_total"]["values"]) == {"who=z"}


def test_peek_and_quantiles_are_the_references(both):
    ref, port = both
    for args in (("dbx_jobs_total",), ("dbx_depth",), ("dbx_latency_seconds",),
                 ("dbx_missing",)):
        for labels in ({}, {"outcome": "ok"}, {"queue": "a"},
                       {"rpc": "Fetch"}):
            assert port.peek(*args, **labels) == ref.peek(*args, **labels)
    assert port.peek("dbx_jobs_total", outcome="ok") == 3.5
    counts, bounds = [0, 3, 1, 0, 2], (0.1, 0.5, 1.0, 2.0)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        for upper in (None, 7.0):
            assert registry.histogram_quantile(counts, bounds, q, upper) == \
                ref_reg.histogram_quantile(counts, bounds, q, upper)
    assert registry.histogram_quantile([0, 0], (1.0,), 0.5) == 0.0


@pytest.mark.parametrize("bad", [
    lambda r: r.counter("9bad"),
    lambda r: r.counter("dbx_x_total", **{"bad-label": "v"}),
    lambda r: (r.counter("dbx_dup"), r.gauge("dbx_dup")),
    lambda r: r.counter("dbx_neg_total").inc(-1),
    lambda r: r.histogram("dbx_h", buckets=()),
], ids=["name", "label", "kind", "negative", "buckets"])
def test_invalid_use_raises_as_in_the_reference(bad):
    with pytest.raises(ValueError):
        bad(ref_reg.Registry())
    with pytest.raises(ValueError):
        bad(registry.Registry())


def test_package_exports_and_global_registry():
    assert obs.get_registry() is registry.get_registry()
    assert isinstance(obs.get_registry(), obs.Registry)
    assert obs.LATENCY_BUCKETS_S == ref_reg.LATENCY_BUCKETS_S
    for name in ("Counter", "Gauge", "Histogram", "histogram_quantile"):
        assert getattr(obs, name) is getattr(registry, name)
    # The control plane's spans, events and HTTP surface: the reference
    # package's export list.
    from distributed_backtesting_exploration_tpu import obs as ref_obs
    from distributed_backtesting_exploration_tpu_torch.obs import trace

    for name in ("events", "MetricsServer", "start_metrics_server",
                 "LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram",
                 "Registry", "get_registry", "StepTimer",
                 "add_span_listener", "configure_ring", "current_span",
                 "current_trace", "device_profile", "emit_span",
                 "job_trace_pairs", "new_span_id", "new_trace_id",
                 "recent_spans", "remove_span_listener", "span", "timed",
                 "timer", "trace_context"):
        assert hasattr(ref_obs, name) and hasattr(obs, name), name
    assert obs.span is trace.span
