"""Observability of the port: the process-local metrics registry only.

:mod:`.registry` is the reference's ``obs/registry.py`` (counters, gauges,
fixed-bucket histograms, Prometheus text and JSON summaries). The tune
layer (:mod:`..tune`) counts into :func:`get_registry`. The reference's
spans, event log, HTTP surface and fleet telemetry have no port yet; the
backend's own counts stay plain attributes that its ``stats()`` returns.
"""

from .registry import (  # noqa: F401
    LATENCY_BUCKETS_S, Counter, Gauge, Histogram, Registry,
    histogram_quantile, get_registry)
