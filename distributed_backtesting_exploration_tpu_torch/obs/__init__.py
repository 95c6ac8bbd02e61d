"""Observability of the port: the reference's ``obs/`` layer.

- :mod:`.registry` — process-local counters / gauges / fixed-bucket
  histograms, rendered as Prometheus text or JSON summaries;
- :mod:`.trace` — the span API (phase attribution + nesting + the
  distributed ``trace_id``/``span_id``/``parent_id`` triple), ``timed``,
  ``StepTimer``, ``device_profile`` (``torch.profiler``);
- :mod:`.events` — opt-in JSONL event log (``DBX_OBS_JSONL``) for
  post-mortem trace reconstruction;
- :mod:`.http` — the ``/metrics`` + ``/stats.json`` HTTP surface;
- :mod:`.dump` — ``python -m ...obs.dump`` pretty-printer / phase table;
- :mod:`.why` — ``python -m ...obs.why``: a job's dispatch decisions
  beside its timeline;
- :mod:`.timeline` — merge JSONL logs from any number of processes into
  per-job lifecycle timelines with critical-path stage attribution;
- :mod:`.flight`, :mod:`.costmodel`, :mod:`.fleet`, :mod:`.decisions` —
  the dispatcher's planes: the flight recorder, the cost model's
  residuals, the fleet view and the scheduling-decision records.

Each module is a copy of the reference's, held to its outputs by the
``tests/test_torch_obs_*.py`` tests. The tune layer, the dispatcher, the
worker and its backend count into :func:`get_registry`;
``utils.trace`` is the reference's deprecation shim over :mod:`.trace`.
"""

from . import events  # noqa: F401
from .http import MetricsServer, start_metrics_server  # noqa: F401
from .registry import (  # noqa: F401
    LATENCY_BUCKETS_S, Counter, Gauge, Histogram, Registry,
    histogram_quantile, get_registry)
from .trace import (  # noqa: F401
    StepTimer, add_span_listener, configure_ring, current_span,
    current_trace, device_profile, emit_span, job_trace_pairs, new_span_id,
    new_trace_id, recent_spans, remove_span_listener, span, timed, timer,
    trace_context)
