"""Serving observability: span tracing and typed metrics. Twin of
``repro/serving/observe`` without ``audit_cost_drift``, which compares a
head's cataloged cost with compiled XLA HLO (ROADMAP.md, Queue 1 item 8:
the port's audit would compare against profiler / CUDA-event times).

* ``Tracer`` / ``NullTracer`` — per-request span timeline on the
  scheduler's injectable clock, exportable as Chrome trace-event JSON
  (``chrome://tracing`` / Perfetto) or JSONL.
* ``MetricsRegistry`` with ``Counter`` / ``Gauge`` / ``Histogram`` —
  Prometheus-style text exposition + JSON snapshot; ``ServerStats``
  mirrors its funnel and resilience counters into one.
"""
from repro_torch.serving.observe.metrics import (Counter, Gauge, Histogram,
                                                 MetricsRegistry)
from repro_torch.serving.observe.trace import (NULL_TRACER, SCHED_TID,
                                               NullTracer, Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "SCHED_TID",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
]
