"""Serving observability: span tracing, typed metrics, cost-drift audit.
Twin of ``repro/serving/observe``.

* ``Tracer`` / ``NullTracer`` — per-request span timeline on the
  scheduler's injectable clock, exportable as Chrome trace-event JSON
  (``chrome://tracing`` / Perfetto) or JSONL; ``PROCESS_TRACER`` /
  ``active`` put the engine's spans on a torch profiler's clock.
* ``MetricsRegistry`` with ``Counter`` / ``Gauge`` / ``Histogram`` —
  Prometheus-style text exposition + JSON snapshot; ``ServerStats``
  mirrors its funnel and resilience counters into one.
* ``audit_cost_drift`` — cataloged ``flops_per_query`` /
  ``bytes_per_query`` against each head's counted ops
  (``launch/op_cost.py``) and wall-clock time.
"""
from repro_torch.serving.observe.drift import audit_cost_drift
from repro_torch.serving.observe.metrics import (Counter, Gauge, Histogram,
                                                 MetricsRegistry)
from repro_torch.serving.observe.trace import (ENGINE_TID, NULL_TRACER,
                                               PROCESS_TRACER, SCHED_TID,
                                               NullTracer, Tracer, active)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "SCHED_TID", "ENGINE_TID",
    "PROCESS_TRACER", "active",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "audit_cost_drift",
]
