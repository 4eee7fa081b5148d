"""Serving: the batched decode engine (CUDA-graph step cache) and its
continuous-batching streams, requests and routing policies, the
``ContinuousScheduler`` with admission, preemption and resilience, and the
observability it reports through. Twin of ``repro/serving`` without the
paged KV pool, speculative decoding and ``audit_cost_drift`` (ROADMAP.md,
Queue 1 item 8)."""
from repro_torch.serving.engine import (DecodeEngine, DecodeStream,
                                        GenerationResult)
from repro_torch.serving.observe import (NULL_TRACER, Counter, Gauge,
                                         Histogram, MetricsRegistry,
                                         NullTracer, Tracer)
from repro_torch.serving.request import ServeRequest, ServeResult
from repro_torch.serving.resilience import (CircuitBreaker, FaultInjector,
                                            FaultSpec, HeadFault,
                                            LogicalClock, StreamWatchdog)
from repro_torch.serving.router import (DEFAULT_ACCURACY, CostAwarePolicy,
                                        RoutingPolicy, StaticPolicy,
                                        TierPolicy, head_eligible,
                                        route_requests)
from repro_torch.serving.scheduler import (AdmissionRejected, BudgetAdmission,
                                           ContinuousScheduler,
                                           SchedulerStalled, ServerStats)

__all__ = ["DecodeEngine", "DecodeStream", "GenerationResult",
           "ServeRequest", "ServeResult",
           "RoutingPolicy", "StaticPolicy", "TierPolicy", "CostAwarePolicy",
           "DEFAULT_ACCURACY", "head_eligible", "route_requests",
           "ContinuousScheduler", "SchedulerStalled", "ServerStats",
           "BudgetAdmission", "AdmissionRejected",
           "FaultInjector", "FaultSpec", "HeadFault", "LogicalClock",
           "CircuitBreaker", "StreamWatchdog",
           "Tracer", "NullTracer", "NULL_TRACER",
           "Counter", "Gauge", "Histogram", "MetricsRegistry"]
