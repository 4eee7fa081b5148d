"""Serving: the batched decode engine (CUDA-graph step cache) and its
continuous-batching streams, requests and routing policies, the
``ContinuousScheduler`` with admission, preemption and resilience, and the
observability it reports through, the paged KV pool (LSTM logical pages
with a shared-prefix radix cache, and the dense and moe families' device
page store) and speculative decoding, through every head the registry
holds, the vocab-sharded ones included, and the heads' cost-drift audit.
Twin of ``repro/serving``."""
from repro_torch.serving.engine import (DecodeEngine, DecodeStream,
                                        GenerationResult)
from repro_torch.serving.kvpool import (PagedDecodeStream, PagePool,
                                        PoolExhausted, RadixCache)
from repro_torch.serving.observe import (NULL_TRACER, Counter, Gauge,
                                         Histogram, MetricsRegistry,
                                         NullTracer, Tracer, audit_cost_drift)
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
from repro_torch.serving.spec import (DraftLenController, SpecDecodeStream,
                                      SpecPolicy, spec_step_flops)

__all__ = ["DecodeEngine", "DecodeStream", "GenerationResult",
           "PagePool", "PagedDecodeStream", "PoolExhausted", "RadixCache",
           "ServeRequest", "ServeResult",
           "RoutingPolicy", "StaticPolicy", "TierPolicy", "CostAwarePolicy",
           "DEFAULT_ACCURACY", "head_eligible", "route_requests",
           "ContinuousScheduler", "SchedulerStalled", "ServerStats",
           "BudgetAdmission", "AdmissionRejected",
           "SpecPolicy", "SpecDecodeStream", "DraftLenController",
           "spec_step_flops",
           "FaultInjector", "FaultSpec", "HeadFault", "LogicalClock",
           "CircuitBreaker", "StreamWatchdog",
           "Tracer", "NullTracer", "NULL_TRACER",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "audit_cost_drift"]
