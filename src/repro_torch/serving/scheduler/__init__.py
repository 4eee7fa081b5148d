"""Continuous-batching scheduler subsystem: admission control, head-keyed
decode streams with join-at-step, tier deadlines with preemption, and live
``ServerStats`` telemetry. Twin of ``repro/serving/scheduler``; see
``scheduler.ContinuousScheduler`` for the tick loop and ``queue`` for the
admission types."""
from repro_torch.serving.scheduler.queue import (TIER_DEADLINES,
                                                 TIER_PRIORITY, AcceptAll,
                                                 AdmissionDecision,
                                                 AdmissionPolicy,
                                                 AdmissionRejected,
                                                 BudgetAdmission,
                                                 QueuedRequest, RequestQueue,
                                                 SchedulerLoad, head_flops,
                                                 head_flops_modeled,
                                                 tier_priority)
from repro_torch.serving.scheduler.scheduler import (ContinuousScheduler,
                                                     SchedulerStalled)
from repro_torch.serving.scheduler.stats import ServerStats

__all__ = ["ContinuousScheduler", "SchedulerStalled", "ServerStats",
           "RequestQueue",
           "QueuedRequest", "AdmissionPolicy", "AdmissionDecision",
           "AdmissionRejected", "AcceptAll", "BudgetAdmission",
           "SchedulerLoad", "TIER_DEADLINES", "TIER_PRIORITY",
           "head_flops", "head_flops_modeled", "tier_priority"]
