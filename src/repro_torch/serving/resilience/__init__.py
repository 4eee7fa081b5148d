"""Resilience layer: fault injection, circuit breakers, watchdogs. Twin of
``repro/serving/resilience``.

  * faults.py   — ``FaultInjector`` (deterministic chaos: seeded +
                  injectable ``LogicalClock``), typed ``HeadFault``, and
                  the always-on token-output guards every stream runs.
  * breaker.py  — per-head ``CircuitBreaker`` (closed/open/half-open)
                  that trips unhealthy heads out of the routing and
                  admission catalog via ``head_eligible``.
  * watchdog.py — ``StreamWatchdog`` per-request progress/stall detector;
                  request deadlines (``ServeRequest.timeout_s``) are
                  enforced by the scheduler alongside it.

``ContinuousScheduler`` threads all three through its tick loop: faults
retry with bounded backoff (the stream rolls a faulted step back first),
then re-route to the cheapest healthy head clearing the request's
``accuracy_floor`` (exact as last resort), else terminate as
``AdmissionRejected`` with ``stage="fault"`` — the server degrades, it
does not die.
"""
from repro_torch.serving.resilience.breaker import (CLOSED, HALF_OPEN, OPEN,
                                                    CircuitBreaker)
from repro_torch.serving.resilience.faults import (KINDS, SITES,
                                                   FaultInjector, FaultSpec,
                                                   HeadFault, LogicalClock,
                                                   guard_tokens,
                                                   invalid_token_rows)
from repro_torch.serving.resilience.watchdog import StreamWatchdog

__all__ = [
    "SITES", "KINDS",
    "LogicalClock", "HeadFault", "FaultSpec", "FaultInjector",
    "guard_tokens", "invalid_token_rows",
    "CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker",
    "StreamWatchdog",
]
