"""Per-head circuit breakers: closed → open → half-open → closed. Twin of
``repro/serving/resilience/breaker.py``, kept as the port's own copy.

One ``CircuitBreaker`` tracks the health of every head the scheduler
serves. Failure signals (typed ``HeadFault``s from the stream guards,
NaN/empty-row corruption, watchdog stalls, latency spikes) feed per-head
counters; ``failure_threshold`` consecutive failures — or a single hard
(permanent) fault — TRIP the head:

  closed     healthy; requests route to it normally.
  open       tripped; ``allow()`` is False, so the head drops out of the
             router/admission catalog (``head_eligible`` refuses heads the
             scheduler stamps ``breaker_open``) and running streams are
             offloaded to fallbacks. After ``cooldown_s`` on the breaker's
             clock the next ``allow()`` probe transitions to half-open.
  half-open  one-probe trial: traffic may place again; the first recorded
             success closes the breaker, the first failure re-opens it
             (with a fresh cooldown).

The clock is injectable (``LogicalClock`` / the scheduler's fake clock)
and is only read on failure or while non-closed — a healthy server never
pays a clock read per request. ``on_transition(head, old, new)`` is the
observability hook ``ServerStats`` records trips/half-opens/closes from.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class _HeadHealth:
    __slots__ = ("state", "consecutive_failures", "failures", "corrupt",
                 "stalls", "latency_spikes", "open_until")

    def __init__(self):
        self.state = CLOSED
        self.consecutive_failures = 0
        self.failures = 0            # total, all kinds
        self.corrupt = 0             # NaN / empty-candidate-row detections
        self.stalls = 0
        self.latency_spikes = 0
        self.open_until = 0.0


class CircuitBreaker:
    """Health board for every head one scheduler serves.

    ``failure_threshold``  consecutive soft failures that trip a head.
    ``cooldown_s``         seconds (on ``clock``) an open head waits
                           before a half-open probe is allowed.
    ``latency_spike_s``    optional per-step wall-time threshold; spikes
                           count as soft failures (None disables).
    ``clock``              injectable; read lazily (see module docstring).
    ``on_transition``      callback ``(head, old_state, new_state)``.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 latency_spike_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str, str],
                                                  None]] = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1: {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.latency_spike_s = latency_spike_s
        self.clock = clock
        self.on_transition = on_transition
        self._heads: Dict[str, _HeadHealth] = {}

    def _h(self, head: str) -> _HeadHealth:
        h = self._heads.get(head)
        if h is None:
            h = self._heads[head] = _HeadHealth()
        return h

    def _set_state(self, head: str, h: _HeadHealth, new: str) -> None:
        old = h.state
        if old == new:
            return
        h.state = new
        if self.on_transition is not None:
            self.on_transition(head, old, new)

    # -- signals -------------------------------------------------------------
    def record_failure(self, head: str, kind: str = "transient",
                       hard: bool = False) -> None:
        """One failure signal for ``head``. ``hard`` (permanent faults)
        trips immediately; soft failures trip at ``failure_threshold``
        consecutive. A failure in half-open re-opens on the spot."""
        h = self._h(head)
        h.failures += 1
        h.consecutive_failures += 1
        if kind == "corrupt":
            h.corrupt += 1
        elif kind == "stall":
            h.stalls += 1
        tripped = hard or h.state == HALF_OPEN \
            or h.consecutive_failures >= self.failure_threshold
        if tripped and h.state != OPEN:
            self._set_state(head, h, OPEN)
        if tripped:
            h.open_until = self.clock() + self.cooldown_s

    def record_success(self, head: str) -> None:
        """One healthy step/join on ``head``: resets the consecutive
        counter; a half-open probe's success CLOSES the breaker."""
        h = self._heads.get(head)
        if h is None:
            return
        h.consecutive_failures = 0
        if h.state == HALF_OPEN:
            self._set_state(head, h, CLOSED)

    def record_latency(self, head: str, seconds: float) -> None:
        """Per-step wall time; spikes past ``latency_spike_s`` count as
        soft failures (a head slow enough is a head down)."""
        if self.latency_spike_s is None:
            return
        if seconds > self.latency_spike_s:
            self._h(head).latency_spikes += 1
            self.record_failure(head, kind="latency")

    # -- queries -------------------------------------------------------------
    def allow(self, head: str) -> bool:
        """May traffic place on ``head``? closed/half-open → yes; open →
        no, unless the cooldown elapsed, which transitions to half-open
        (the probe) and allows exactly that."""
        h = self._heads.get(head)
        if h is None or h.state == CLOSED:
            return True
        if h.state == OPEN:
            if self.clock() >= h.open_until:
                self._set_state(head, h, HALF_OPEN)
                return True
            return False
        return True                          # half-open: probe allowed

    def state(self, head: str) -> str:
        h = self._heads.get(head)
        return CLOSED if h is None else h.state

    def states(self) -> Dict[str, str]:
        return {name: h.state for name, h in self._heads.items()}

    def open_heads(self) -> tuple:
        return tuple(n for n, h in self._heads.items() if h.state == OPEN)

    def telemetry(self) -> dict:
        return {name: {
            "state": h.state, "failures": h.failures,
            "consecutive": h.consecutive_failures, "corrupt": h.corrupt,
            "stalls": h.stalls, "latency_spikes": h.latency_spikes,
        } for name, h in sorted(self._heads.items())}


__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker"]
