"""Stream watchdog: per-request progress tracking + stall detection. Twin
of ``repro/serving/resilience/watchdog.py``, kept as the port's own copy.

The scheduler feeds the watchdog one observation per placed request per
tick (its emitted-token count on the tick's clock). A request whose count
has not moved for longer than ``stall_timeout_s`` is STALLED — a wedged
stream the tick loop cannot see from the inside (an injected stall fault,
a hung device, a head that stopped returning) — and the scheduler evicts
and re-routes it through the same fallback path head faults take.

Request deadlines (``ServeRequest.timeout_s``) are enforced by the
scheduler directly (they need the request's arrival stamp, not progress);
the watchdog is purely the progress detector. ``stall_timeout_s=None``
(the default) disables stall detection entirely and the scheduler then
never reads the clock for it — zero overhead on the healthy path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class StreamWatchdog:
    """Tracks ``rid -> (last token count, time it last changed)``."""

    def __init__(self, stall_timeout_s: Optional[float] = None):
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be > 0 or None: {stall_timeout_s}")
        self.stall_timeout_s = stall_timeout_s
        self._progress: Dict[int, Tuple[int, float]] = {}

    @property
    def armed(self) -> bool:
        return self.stall_timeout_s is not None

    @property
    def tracked(self) -> int:
        """Requests currently under progress tracking — the watchdog's
        gauge for the metrics registry."""
        return len(self._progress)

    def observe(self, rid: int, n_tokens: int, now: float) -> None:
        prev = self._progress.get(rid)
        if prev is None or n_tokens != prev[0]:
            self._progress[rid] = (int(n_tokens), float(now))

    def stalled(self, now: float) -> List[int]:
        """Request ids with no token progress for > ``stall_timeout_s``."""
        if self.stall_timeout_s is None:
            return []
        return [rid for rid, (_, since) in self._progress.items()
                if now - since > self.stall_timeout_s]

    def forget(self, rid: int) -> None:
        self._progress.pop(rid, None)


__all__ = ["StreamWatchdog"]
