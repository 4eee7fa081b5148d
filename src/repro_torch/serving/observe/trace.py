"""Span tracing for the serving stack. Twin of
``repro/serving/observe/trace.py``, kept as the port's own copy.

A ``Tracer`` records per-request spans (submit -> admit/queue/join ->
decode ticks -> retire), scheduler-tick spans and kernel-dispatch spans
into a bounded ring buffer, exportable as Chrome trace-event JSON
(loadable in ``chrome://tracing`` / Perfetto) or as JSONL.

Design constraints, in order:

* **No new graphs.** Everything here is host-side Python; nothing the
  tracer does is captured into a CUDA graph. Kernel spans time the
  host-side replay+guard window around the already-captured step.
* **One timeline.** The tracer reads the scheduler's injectable clock
  (``LogicalClock`` under chaos tests, ``time.perf_counter`` in real
  runs), so spans, deadlines and watchdog decisions share an axis.
* **Cheap when off.** ``NullTracer`` no-ops every method and advertises
  ``enabled = False`` so hot paths can skip argument construction with
  ``if tracer.enabled:``. The module-level ``NULL_TRACER`` singleton is
  the default everywhere a tracer is threaded through.

Chrome trace-event mapping: request rows use ``tid = rid`` so every
request gets its own lane under one process; the scheduler's tick spans
live on ``tid = SCHED_TID`` (-1 — request ids start at 0, so the
scheduler lane must sit outside the rid space). Durations/timestamps
are exported in microseconds as the format requires.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional

# Trace lane for scheduler-level (non-request) spans. Negative so it can
# never collide with a request id (rids count up from 0).
SCHED_TID = -1


class Tracer:
    """Bounded ring buffer of trace events on an injectable clock.

    Events are stored as small dicts in trace-event shape (seconds
    internally; scaled to microseconds at export). When the buffer
    overflows, the oldest events are dropped — ``dropped`` reports how
    many, so exports can say so instead of silently truncating."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 capacity: int = 65536):
        self._clock = clock if clock is not None else time.perf_counter
        self._buf: deque = deque(maxlen=int(capacity))
        self.capacity = int(capacity)
        self.emitted = 0

    # -- recording -----------------------------------------------------------
    def now(self) -> float:
        """Current time on the tracer's clock (seconds)."""
        return float(self._clock())

    def span(self, name: str, cat: str, t0: float,
             t1: Optional[float] = None, tid: int = SCHED_TID,
             args: Optional[dict] = None) -> None:
        """A complete ("X") span from ``t0`` to ``t1`` (default: now)."""
        if t1 is None:
            t1 = self.now()
        ev = {"name": name, "cat": cat, "ph": "X", "ts": float(t0),
              "dur": max(0.0, float(t1) - float(t0)), "tid": int(tid)}
        if args:
            ev["args"] = dict(args)
        self._buf.append(ev)
        self.emitted += 1

    def instant(self, name: str, cat: str, tid: int = SCHED_TID,
                args: Optional[dict] = None,
                t: Optional[float] = None) -> None:
        """A point-in-time ("i") marker (admit/reject/fault/retry...)."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self.now() if t is None else float(t), "tid": int(tid)}
        if args:
            ev["args"] = dict(args)
        self._buf.append(ev)
        self.emitted += 1

    # -- inspection / export -------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events lost to ring-buffer overflow."""
        return self.emitted - len(self._buf)

    def events(self) -> List[dict]:
        """The retained events, oldest first (internal units: seconds)."""
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.emitted = 0

    def chrome_trace(self) -> dict:
        """The full Chrome trace-event JSON object (timestamps in µs)."""
        pid = 1
        events = []
        tids: Dict[int, bool] = {}
        for ev in self._buf:
            out = dict(ev)
            out["pid"] = pid
            out["ts"] = ev["ts"] * 1e6
            if "dur" in out:
                out["dur"] = ev["dur"] * 1e6
            events.append(out)
            tids[ev["tid"]] = True
        # thread_name metadata makes Perfetto label the lanes usefully
        meta = []
        for tid in sorted(tids):
            name = "scheduler" if tid == SCHED_TID else f"request {tid}"
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"emitted": self.emitted, "dropped": self.dropped},
        }

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")
        return path

    def export_jsonl(self, path: str) -> str:
        """One retained event per line (µs timestamps, same shape as the
        ``traceEvents`` entries, no metadata rows)."""
        with open(path, "w") as f:
            for ev in self._buf:
                out = dict(ev)
                out["pid"] = 1
                out["ts"] = ev["ts"] * 1e6
                if "dur" in out:
                    out["dur"] = ev["dur"] * 1e6
                f.write(json.dumps(out) + "\n")
        return path

    def __repr__(self) -> str:      # pragma: no cover - debug aid
        return (f"Tracer(events={len(self._buf)}, emitted={self.emitted}, "
                f"dropped={self.dropped})")


class NullTracer:
    """Disabled tracer: every method is a no-op and ``enabled`` is False,
    so instrumented hot paths cost one attribute read when tracing is
    off. Export methods still work (they write an empty trace)."""

    enabled = False
    emitted = 0
    dropped = 0
    capacity = 0

    def now(self) -> float:
        return 0.0

    def span(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def events(self) -> List[dict]:
        return []

    def clear(self) -> None:
        pass

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"emitted": 0, "dropped": 0}}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def export_jsonl(self, path: str) -> str:
        open(path, "w").close()
        return path


#: Shared disabled tracer — the default for every instrumented surface.
NULL_TRACER = NullTracer()
