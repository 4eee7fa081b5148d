"""Reading the profiler's trace of a ``--trace 1`` run.

The traced part of the window runs inside ``torch.profiler.profile``
(CUDA activity: the device's operations and the CUDA runtime's calls);
its bounds are read from the wall clock
(``time.time_ns``), the clock of Kineto's timestamps, after the profiler
starts and before it stops. The raw Kineto events are read once
(``prof.profiler.kineto_results.events()``: no Chrome trace is written)
into arrays: the device's operations (kernels, copies, sets) and the
host's operations.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List

import numpy as np

GAP_MIN_NS = 10_000          # idle gaps shorter than 10 µs go unlabelled
TOP = 10
# Kineto's own host events: never what the host was doing for the program
PROFILER_EVENTS = ("Activity Buffer Request",)


class Trace:
    """Device and host operations of one traced window (times in ns on
    the profiler's clock)."""

    def __init__(self, events, window: tuple):
        from torch.autograd import DeviceType
        dev_name, dev_t0, dev_t1 = [], [], []
        host = []
        for e in events:
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() != DeviceType.CPU:
                dev_name.append(name)
                dev_t0.append(t0)
                dev_t1.append(t1)
                continue
            if name not in PROFILER_EVENTS:
                host.append((t0, t1, name))
        self.window = tuple(window)
        self.dev_name = dev_name
        self.dev_t0 = np.asarray(dev_t0, np.int64)
        self.dev_t1 = np.asarray(dev_t1, np.int64)
        host.sort()
        self.host = host
        self._host_t0 = [h[0] for h in host]

    @classmethod
    def of(cls, prof, window: tuple) -> "Trace":
        return cls(prof.profiler.kineto_results.events(), window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[tuple]:
        """The union of device operations inside the window, merged."""
        w0, w1 = self.window
        t0 = np.clip(self.dev_t0, w0, w1)
        t1 = np.clip(self.dev_t1, w0, w1)
        keep = t1 > t0
        order = np.argsort(t0[keep], kind="stable")
        out: List[list] = []
        for a, b in zip(t0[keep][order].tolist(), t1[keep][order].tolist()):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_ops(self) -> List[list]:
        """[[name, seconds]] of the device operations that took the most
        time in the window, at most ``TOP``."""
        w0, w1 = self.window
        tot: Dict[str, float] = defaultdict(float)
        for n, a, b in zip(self.dev_name, self.dev_t0.tolist(),
                           self.dev_t1.tolist()):
            a, b = max(a, w0), min(b, w1)
            if b > a:
                tot[n] += (b - a) * 1e-9
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda x: -x[1])[:TOP]]

    def _host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self._host_t0, t)
        for j in range(i - 1, max(i - 256, -1), -1):
            a, b, name = self.host[j]
            if a <= t <= b:
                return name
        return "host, outside any profiled operation"

    def idle_gaps(self) -> List[list]:
        """[[what the host was doing, seconds]]: the device's idle time in
        the window by the innermost host operation running at the middle
        of each gap of ``GAP_MIN_NS`` or more, the largest ``TOP``."""
        w0, w1 = self.window
        tot: Dict[str, float] = defaultdict(float)
        prev = w0
        for a, b in self.busy_intervals() + [(w1, w1)]:
            if a - prev >= GAP_MIN_NS:
                tot[self._host_at((a + prev) // 2)] += (a - prev) * 1e-9
            prev = max(prev, b)
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda x: -x[1])[:TOP]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
