"""Wall-clock timing helpers for serving telemetry. Twin of
``repro/utils/timing.py``: where the reference blocks on JAX outputs,
``bench_wall`` synchronises the card that holds a CUDA tensor output."""
from __future__ import annotations

import math
import time
from collections import deque

import numpy as np
import torch


class Timer:
    """Context-manager wall timer: ``with Timer() as t: ...; t.ms``."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self.s = self.t1 - self.t0
        self.ms = self.s * 1e3
        self.us = self.s * 1e6
        return False


class LatencyTracker:
    """Streaming percentile tracker over a sliding window of samples.

    ``record(seconds)`` appends one observation; queries (``percentile``,
    ``p50``, ``p95``, ``mean``) answer over the most recent ``window``
    samples — O(window log window) per query, O(1) per record, bounded
    memory — which is what a live serving loop wants: current behavior, not
    an all-history average that a warmup spike skews forever. ``count``
    still reports ALL samples ever recorded (telemetry totals).

    Used by ``repro_torch.serving.scheduler.ServerStats``. Empty trackers
    answer NaN rather than raising — a snapshot taken before traffic
    arrives is not an error.
    """

    def __init__(self, window: int = 4096):
        if window < 1:
            raise ValueError(f"LatencyTracker window must be >= 1: {window}")
        self.window = window
        self._buf: "deque[float]" = deque(maxlen=window)
        self.count = 0

    def record(self, seconds: float) -> None:
        self._buf.append(float(seconds))
        self.count += 1

    def __len__(self) -> int:
        return len(self._buf)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; np.percentile (linear interpolation) over the
        window, NaN when empty instead of numpy's warning+nan path."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100]: {q}")
        if not self._buf:
            return math.nan
        return float(np.percentile(list(self._buf), q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def mean(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else math.nan

    def snapshot(self) -> dict:
        """JSON-ready summary of the current window."""
        return {"count": self.count, "window_count": len(self._buf),
                "p50_s": self.p50, "p95_s": self.p95, "mean_s": self.mean}


def _synchronize(out) -> None:
    """Wait for every card that holds a CUDA tensor in ``out`` (a tensor,
    or a list / tuple / dict of them); CPU outputs are already done."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _synchronize(v)


def bench_wall(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Return median wall seconds per call of ``fn(*args)``, each call
    ending when the card has finished its CUDA tensor outputs."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(out)
        t1 = time.perf_counter()
        if i >= warmup:
            times.append(t1 - t0)
    times.sort()
    return times[len(times) // 2]
