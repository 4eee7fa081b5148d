"""Typed metrics with label sets: Counter / Gauge / Histogram + registry.
Twin of ``repro/serving/observe/metrics.py``, kept as the port's own copy.

A deliberately small, dependency-free slice of the Prometheus data model:

* ``Counter`` — monotonically non-decreasing; ``inc`` rejects negative
  amounts and ``set_monotonic`` rejects regressions, so funnel counters
  mirrored from ``ServerStats`` can't silently run backwards.
* ``Gauge`` — settable point-in-time value (queue depth, pool pages,
  breaker state).
* ``Histogram`` — cumulative fixed buckets + sum + count (latency,
  queue wait).

Label sets are passed as keyword arguments (``c.inc(1, head="exact")``)
and must match the metric's declared ``labelnames`` exactly. Exposition
is Prometheus text format (``prometheus_text``) or a JSON-ready
``snapshot``.

Collection is both push and pull: hot paths push (``inc``/``observe``),
while sources that already keep their own counters (``ServerStats``,
``PagePool``, ``CircuitBreaker``...) register a *collector* callback
that refreshes their mirrored metrics right before every exposition —
the prometheus_client custom-collector pattern, without a scrape server.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: Default histogram buckets (seconds) — serving latencies from 100µs up.
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0,
                   5.0, 10.0, 30.0)

LabelKey = Tuple[str, ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Sequence[str], key: LabelKey,
                extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(labelnames, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Metric:
    """Shared name/help/labelnames plumbing for the three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: Dict[str, str]) -> LabelKey:
        return _label_key(self.labelnames, labels)


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0.0) + float(amount)

    def set_monotonic(self, value: float, **labels: str) -> None:
        """Mirror an externally-kept cumulative counter. Rejects
        regressions — a mirrored source running backwards is a bug."""
        k = self._key(labels)
        cur = self._values.get(k, 0.0)
        if value < cur:
            raise ValueError(
                f"counter {self.name}{dict(labels)}: {value} < {cur}")
        self._values[k] = float(value)

    def value(self, **labels: str) -> float:
        return self._values.get(self._key(labels), 0.0)

    def _expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labelnames, k)} {v:g}"
                for k, v in sorted(self._values.items())]

    def _snapshot(self):
        return _kv_snapshot(self.labelnames, self._values)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        return self._values.get(self._key(labels), 0.0)

    def _expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labelnames, k)} {v:g}"
                for k, v in sorted(self._values.items())]

    def _snapshot(self):
        return _kv_snapshot(self.labelnames, self._values)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {self.name}: empty buckets")
        self.buckets = tuple(bs)
        # per label-set: [bucket counts..., +inf count], sum, count
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels: str) -> None:
        v = float(value)
        if math.isnan(v):
            return                     # NaN observations are meaningless
        k = self._key(labels)
        counts = self._counts.setdefault(
            k, [0] * (len(self.buckets) + 1))
        for i, b in enumerate(self.buckets):
            if v <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[k] = self._sums.get(k, 0.0) + v
        self._totals[k] = self._totals.get(k, 0) + 1

    def count(self, **labels: str) -> int:
        return self._totals.get(self._key(labels), 0)

    def sum(self, **labels: str) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def _expose(self) -> List[str]:
        lines = []
        for k in sorted(self._totals):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[k][i]
                lab = _fmt_labels(self.labelnames, k, f'le="{b:g}"')
                lines.append(f"{self.name}_bucket{lab} {cum}")
            cum += self._counts[k][-1]
            lab = _fmt_labels(self.labelnames, k, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{lab} {cum}")
            lines.append(f"{self.name}_sum"
                         f"{_fmt_labels(self.labelnames, k)} "
                         f"{self._sums[k]:g}")
            lines.append(f"{self.name}_count"
                         f"{_fmt_labels(self.labelnames, k)} "
                         f"{self._totals[k]}")
        return lines

    def _snapshot(self):
        out = {}
        for k in sorted(self._totals):
            label = ",".join(f"{n}={v}" for n, v in zip(self.labelnames, k))
            out[label or "_"] = {
                "count": self._totals[k], "sum": self._sums[k],
                "buckets": {f"{b:g}": c for b, c in
                            zip(self.buckets, self._counts[k])},
                "inf": self._counts[k][-1],
            }
        return out


def _kv_snapshot(labelnames: Sequence[str],
                 values: Dict[LabelKey, float]):
    if not labelnames:
        return values.get((), 0.0)
    return {",".join(f"{n}={v}" for n, v in zip(labelnames, k)): val
            for k, val in sorted(values.items())}


class MetricsRegistry:
    """Get-or-create home for metrics + pull-style collector callbacks.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the name is already registered with the same kind and labelnames,
    and raise on any mismatch — two call sites silently disagreeing
    about a metric's shape is how dashboards lie."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Metric:
        existing = self._metrics.get(name)
        if existing is not None:
            if (existing.kind != cls.kind
                    or existing.labelnames != tuple(labelnames)):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}{list(existing.labelnames)}, wanted "
                    f"{cls.kind}{list(labelnames)}")
            return existing
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` is invoked before every exposition to refresh mirrored
        metrics from their live source (pull-style collection)."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def prometheus_text(self) -> str:
        """Prometheus text exposition (collectors run first)."""
        self.collect()
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m._expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready view of every metric (collectors run first)."""
        self.collect()
        return {name: {"kind": m.kind, "values": m._snapshot()}
                for name, m in sorted(self._metrics.items())}
