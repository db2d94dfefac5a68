"""Process metrics registry: named counters, gauges, histograms.

Counterpart of what the serving engine uses from
``distributed_machine_learning_tpu/telemetry/registry.py``
(``MetricsRegistry`` with ``counter``/``gauge``/``histogram`` and
``snapshot``, and ``default_latency_buckets``), copied so the port imports
nothing of the JAX package.  Prometheus semantics, minimally: a counter
never decreases, a gauge is last-write-wins, a histogram has fixed
buckets plus exact count/sum/min/max and reports p50/p95/p99 by linear
interpolation inside the owning bucket.  Instruments are keyed by
``(name, sorted(labels))``: repeated calls return the same object.
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterable


def default_latency_buckets() -> tuple[float, ...]:
    """Request-latency seconds buckets, 0.5 ms .. ~16 s at √2 steps: the
    resolution sits where per-request latencies live."""
    out = []
    b = 5e-4
    while b < 16.0:
        out.append(b)
        b *= 2.0 ** 0.5
    return tuple(out)


class Counter:
    """Monotonic counter; ``inc`` with a negative amount raises."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.  ``buckets`` are
    ascending upper bounds (default :func:`default_latency_buckets`); an
    implicit +inf bucket catches the overflow and reports the exact
    observed max."""

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: tuple,
                 buckets: Iterable[float] | None = None):
        self.name = name
        self.labels = labels
        bounds = tuple(sorted(buckets)) if buckets else default_latency_buckets()
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: the +inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated ``q``-quantile (``q`` in [0, 1]) from the buckets."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == len(self.bounds):  # +inf bucket: the exact max
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else min(self.min, 0.0)
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            seen += c
        return self.max

    def quantiles(self) -> dict:
        return {"p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99),
                "max": self.max if self.count else 0.0}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create home for every instrument."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(name, _label_key(labels), **kw)
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: Iterable[float] | None = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def snapshot(self) -> dict:
        """JSON-ready dump of every instrument (histogram quantiles
        included)."""
        out: dict = {"counters": [], "gauges": [], "histograms": []}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            entry: dict = {"name": inst.name, "labels": dict(inst.labels)}
            if isinstance(inst, Counter):
                entry["value"] = inst.value
                out["counters"].append(entry)
            elif isinstance(inst, Gauge):
                entry["value"] = inst.value
                out["gauges"].append(entry)
            else:
                entry.update(count=inst.count, sum=inst.sum, mean=inst.mean,
                             **inst.quantiles())
                out["histograms"].append(entry)
        return out
