"""Process-wide metrics registry: named counters, gauges, histograms.

A copy of ``distributed_machine_learning_tpu/telemetry/registry.py``, so
the port imports nothing of the JAX package.  Semantics follow the
Prometheus data model, minimally:

- :class:`Counter` — monotonically non-decreasing; ``inc(n)``.
- :class:`Gauge` — last-write-wins; ``set(v)``.
- :class:`Histogram` — FIXED buckets chosen at creation (no rebinning,
  so merge/export is trivial) plus exact count/sum/min/max, exposing
  p50/p95/p99 by linear interpolation inside the owning bucket.

Instruments are keyed by ``(name, sorted(labels))`` — repeated
``registry.counter("x", kind="y")`` calls return the same object, so
call sites never need to cache handles.  Creation takes a lock;
updates are plain attribute writes, cheap enough for per-step use.
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterable


def default_time_buckets() -> tuple[float, ...]:
    """Exponential seconds buckets, 100 µs .. ~2 min — wide enough for a
    CPU-host step AND a checkpoint serialize in the same histogram."""
    out = []
    b = 1e-4
    while b < 120.0:
        out.append(b)
        b *= 2.0
    return tuple(out)


def default_latency_buckets() -> tuple[float, ...]:
    """Request-latency seconds buckets, 0.5 ms .. ~16 s at √2 steps.
    Histogram buckets are fixed at
    construction, and :func:`default_time_buckets`' doubling grid
    (tuned for multi-second train steps) puts an entire
    millisecond-scale serving distribution inside one or two buckets,
    flattening p50/p95/p99 into the same interpolated value.  The √2
    ratio doubles the resolution exactly where per-request latencies
    live while still reaching tail-amplification territory."""
    out = []
    b = 5e-4
    while b < 16.0:
        out.append(b)
        b *= 2.0 ** 0.5
    return tuple(out)


class Counter:
    """Monotonic counter.  ``inc`` with a negative amount is an error —
    a decreasing "counter" is a gauge wearing the wrong name."""

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
    """Fixed-bucket histogram with exact count/sum/min/max.

    ``buckets`` are upper bounds (ascending); an implicit +inf bucket
    catches the overflow.  Quantiles interpolate linearly inside the
    bucket that crosses the target rank — the standard fixed-bucket
    estimate — except the +inf bucket, which reports the exact observed
    max (unbounded interpolation would be fiction).
    """

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: tuple,
                 buckets: Iterable[float] | None = None):
        self.name = name
        self.labels = labels
        bounds = tuple(sorted(buckets)) if buckets else default_time_buckets()
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
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

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
                if i == len(self.bounds):  # +inf bucket: report exact max
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else min(self.min, 0.0)
                hi = self.bounds[i]
                frac = (rank - seen) / c
                # Clamp into the observed range so a single-bucket
                # histogram never reports below its own min / above max.
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            seen += c
        return self.max

    def quantiles(self) -> dict:
        return {
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "max": self.max if self.count else 0.0,
        }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create home for every instrument in the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, _label_key(labels), **kw)
                    self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: Iterable[float] | None = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready dump of every instrument (quantiles included for
        histograms) — the ``registry.json`` payload."""
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
                entry.update(
                    count=inst.count, sum=inst.sum, mean=inst.mean,
                    **inst.quantiles(),
                )
                out["histograms"].append(entry)
        return out

    def to_prometheus(self) -> str:
        """Prometheus textfile-collector format (final values — the
        node-exporter textfile pattern, not a live scrape endpoint).

        One ``# TYPE`` line per metric FAMILY (name), with every label
        series grouped under it — the exposition format allows at most
        one TYPE per family, and promtool rejects duplicates.

        Label VALUES are escaped per the exposition format (backslash,
        double-quote, newline): an abort reason or fault spec carried
        as a label would otherwise break the line grammar and take the
        whole textfile down with it — the scrape that fails is exactly
        the post-mortem one.
        """

        def esc(v) -> str:
            return (str(v).replace("\\", r"\\").replace('"', r"\"")
                    .replace("\n", r"\n"))

        def fmt(name, labels, value, extra_labels=()):
            pairs = [*labels, *extra_labels]
            lab = ("{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs)
                   + "}" if pairs else "")
            return f"{name}{lab} {value}"

        with self._lock:
            instruments = list(self._instruments.values())
        families: dict[str, tuple[str, list]] = {}
        for inst in instruments:
            kind = ("counter" if isinstance(inst, Counter)
                    else "gauge" if isinstance(inst, Gauge)
                    else "histogram")
            families.setdefault(inst.name, (kind, []))[1].append(inst)
        lines = []
        for name, (kind, insts) in families.items():
            lines.append(f"# TYPE {name} {kind}")
            for inst in insts:
                if kind in ("counter", "gauge"):
                    lines.append(fmt(name, inst.labels, inst.value))
                    continue
                cum = 0
                for bound, c in zip(inst.bounds, inst.counts):
                    cum += c
                    lines.append(fmt(f"{name}_bucket", inst.labels, cum,
                                     (("le", repr(bound)),)))
                lines.append(fmt(f"{name}_bucket", inst.labels, inst.count,
                                 (("le", "+Inf"),)))
                lines.append(fmt(f"{name}_sum", inst.labels, inst.sum))
                lines.append(fmt(f"{name}_count", inst.labels, inst.count))
        return "\n".join(lines) + "\n" if lines else ""
