"""Per-iteration timing harness.

A copy of ``distributed_machine_learning_tpu/utils/timing.py``: the
reference's measurement protocol (``part1/main.py:36,53-58``), wall clock
per iteration, iteration 0 excluded as warm-up, totals and the average
over the rest printed at the end.  The caller syncs with the device (the
loss's ``.item()``) before stopping the clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence


def percentile(times: Sequence[float], q: float) -> float:
    """Exact ``q``-quantile (``q`` in [0, 1]) by linear interpolation
    between order statistics (numpy's default method)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    if not times:
        return 0.0
    xs = sorted(times)
    rank = q * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])


def percentile_stats(times: Sequence[float]) -> dict:
    """{p50, p95, p99, max} of a sample."""
    return {
        "p50": percentile(times, 0.50),
        "p95": percentile(times, 0.95),
        "p99": percentile(times, 0.99),
        "max": max(times) if times else 0.0,
    }


@dataclass
class IterationTimer:
    """Accumulates per-iteration wall clock, excluding ``skip_first`` iters.

    The reference runs 40 iterations and divides the total by 39
    (``part1/main.py:53-58``): iteration 0 is measured but not accumulated.
    """

    skip_first: int = 1
    times: list = field(default_factory=list)
    # Seconds of each overlapped parameter gather (train/loop.py fills it).
    param_gather_s: list = field(default_factory=list)
    _start: float = 0.0
    _iter: int = 0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        """Stop the clock; returns this iteration's time (always), and
        accumulates it unless it is among the first ``skip_first`` iters."""
        elapsed = time.perf_counter() - self._start
        if self._iter >= self.skip_first:
            self.times.append(elapsed)
        self._iter += 1
        return elapsed

    @property
    def total(self) -> float:
        return sum(self.times)

    @property
    def average(self) -> float:
        return self.total / len(self.times) if self.times else 0.0

    @property
    def count(self) -> int:
        return len(self.times)

    def percentiles(self) -> dict:
        """{p50, p95, p99, max} over the accumulated iterations."""
        return percentile_stats(self.times)

    def summary(self) -> str:
        # The reference's two lines (part1/main.py:57-58), then the tail.
        p = self.percentiles()
        return (
            f"Total execution time is : {self.total} seconds\n"
            f"Average execution time is  : {self.average} seconds\n"
            f"Iteration time p50/p95/p99/max : {p['p50']:.6f}/"
            f"{p['p95']:.6f}/{p['p99']:.6f}/{p['max']:.6f} seconds"
        )
