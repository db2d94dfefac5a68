"""Regime-aware dispatch scheduler for serving.

Counterpart of ``distributed_machine_learning_tpu/runtime/scheduler.py``
(``LATENCY``, ``THROUGHPUT``, ``RegimeConfig``, ``RegimeScheduler``),
copied so the port imports nothing of the JAX package.
:class:`RegimeScheduler` observes ``(queue_depth, in_flight_width)`` each
engine step and returns which lever the next step uses: ``"latency"``
(full-precision weights, the thin-batch regime) or ``"throughput"`` (int8
weights, the wide-batch regime).  Two mechanisms keep it from thrashing:

* a **dead band**: pressure (queued + in flight) must reach
  ``wide_width`` to enter the throughput regime and fall to
  ``thin_width`` (< wide) to leave it;
* a **dwell**: the out-of-regime pressure must persist for
  ``dwell_steps`` consecutive observations before the flip commits.
"""

from __future__ import annotations

import dataclasses
import threading

LATENCY = "latency"
THROUGHPUT = "throughput"


@dataclasses.dataclass(frozen=True)
class RegimeConfig:
    """Thresholds in units of pressure = queued + in-flight requests.
    Defaults suit an 8-lane engine."""

    thin_width: int = 2
    wide_width: int = 6
    dwell_steps: int = 8

    def __post_init__(self):
        if self.thin_width < 0:
            raise ValueError(f"thin_width must be >= 0: {self.thin_width}")
        if self.wide_width <= self.thin_width:
            raise ValueError(
                f"need thin_width < wide_width for a dead band, got "
                f"{self.thin_width} >= {self.wide_width}")
        if self.dwell_steps < 1:
            raise ValueError(f"dwell_steps must be >= 1: {self.dwell_steps}")


class RegimeScheduler:
    """Hysteretic two-regime lever policy,
    ``observe(queue_depth, width) -> "latency" | "throughput"``.
    Thread-safe (the lock is a leaf, held for arithmetic only)."""

    def __init__(self, cfg: RegimeConfig | None = None, registry=None):
        self.cfg = cfg or RegimeConfig()
        self._lock = threading.Lock()
        self.lever = LATENCY
        self.flips = 0
        self._streak = 0
        self._g_regime = self._g_pressure = self._c_flips = None
        if registry is not None:
            self._g_regime = registry.gauge("serving_regime")
            self._g_pressure = registry.gauge("serving_pressure")
            self._c_flips = registry.counter("serving_regime_flips")
            self._g_regime.set(0.0)

    def observe(self, queue_depth: int, width: int) -> str:
        """Feed one load sample; returns the lever for the next step."""
        pressure = int(queue_depth) + int(width)
        with self._lock:
            cfg = self.cfg
            if self.lever == LATENCY:
                wants_flip = pressure >= cfg.wide_width
            else:
                wants_flip = pressure <= cfg.thin_width
            if wants_flip:
                self._streak += 1
                if self._streak >= cfg.dwell_steps:
                    self.lever = THROUGHPUT if self.lever == LATENCY else LATENCY
                    self.flips += 1
                    self._streak = 0
                    if self._c_flips is not None:
                        self._c_flips.inc()
            else:
                self._streak = 0
            lever = self.lever
        if self._g_pressure is not None:
            self._g_pressure.set(float(pressure))
        if self._g_regime is not None:
            self._g_regime.set(1.0 if lever == THROUGHPUT else 0.0)
        return lever

    def snapshot(self) -> dict:
        with self._lock:
            return {"lever": self.lever, "flips": self.flips,
                    "streak": self._streak,
                    "thin_width": self.cfg.thin_width,
                    "wide_width": self.cfg.wide_width,
                    "dwell_steps": self.cfg.dwell_steps}
