"""Live SLO engine for the serving fleet.

A copy of ``distributed_machine_learning_tpu/telemetry/slo.py``.  The
router's serving audit answers "did every request complete exactly
once"; it cannot answer "is the fleet meeting its latency objective
RIGHT NOW" — the question a deploy gate or a canary rollback (the
ROADMAP items above this layer) actually asks.  This module evaluates
declared objectives over the live request outcome stream:

- :func:`parse_slo` — one objective from CLI text: ``p99<=250ms``
  (a latency quantile bound), ``error_ratio<=0.01`` or
  ``reject_ratio<=1%`` (outcome-fraction bounds).
- :class:`SLOEngine` — feed one :meth:`observe` per request outcome
  (completed with a latency, errored, or rejected at admission).  Every
  objective maps onto an **error budget** — the allowed bad-outcome
  fraction (``p99<=X`` allows 1% of requests over ``X``;
  ``reject_ratio<=Y`` allows ``Y``) — and the engine tracks the
  **burn rate**: observed bad fraction ÷ budget, over a short and a
  long sliding window.  An alert fires when BOTH windows burn above
  the threshold (the standard multi-window rule: the long window
  proves the problem is sustained, the short window proves it is
  still happening — a burst that already ended never pages).
- :meth:`SLOEngine.verdict` — the end-of-run judgement ``cli/serve.py``
  prints: an objective fails when its whole-run bad fraction exceeded
  the budget OR a burn-rate alert fired during the run (a sustained
  mid-run breach is a violation even if a quiet tail averages it away).

Clock discipline: the engine never reads wall time on its own — the
caller injects timestamps (``now=``) or a ``now_fn`` (defaulting to
``time.monotonic``, single-process only, per DML001).  Injected
timestamps are what make the burn-rate tests deterministic.

Deliberately stdlib-only, like ``telemetry/aggregator.py``
— the ``tools/`` layer imports it against a dead run's ledgers.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import deque

_LATENCY_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")
_RATIO_KINDS = ("error_ratio", "reject_ratio")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declared objective, normalized to an error budget."""

    raw: str            # the CLI text, echoed in verdicts/alerts
    kind: str           # "latency" | "error_ratio" | "reject_ratio"
    threshold: float    # latency bound (seconds) or allowed fraction
    budget: float       # allowed bad-outcome fraction, in (0, 1)

    def is_relevant(self, outcome: "_Outcome") -> bool:
        if self.kind == "latency":
            return outcome.latency_s is not None
        if self.kind == "error_ratio":
            return not outcome.rejected
        return True  # reject_ratio judges every admission attempt

    def is_bad(self, outcome: "_Outcome") -> bool:
        if self.kind == "latency":
            return (outcome.latency_s is not None
                    and outcome.latency_s > self.threshold)
        if self.kind == "error_ratio":
            return outcome.error
        return outcome.rejected


@dataclasses.dataclass(frozen=True)
class _Outcome:
    t: float
    latency_s: float | None
    error: bool
    rejected: bool


def _parse_seconds(text: str) -> float:
    text = text.strip()
    for suffix, scale in (("ms", 1e-3), ("us", 1e-6), ("s", 1.0)):
        if text.endswith(suffix):
            return float(text[: -len(suffix)]) * scale
    return float(text)


def _parse_fraction(text: str) -> float:
    text = text.strip()
    if text.endswith("%"):
        return float(text[:-1]) / 100.0
    return float(text)


def parse_slo(spec: str) -> SLOSpec:
    """``p99<=250ms`` / ``p95<=0.1`` / ``error_ratio<=0.01`` /
    ``reject_ratio<=5%`` -> :class:`SLOSpec`.  Raises ``ValueError``
    with the offending text for anything else."""
    raw = spec.strip()
    if "<=" not in raw:
        raise ValueError(f"SLO spec needs '<=': {spec!r}")
    lhs, rhs = (part.strip() for part in raw.split("<=", 1))
    m = _LATENCY_RE.match(lhs)
    if m:
        q = float(m.group(1)) / 100.0
        if not 0.0 < q < 1.0:
            raise ValueError(f"SLO quantile out of range: {spec!r}")
        threshold = _parse_seconds(rhs)
        if threshold <= 0:
            raise ValueError(f"SLO latency bound must be > 0: {spec!r}")
        return SLOSpec(raw=raw, kind="latency", threshold=threshold,
                       budget=1.0 - q)
    if lhs in _RATIO_KINDS:
        frac = _parse_fraction(rhs)
        if not 0.0 < frac < 1.0:
            raise ValueError(f"SLO ratio must be in (0, 1): {spec!r}")
        return SLOSpec(raw=raw, kind=lhs, threshold=frac, budget=frac)
    raise ValueError(
        f"unknown SLO objective {lhs!r} (want pNN, error_ratio or "
        f"reject_ratio): {spec!r}")


class SLOEngine:
    """Sliding-window burn-rate evaluation over request outcomes."""

    def __init__(self, objectives, *, short_window_s: float = 5.0,
                 long_window_s: float = 60.0,
                 burn_threshold: float = 2.0, now_fn=None):
        if short_window_s <= 0 or long_window_s < short_window_s:
            raise ValueError(
                "windows must satisfy 0 < short <= long, got "
                f"{short_window_s}/{long_window_s}")
        if burn_threshold <= 0:
            raise ValueError(
                f"burn threshold must be > 0, got {burn_threshold}")
        self.objectives: list[SLOSpec] = [
            o if isinstance(o, SLOSpec) else parse_slo(o)
            for o in objectives]
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self._now = now_fn if now_fn is not None else time.monotonic
        self._window: deque[_Outcome] = deque()
        # Whole-run tallies per objective (never trimmed): the verdict
        # judges the run, the windows judge the moment.
        self._relevant = {o.raw: 0 for o in self.objectives}
        self._bad = {o.raw: 0 for o in self.objectives}
        self._alerting: set[str] = set()  # objectives in an alert episode
        self.alerts: list[dict] = []

    # -- feed ------------------------------------------------------------
    def observe(self, *, latency_s: float | None = None,
                error: bool = False, rejected: bool = False,
                now: float | None = None) -> list[dict]:
        """Record one request outcome; returns any alerts fired by it.
        ``now`` injects a deterministic timestamp (tests, replays)."""
        t = float(now) if now is not None else self._now()
        outcome = _Outcome(t=t, latency_s=latency_s, error=bool(error),
                           rejected=bool(rejected))
        self._window.append(outcome)
        while self._window and self._window[0].t < t - self.long_window_s:
            self._window.popleft()
        fired = []
        for obj in self.objectives:
            if obj.is_relevant(outcome):
                self._relevant[obj.raw] += 1
                if obj.is_bad(outcome):
                    self._bad[obj.raw] += 1
            short = self._burn(obj, t, self.short_window_s)
            long_ = self._burn(obj, t, self.long_window_s)
            if (short is not None and long_ is not None
                    and short > self.burn_threshold
                    and long_ > self.burn_threshold):
                if obj.raw not in self._alerting:
                    self._alerting.add(obj.raw)
                    alert = {"slo": obj.raw, "at": t,
                             "short_burn": short, "long_burn": long_}
                    self.alerts.append(alert)
                    fired.append(alert)
            elif short is not None and short <= self.burn_threshold:
                # Recovery re-arms the alert: a later sustained breach
                # is a new episode, not a continuation.
                self._alerting.discard(obj.raw)
        return fired

    def _burn(self, obj: SLOSpec, now: float,
              window_s: float) -> float | None:
        """Bad fraction ÷ budget over the trailing window, or None with
        no relevant outcome in it (no evidence is not a breach)."""
        relevant = bad = 0
        for o in self._window:
            if o.t < now - window_s or not obj.is_relevant(o):
                continue
            relevant += 1
            if obj.is_bad(o):
                bad += 1
        if relevant == 0:
            return None
        return (bad / relevant) / obj.budget

    # -- judgement -------------------------------------------------------
    def verdict(self) -> dict:
        """Whole-run pass/fail per objective, plus the alert history."""
        rows = []
        ok = True
        for obj in self.objectives:
            relevant = self._relevant[obj.raw]
            bad = self._bad[obj.raw]
            ratio = bad / relevant if relevant else 0.0
            alerts = sum(1 for a in self.alerts if a["slo"] == obj.raw)
            row_ok = ratio <= obj.budget and alerts == 0
            ok = ok and row_ok
            rows.append({
                "slo": obj.raw, "kind": obj.kind,
                "budget": obj.budget, "bad_ratio": ratio,
                "relevant": relevant, "bad": bad,
                "alerts": alerts, "ok": row_ok,
            })
        return {"ok": ok, "objectives": rows,
                "alerts": list(self.alerts)}


def format_verdict(verdict: dict) -> str:
    """One human line per objective + the overall verdict — what
    ``cli/serve.py`` prints at end of run."""
    lines = []
    for row in verdict["objectives"]:
        mark = "PASS" if row["ok"] else "FAIL"
        lines.append(
            f"  slo {row['slo']}: {mark} "
            f"(bad {row['bad']}/{row['relevant']} = "
            f"{row['bad_ratio']:.4f} vs budget {row['budget']:.4f}, "
            f"{row['alerts']} alert(s))")
    lines.append("slo verdict: "
                 + ("PASS" if verdict["ok"] else "FAIL")
                 + f" ({len(verdict['alerts'])} alert(s) fired)")
    return "\n".join(lines)
