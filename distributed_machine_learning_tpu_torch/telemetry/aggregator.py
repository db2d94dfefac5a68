"""Gang-wide metric aggregation — the cross-rank half of telemetry.

A copy of ``distributed_machine_learning_tpu/telemetry/aggregator.py``.
Every process has its own registry, JSONL stream, and trace; what no
single stream shows is the *relation* between ranks: a straggler is invisible
in its own stream (every step it completes looks normal — it just
completes them late), and a lock-step gang converts one slow rank into
N blocked ones, so per-rank dashboards show everyone equally idle.
"Massively Distributed SGD" (PAPERS.md, arxiv 1811.05233) attributes
its wins to exactly this cross-replica accounting: you cannot run
backup workers — or even pick a sane batch size — without knowing the
per-step spread across ranks.

This module is the reader/rollup side of that story, deliberately
stdlib-only (no torch, no numpy) so the ``tools/`` layer can run it on a
bare host against a dead run's directory:

- :func:`discover_rank_streams` — find the per-rank artifacts under a
  gang telemetry dir, in either layout: rank-suffixed files
  (``metrics.rank<r>.jsonl``, the collision-safe default the gang
  worker writes) or per-rank subdirectories (``rank<r>/metrics.jsonl``).
- :func:`aggregate_gang_metrics` — per-step cross-rank rollups:
  min/median/p95/max across ranks for step time and every per-phase
  duration (``data_wait_s``/``place_s``/``dispatch_s``/``block_s`` from
  the train loop; ``barrier_wait_s``/``compute_s`` from the gang
  worker), per-rank examples/s, and a per-step **skew ratio**
  (slowest rank / median rank).
- :class:`StragglerDetector` — flags ranks whose rolling step time
  exceeds a configurable multiple of the gang median for K consecutive
  observations.  Used offline over the metrics streams (here) and live
  over heartbeat snapshots (``runtime/supervisor.py::gang_supervise``).
- :class:`HeartbeatSampler` — effective per-rank step times from the
  beat files ``runtime/coordinator.py`` writes, on the same
  locally-observed-change staleness basis as the coordinator's own
  peer checks (never cross-host mtime/wall-clock comparison).

File-name constants here mirror the *writer* modules (the payloads are
read tolerantly, so a torn final line — the artifact of the crash being
diagnosed — never kills the diagnosis): ``beat_rank<r>.json`` and
``gang_health.jsonl`` are written by ``runtime/coordinator.py``,
``faults_fired.jsonl`` by ``runtime/faults.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time

from distributed_machine_learning_tpu_torch.telemetry.sink import read_jsonl
from distributed_machine_learning_tpu_torch.utils.timing import percentile

# Writer-side names, mirrored so the stdlib tools can read a gang dir
# without importing the (torch-heavy) runtime package.
BEAT_PREFIX = "beat_rank"             # runtime/coordinator.py heartbeats
GANG_HEALTH_FILE = "gang_health.jsonl"  # supervisor advisory ledger
FAULT_LEDGER_FILE = "faults_fired.jsonl"  # runtime/faults.py firings
CONSUMED_PREFIX = "consumed_rank"     # gang worker consumption ledgers

# Keys every metrics row may carry; any other numeric key ending in
# "_s" is treated as a per-phase duration (so the train loop's
# data_wait_s/place_s/... and the gang worker's barrier_wait_s/... are
# aggregated by one rule, and new phases need no registry here).
# Rates ("*_per_s") and the whole-step time are not phases.
_STEP_KEY = "step"
_ITER_KEY = "iter_s"
_NON_PHASE_KEYS = {_ITER_KEY}


def _is_phase_key(k: str) -> bool:
    return (k.endswith("_s") and not k.endswith("_per_s")
            and k not in _NON_PHASE_KEYS)

_RANK_FILE_RE = re.compile(r"^metrics\.rank(\d+)\.jsonl$")
_RANK_DIR_RE = re.compile(r"^rank(\d+)$")


def median(values) -> float:
    """Exact median (midpoint of the two central order statistics for
    even counts) — public: the supervisor and the status tool share it,
    so "the gang median" means one thing everywhere."""
    xs = sorted(values)
    if not xs:
        return 0.0
    mid = len(xs) // 2
    if len(xs) % 2:
        return float(xs[mid])
    return (xs[mid - 1] + xs[mid]) / 2.0


def _spread(values: list[float]) -> dict:
    """The cross-rank rollup block: min/median/p95/max over one step's
    per-rank values (p95 interpolates order statistics — with a handful
    of ranks it tracks the max, which is the honest reading)."""
    return {
        "min": min(values),
        "median": median(values),
        "p95": percentile(values, 0.95),
        "max": max(values),
    }


def discover_rank_streams(root: str | os.PathLike) -> dict[int, dict]:
    """rank -> {"metrics": path, "trace": path|None, "registry":
    path|None, "dir": path} for every per-rank stream under ``root``.

    Two layouts are recognized (both appear in practice):

    - **suffix layout** (the gang default): ``metrics.rank<r>.jsonl`` /
      ``trace.rank<r>.json`` directly under ``root`` — N processes
      sharing one directory with collision-safe names;
    - **subdir layout**: ``rank<r>/metrics.jsonl`` — each rank pointed
      at its own ``--telemetry-dir``.

    When both exist for a rank, the suffix layout wins (it is the one
    the current worker writes; a subdir is a leftover of an older
    launcher).  Ranks are ORIGINAL-numbering identities: a renumbered
    survivor keeps appending to its original stream, so one rank maps
    to one stream across shrinks.
    """
    root = os.fspath(root)
    out: dict[int, dict] = {}
    if not os.path.isdir(root):
        return out

    def entry(rank: int, metrics: str, trace: str, registry: str,
              base: str) -> None:
        if rank in out:
            return
        out[rank] = {
            "metrics": metrics if os.path.isfile(metrics) else None,
            "trace": trace if os.path.isfile(trace) else None,
            "registry": registry if os.path.isfile(registry) else None,
            "dir": base,
        }

    names = sorted(os.listdir(root))
    for name in names:
        m = _RANK_FILE_RE.match(name)
        if m:
            r = int(m.group(1))
            entry(
                r,
                os.path.join(root, name),
                os.path.join(root, f"trace.rank{r}.json"),
                os.path.join(root, f"registry.rank{r}.json"),
                root,
            )
    for name in names:
        m = _RANK_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            r = int(m.group(1))
            base = os.path.join(root, name)
            entry(
                r,
                os.path.join(base, "metrics.jsonl"),
                os.path.join(base, "trace.json"),
                os.path.join(base, "registry.json"),
                base,
            )
    # Drop ranks with no readable metrics stream at all (an empty
    # rank<r>/ dir from a worker that died pre-first-row still shows up
    # in the trace discovery of tools/trace_merge.py, not here).
    return {r: e for r, e in out.items() if e["metrics"] is not None}


def _rank_step_rows(streams: dict[int, dict]
                    ) -> dict[int, dict[int, dict]]:
    """rank -> step -> the authoritative metrics row for that step.

    Restarted attempts replay steps, so one (rank, step) can have many
    rows; the LAST row of the HIGHEST attempt wins — it belongs to the
    attempt that actually carried the run past this step.  Warm-up
    rows (compile steps, timer-excluded) are skipped the same way
    ``tools/trace_summary.py`` skips them: a compile belongs on the
    timeline, not in a skew ratio.
    """
    out: dict[int, dict[int, dict]] = {}
    for rank, entry in sorted(streams.items()):
        best: dict[int, tuple[int, int, dict]] = {}
        try:
            rows = read_jsonl(entry["metrics"])
        except OSError:
            continue
        for order, row in enumerate(rows):
            if not isinstance(row, dict) or row.get("warmup"):
                continue
            step = row.get(_STEP_KEY)
            if not isinstance(step, int) or _ITER_KEY not in row:
                continue
            key = (int(row.get("attempt", 0)), order)
            cur = best.get(step)
            if cur is None or key >= cur[:2]:
                best[step] = (*key, row)
        out[rank] = {s: r for s, (_, _, r) in best.items()}
    return out


def _phase_keys(rows: list[dict]) -> list[str]:
    keys: set[str] = set()
    for row in rows:
        for k, v in row.items():
            if _is_phase_key(k) and isinstance(v, (int, float)):
                keys.add(k)
    return sorted(keys)


@dataclasses.dataclass
class StragglerVerdict:
    """One flagged rank: its rolling step time ``value_s`` held above
    ``multiple`` x the gang median ``median_s`` for ``streak``
    consecutive observations."""

    rank: int
    ratio: float
    value_s: float
    median_s: float
    streak: int
    step: int | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class StragglerDetector:
    """Flags ranks whose step time runs away from the gang median.

    Feed :meth:`update` one sample per rank per observation window (a
    completed step offline; a supervisor poll live).  A rank is flagged
    when its value exceeds ``multiple`` x the median across ranks for
    ``consecutive`` observations in a row — one flag per episode: the
    rank must drop back under the threshold (which also resets its
    streak) before it can be flagged again.  ``None`` samples (rank has
    published no timing yet) are ignored; fewer than ``min_ranks``
    usable samples means no judgement at all — a median of one is not a
    gang.

    The detector is advisory by design (this PR detects; a later
    elastic-grow/backup-worker policy consumes): it never aborts
    anything, it only produces verdicts for counters, the health
    ledger, and the supervisor log.
    """

    def __init__(self, multiple: float = 4.0, consecutive: int = 3,
                 min_ranks: int = 2):
        if multiple <= 1.0:
            raise ValueError(
                f"multiple must be > 1 (a rank at the median is not a "
                f"straggler), got {multiple}"
            )
        if consecutive < 1:
            raise ValueError(
                f"consecutive must be >= 1, got {consecutive}"
            )
        if min_ranks < 2:
            raise ValueError(f"min_ranks must be >= 2, got {min_ranks}")
        self.multiple = multiple
        self.consecutive = consecutive
        self.min_ranks = min_ranks
        self.flagged: set[int] = set()
        self.flags_total = 0
        self.skew_ratio = 0.0
        self._streak: dict[int, int] = {}

    def update(self, samples: dict[int, float | None],
               step: int | None = None) -> list[StragglerVerdict]:
        clean = {r: float(v) for r, v in samples.items() if v is not None}
        if len(clean) < self.min_ranks:
            return []
        med = median(clean.values())
        self.skew_ratio = max(clean.values()) / med if med > 0 else 0.0
        if med <= 0:
            return []
        verdicts = []
        for rank in sorted(clean):
            v = clean[rank]
            if v > self.multiple * med:
                self._streak[rank] = self._streak.get(rank, 0) + 1
                if (self._streak[rank] >= self.consecutive
                        and rank not in self.flagged):
                    self.flagged.add(rank)
                    self.flags_total += 1
                    verdicts.append(StragglerVerdict(
                        rank=rank, ratio=v / med, value_s=v, median_s=med,
                        streak=self._streak[rank], step=step,
                    ))
            else:
                self._streak[rank] = 0
                self.flagged.discard(rank)  # recovery re-arms the flag
        return verdicts

    def reset_rank(self, rank: int) -> None:
        """Forget ``rank``'s episode state — the replace-policy hook:
        when a flagged rank is evicted and a new incarnation admitted
        (serving re-promotion, gang replace), the new one must be
        judged fresh, not inherit the old flag."""
        self._streak.pop(rank, None)
        self.flagged.discard(rank)


_SERVING_BY_RE = re.compile(r"^replica(\d+)$")


def serving_stage_samples(events, stage: str = "computed"
                          ) -> dict[int, float]:
    """Per-replica duration samples for one stage out of a request's
    stage-event record — ``{rank: dt_seconds}`` for every
    ``stage`` event stamped by a ``replica<r>`` actor with a rank-local
    delta attached (``dt`` is None when the prior stamp crossed a
    process boundary; those carry no duration and are skipped).

    This is the serving feed for :class:`StragglerDetector`: the
    ``computed`` event's ``dt`` is exactly the replica's compute
    interval (``computed`` − ``bound`` on that replica's own monotonic
    clock), so serving eviction and training straggler detection judge
    through one detector code path instead of the router keeping its
    own service-time bookkeeping off the beat channel.  When a request
    was attempted on several replicas (requeue after a death), the last
    sample per rank wins — the freshest observation of that replica.
    """
    out: dict[int, float] = {}
    for ev in events or ():
        if not isinstance(ev, dict) or ev.get("stage") != stage:
            continue
        dt = ev.get("dt")
        if not isinstance(dt, (int, float)):
            continue
        m = _SERVING_BY_RE.match(str(ev.get("by", "")))
        if m:
            out[int(m.group(1))] = float(dt)
    return out


@dataclasses.dataclass
class GangRollup:
    """Everything :func:`aggregate_gang_metrics` derives from a gang's
    per-rank streams — JSON-ready via :meth:`as_dict`."""

    ranks: list[int]
    steps: list[dict]          # per-step cross-rank rollups, step order
    per_rank: dict[int, dict]  # per-rank totals (rows, means, attempts)
    skew: dict                 # spread of the per-step skew ratios
    stragglers: list[dict]     # offline StragglerVerdicts, as dicts
    phases: list[str]          # every phase key seen in any stream

    def as_dict(self) -> dict:
        return {
            "ranks": self.ranks,
            "steps": self.steps,
            "per_rank": {str(r): v for r, v in self.per_rank.items()},
            "skew": self.skew,
            "stragglers": self.stragglers,
            "phases": self.phases,
        }


def aggregate_gang_metrics(root: str | os.PathLike, *, window: int = 4,
                           multiple: float = 4.0, consecutive: int = 3
                           ) -> GangRollup:
    """Cross-rank rollups over every per-rank metrics stream under
    ``root``.

    Per step (only ranks that recorded the step contribute — an
    elastic gang's lost rank simply stops contributing): the
    min/median/p95/max spread of ``iter_s`` and of every phase
    duration, per-rank examples/s, and ``skew`` = slowest/median
    ``iter_s``.  The offline straggler pass runs the same
    :class:`StragglerDetector` the live supervisor uses, over a
    ``window``-step rolling mean per rank.
    """
    streams = discover_rank_streams(root)
    by_rank = _rank_step_rows(streams)
    ranks = sorted(by_rank)
    all_steps = sorted({s for rows in by_rank.values() for s in rows})
    all_rows = [row for rows in by_rank.values() for row in rows.values()]
    phases = _phase_keys(all_rows)

    detector = StragglerDetector(multiple=multiple,
                                 consecutive=consecutive)
    rolling: dict[int, list[float]] = {r: [] for r in ranks}
    steps_out: list[dict] = []
    skews: list[float] = []
    verdicts: list[dict] = []
    for step in all_steps:
        present = {r: by_rank[r][step] for r in ranks
                   if step in by_rank[r]}
        iters = {r: float(row[_ITER_KEY]) for r, row in present.items()}
        entry: dict = {
            "step": step,
            "ranks": sorted(present),
            "iter_s": _spread(list(iters.values())),
        }
        med = median(iters.values())
        skew = max(iters.values()) / med if med > 0 else 0.0
        entry["skew"] = skew
        if skew:
            skews.append(skew)
        phase_block = {}
        for key in phases:
            vals = [float(row[key]) for row in present.values()
                    if isinstance(row.get(key), (int, float))]
            if vals:
                phase_block[key] = _spread(vals)
        if phase_block:
            entry["phases"] = phase_block
        eps = {r: float(row["examples_per_s"])
               for r, row in present.items()
               if isinstance(row.get("examples_per_s"), (int, float))}
        if eps:
            entry["examples_per_s"] = {str(r): v for r, v in eps.items()}
        steps_out.append(entry)
        # Offline straggler pass: rolling mean per rank, judged at the
        # step granularity — the same detector the supervisor feeds
        # live heartbeat samples.
        feed = {}
        for r, v in iters.items():
            win = rolling[r]
            win.append(v)
            del win[:-window]
            feed[r] = sum(win) / len(win)
        for v in detector.update(feed, step=step):
            verdicts.append(v.as_dict())

    per_rank: dict[int, dict] = {}
    for r in ranks:
        rows = list(by_rank[r].values())
        iters = [float(row[_ITER_KEY]) for row in rows]
        eps = [float(row["examples_per_s"]) for row in rows
               if isinstance(row.get("examples_per_s"), (int, float))]
        per_rank[r] = {
            "rows": len(rows),
            "attempts": sorted({int(row.get("attempt", 0))
                                for row in rows}),
            "last_step": max(by_rank[r]) if by_rank[r] else None,
            "iter_s_mean": sum(iters) / len(iters) if iters else 0.0,
            "examples_per_s_mean": (sum(eps) / len(eps)) if eps else None,
        }
    skew_block = _spread(skews) if skews else {
        "min": 0.0, "median": 0.0, "p95": 0.0, "max": 0.0
    }
    skew_block["last"] = skews[-1] if skews else 0.0
    return GangRollup(ranks=ranks, steps=steps_out, per_rank=per_rank,
                      skew=skew_block, stragglers=verdicts, phases=phases)


def publish_rollup(rollup: GangRollup, registry) -> None:
    """Mirror a rollup's verdicts into a metrics registry —
    ``gang_skew_ratio`` gauge (the run's latest per-step skew) and one
    ``gang_straggler{rank=...}`` count per offline verdict.  For
    post-mortem use into a FRESH registry; the live supervisor
    publishes its own verdicts as they happen (double-publishing both
    into one registry would double-count)."""
    registry.gauge("gang_skew_ratio").set(rollup.skew.get("last", 0.0))
    for v in rollup.stragglers:
        registry.counter("gang_straggler", rank=str(v["rank"])).inc()


# -- live sampling over the beat directory --------------------------------


@dataclasses.dataclass
class RankSample:
    """One rank's health at a sampling instant, from its heartbeat."""

    rank: int
    step: int
    age_s: float                   # progress age (see HeartbeatSampler)
    step_time_s: float | None      # published rolling mean, if any
    eff_step_time_s: float | None  # step_time_s, inflated by in-flight
    suspended: bool                # time when this rank holds the gang
    done: bool
    phases: dict


def read_beats(gang_dir: str | os.PathLike) -> dict[int, dict]:
    """rank -> latest heartbeat payload under ``gang_dir`` (torn writes
    and non-beat files skipped — the same tolerance every other gang
    reader applies)."""
    gang_dir = os.fspath(gang_dir)
    out: dict[int, dict] = {}
    try:
        names = os.listdir(gang_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(BEAT_PREFIX) and name.endswith(".json")):
            continue
        rank_s = name[len(BEAT_PREFIX):-len(".json")]
        if not rank_s.isdigit():
            continue
        try:
            with open(os.path.join(gang_dir, name)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # mid-replace torn read: next sample sees it whole
        if isinstance(payload, dict):
            out[int(rank_s)] = payload
    return out


def read_health_events(gang_dir: str | os.PathLike) -> list[dict]:
    """Every advisory event the supervisor recorded in the gang health
    ledger (straggler verdicts, restarts, shrinks), oldest first; a
    torn final line is dropped."""
    path = os.path.join(os.fspath(gang_dir), GANG_HEALTH_FILE)
    try:
        return [e for e in read_jsonl(path) if isinstance(e, dict)]
    except OSError:
        return []


class HeartbeatSampler:
    """Effective per-rank step times from the beat files, suitable for
    feeding :class:`StragglerDetector` live.

    Progress age uses the coordinator's own skew-free basis: staleness
    is *locally observed no-change time* — when did THIS sampler last
    see the rank's ``seq`` advance, on this host's monotonic clock —
    plus the ``beat_age`` the rank itself published.  Cross-host
    mtime/wall-clock comparison is never used (shared-mount skew of a
    minute is routine).

    Attribution rule: only ranks at the gang's MINIMUM published step
    have their in-flight time counted (``eff = max(rolling mean,
    progress age)``) — they are the ranks the lock-step barrier is
    actually waiting on.  Every rank ahead of the minimum is blocked on
    someone else, so its published rolling mean stands; without this
    rule one stalled rank starves the whole gang of progress and every
    rank's age grows in sympathy, which would push the median up and
    hide the true straggler.  Suspended ranks (checkpoint save, eval,
    compile) keep their rolling mean too: the coordinator already
    exempts declared non-step phases from progress judgement.
    """

    def __init__(self):
        # rank -> (last seen seq, monotonic time that seq first seen)
        self._seen: dict[int, tuple[int, float]] = {}

    def sample(self, gang_dir: str | os.PathLike | None,
               now: float | None = None,
               beats: dict[int, dict] | None = None
               ) -> dict[int, RankSample]:
        """``beats``: pre-read payloads from a
        ``GangTransport`` snapshot — the supervisor samples through its
        transport's batched read instead of globbing beat files; the
        offline tools keep passing a directory."""
        if beats is None:
            beats = read_beats(gang_dir)
        now = time.monotonic() if now is None else now
        live_steps = [int(p.get("step", 0)) for p in beats.values()
                      if not p.get("done")]
        min_step = min(live_steps) if live_steps else None
        out: dict[int, RankSample] = {}
        for rank, p in sorted(beats.items()):
            seq = int(p.get("seq", 0))
            seen = self._seen.get(rank)
            if seen is None or seen[0] != seq:
                self._seen[rank] = (seq, now)
                staleness = 0.0
            else:
                staleness = now - seen[1]
            age = staleness + float(p.get("beat_age", 0.0))
            metrics = p.get("metrics")
            stime = None
            phases = {}
            modeled = False
            if isinstance(metrics, dict):
                st = metrics.get("step_time_s")
                if isinstance(st, (int, float)):
                    stime = float(st)
                if isinstance(metrics.get("phases"), dict):
                    phases = metrics["phases"]
                modeled = bool(metrics.get("modeled"))
            step = int(p.get("step", 0))
            done = bool(p.get("done"))
            suspended = bool(p.get("suspended"))
            if stime is None or done or suspended or modeled:
                # ``modeled`` (the digital twin): step times are
                # VIRTUAL seconds — inflating them by real-clock
                # progress age would mix clocks and flag every rank a
                # busy CI core descheduled.  Liveness still rides the
                # real heartbeat (peer timeout), so an actually-dead
                # rank is caught by the monitor, not this rule.
                eff = stime
            elif min_step is not None and step <= min_step:
                eff = max(stime, age)
            else:
                eff = stime
            out[rank] = RankSample(
                rank=rank, step=step, age_s=age, step_time_s=stime,
                eff_step_time_s=eff, suspended=suspended, done=done,
                phases=phases,
            )
        return out
