"""The fleet's part of fault injection: fault classes, the robustness
counters, the fired-fault ledger readers and transport chaos.

Counterpart of ``distributed_machine_learning_tpu/runtime/faults.py``,
copied so the port imports nothing of the JAX package:

- :class:`InjectedFault` / :class:`InjectedKill` — the exception classes;
- :class:`FaultEvents` — every robustness counter, mirrored into the
  telemetry registry as it moves (``fault_events{kind=...}``);
- :data:`FAULT_LEDGER_FILE` and the ledger readers
  (:func:`ledger_entries`, the lost/recovered-rank views);
- :class:`ChaosAction` / :class:`TransportChaos` — the deterministic
  fault plan a lossy gang transport consults per send attempt.

The seeded step-level injector behind ``--faults`` (``FaultInjector``)
is not ported yet (ROADMAP A6): constructing it raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

# Cross-process fired-fault ledger (one JSON line per firing), kept in
# the gang directory: a gang relaunch re-execs every worker, and without
# the ledger each fresh process would re-parse the spec and re-fire the
# same kill forever — no number of restarts could ever finish the run.
FAULT_LEDGER_FILE = "faults_fired.jsonl"


class InjectedFault(RuntimeError):
    """A fault deliberately raised by the injector (data-path class)."""


class InjectedKill(InjectedFault):
    """A simulated process death mid-checkpoint.

    Raised (instead of ``os._exit``) so an in-process supervisor can
    observe the crash *boundary* — the half-written checkpoint is
    already on disk when this propagates, exactly as if the process had
    died there.
    """


@dataclasses.dataclass
class FaultEvents:
    """Counters for every robustness event — the observable surface.

    A silent recovery is indistinguishable from a bug that never
    triggered; every skip/retry/stall/restart increments a counter here,
    and ``utils/summary.py::resilience_summary`` renders the table the
    run prints.  Shared mutable state between the loop, the loaders, the
    watchdog, and the supervisor (all same-thread or GIL-atomic
    ``+= 1`` updates).
    """

    skipped_steps: int = 0      # non-finite-gradient guard skipped the update
    scaler_backoffs: int = 0    # dynamic loss scale halved on overflow
    scaler_growths: int = 0     # dynamic loss scale doubled after good steps
    loader_retries: int = 0     # data iterator recreated after an exception
    skipped_batches: int = 0    # batch dropped after exhausting its attempts
    stalls: int = 0             # watchdog declared a stall episode
    restarts: int = 0           # supervisor restored a checkpoint and retried
    preemptions: int = 0        # SIGTERM turned into a clean checkpointed stop
    ckpt_kills: int = 0         # injected death mid-checkpoint-save
    rank_kills: int = 0         # injected hard rank death (kill_rank)
    rank_losses: int = 0        # injected PERMANENT rank loss (lose_rank)
    rank_recoveries: int = 0    # injected rank recovery (recover_rank)
    rank_stalls: int = 0        # injected rank stall (stall_rank)
    ckpt_corruptions: int = 0   # injected post-save byte flips (corrupt_ckpt)
    peer_failures: int = 0      # gang detector declared a dead/stalled peer
    stragglers: int = 0         # advisory: rank flagged slow vs gang median
    gang_restarts: int = 0      # gang supervisor relaunched all workers
    gang_shrinks: int = 0       # gang continued at a smaller world size
    gang_grows: int = 0         # gang continued at a LARGER world size
    spare_promotions: int = 0   # warm spare promoted to a live rank
    spare_demotions: int = 0    # live rank demoted to warm spare
    reshard_restores: int = 0   # checkpoint restored onto a different world
    ckpt_verify_failures: int = 0  # checkpoint failed manifest verification
    ckpt_fallbacks: int = 0     # restore fell back past an invalid checkpoint
    transport_retries: int = 0  # gang-transport ops re-attempted (backoff)
    transport_timeouts: int = 0  # gang-transport ops that timed out/dropped
    replica_evictions: int = 0  # serving replicas evicted (dead or slow)
    drains: int = 0             # serving replicas drained gracefully
    request_rejects: int = 0    # serving requests rejected at admission
    weight_swaps: int = 0       # replica weight hot-swaps committed
    canary_promotions: int = 0  # deploys promoted fleet-wide (clean canary)
    canary_rollbacks: int = 0   # deploys rolled back (regression/SLO burn)
    link_degradations: int = 0  # injected gray link slowdown (degrade_link)
    link_flakes: int = 0        # injected lossy link (flaky_link)
    bw_collapses: int = 0       # injected node bandwidth collapse
    link_restorations: int = 0  # gray link state cleared (restore_link)

    def __setattr__(self, name: str, value) -> None:
        # Mirror every increment into the telemetry registry AS IT
        # HAPPENS (``fault_events{kind=...}`` counters) — the end-of-run
        # summary shows totals, but a restart wipes this object's host
        # memory while the streamed registry survives; catching the
        # write here instruments every `events.x += 1` site at once.
        prev = self.__dict__.get(name)
        object.__setattr__(self, name, value)
        if isinstance(prev, int) and isinstance(value, int) and value > prev:
            from distributed_machine_learning_tpu_torch.telemetry import (
                get_telemetry,
            )

            tel = get_telemetry()
            if tel is not None:
                tel.registry.counter("fault_events", kind=name).inc(
                    value - prev
                )
                tel.tracer.instant(f"fault_{name}")
                # Export NOW: the next thing after some of these events
                # is a process death (kill_ckpt's os._exit mode) — a
                # counter only in host memory at that point is lost,
                # and the re-exec would rehydrate stale totals.  Fault
                # events are rare; two atomic file writes each is
                # noise.
                tel.flush()

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)

    def total(self) -> int:
        return sum(self.as_dict().values())



class FaultInjector:
    """Not ported yet: the seeded step-level injector behind ``--faults``
    waits for the rest of the control plane (ROADMAP A6)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FaultInjector (--faults, DML_FAULTS) is not ported yet: ROADMAP A6")

    @classmethod
    def parse(cls, spec: str, *args, **kwargs) -> "FaultInjector":
        return cls()


def ledger_entries(path: str | os.PathLike) -> list[dict]:
    """Every parseable firing recorded in a fired-fault ledger (absent
    file = empty; a torn final line — a kill mid-append — is skipped,
    matching ``attach_ledger``)."""
    try:
        with open(os.fspath(path)) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            entry = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(entry, dict):
            out.append(entry)
    return out


def lost_ranks_from_entries(entries: list[dict]) -> set[int]:
    """Ranks whose ``lose_rank`` fault has fired, from parsed ledger
    entries (any transport backend)."""
    return {
        int(e["rank"]) for e in entries
        if e.get("kind") == "lose_rank" and isinstance(e.get("rank"), int)
    }


def recovered_ranks_from_entries(entries: list[dict]) -> set[int]:
    """Ranks whose ``recover_rank`` fault has fired, from parsed ledger
    entries — rank ids are the ``target`` field (ORIGINAL numbering):
    the acting process is a different, live rank."""
    return {
        int(e["target"]) for e in entries
        if e.get("kind") == "recover_rank"
        and isinstance(e.get("target"), int)
    }


def unrecovered_lost_from_entries(entries: list[dict]) -> set[int]:
    """Ranks currently lost, ORDER-AWARE: a ``recover_rank`` clears
    only the ``lose_rank`` entries appended BEFORE it.  Plain set
    subtraction would let one all-time recovery mask every later loss
    of the same rank — a host that dies again after recovering must
    count as lost again.  The ledger is append-only, so entry order is
    event order."""
    lost: set[int] = set()
    for e in entries:
        kind = e.get("kind")
        if kind == "lose_rank" and isinstance(e.get("rank"), int):
            lost.add(int(e["rank"]))
        elif kind == "recover_rank" and isinstance(e.get("target"), int):
            lost.discard(int(e["target"]))
    return lost


def ledger_lost_ranks(path: str | os.PathLike) -> set[int]:
    """Ranks whose ``lose_rank`` fault has fired, per the ledger — the
    marker the gang supervisor reads to declare a rank's restart budget
    exhausted (the fault IS the dead-host event; relaunching the rank
    would just re-lose it).  Rank ids are in the ORIGINAL numbering
    (stable across shrink renumberings — the gang worker keys its
    injector on ``--orig-rank``), so callers only intersect with the
    ranks still active."""
    return lost_ranks_from_entries(ledger_entries(path))


def ledger_recovered_ranks(path: str | os.PathLike) -> set[int]:
    """Ranks whose ``recover_rank`` fault has fired, per the ledger —
    the budget-recovered marker the elastic supervisor subtracts from
    :func:`ledger_lost_ranks` (the host came back; holding its
    ``lose_rank`` entry against it forever would make every loss
    permanent even after the recovery event)."""
    return recovered_ranks_from_entries(ledger_entries(path))


def ledger_unrecovered_lost_ranks(path: str | os.PathLike) -> set[int]:
    """File-backed form of :func:`unrecovered_lost_from_entries`."""
    return unrecovered_lost_from_entries(ledger_entries(path))


# ---------------------------------------------------------------------------
# Transport-level fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """What the chaos plan does to ONE transport send attempt."""

    drop: bool = False        # the medium ate the request (→ retry path)
    duplicate: bool = False   # delivered twice (same op_id → dedup path)
    delay_s: float = 0.0      # delivered late
    partitioned: bool = False  # channel severed: the op cannot leave


_NO_ACTION = ChaosAction()


class TransportChaos:
    """Deterministic fault plan for a LOSSY gang transport — the tests'
    proof that the TCP retry/backoff/idempotency layer works, rather
    than an assertion that it would.

    ``drop``/``duplicate``/``delay``: iterables of ``(op, nth)`` pairs —
    fire on the nth call (1-based, counted per op kind) of that
    operation; ``op`` may be ``"*"`` to match any operation (counted
    globally).  ``delay_s`` applies to every delayed delivery.
    ``partition_after``: sever the channel entirely after N total
    operations (every later send raises, as if this member's link was
    cut) — the partitioned rank stops beating, its peers declare it
    dead within ``peer_timeout_s``, and the rank itself self-aborts
    once the outage outlives the same timeout.

    ``degrade_after``: the GRAY counterpart of
    ``partition_after`` — after N total operations the channel goes
    slow-not-dead: every later send attempt carries
    ``degrade_delay_s`` of latency but still delivers.  This is the
    transport-level expression of ``degrade_link``: the member keeps
    beating (no peer-death escalation), it just beats late — exactly
    the failure the straggler detector, not the liveness machinery,
    must catch.

    Thread-safe: one plan is shared by a member's worker and monitor
    threads."""

    def __init__(self, *, drop=(), duplicate=(), delay=(),
                 partition_after: int | None = None,
                 delay_s: float = 0.05,
                 degrade_after: int | None = None,
                 degrade_delay_s: float = 0.05):
        self._drop = {(op, int(n)) for op, n in drop}
        self._dup = {(op, int(n)) for op, n in duplicate}
        self._delay = {(op, int(n)) for op, n in delay}
        self.partition_after = partition_after
        self.delay_s = float(delay_s)
        self.degrade_after = degrade_after
        self.degrade_delay_s = float(degrade_delay_s)
        self._counts: dict[str, int] = {}
        self._total = 0
        self._lock = threading.Lock()
        self.fired: list[tuple[str, str, int]] = []  # (action, op, nth)

    def _matches(self, plan: set, op: str, nth: int, any_nth: int) -> bool:
        return (op, nth) in plan or ("*", any_nth) in plan

    def plan(self, op: str) -> ChaosAction:
        """Called by the transport client once per SEND ATTEMPT (so a
        dropped op's retry is a fresh attempt that the plan may or may
        not hit again)."""
        with self._lock:
            self._total += 1
            self._counts[op] = self._counts.get(op, 0) + 1
            nth, any_nth = self._counts[op], self._total
            if (self.partition_after is not None
                    and self._total > self.partition_after):
                self.fired.append(("partition", op, any_nth))
                return ChaosAction(partitioned=True)
            degraded = (self.degrade_after is not None
                        and self._total > self.degrade_after)
            drop = self._matches(self._drop, op, nth, any_nth)
            dup = self._matches(self._dup, op, nth, any_nth)
            delay = self._matches(self._delay, op, nth, any_nth)
            if degraded:
                self.fired.append(("degrade", op, any_nth))
            if drop:
                self.fired.append(("drop", op, nth))
            if dup:
                self.fired.append(("duplicate", op, nth))
            if delay:
                self.fired.append(("delay", op, nth))
        if not (drop or dup or delay or degraded):
            return _NO_ACTION
        delay_s = self.delay_s if delay else 0.0
        if degraded:
            # Gray state is PERSISTENT: every attempt from here on is
            # slow — additive with a one-shot delay match.
            delay_s += self.degrade_delay_s
        return ChaosAction(drop=drop, duplicate=dup, delay_s=delay_s)
