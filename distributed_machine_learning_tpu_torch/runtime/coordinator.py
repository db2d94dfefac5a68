"""Gang coordination: heartbeats, peer-failure detection, coordinated
abort, and the restore-point election.

A copy of ``distributed_machine_learning_tpu/runtime/coordinator.py``.
The checkpoint side of the election (``ckpt_dirs`` given to
:func:`elect_restore_step`, and :func:`enforce_restore_point`) needs
the port's checkpoints, which are not ported yet (ROADMAP A3a): those
calls raise.

The supervisor heals a *single* process; a real data-parallel gang
(``runtime/distributed.py``, the reference's 4-node gloo cluster) fails
differently: one rank dies or stalls mid-collective and every other
rank blocks forever inside gloo/nccl with no Python frame to raise from.
Nothing inside the process can un-hang it — the only cure is for the
*survivors* to notice, abort hard, and for a gang supervisor
(``runtime/supervisor.py::gang_supervise``) to relaunch everyone
together from a checkpoint every rank agrees on.

The medium is a shared directory (``gang_dir``) because it is the one
channel both local multi-process gangs and multi-host clusters reliably
share (the hosts mount common storage; collectives are exactly the thing
we cannot trust during a failure).  Three file families live there:

- ``beat_rank<r>.json`` — rank r's heartbeat.  A daemon thread rewrites
  it every ``heartbeat_interval_s`` with the age of the rank's last
  *training progress* (``beat()`` calls from the step loop).  File
  mtime going stale means the process died; a fresh file whose
  ``beat_age`` exceeds the timeout means the process is alive but stuck
  (hung collective, wedged loader).  ``suspend()`` marks expected-long
  non-step phases (checkpoint save, eval, compile, rendezvous) so they
  are not judged as stalls — liveness detection keeps running.
- ``restore_rank<r>.json`` — rank r's restore-point record: every
  checkpoint step it has locally verified (saved successfully or
  restored from).  The election (``elect_restore_step``) intersects all
  ranks' records and picks the highest step every rank agrees on —
  the only step where a coordinated relaunch is guaranteed to find all
  shards of one consistent checkpoint.
- ``abort.json`` — the coordinated-abort latch.  The first rank to
  declare a peer dead writes it (atomically, first writer wins) and
  exits with :data:`GANG_ABORT_EXIT`; every other rank's monitor sees
  the file and exits too, so the whole gang tears down within one
  heartbeat interval instead of hanging on the dead peer.

Everything here is host-side stdlib (files + one daemon thread per
rank): the compiled step and the collectives are never touched, and a
rank blocked inside a collective can still be aborted because
``os._exit`` works from the monitor thread.

Telemetry: ``gang_heartbeat_age_s{rank=...}`` gauges track every
peer's progress age; ``gang_peer_failures`` counts declarations; all
abort events flush before exit so the post-mortem trace survives.

Observability plane: heartbeats are ENRICHED — each beat
carries a compact metric snapshot (current step, rolling step time
over the last ``metrics_window`` completed steps, last per-phase
breakdown) published by :meth:`GangCoordinator.observe_step`, so
liveness and progress travel on one channel and the gang supervisor's
straggler detector (``telemetry/aggregator.py``) reads the whole
gang's health from the beat directory alone.  Advisory verdicts and
restart/shrink events land in ``gang_health.jsonl``
(:func:`append_health_event`), the whole-run ledger
``tools/gang_status.py`` renders.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

# Exit code of a coordinated gang abort — distinct from an injected rank
# death (runtime/faults.py::KILL_RANK_EXIT) so logs show who was the
# victim and who pulled the cord.
GANG_ABORT_EXIT = 43

ABORT_FILE = "abort.json"
_BEAT_PREFIX = "beat_rank"
_RESTORE_PREFIX = "restore_rank"

# Per-rank consumed-example ledgers written by runtime/gang_worker.py
# (the elastic exactly-once audit trail).  Cleared with the fault
# ledger at fresh-run init — but NOT across restarts or shrinks, where
# they are the whole-run history a post-mortem reads.
CONSUMED_PREFIX = "consumed_rank"

# The gang health ledger: one JSON line per advisory event the gang
# supervisor records (straggler verdicts, restarts, shrinks, grows,
# promotions/demotions) — the durable half of the observability plane,
# read back by ``telemetry/aggregator.py::read_health_events`` and
# ``tools/gang_status.py``.  Whole-run history like the consumption
# ledgers: survives restarts and shrinks, cleared only at fresh-run
# init.
GANG_HEALTH_FILE = "gang_health.jsonl"

# The join/announcement channel (elastic GROW): one
# ``join_rank<r>.json`` per member announcing itself to the supervisor
# — a recovered host asking to be readmitted, or a warm spare
# publishing that it is alive and which checkpoint step it has
# prefetched.  Written atomically by the announcing process, consumed
# (deleted) by the supervisor when it ADMITS the member at a
# coordinated restart/grow boundary; pending announcements survive
# restarts and shrinks (they are exactly what the next boundary reads)
# and are cleared only at fresh-run init, like the ledgers above.
JOIN_PREFIX = "join_rank"


# ---------------------------------------------------------------------------
# Deterministic-scheduler seam (dmlcheck layer 3)
# ---------------------------------------------------------------------------
# ``analysis/interleave.py`` installs a cooperative scheduler here to
# explore thread interleavings of the gang control plane under its own
# control.  The hooks live in THIS module because it is the bottom of
# the runtime import chain (``runtime/transport.py`` already imports
# it, so the transport aliases these rather than the reverse).  With no
# scheduler installed — every production and ordinary-test run — a
# schedule point is one global read and a None test.

_SCHED = None


def install_scheduler(sched) -> None:
    """Route every schedule point to ``sched`` (layer-3 exploration
    only; one scheduler per process at a time)."""
    global _SCHED
    _SCHED = sched


def uninstall_scheduler() -> None:
    global _SCHED
    _SCHED = None


def _sched_point(label: str) -> None:
    """A schedule point: under an installed scheduler the calling
    thread (if registered with it) yields control here and resumes only
    when scheduled.  ``label`` is structured ``channel:...[:r|:w]`` so
    the explorer can judge independence of adjacent steps."""
    sched = _SCHED
    if sched is not None:
        sched.point(label)


def _sched_block(label: str, predicate) -> bool:
    """A blocking schedule point: the thread is descheduled until
    ``predicate()`` turns true (the seam for real waits like
    ``_InFlight.wait`` — a cooperatively-scheduled thread must never
    sit in a native wait the scheduler cannot see).  Returns True when
    a scheduler handled the wait (the predicate now holds), False when
    the caller must fall back to its real blocking wait."""
    sched = _SCHED
    if sched is not None:
        return sched.block(label, predicate)
    return False


def _beat_path(gang_dir: str, rank: int) -> str:
    return os.path.join(gang_dir, f"{_BEAT_PREFIX}{rank}.json")


def _restore_path(gang_dir: str, rank: int) -> str:
    return os.path.join(gang_dir, f"{_RESTORE_PREFIX}{rank}.json")


def _write_atomic(path: str, payload: dict) -> None:
    # Tmp name unique per process AND thread: the monitor thread and the
    # main thread (finish()) may both be writing this rank's beat file.
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def append_health_event(gang_dir: str | os.PathLike, kind: str,
                        **fields) -> None:
    """Record one advisory event in the gang health ledger — flushed
    AND fsynced before returning (dmlcheck DML002): the next supervisor
    action may be tearing the gang down via ``os._exit``, and a verdict
    that only reached the page cache at that point is lost with it."""
    payload = {"kind": kind, "time": time.time(), **fields}
    gang_dir = os.fspath(gang_dir)
    os.makedirs(gang_dir, exist_ok=True)
    with open(os.path.join(gang_dir, GANG_HEALTH_FILE), "a") as f:
        f.write(json.dumps(payload) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _join_path(gang_dir: str, rank: int) -> str:
    return os.path.join(gang_dir, f"{JOIN_PREFIX}{rank}.json")


def announce_join(gang_dir: str | os.PathLike, rank: int, *,
                  spare: bool = False, prefetched_step: int | None = None,
                  **fields) -> None:
    """Publish (or refresh) a join announcement for ORIGINAL-rank
    ``rank`` — the member's half of the grow protocol.  A recovered
    host announces ``spare=False`` (readmit me); a warm spare
    announces ``spare=True`` with the checkpoint step it has
    prefetched (``prefetched_step``), refreshed every heartbeat so the
    supervisor can tell a live spare from a dead announcement.
    Atomic overwrite: re-announcing is idempotent and the supervisor
    never reads a torn payload."""
    if rank < 0:
        raise ValueError(f"rank must be >= 0, got {rank}")
    gang_dir = os.fspath(gang_dir)
    os.makedirs(gang_dir, exist_ok=True)
    payload = {"rank": int(rank), "spare": bool(spare),
               "time": time.time(), **fields}
    if prefetched_step is not None:
        payload["prefetched_step"] = int(prefetched_step)
    _write_atomic(_join_path(gang_dir, rank), payload)


def read_joins(gang_dir: str | os.PathLike) -> dict[int, dict]:
    """rank -> announcement payload for every pending join under
    ``gang_dir`` (torn writes skipped — the next poll sees them
    whole)."""
    gang_dir = os.fspath(gang_dir)
    out: dict[int, dict] = {}
    try:
        names = os.listdir(gang_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(JOIN_PREFIX) and name.endswith(".json")):
            continue
        rank_s = name[len(JOIN_PREFIX):-len(".json")]
        if not rank_s.isdigit():
            continue
        try:
            with open(os.path.join(gang_dir, name)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(payload, dict):
            out[int(rank_s)] = payload
    return out


def consume_join(gang_dir: str | os.PathLike, rank: int) -> None:
    """Remove rank ``rank``'s announcement — called by the supervisor
    at the boundary that ADMITS the member, so the same announcement
    can never drive two grows."""
    with contextlib.suppress(OSError):
        os.remove(_join_path(os.fspath(gang_dir), rank))


def read_abort(gang_dir: str | os.PathLike) -> dict | None:
    """The abort latch's payload, or None when no abort was declared.
    Tolerates a torn write (another rank mid-``os.replace``) by treating
    it as not-yet-declared — the next poll sees the complete file."""
    try:
        with open(os.path.join(os.fspath(gang_dir), ABORT_FILE)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def declare_abort(gang_dir: str | os.PathLike, reason: str,
                  by_rank: int, peer: int | None = None) -> bool:
    """Write the abort latch; returns True if THIS call won the race
    (False: someone already declared — their reason stands)."""
    path = os.path.join(os.fspath(gang_dir), ABORT_FILE)
    payload = {"reason": reason, "by_rank": by_rank, "time": time.time()}
    if peer is not None:
        payload["peer"] = peer
    try:
        with open(path, "x") as f:
            json.dump(payload, f)
        return True
    except FileExistsError:
        return False


def clear_gang_state(gang_dir: str | os.PathLike,
                     restore_records: bool = False,
                     fault_ledger: bool | None = None) -> None:
    """Remove the previous attempt's beats and abort latch (and, for a
    fresh run, the restore-point records and the fired-fault ledger).
    Restore records and the ledger survive between restart attempts by
    design: the records ARE the election input, and the ledger is what
    keeps an already-fired fault from re-firing in the relaunch.

    ``fault_ledger`` decouples the ledger from the records (default:
    follows ``restore_records``): a gang SHRINK renumbers ranks, so the
    old numbering's restore records must go — but the ledger must stay,
    or every already-fired fault would re-fire on whichever survivor
    inherited the fired rank's number.  Join announcements follow the
    same fresh-run-only rule: a pending join must survive the very
    boundary that will admit it (the supervisor consumes it there),
    while a stale one from an earlier run must not trigger a phantom
    grow."""
    from distributed_machine_learning_tpu_torch.runtime.faults import (
        FAULT_LEDGER_FILE,
    )

    if fault_ledger is None:
        fault_ledger = restore_records
    gang_dir = os.fspath(gang_dir)
    if not os.path.isdir(gang_dir):
        os.makedirs(gang_dir, exist_ok=True)
        return
    for name in os.listdir(gang_dir):
        if (name == ABORT_FILE or name.startswith(_BEAT_PREFIX)
                or (restore_records and name.startswith(_RESTORE_PREFIX))
                or (fault_ledger
                    and (name == FAULT_LEDGER_FILE
                         or name == GANG_HEALTH_FILE
                         or name.startswith(CONSUMED_PREFIX)
                         or name.startswith(JOIN_PREFIX)))):
            with contextlib.suppress(OSError):
                os.remove(os.path.join(gang_dir, name))


def read_restore_record(gang_dir: str | os.PathLike, rank: int
                        ) -> set[int] | None:
    """The set of checkpoint steps rank ``rank`` has verified, or None
    when the rank never recorded one (fresh start / died pre-save)."""
    try:
        with open(_restore_path(os.fspath(gang_dir), rank)) as f:
            payload = json.load(f)
        return {int(s) for s in payload.get("steps", [])}
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def _as_dirs(ckpt_dirs) -> list[str]:
    if ckpt_dirs is None:
        return []
    if isinstance(ckpt_dirs, (str, os.PathLike)):
        return [os.fspath(ckpt_dirs)]
    return [os.fspath(d) for d in ckpt_dirs]


def elect_restore_step(gang_dir: str | os.PathLike, world: int,
                       ckpt_dirs=None, ranks=None,
                       transport=None) -> int | None:
    """The highest checkpoint step EVERY rank has verified (the
    intersection of all restore-point records), or None when no common
    step exists — the gang then starts from scratch / whatever the
    fallback chain finds.

    ``ckpt_dirs``: one shared checkpoint directory, or one per rank
    (per-host shard layouts).  When given, candidate steps are
    additionally filtered through the on-disk validity check
    (``validate_checkpoint``) in EVERY directory, so an
    agreed-but-since-corrupted checkpoint is never elected.

    ``ranks``: the ranks whose agreement matters (default: all of
    ``range(world)``).  The shrink-to-survivors path elects among the
    SURVIVORS only — a permanently lost rank can never verify anything
    again, and demanding its vote would strand the gang at step None
    forever.

    ``transport``: a ``runtime/transport.py::GangTransport`` to read
    the records through (the pluggable control plane); None keeps the
    historical direct-file read of ``gang_dir``.
    """
    if _as_dirs(ckpt_dirs):
        raise NotImplementedError(
            "electing a restore step against checkpoint directories needs "
            "the port's checkpoints, not ported yet: ROADMAP A3a")
    gang_dir = os.fspath(gang_dir) if gang_dir is not None else None
    common: set[int] | None = None
    for rank in (range(world) if ranks is None else ranks):
        steps = (transport.read_restore_record(rank)
                 if transport is not None
                 else read_restore_record(gang_dir, rank))
        if steps is None:
            return None  # a rank with no record can't agree on anything
        common = steps if common is None else (common & steps)
    return max(common) if common else None


def enforce_restore_point(ckpt_dirs, step: int | None) -> list[str]:
    """Quarantine every complete checkpoint newer than the elected
    ``step`` (in each of ``ckpt_dirs``) so a relaunched gang's fallback
    chain resolves to the SAME restore point on every rank; returns the
    paths quarantined.  A newer checkpoint that not every rank verified
    may be torn on some host — restoring it would diverge the gang.
    ``step=None`` quarantines nothing (no agreement ⇒ the fallback
    chain decides)."""
    if not _as_dirs(ckpt_dirs):
        return []
    raise NotImplementedError(
        "enforcing a restore point on checkpoint directories needs the "
        "port's checkpoints, not ported yet: ROADMAP A3a")


class GangCoordinator:
    """One rank's view of the gang: writes its own heartbeat, watches
    every peer's, and aborts the process (loudly, via the shared latch)
    when a peer dies or stalls past ``peer_timeout_s``.

    Usage (one per worker process)::

        coord = GangCoordinator(gang_dir, rank=r, world=n,
                                peer_timeout_s=30).start()
        with coord.suspend():
            ...rendezvous / compile...
        for batch in batches:
            ...train step...
            coord.beat(step)
            ...checkpoint inside coord.suspend(); then
            coord.record_valid_step(step)...
        coord.stop()

    ``on_abort``: test hook replacing ``os._exit`` (receives the
    reason); production leaves it None — a hung collective can only be
    escaped by process death, which is exactly what the gang supervisor
    expects.  ``check_self=True`` also self-declares when this rank's
    own progress stalls past the timeout (the stalled rank usually
    notices first: its monitor thread keeps running while the main
    thread sleeps/hangs).

    ``transport``: a ``runtime/transport.py::GangTransport``
    carrying every channel above; None builds the historical file
    backend over ``gang_dir`` (byte-identical layout).  With a lossy
    transport (TCP), a persistent ``TransportError`` streak longer
    than ``peer_timeout_s`` is treated as THIS rank being partitioned
    off the gang — peer death seen from the inside — and aborts the
    process just like a dead peer would.
    """

    def __init__(self, gang_dir: str | os.PathLike | None, rank: int,
                 world: int,
                 *, heartbeat_interval_s: float = 1.0,
                 peer_timeout_s: float = 30.0,
                 exit_code: int = GANG_ABORT_EXIT,
                 events=None, check_self: bool = True, on_abort=None,
                 metrics_window: int = 8, transport=None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if not 0 <= rank < world:
            raise ValueError(f"rank must be in [0, {world}), got {rank}")
        if heartbeat_interval_s <= 0:
            raise ValueError(
                f"heartbeat_interval_s must be > 0, got "
                f"{heartbeat_interval_s}"
            )
        if peer_timeout_s <= 2 * heartbeat_interval_s:
            raise ValueError(
                f"peer_timeout_s ({peer_timeout_s}) must exceed two "
                f"heartbeat intervals ({heartbeat_interval_s} each): a "
                "single delayed write would otherwise read as a death"
            )
        if gang_dir is None and transport is None:
            raise ValueError("a coordinator needs gang_dir or transport")
        self.gang_dir = os.fspath(gang_dir) if gang_dir is not None \
            else None
        if transport is None:
            from distributed_machine_learning_tpu_torch.runtime.transport import (
                FileTransport,
            )

            transport = FileTransport(self.gang_dir, events=events)
        elif self.gang_dir is not None:
            os.makedirs(self.gang_dir, exist_ok=True)
        self.transport = transport
        self.rank = rank
        self.world = world
        self.heartbeat_interval_s = heartbeat_interval_s
        self.peer_timeout_s = peer_timeout_s
        self.exit_code = exit_code
        self.events = events
        self.check_self = check_self
        self.on_abort = on_abort
        self.aborted: str | None = None  # reason, once declared/observed
        self._seq = 0
        self._step = 0
        self._done = False
        self._suspended = 0
        self.suspensions = 0
        self._last_beat = time.monotonic()
        self._valid_steps: set[int] = set()
        if metrics_window < 1:
            raise ValueError(
                f"metrics_window must be >= 1, got {metrics_window}"
            )
        # The heartbeat metric snapshot: liveness and
        # progress travel on the same channel, so the supervisor's
        # straggler detector needs no second file family.  Appends are
        # GIL-atomic; the monitor thread reads a list() copy.
        self._step_times: collections.deque[float] = collections.deque(
            maxlen=metrics_window
        )
        self._phases: dict = {}
        # Digital-twin flag: when the harness reports
        # MODELED step times through ``observe_step`` (virtual
        # seconds, not this thread's wall time), beats mark their
        # metrics ``modeled`` so the supervisor's sampler judges the
        # model's clock only — wall-clock progress age is meaningless
        # when 512 thread-ranks share one core.  Liveness is
        # unaffected: heartbeats ride the real clock either way.
        self.modeled_time = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._write_lock = threading.Lock()
        # peer -> (beat signature, monotonic time this monitor first
        # saw that signature) — the skew-free staleness basis.  The
        # signature is transport-opaque (file: (mtime_ns, size); hub: a
        # version counter).
        self._peer_seen: dict[int, tuple[object, float]] = {}
        self._started_at = time.monotonic()
        # Monotonic instant the transport started failing (None =
        # healthy): the partition-is-peer-death escalation clock.
        self._tx_down_since: float | None = None

    # -- liveness/progress surface --------------------------------------
    def beat(self, step: int | None = None) -> None:
        """Record training progress — call once per completed step.
        In-memory only (no IO on the step path); the monitor thread
        publishes it at the heartbeat interval."""
        self._last_beat = time.monotonic()
        if step is not None:
            self._step = int(step)

    def observe_step(self, step: int, step_time_s: float,
                     phases: dict | None = None) -> None:
        """Record one completed step's wall time (and optional
        per-phase breakdown, ``{"barrier_wait_s": ..., ...}``) and
        beat.  The rolling mean over the last ``metrics_window`` steps
        rides every heartbeat as a compact metric snapshot — the
        signal the gang supervisor's straggler detector compares
        across ranks without touching any rank's metrics stream."""
        self._step_times.append(float(step_time_s))
        if phases:
            self._phases = {str(k): float(v) for k, v in phases.items()}
        self.beat(step)

    @contextlib.contextmanager
    def suspend(self):
        """Mark an expected-long non-step phase (checkpoint save, eval,
        compile, rendezvous): peers keep checking that this process is
        ALIVE (the heartbeat file keeps refreshing) but stop judging its
        progress age.  Re-entrant; beats on exit.  ``suspensions``
        counts entries monotonically, so interval-based step timers
        (``cli/common.py``'s stop-predicate deltas) can tell a pure
        step apart from one whose interval swallowed an eval or save."""
        self.suspensions += 1
        self._suspended += 1
        try:
            yield
        finally:
            try:
                self.beat()
            finally:
                self._suspended -= 1

    def peer_state(self, peer: int) -> dict | None:
        """The peer's latest heartbeat payload, or None (never wrote /
        torn write)."""
        from distributed_machine_learning_tpu_torch.runtime.transport import (
            TransportError,
        )

        try:
            entry = self.transport.read_beat(peer)
        except TransportError:
            return None
        return entry[1] if entry is not None else None

    def wait_for_peers(self, step: int, poll_s: float | None = None,
                       stop=None) -> bool:
        """Block until every peer's published step reaches ``step`` (or
        the peer finished its run) — a lock-step barrier over the beat
        directory.

        This is the harness's stand-in for a synchronous collective
        where real cross-process collectives are unavailable (the CI
        host's CPU backend): it hangs exactly when a collective would —
        a dead or stalled peer never publishes the step — and is freed
        the same way: the monitor thread declares the peer and aborts
        this process.  Deliberately does NOT suspend the stall clock:
        time spent starved at the barrier is exactly what the detector
        must judge.  Returns False only in test mode (``on_abort`` set)
        once an abort was observed; production never returns False
        (the abort exits the process).

        ``poll_s`` defaults to the transport's barrier cadence; the
        read is BATCHED (one ``read_beats`` per poll for the whole
        gang, not one per peer — at world 128 over TCP the difference
        is the rank-0 host's life).  ``stop``: optional zero-arg
        predicate; True releases the barrier with False (the in-proc
        drain path — a thread cannot be SIGTERMed out of a wait)."""
        from distributed_machine_learning_tpu_torch.runtime.transport import (
            TransportError,
        )

        if poll_s is None:
            poll_s = self.transport.barrier_poll_s()
        # Pod-scale seam: a transport may expose ``barrier_ready`` — a
        # single-pass, copy-free readiness probe.  The generic path
        # below snapshots the whole beat table per poll, which at 512
        # thread-ranks costs ~150µs × world pollers and saturates the
        # CI core; the in-proc fast path is what keeps the digital-twin
        # campaigns in tier-1 time.
        ready_fn = getattr(self.transport, "barrier_ready", None)
        while True:
            if self.aborted is not None:
                return False
            if stop is not None and stop():
                return False
            if ready_fn is not None:
                try:
                    ready = ready_fn(step, self.rank, self.world)
                except TransportError:
                    ready = False
            else:
                try:
                    beats = self.transport.read_beat_payloads()
                except TransportError:
                    beats = {}  # the monitor escalates a persistent outage
                ready = True
                for peer in range(self.world):
                    if peer == self.rank:
                        continue
                    payload = beats.get(peer)
                    if payload is None or (
                            not payload.get("done")
                            and int(payload.get("step", -1)) < step):
                        ready = False
                        break
            if ready:
                return True
            time.sleep(poll_s)

    def finish(self) -> None:
        """Publish clean completion and stop the monitor: a rank that
        finished its run must read as healthy forever (its heartbeat
        file will never refresh again), not as a death to declare."""
        self._done = True
        self._write_beat()
        self.stop()

    def record_valid_step(self, step: int) -> None:
        """Publish that this rank verified checkpoint ``step`` (its save
        returned, or it restored from it) — the rank's half of the
        restore-point election.  Written through the beat directory
        immediately: the record must survive this process dying at any
        later moment.

        MERGES with the record already on disk: a relaunched process
        starts with an empty in-memory set, and overwriting would drop
        the previously agreed steps from this rank's record — the
        election would then lose its only common point the moment any
        rank saved once after a restart."""
        self._valid_steps.add(int(step))
        _sched_point("coord:restore:rmw")
        prior = self.transport.read_restore_record(self.rank)
        if prior:
            self._valid_steps |= prior
        self.transport.write_restore_record(
            self.rank, sorted(self._valid_steps))

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "GangCoordinator":
        if self._thread is not None:
            raise RuntimeError("coordinator already started")
        if self.gang_dir is not None:
            os.makedirs(self.gang_dir, exist_ok=True)
        self._started_at = time.monotonic()
        self._last_beat = time.monotonic()
        self._write_beat()
        self._thread = threading.Thread(
            target=self._run, name=f"gang-coordinator-r{self.rank}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "GangCoordinator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals -------------------------------------------------------
    def _write_beat(self) -> None:
        _sched_point("coord:beat:w")
        with self._write_lock:
            self._write_beat_locked()

    def _write_beat_locked(self) -> None:
        now = time.monotonic()
        self._seq += 1
        payload = {
            "rank": self.rank,
            "seq": self._seq,
            "step": self._step,
            "beat_age": now - self._last_beat,
            "suspended": bool(self._suspended),
            "done": self._done,
            "time": time.time(),
        }
        times = list(self._step_times)
        if times:
            payload["metrics"] = {
                "step_time_s": sum(times) / len(times),
                "last_step_time_s": times[-1],
                "steps_timed": len(times),
                "phases": self._phases,
            }
            if self.modeled_time:
                payload["metrics"]["modeled"] = True
        from distributed_machine_learning_tpu_torch.runtime.transport import (
            TransportError,
        )

        try:
            self.transport.publish_beat(self.rank, payload)
        except TransportError:
            # A failed publish is transport-outage evidence, not a
            # crash: the monitor loop escalates once the outage
            # outlives peer_timeout_s.
            self._note_transport(ok=False)
        # A SUCCESSFUL publish deliberately does NOT reset the outage
        # clock: on a half-open link (tiny beat writes succeed, the
        # ~world-sized batched reads keep timing out) a rank that can
        # publish but cannot observe the gang is still blind — it can
        # neither join an abort nor judge peers, and must escalate on
        # the READ path's schedule.  Only _run's successful read cycle
        # resets.

    def _note_transport(self, ok: bool) -> None:
        if ok:
            self._tx_down_since = None
        elif self._tx_down_since is None:
            self._tx_down_since = time.monotonic()

    def _telemetry(self):
        from distributed_machine_learning_tpu_torch.telemetry import get_telemetry

        return get_telemetry()

    def _abort(self, reason: str, peer: int | None = None) -> None:
        """Declare (or join) the gang abort and kill this process."""
        from distributed_machine_learning_tpu_torch.runtime.transport import (
            TransportError,
        )

        try:
            won = self.transport.declare_abort(reason, self.rank,
                                               peer=peer)
        except TransportError:
            # Partitioned off the gang: the latch is unreachable, but
            # this rank must still die loudly — the peers' detectors
            # will read its silence as the death it is.
            won = False
        self.aborted = reason
        if won and self.events is not None and peer is not None:
            self.events.peer_failures += 1
        tel = self._telemetry()
        if tel is not None:
            if won:
                tel.registry.counter("gang_peer_failures").inc()
            tel.tracer.instant("gang_abort", reason=reason)
            tel.flush()
        print(
            f"[gang] rank {self.rank} aborting: {reason} "
            f"(exit {self.exit_code})",
            flush=True,
        )
        if self.on_abort is not None:
            self.on_abort(reason)
            return
        os._exit(self.exit_code)

    def _check_peer(self, peer: int, entry, now: float, tel
                    ) -> str | None:
        """None if the peer looks healthy, else the failure reason.
        ``entry`` is the peer's ``(signature, payload)`` from this
        poll's batched ``read_beats`` (None: never published).

        Staleness is judged by LOCALLY-OBSERVED change (when did THIS
        monitor last see the peer's beat signature advance, on this
        host's monotonic clock), never by comparing wall clocks to
        filesystem mtimes: on the shared mounts pods actually use,
        cross-host clock/mtime skew of a minute is routine and would
        otherwise read as instant death (or mask a real one)."""
        if entry is None:
            # Never beat at all: allow a full timeout from gang start
            # (the peer may still be exec'ing / rendezvousing).
            if now - self._started_at > self.peer_timeout_s:
                return (f"rank {peer} never wrote a heartbeat within "
                        f"{self.peer_timeout_s}s of gang start")
            return None
        sig, payload = entry
        seen = self._peer_seen.get(peer)
        if seen is None or seen[0] != sig:
            self._peer_seen[peer] = (sig, now)
            file_age = 0.0
        else:
            file_age = now - seen[1]
        if payload is not None and payload.get("done"):
            return None  # finished cleanly: healthy forever (file frozen)
        if file_age > self.peer_timeout_s:
            return (f"rank {peer} heartbeat last changed "
                    f"{file_age:.1f}s ago (timeout {self.peer_timeout_s}s)"
                    ": process dead")
        if payload is None or payload.get("suspended"):
            return None
        progress_age = file_age + float(payload.get("beat_age", 0.0))
        if tel is not None:
            tel.registry.gauge(
                "gang_heartbeat_age_s", rank=str(peer)
            ).set(progress_age)
        # Stalls are judged at 1.5x the death timeout: when one rank
        # dies, every survivor blocked on it is ALSO progress-starved —
        # the extra half-window lets the true cause (the dead peer's
        # stale file) win the declaration race, so the abort reason
        # names the victim, not a symptom.
        if progress_age > 1.5 * self.peer_timeout_s:
            return (f"rank {peer} made no step progress for "
                    f"{progress_age:.1f}s (stall timeout "
                    f"{1.5 * self.peer_timeout_s:.1f}s): stalled (hung "
                    "collective or wedged input)")
        return None

    def _run(self) -> None:
        from distributed_machine_learning_tpu_torch.runtime.transport import (
            TransportError,
        )

        # Poll cadence is a TRANSPORT property: file keeps
        # the historical min(heartbeat, timeout/4); in-proc polls
        # tightly (reads are dict lookups); TCP scales the interval
        # with the world so 128 monitors cannot self-DoS rank 0.
        poll_s = self.transport.monitor_poll_s(
            self.heartbeat_interval_s, self.peer_timeout_s, self.world)
        while not self._stop.wait(poll_s):
            self._write_beat()
            now = time.monotonic()
            try:
                abort = self.transport.read_abort()
                beats = self.transport.read_beats() if abort is None \
                    else {}
            except TransportError:
                # Connection loss IS peer-death evidence — for THIS
                # rank: a member that cannot reach the gang for a full
                # peer timeout is partitioned off it, and its peers are
                # already reading its silence as a death.
                self._note_transport(ok=False)
                if now - self._tx_down_since > self.peer_timeout_s:
                    self._abort(
                        f"rank {self.rank} lost the gang transport for "
                        f"{now - self._tx_down_since:.1f}s (timeout "
                        f"{self.peer_timeout_s}s): partitioned off the "
                        "gang", peer=self.rank,
                    )
                    return
                continue
            self._note_transport(ok=True)
            if abort is not None:
                self._abort(
                    f"joining gang abort declared by rank "
                    f"{abort.get('by_rank')}: {abort.get('reason')}"
                )
                return
            tel = self._telemetry()
            if (self.check_self and not self._suspended
                    and now - self._last_beat > 1.5 * self.peer_timeout_s):
                self._abort(
                    f"rank {self.rank} (self) made no step progress for "
                    f"{now - self._last_beat:.1f}s "
                    f"(stall timeout {1.5 * self.peer_timeout_s:.1f}s)",
                    peer=self.rank,
                )
                return
            for peer in range(self.world):
                if peer == self.rank:
                    continue
                reason = self._check_peer(peer, beats.get(peer), now,
                                          tel)
                if reason is not None:
                    self._abort(reason, peer=peer)
                    return
