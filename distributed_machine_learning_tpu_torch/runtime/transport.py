"""Pluggable gang transport — the control-plane seam.

A copy of ``distributed_machine_learning_tpu/runtime/transport.py``, so
the port imports nothing of the JAX package (the serving fleet's
channels, the gang channels and :func:`stamp_stage`).

Every coordination channel the gang stack uses — heartbeats, the
first-writer-wins abort latch, join announcements, restore-point
records, the health/fault/consumption ledgers, and the between-attempt
state clear — historically lived as files in a shared ``gang_dir``
(``runtime/coordinator.py``).  Correct, but it hard-capped gang tests
at worlds ≤ 5 (one OS process per rank), assumed a shared filesystem,
and left the resilience stack unproven at the worlds the papers it
reproduces run at (arxiv 1811.05233's hundreds of replicas).

:class:`GangTransport` extracts that channel set as an interface with
three backends:

- :class:`FileTransport` — today's behavior, delegated verbatim to the
  ``runtime/coordinator.py`` file functions: the on-disk format is
  byte-compatible with the reference's, the fsync discipline on the
  ledgers is preserved (dmlcheck DML002), and a coordinator built
  without an explicit transport gets exactly this.
- :class:`InProcTransport` over an :class:`InProcHub` — threads +
  in-memory channels: no shared filesystem, no subprocess spawn.  This
  is what makes 64-128-rank supervised gangs run in seconds and
  unlocks the chaos *campaigns* (``runtime/inproc_worker.py``,
  ``tests/test_chaos_campaign.py``).  Durable ledgers (health, faults,
  consumption) can MIRROR to a ``mirror_dir`` so post-mortem tools
  (``tools/gang_status.py``) read a dead campaign exactly like a file
  gang.
- :class:`TcpTransport` against a :class:`TcpGangServer` — the first
  transport with a LOSSY medium, so it carries the robustness layer
  the others never needed: a per-operation timeout on every socket
  call, bounded retry with exponential backoff + jitter, idempotent
  message semantics (every mutating request carries an ``op_id`` the
  server deduplicates, so a duplicated or retried delivery can never
  double-fire an abort, double-append a ledger line, or re-admit a
  consumed join), and persistent connection loss surfaced as
  :class:`TransportError` — which ``GangCoordinator`` feeds into the
  existing peer-death detector (a rank that cannot reach the gang for
  ``peer_timeout_s`` treats ITSELF as partitioned off and exits).

Poll cadence is a TRANSPORT property: the old
``min(heartbeat_interval_s, peer_timeout_s / 4)`` monitor cadence and
the supervisor's fixed 0.2 s poll were tuned for file-stat costs.  The
in-proc backend polls tightly (reads are dict lookups — tight polls
are what make the campaigns fast), while the TCP backend scales its
cadence with the world size so 128 monitors polling N-1 peers each
cannot self-DoS the rank-0 host (reads are also BATCHED:
``read_beats`` is one round trip for the whole gang, never N).

Telemetry: every operation counts into ``gang_transport_ops{op,
backend}``; retries and timeouts count into ``gang_transport_retries``
/ ``gang_transport_timeouts`` and mirror into
``FaultEvents.transport_retries``/``transport_timeouts`` (the
``resilience_summary`` rows).  ``stats()`` returns the same totals for
the supervisor's end-of-run health-ledger record, which
``tools/gang_status.py`` renders as the transport-health line.

This module is deliberately stdlib-only (no torch, no numpy) so the
``tools/`` layer can import it against a dead run's directory — the
same contract as ``telemetry/aggregator.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import socket
import socketserver
import threading
import time
import uuid
from collections import OrderedDict

try:  # posix only; the file backend falls back to post-then-reverify
    import fcntl
except ImportError:  # pragma: no cover
    fcntl = None

from distributed_machine_learning_tpu_torch.runtime import coordinator as _coord

TRANSPORT_BACKENDS = ("file", "inproc", "tcp")

# One line of the TCP wire protocol (request or response) may not
# exceed this — a 128-rank beat snapshot with metrics is ~100 KiB.
_MAX_LINE = 8 * 1024 * 1024

# Ops that mutate server/hub state: each request carries an op_id the
# server deduplicates, so retries and duplicated deliveries are exactly
# -once.  Reads are naturally idempotent and retry without ids.
_MUTATING_OPS = frozenset({
    "publish_beat", "declare_abort", "announce_join", "consume_join",
    "write_restore", "append_health", "append_fault", "append_consumed",
    "clear",
    # Serving-plane channels.  ``take_requests`` and
    # ``take_results`` are destructive pops, so the dedup matters MOST
    # there: a tcp retry after a lost response must return the batch
    # the original pop claimed, never pop a second one — that is the
    # request-level exactly-once the serving router builds on.
    "push_request", "take_requests", "post_result", "take_results",
    "set_drain", "set_role", "retire_replica",
    # Continuous-deployment weight channel: staging and
    # committing a weights version both mutate the per-replica weight
    # record the post fence reads, so a tcp retry must be a result
    # fetch, never a second stage/commit.
    "set_weights", "commit_weights",
})


# Deterministic-scheduler seam (dmlcheck layer 3): the hooks live in
# runtime/coordinator.py — the bottom of the runtime import chain,
# which this module already imports — and are aliased here so every
# schedule point on the transport hot paths is one plain call.  With
# no scheduler installed (every production run) a point is a global
# read + None test; ``_sched_block`` returns False and the caller
# falls back to its real blocking wait.
_sched_point = _coord._sched_point
_sched_block = _coord._sched_block


class TransportError(RuntimeError):
    """A gang-transport operation failed for good (retries exhausted,
    or the channel is severed).  The coordinator treats a persistent
    TransportError streak as evidence this rank is partitioned off the
    gang — peer death, seen from the inside."""


# ---------------------------------------------------------------------------
# Request-scoped stage events
# ---------------------------------------------------------------------------
# A serving request that carries an ``events`` list gets one stage
# record appended at every hop of its journey: router-side (admitted,
# queued, dispatched, requeued, dropped, completed) and worker-side
# (taken, bound, computed, posted, fenced).  Replicas running the
# continuous-batching engine replace the single batch-wide
# ``computed`` stamp with the per-request pair ``prefill`` (bound →
# first token sampled) and ``decode`` (prefill → retirement), so the
# stage histograms decompose a request's compute into its two
# regimes instead of hiding both under one micro-batch interval.  The record is
# ``{"stage", "by", "dt"}`` where ``dt`` is the seconds since the SAME
# actor's previous stamp on this request, measured on that actor's own
# monotonic clock — or None when the previous stamp came from another
# process.  The clock anchor rides the payload as the private
# ``_mono_last``/``_mono_by`` pair and is STRIPPED at every wire
# crossing (``push_request``/``post_result``), so no timestamp is ever
# compared across hosts (the DML001 discipline): only rank-local
# deltas travel.  Stamping for ``taken``/``posted`` lives in the
# GangTransport base wrappers below, which run exactly once per
# LOGICAL operation on every backend — tcp retries happen underneath,
# inside ``_call``, and the op-id dedup returns the original effect,
# so stage events inherit the same exactly-once guarantee as the ops
# that carry them.

SERVING_STAGES = ("admitted", "queued", "dispatched", "taken", "bound",
                  "prefill", "decode", "computed", "posted", "completed",
                  "requeued", "fenced", "dropped")

# Terminal stages: after one of these, the actor that stamped it holds
# no further obligation for the request (dmlcheck DML015 keys on this
# split — an open stage without a terminal stamp on some exit path is
# an abandoned record that silently skews the stage histograms).
SERVING_TERMINAL_STAGES = frozenset(
    {"posted", "completed", "requeued", "fenced", "dropped"})

_STAGE_CLOCK_KEYS = ("_mono_last", "_mono_by")


def stamp_stage(payload: dict, stage: str, by: str, **extra) -> dict:
    """Append one stage event to ``payload["events"]`` and advance the
    payload's per-actor monotonic anchor.  ``dt`` is filled only when
    the previous stamp was made by the same ``by`` (same process) —
    never a cross-host clock comparison."""
    now = time.monotonic()
    dt = None
    if payload.get("_mono_by") == by:
        last = payload.get("_mono_last")
        if isinstance(last, (int, float)):
            dt = now - float(last)
    payload["_mono_last"] = now
    payload["_mono_by"] = by
    ev = {"stage": str(stage), "by": str(by), "dt": dt}
    if "dispatch" in payload:
        ev["disp"] = payload["dispatch"]
    ev.update(extra)
    payload.setdefault("events", []).append(ev)
    return ev


def strip_stage_clock(payload: dict) -> dict:
    """Remove the private monotonic anchor before a payload crosses the
    wire: monotonic values are meaningless in another process, and
    leaving them attached would invite exactly the cross-host
    comparison the event schema exists to avoid."""
    for k in _STAGE_CLOCK_KEYS:
        payload.pop(k, None)
    return payload


def carry_stage_context(src: dict, dst: dict) -> dict:
    """Move the trace context (events + dispatch tag + clock anchor)
    from a taken request onto the result being posted for it, so the
    worker-side stamps reach the router.  No-op for requests submitted
    without tracing."""
    if isinstance(src.get("events"), list):
        dst["events"] = src["events"]
        for k in ("dispatch", *_STAGE_CLOCK_KEYS):
            if k in src:
                dst[k] = src[k]
    return dst


def append_jsonl_fsync(path: str | os.PathLike, entry: dict) -> None:
    """Append one JSON line to a ledger file, flushed AND fsynced
    before returning (dmlcheck DML002): ledger consumers include
    relaunched processes whose writer may ``os._exit`` on its very
    next statement."""
    with open(os.fspath(path), "a") as f:
        f.write(json.dumps(entry) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _read_jsonl_dicts(path: str) -> list[dict]:
    """Tolerant JSONL reader: absent file → empty, torn final line (a
    kill mid-append) skipped — the shared reading rule of every gang
    ledger."""
    try:
        with open(path) as f:
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


# ---------------------------------------------------------------------------
# Interface
# ---------------------------------------------------------------------------


class GangTransport:
    """The channel set ``GangCoordinator``/``gang_supervise`` coordinate
    through.  Subclasses implement the ``_do_*`` operations; this base
    owns operation accounting (the telemetry satellite) and the poll
    cadence defaults (the file backend's historical numbers).

    Beat reads return ``(signature, payload)`` pairs: ``signature`` is
    an opaque token that changes whenever the rank re-publishes (file:
    ``(st_mtime_ns, st_size)``; hub: a version counter) — the
    change-signature staleness basis the peer detector judges on, never
    a cross-host clock.  ``payload`` may be None for a torn/unreadable
    beat whose signature still advanced (alive, content unreadable this
    instant).
    """

    backend = "?"

    def __init__(self, events=None):
        self.events = events
        self.op_counts: dict[str, int] = {}
        self.retries = 0
        self.timeouts = 0
        self._stats_lock = threading.Lock()
        self._tel_counters: dict[str, object] = {}

    # -- accounting ------------------------------------------------------
    def _telemetry(self):
        from distributed_machine_learning_tpu_torch.telemetry import get_telemetry

        return get_telemetry()

    def _count(self, op: str) -> None:
        with self._stats_lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
            counter = self._tel_counters.get(op)
        if counter is None:
            tel = self._telemetry()
            if tel is None:
                return
            counter = tel.registry.counter(
                "gang_transport_ops", op=op, backend=self.backend
            )
            with self._stats_lock:
                self._tel_counters[op] = counter
        counter.inc()

    def _count_retry(self) -> None:
        with self._stats_lock:
            self.retries += 1
        if self.events is not None:
            self.events.transport_retries += 1
        tel = self._telemetry()
        if tel is not None:
            tel.registry.counter("gang_transport_retries",
                                 backend=self.backend).inc()

    def _count_timeout(self) -> None:
        with self._stats_lock:
            self.timeouts += 1
        if self.events is not None:
            self.events.transport_timeouts += 1
        tel = self._telemetry()
        if tel is not None:
            tel.registry.counter("gang_transport_timeouts",
                                 backend=self.backend).inc()

    def stats(self) -> dict:
        """Op/retry/timeout totals — the transport-health record the
        supervisor appends to the health ledger at the end of a run."""
        with self._stats_lock:
            ops = dict(sorted(self.op_counts.items()))
            return {
                "backend": self.backend,
                "ops": ops,
                "ops_total": sum(ops.values()),
                "retries": self.retries,
                "timeouts": self.timeouts,
            }

    # -- poll cadence (transport property) ---------
    def monitor_poll_s(self, heartbeat_interval_s: float,
                       peer_timeout_s: float, world: int) -> float:
        """How often one rank's monitor thread should poll the gang."""
        return min(heartbeat_interval_s, peer_timeout_s / 4)

    def supervisor_poll_s(self, world: int) -> float:
        """How often the gang supervisor should poll worker liveness,
        joins, and the health snapshot."""
        return 0.2

    def barrier_poll_s(self) -> float:
        """How often ``wait_for_peers`` re-reads the gang's steps."""
        return 0.05

    # -- channel operations (subclass hooks wrapped with accounting) -----
    def publish_beat(self, rank: int, payload: dict) -> None:
        self._count("publish_beat")
        self._do_publish_beat(rank, payload)

    def read_beat(self, rank: int):
        """(signature, payload|None) or None when the rank never
        published."""
        self._count("read_beat")
        return self._do_read_beat(rank)

    def read_beats(self) -> dict[int, tuple]:
        """rank -> (signature, payload|None) for every published beat —
        ONE operation regardless of world size (the batched read the
        TCP cadence depends on)."""
        self._count("read_beats")
        return self._do_read_beats()

    def read_beat_payloads(self) -> dict[int, dict]:
        """rank -> payload for every beat readable right now."""
        return {r: p for r, (_, p) in self.read_beats().items()
                if isinstance(p, dict)}

    def declare_abort(self, reason: str, by_rank: int,
                      peer: int | None = None) -> bool:
        self._count("declare_abort")
        return self._do_declare_abort(reason, by_rank, peer)

    def read_abort(self) -> dict | None:
        self._count("read_abort")
        return self._do_read_abort()

    def announce_join(self, rank: int, payload: dict) -> None:
        """Publish (or refresh — idempotent overwrite) a join
        announcement.  ``payload`` must carry at least ``rank`` and
        ``spare``; callers add ``prefetched_step``/``kind``/... ."""
        self._count("announce_join")
        self._do_announce_join(int(rank), payload)

    def read_joins(self) -> dict[int, dict]:
        self._count("read_joins")
        return self._do_read_joins()

    def consume_join(self, rank: int) -> None:
        self._count("consume_join")
        self._do_consume_join(int(rank))

    def write_restore_record(self, rank: int, steps) -> None:
        self._count("write_restore")
        self._do_write_restore(int(rank), sorted(int(s) for s in steps))

    def read_restore_record(self, rank: int) -> set[int] | None:
        self._count("read_restore")
        return self._do_read_restore(int(rank))

    def append_health_event(self, kind: str, **fields) -> None:
        self._count("append_health")
        self._do_append_health({"kind": kind, "time": time.time(),
                                **fields})

    def read_health_events(self) -> list[dict]:
        self._count("read_health")
        return self._do_read_health()

    def append_fault_entry(self, entry: dict) -> None:
        self._count("append_fault")
        self._do_append_fault(dict(entry))

    def read_fault_entries(self) -> list[dict]:
        self._count("read_faults")
        return self._do_read_faults()

    def append_consumed(self, orig_rank: int, payload: dict) -> None:
        self._count("append_consumed")
        self._do_append_consumed(int(orig_rank), dict(payload))

    def read_consumed(self, orig_rank: int | None = None) -> list[dict]:
        """Consumption rows for one original rank, or (None) for every
        rank — the exactly-once audit input."""
        self._count("read_consumed")
        return self._do_read_consumed(
            None if orig_rank is None else int(orig_rank))

    # -- serving-plane channels -------------------------------
    # The replicated-inference tier reuses the gang control plane and
    # adds four channels: a per-replica inbound request queue, a shared
    # completed-result queue, a per-replica drain latch, and the
    # role/epoch record that fences a retired replica's late writes.
    def push_request(self, replica: int, payload: dict) -> None:
        """Enqueue one request onto ``replica``'s inbound queue.  The
        router stamps each payload with ``rid`` and the replica's
        serving epoch; the transport treats it as opaque — except the
        trace context: a payload carrying an ``events`` list has its
        private monotonic anchor stripped here (monotonic values never
        cross the wire, DML001) and its events copied so the caller's
        record cannot alias the queued one."""
        self._count("push_request")
        payload = dict(payload)
        if isinstance(payload.get("events"), list):
            payload["events"] = [dict(e) for e in payload["events"]]
            strip_stage_clock(payload)
        self._do_push_request(int(replica), payload)

    def take_requests(self, replica: int, max_n: int = 1) -> list[dict]:
        """Destructively pop up to ``max_n`` pending requests from
        ``replica``'s queue, FIFO.  On tcp the op_id dedup makes a
        retried take return the ORIGINAL batch — a request can be
        claimed by at most one take.  Traced requests are stamped
        ``taken`` here: the wrapper runs in the worker's process on
        every backend, exactly once per logical take (retries collapse
        below it), so the stamp is both on the right clock and
        exactly-once."""
        self._count("take_requests")
        reqs = self._do_take_requests(int(replica), int(max_n))
        by = f"replica{int(replica)}"
        for r in reqs:
            if isinstance(r.get("events"), list):
                stamp_stage(r, "taken", by)
        return reqs

    def post_result(self, replica: int, epoch: int,
                    payload: dict, version: int | None = None) -> bool:
        """Append one completed result — ACCEPTED only when ``epoch``
        matches the replica's current serving epoch (checked atomically
        with the append).  Returns False for a fenced (stale-epoch)
        post: a drained/evicted replica's late result is discarded at
        the hub, never double-delivered.  ``version``: the
        weights version the compute was bound to; when given it is
        checked — inside the SAME atomic section — against the
        replica's committed weights version, so a late post from an
        old-version compute can never complete a request after the
        hot-swap committed.  A traced result is stamped ``posted`` on a
        COPY of its event record (a fenced post's stamp is discarded
        with the post — the caller's record never shows a delivery
        that did not happen), clock anchor stripped before the wire."""
        self._count("post_result")
        payload = dict(payload)
        if isinstance(payload.get("events"), list):
            payload["events"] = [dict(e) for e in payload["events"]]
            stamp_stage(payload, "posted", f"replica{int(replica)}")
            strip_stage_clock(payload)
        return bool(self._do_post_result(
            int(replica), int(epoch), payload,
            None if version is None else int(version)))

    def take_results(self, max_n: int = 16) -> list[dict]:
        """Destructively pop up to ``max_n`` completed results (the
        router's collection read)."""
        self._count("take_results")
        return self._do_take_results(int(max_n))

    def set_drain(self, replica: int, draining: bool = True) -> None:
        """Set/clear ``replica``'s drain latch: a draining replica
        finishes its in-flight work but the router stops dispatching
        to it."""
        self._count("set_drain")
        self._do_set_drain(int(replica), bool(draining))

    def set_serving_role(self, replica: int, role: str) -> None:
        """Record ``replica``'s role (``"live"`` or ``"spare"``) — the
        promotion edge of the replica state machine."""
        self._count("set_role")
        self._do_set_role(int(replica), str(role))

    def set_weights(self, replica: int, version: int,
                    meta: dict | None = None) -> None:
        """Stage a new weights version for ``replica``: the
        deployment controller's announce edge.  ``meta`` (checkpoint
        step, digest, path…) rides the record so the worker's swap
        callback knows what to load.  Staging does NOT move the fence:
        the replica keeps posting under its committed version until it
        drains its in-flight micro-batch and calls
        :meth:`commit_weights` — that is the zero-dropped-requests
        half of the swap protocol."""
        self._count("set_weights")
        self._do_set_weights(int(replica), int(version),
                             dict(meta or {}))

    def commit_weights(self, replica: int, version: int) -> bool:
        """Commit ``replica``'s weights version — the swap's fence
        move, atomic at the hub with the :meth:`post_result` version
        check: from this op on, a post carrying the OLD version is
        fenced (returns False), so an old-version compute can never
        complete a new-version request.  Called by the worker after it
        drained in-flight work and loaded the staged weights."""
        self._count("commit_weights")
        return bool(self._do_commit_weights(int(replica), int(version)))

    def retire_replica(self, replica: int) -> list[dict]:
        """Demote ``replica`` in ONE atomic step: bump its serving
        epoch (fencing any in-flight ``post_result`` from the old
        epoch), flip its role back to ``spare``, clear its drain
        latch, and return whatever requests were still queued for it —
        the router re-dispatches those to survivors."""
        self._count("retire_replica")
        return self._do_retire_replica(int(replica))

    def read_serving(self, replica: int | None = None) -> dict:
        """One replica's ``{role, epoch, drain, queued, weights}``
        record, or (``None``) the whole serving plane: ``{replicas:
        {rank: record}, results: depth}`` — the status-tool read.
        ``weights`` is ``{version, pending, …meta}``: the committed
        weights version fencing this replica's posts, plus any staged
        (not yet committed) version and its deploy metadata."""
        self._count("read_serving")
        return self._do_read_serving(
            None if replica is None else int(replica))

    def clear_gang_state(self, restore_records: bool = False,
                         fault_ledger: bool | None = None) -> None:
        """Same contract as ``coordinator.clear_gang_state``: beats and
        the abort latch always; restore records on request; the
        fault/health/consumed ledgers and pending joins only at
        fresh-run init (``fault_ledger`` defaults to
        ``restore_records``)."""
        self._count("clear")
        self._do_clear(restore_records,
                       restore_records if fault_ledger is None
                       else fault_ledger)

    def snapshot(self) -> dict:
        """Everything a status tool needs in one read: beats, the abort
        latch, pending joins, health events, fired faults — the API
        ``tools/gang_status.py`` reads instead of globbing
        ``beat_rank*.json``."""
        return {
            "backend": self.backend,
            "beats": self.read_beat_payloads(),
            "abort": self.read_abort(),
            "joins": self.read_joins(),
            "health": self.read_health_events(),
            "faults_fired": self.read_fault_entries(),
            "serving": self.read_serving(),
        }

    def close(self) -> None:
        """Release any live resources (sockets).  Idempotent."""


# ---------------------------------------------------------------------------
# File backend — the historical directory layout
# ---------------------------------------------------------------------------


class FileTransport(GangTransport):
    """The shared-directory backend: every operation delegates to the
    ``runtime/coordinator.py`` file functions (or reproduces their
    exact format for the ledgers), so the on-disk layout is
    byte-compatible with every pre-transport release and mixed
    deployments (old reader, new writer) keep working."""

    backend = "file"

    def __init__(self, gang_dir: str | os.PathLike, events=None):
        super().__init__(events=events)
        self.gang_dir = os.fspath(gang_dir)
        # The directory is created on the first WRITE, never at
        # construction: read-only consumers (tools/gang_status.py
        # pointed at a post-mortem mount, or a typo'd path) must not
        # mutate the filesystem.
        self._dir_ready = False
        # Orphaned-claim GC state: claim path -> (stat signature,
        # monotonic time this handle first saw that signature).
        self._claim_seen: dict[str, tuple] = {}

    def _ensure_dir(self) -> None:
        if not self._dir_ready:
            os.makedirs(self.gang_dir, exist_ok=True)
            self._dir_ready = True

    # beats
    def _do_publish_beat(self, rank: int, payload: dict) -> None:
        self._ensure_dir()
        _coord._write_atomic(_coord._beat_path(self.gang_dir, rank),
                             payload)

    def _beat_entry(self, path: str):
        try:
            st = os.stat(path)
        except OSError:
            return None
        sig = (st.st_mtime_ns, st.st_size)
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            payload = None  # torn read mid-replace: alive by signature
        return (sig, payload if isinstance(payload, dict) else None)

    def _do_read_beat(self, rank: int):
        return self._beat_entry(_coord._beat_path(self.gang_dir, rank))

    def _do_read_beats(self) -> dict[int, tuple]:
        out: dict[int, tuple] = {}
        prefix = _coord._BEAT_PREFIX
        try:
            names = os.listdir(self.gang_dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            rank_s = name[len(prefix):-len(".json")]
            if not rank_s.isdigit():
                continue
            entry = self._beat_entry(os.path.join(self.gang_dir, name))
            if entry is not None:
                out[int(rank_s)] = entry
        return out

    # abort latch
    def _do_declare_abort(self, reason, by_rank, peer) -> bool:
        self._ensure_dir()
        return _coord.declare_abort(self.gang_dir, reason, by_rank,
                                    peer=peer)

    def _do_read_abort(self):
        return _coord.read_abort(self.gang_dir)

    # joins
    def _do_announce_join(self, rank: int, payload: dict) -> None:
        self._ensure_dir()
        _coord._write_atomic(_coord._join_path(self.gang_dir, rank),
                             payload)

    def _do_read_joins(self):
        return _coord.read_joins(self.gang_dir)

    def _do_consume_join(self, rank: int) -> None:
        _coord.consume_join(self.gang_dir, rank)

    # restore records
    def _do_write_restore(self, rank: int, steps: list[int]) -> None:
        self._ensure_dir()
        _coord._write_atomic(
            _coord._restore_path(self.gang_dir, rank),
            {"rank": rank, "steps": steps, "time": time.time()},
        )

    def _do_read_restore(self, rank: int):
        return _coord.read_restore_record(self.gang_dir, rank)

    # ledgers (append paths carry the DML002 flush+fsync discipline)
    def _do_append_health(self, payload: dict) -> None:
        self._ensure_dir()
        append_jsonl_fsync(
            os.path.join(self.gang_dir, _coord.GANG_HEALTH_FILE), payload)

    def _do_read_health(self) -> list[dict]:
        return _read_jsonl_dicts(
            os.path.join(self.gang_dir, _coord.GANG_HEALTH_FILE))

    def fault_ledger_path(self) -> str:
        # Import-free name: runtime/faults.py pulls in numpy, which the
        # stdlib-only tools layer must never load.
        return os.path.join(self.gang_dir, "faults_fired.jsonl")

    def _do_append_fault(self, entry: dict) -> None:
        self._ensure_dir()
        append_jsonl_fsync(self.fault_ledger_path(), entry)

    def _do_read_faults(self) -> list[dict]:
        return _read_jsonl_dicts(self.fault_ledger_path())

    def _consumed_path(self, orig_rank: int) -> str:
        return os.path.join(
            self.gang_dir, f"{_coord.CONSUMED_PREFIX}{orig_rank}.jsonl")

    def _do_append_consumed(self, orig_rank: int, payload: dict) -> None:
        self._ensure_dir()
        append_jsonl_fsync(self._consumed_path(orig_rank), payload)

    def _do_read_consumed(self, orig_rank: int | None) -> list[dict]:
        if orig_rank is not None:
            return _read_jsonl_dicts(self._consumed_path(orig_rank))
        out: list[dict] = []
        try:
            names = sorted(os.listdir(self.gang_dir))
        except OSError:
            return out
        for name in names:
            if name.startswith(_coord.CONSUMED_PREFIX) \
                    and name.endswith(".jsonl"):
                out.extend(_read_jsonl_dicts(
                    os.path.join(self.gang_dir, name)))
        return out

    def _do_clear(self, restore_records: bool, fault_ledger: bool) -> None:
        _coord.clear_gang_state(self.gang_dir,
                                restore_records=restore_records,
                                fault_ledger=fault_ledger)
        if fault_ledger:
            self._clear_serving()

    # -- serving channels: spool directories under gang_dir/serving ------
    # Queues are one-file-per-request spools; a pop CLAIMS a file with
    # an atomic os.rename before reading it, so two competing takers can
    # never both consume the same request.  File names carry a
    # per-handle counter (FIFO per writer) plus a uuid suffix so
    # concurrent writers never collide.  A claim orphaned by a crashed
    # taker (renamed but never read+removed) is garbage-collected: a
    # claim a scanner observes with an UNCHANGED stat signature for
    # ``_TAKE_ORPHAN_S`` of its own monotonic clock (change-signatures,
    # never cross-host wall time — DML001) is renamed back to its spool
    # name, restoring it to takes, retire reclaim, and the queued count.
    _SERVING_DIR = "serving"
    _TAKE_ORPHAN_S = 30.0

    def _serving_path(self, *parts) -> str:
        return os.path.join(self.gang_dir, self._SERVING_DIR, *parts)

    def _serving_seq_name(self) -> str:
        with self._stats_lock:
            seq = getattr(self, "_serving_seq", 0) + 1
            self._serving_seq = seq
        return f"{seq:010d}_{uuid.uuid4().hex[:8]}.json"

    @staticmethod
    def _read_json(path: str):
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return entry if isinstance(entry, dict) else None

    def _spool_push(self, subdir: str, payload: dict) -> str:
        self._ensure_dir()
        d = self._serving_path(subdir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, self._serving_seq_name())
        _coord._write_atomic(path, payload)
        return path

    def _spool_take(self, subdir: str, max_n: int) -> list[dict]:
        d = self._serving_path(subdir)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        out: list[dict] = []
        claims: set[str] = set()
        for name in names:
            if ".take" in name:
                # GC an orphaned claim: the taker crashed between its
                # rename and the read+remove.  Staleness is this
                # handle's monotonic clock over an unchanged stat
                # signature; once stale, the claim is renamed back to
                # its spool name and is claimable on the next scan.
                path = os.path.join(d, name)
                claims.add(path)
                try:
                    st = os.stat(path)
                except OSError:
                    self._claim_seen.pop(path, None)
                    continue
                sig = (st.st_mtime_ns, st.st_size)
                seen = self._claim_seen.get(path)
                now = time.monotonic()
                if seen is None or seen[0] != sig:
                    self._claim_seen[path] = (sig, now)
                elif now - seen[1] > self._TAKE_ORPHAN_S:
                    with contextlib.suppress(OSError):
                        os.rename(path, os.path.join(
                            d, name.split(".take", 1)[0]))
                    self._claim_seen.pop(path, None)
                continue
            if len(out) >= max_n or not name.endswith(".json"):
                continue
            path = os.path.join(d, name)
            claimed = f"{path}.take{os.getpid()}.{threading.get_ident()}"
            try:
                os.rename(path, claimed)  # atomic claim: one winner
            except OSError:
                continue  # another taker won this file
            entry = self._read_json(claimed)
            with contextlib.suppress(OSError):
                os.remove(claimed)
            if entry is not None:
                out.append(entry)
        # Forget claims that vanished (their takers finished normally).
        prefix = d + os.sep
        for p in [p for p in self._claim_seen
                  if p.startswith(prefix) and p not in claims]:
            self._claim_seen.pop(p, None)
        return out

    def _do_push_request(self, replica: int, payload: dict) -> None:
        self._spool_push(f"requests_r{replica}", payload)

    def _do_take_requests(self, replica: int, max_n: int) -> list[dict]:
        return self._spool_take(f"requests_r{replica}", max_n)

    @contextlib.contextmanager
    def _replica_fence(self, replica: int):
        """Cross-process mutual exclusion between a result post's
        epoch check + spool push and ``retire_replica``'s epoch bump —
        the file-backend equivalent of the hub lock the in-proc fence
        holds, so the 'checked atomically with the append' contract is
        real, not check-then-act.  No-op without fcntl (the post path
        re-verifies after the push instead)."""
        if fcntl is None:
            yield
            return
        self._ensure_dir()
        os.makedirs(self._serving_path(), exist_ok=True)
        fd = os.open(self._serving_path(f"fence_r{replica}.lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            with contextlib.suppress(OSError):
                fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _weights_path(self, replica: int) -> str:
        return self._serving_path(f"weights_r{replica}.json")

    def _weights_ok(self, replica: int, version: int | None) -> bool:
        if version is None:
            return True
        cur = self._read_json(self._weights_path(replica)) or {}
        return int(version) == int(cur.get("version", 0))

    def _do_post_result(self, replica: int, epoch: int,
                        payload: dict, version: int | None) -> bool:
        epoch_path = self._serving_path(f"epoch_r{replica}.json")
        with self._replica_fence(replica):
            cur = self._read_json(epoch_path) or {}
            if int(epoch) != int(cur.get("epoch", 0)):
                return False
            # The weight-swap fence, under the SAME flock
            # commit_weights takes: a post from an old-version compute
            # after the swap committed is discarded here, atomic with
            # the append.
            if not self._weights_ok(replica, version):
                return False
            if version is not None:
                payload = dict(payload, version=int(version))
            posted = self._spool_push(
                "results",
                dict(payload, replica=replica, epoch=int(epoch)))
        if fcntl is not None:
            return True
        # Lock-free fallback: a retire_replica (or commit_weights) may
        # have moved a fence between the read and the push.  Re-verify
        # and reclaim the stale file; if the router consumed it first,
        # it was delivered (the router's ledger dedups regardless).
        cur = self._read_json(epoch_path) or {}
        if (int(epoch) == int(cur.get("epoch", 0))
                and self._weights_ok(replica, version)):
            return True
        claimed = f"{posted}.take{os.getpid()}.{threading.get_ident()}"
        try:
            os.rename(posted, claimed)
        except OSError:
            return True
        with contextlib.suppress(OSError):
            os.remove(claimed)
        return False

    def _do_take_results(self, max_n: int) -> list[dict]:
        return self._spool_take("results", max_n)

    def _do_set_drain(self, replica: int, draining: bool) -> None:
        self._ensure_dir()
        os.makedirs(self._serving_path(), exist_ok=True)
        _coord._write_atomic(self._serving_path(f"drain_r{replica}.json"),
                             {"drain": bool(draining)})

    def _do_set_role(self, replica: int, role: str) -> None:
        self._ensure_dir()
        os.makedirs(self._serving_path(), exist_ok=True)
        _coord._write_atomic(self._serving_path(f"role_r{replica}.json"),
                             {"role": role})

    def _do_set_weights(self, replica: int, version: int,
                        meta: dict) -> None:
        self._ensure_dir()
        os.makedirs(self._serving_path(), exist_ok=True)
        with self._replica_fence(replica):
            cur = self._read_json(self._weights_path(replica)) or {}
            committed = int(cur.get("version", 0))
            rec = dict(meta)
            rec["version"] = committed
            rec["pending"] = int(version)
            _coord._write_atomic(self._weights_path(replica), rec)

    def _do_commit_weights(self, replica: int, version: int) -> bool:
        self._ensure_dir()
        os.makedirs(self._serving_path(), exist_ok=True)
        with self._replica_fence(replica):
            cur = self._read_json(self._weights_path(replica)) or {}
            cur["version"] = int(version)
            if cur.get("pending") == int(version):
                cur["pending"] = None
            _coord._write_atomic(self._weights_path(replica), cur)
        return True

    def _do_retire_replica(self, replica: int) -> list[dict]:
        self._ensure_dir()
        os.makedirs(self._serving_path(), exist_ok=True)
        with self._replica_fence(replica):
            cur = self._read_json(
                self._serving_path(f"epoch_r{replica}.json")) or {}
            _coord._write_atomic(
                self._serving_path(f"epoch_r{replica}.json"),
                {"epoch": int(cur.get("epoch", 0)) + 1})
        self._do_set_role(replica, "spare")
        with contextlib.suppress(OSError):
            os.remove(self._serving_path(f"drain_r{replica}.json"))
        return self._spool_take(f"requests_r{replica}", 1 << 30)

    def _replica_record(self, replica: int) -> dict:
        role = self._read_json(
            self._serving_path(f"role_r{replica}.json")) or {}
        epoch = self._read_json(
            self._serving_path(f"epoch_r{replica}.json")) or {}
        drain = self._read_json(
            self._serving_path(f"drain_r{replica}.json")) or {}
        try:
            queued = sum(
                n.endswith(".json") for n in os.listdir(
                    self._serving_path(f"requests_r{replica}")))
        except OSError:
            queued = 0
        weights = self._read_json(self._weights_path(replica)) or {}
        wrec = dict(weights)
        wrec["version"] = int(weights.get("version", 0))
        wrec.setdefault("pending", None)
        return {"role": role.get("role", "spare"),
                "epoch": int(epoch.get("epoch", 0)),
                "drain": bool(drain.get("drain", False)),
                "queued": queued,
                "weights": wrec}

    def _do_read_serving(self, replica: int | None) -> dict:
        if replica is not None:
            return self._replica_record(replica)
        replicas: dict[int, dict] = {}
        try:
            names = os.listdir(self._serving_path())
        except OSError:
            names = []
        for name in names:
            for prefix in ("role_r", "epoch_r", "drain_r", "weights_r"):
                if name.startswith(prefix) and name.endswith(".json"):
                    rank_s = name[len(prefix):-len(".json")]
                    if rank_s.isdigit():
                        replicas.setdefault(int(rank_s), {})
        for rank in list(replicas):
            replicas[rank] = self._replica_record(rank)
        try:
            results = sum(
                n.endswith(".json")
                for n in os.listdir(self._serving_path("results")))
        except OSError:
            results = 0
        return {"replicas": replicas, "results": results}

    def _clear_serving(self) -> None:
        root = self._serving_path()
        try:
            names = os.listdir(root)
        except OSError:
            return
        for name in names:
            path = os.path.join(root, name)
            if os.path.isdir(path):
                for inner in os.listdir(path):
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(path, inner))
                with contextlib.suppress(OSError):
                    os.rmdir(path)
            else:
                with contextlib.suppress(OSError):
                    os.remove(path)


# ---------------------------------------------------------------------------
# In-proc backend — threads + in-memory channels
# ---------------------------------------------------------------------------


class InProcHub:
    """The shared in-memory gang state N thread-ranks coordinate
    through — one hub per gang, one :class:`InProcTransport` handle per
    member.  All mutation is under one lock (operations are dict
    updates; contention is negligible against even the in-proc poll
    cadence).

    ``mirror_dir``: when given, the DURABLE ledgers (health, faults,
    consumption) are also appended to files in that directory in the
    exact file-backend format — volatile channels (beats, abort latch,
    joins) stay memory-only.  This is what lets ``tools/gang_status.py``
    and the exactly-once audits read a finished 64-128-rank campaign
    exactly like a file-backed gang.

    ``epoch`` advances on every :meth:`clear`: member transports bind
    the epoch they were created under, so a zombie worker thread from a
    drained attempt (threads cannot be SIGKILLed) gets
    :class:`TransportError` on its next write instead of polluting the
    relaunched attempt's state.
    """

    def __init__(self, mirror_dir: str | os.PathLike | None = None):
        self.lock = threading.RLock()
        self.mirror_dir = (os.fspath(mirror_dir)
                           if mirror_dir is not None else None)
        if self.mirror_dir is not None:
            os.makedirs(self.mirror_dir, exist_ok=True)
        self.epoch = 0
        self.beats: dict[int, tuple[int, dict]] = {}
        self.abort: dict | None = None
        self.joins: dict[int, dict] = {}
        self.restore: dict[int, list[int]] = {}
        self.health: list[dict] = []
        self.faults: list[dict] = []
        self.consumed: dict[int, list[dict]] = {}
        self.box: dict = {}
        # Serving-plane state: per-replica request queues,
        # the shared result queue, the drain latches, and the
        # role/epoch records that fence retired replicas.
        self.serving_requests: dict[int, list[dict]] = {}
        self.serving_results: list[dict] = []
        self.serving_drain: dict[int, bool] = {}
        self.serving_epoch: dict[int, int] = {}
        self.serving_role: dict[int, str] = {}
        # Per-replica weight records: {"version": committed,
        # "pending": staged-or-None, ...deploy meta} — the version
        # fence post_result checks atomically with its append.
        self.serving_weights: dict[int, dict] = {}
        self._version = 0
        # Digital-twin seam: when a campaign attaches a
        # ``runtime.netmodel.NetModel`` here, in-proc workers report
        # MODELED step times through ``observe_step`` and the fault
        # injector's gray link kinds mutate it.  Hub-scoped on purpose:
        # ``clear`` resets beats and aborts between attempts, but a
        # degraded physical link stays degraded across a relaunch —
        # the fault ledger (not the model) is what stops the
        # *injection* from re-firing.
        self.netmodel = None

    # -- the broadcast box (in-proc worker extension) --------------------
    # A tiny rank-0-broadcast channel the in-proc worker harness uses to
    # share the restored state and save commits (on a real pod this is a
    # host-side broadcast collective; in-proc it is a dict).
    def box_put(self, key, value) -> None:
        _sched_point("hub:box:w")
        with self.lock:
            self.box[key] = value

    def box_get(self, key, default=None):
        _sched_point("hub:box:r")
        with self.lock:
            return self.box.get(key, default)

    def clear(self, restore_records: bool, fault_ledger: bool) -> None:
        _sched_point("hub:clear:w")
        with self.lock:
            self.epoch += 1
            self.beats.clear()
            self.abort = None
            self.box.clear()
            if restore_records:
                self.restore.clear()
            if fault_ledger:
                self.health.clear()
                self.faults.clear()
                self.consumed.clear()
                self.joins.clear()
                self.serving_requests.clear()
                self.serving_results.clear()
                self.serving_drain.clear()
                self.serving_epoch.clear()
                self.serving_role.clear()
                self.serving_weights.clear()
        if self.mirror_dir is not None:
            _coord.clear_gang_state(self.mirror_dir,
                                    restore_records=restore_records,
                                    fault_ledger=fault_ledger)


class InProcTransport(GangTransport):
    """One gang member's handle on an :class:`InProcHub`.

    ``bind_epoch=True`` (the worker-thread default via
    :func:`make_transport`) pins the handle to the hub epoch at
    creation: after the supervisor clears between attempts, writes from
    a leftover thread of the drained attempt raise
    :class:`TransportError` — the in-proc analogue of a killed process
    staying dead.  The supervisor's own handle binds no epoch (it is
    the one doing the clearing)."""

    backend = "inproc"

    def __init__(self, hub: InProcHub, events=None,
                 bind_epoch: bool = False):
        super().__init__(events=events)
        self.hub = hub
        self._epoch = hub.epoch if bind_epoch else None

    @contextlib.contextmanager
    def _locked(self, label: str):
        """Enter the hub's critical section for one operation: schedule
        point (layer-3 seam), lock, THEN the epoch fence — checked
        INSIDE the lock, atomic with the caller's read/mutate.  The
        fence used to run before the acquire: a drained zombie thread
        could pass the check, lose the CPU to the supervisor's
        ``clear`` (which advances the epoch), and then write into the
        NEXT attempt's state — the check-then-act race layer 3's
        epoch-fence scenario explores (and whose broken form survives
        as ``analysis/interleave.py``'s ``epoch-unlocked`` mutation)."""
        _sched_point(label)
        hub = self.hub
        with hub.lock:
            if self._epoch is not None and self._epoch != hub.epoch:
                raise TransportError(
                    f"stale transport handle (epoch {self._epoch}, hub "
                    f"at {hub.epoch}): this member was drained and the "
                    "gang state cleared"
                )
            yield hub

    def _do_publish_beat(self, rank: int, payload: dict) -> None:
        with self._locked("hub:beats:w") as hub:
            hub._version += 1
            hub.beats[rank] = (hub._version, dict(payload))

    def _do_read_beat(self, rank: int):
        with self._locked("hub:beats:r") as hub:
            entry = hub.beats.get(rank)
            # Payloads are replaced wholesale on publish and treated
            # read-only by every consumer, so reads hand out the stored
            # reference: N ranks re-reading N beats every barrier poll
            # must stay O(world) dict lookups, not O(world) deep
            # copies.
            return (entry[0], entry[1]) if entry else None

    def _do_read_beats(self) -> dict[int, tuple]:
        with self._locked("hub:beats:r") as hub:
            return dict(hub.beats)

    def barrier_ready(self, step: int, rank: int, world: int) -> bool:
        """Copy-free lock-step barrier probe (the coordinator's
        ``wait_for_peers`` fast path).  Semantically identical to
        snapshotting the beat table and scanning — every peer must
        have published ``step`` (or ``done``) — but one lock entry and
        zero dict copies, which is the difference between a 512-rank
        barrier costing ~2µs per poll and ~150µs: at pod scale the
        generic path alone would saturate the single CI core."""
        with self._locked("hub:barrier:r") as hub:
            beats = hub.beats
            for peer in range(world):
                if peer == rank:
                    continue
                entry = beats.get(peer)
                if entry is None or not isinstance(entry[1], dict):
                    return False
                payload = entry[1]
                if (not payload.get("done")
                        and int(payload.get("step", -1)) < step):
                    return False
            return True

    def _do_declare_abort(self, reason, by_rank, peer) -> bool:
        payload = {"reason": reason, "by_rank": by_rank,
                   "time": time.time()}
        if peer is not None:
            payload["peer"] = peer
        with self._locked("hub:abort:w") as hub:
            if hub.abort is not None:
                return False
            hub.abort = payload
            return True

    def _do_read_abort(self):
        with self._locked("hub:abort:r") as hub:
            return dict(hub.abort) if hub.abort else None

    def _do_announce_join(self, rank: int, payload: dict) -> None:
        with self._locked("hub:joins:w") as hub:
            hub.joins[rank] = dict(payload)

    def _do_read_joins(self):
        with self._locked("hub:joins:r") as hub:
            return {r: dict(p) for r, p in hub.joins.items()}

    def _do_consume_join(self, rank: int) -> None:
        with self._locked("hub:joins:w") as hub:
            hub.joins.pop(rank, None)

    def _do_write_restore(self, rank: int, steps: list[int]) -> None:
        with self._locked("hub:restore:w") as hub:
            hub.restore[rank] = list(steps)

    def _do_read_restore(self, rank: int):
        with self._locked("hub:restore:r") as hub:
            steps = hub.restore.get(rank)
            return set(steps) if steps is not None else None

    def _do_append_health(self, payload: dict) -> None:
        # Mirror writes happen INSIDE the hub lock: the on-disk ledger
        # order must match the authoritative in-memory order (the
        # fault ledger's loss/recovery masking is explicitly
        # order-aware), and hub.lock is an RLock so the ledger paths
        # stay one critical section.
        with self._locked("hub:health:w") as hub:
            hub.health.append(dict(payload))
            if hub.mirror_dir is not None:
                append_jsonl_fsync(
                    os.path.join(hub.mirror_dir,
                                 _coord.GANG_HEALTH_FILE), payload)

    def _do_read_health(self) -> list[dict]:
        with self._locked("hub:health:r") as hub:
            return [dict(e) for e in hub.health]

    def _do_append_fault(self, entry: dict) -> None:
        with self._locked("hub:faults:w") as hub:
            hub.faults.append(dict(entry))
            if hub.mirror_dir is not None:
                append_jsonl_fsync(
                    os.path.join(hub.mirror_dir,
                                 "faults_fired.jsonl"), entry)

    def _do_read_faults(self) -> list[dict]:
        with self._locked("hub:faults:r") as hub:
            return [dict(e) for e in hub.faults]

    def _do_append_consumed(self, orig_rank: int, payload: dict) -> None:
        with self._locked("hub:consumed:w") as hub:
            hub.consumed.setdefault(orig_rank, []).append(
                dict(payload))
            if hub.mirror_dir is not None:
                append_jsonl_fsync(
                    os.path.join(
                        hub.mirror_dir,
                        f"{_coord.CONSUMED_PREFIX}{orig_rank}.jsonl"),
                    payload)

    def _do_read_consumed(self, orig_rank: int | None) -> list[dict]:
        with self._locked("hub:consumed:r") as hub:
            if orig_rank is not None:
                return [dict(e)
                        for e in hub.consumed.get(orig_rank, ())]
            return [dict(e) for r in sorted(hub.consumed)
                    for e in hub.consumed[r]]

    # -- serving channels ------------------------------------------------
    # Schedule-point labels: the queue channels get structured
    # ``hub:<channel>:w`` labels (independent channels prune against
    # each other in the layer-3 POR), while ``retire_replica`` and the
    # cross-channel snapshot read get deliberately NON-structured
    # labels so the explorer treats them as conflicting with every
    # serving op — they touch several channels in one critical section.
    def _do_push_request(self, replica: int, payload: dict) -> None:
        with self._locked("hub:srequests:w") as hub:
            hub.serving_requests.setdefault(replica, []).append(
                dict(payload))

    def _do_take_requests(self, replica: int, max_n: int) -> list[dict]:
        with self._locked("hub:srequests:w") as hub:
            q = hub.serving_requests.get(replica)
            if not q:
                return []
            out = q[:max_n]
            del q[:max_n]
            return [dict(e) for e in out]

    def _do_post_result(self, replica: int, epoch: int,
                        payload: dict, version: int | None) -> bool:
        # The drain/promote fence: the epoch is compared INSIDE the
        # lock, atomic with the append.  A retired replica's late post
        # (its epoch was bumped by ``retire_replica``) returns False
        # and touches nothing — the check-then-act race the layer-3
        # ``drain_promote`` scenario explores, whose broken form
        # survives as ``analysis/interleave.py``'s ``result-unfenced``
        # mutation.  The weights version is fenced in the
        # SAME critical section — its hoisted-check form is the
        # ``swap-unfenced`` mutation the ``weight_swap`` scenario
        # rediscovers.
        with self._locked("hub:sresults:w") as hub:
            if int(epoch) != hub.serving_epoch.get(replica, 0):
                return False
            if version is not None:
                wrec = hub.serving_weights.get(replica) or {}
                if int(version) != int(wrec.get("version", 0)):
                    return False
                payload = dict(payload, version=int(version))
            hub.serving_results.append(
                dict(payload, replica=replica, epoch=int(epoch)))
            return True

    def _do_take_results(self, max_n: int) -> list[dict]:
        with self._locked("hub:sresults:w") as hub:
            out = hub.serving_results[:max_n]
            del hub.serving_results[:max_n]
            return [dict(e) for e in out]

    def _do_set_drain(self, replica: int, draining: bool) -> None:
        with self._locked("hub:sdrain:w") as hub:
            hub.serving_drain[replica] = bool(draining)

    def _do_set_role(self, replica: int, role: str) -> None:
        with self._locked("hub:srole:w") as hub:
            hub.serving_role[replica] = role

    def _do_set_weights(self, replica: int, version: int,
                        meta: dict) -> None:
        # Non-structured label: the weight record is read by the post
        # fence (hub:sresults:w) and the snapshot — staging must
        # conflict with both in the layer-3 POR, not prune against
        # them as an independent channel.
        with self._locked("hub:serving:setw") as hub:
            cur = hub.serving_weights.get(replica) or {}
            rec = dict(meta)
            rec["version"] = int(cur.get("version", 0))
            rec["pending"] = int(version)
            hub.serving_weights[replica] = rec

    def _do_commit_weights(self, replica: int, version: int) -> bool:
        # The swap's fence move: committed version flips under the hub
        # lock, atomic with every concurrent post's version check.
        with self._locked("hub:serving:commitw") as hub:
            rec = dict(hub.serving_weights.get(replica) or {})
            rec["version"] = int(version)
            if rec.get("pending") == int(version):
                rec["pending"] = None
            hub.serving_weights[replica] = rec
            return True

    def _do_retire_replica(self, replica: int) -> list[dict]:
        with self._locked("hub:serving:retire") as hub:
            hub.serving_epoch[replica] = \
                hub.serving_epoch.get(replica, 0) + 1
            undelivered = hub.serving_requests.pop(replica, [])
            hub.serving_role[replica] = "spare"
            hub.serving_drain.pop(replica, None)
            return [dict(e) for e in undelivered]

    def _replica_record_locked(self, hub: InProcHub,
                               replica: int) -> dict:
        wrec = dict(hub.serving_weights.get(replica) or {})
        wrec["version"] = int(wrec.get("version", 0))
        wrec.setdefault("pending", None)
        return {"role": hub.serving_role.get(replica, "spare"),
                "epoch": hub.serving_epoch.get(replica, 0),
                "drain": bool(hub.serving_drain.get(replica, False)),
                "queued": len(hub.serving_requests.get(replica, ())),
                "weights": wrec}

    def _do_read_serving(self, replica: int | None) -> dict:
        with self._locked("hub:serving:snapshot") as hub:
            if replica is not None:
                return self._replica_record_locked(hub, replica)
            ranks = (set(hub.serving_role) | set(hub.serving_epoch)
                     | set(hub.serving_drain)
                     | set(hub.serving_requests)
                     | set(hub.serving_weights))
            return {"replicas": {r: self._replica_record_locked(hub, r)
                                 for r in sorted(ranks)},
                    "results": len(hub.serving_results)}

    def _do_clear(self, restore_records: bool, fault_ledger: bool) -> None:
        self.hub.clear(restore_records, fault_ledger)

    # cadence: reads are dict lookups — poll tightly so barriers and
    # boundary detection turn around in milliseconds, which is the
    # whole point of the backend (64-128-rank campaigns in seconds).
    # Above ~128 ranks the tight cadence itself becomes the bottleneck
    # (512 threads × 2 ms polls is ~256k acquisitions/s on ONE hub
    # lock), so the poll intervals stretch with world size — pod-scale
    # twins trade per-op latency for lock headroom.
    def monitor_poll_s(self, heartbeat_interval_s, peer_timeout_s,
                       world) -> float:
        base = max(min(heartbeat_interval_s, peer_timeout_s / 4, 0.05),
                   0.005)
        return base * max(1.0, world / 128)

    def supervisor_poll_s(self, world: int) -> float:
        return 0.02 * max(1.0, world / 256)

    def barrier_poll_s(self) -> float:
        # No world argument on this hook, but the beat table holds one
        # entry per live member — stretch by it so a 512-rank barrier
        # (each poll copies the whole table) doesn't burn the single
        # CI core on 256k lock acquisitions per second.  Unlocked
        # len() is safe (GIL) and only tunes a poll interval.
        return 0.002 * max(1.0, len(self.hub.beats) / 128)


# ---------------------------------------------------------------------------
# TCP backend — the lossy medium, with the robustness layer
# ---------------------------------------------------------------------------


class _InFlight:
    """Reservation slot for a mutating op being applied: duplicates
    arriving while the original is in flight wait on it instead of
    re-applying."""

    def __init__(self):
        self._done = threading.Event()
        self._claimed = False
        self._lock = threading.Lock()
        self.result = None
        self.error: BaseException | None = None

    def claim(self) -> bool:
        with self._lock:
            was = self._claimed
            self._claimed = True
            return not was

    def finish(self, result) -> None:
        self.result = result
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self._done.set()

    def wait(self, timeout_s: float):
        if not self._done.wait(timeout_s):
            raise TimeoutError("duplicate op still in flight")
        if self.error is not None:
            raise RuntimeError(
                f"original delivery failed: {self.error}")
        return self.result


class _TcpHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        # Per-connection timeout: a wedged client must not pin a
        # handler thread forever (dmlcheck DML012).
        self.request.settimeout(self.server.io_timeout_s)
        try:
            line = self.rfile.readline(_MAX_LINE)
        except OSError:
            return
        if not line:
            return
        try:
            req = json.loads(line)
            result = self.server.dispatch(req)
            resp = {"ok": True, "result": result}
        except Exception as exc:  # surfaced to the client as an error
            resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        with contextlib.suppress(OSError):
            self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))


class _TcpServerCore(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class TcpGangServer:
    """The rank-0-side gang state server: a threaded stdlib TCP server
    speaking newline-delimited JSON, holding its state in an
    :class:`InProcHub` (optionally ledger-mirrored to ``mirror_dir``).

    On a real pod this runs on rank 0 / the controller host; in the
    local launcher (``cli/gang.py --gang-transport tcp``) the
    supervisor process hosts it and hands workers the address.

    Idempotency: every mutating request carries an ``op_id``; the
    server remembers the last :data:`_DEDUP_CAP` ids with their
    results, so a client retry after a lost RESPONSE (the request
    actually landed) — or a network-duplicated delivery — returns the
    original result instead of double-firing.  The abort latch, join
    overwrite, and consume are idempotent by construction; the dedup
    store is what extends exactly-once to the ledger appends and makes
    ``declare_abort``'s first-writer verdict stable under retry.
    """

    _DEDUP_CAP = 65536

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 mirror_dir=None, io_timeout_s: float = 10.0,
                 listen: bool = True):
        self.hub = InProcHub(mirror_dir=mirror_dir)
        self._state = InProcTransport(self.hub)
        self._seen: OrderedDict[str, object] = OrderedDict()
        self._seen_lock = threading.Lock()
        self.io_timeout_s = float(io_timeout_s)
        # ``listen=False`` builds the dispatch/dedup state machine with
        # no socket at all — the layer-3 explorer drives ``dispatch()``
        # directly, so exploring a schedule never binds a port.
        self._server = None
        if listen:
            self._server = _TcpServerCore((host, port), _TcpHandler)
            self._server.dispatch = self.dispatch
            self._server.io_timeout_s = self.io_timeout_s
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        if self._server is None:
            raise RuntimeError("server built with listen=False has no "
                               "address")
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "TcpGangServer":
        if self._server is None:
            raise RuntimeError("server built with listen=False cannot "
                               "serve")
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="gang-tcp-server", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is None:
            return
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()

    def local_transport(self, events=None) -> InProcTransport:
        """A direct (no-socket) handle on the server's hub for the
        process hosting it — the supervisor must never compete with
        128 workers for its own socket.  Labeled ``tcp`` (it is the
        server side of the tcp control plane); its stats count the
        supervisor's ops, while each worker's retry/timeout counts land
        in that worker's own telemetry registry."""
        handle = InProcTransport(self.hub, events=events)
        handle.backend = "tcp"
        return handle

    # -- request dispatch ------------------------------------------------
    def dispatch(self, req: dict):
        op = req.get("op")
        op_id = req.get("op_id")
        if op_id is None:
            return self._apply(op, req)
        # The op_id is RESERVED under the lock before the apply runs: a
        # duplicate racing a still-in-flight original (client timeout
        # shorter than a slow mirror fsync) must wait for the original's
        # result, never re-apply — check-then-apply outside the lock
        # would double-append and break exactly-once.
        _sched_point("tcp:seen:w:reserve")
        with self._seen_lock:
            if op_id in self._seen:  # membership: a result may be None
                entry = self._seen[op_id]
            else:
                entry = _InFlight()
                self._seen[op_id] = entry
        if isinstance(entry, _InFlight):
            if entry.claim():  # this thread owns the apply
                _sched_point("tcp:apply")
                try:
                    result = self._apply(op, req)
                except BaseException as exc:
                    # A failed apply must not poison the id: drop the
                    # reservation so the client's retry re-applies.
                    with self._seen_lock:
                        self._seen.pop(op_id, None)
                    entry.fail(exc)
                    raise
                entry.finish(result)
                _sched_point("tcp:seen:w:store")
                with self._seen_lock:
                    self._seen[op_id] = result
                    self._evict_seen_locked()
                return result
            if _sched_block("tcp:inflight:wait", entry._done.is_set):
                # The scheduler descheduled this thread until the
                # original settled; the zero-timeout wait just fetches
                # the result (or re-raises the original's failure).
                return entry.wait(0)
            return entry.wait(self.io_timeout_s)
        return entry  # already-completed result, cached

    def _evict_seen_locked(self) -> None:
        """Trim the dedup store to ``_DEDUP_CAP``, oldest first — but
        NEVER a still-``_InFlight`` reservation (caller holds
        ``_seen_lock``).  Evicting one would forget that its op is
        being applied right now, so the op's retry would miss the
        dedup store, re-apply, and break exactly-once; in-flight
        entries rotate to the young end instead (the store runs over
        cap until they settle).  The pre-fix form — a plain
        ``popitem(last=False)`` loop — survives as the layer-3
        mutation-test seed (``analysis/interleave.py``,
        ``MUTATIONS['dedup-evict']``): the explorer must rediscover
        this bug whenever it is re-introduced."""
        excess = len(self._seen) - self._DEDUP_CAP
        for _ in range(len(self._seen)):
            if excess <= 0:
                break
            op_id, entry = self._seen.popitem(last=False)
            if isinstance(entry, _InFlight):
                self._seen[op_id] = entry
            else:
                excess -= 1

    def _apply(self, op: str, req: dict):
        s = self._state
        if op == "ping":
            return "pong"
        if op == "publish_beat":
            rank, payload = int(req["rank"]), req["payload"]
            # A duplicated/reordered beat delivery must not make a dead
            # rank look freshly alive: the version (the reader-side
            # change signature) only advances when the CONTENT changes.
            with self.hub.lock:
                cur = self.hub.beats.get(rank)
                if cur is not None and cur[1] == payload:
                    return None
            s._do_publish_beat(rank, payload)
            return None
        if op == "read_beats":
            return {str(r): [v, p]
                    for r, (v, p) in s._do_read_beats().items()}
        if op == "read_beat":
            entry = s._do_read_beat(int(req["rank"]))
            return None if entry is None else [entry[0], entry[1]]
        if op == "declare_abort":
            return s._do_declare_abort(req["reason"], req["by_rank"],
                                       req.get("peer"))
        if op == "read_abort":
            return s._do_read_abort()
        if op == "announce_join":
            s._do_announce_join(int(req["rank"]), req["payload"])
            return None
        if op == "read_joins":
            return {str(r): p for r, p in s._do_read_joins().items()}
        if op == "consume_join":
            s._do_consume_join(int(req["rank"]))
            return None
        if op == "write_restore":
            s._do_write_restore(int(req["rank"]), req["steps"])
            return None
        if op == "read_restore":
            steps = s._do_read_restore(int(req["rank"]))
            return None if steps is None else sorted(steps)
        if op == "append_health":
            s._do_append_health(req["payload"])
            return None
        if op == "read_health":
            return s._do_read_health()
        if op == "append_fault":
            s._do_append_fault(req["payload"])
            return None
        if op == "read_faults":
            return s._do_read_faults()
        if op == "append_consumed":
            s._do_append_consumed(int(req["rank"]), req["payload"])
            return None
        if op == "read_consumed":
            rank = req.get("rank")
            return s._do_read_consumed(
                None if rank is None else int(rank))
        if op == "clear":
            self.hub.clear(bool(req["restore_records"]),
                           bool(req["fault_ledger"]))
            return None
        if op == "push_request":
            s._do_push_request(int(req["rank"]), req["payload"])
            return None
        if op == "take_requests":
            return s._do_take_requests(int(req["rank"]),
                                       int(req["max_n"]))
        if op == "post_result":
            version = req.get("version")
            return s._do_post_result(
                int(req["rank"]), int(req["epoch"]), req["payload"],
                None if version is None else int(version))
        if op == "take_results":
            return s._do_take_results(int(req["max_n"]))
        if op == "set_drain":
            s._do_set_drain(int(req["rank"]), bool(req["draining"]))
            return None
        if op == "set_role":
            s._do_set_role(int(req["rank"]), req["role"])
            return None
        if op == "set_weights":
            s._do_set_weights(int(req["rank"]), int(req["version"]),
                              req.get("meta") or {})
            return None
        if op == "commit_weights":
            return s._do_commit_weights(int(req["rank"]),
                                        int(req["version"]))
        if op == "retire_replica":
            return s._do_retire_replica(int(req["rank"]))
        if op == "read_serving":
            rank = req.get("rank")
            state = s._do_read_serving(
                None if rank is None else int(rank))
            if rank is None:
                state = dict(state,
                             replicas={str(r): rec for r, rec
                                       in state["replicas"].items()})
            return state
        raise ValueError(f"unknown transport op {op!r}")


class TcpTransport(GangTransport):
    """A gang member's client on a :class:`TcpGangServer` — the lossy
    medium, so every call carries the robustness layer:

    - **per-op timeout**: every socket op (connect, send, read) is
      bounded by ``timeout_s`` — no call can hang a monitor thread;
    - **bounded retry, backoff + jitter**: up to ``max_tries`` attempts
      with exponential backoff (``backoff_s * 2**k``) times a random
      0.5-1.5 jitter factor, so 128 clients recovering from one server
      hiccup do not re-arrive in lockstep;
    - **idempotent delivery**: mutating requests carry an ``op_id``
      (unique per logical operation, REUSED across its retries) the
      server deduplicates — a retry after a lost response or a
      fault-injected duplicate can never double-append or re-admit;
    - **connection loss as peer-death evidence**: retries exhausted →
      :class:`TransportError`, which ``GangCoordinator`` escalates to a
      self-abort once the outage outlives ``peer_timeout_s`` (a rank
      partitioned off the gang IS a dead peer, seen from inside).

    ``chaos``: an optional ``runtime/faults.py::TransportChaos`` plan
    injecting drop/delay/duplicate/partition at the send boundary —
    how the retry/idempotency claims are tested rather than asserted.
    """

    backend = "tcp"

    def __init__(self, address: str, events=None, *,
                 timeout_s: float = 2.0, max_tries: int = 4,
                 backoff_s: float = 0.05, chaos=None,
                 client_id: str | None = None):
        super().__init__(events=events)
        host, _, port_s = address.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(
                f"bad gang transport address {address!r} "
                "(expected host:port)")
        self.address = (host, int(port_s))
        self.timeout_s = float(timeout_s)
        self.max_tries = int(max_tries)
        self.backoff_s = float(backoff_s)
        self.chaos = chaos
        # Unique per INSTANCE, not per process: several clients in one
        # process (worker + monitor + tools) must never collide in the
        # server's op_id dedup space.
        self._id = client_id or (
            f"{socket.gethostname()}.{os.getpid()}."
            f"{uuid.uuid4().hex[:12]}")
        self._seq = 0
        self._seq_lock = threading.Lock()
        # Jitter only — never used for anything that must reproduce.
        self._rng = random.Random()

    # -- wire ------------------------------------------------------------
    def _next_op_id(self) -> str:
        with self._seq_lock:
            self._seq += 1
            return f"{self._id}.{self._seq}"

    def _roundtrip(self, req: dict):
        data = (json.dumps(req) + "\n").encode("utf-8")
        with socket.create_connection(self.address,
                                      timeout=self.timeout_s) as sock:
            sock.settimeout(self.timeout_s)
            sock.sendall(data)
            f = sock.makefile("rb")
            line = f.readline(_MAX_LINE)
        if not line:
            raise TransportError("gang server closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise TransportError(
                f"gang server rejected {req.get('op')}: "
                f"{resp.get('error')}")
        return resp.get("result")

    def _call(self, op: str, **fields):
        req = {"op": op, **fields}
        if op in _MUTATING_OPS:
            # ONE op_id per logical operation, reused by every retry:
            # the server-side dedup is what turns at-least-once
            # delivery into exactly-once application.
            req["op_id"] = self._next_op_id()
        last: Exception | None = None
        for attempt in range(self.max_tries):
            if attempt:
                self._count_retry()
                sleep_s = (self.backoff_s * (2 ** (attempt - 1))
                           * (0.5 + self._rng.random()))
                time.sleep(sleep_s)
            act = self.chaos.plan(op) if self.chaos is not None else None
            if act is not None:
                if act.partitioned:
                    raise TransportError(
                        f"{op}: channel severed (injected partition)")
                if act.delay_s:
                    time.sleep(act.delay_s)
                if act.drop:
                    # The medium ate the request: to the client this is
                    # indistinguishable from a timeout.
                    self._count_timeout()
                    last = TransportError(
                        f"{op}: request dropped (injected)")
                    continue
            try:
                if act is not None and act.duplicate:
                    # The medium delivered it twice: same op_id, so the
                    # server must apply it once.
                    self._roundtrip(dict(req))
                return self._roundtrip(req)
            except socket.timeout as exc:
                self._count_timeout()
                last = exc
            except (TransportError, OSError, ValueError) as exc:
                # TransportError here covers a response lost to a clean
                # connection close and transient server-side errors
                # (e.g. a duplicate that outwaited its in-flight
                # original) — all retry-safe BECAUSE the op_id rides
                # every retry: the dedup layer turns the re-send into a
                # result fetch, never a re-apply.  A deterministic
                # rejection just burns the bounded retry budget before
                # surfacing.
                last = exc
        raise TransportError(
            f"{op} failed after {self.max_tries} tries against "
            f"{self.address[0]}:{self.address[1]}: {last}")

    # -- operations ------------------------------------------------------
    def _do_publish_beat(self, rank, payload):
        self._call("publish_beat", rank=rank, payload=payload)

    def _do_read_beat(self, rank):
        entry = self._call("read_beat", rank=rank)
        return None if entry is None else (entry[0], entry[1])

    def _do_read_beats(self):
        raw = self._call("read_beats")
        return {int(r): (v_p[0], v_p[1]) for r, v_p in raw.items()}

    def _do_declare_abort(self, reason, by_rank, peer):
        return bool(self._call("declare_abort", reason=reason,
                               by_rank=by_rank, peer=peer))

    def _do_read_abort(self):
        return self._call("read_abort")

    def _do_announce_join(self, rank, payload):
        self._call("announce_join", rank=rank, payload=payload)

    def _do_read_joins(self):
        return {int(r): p
                for r, p in self._call("read_joins").items()}

    def _do_consume_join(self, rank):
        self._call("consume_join", rank=rank)

    def _do_write_restore(self, rank, steps):
        self._call("write_restore", rank=rank, steps=steps)

    def _do_read_restore(self, rank):
        steps = self._call("read_restore", rank=rank)
        return None if steps is None else {int(s) for s in steps}

    def _do_append_health(self, payload):
        self._call("append_health", payload=payload)

    def _do_read_health(self):
        return self._call("read_health")

    def _do_append_fault(self, entry):
        self._call("append_fault", payload=entry)

    def _do_read_faults(self):
        return self._call("read_faults")

    def _do_append_consumed(self, orig_rank, payload):
        self._call("append_consumed", rank=orig_rank, payload=payload)

    def _do_read_consumed(self, orig_rank):
        return self._call("read_consumed", rank=orig_rank)

    def _do_clear(self, restore_records, fault_ledger):
        self._call("clear", restore_records=restore_records,
                   fault_ledger=fault_ledger)

    # serving channels — all mutating ops ride the op_id dedup, so a
    # retried take/post is a result fetch, never a second pop/append.
    def _do_push_request(self, replica, payload):
        self._call("push_request", rank=replica, payload=payload)

    def _do_take_requests(self, replica, max_n):
        return self._call("take_requests", rank=replica, max_n=max_n)

    def _do_post_result(self, replica, epoch, payload, version):
        return bool(self._call("post_result", rank=replica,
                               epoch=epoch, payload=payload,
                               version=version))

    def _do_take_results(self, max_n):
        return self._call("take_results", max_n=max_n)

    def _do_set_drain(self, replica, draining):
        self._call("set_drain", rank=replica, draining=draining)

    def _do_set_role(self, replica, role):
        self._call("set_role", rank=replica, role=role)

    def _do_set_weights(self, replica, version, meta):
        self._call("set_weights", rank=replica, version=version,
                   meta=meta)

    def _do_commit_weights(self, replica, version):
        return bool(self._call("commit_weights", rank=replica,
                               version=version))

    def _do_retire_replica(self, replica):
        return self._call("retire_replica", rank=replica)

    def _do_read_serving(self, replica):
        state = self._call("read_serving", rank=replica)
        if replica is None:
            state = dict(state,
                         replicas={int(r): rec for r, rec
                                   in state["replicas"].items()})
        return state

    # cadence: each monitor poll is ONE batched read_beats round trip,
    # and the interval grows with the world so the whole gang's request
    # rate on the rank-0 host stays bounded (~world/poll ≈ 500/s at any
    # size) instead of quadratic.
    _PER_RANK_BUDGET_S = 0.002

    def monitor_poll_s(self, heartbeat_interval_s, peer_timeout_s,
                       world) -> float:
        base = min(heartbeat_interval_s, peer_timeout_s / 4)
        return min(max(base, self._PER_RANK_BUDGET_S * world),
                   peer_timeout_s / 4)

    def supervisor_poll_s(self, world: int) -> float:
        return max(0.2, self._PER_RANK_BUDGET_S * world)

    def barrier_poll_s(self) -> float:
        return max(0.05, self._PER_RANK_BUDGET_S * 8)


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------


def make_transport(backend: str, *, gang_dir=None, address=None,
                   hub: InProcHub | None = None, events=None,
                   bind_epoch: bool = True, chaos=None,
                   timeout_s: float = 2.0) -> GangTransport:
    """Build a transport from launcher-level selection flags:

    - ``file``: requires ``gang_dir`` (the historical default);
    - ``inproc``: requires ``hub`` (one per gang, shared by every
      member thread; ``bind_epoch`` pins worker handles to the current
      attempt — see :class:`InProcTransport`);
    - ``tcp``: requires ``address`` (``host:port`` of the gang server).
    """
    if backend == "file":
        if gang_dir is None:
            raise ValueError("file transport requires gang_dir")
        return FileTransport(gang_dir, events=events)
    if backend == "inproc":
        if hub is None:
            raise ValueError("inproc transport requires a shared hub")
        return InProcTransport(hub, events=events, bind_epoch=bind_epoch)
    if backend == "tcp":
        if address is None:
            raise ValueError("tcp transport requires address host:port")
        return TcpTransport(address, events=events, chaos=chaos,
                            timeout_s=timeout_s)
    raise ValueError(
        f"unknown gang transport {backend!r}; choose from "
        f"{TRANSPORT_BACKENDS}")
