"""Elastic serving fleet — the router side.

A copy of ``distributed_machine_learning_tpu/runtime/serving.py``
(``ServingRouter``, ``ServingConfig``, ``Overloaded``), so the port
imports nothing of the JAX package.  The gang control plane (heartbeats
+ health ledger, warm spares, straggler detection, the pluggable
transport with op-id exactly-once) aimed at a replicated inference
tier:

- :class:`ServingRouter` owns a **bounded request queue with admission
  control**: past ``max_queue`` open requests, :meth:`submit` raises
  :class:`Overloaded` — an explicit, counted rejection, never a silent
  drop.
- Admitted requests are dispatched in **micro-batches** to N live
  replica ranks (each a ``runtime/serving_worker.py`` loop driving a
  step callable or the continuous-batching engine).
- Replica lifecycle reuses the gang primitives: **liveness** from the
  beat channel (change-signatures + the router's monotonic clock —
  never cross-host wall time, DML001); **eviction of slow replicas**
  via the :class:`StragglerDetector` fed per-replica service
  times, with ``--straggler-policy=replace`` semantics (demote, then
  promote a warm spare in its place); **elastic grow** under sustained
  queue pressure by promoting spares that announced on the join
  channel with prefetched verified checkpoints (promotion is
  O(restore)); **graceful drain** for redeploy — stop
  dispatching, finish in-flight, then demote to spare.
- The drain/demote handoff is **epoch-fenced** at the transport
  (``retire_replica`` bumps the replica's serving epoch atomically
  with reclaiming its queue; a late ``post_result`` from the old epoch
  is discarded at the hub) — the protocol dmlcheck layer 3 explores as
  ``drain_promote``.  On top of the fence the router keeps a request
  ledger with **first-result-wins** per ``rid``: a request completed
  by a dying replica *and* re-dispatched to a survivor delivers
  exactly once, with the duplicate counted, never returned.

Telemetry: per-request latency lands in a ``serving_request_latency_s``
histogram built on the latency bucket preset
(``default_latency_buckets`` — the train-step buckets flattened
millisecond p99s into one bucket); fleet gauges ``serving_replicas`` /
``serving_queue_depth`` and counters ``serving_evictions`` /
``serving_rejects`` flow through the same registry, mirrored into
``FaultEvents.replica_evictions`` / ``drains`` / ``request_rejects``
for the ``resilience_summary`` rows.  Lifecycle edges append
``serve_promote`` / ``serve_evict`` / ``serve_demote`` health-ledger
events and :meth:`close` appends a final ``serving`` summary record —
what ``tools/gang_status.py`` renders as the serving view.

Request-scoped tracing: every admitted request carries a
stage-event record (see ``runtime/transport.py::SERVING_STAGES``) the
router opens at admission and closes at completion; worker-side stamps
merge back in with the posted result.  At completion the rank-local
stage deltas feed ``serving_stage_latency_s{stage=...}`` histograms,
the shared :class:`StragglerDetector` (via
``telemetry.aggregator.serving_stage_samples`` — the ``computed``
deltas ARE the per-replica service times, replacing the old beat-borne
copy), an optional :class:`~..telemetry.slo.SLOEngine`, and — when
``record_requests`` is on — a ``serve_request`` health-ledger record
``tools/serve_status.py --postmortem RID`` reconstructs timelines
from.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
from distributed_machine_learning_tpu_torch.runtime.transport import (
    stamp_stage,
)
from distributed_machine_learning_tpu_torch.telemetry import get_telemetry
from distributed_machine_learning_tpu_torch.telemetry.aggregator import (
    StragglerDetector,
    serving_stage_samples,
)
from distributed_machine_learning_tpu_torch.telemetry.registry import (
    Histogram,
    default_latency_buckets,
)

# Stages whose rank-local deltas are observed into the per-stage
# latency histograms at completion.  On the happy path that is the
# full journey decomposition: ``queued`` (admission → queue append,
# router clock), ``dispatched`` (queue wait, router clock), ``bound``
# (fence check after take, replica clock), ``computed`` (the compute
# interval, replica clock), ``posted`` (result append, replica clock),
# ``completed`` (dispatch → collection round trip, router clock).
# ``requeued`` rides along on the failure path — the time a request
# sat on a replica that died under it.  ``admitted``/``taken`` open
# each actor's local chain (dt is None by construction: the prior
# stamp crossed a process boundary) and ``fenced``/``dropped`` record
# discards, so none of those carry durations.  ``prefill``/``decode``
# are the continuous-batching engine's split of the compute interval
#: engine replicas stamp those two instead of ``computed``,
# so per-request prefill/decode latency quantiles fall out of the same
# serving_stage_latency_s family.
_HISTOGRAM_STAGES = frozenset(
    {"queued", "dispatched", "bound", "prefill", "decode", "computed",
     "posted", "completed", "requeued"})


class Overloaded(RuntimeError):
    """Admission control rejected the request: the bounded queue is at
    capacity.  Explicit back-pressure the caller can act on (shed,
    retry with backoff) — the router never silently drops an admitted
    request, so it must never silently absorb an unadmittable one."""


@dataclasses.dataclass
class ServingConfig:
    """Router policy knobs.  Defaults suit the in-proc chaos campaigns;
    ``cli/serve.py`` maps its flags onto these."""

    replicas: int = 2           # target live replicas (heal up to this)
    max_replicas: int | None = None  # pressure-grow ceiling (None: +spares)
    max_queue: int = 64         # admission bound on OPEN requests
    micro_batch: int = 4        # requests per dispatch to one replica
    max_outstanding: int = 8    # per-replica in-flight cap (backpressure)
    poll_s: float = 0.005       # run() pump cadence
    replica_timeout_s: float = 2.0   # beat-staleness eviction threshold
    straggler_multiple: float = 4.0  # detector: x median
    straggler_consecutive: int = 3
    grow_watermark: float = 0.75     # queue fraction that counts as pressure
    grow_patience: int = 5           # consecutive pressured pumps to grow
    retain_done: int = 1024          # completed entries kept in the ledger
    record_requests: bool = True     # serve_request ledger records


@dataclasses.dataclass
class _Replica:
    """Router-side record of one live replica."""

    epoch: int
    sig: object = None            # last beat change-signature seen
    sig_mono: float = 0.0         # router monotonic time sig last changed
    in_flight: set = dataclasses.field(default_factory=set)  # rids
    served: int = 0
    service_s: float | None = None  # last reported micro-batch service time
    draining: bool = False
    wv: int = 0                   # weights version the router believes


class ServingRouter:
    """The fleet control plane: admission, dispatch, collection,
    liveness, eviction, promotion, drain.  Thread-safe: ``submit`` may
    be called from any number of client threads while one owner drives
    :meth:`pump` (or :meth:`run` on its own thread)."""

    def __init__(self, transport, config: ServingConfig | None = None,
                 events: FaultEvents | None = None, *,
                 telemetry=None, slo=None, scheduler=None):
        self.tx = transport
        self.cfg = config or ServingConfig()
        self.events = events if events is not None else FaultEvents()
        self.slo = slo  # an SLOEngine fed one observe() per outcome
        # Regime-aware dispatch: a RegimeScheduler observed
        # once per pump with the FLEET-wide load (queue depth + total
        # in-flight).  The chosen lever is stamped onto every dispatched
        # request so each replica's engine follows one coherent regime
        # instead of N local views drifting at the boundary.
        self.scheduler = scheduler
        self._lock = threading.RLock()
        self._queue: collections.deque[str] = collections.deque()
        self._ledger: dict[str, dict] = {}
        # The ledger holds at most ``retain_done`` completed entries: a
        # long-running router would otherwise retain every prompt +
        # result forever.  Compacted entries survive as counters plus a
        # bounded rid tombstone set (so a dead replica's very late
        # duplicate still classifies as a duplicate, not "unknown").
        self._done_fifo: collections.deque[str] = collections.deque()
        self._compacted = 0
        self._tombstones: collections.OrderedDict[str, None] = \
            collections.OrderedDict()
        self._tombstone_cap = max(1024, 4 * self.cfg.retain_done)
        self._replicas: dict[int, _Replica] = {}
        self._rid_seq = 0
        self._open = 0            # admitted, not yet completed
        self._closed = False
        self._pressure = 0
        self.rejected = 0
        self.completed = 0
        self.duplicates_discarded = 0
        self.unknown_results = 0
        self.redispatches = 0
        self.promotions = 0
        self.evictions = 0
        self.drains_done = 0
        self._ever_evicted: set[int] = set()
        # Continuous deployment: the deploy controller tells
        # the router which ranks carry canary weights and what slice of
        # traffic to steer at them (deterministic, counter-based — no
        # randomness, so campaigns replay).  ``on_complete`` is the
        # controller's per-outcome feed: called outside the lock with
        # {rid, replica, wv, version, latency_s, prompt, output} so the
        # canary judgement sees every completion's weights version.
        self._canary: set[int] = set()
        self._canary_every = 0
        self._canary_seq = 0
        self.on_complete = None
        self._detector = StragglerDetector(
            multiple=self.cfg.straggler_multiple,
            consecutive=self.cfg.straggler_consecutive,
            min_ranks=2,
        )
        # The latency histogram exists even with no telemetry sink
        # configured (quantiles feed the SLO assertions directly); with
        # a sink it is the registry's own instrument, so it streams.
        # An explicit ``telemetry=`` beats the process-wide install —
        # the router may be one of several instances sharing a process
        # (in-proc fleets), each with its own instance-tagged artifacts.
        tel = telemetry if telemetry is not None else get_telemetry()
        self._tel = tel
        self._stage_hist: dict[str, Histogram] = {}
        if tel is not None:
            self.latency = tel.registry.histogram(
                "serving_request_latency_s",
                buckets=default_latency_buckets())
            self._g_replicas = tel.registry.gauge("serving_replicas")
            self._g_depth = tel.registry.gauge("serving_queue_depth")
            self._g_inflight = tel.registry.gauge("serving_inflight")
            self._c_evict = tel.registry.counter("serving_evictions")
            self._c_reject = tel.registry.counter("serving_rejects")
        else:
            self.latency = Histogram(
                "serving_request_latency_s", (),
                buckets=default_latency_buckets())
            self._g_replicas = self._g_depth = self._g_inflight = None
            self._c_evict = self._c_reject = None

    def _stage_latency(self, stage: str) -> Histogram:
        """Get-or-create the ``serving_stage_latency_s{stage=...}``
        histogram — a registry instrument when telemetry is on (it
        streams into registry.json), a local one otherwise (quantiles
        still feed audits and tests)."""
        h = self._stage_hist.get(stage)
        if h is None:
            if self._tel is not None:
                h = self._tel.registry.histogram(
                    "serving_stage_latency_s",
                    buckets=default_latency_buckets(), stage=stage)
            else:
                h = Histogram("serving_stage_latency_s",
                              (("stage", stage),),
                              buckets=default_latency_buckets())
            self._stage_hist[stage] = h
        return h

    # -- admission -------------------------------------------------------
    def submit(self, prompt, rid: str | None = None,
               max_new: int | None = None) -> str:
        """Admit one request (or raise :class:`Overloaded`).  Returns
        the request id; poll :meth:`result` or :meth:`wait_idle` for
        completion.  ``max_new``: the request's own cap on new tokens,
        carried in the dispatched payload for an engine replica (None:
        the engine's default; a step callable ignores it)."""
        with self._lock:
            if self._closed:
                raise Overloaded("router is closed to new requests")
            if self._open >= self.cfg.max_queue:
                self.rejected += 1
                self.events.request_rejects += 1
                if self._c_reject is not None:
                    self._c_reject.inc()
                if self.slo is not None:
                    self.slo.observe(rejected=True)
                raise Overloaded(
                    f"queue full ({self._open}/{self.cfg.max_queue} "
                    "open requests)")
            if rid is None:
                self._rid_seq += 1
                rid = f"r{self._rid_seq}"
            if rid in self._ledger:
                raise ValueError(f"duplicate rid {rid!r}")
            entry = {
                "rid": rid, "prompt": prompt, "state": "queued",
                "replica": None, "epoch": None, "wv": None,
                "dispatches": 0,
                "submit_mono": time.monotonic(), "result": None,
                "latency_s": None, "events": [],
            }
            if max_new is not None:
                entry["max_new"] = int(max_new)
            stamp_stage(entry, "admitted", "router")
            stamp_stage(entry, "queued", "router")
            self._ledger[rid] = entry
            self._queue.append(rid)
            self._open += 1
            return rid

    def result(self, rid: str) -> dict | None:
        """The ledger entry for ``rid`` (a copy), or None if unknown —
        including a completed entry the ledger already compacted away
        (``retain_done`` bounds how long results are retained)."""
        with self._lock:
            entry = self._ledger.get(rid)
            return dict(entry) if entry is not None else None

    # -- lifecycle edges -------------------------------------------------
    def _promote_locked(self, rank: int, now: float) -> None:
        self.tx.set_serving_role(rank, "live")
        srv = self.tx.read_serving(rank)
        epoch = srv["epoch"]
        wv = int((srv.get("weights") or {}).get("version", 0) or 0)
        self._replicas[rank] = _Replica(epoch=epoch, sig_mono=now,
                                        wv=wv)
        self._detector.reset_rank(rank)  # fresh straggler episode
        self.tx.consume_join(rank)
        self.promotions += 1
        self.events.spare_promotions += 1
        self.tx.append_health_event("serve_promote", rank=rank,
                                    epoch=epoch)

    def _retire_locked(self, rank: int) -> int:
        """The epoch-fenced handoff: ``retire_replica`` bumps the fence
        and reclaims the queued requests in one atomic transport op;
        everything that was admitted but not completed goes back on the
        queue for survivors."""
        rep = self._replicas.pop(rank)
        undelivered = self.tx.retire_replica(rank)
        requeue = {r.get("rid") for r in undelivered}
        requeue.update(rep.in_flight)
        n = 0
        for rid in sorted(requeue, key=self._submit_order):
            entry = self._ledger.get(rid)
            # Only "dispatched" entries go back on the queue: "done"
            # was already delivered, and "queued" is already IN the
            # queue — appending it twice would double-dispatch.
            if entry is None or entry["state"] != "dispatched":
                continue
            entry["state"] = "queued"
            # dt here is dispatched -> requeued on the router clock:
            # how long the request sat on the replica that just died
            # (or drained) under it.
            stamp_stage(entry, "requeued", "router",
                        replica=entry["replica"])
            entry["replica"] = None
            self._queue.append(rid)
            self.redispatches += 1
            n += 1
        self.events.spare_demotions += 1
        return n

    def _submit_order(self, rid: str) -> float:
        entry = self._ledger.get(rid)
        return entry["submit_mono"] if entry else float("inf")

    def _evict_locked(self, rank: int, why: str, now: float) -> None:
        n = self._retire_locked(rank)
        self.evictions += 1
        self._ever_evicted.add(rank)
        self.events.replica_evictions += 1
        if self._c_evict is not None:
            self._c_evict.inc()
        self.tx.append_health_event("serve_evict", rank=rank, why=why,
                                    requeued=n)

    def drain(self, rank: int) -> bool:
        """Begin a graceful drain: stop dispatching to ``rank``, let it
        finish in-flight work, then demote it to spare (completed by a
        later :meth:`pump` once its in-flight set empties)."""
        with self._lock:
            rep = self._replicas.get(rank)
            if rep is None or rep.draining:
                return False
            rep.draining = True
        self.tx.set_drain(rank, True)
        self.tx.append_health_event("serve_drain", rank=rank)
        return True

    # -- continuous deployment --------------------------------
    def note_weights(self, rank: int, version: int) -> None:
        """The deploy controller observed ``rank`` commit ``version``:
        record it so dispatches stamp the weights version the request
        is expected to be answered under (``entry["wv"]``)."""
        with self._lock:
            rep = self._replicas.get(rank)
            if rep is not None:
                rep.wv = int(version)

    def set_canary(self, ranks, every_n: int) -> None:
        """Steer a deterministic traffic slice at the canary ranks:
        every ``every_n``-th replica pick routes to a canary (when one
        has dispatch room), the rest to the stable pool.  Counter-based
        — identical request streams produce identical routing, so the
        chaos campaigns replay.  ``every_n=0`` (or no ranks) clears the
        slice and dispatch falls back to pure least-loaded."""
        with self._lock:
            self._canary = {int(r) for r in ranks}
            self._canary_every = max(0, int(every_n))
            self._canary_seq = 0

    def clear_canary(self) -> None:
        self.set_canary((), 0)

    # -- the pump --------------------------------------------------------
    def pump(self) -> None:
        """One control iteration: collect results, judge liveness and
        stragglers, complete drains, dispatch, grow."""
        now = time.monotonic()
        # 1. Collect first: a dying replica's last posts must be
        # credited before its eviction re-queues their rids.
        for res in self.tx.take_results(64):
            self._complete(res, now)
        beats = self.tx.read_beats()
        with self._lock:
            self._observe_beats_locked(beats, now)
            self._judge_stragglers_locked(now)
            self._finish_drains_locked(now)
            self._dispatch_locked()
            self._grow_locked(now)
            if self._g_replicas is not None:
                self._g_replicas.set(len(self._replicas))
                self._g_depth.set(len(self._queue))
                self._g_inflight.set(sum(
                    len(rep.in_flight)
                    for rep in self._replicas.values()))

    def _observe_beats_locked(self, beats: dict, now: float) -> None:
        for rank, rep in list(self._replicas.items()):
            entry = beats.get(rank)
            if entry is not None and entry[0] != rep.sig:
                rep.sig = entry[0]
                rep.sig_mono = now
                # Beats carry LIVENESS only: per-replica service times
                # now flow from the request event stream (the
                # ``computed`` stage deltas, see _complete) — one
                # detector feed shared with training instead of a
                # second bookkeeping path off the beat channel.
            if now - rep.sig_mono > self.cfg.replica_timeout_s:
                self._evict_locked(rank, "dead (beat stale)", now)

    def _judge_stragglers_locked(self, now: float) -> None:
        samples = {rank: rep.service_s
                   for rank, rep in self._replicas.items()
                   if not rep.draining}
        for verdict in self._detector.update(samples):
            if verdict.rank in self._replicas:
                self._evict_locked(
                    verdict.rank,
                    f"straggler {verdict.ratio:.1f}x median", now)

    def _finish_drains_locked(self, now: float) -> None:
        for rank, rep in list(self._replicas.items()):
            if rep.draining and not rep.in_flight:
                n = self._retire_locked(rank)
                self.drains_done += 1
                self.events.drains += 1
                self.tx.append_health_event("serve_demote", rank=rank,
                                            why="drained", requeued=n)

    def _pick_replica_locked(self, ready: list) -> int:
        """Choose the next dispatch target from ``ready`` (a list of
        ``(in_flight, rank)``).  With a canary slice active, every
        ``every_n``-th pick prefers the canary pool (least-loaded
        within it), the rest the stable pool; an empty preferred pool
        falls back to the other so neither side ever starves."""
        if self._canary and self._canary_every:
            canary = [t for t in ready if t[1] in self._canary]
            stable = [t for t in ready if t[1] not in self._canary]
            self._canary_seq += 1
            if self._canary_seq % self._canary_every == 0:
                pool = canary or stable
            else:
                pool = stable or canary
            return min(pool)[1]
        return min(ready)[1]

    def _dispatch_locked(self) -> None:
        # One regime observation per pump — NOT per request: the
        # scheduler's dwell counts observations, and a burst of N
        # dispatches is one load sample, not N votes to flip.
        lever = None
        if self.scheduler is not None:
            lever = self.scheduler.observe(
                len(self._queue),
                sum(len(rep.in_flight)
                    for rep in self._replicas.values()))
        while self._queue:
            ready = [(len(rep.in_flight), rank)
                     for rank, rep in self._replicas.items()
                     if not rep.draining
                     and len(rep.in_flight) < self.cfg.max_outstanding]
            if not ready:
                return
            rank = self._pick_replica_locked(ready)
            rep = self._replicas[rank]
            room = self.cfg.max_outstanding - len(rep.in_flight)
            for _ in range(min(self.cfg.micro_batch, room,
                               len(self._queue))):
                rid = self._queue.popleft()
                entry = self._ledger.get(rid)
                if entry is None or entry["state"] != "queued":
                    # Stale queue entry: an eviction requeued the rid,
                    # then the dead replica's late result completed it
                    # (or compaction dropped it) while it still sat in
                    # the queue.  Re-dispatching a done rid would reset
                    # it to "dispatched" and let the survivor's answer
                    # drive _open negative — exactly-once demands one
                    # completion per rid, ever.
                    continue
                entry["state"] = "dispatched"
                entry["replica"] = rank
                entry["epoch"] = rep.epoch
                entry["wv"] = rep.wv
                entry["dispatches"] += 1
                # dt here is queued -> dispatched on the router clock:
                # the queue wait.
                stamp_stage(entry, "dispatched", "router",
                            disp=entry["dispatches"], replica=rank)
                rep.in_flight.add(rid)
                payload = {
                    "rid": rid, "prompt": entry["prompt"],
                    "epoch": rep.epoch,
                    "dispatch": entry["dispatches"],
                    "events": entry["events"],
                }
                if "max_new" in entry:
                    payload["max_new"] = entry["max_new"]
                if lever is not None:
                    payload["lever"] = lever
                self.tx.push_request(rank, payload)

    def _grow_locked(self, now: float) -> None:
        live = sum(1 for rep in self._replicas.values()
                   if not rep.draining)
        deficit = max(0, self.cfg.replicas - live)
        if len(self._queue) >= self.cfg.grow_watermark * self.cfg.max_queue:
            self._pressure += 1
        else:
            self._pressure = 0
        want = deficit
        if self._pressure >= self.cfg.grow_patience:
            ceiling = self.cfg.max_replicas
            if ceiling is None or live + deficit < ceiling:
                want += 1
                self._pressure = 0
        if want <= 0:
            return
        joins = self.tx.read_joins()
        # Prefer spares that were never evicted: an evicted-then-
        # re-announced rank only comes back when nobody cleaner exists.
        spares = sorted(
            (r for r, p in joins.items()
             if p.get("spare") and r not in self._replicas),
            key=lambda r: (r in self._ever_evicted, r))
        for rank in spares[:want]:
            self._promote_locked(rank, now)

    def _complete(self, res: dict, now: float) -> None:
        record = None
        outcome = None
        with self._lock:
            rid = res.get("rid")
            entry = self._ledger.get(rid)
            if entry is None:
                if rid in self._tombstones:
                    self.duplicates_discarded += 1
                else:
                    self.unknown_results += 1
                return
            if entry["state"] == "done":
                # First-result-wins: the replica died AFTER posting but
                # before the router observed it, so the rid was
                # re-dispatched and a survivor answered too.  One
                # delivery, one counted duplicate — recorded on the
                # winner's timeline so a postmortem shows the race.
                self.duplicates_discarded += 1
                stamp_stage(entry, "dropped", "router", why="duplicate")
                return
            owner = self._replicas.get(entry.get("replica"))
            if owner is not None:
                owner.in_flight.discard(rid)
                owner.served += 1
            entry["state"] = "done"
            entry["result"] = res.get("output")
            # The hub-stamped weights version that produced this
            # answer — what a postmortem ties a served
            # output back to.
            entry["version"] = res.get("version")
            entry["latency_s"] = now - entry["submit_mono"]
            # Merge the worker-side journey (taken/bound/computed/
            # posted, stamped on the replica's own clock) into the
            # authoritative ledger record, then close it.  Router
            # stamps in the posted copy would be duplicates of what
            # the ledger already holds.
            for ev in res.get("events") or ():
                if isinstance(ev, dict) and ev.get("by") != "router":
                    entry["events"].append(dict(ev))
            # dt here is dispatched -> completed on the router clock:
            # the full dispatch round trip (the worker stages nest
            # inside it — summing them alongside would double-count).
            stamp_stage(entry, "completed", "router")
            self.latency.observe(entry["latency_s"])
            for ev in entry["events"]:
                dt = ev.get("dt")
                if dt is not None and ev["stage"] in _HISTOGRAM_STAGES:
                    self._stage_latency(ev["stage"]).observe(dt)
            # The straggler feed (shared detector code path): the
            # ``computed`` deltas are per-replica compute intervals.
            # Engine replicas stamp ``decode`` instead —
            # the per-request decode interval is their service sample.
            samples = serving_stage_samples(
                entry["events"], stage="computed")
            if not samples:
                samples = serving_stage_samples(
                    entry["events"], stage="decode")
            for rank, dur in samples.items():
                rep = self._replicas.get(rank)
                if rep is not None:
                    rep.service_s = dur
            if self.slo is not None:
                self.slo.observe(latency_s=entry["latency_s"])
            if self._tel is not None:
                tr = self._tel.tracer
                t1 = tr.now()
                tr.complete("request", t1 - entry["latency_s"], t1,
                            rid=rid, dispatches=entry["dispatches"],
                            replica=entry.get("replica"))
            if self.cfg.record_requests:
                record = {
                    "rid": rid, "state": "done",
                    "latency_s": entry["latency_s"],
                    "dispatches": entry["dispatches"],
                    "version": res.get("version"),
                    "events": [dict(ev) for ev in entry["events"]],
                }
            if self.on_complete is not None:
                # The deploy controller's per-outcome feed: the posted
                # ``version`` is authoritative (the hub's fence stamped
                # it), ``wv`` is what the router expected at dispatch.
                outcome = {
                    "rid": rid, "replica": entry.get("replica"),
                    "wv": entry.get("wv"),
                    "version": res.get("version"),
                    "latency_s": entry["latency_s"],
                    "prompt": entry.get("prompt"),
                    "output": entry.get("result"),
                }
            self.completed += 1
            self._open -= 1
            self._done_fifo.append(rid)
            while len(self._done_fifo) > self.cfg.retain_done:
                old = self._done_fifo.popleft()
                self._ledger.pop(old, None)
                self._compacted += 1
                self._tombstones[old] = None
                while len(self._tombstones) > self._tombstone_cap:
                    self._tombstones.popitem(last=False)
        if outcome is not None:
            # Outside the lock: the controller's hook may read router
            # state (audit) or talk to the transport.
            self.on_complete(outcome)
        if record is not None:
            # Outside the lock: on tcp this is a network round trip,
            # and submit() from client threads must not block on it.
            self.tx.append_health_event("serve_request", **record)

    # -- driving ---------------------------------------------------------
    def run(self, stop_event: threading.Event) -> None:
        """Pump until ``stop_event`` — the router's own thread target."""
        while not stop_event.is_set():
            self.pump()
            stop_event.wait(self.cfg.poll_s)

    def wait_idle(self, timeout_s: float,
                  stop_event: threading.Event | None = None) -> bool:
        """Block until every admitted request completed (True) or the
        deadline passed (False).  Safe from a client thread while a
        router thread pumps."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._open == 0:
                    return True
            if stop_event is not None and stop_event.is_set():
                return False
            time.sleep(0.005)
        with self._lock:
            return self._open == 0

    # -- audit / shutdown ------------------------------------------------
    def audit(self) -> dict:
        """The exactly-once verdict the chaos campaigns assert on: every
        admitted request must be completed exactly once — duplicates
        discarded and rejects are *counted*, loss is a failure."""
        with self._lock:
            states = collections.Counter(
                e["state"] for e in self._ledger.values())
            # Compacted entries were all "done" — they left the ledger
            # but still count toward the exactly-once arithmetic.
            if self._compacted:
                states["done"] += self._compacted
            admitted = len(self._ledger) + self._compacted
            q = self.latency.quantiles()
            return {
                "admitted": admitted,
                "completed": self.completed,
                "open": self._open,
                "compacted": self._compacted,
                "states": dict(states),
                "rejected": self.rejected,
                "duplicates_discarded": self.duplicates_discarded,
                "unknown_results": self.unknown_results,
                "redispatches": self.redispatches,
                "promotions": self.promotions,
                "evictions": self.evictions,
                "drains": self.drains_done,
                "exactly_once": (self._open == 0
                                 and states.get("done", 0) == admitted),
                "weight_versions": {
                    rank: rep.wv
                    for rank, rep in sorted(self._replicas.items())},
                "canary": sorted(self._canary),
                "latency": q,
                "stage_latency": {
                    s: h.quantiles()
                    for s, h in sorted(self._stage_hist.items())},
            }

    def close(self) -> dict:
        """Stop admitting, append the ``serving`` summary health record
        (the ``tools/gang_status.py`` serving view), and return the
        final audit."""
        with self._lock:
            self._closed = True
        verdict = self.audit()
        with self._lock:
            live = len(self._replicas)
            depth = len(self._queue)
        self.tx.append_health_event(
            "serving", replicas=live, queue_depth=depth,
            completed=verdict["completed"],
            admitted=verdict["admitted"],
            rejected=verdict["rejected"],
            duplicates_discarded=verdict["duplicates_discarded"],
            evictions=verdict["evictions"], drains=verdict["drains"],
            promotions=verdict["promotions"],
            exactly_once=verdict["exactly_once"],
            p50=verdict["latency"].get("p50"),
            p95=verdict["latency"].get("p95"),
            p99=verdict["latency"].get("p99"),
        )
        return verdict
