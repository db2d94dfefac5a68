"""Serving replica worker — the fleet's rank-side loop.

A copy of ``distributed_machine_learning_tpu/runtime/serving_worker.py``;
the ``engine`` seam drives the port's
:class:`~..inference.continuous.ContinuousEngine`.

One worker = one rank's thread (in-proc campaigns) or process
(``cli/serve.py --role worker`` over tcp/file), driving the replica
state machine the router controls through the serving channels:

``spare``: announce on the join channel (``spare=True``, refreshed
every heartbeat, with the newest prefetched checkpoint step — the
warm-spare contract, so promotion is O(restore) not O(init)) and
poll ``read_serving`` for a promotion.

``live``: publish beats (liveness + the last micro-batch service time
the router's straggler detector judges), pop micro-batches off this
rank's request queue, run the injected ``step_fn`` (production: the
``inference/generate.py`` step-callable seam,
``make_serving_step``), and post one result per request **under the
serving epoch bound at promotion**.  When the router retires this
replica (drain completed, or eviction) the epoch advances: the
worker's next ``read_serving`` shows a new epoch/role and it falls
back to spare mode — and any result it was still holding posts as a
fenced no-op (``post_result`` → False), never a duplicate.  Requests
carry their dispatch epoch: a taken request stamped NEWER than the
bound epoch (this rank was retired and re-promoted between the
worker's serving read and its take) is pushed back and the worker
rebinds before serving it, so no request is burned under a fence that
is guaranteed to reject it.

The loop mirrors ``runtime/inproc_worker.py``: ``TransportError``
means this worker is severed from the control plane (hub cleared, tcp
partition) and it retires quietly — the router's beat-staleness
eviction re-dispatches whatever it owned.  This module is
deliberately torch-free: ``step_fn`` (or the engine) is the only
compute seam.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from distributed_machine_learning_tpu_torch.runtime.transport import (
    GangTransport,
    TransportError,
    carry_stage_context,
    stamp_stage,
)


@dataclasses.dataclass
class ServingWorkerConfig:
    heartbeat_interval: float = 0.05  # beat + spare-announce cadence
    micro_batch: int = 4              # max requests per take
    poll_s: float = 0.005             # idle request-poll cadence


def run_serving_worker(tx: GangTransport, rank: int, step_fn,
                       stop_event: threading.Event,
                       cfg: ServingWorkerConfig | None = None, *,
                       prefetch_fn=None, on_restore=None,
                       on_swap=None, telemetry=None,
                       engine=None) -> dict:
    """Drive one replica until ``stop_event`` (a campaign's kill switch
    doubles as the worker's death) or the control plane severs.

    ``step_fn(prompts) -> outputs``: the compute seam — one output per
    prompt, order-aligned.  ``prefetch_fn() -> int | None``: called
    while spare, returns the newest verified checkpoint step to
    advertise.  ``on_restore(prefetched_step)``: called once per
    promotion — where a real replica restores params (O(restore));
    tests count the calls.  ``on_swap(version, record) -> step_fn |
    None``: the weight hot-swap seam — called between
    micro-batches when the deploy controller staged a new weights
    version for this rank (``set_weights``), AFTER every in-flight
    result posted under the old version (the drain).  It loads the
    staged weights (production: rebuild the ``make_serving_step``
    callable from the record's checkpoint path) and may return a
    replacement step function; the worker then ``commit_weights`` —
    the hub-atomic fence move — and serves every later request under
    the new version.  ``telemetry``: this replica's own
    instance-tagged :class:`~..telemetry.Telemetry` — one ``request``
    span per take→outcome lands in its Chrome trace, which
    ``tools/trace_merge.py`` re-homes next to the router's track.

    Requests that carry an ``events`` record are stamped at
    every stage on THIS replica's monotonic clock: ``taken`` (in the
    transport wrapper), ``bound`` after the fence check, ``computed``
    after ``step_fn``, ``posted`` at the post (wrapper again) — and on
    the failure paths ``requeued`` (newer-epoch repush) / ``fenced``
    (zombie drop), so every exit closes the record.

    ``engine``: a
    :class:`~..inference.continuous.ContinuousEngine` replaces the
    batch-static ``step_fn`` with iteration-level scheduling.  Fence
    triage is unchanged; kept requests are *submitted* to the engine
    (which stamps ``prefill``/``decode`` instead of ``computed``),
    each loop iteration advances it one decode step, and every
    retirement posts immediately under the bound epoch — so requests
    finish mid-micro-batch instead of waiting on the group.  Router
    lever hints (``request["lever"]``, stamped by a regime-aware
    dispatcher) are forwarded via ``note_lever``.  On a staged weight
    version the worker pauses admission and keeps stepping until
    ``engine.in_flight() == 0`` — the drain that guarantees no
    sequence ever mixes weight versions — before ``on_swap`` (which
    may return a *replacement engine*, or swap the existing engine's
    params itself and return None) and the ``commit_weights`` fence.
    On retirement the engine's queued/in-flight work is aborted
    without posting: the router's retire already requeued those rids
    for survivors, and a late post would fence anyway.

    Returns a summary dict (served counts, restores) for audits.
    """
    cfg = cfg or ServingWorkerConfig()
    tracer = telemetry.tracer if telemetry is not None else None
    by = f"replica{rank}"
    seq = 0
    served = 0
    fenced = 0
    repushed = 0
    restores = 0
    swaps = 0
    aborted = 0
    last_service: float | None = None
    bound_epoch: int | None = None
    bound_version: int | None = None
    prefetched = None
    last_announce = -1.0
    last_beat = -1.0
    if engine is not None:
        # The engine stamps stage events itself; rename its actor to
        # this replica so each request's taken→bound→prefill→decode
        # chain stays on one monotonic clock (and the router's
        # straggler feed can attribute the decode samples to a rank).
        engine._by = by

    def _post_engine(done) -> None:
        """Post one engine retirement batch under the bound epoch."""
        nonlocal served, fenced, last_service
        for d in done:
            req = d.get("request") or {}
            svc = d["prefill_s"] + d["decode_s"]
            last_service = svc
            ok = tx.post_result(rank, bound_epoch,
                                carry_stage_context(req, {
                                    "rid": d["rid"],
                                    "output": d["tokens"],
                                    "service_time_s": svc,
                                    "lever": d["lever"],
                                }), version=bound_version)
            if tracer is not None:
                t1 = time.perf_counter()
                tracer.complete("request", t1 - d["e2e_s"], t1,
                                rid=d["rid"], rank=rank,
                                stage="posted" if ok else "fenced")
            if ok:
                served += 1
            else:
                fenced += 1

    try:
        while not stop_event.is_set():
            state = tx.read_serving(rank)
            if state["role"] != "live":
                if engine is not None and bound_epoch is not None:
                    # Retired with work still on the engine: the
                    # router's retire_replica already requeued every
                    # owned rid for survivors — drop ours without
                    # posting (a post would fence anyway).
                    aborted += len(engine.abort_all())
                bound_epoch = None
                bound_version = None
                now = time.monotonic()
                if (last_announce < 0
                        or now - last_announce
                        >= cfg.heartbeat_interval):
                    if prefetch_fn is not None:
                        prefetched = prefetch_fn()
                    tx.announce_join(rank, {
                        "rank": rank, "spare": True, "kind": "serving",
                        "prefetched_step": prefetched,
                        "time": time.time(),
                    })
                    last_announce = now
                stop_event.wait(cfg.poll_s)
                continue
            if bound_epoch != state["epoch"]:
                # Promoted (or re-promoted into a fresh epoch): restore
                # before serving, and post every future result under
                # THIS epoch — the fence that makes a late post after
                # retirement a no-op instead of a duplicate.
                if engine is not None and bound_epoch is not None:
                    # Re-promoted without passing through spare: the
                    # old epoch's requests were requeued at retirement.
                    aborted += len(engine.abort_all())
                bound_epoch = state["epoch"]
                bound_version = None  # rebind to the committed record
                restores += 1
                last_announce = -1.0
                if on_restore is not None:
                    on_restore(prefetched)
            wrec = state.get("weights") or {}
            if bound_version is None:
                bound_version = int(wrec.get("version", 0) or 0)
                if engine is not None and not engine.in_flight():
                    engine.version = bound_version
            pending = wrec.get("pending")
            if pending is not None and int(pending) != bound_version:
                # Hot-swap point: the deploy controller
                # staged a new weights version for this rank.  We are
                # between micro-batches here — every in-flight result
                # already posted under the OLD version, which is the
                # zero-dropped-requests drain the two-phase protocol
                # promises.  Load the staged weights, then commit: the
                # hub flips the committed version atomically with the
                # result fence, so an old-version zombie's late post
                # can never complete a post-swap rid.
                pending = int(pending)
                if engine is not None:
                    # Engine drain: sequences are mid-decode
                    # at arbitrary frontiers, and swap_params refuses
                    # while any are in flight — finish every one under
                    # the OLD weights first, admission paused so queued
                    # work waits for the new version.  This is the
                    # step-boundary fence: no sequence ever mixes
                    # weight versions mid-stream.
                    engine.pause_admission()
                    while (engine.in_flight()
                           and not stop_event.is_set()):
                        _post_engine(engine.step())
                    if engine.in_flight():
                        continue  # killed mid-drain; exit via loop top
                    if on_swap is not None:
                        new_engine = on_swap(pending, dict(wrec))
                        if new_engine is not None:
                            engine = new_engine
                            engine._by = by
                    engine.version = pending
                    engine.resume_admission()
                elif on_swap is not None:
                    new_step = on_swap(pending, dict(wrec))
                    if new_step is not None:
                        step_fn = new_step
                tx.commit_weights(rank, pending)
                bound_version = pending
                swaps += 1
                if tracer is not None:
                    tracer.instant("weight_swap", rank=rank,
                                   version=bound_version)
            now = time.monotonic()
            if last_beat < 0 or now - last_beat >= cfg.heartbeat_interval:
                seq += 1
                tx.publish_beat(rank, {
                    "rank": rank, "seq": seq, "kind": "serving",
                    "served": served, "service_time_s": last_service,
                    "weight_version": bound_version,
                    "time": time.time(),
                })
                last_beat = now
            reqs = tx.take_requests(rank, cfg.micro_batch)
            if not reqs and engine is None:
                stop_event.wait(cfg.poll_s)
                continue
            t_take = time.perf_counter()
            # Fence check BEFORE compute: the router stamps every
            # request with its dispatch epoch.  A stamp NEWER than the
            # bound means this rank was retired and re-promoted between
            # read_serving and the take — running the request under the
            # stale bound would fence its post and strand it in the new
            # replica's in-flight set forever (the rank keeps beating,
            # so no eviction requeues it): push it back onto our own
            # queue and re-read the serving state to rebind first.  A
            # stamp OLDER than the bound is a zombie from a retired
            # epoch (the router requeued its rid at retirement) — drop
            # it as fenced rather than re-push it in a cycle no future
            # epoch can ever serve.
            keep = []
            newer = []
            for r in reqs:
                e = r.get("epoch")
                if e is None or e == bound_epoch:
                    keep.append(r)
                elif e > bound_epoch:
                    newer.append(r)
                else:
                    fenced += 1
                    if isinstance(r.get("events"), list):
                        stamp_stage(r, "fenced", by, epoch=e,
                                    bound=bound_epoch)
                    if tracer is not None:
                        tracer.complete("request", t_take,
                                        time.perf_counter(),
                                        rid=r.get("rid"), rank=rank,
                                        stage="fenced")
            if newer:
                for r in newer:
                    if isinstance(r.get("events"), list):
                        stamp_stage(r, "requeued", by,
                                    epoch=r.get("epoch"),
                                    bound=bound_epoch)
                    if tracer is not None:
                        tracer.complete("request", t_take,
                                        time.perf_counter(),
                                        rid=r.get("rid"), rank=rank,
                                        stage="requeued")
                    tx.push_request(rank, r)
                repushed += len(newer)
            reqs = keep
            if engine is not None:
                for r in reqs:
                    if isinstance(r.get("events"), list):
                        # dt: taken -> bound, the fence-check interval.
                        stamp_stage(r, "bound", by, epoch=bound_epoch)
                    hint = r.get("lever")
                    if hint is not None:
                        try:
                            engine.note_lever(hint)
                        except ValueError:
                            pass  # router speaks a newer lever dialect
                    try:
                        engine.submit(r.get("rid"), r.get("prompt"),
                                      max_new=r.get("max_new"),
                                      request=r)
                    except (TypeError, ValueError) as e:
                        # A request the engine can NEVER serve (empty,
                        # or longer than max_len): answer it rather
                        # than strand it in the router's in-flight set.
                        tx.post_result(rank, bound_epoch,
                                       carry_stage_context(r, {
                                           "rid": r.get("rid"),
                                           "output": None,
                                           "error": str(e),
                                       }), version=bound_version)
                if newer and not reqs:
                    continue  # rebind via read_serving first
                if not engine.has_work():
                    stop_event.wait(cfg.poll_s)
                    continue
                # One iteration: every in-flight sequence advances one
                # token; retirements post immediately and their lanes
                # backfill inside the same step.
                _post_engine(engine.step())
                continue
            if not reqs:
                if newer:
                    continue  # rebind via read_serving first
                stop_event.wait(cfg.poll_s)
                continue
            for r in reqs:
                if isinstance(r.get("events"), list):
                    # dt: taken -> bound, the fence-check interval.
                    stamp_stage(r, "bound", by, epoch=bound_epoch)
            t0 = time.perf_counter()
            outs = step_fn([r.get("prompt") for r in reqs])
            last_service = time.perf_counter() - t0
            for r in reqs:
                if isinstance(r.get("events"), list):
                    # dt: bound -> computed, this replica's compute
                    # interval — the straggler detector's sample.
                    stamp_stage(r, "computed", by)
            for req, out in zip(reqs, outs):
                ok = tx.post_result(rank, bound_epoch,
                                    carry_stage_context(req, {
                                        "rid": req.get("rid"),
                                        "output": out,
                                        "service_time_s": last_service,
                                    }), version=bound_version)
                if tracer is not None:
                    tracer.complete("request", t_take,
                                    time.perf_counter(),
                                    rid=req.get("rid"), rank=rank,
                                    stage="posted" if ok else "fenced")
                if ok:
                    served += 1
                else:
                    # Retired mid-batch: the fence already handed the
                    # rest of this work to survivors.
                    fenced += 1
                    break
    except TransportError:
        pass  # severed from the control plane: retire quietly
    return {"rank": rank, "served": served, "fenced": fenced,
            "repushed": repushed, "restores": restores, "swaps": swaps,
            "aborted": aborted, "weight_version": bound_version}


def start_worker_thread(tx: GangTransport, rank: int, step_fn,
                        stop_event: threading.Event,
                        cfg: ServingWorkerConfig | None = None,
                        **kwargs) -> tuple[threading.Thread, dict]:
    """Spawn :func:`run_serving_worker` on a daemon thread; the second
    element collects the worker's summary once it exits (campaign
    audits read it after joining)."""
    out: dict = {}

    def _run():
        out.update(run_serving_worker(tx, rank, step_fn, stop_event,
                                      cfg, **kwargs))

    t = threading.Thread(target=_run, name=f"serve-worker-{rank}",
                         daemon=True)
    t.start()
    return t, out
