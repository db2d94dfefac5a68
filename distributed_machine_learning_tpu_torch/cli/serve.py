"""Launch an elastic serving fleet over the gang control plane.

Counterpart of ``distributed_machine_learning_tpu/cli/serve.py``, with
every flag, plus ``--device``.  Fleet mode (the default) builds the
router and a pool of replica workers over the chosen
``--gang-transport``, promotes ``--replicas`` of them live (the rest stay
warm spares), fires ``--requests`` synthetic prompts at the admission
queue, waits for the fleet to drain, and prints the latency quantiles,
the exactly-once audit, and the resilience summary.  Exit status is the
audit verdict: 0 only when every admitted request completed exactly
once (and every ``--slo`` objective held).

    python -m distributed_machine_learning_tpu_torch.cli.serve \
        --replicas 4 --spares 2 --requests 200 --gang-transport inproc

    # the same fleet over a directory / a tcp gang server:
    python -m distributed_machine_learning_tpu_torch.cli.serve \
        --replicas 2 --spares 1 --requests 50 \
        --gang-transport file --gang-dir /tmp/serve
    python -m distributed_machine_learning_tpu_torch.cli.serve \
        --replicas 4 --spares 2 --requests 200 --gang-transport tcp

Worker mode joins an EXISTING tcp fleet from another process:

    python -m distributed_machine_learning_tpu_torch.cli.serve \
        --role worker --rank 3 --address 127.0.0.1:4242 \
        [--tx-chaos partition@40]

``--drain-after N`` demos the graceful-drain protocol mid-load: after N
completions, replica 0 is drained, finishes its in-flight requests, and
demotes to spare with zero drops.

The decode step is synthetic by default (echo + checksum token, with
``--service-time`` of simulated work), so the fleet runs without a
model or a device.  ``--engine`` puts every replica on the
continuous-batching engine (``inference/continuous.py``: paged KV pool,
iteration-level scheduling, the paged decode kernel and the int8
throughput lever) over a tiny model with random weights, and hands the
router the regime-aware scheduler.  The engines run on the card unless
``--device cpu`` is given.  On the CPU the model is the reference's
(vocab 32, d_model 16, 2 layers, 4 heads of dim 4, 2 KV heads); on the
card d_model is 128 (heads of dim 32, the narrowest the paged decode
kernel takes), every other field as on the CPU.  The replicas share one
model and its int8 twin, each with its own paged pool, and every engine
is warmed (its kernels built and launched) before any worker starts to
heartbeat.

``--telemetry-dir`` gives every serving process its own instance-tagged
stream (``registry.router.json`` with the per-stage latency histograms,
``trace.router.json`` + ``trace.replica<r>.json`` request spans), and
repeatable ``--slo`` objectives (``p99<=250ms``, ``reject_ratio<=5%``)
run a live burn-rate engine whose end-of-run verdict fails the exit
status:

    python -m distributed_machine_learning_tpu_torch.cli.serve \
        --replicas 2 --spares 1 --requests 100 \
        --gang-dir /tmp/serve --telemetry-dir /tmp/serve/telemetry \
        --slo 'p99<=250ms' --slo 'reject_ratio<=0.05'
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import torch

from distributed_machine_learning_tpu_torch import resolve_device


def synthetic_step(service_time_s: float = 0.0):
    """A model-free decode step: echoes each prompt plus one checksum
    token, sleeping ``service_time_s`` per micro-batch to simulate
    decode work."""

    def step(prompts):
        if service_time_s > 0:
            time.sleep(service_time_s)
        return [list(p) + [(sum(p) + len(p)) % 97] for p in prompts]

    return step


# The reference's tiny serving model; on the card d_model widens to
# CARD_D_MODEL (heads of dim 32: the paged decode kernel takes head dim
# 32, 64 or 128).
ENGINE_MODEL = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=4,
                    n_kv_heads=2)
CARD_D_MODEL = 128


def engine_model_config(device) -> dict:
    """The ``--engine`` model's shape on ``device``."""
    cfg = dict(ENGINE_MODEL)
    if torch.device(device).type == "cuda":
        cfg["d_model"] = CARD_D_MODEL
    return cfg


def make_engines(n: int, micro_batch: int, device) -> list:
    """``n`` continuous-batching engines, one per worker (an engine is
    owned by a single thread), over one model with random weights (seed
    0) and one int8 twin, each with its own paged pool.  Each is warmed
    before any worker starts heartbeating: a kernel build inside the
    first live ``step()`` would starve the beat channel long enough to
    look like a dead replica."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import (
        TransformerLM,
    )

    model = TransformerLM(**engine_model_config(device), device=device)
    init_params(model, seed=0)
    cfg = EngineConfig(max_lanes=micro_batch, block_size=4, num_blocks=32,
                       max_len=16, max_new=8)
    engines = []
    for _ in range(n):
        engine = ContinuousEngine(
            model, cfg, device=device,
            lever_models=engines[0].models if engines else None)
        engine.warmup(prompt_lens=(1, 2, 3))
        engines.append(engine)
    return engines


def _parse_tx_chaos(spec: str):
    from distributed_machine_learning_tpu_torch.runtime.faults import (
        TransportChaos,
    )

    kind, _, arg = spec.partition("@")
    if kind == "partition" and arg.isdigit():
        return TransportChaos(partition_after=int(arg))
    raise ValueError(
        f"bad --tx-chaos {spec!r} (expected partition@AFTER_OPS)")


def _instance_telemetry(args, instance: str):
    """One instance-tagged Telemetry over ``--telemetry-dir`` (or None
    when the flag is unset).  ``enabled=True`` bypasses the rank-0
    gate: every serving process owns its own stream — the collision
    safety comes from the instance tag, not from writing nothing."""
    if not args.telemetry_dir:
        return None
    from distributed_machine_learning_tpu_torch.telemetry import Telemetry

    return Telemetry(args.telemetry_dir, instance=instance,
                     enabled=True)


def _run_worker(args) -> int:
    from distributed_machine_learning_tpu_torch.runtime.serving_worker import (
        ServingWorkerConfig,
        run_serving_worker,
    )
    from distributed_machine_learning_tpu_torch.runtime.transport import (
        make_transport,
    )

    chaos = _parse_tx_chaos(args.tx_chaos) if args.tx_chaos else None
    tx = make_transport("tcp", address=args.address, chaos=chaos)
    stop = threading.Event()
    tel = _instance_telemetry(args, f"replica{args.rank}")
    engine = (make_engines(1, args.micro_batch, args.device)[0]
              if args.engine else None)
    try:
        summary = run_serving_worker(
            tx, args.rank, synthetic_step(args.service_time), stop,
            ServingWorkerConfig(micro_batch=args.micro_batch),
            telemetry=tel, engine=engine)
    finally:
        if tel is not None:
            tel.close()
    print(f"worker rank {args.rank}: {summary}")
    return 0


def _run_fleet(args) -> int:
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
    from distributed_machine_learning_tpu_torch.runtime.serving import (
        Overloaded,
        ServingConfig,
        ServingRouter,
    )
    from distributed_machine_learning_tpu_torch.runtime.serving_worker import (
        ServingWorkerConfig,
        start_worker_thread,
    )
    from distributed_machine_learning_tpu_torch.runtime.transport import (
        FileTransport,
        InProcHub,
        InProcTransport,
        TcpGangServer,
        TcpTransport,
    )
    from distributed_machine_learning_tpu_torch.utils.summary import (
        resilience_summary,
    )

    world = args.replicas + args.spares
    server = None
    if args.gang_transport == "inproc":
        hub = InProcHub(mirror_dir=args.gang_dir)
        make_tx = lambda: InProcTransport(hub)  # noqa: E731
    elif args.gang_transport == "file":
        if not args.gang_dir:
            print("--gang-transport file requires --gang-dir",
                  file=sys.stderr)
            return 2
        make_tx = lambda: FileTransport(args.gang_dir)  # noqa: E731
    else:  # tcp: host the gang server in-process, clients on the wire
        server = TcpGangServer(mirror_dir=args.gang_dir).start()
        address = server.address
        make_tx = lambda: TcpTransport(address,  # noqa: E731
                                       backoff_s=0.01)

    slo = None
    if args.slo:
        from distributed_machine_learning_tpu_torch.telemetry.slo import (
            SLOEngine,
        )

        slo = SLOEngine(args.slo,
                        short_window_s=args.slo_short_window,
                        long_window_s=args.slo_long_window,
                        burn_threshold=args.slo_burn_threshold)
    router_tel = _instance_telemetry(args, "router")
    worker_tels = [_instance_telemetry(args, f"replica{rank}")
                   for rank in range(world)]

    scheduler = None
    if args.engine:
        from distributed_machine_learning_tpu_torch.runtime.scheduler import (
            RegimeScheduler,
        )

        scheduler = RegimeScheduler()
    events = FaultEvents()
    router = ServingRouter(
        make_tx(),
        ServingConfig(replicas=args.replicas,
                      max_queue=args.max_queue,
                      micro_batch=args.micro_batch,
                      replica_timeout_s=args.replica_timeout),
        events=events, telemetry=router_tel, slo=slo,
        scheduler=scheduler)
    stop = threading.Event()
    wcfg = ServingWorkerConfig(micro_batch=args.micro_batch)
    engines = (make_engines(world, args.micro_batch, args.device)
               if args.engine else [None] * world)
    workers = [start_worker_thread(
        make_tx(), rank, synthetic_step(args.service_time), stop, wcfg,
        telemetry=worker_tels[rank], engine=engines[rank])
        for rank in range(world)]
    router_thread = threading.Thread(target=router.run, args=(stop,),
                                     name="serve-router", daemon=True)
    router_thread.start()

    rng_state = 12345
    drained = args.drain_after <= 0
    try:
        for i in range(args.requests):
            rng_state = (1103515245 * rng_state + 12345) % (1 << 31)
            prompt = [1 + (rng_state >> s) % 13 for s in (3, 7, 11)][
                :1 + rng_state % 3]
            while True:
                try:
                    router.submit(prompt)
                    break
                except Overloaded:
                    time.sleep(0.005)  # explicit back-pressure: retry
            if not drained and router.completed >= args.drain_after:
                drained = True
                router.drain(0)
        if not drained:
            # Submission outpaced completion: wait for the threshold so
            # the drain demo still happens mid-completion.
            deadline = time.monotonic() + args.timeout
            while (router.completed < args.drain_after
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            drained = True
            router.drain(0)
        ok = router.wait_idle(args.timeout)
    finally:
        verdict = router.close()
        stop.set()
        for t, _ in workers:
            t.join(timeout=5)
        router_thread.join(timeout=5)
        for tel in (router_tel, *worker_tels):
            if tel is not None:
                tel.close()
        if server is not None:
            server.stop()

    lat = verdict["latency"]
    print(f"fleet: {args.replicas} replicas + {args.spares} spares "
          f"over {args.gang_transport}")
    print(f"requests: {verdict['completed']}/{verdict['admitted']} "
          f"completed, {verdict['rejected']} rejected at admission, "
          f"{verdict['duplicates_discarded']} duplicates discarded")
    print(f"fleet events: {verdict['promotions']} promotions, "
          f"{verdict['evictions']} evictions, "
          f"{verdict['drains']} drains")
    if lat.get("p50") is not None:
        print(f"latency: p50 {lat['p50'] * 1e3:.1f} ms  "
              f"p95 {lat['p95'] * 1e3:.1f} ms  "
              f"p99 {lat['p99'] * 1e3:.1f} ms")
    if scheduler is not None:
        print(f"regime: {scheduler.lever} after "
              f"{scheduler.flips} flip(s)")
    print(resilience_summary(events))
    rc = 0
    if slo is not None:
        from distributed_machine_learning_tpu_torch.telemetry.slo import (
            format_verdict,
        )

        slo_verdict = slo.verdict()
        print(format_verdict(slo_verdict))
        if not slo_verdict["ok"]:
            print("FAILED: SLO objectives violated", file=sys.stderr)
            rc = 1
    if not ok or not verdict["exactly_once"]:
        print("FAILED: not every admitted request completed exactly "
              "once", file=sys.stderr)
        return 1
    print("exactly-once audit: PASS")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--role", choices=("fleet", "worker"),
                    default="fleet",
                    help="fleet: router + worker pool in this process; "
                         "worker: join an existing tcp fleet")
    ap.add_argument("--replicas", type=int, default=4,
                    help="target live replicas (fleet mode)")
    ap.add_argument("--spares", type=int, default=1,
                    help="warm spares kept ready for promotion")
    ap.add_argument("--requests", type=int, default=100,
                    help="synthetic requests to fire (fleet mode)")
    ap.add_argument("--max-queue", dest="max_queue", type=int,
                    default=64,
                    help="admission bound: open requests past this "
                         "raise Overloaded")
    ap.add_argument("--micro-batch", dest="micro_batch", type=int,
                    default=4, help="requests per dispatch")
    ap.add_argument("--engine", action="store_true",
                    help="replicas run the continuous-batching engine "
                         "(paged KV pool, per-sequence retirement) over a "
                         "tiny model with random weights instead of the "
                         "synthetic batch step; the router gets the "
                         "regime-aware scheduler.  The model is vocab 32, "
                         "2 layers, 4 heads, 2 KV heads, d_model 16 on "
                         "the CPU and 128 on the card (head dim 32, the "
                         "narrowest the paged decode kernel takes)")
    ap.add_argument("--device", default=None,
                    help="where --engine replicas run: cuda (default) or "
                         "cpu")
    ap.add_argument("--service-time", dest="service_time", type=float,
                    default=0.0,
                    help="simulated decode seconds per micro-batch")
    ap.add_argument("--replica-timeout", dest="replica_timeout",
                    type=float, default=2.0,
                    help="beat staleness that evicts a replica")
    ap.add_argument("--drain-after", dest="drain_after", type=int,
                    default=0,
                    help="gracefully drain replica 0 after this many "
                         "completions (0: never)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="fleet-idle deadline before declaring failure")
    ap.add_argument("--gang-transport", dest="gang_transport",
                    choices=("file", "inproc", "tcp"),
                    default="inproc", help="control-plane backend")
    ap.add_argument("--gang-dir", dest="gang_dir", default=None,
                    help="file backend directory / inproc+tcp ledger "
                         "mirror for post-mortem gang_status")
    ap.add_argument("--telemetry-dir", dest="telemetry_dir",
                    default=None,
                    help="per-instance telemetry artifacts (router + "
                         "one stream per replica): stage histograms "
                         "in registry.router.json, request spans in "
                         "trace.<instance>.json for trace_merge")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="SPEC",
                    help="declare an objective, e.g. p99<=250ms or "
                         "reject_ratio<=0.05 (repeatable); the run "
                         "fails when one is violated or its burn-rate "
                         "alert fires")
    ap.add_argument("--slo-short-window", dest="slo_short_window",
                    type=float, default=5.0,
                    help="burn-rate short window, seconds")
    ap.add_argument("--slo-long-window", dest="slo_long_window",
                    type=float, default=60.0,
                    help="burn-rate long window, seconds")
    ap.add_argument("--slo-burn-threshold", dest="slo_burn_threshold",
                    type=float, default=2.0,
                    help="alert when BOTH windows burn error budget "
                         "above this multiple of the sustainable rate")
    ap.add_argument("--address", default=None,
                    help="worker mode: host:port of the fleet's gang "
                         "server")
    ap.add_argument("--rank", type=int, default=0,
                    help="worker mode: this replica's rank")
    ap.add_argument("--tx-chaos", dest="tx_chaos", default=None,
                    help="worker mode: 'partition@AFTER_OPS' severs "
                         "this worker's channel after that many "
                         "transport ops")
    args = ap.parse_args(argv)
    if args.engine:
        args.device = resolve_device(args.device)

    if args.role == "worker":
        if not args.address:
            ap.error("--role worker requires --address")
        return _run_worker(args)
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.spares < 0:
        ap.error(f"--spares must be >= 0, got {args.spares}")
    if args.tx_chaos:
        ap.error("--tx-chaos is a worker-mode flag (the fleet's own "
                 "channels must stay healthy)")
    return _run_fleet(args)


if __name__ == "__main__":
    sys.exit(main())
