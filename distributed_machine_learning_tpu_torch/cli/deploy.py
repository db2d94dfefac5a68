"""Continuous deployment onto a live serving fleet.

Counterpart of ``distributed_machine_learning_tpu/cli/deploy.py``.  Builds
a fleet (``cli/serve.py``'s shape: a router and replica workers over the
chosen ``--gang-transport``), fires sustained synthetic load at it, and
while it serves rolls ``--deploys`` checkpoints through the train-to-serve
pipeline (``runtime/deploy.py``): the verified-chain watch, the restore and
int8 requantize with the digests re-verified after it, the per-replica
fenced hot swap, the canary slice, then promotion or rollback.  The exit
status is the exactly-once audit plus the expected deploy outcomes.

    python -m distributed_machine_learning_tpu_torch.cli.deploy \\
        --replicas 4 --spares 1 --requests 300 --deploys 2

    # a quality regression in deploy 2: the canary probe fails, the
    # controller rolls back, and the run still audits clean
    python -m distributed_machine_learning_tpu_torch.cli.deploy \\
        --replicas 4 --requests 300 --deploys 2 --inject regression@2

The checkpoints are real: a tiny ``TransformerLM`` (vocab 32, d_model 16,
1 layer, 2 heads) is built on ``--device`` (cuda unless ``--device cpu``),
its ``TrainState`` saved per deploy through ``train/checkpoint.py``, and
every deploy restores it through ``load_serving_weights``.  The replicas'
compute stays synthetic (echo plus a checksum token, tagged with the
weights version), as in the reference.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import threading
import time

from distributed_machine_learning_tpu_torch.cli.serve import (
    _instance_telemetry,
    synthetic_step,
)


def checksum_token(prompt) -> int:
    """The synthetic step's answer contract (``cli/serve.py``), which the
    quality probe recomputes."""
    return (sum(prompt) + len(prompt)) % 97


def versioned_step(version: int, service_time_s: float = 0.0, corrupt: bool = False):
    """A version's synthetic decode step; ``corrupt=True`` miscomputes the
    checksum token (the injected quality regression)."""
    base = synthetic_step(service_time_s)

    def step(prompts):
        outs = base(prompts)
        if corrupt:
            outs = [o[:-1] + [(o[-1] + 1) % 97] for o in outs]
        return outs

    return step


def quality_probe(outcome: dict) -> bool:
    """True iff the served output keeps the synthetic step's contract."""
    prompt, out = outcome.get("prompt"), outcome.get("output")
    if not isinstance(out, list) or prompt is None:
        return False
    return out == list(prompt) + [checksum_token(prompt)]


def write_demo_checkpoint(directory: str, step: int, device=None) -> str:
    """Save a verified dp checkpoint of the tiny LM at ``step`` (weights
    from ``init_params(seed=step)``, built on ``device``); returns the
    step directory."""
    from distributed_machine_learning_tpu_torch import resolve_device
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.checkpoint import save_checkpoint
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = TransformerLM(vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                          device=resolve_device(device))
    init_params(model, seed=step)
    state = TrainState.create(model, AdamWConfig())
    state.step = step
    return save_checkpoint(directory, state)


def _run(args) -> int:
    import tempfile

    from distributed_machine_learning_tpu_torch.runtime.deploy import (
        DeployConfig,
        DeployController,
    )
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
    from distributed_machine_learning_tpu_torch.utils.summary import resilience_summary

    inject_at = 0
    if args.inject:
        kind, _, at = args.inject.partition("@")
        if kind != "regression" or not at.isdigit():
            print(f"bad --inject {args.inject!r} (expected regression@DEPLOY_N)",
                  file=sys.stderr)
            return 2
        inject_at = int(at)

    world = args.replicas + args.spares
    server = None
    if args.gang_transport == "inproc":
        hub = InProcHub(mirror_dir=args.gang_dir)
        make_tx = lambda: InProcTransport(hub)  # noqa: E731
    elif args.gang_transport == "file":
        if not args.gang_dir:
            print("--gang-transport file requires --gang-dir", file=sys.stderr)
            return 2
        make_tx = lambda: FileTransport(args.gang_dir)  # noqa: E731
    else:  # tcp: host the gang server in-process
        server = TcpGangServer(mirror_dir=args.gang_dir).start()
        address = server.address
        make_tx = lambda: TcpTransport(address, backoff_s=0.01)  # noqa: E731

    own_dir = args.checkpoint_dir is None
    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="deploy_ckpts_")
    events = FaultEvents()
    router_tel = _instance_telemetry(args, "router")
    router = ServingRouter(
        make_tx(),
        ServingConfig(replicas=args.replicas, max_queue=args.max_queue,
                      micro_batch=args.micro_batch,
                      replica_timeout_s=args.replica_timeout),
        events=events, telemetry=router_tel)

    def on_swap(version, rec):  # each version its own step; --inject corrupts one
        return versioned_step(version, args.service_time,
                              corrupt=bool(inject_at and version == inject_at))

    stop = threading.Event()
    wcfg = ServingWorkerConfig(micro_batch=args.micro_batch)
    worker_tels = [_instance_telemetry(args, f"replica{rank}") for rank in range(world)]
    workers = [start_worker_thread(make_tx(), rank, versioned_step(0, args.service_time),
                                   stop, wcfg, on_swap=on_swap, telemetry=worker_tels[rank])
               for rank in range(world)]
    router_thread = threading.Thread(target=router.run, args=(stop,), name="deploy-router",
                                     daemon=True)
    router_thread.start()

    controller = DeployController(
        make_tx(), router,
        DeployConfig(checkpoint_dir=ckpt_dir, canary_replicas=args.canary_replicas,
                     canary_every_n=args.canary_every, canary_window=args.canary_window,
                     judge_timeout_s=args.timeout, slo=tuple(args.slo)),
        events=events, telemetry=router_tel, quality_fn=quality_probe)

    # Sustained load from a client thread: traffic flows until every deploy
    # was judged (canary windows need completions) and --requests were admitted.
    submitted = {"n": 0}
    deploys_done = threading.Event()
    rng_state = 12345

    def load():
        nonlocal rng_state
        while not stop.is_set():
            if deploys_done.is_set() and submitted["n"] >= args.requests:
                return
            rng_state = (1103515245 * rng_state + 12345) % (1 << 31)
            prompt = [1 + (rng_state >> s) % 13 for s in (3, 7, 11)][:1 + rng_state % 3]
            try:
                router.submit(prompt)
                submitted["n"] += 1
            except Overloaded:
                time.sleep(0.005)

    load_thread = threading.Thread(target=load, name="deploy-load", daemon=True)
    load_thread.start()

    outcomes = []
    try:
        for n in range(1, args.deploys + 1):
            write_demo_checkpoint(ckpt_dir, step=100 * n, device=args.device)
            out = controller.poll_once()
            outcomes.append(out)
            print(f"deploy {n}: {out['outcome']}"
                  + (f" ({out['reason']})" if out["outcome"] == "rolled_back" else ""))
        deploys_done.set()
        load_thread.join(timeout=args.timeout)
        ok = router.wait_idle(args.timeout)
    finally:
        verdict = router.close()
        stop.set()
        for t, _ in workers:
            t.join(timeout=5)
        router_thread.join(timeout=5)
        load_thread.join(timeout=5)
        for tel in (router_tel, *worker_tels):
            if tel is not None:
                tel.close()
        if server is not None:
            server.stop()
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    summary = controller.summary()
    print(f"fleet: {args.replicas} replicas + {args.spares} spares over "
          f"{args.gang_transport}")
    print(f"requests: {verdict['completed']}/{verdict['admitted']} completed, "
          f"{verdict['duplicates_discarded']} duplicates discarded")
    print(f"deploys: {len(outcomes)} ({events.canary_promotions} promoted, "
          f"{events.canary_rollbacks} rolled back, {events.weight_swaps} replica swaps)")
    print(f"deployed version: v{summary['deployed_version']} (state: {summary['state']})")
    print(resilience_summary(events))
    rc = 0
    for n, out in enumerate(outcomes, 1):
        want = "rolled_back" if inject_at == n else "promoted"
        if out is None or out["outcome"] != want:
            print(f"FAILED: deploy {n} expected {want}, got {out and out['outcome']}",
                  file=sys.stderr)
            rc = 1
    if not ok or not verdict["exactly_once"]:
        print("FAILED: not every admitted request completed exactly once",
              file=sys.stderr)
        return 1
    if rc == 0:
        print("exactly-once audit: PASS")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replicas", type=int, default=4, help="target live replicas")
    ap.add_argument("--spares", type=int, default=1,
                    help="warm spares kept ready for promotion")
    ap.add_argument("--requests", type=int, default=200,
                    help="synthetic requests fired across the run")
    ap.add_argument("--deploys", type=int, default=1,
                    help="checkpoints written and rolled onto the fleet")
    ap.add_argument("--inject", default=None, metavar="regression@N",
                    help="corrupt the Nth deploy's outputs so the canary probe "
                         "fails and the rollback path runs")
    ap.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                    help="step directory the controller watches (default: a "
                         "temporary directory this run owns and removes)")
    ap.add_argument("--canary-replicas", dest="canary_replicas", type=int, default=1,
                    help="replicas swapped first as the canary")
    ap.add_argument("--canary-every", dest="canary_every", type=int, default=3,
                    help="traffic slice: every Nth dispatch to canary")
    ap.add_argument("--canary-window", dest="canary_window", type=int, default=12,
                    help="canary completions needed before judging")
    ap.add_argument("--max-queue", dest="max_queue", type=int, default=64,
                    help="admission bound")
    ap.add_argument("--micro-batch", dest="micro_batch", type=int, default=4,
                    help="requests per dispatch")
    ap.add_argument("--service-time", dest="service_time", type=float, default=0.0,
                    help="simulated decode seconds per micro-batch")
    ap.add_argument("--replica-timeout", dest="replica_timeout", type=float, default=2.0,
                    help="beat staleness that evicts a replica")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="per-phase deadline (canary fill, fleet idle)")
    ap.add_argument("--gang-transport", dest="gang_transport",
                    choices=("file", "inproc", "tcp"), default="inproc",
                    help="control-plane backend")
    ap.add_argument("--gang-dir", dest="gang_dir", default=None,
                    help="file backend directory / ledger mirror for "
                         "post-mortem serve_status")
    ap.add_argument("--telemetry-dir", dest="telemetry_dir", default=None,
                    help="per-instance telemetry artifacts")
    ap.add_argument("--slo", action="append", default=[], metavar="SPEC",
                    help="canary-scoped objective, e.g. p99<=250ms (repeatable): a "
                         "burn-rate alert during the canary window rolls the deploy back")
    ap.add_argument("--device", default=None,
                    help="where the demo checkpoints' model is built: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.deploys < 1:
        ap.error(f"--deploys must be >= 1, got {args.deploys}")
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
