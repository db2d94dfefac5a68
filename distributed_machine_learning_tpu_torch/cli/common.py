"""Shared runner behind the four reference-parity entry points.

Counterpart of ``distributed_machine_learning_tpu/cli/common.py``
(``make_flag_parser``, ``parse_flags``, ``run_part``).  The reference's
four parts are clones that differ only in the gradient-sync layer
(SURVEY.md §1); one runner takes the strategy and each part's constants.
The reference's flags are kept verbatim: ``--master-ip`` (default
``127.0.1.1:8000``), ``--rank`` (0), ``--num-nodes`` (1)
(``part2/2a/main.py:210-218``).  Each rank is one process
(``runtime/distributed.py``): start ``--num-nodes`` of them with ranks
0..N-1, as the reference is run.

Beyond the reference's surface (defaults reproduce it): ``--model``
(the VGGs and ResNet-18/34/50, ``models/registry.py``), ``--optimizer``
sgd/lars/adamw (``--fused-update``: AdamW's kernel K7; with sgd or lars
a WARNING and the reference update, as in the JAX CLI),
``--lr-schedule``/``--warmup-steps`` (``train/schedule.py``),
``--grad-accum``, ``--dist-eval``, ``--loader`` native/python/auto and
``--loader-retries`` (``data/native_loader.py``, ``data/retry.py``),
checkpoints after every epoch (``--ckpt-dir``, ``--keep-last-n``,
``--async-ckpt``; rank 0 writes, the state being replicated) and their
restore (``--resume``; ``--resume auto`` restarts a failed attempt from
the newest complete checkpoint, up to ``--max-restarts`` times).

Flags of the JAX CLI that this port does not carry raise
NotImplementedError naming their ROADMAP item (faults, telemetry,
profiling, the gang, the watchdog: A6; ``--ring-topology``: A5c).
"""

from __future__ import annotations

import argparse
import itertools

import torch

from distributed_machine_learning_tpu_torch.models.registry import list_models
from distributed_machine_learning_tpu_torch.train.optimizers import optimizer_names

SEED = 69143  # the reference's shared seed (part1/main.py:17)
EVAL_BATCH = 256

# Flags of the JAX part CLIs this port does not carry: (dest, the value that
# means "not asked for", the ROADMAP item).
_NOT_PORTED = [
    ("faults", None, "A6 (runtime/faults.py)"),
    ("trace_dir", None, "A6 (utils/profiling.py)"),
    ("metrics_file", None, "A6 (utils/profiling.py MetricsLogger)"),
    ("telemetry_dir", None, "A6 (telemetry)"),
    ("telemetry_flush_every", 20, "A6 (telemetry)"),
    ("gang_dir", None, "A6 (runtime/coordinator.py)"),
    ("watchdog_timeout", 0, "A6 (runtime/resilience.py)"),
    ("ring_topology", None, "A5c (ops/topology.py)"),
]


def make_flag_parser(description: str) -> argparse.ArgumentParser:
    """The JAX parts' flag surface (defaults reproduce the reference), plus
    ``--device``."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        DEFAULT_MASTER_IP,
    )

    p = argparse.ArgumentParser(description=description)
    # The reference's connectivity flags (part2/2a/main.py:210-218).
    p.add_argument("--master-ip", dest="master_ip", default=DEFAULT_MASTER_IP,
                   help="rendezvous address host:port")
    p.add_argument("--rank", default=0, type=int, help="process rank")
    p.add_argument("--num-nodes", dest="num_nodes", default=1, type=int,
                   help="number of processes")
    p.add_argument("--device", default=None,
                   help="cuda (default; rank r on cuda:r mod the card count) or cpu")
    p.add_argument("--gang-dir", dest="gang_dir", default=None)
    p.add_argument("--heartbeat-interval", dest="heartbeat_interval", default=1.0, type=float)
    p.add_argument("--peer-timeout", dest="peer_timeout", default=60.0, type=float)
    p.add_argument("--data-root", default="./data", type=str)
    p.add_argument("--epochs", default=1, type=int)  # range(1): part1/main.py:123
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--model", default="vgg11", type=str, choices=list_models(),
                   help="model to train; default reproduces the reference's VGG11")
    p.add_argument("--max-iters", default=40, type=int,
                   help="training iteration cap (reference: 40)")
    p.add_argument("--batch-size", default=None, type=int,
                   help="override the part's per-worker batch size")
    p.add_argument("--eval-batches", default=None, type=int,
                   help="cap eval batches (default: the whole test set)")
    p.add_argument("--eval-batch-size", dest="eval_batch_size", default=EVAL_BATCH, type=int)
    p.add_argument("--ckpt-dir", default=None, type=str)
    p.add_argument("--async-ckpt", dest="async_ckpt", action="store_true")
    p.add_argument("--resume", nargs="?", const="latest", default=None,
                   choices=["latest", "auto"])
    p.add_argument("--max-restarts", dest="max_restarts", default=3, type=int)
    p.add_argument("--keep-last-n", dest="keep_last_n", default=None, type=int)
    p.add_argument("--guard-nonfinite", dest="guard_nonfinite", action="store_true",
                   help="a NaN/Inf synced gradient skips that update (state, BN "
                        "statistics, residual and step counter unchanged)")
    p.add_argument("--loader-retries", dest="loader_retries", default=0, type=int)
    p.add_argument("--faults", default=None, type=str)
    p.add_argument("--trace-dir", default=None, type=str)
    p.add_argument("--metrics-file", default=None, type=str)
    p.add_argument("--telemetry-dir", dest="telemetry_dir", default=None, type=str)
    p.add_argument("--telemetry-flush-every", dest="telemetry_flush_every", default=20,
                   type=int)
    p.add_argument("--loader", default="auto", choices=["auto", "python", "native"],
                   help="'native': the C++ prefetching loader (data/native_loader.py, "
                        "built with g++ on first use), 'python' the Python one, 'auto' "
                        "native if it builds (the same batch stream either way)")
    p.add_argument("--lr-schedule", dest="lr_schedule", default="constant",
                   choices=["constant", "cosine", "step"])
    p.add_argument("--warmup-steps", dest="warmup_steps", default=0, type=int)
    p.add_argument("--clip-norm", dest="clip_norm", default=None, type=float,
                   help="clip the synced gradient to this global L2 norm")
    p.add_argument("--optimizer", default="sgd", choices=optimizer_names(),
                   help="'sgd' reproduces the reference (lr 0.1, momentum 0.9, wd "
                        "1e-4); 'lars' layer-wise adaptive rates (train/lars.py); "
                        "'adamw' decoupled-decay Adam")
    p.add_argument("--fused-update", dest="fused_update", action="store_true",
                   help="the AdamW update as the fused kernel K7 (--optimizer adamw)")
    p.add_argument("--wire-dtype", dest="wire_dtype", default=None, choices=["bfloat16"],
                   help="deprecated: use --ring-compress bf16")
    p.add_argument("--ring-compress", dest="ring_compress", default="none",
                   choices=["none", "bf16", "int8", "topk"],
                   help="ring hop compression (part3): bf16 cast, int8 per-chunk "
                        "symmetric + f32 scale, topk; int8/topk carry an error-"
                        "feedback residual unless --ring-no-error-feedback")
    p.add_argument("--ring-codec-impl", dest="ring_codec_impl", default="xla",
                   choices=["xla", "pallas"],
                   help="the int8 codec: 'pallas' runs the hand-written kernels "
                        "K8-K10 on the card, 'xla' their plain PyTorch versions "
                        "(bitwise equal)")
    p.add_argument("--ring-topk-frac", dest="ring_topk_frac", default=0.125, type=float)
    p.add_argument("--ring-no-error-feedback", dest="ring_error_feedback",
                   action="store_false")
    p.add_argument("--ring-topology", dest="ring_topology", default=None,
                   metavar="INNERxOUTER")
    p.add_argument("--dist-eval", dest="dist_eval", action="store_true")
    p.add_argument("--watchdog-timeout", dest="watchdog_timeout", default=0, type=float)
    p.add_argument("--local-loss", dest="local_loss", action="store_true",
                   help="every rank prints its own loss (the reference's per-rank "
                        "print surface) instead of the mean over the ranks")
    p.add_argument("--unsync-bn", dest="unsync_bn", action="store_true",
                   help="each rank keeps its own BatchNorm running statistics (the "
                        "reference part3's quirk); default averages them")
    p.add_argument("--grad-accum", dest="grad_accum", default=1, type=int,
                   help="split each rank's batch into this many microbatches, "
                        "accumulating their gradients for one update (one sync a step)")
    return p


def make_schedule(args, learning_rate: float, start_step: int = 0):
    """The ``step -> lr`` schedule the flags describe (None for the
    reference's fixed rate).  ``start_step``: the state's step at the run's
    start (non-zero after ``--resume``); the horizon is *this run's*
    ``max_iters × epochs`` from there, so a resumed cosine run does not
    start past its own end."""
    from distributed_machine_learning_tpu_torch.train.schedule import (
        step_decay,
        warmup_cosine,
    )

    total = max(args.max_iters * args.epochs, 1)
    if args.lr_schedule == "cosine":
        base = warmup_cosine(learning_rate, args.warmup_steps, total)
    elif args.lr_schedule == "step":
        base = step_decay(learning_rate, boundaries=(total // 2, (3 * total) // 4))
    else:
        return None
    if start_step:
        return lambda step: base(step - start_step)
    return base


def parse_flags(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """parse_args + cross-flag validation (before any process group)."""
    args = parser.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        parser.error("--resume requires --ckpt-dir")
    if args.max_restarts < 0:
        parser.error(f"--max-restarts must be >= 0, got {args.max_restarts}")
    if args.keep_last_n is not None and args.keep_last_n < 1:
        parser.error(f"--keep-last-n must be >= 1, got {args.keep_last_n}")
    if args.loader_retries < 0:
        parser.error(f"--loader-retries must be >= 0, got {args.loader_retries}")
    if args.clip_norm is not None and args.clip_norm <= 0:
        parser.error(f"--clip-norm must be positive, got {args.clip_norm}")
    if not 0.0 < args.ring_topk_frac <= 1.0:
        parser.error(f"--ring-topk-frac must be in (0, 1], got {args.ring_topk_frac}")
    if args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
    if args.warmup_steps < 0:
        parser.error(f"--warmup-steps must be >= 0, got {args.warmup_steps}")
    if args.lr_schedule == "cosine" and args.warmup_steps >= args.max_iters * args.epochs:
        parser.error(f"--warmup-steps {args.warmup_steps} must be shorter than the run "
                     f"(max_iters × epochs = {args.max_iters * args.epochs} steps): the "
                     "rate would never reach its peak")
    if args.num_nodes < 1 or not 0 <= args.rank < args.num_nodes:
        parser.error(f"--rank {args.rank} out of range for --num-nodes {args.num_nodes}")
    return args


def _refuse_unported(args) -> None:
    for dest, default, item in _NOT_PORTED:
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP {item}")


def _strategy_kwargs(strategy_name: str, args, kwargs: dict | None) -> dict:
    from distributed_machine_learning_tpu_torch.utils.logging import rank0_print

    kwargs = dict(kwargs or {})
    compress = args.ring_compress
    if args.wire_dtype:
        rank0_print("WARNING: --wire-dtype is deprecated; use --ring-compress bf16.")
        if compress == "none":
            compress = "bf16"
    if strategy_name != "ring":
        if compress != "none":
            rank0_print(f"WARNING: --ring-compress/--wire-dtype only apply to the ring "
                        f"strategy (part3); strategy {strategy_name!r} runs uncompressed.")
        return kwargs
    if compress != "none":
        kwargs.update(compress=compress, topk_frac=args.ring_topk_frac,
                      error_feedback=args.ring_error_feedback)
    if args.ring_codec_impl != "xla":
        if compress != "int8":
            rank0_print("WARNING: --ring-codec-impl pallas has kernels for "
                        f"--ring-compress int8 only; {compress!r} runs its plain path.")
        kwargs["codec_impl"] = args.ring_codec_impl
    return kwargs




def _copy_tree(dst: dict, src: dict, what: str) -> None:
    """Copy a nested dict of tensors into ``dst``'s tensors, in place."""
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"checkpoint {what} do not fit this model: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for k, t in dst.items():
        if isinstance(t, dict):
            _copy_tree(t, src[k], what)
        elif tuple(t.shape) != tuple(src[k].shape):
            raise ValueError(f"checkpoint {what} {k}: shape {tuple(src[k].shape)} != "
                             f"{tuple(t.shape)}")
        else:
            t.copy_(src[k])


def _reset_bn(model) -> None:
    """BatchNorm layers back to scale 1, bias 0 and fresh running stats."""
    with torch.no_grad():
        for bn in model.bns:
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)


def run_part(strategy_name: str, per_rank_batch: int, use_bn: bool, args,
             strategy_kwargs: dict | None = None, init_method: str | None = None,
             shutdown: bool = True) -> dict:
    """Train ``args.model`` (default VGG-11) on CIFAR-10 (or its synthetic
    stand-in) for ``args.epochs`` under one sync strategy, as this rank of
    ``--num-nodes`` processes; after each epoch evaluate, then save a
    checkpoint under ``--ckpt-dir``.

    Returns this rank's record: ``losses`` (every step's printed loss),
    ``times`` (timed iterations, s), ``sync_ms`` (the sync inside each
    step), ``backend``/``wire``/``device``, and the live ``state``,
    ``step``, ``place``, ``batches`` (a fresh train-batch iterator factory),
    ``events`` (the run's ``FaultEvents``), ``saved`` (the checkpoint paths
    written) and ``ctx`` (with ``shutdown=False`` the process group stays up
    for the caller, who shuts it down).

    Under ``--unsync-bn`` each rank keeps its own BN statistics: a save
    gathers them into ``[world, C]`` leaves (the reference's stacked layout),
    and a restore gives each rank its row; a checkpoint of plain ``[C]``
    statistics gives every rank the same ones."""
    from distributed_machine_learning_tpu_torch.data.cifar10 import load_cifar10
    from distributed_machine_learning_tpu_torch.data.distributed_loader import (
        DistributedBatchLoader,
    )
    from distributed_machine_learning_tpu_torch.data.loader import BatchLoader
    from distributed_machine_learning_tpu_torch.models.registry import get_model, init_params
    from distributed_machine_learning_tpu_torch.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.loop import evaluate, train_epoch
    from distributed_machine_learning_tpu_torch.train.optimizers import (
        get_optimizer,
        init_for_config,
    )
    from distributed_machine_learning_tpu_torch.train.state import TrainState
    from distributed_machine_learning_tpu_torch.train.step import (
        SyncTimer,
        make_eval_step,
        make_train_step,
    )
    from distributed_machine_learning_tpu_torch.utils.logging import rank0_print
    from distributed_machine_learning_tpu_torch.utils.summary import (
        model_summary,
        resilience_summary,
    )

    _refuse_unported(args)
    cfg_cls = get_optimizer(args.optimizer)[0]
    distributed = strategy_name != "none"
    if not distributed and args.num_nodes > 1:
        raise ValueError("part1 is the single-process baseline; --num-nodes must be 1")
    # The strategy's flags fail before any rendezvous.
    strategy = get_strategy(strategy_name, **_strategy_kwargs(strategy_name, args,
                                                              strategy_kwargs))
    ctx = initialize_from_flags(args.master_ip, args.rank, args.num_nodes,
                                device=args.device, init_method=init_method)
    events = FaultEvents()
    supervised = args.resume == "auto"
    show_resilience = supervised or args.guard_nonfinite or bool(args.loader_retries)
    writer = None
    failed = False
    try:
        comm, device = ctx.comm, ctx.device
        # Reference banner (part2/2a/main.py:200-203), with the wire chosen.
        rank0_print(f"strategy={strategy_name} world_size={comm.world} "
                    f"backend={ctx.backend or 'none'} wire={comm.wire} devices={device}")
        dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
        model = init_params(get_model(args.model, use_bn=use_bn, compute_dtype=dtype,
                                      device=device), SEED)
        opt_config = cfg_cls()
        if args.fused_update:
            if isinstance(opt_config, AdamWConfig):
                opt_config = cfg_cls(fused=True)
            else:
                rank0_print("WARNING: --fused-update applies to --optimizer adamw only; "
                            f"{args.optimizer!r} runs its reference update.")
        state = TrainState.create(model, opt_config)
        unsync_bn = args.unsync_bn
        if unsync_bn and not distributed:
            rank0_print("WARNING: --unsync-bn has no effect on the single-device part1 "
                        "path (one device, one set of stats).")
            unsync_bn = False
        if unsync_bn and not state.batch_stats:
            unsync_bn = False  # BN-free model: nothing to (un)sync

        def fresh_state():
            init_params(model, SEED)
            _reset_bn(model)
            return TrainState.create(model, opt_config)

        def restore_latest(state):
            """``state`` restored in place from the newest complete checkpoint
            under --ckpt-dir (unchanged when there is none)."""
            from distributed_machine_learning_tpu_torch.train.checkpoint import (
                NoRestorableCheckpointError,
                checkpoint_chain_report,
                latest_checkpoint,
                restore_checkpoint,
            )

            latest = latest_checkpoint(args.ckpt_dir, events=events)
            if latest is None:
                report = checkpoint_chain_report(args.ckpt_dir)
                if any(v.startswith("quarantined") for _, v in report):
                    lines = "\n".join(f"  {p}: {v}" for p, v in report)
                    raise NoRestorableCheckpointError(
                        f"--resume: no restorable checkpoint under {args.ckpt_dir} — every "
                        f"candidate in the fallback chain is unusable:\n{lines}\n(remove "
                        "--resume, or point --ckpt-dir at a clean directory, to start "
                        "from scratch)")
                rank0_print(f"No checkpoint under {args.ckpt_dir}; starting from scratch.")
                return state
            host = restore_checkpoint(latest, files_verified=True, events=events)
            with torch.no_grad():
                _copy_tree(state.params, host.params, "parameters")
                for k, b in state.batch_stats.items():
                    saved = host.batch_stats.get(k)
                    if saved is None:
                        raise ValueError(f"checkpoint {latest} has no BN statistics {k}")
                    if saved.dim() == b.dim() + 1:  # stacked per rank: --unsync-bn's
                        if not unsync_bn or saved.shape[0] != comm.world:
                            raise ValueError(
                                f"checkpoint {latest} holds per-rank BN statistics "
                                f"{tuple(saved.shape)}: resume it with --unsync-bn at "
                                f"--num-nodes {saved.shape[0]}")
                        saved = saved[comm.rank]
                    b.copy_(saved)  # plain stats into quirk mode: every rank the same
                state.step = host.step
                rank0_print(f"Resumed from {latest} (step {state.step})")
                if type(host.config) is not type(opt_config):
                    # SGD's (raw-gradient-scale), LARS's (scaled-step) and AdamW's
                    # moments are not interchangeable: reset, keep the rest.
                    rank0_print(f"WARNING: checkpoint was trained with "
                                f"{type(host.config).__name__} but this run uses "
                                f"--optimizer {args.optimizer}; resetting momentum buffers "
                                "(params/step/stats are kept).")
                    state.momentum = init_for_config(opt_config)(state.params)
                else:
                    _copy_tree(state.momentum, host.momentum, "optimizer moments")
            state.config = opt_config
            return state

        if args.resume:
            state = restore_latest(state)
        if args.resume and strategy.stateful:
            # The residual is the step's, per rank, not the TrainState's.
            rank0_print(f"NOTE: error-feedback residuals (--ring-compress "
                        f"{strategy.compress}) are not checkpointed; resuming with a zero "
                        "residual (one step of EF warmup).")
        rank0_print(model_summary(model, title=args.model))
        sync_timer = SyncTimer(device)
        local_loss = args.local_loss and comm.world > 1
        step = make_train_step(model, strategy, comm, sync_bn=not unsync_bn,
                               clip_norm=args.clip_norm, guard_nonfinite=args.guard_nonfinite,
                               local_loss=local_loss, sync_timer=sync_timer,
                               accum_steps=args.grad_accum,
                               schedule=make_schedule(args, opt_config.learning_rate,
                                                      start_step=state.step))
        losses: list = []

        def recorded(state, images, labels):
            state, loss = step(state, images, labels)
            losses.append(loss)
            return state, loss

        if args.dist_eval and not distributed:
            rank0_print("WARNING: --dist-eval has no effect for the single-device part1 "
                        "path (no mesh to shard over); evaluating on one device.")
        eval_step = make_eval_step(model, comm if args.dist_eval and distributed else None)
        train_set = load_cifar10(args.data_root, train=True)
        test_set = load_cifar10(args.data_root, train=False)
        if train_set.synthetic:
            rank0_print("WARNING: CIFAR-10 not found on disk — using the deterministic "
                        "synthetic stand-in dataset.")
        batch = args.batch_size if args.batch_size is not None else per_rank_batch

        loader_cls, dist_loader_cls = BatchLoader, DistributedBatchLoader
        if args.loader in ("auto", "native"):
            from distributed_machine_learning_tpu_torch.data import native_loader

            if native_loader.native_available():
                loader_cls = native_loader.NativeBatchLoader
                dist_loader_cls = native_loader.NativeDistributedBatchLoader
            elif args.loader == "native":
                raise RuntimeError(native_loader.native_unavailable_reason())
            else:
                rank0_print("native loader unavailable, using python loader "
                            f"({native_loader.native_unavailable_reason()})")
        retry_policy = None
        if args.loader_retries:
            from distributed_machine_learning_tpu_torch.data.retry import RetryPolicy

            retry_policy = RetryPolicy(max_retries=args.loader_retries)

        def base_loader():
            if not distributed:
                return loader_cls(train_set, batch)
            return dist_loader_cls(train_set, batch, comm.world, comm.rank)

        # Epochs completed across supervised restarts: a restart resumes from
        # the per-epoch checkpoint, so finished epochs stay done.
        progress = {"epochs": 0}

        def epoch_batches():
            base = base_loader()
            epoch_base = progress["epochs"] * args.max_iters

            def source(pos):
                # Seekable by re-slicing: the loaders are deterministic.
                return itertools.islice(iter(base), pos - epoch_base, None)

            if retry_policy is not None:
                from distributed_machine_learning_tpu_torch.data.retry import retry_batches

                return retry_batches(source, retry_policy, events, start=epoch_base)
            return source(epoch_base)

        def place(images, labels):
            return (torch.from_numpy(images).to(device),
                    torch.from_numpy(labels).to(device, torch.long))

        saved_paths: list = []

        def save(state):
            nonlocal writer
            from distributed_machine_learning_tpu_torch.train.checkpoint import (
                AsyncCheckpointWriter,
                HostState,
                save_checkpoint,
            )

            snap = state
            if unsync_bn:  # every rank's statistics, stacked [world, C]
                snap = HostState(params=state.params, momentum=state.momentum,
                                 batch_stats={k: torch.stack(comm.all_gather(b))
                                              for k, b in state.batch_stats.items()},
                                 step=state.step, config=state.config)
            if args.async_ckpt:
                if writer is None:
                    writer = AsyncCheckpointWriter()
                path = writer.save(args.ckpt_dir, snap, keep_last_n=args.keep_last_n)
                rank0_print(f"Saving checkpoint to {path} (async)")
            else:
                path = save_checkpoint(args.ckpt_dir, snap, keep_last_n=args.keep_last_n)
                rank0_print(f"Saved checkpoint to {path}")
            saved_paths.append(path)

        times: list = []

        def run_epochs(state):
            while progress["epochs"] < args.epochs:
                state, timer = train_epoch(recorded, state, epoch_batches(),
                                           place_batch=place, max_iters=args.max_iters,
                                           local_loss_rank=comm.rank if local_loss else None)
                times.extend(timer.times)
                eval_batches = iter(BatchLoader(test_set, args.eval_batch_size))
                if args.eval_batches is not None:
                    eval_batches = itertools.islice(eval_batches, args.eval_batches)
                evaluate(eval_step, eval_batches, place_batch=place)
                if args.ckpt_dir:
                    save(state)
                progress["epochs"] += 1
            return state

        if supervised:
            from distributed_machine_learning_tpu_torch.runtime.supervisor import (
                run_attempts,
            )

            def attempt(restart_idx):
                s = state
                if restart_idx > 0:
                    if writer is not None:
                        try:  # the last scheduled save must be visible first
                            writer.wait()
                        except Exception as e:
                            rank0_print("async checkpoint save failed before restart "
                                        f"({type(e).__name__}: {e}); resuming from the "
                                        "previous complete checkpoint")
                    s = restore_latest(fresh_state())
                    step.set_sync_state(None)
                    # Finished epochs from what was restored, not from the counter.
                    progress["epochs"] = min(args.epochs, s.step // max(args.max_iters, 1))
                return run_epochs(s)

            state = run_attempts(attempt, max_restarts=args.max_restarts, events=events)
        else:
            state = run_epochs(state)
        if writer is not None:
            writer.close()
        return {"losses": [float(x) for x in losses], "times": times,
                "sync_ms": sync_timer.ms(), "backend": ctx.backend, "wire": comm.wire,
                "device": str(device), "world": comm.world, "state": state, "step": step,
                "place": place, "batches": lambda: iter(base_loader()), "events": events,
                "saved": saved_paths, "ctx": ctx}
    except BaseException:
        if writer is not None:
            try:  # no half-written async save left in flight
                writer.close()
            except Exception as e:
                rank0_print(f"async checkpoint save failed ({type(e).__name__}: {e})")
        failed = True
        raise
    finally:
        if show_resilience:  # on a crashed run too: the counters are the diagnosis
            rank0_print(resilience_summary(events))
        if shutdown or failed:
            ctx.shutdown()  # dist.destroy_process_group parity (part2/2a/main.py:207)
