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

Flags of the JAX CLI that this port does not carry raise
NotImplementedError naming their ROADMAP item (checkpoints, faults,
telemetry, the native loader, loader retries, LR schedules, gradient
accumulation, ``--ring-topology``, ``--dist-eval``, ``--optimizer lars``,
``--fused-update`` with sgd).
"""

from __future__ import annotations

import argparse
import itertools

import torch

SEED = 69143  # the reference's shared seed (part1/main.py:17)
EVAL_BATCH = 256

# Flags of the JAX part CLIs this port does not carry: (dest, the value that
# means "not asked for", the ROADMAP item).
_NOT_PORTED = [
    ("ckpt_dir", None, "A4 (train/checkpoint.py for the VGG parts)"),
    ("async_ckpt", False, "A4 (train/checkpoint.py for the VGG parts)"),
    ("resume", None, "A4 (train/checkpoint.py, --resume)"),
    ("keep_last_n", None, "A4 (train/checkpoint.py for the VGG parts)"),
    ("max_restarts", 3, "A4 (--resume auto)"),
    ("faults", None, "A6 (runtime/faults.py)"),
    ("trace_dir", None, "A6 (utils/profiling.py)"),
    ("metrics_file", None, "A6 (utils/profiling.py MetricsLogger)"),
    ("telemetry_dir", None, "A6 (telemetry)"),
    ("telemetry_flush_every", 20, "A6 (telemetry)"),
    ("gang_dir", None, "A6 (runtime/coordinator.py)"),
    ("watchdog_timeout", 0, "A6 (runtime/resilience.py)"),
    ("loader_retries", 0, "A4 (data/retry.py)"),
    ("lr_schedule", "constant", "A4 (train/schedule.py's schedules)"),
    ("warmup_steps", 0, "A4 (train/schedule.py's schedules)"),
    ("grad_accum", 1, "A4 (--grad-accum)"),
    ("ring_topology", None, "A5 (ops/topology.py)"),
    ("dist_eval", False, "A4 (--dist-eval)"),
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
    p.add_argument("--model", default="vgg11", type=str,
                   choices=["resnet18", "resnet50", "vgg11", "vgg13", "vgg16", "vgg19",
                            "vggtest"],
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
                   help="'auto' and 'python': the Python loader (the native one is "
                        "not ported)")
    p.add_argument("--lr-schedule", dest="lr_schedule", default="constant",
                   choices=["constant", "cosine", "step"])
    p.add_argument("--warmup-steps", dest="warmup_steps", default=0, type=int)
    p.add_argument("--clip-norm", dest="clip_norm", default=None, type=float,
                   help="clip the synced gradient to this global L2 norm")
    p.add_argument("--optimizer", default="sgd", choices=["adamw", "lars", "sgd"],
                   help="'sgd' reproduces the reference (lr 0.1, momentum 0.9, wd 1e-4)")
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
    p.add_argument("--grad-accum", dest="grad_accum", default=1, type=int)
    return p


def parse_flags(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """parse_args + cross-flag validation (before any process group)."""
    args = parser.parse_args(argv)
    if args.clip_norm is not None and args.clip_norm <= 0:
        parser.error(f"--clip-norm must be positive, got {args.clip_norm}")
    if not 0.0 < args.ring_topk_frac <= 1.0:
        parser.error(f"--ring-topk-frac must be in (0, 1], got {args.ring_topk_frac}")
    if args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
    if args.num_nodes < 1 or not 0 <= args.rank < args.num_nodes:
        parser.error(f"--rank {args.rank} out of range for --num-nodes {args.num_nodes}")
    return args


def _refuse_unported(args) -> None:
    for dest, default, item in _NOT_PORTED:
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP {item}")
    if args.loader == "native":
        raise NotImplementedError("--loader native is not ported yet: ROADMAP A4 "
                                  "(data/native_loader.py)")
    if args.fused_update and args.optimizer != "adamw":
        raise NotImplementedError(
            f"--fused-update with --optimizer {args.optimizer}: only AdamW has a fused "
            "kernel (K7); a fused SGD update is ROADMAP A4")


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


def run_part(strategy_name: str, per_rank_batch: int, use_bn: bool, args,
             strategy_kwargs: dict | None = None, init_method: str | None = None,
             shutdown: bool = True) -> dict:
    """Train ``args.model`` (default VGG-11) on CIFAR-10 (or its synthetic
    stand-in) for ``args.epochs`` under one sync strategy, as this rank of
    ``--num-nodes`` processes, and evaluate after each epoch.

    Returns this rank's record: ``losses`` (every step's printed loss),
    ``times`` (timed iterations, s), ``sync_ms`` (the sync inside each
    step), ``backend``/``wire``/``device``, and the live ``state``,
    ``step``, ``place``, ``batches`` (a fresh train-batch iterator factory)
    and ``ctx`` (with ``shutdown=False`` the process group stays up for the
    caller, who shuts it down)."""
    from distributed_machine_learning_tpu_torch.data.cifar10 import load_cifar10
    from distributed_machine_learning_tpu_torch.data.distributed_loader import (
        DistributedBatchLoader,
    )
    from distributed_machine_learning_tpu_torch.data.loader import BatchLoader
    from distributed_machine_learning_tpu_torch.models.vgg import get_model, init_params
    from distributed_machine_learning_tpu_torch.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.loop import evaluate, train_epoch
    from distributed_machine_learning_tpu_torch.train.optimizers import get_optimizer
    from distributed_machine_learning_tpu_torch.train.state import TrainState
    from distributed_machine_learning_tpu_torch.train.step import (
        SyncTimer,
        make_eval_step,
        make_train_step,
    )
    from distributed_machine_learning_tpu_torch.utils.logging import rank0_print
    from distributed_machine_learning_tpu_torch.utils.summary import model_summary

    _refuse_unported(args)
    cfg_cls = get_optimizer(args.optimizer)[0]  # raises for lars
    if strategy_name == "none" and args.num_nodes > 1:
        raise ValueError("part1 is the single-process baseline; --num-nodes must be 1")
    # The strategy's flags fail before any rendezvous.
    strategy = get_strategy(strategy_name, **_strategy_kwargs(strategy_name, args,
                                                              strategy_kwargs))
    ctx = initialize_from_flags(args.master_ip, args.rank, args.num_nodes,
                                device=args.device, init_method=init_method)
    try:
        comm, device = ctx.comm, ctx.device
        # Reference banner (part2/2a/main.py:200-203), with the wire chosen.
        rank0_print(f"strategy={strategy_name} world_size={comm.world} "
                    f"backend={ctx.backend or 'none'} wire={comm.wire} devices={device}")
        dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
        model = init_params(get_model(args.model, use_bn=use_bn, compute_dtype=dtype,
                                      device=device), SEED)
        config = cfg_cls(fused=True) if args.fused_update else cfg_cls()
        state = TrainState.create(model, config)
        rank0_print(model_summary(model, title=args.model))
        sync_timer = SyncTimer(device)
        local_loss = args.local_loss and comm.world > 1
        step = make_train_step(model, strategy, comm, sync_bn=not args.unsync_bn,
                               clip_norm=args.clip_norm, guard_nonfinite=args.guard_nonfinite,
                               local_loss=local_loss, sync_timer=sync_timer)
        losses: list = []

        def recorded(state, images, labels):
            state, loss = step(state, images, labels)
            losses.append(loss)
            return state, loss

        train_set = load_cifar10(args.data_root, train=True)
        test_set = load_cifar10(args.data_root, train=False)
        if train_set.synthetic:
            rank0_print("WARNING: CIFAR-10 not found on disk — using the deterministic "
                        "synthetic stand-in dataset.")
        batch = args.batch_size if args.batch_size is not None else per_rank_batch

        def batches():
            if strategy_name == "none":
                return iter(BatchLoader(train_set, batch))
            return iter(DistributedBatchLoader(train_set, batch, comm.world, comm.rank))

        def place(images, labels):
            return (torch.from_numpy(images).to(device),
                    torch.from_numpy(labels).to(device, torch.long))

        eval_step = make_eval_step(model)
        times: list = []
        for _ in range(args.epochs):
            state, timer = train_epoch(recorded, state, batches(), place_batch=place,
                                       max_iters=args.max_iters,
                                       local_loss_rank=comm.rank if local_loss else None)
            times += timer.times
            eval_batches = iter(BatchLoader(test_set, args.eval_batch_size))
            if args.eval_batches is not None:
                eval_batches = itertools.islice(eval_batches, args.eval_batches)
            evaluate(eval_step, eval_batches, place_batch=place)
        return {"losses": [float(x) for x in losses], "times": times,
                "sync_ms": sync_timer.ms(), "backend": ctx.backend, "wire": comm.wire,
                "device": str(device), "world": comm.world, "state": state, "step": step,
                "place": place, "batches": batches, "ctx": ctx}
    except BaseException:
        ctx.shutdown()
        raise
    finally:
        if shutdown:
            ctx.shutdown()  # dist.destroy_process_group parity (part2/2a/main.py:207)
