"""Language-model training entry point of the port: every ``--parallel``
scheme of the reference.

Counterpart of ``distributed_machine_learning_tpu/cli/lm.py``.  Trains the
decoder-only ``TransformerLM`` on the reference's deterministic synthetic
token stream (``np.random.default_rng(69143)``), or on a byte-level corpus
of every text file under ``--data-dir`` (``data/text.py``; vocab raised to
257): f32 master weights, the compute dtype of ``--compute-dtype``, AdamW
(``--fused-update``: the fused kernel K7), or SGD (``--momentum-dtype``
narrows its buffers) or LARS (``--optimizer``; LARS under dp, ring,
ulysses and tp: the sharded and pipeline schemes refuse it), flash attention with its
backward kernels K2/K3 where ``--attn`` picks flash, and the head fused
with the loss over ``--fused-ce-chunks`` vocab chunks (``ops/fused_ce.py``:
the [B, L, vocab] logits never exist).  The measurement protocol is the
reference's: ``--max-iters`` capped, iteration 0 left out of the timing,
the loss printed every 20 iterations, the total/average summary at the
end.  Runs on the GPU unless ``--device cpu`` is given.

``--num-nodes W`` runs W processes, one per rank (``--rank``,
``--master-ip``), over ``torch.distributed``: nccl when each rank has a
card, gloo through host buffers when ranks share one (or on the CPU).
Every rank draws the same global batch and takes its part:

- ``--parallel dp``: its rows; gradients and loss averaged over the ranks;
- ``--parallel ring``: its sequence chunk of ``--seq-len / W`` tokens, with
  attention as a ring over the ranks: the einsum ring, or the ring flash
  kernels K11-K13 where the reference's upgrade rule picks them
  (``--attn auto``/``flash`` and a chunk the kernels tile);
- ``--parallel ulysses``: its sequence chunk, with two all-to-alls around
  attention over the full sequence on H/W heads (``ops/ulysses.py``; the
  local attention is K1-K3 where ``flash_wins`` holds for the full L:
  "ulysses owns its attention", ``--attn`` does not apply);
- ``--parallel fsdp``: its rows, with parameters and AdamW moments sharded
  1/W on one flat vector (ZeRO-3, ``parallel/fsdp.py``): a step gathers the
  parameters, reduce-scatters the gradients and updates the rank's shard
  (one K7 launch with ``--fused-update``); dense attention only (``auto``
  resolves to dense, explicit ``flash`` is refused).  ``--overlap-update``
  gathers the next step's parameters behind the host's work between steps
  (``parallel/overlap.py``), bit for bit the sync trajectory;
- ``--parallel fsdp_pl``: its rows, with every leaf and its moments split
  1/W along the leaf's largest W-divisible dimension (per-layer ZeRO-3,
  ``parallel/fsdp_perlayer.py``): each layer's leaves are gathered when the
  layer runs and again in its backward, each leaf's gradient
  reduce-scattered to the rank's block, the optimizer run per leaf (one K7
  launch a leaf with ``--fused-update``); ``--attn`` is honoured (K1-K3
  under flash);
- ``--parallel tp``: the whole batch, with its slice of every layer (its
  H/W heads and Hkv/W KV heads, d_ff/W, the embedding's and the head's
  vocabulary; ``parallel/tensor_parallel.py``): Megatron's f/g sums around
  each sub-layer, the vocabulary-parallel loss, the optimizer per local
  leaf; ``--attn`` is honoured;
- ``--parallel pp``: its stage of the layers (the embedding, ``ln_f`` and
  the head whole on every stage), ``--microbatches`` M through the stages
  in the ``--pp-schedule``'s order: ``1f1b`` (the default,
  ``parallel/pipeline_1f1b.py``), ``gpipe`` (``parallel/pipeline.py``;
  ``--overlap-update`` shards the boundary modules' update over the
  stages) or ``interleaved`` (``--pp-chunks`` v chunks a stage,
  ``parallel/pipeline_interleaved.py``); dense attention, or explicit
  ``--attn flash`` (``auto`` resolves to dense, as the reference's);
- ``--parallel 3d --dp D --pp P --tp T``: GPipe over P stages of T-way TP
  layers, each microbatch's rows split over D (``parallel/parallel3d.py``;
  ``--zero1-dp`` keeps the moments 1/D over the data group); dense, or
  explicit ``--attn flash`` (the reference's pipeline blocks resolve
  ``auto`` to dense);
- ``--parallel ep``: the Switch-routed ``MoETransformerLM`` (``--n-experts``,
  ``--capacity-factor``), its experts split over an expert axis of ``--ep``
  ranks (default gcd(W, n_experts)), W / (ep × ``--ep-seq``) ranks a data
  axis (``parallel/expert_parallel.py``, ``models/moe.py``).  ``--moe-impl
  einsum``: each data rank's rows whole on its expert ranks, each computing
  its own experts at the global batch's capacity, the combine summed over
  them; ``--moe-impl grouped``: dropless, the rows split over data × expert
  and sent to their experts' owners by an all-to-all (``--ep-slots`` bounds
  the send slots an owner, dropping the overflow), and with ``--ep-seq S``
  the sequence split over S more ranks with ring attention over them (the
  ring flash kernels K11-K13 where ``_ring_flash_wins`` holds for the
  chunk).  At one rank: the one-device MoE step.

Usage (the repo's d2048 / 8-layer / GQA-4 LM)::

    python -m distributed_machine_learning_tpu_torch.cli.lm --parallel dp \\
        --d-model 2048 --n-layers 8 --n-heads 16 --n-kv-heads 4 --vocab 32000 \\
        --seq-len 4096 --batch-size 4 --compute-dtype bfloat16 \\
        --optimizer adamw --fused-update --attn flash --max-iters 8

    # expert parallelism over 2 ranks: dropless grouped EP, E 8
    for r in 0 1; do python -m distributed_machine_learning_tpu_torch.cli.lm \\
        --parallel ep --moe-impl grouped --num-nodes 2 --rank $r \\
        --master-ip 127.0.0.1:29500 ... & done; wait

    # context parallel over 2 ranks (one process each); ring or ulysses
    for r in 0 1; do python -m distributed_machine_learning_tpu_torch.cli.lm \\
        --parallel ring --num-nodes 2 --rank $r --master-ip 127.0.0.1:29500 \\
        --seq-len 8192 --batch-size 1 ... & done; wait

    # byte-level text with a held-out eval, the head fused with the loss
    python -m distributed_machine_learning_tpu_torch.cli.lm ... \\
        --data-dir distributed_machine_learning_tpu --eval-batches 4 \\
        --fused-ce-chunks 8

    # save after 2 steps, then resume from the newest valid checkpoint
    python -m distributed_machine_learning_tpu_torch.cli.lm ... --max-iters 2 \\
        --ckpt-dir ckpts
    python -m distributed_machine_learning_tpu_torch.cli.lm ... --max-iters 2 \\
        --ckpt-dir ckpts --resume

``--ckpt-dir`` saves the state after training (``train/checkpoint.py``:
rank 0 writes, every rank restores; not under fsdp, as in the reference;
under fsdp_pl, tp and ep every leaf is gathered whole first, so the files
are a dp run's (an ep run's serve with ``cli.generate --moe --ckpt-dir``),
and a resume slices each rank's part out of them; under pp and 3d
the blocks are stacked in the pipeline layout, tagged "pp-contiguous" or
with the interleaved order's tag, which a resume must match and
``cli.generate --ckpt-dir`` unstacks);
``--resume`` first restores the newest valid checkpoint there (this run's
optimizer hyperparameters win, so ``--lr`` may change), ``--resume auto``
also restarts a failed run from it, up to ``--max-restarts`` times.  The
synthetic stream starts from its seed in every process, as the
reference's does.  ``--eval-batches`` evaluates after training: the
held-out final 10 % of the corpus under ``--data-dir``, else synthetic
batches of the next seed; under fsdp, fsdp_pl, tp and ep on the gathered
parameters, under pp and 3d on the gathered and unstacked ones.

Every flag of the reference that this port does not carry yet raises
NotImplementedError naming its ROADMAP item (telemetry).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.cli.common import SEED
from distributed_machine_learning_tpu_torch.data.text import (
    VOCAB_SIZE,
    TextWindowLoader,
    eval_windows,
    load_corpus,
    split_corpus,
)
from distributed_machine_learning_tpu_torch.models.transformer import (
    TransformerLM,
    _ring_flash_wins,
)
from distributed_machine_learning_tpu_torch.ops.flash_attention import _needs_pad
from distributed_machine_learning_tpu_torch.runtime.distributed import (
    DistributedContext,
    initialize_from_flags,
)
from distributed_machine_learning_tpu_torch.train.lm_step import (
    init_lm_state,
    make_lm_eval_step,
    make_lm_train_step,
    shard_lm_batch,
    unwrap_dynamic_scale,
    with_dynamic_scale,
)
from distributed_machine_learning_tpu_torch.train.loop import evaluate_lm, train_epoch
from distributed_machine_learning_tpu_torch.train.optimizers import (
    get_optimizer,
    optimizer_names,
)
from distributed_machine_learning_tpu_torch.utils.logging import rank0_print

PARALLEL = ["dp", "ring", "ulysses", "fsdp", "fsdp_pl", "tp", "pp", "3d", "ep"]

# Flags of the reference CLI that this slice does not carry: (dest, the
# value that means "not asked for", the ROADMAP item).
_NOT_PORTED = [
    ("telemetry_dir", None, "A6 'telemetry'"),
    ("telemetry_flush_every", 20, "A6 'telemetry'"),
]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # Node flags (the reference's add_node_flags).
    p.add_argument("--master-ip", dest="master_ip", default="127.0.1.1:8000")
    p.add_argument("--rank", default=0, type=int)
    p.add_argument("--num-nodes", dest="num_nodes", default=1, type=int,
                   help="processes (ranks), one per rank")
    p.add_argument("--telemetry-dir", dest="telemetry_dir", default=None)
    p.add_argument("--telemetry-flush-every", dest="telemetry_flush_every",
                   default=20, type=int)
    p.add_argument("--parallel", default="dp", choices=PARALLEL,
                   help="dp, fsdp or fsdp_pl (each rank its rows), ring or ulysses "
                        "(each rank its sequence chunk), tp (its heads), pp (its stage), "
                        "3d (data x pipeline x tensor), ep (its experts)")
    p.add_argument("--n-experts", dest="n_experts", default=8, type=int,
                   help="MoE experts (--parallel ep only)")
    p.add_argument("--capacity-factor", dest="capacity_factor", default=1.25,
                   type=float, help="MoE expert capacity factor (ep only)")
    p.add_argument("--ep", default=None, type=int,
                   help="expert-axis size for --parallel ep (default: the greatest "
                        "common divisor of the rank count and --n-experts); the rest "
                        "of the ranks / ep is the data axis")
    p.add_argument("--moe-impl", dest="moe_impl", default="einsum",
                   choices=["einsum", "grouped"],
                   help="--parallel ep's expert compute: 'einsum' (Switch capacity and "
                        "drops, activations whole on every expert rank) or 'grouped' "
                        "(dropless; token rows sent to their experts' owners by an "
                        "all-to-all, the batch split over data x expert)")
    p.add_argument("--ep-slots", dest="ep_slots", default=None, type=int,
                   help="grouped EP's send slots an owner rank (default N_local: "
                        "dropless); fewer bound the all-to-all's bytes and drop the "
                        "overflow rows")
    p.add_argument("--ep-seq", dest="ep_seq", default=1, type=int,
                   help="sequence-axis size for MoE x context parallelism (--parallel "
                        "ep --moe-impl grouped): the sequence split over it, ring "
                        "attention over it")
    p.add_argument("--d-model", dest="d_model", default=256, type=int)
    p.add_argument("--n-layers", dest="n_layers", default=4, type=int)
    p.add_argument("--n-heads", dest="n_heads", default=8, type=int)
    p.add_argument("--n-kv-heads", dest="n_kv_heads", default=None, type=int,
                   help="grouped-query attention: K/V heads (default: MHA)")
    p.add_argument("--vocab", default=256, type=int)
    p.add_argument("--seq-len", dest="seq_len", default=256, type=int)
    p.add_argument("--batch-size", dest="batch_size", default=8, type=int,
                   help="global batch (sequences per step)")
    p.add_argument("--max-iters", dest="max_iters", default=40, type=int)
    p.add_argument("--microbatches", default=2, type=int,
                   help="pipeline microbatches (pp/3d)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", nargs="?", const="latest", default=None,
                   choices=["latest", "auto"])
    p.add_argument("--max-restarts", dest="max_restarts", default=3, type=int)
    p.add_argument("--guard-nonfinite", dest="guard_nonfinite", action="store_true",
                   help="a NaN/Inf gradient skips that update (state unchanged, "
                        "step not counted)")
    p.add_argument("--loss-scale", dest="loss_scale", default="none",
                   choices=["none", "dynamic"],
                   help="'dynamic': dynamic loss scaling (overflow skips the "
                        "update and halves the scale, 200 good steps double it)")
    p.add_argument("--pp-schedule", dest="pp_schedule", default="1f1b",
                   choices=["1f1b", "gpipe", "interleaved"],
                   help="pipeline schedule (pp only): 1f1b (one backward per forward, "
                        "O(P) activations), gpipe (all forwards, then all backwards) or "
                        "interleaved (--pp-chunks virtual stages a rank)")
    p.add_argument("--pp-chunks", dest="pp_chunks", default=None, type=int,
                   help="virtual stages per rank for --pp-schedule interleaved (v, "
                        "default 2); n_layers must divide by ranks x v")
    p.add_argument("--dp", default=None, type=int,
                   help="data-axis size for --parallel 3d (default: ranks // (pp*tp))")
    p.add_argument("--pp", default=2, type=int, help="pipe-axis size for --parallel 3d")
    p.add_argument("--tp", default=2, type=int, help="model-axis size for --parallel 3d")
    p.add_argument("--zero1-dp", dest="zero1_dp", action="store_true",
                   help="with --parallel 3d: the optimizer moments 1/dp over the data "
                        "axis (parallel/parallel3d.py); update-equivalent to plain 3d")
    p.add_argument("--overlap-update", dest="overlap_update", action="store_true",
                   help="with --parallel fsdp: gather the next step's parameters "
                        "behind the host's work between steps (parallel/overlap.py); "
                        "with --parallel pp --pp-schedule gpipe: the boundary modules' "
                        "update sharded over the stages, its gather behind the blocks' "
                        "update")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--optimizer", default="adamw", choices=optimizer_names())
    p.add_argument("--lr", default=None, type=float,
                   help="override the optimizer config's learning rate")
    p.add_argument("--fused-update", dest="fused_update", action="store_true",
                   help="run the AdamW update as the fused kernel K7 (adamw only)")
    p.add_argument("--momentum-dtype", dest="momentum_dtype", default=None,
                   help="SGD momentum-buffer storage dtype (e.g. bfloat16); the update "
                        "math stays f32 (sgd only)")
    p.add_argument("--data-dir", dest="data_dir", default=None,
                   help="train on every text file under this directory as a "
                        "byte-level corpus (data/text.py; vocab raised to 257)")
    p.add_argument("--eval-batches", dest="eval_batches", default=0, type=int,
                   help="after training, the perplexity of this many batches: "
                        "windows of the held-out final 10%% of the corpus under "
                        "--data-dir, else synthetic ones (0 skips)")
    p.add_argument("--fused-ce-chunks", dest="fused_ce_chunks", default=None,
                   type=int, help="the head fused with the loss over this many vocab "
                                  "chunks (ops/fused_ce.py); dp/ring/ulysses/fsdp/"
                                  "fsdp_pl")
    p.add_argument("--attn", default="auto", choices=["auto", "dense", "flash"],
                   help="'auto': flash from the reference's length policy up "
                        "(ops/flash_attention.flash_wins), dense below; ring "
                        "upgrades to its flash kernels by the reference's rule, "
                        "fsdp, pp and 3d resolve 'auto' to dense, fsdp_pl and tp "
                        "honour it, ulysses owns its attention")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing (torch.utils.checkpoint)")
    p.add_argument("--remat-policy", dest="remat_policy", default="mlp",
                   choices=["mlp", "block"],
                   help="with --remat: 'mlp' recomputes only LN2+MLP (attention's "
                        "out and lse stay saved); 'block' the whole block")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def _refuse_unported(args) -> None:
    for dest, default, item in _NOT_PORTED:
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP {item}")


def _check_layout(args) -> None:
    """The reference's checks of the flags against the scheme
    (``cli/lm.py:317-369``) and its divisibility checks (``:370-388``,
    ``:436-440``), made before any rank joins the group."""
    n = args.num_nodes
    if args.momentum_dtype is not None and args.optimizer != "sgd":
        raise ValueError("--momentum-dtype applies to --optimizer sgd only (AdamW keeps "
                         "fp32 moments; LARS accumulates in the buffer dtype and refuses "
                         "narrowing)")
    if args.fused_update and args.optimizer != "adamw":
        raise ValueError("--fused-update applies to --optimizer adamw only (the fused "
                         f"kernel is the AdamW rule; got --optimizer {args.optimizer})")
    if args.pp_chunks is not None and not (args.parallel == "pp"
                                           and args.pp_schedule == "interleaved"):
        raise ValueError("--pp-chunks applies to --parallel pp with --pp-schedule "
                         f"interleaved only (got --parallel {args.parallel}, "
                         f"--pp-schedule {args.pp_schedule})")
    if args.ep_seq != 1 and args.parallel != "ep":
        raise ValueError("--ep-seq (MoE x context parallelism) applies to --parallel "
                         f"ep only (got --parallel {args.parallel})")
    if args.ep_slots is not None and not (args.parallel == "ep"
                                          and args.moe_impl == "grouped"):
        raise ValueError("--ep-slots applies to --parallel ep --moe-impl grouped only "
                         f"(got --parallel {args.parallel}, --moe-impl {args.moe_impl})")
    if args.zero1_dp and args.parallel != "3d":
        raise ValueError("--zero1-dp (ZeRO-1 x 3-D moment sharding) applies to --parallel "
                         f"3d only (got --parallel {args.parallel}); the standalone ZeRO-1 "
                         "scheme is parallel/zero1.py")
    if args.overlap_update and (args.parallel not in ("fsdp", "pp") or (
            args.parallel == "pp" and args.pp_schedule != "gpipe")):
        raise ValueError("--overlap-update applies to --parallel fsdp (prefetch protocol) "
                         "or --parallel pp --pp-schedule gpipe (pipe-sharded boundary "
                         f"update); got --parallel {args.parallel}"
                         + (f" --pp-schedule {args.pp_schedule}" if args.parallel == "pp"
                            else ""))
    if args.fused_ce_chunks and args.parallel not in ("dp", "ring", "ulysses", "fsdp",
                                                      "fsdp_pl"):
        raise ValueError("--fused-ce-chunks applies to the dp/ring/ulysses/fsdp/"
                         "fsdp_pl steps only (tp shards the lm_head, pp computes the "
                         "loss on the last stage)")
    if (args.guard_nonfinite or args.loss_scale == "dynamic") and args.parallel not in (
            "dp", "ring", "ulysses"):
        raise ValueError("--guard-nonfinite/--loss-scale apply to the replicated "
                         f"dp/ring/ulysses steps only (got --parallel {args.parallel})")
    if args.parallel in ("dp", "fsdp", "fsdp_pl") and args.batch_size % n:
        raise ValueError(f"--batch-size {args.batch_size} must be divisible by "
                         f"the {n}-device data axis")
    if args.parallel in ("ring", "ulysses") and args.seq_len % n:
        raise ValueError(f"--seq-len {args.seq_len} must be divisible by the "
                         f"{n}-device sequence axis ({args.parallel} shards the "
                         "sequence)")
    if args.parallel in ("pp", "3d") and args.optimizer == "lars":
        raise ValueError("LARS is not supported under pipeline/3-D parallelism: per-leaf "
                         "weight/grad norms would be computed on per-stage slices; use sgd "
                         "or adamw (elementwise updates are exact on any slice)")
    if args.parallel == "3d":
        from distributed_machine_learning_tpu_torch.parallel.parallel3d import check_3d_mesh

        check_3d_mesh(n, args.dp, args.pp, args.tp)
    if args.parallel == "fsdp" and args.attn == "flash":
        raise ValueError("FSDP LM step requires attn_impl='dense' (sequence-sharded "
                         "attention needs a second mesh axis)")
    if args.ckpt_dir and args.parallel == "fsdp":
        raise ValueError("--ckpt-dir does not support the flat-vector fsdp state "
                         "(FSDPState is not a TrainState); use --parallel fsdp_pl "
                         "for checkpointable ZeRO-3")
    if args.parallel == "ep":
        ep_layout(args)


def ep_layout(args) -> tuple[int, int, int]:
    """``(dp, ep, sp)`` of ``--parallel ep`` over ``--num-nodes`` ranks,
    after the reference's checks (``cli/lm.py:475-565``), in its words."""
    n = args.num_nodes
    if args.n_kv_heads is not None and (args.n_kv_heads < 1
                                        or args.n_heads % args.n_kv_heads):
        raise ValueError(f"--n-kv-heads {args.n_kv_heads} must be a positive divisor of "
                         f"--n-heads {args.n_heads}")
    if args.remat and args.remat_policy != "mlp":
        raise ValueError("--parallel ep supports --remat-policy mlp only (the selective "
                         "LN2+expert-MLP checkpoint); whole-block remat is not wired "
                         "through the MoE blocks")
    if args.n_experts < 1:
        raise ValueError(f"--n-experts must be >= 1, got {args.n_experts}")
    ep = math.gcd(n, args.n_experts) if args.ep is None else args.ep
    if ep < 1 or n % ep:
        raise ValueError(f"--ep {ep} must be a positive divisor of the device count {n}")
    if args.n_experts % ep:
        raise ValueError(f"--n-experts {args.n_experts} must be divisible by --ep {ep}")
    sp = args.ep_seq
    if sp < 1:
        raise ValueError(f"--ep-seq must be >= 1, got {sp}")
    if sp > 1 and args.moe_impl != "grouped":
        raise ValueError("--ep-seq (MoE x context parallelism) requires --moe-impl "
                         "grouped (the manual shard_map step; the GSPMD einsum step has "
                         "no sequence axis)")
    if n % (ep * sp):
        raise ValueError(f"--ep {ep} x --ep-seq {sp} must divide the device count {n}")
    dp = n // (ep * sp)
    if args.batch_size % dp:
        raise ValueError(f"--batch-size {args.batch_size} must be divisible by the {dp}-"
                         "device data axis (devices/(ep*ep_seq))")
    if args.moe_impl == "grouped" and not (n == 1 and sp == 1):
        if args.batch_size % (dp * ep):
            raise ValueError(f"--batch-size {args.batch_size} must be divisible by data "
                             f"x expert = {dp * ep} (the EP-grouped step shards the batch "
                             "over both)")
        if sp > 1 and args.seq_len % sp:
            raise ValueError(f"--seq-len {args.seq_len} must be divisible by --ep-seq {sp}")
    return dp, ep, sp


def optimizer_config(args):
    """The optimizer config the flags describe (``--optimizer``, ``--lr``,
    ``--momentum-dtype`` for sgd, ``--fused-update`` for adamw)."""
    cfg: dict = {}
    if args.lr is not None:
        cfg["learning_rate"] = args.lr
    if args.momentum_dtype is not None:
        cfg["momentum_dtype"] = args.momentum_dtype
    if args.fused_update:
        cfg["fused"] = True
    return get_optimizer(args.optimizer)[0](**cfg)


def attn_impl(args) -> str:
    """The model's attention: ``--attn`` under dp, fsdp_pl, tp and ep (with
    ``--ep-seq`` > 1 the ring, upgraded to ring_flash where ``--attn`` is
    auto or flash and ``_ring_flash_wins`` holds for the chunk, the
    reference's rule at ``cli/lm.py:549-565``); under
    fsdp ``auto`` resolved to dense (its step refuses flash), under pp and 3d
    too (the reference's pipeline blocks run flash only when asked for
    explicitly); ``ulysses`` under ulysses;
    under ring the einsum ring, upgraded to the ring flash kernels as the
    reference decides (``cli/lm.py:394-419``): ``--attn flash`` on any chunk
    the kernels tile natively, ``--attn auto`` where
    ``_ring_flash_wins(chunk)``."""
    if args.parallel == "ulysses":
        return "ulysses"
    if args.parallel in ("fsdp", "pp", "3d") and args.attn == "auto":
        return "dense"
    if args.parallel == "ep" and args.ep_seq > 1:
        chunk = args.seq_len // args.ep_seq
        if args.attn in ("auto", "flash") and _ring_flash_wins(chunk):
            return "ring_flash"
        if args.attn == "flash":
            rank0_print(f"WARNING: per-device chunk {chunk} does not qualify for the flash "
                        "ring kernels — falling back to the einsum ring")
        return "ring"
    if args.parallel != "ring":
        return args.attn
    chunk = args.seq_len // args.num_nodes
    if (args.attn == "flash" and not _needs_pad(chunk)) or (
            args.attn == "auto" and _ring_flash_wins(chunk)):
        return "ring_flash"
    if args.attn == "flash":
        rank0_print(f"WARNING: --attn flash with --parallel ring: per-device chunk "
                    f"{chunk} is not natively tileable (largest power-of-two divisor "
                    "< 128) and the ring kernels have no pad path — falling back to "
                    "the einsum ring")
    return "ring"


def synthetic_tokens(rng: np.random.Generator, batch: int, seq_len: int,
                     vocab: int) -> np.ndarray:
    """[B, L+1] int32 token block; [:, :-1] feeds, [:, 1:] targets (the
    reference's stream, draw for draw)."""
    return rng.integers(0, vocab, (batch, seq_len + 1)).astype(np.int32)


def synthetic_batches(args, seed: int = SEED, count: int | None = None):
    """The ``(tokens, targets)`` host batches of the run (numpy int32)."""
    rng = np.random.default_rng(seed)
    for _ in range(args.max_iters if count is None else count):
        block = synthetic_tokens(rng, args.batch_size, args.seq_len, args.vocab)
        yield block[:, :-1], block[:, 1:]


def build(args, ctx: DistributedContext | None = None):
    """``(step, state, place, model)`` of this rank: the model (f32
    parameters from SEED, the same on every rank), its TrainState (an
    ``FSDPState`` of this rank's shards under fsdp; under fsdp_pl a TrainState
    whose parameters and moments are this rank's blocks), the train step and
    the batch placement (the global host batch → this rank's shard on its
    device).  ``step.params_fn(state)`` gives the full parameters by name
    (under fsdp, fsdp_pl, tp, pp and 3d a gather: every rank must call it).
    Under tp, pp and 3d the state holds this rank's local model (its TP
    slices, its pipeline stage), the returned model is that local model,
    ``step.mesh`` the Comm of each mesh axis and ``step.eval_model`` the
    global model's config on the meta device (the local model carries the
    mesh too, as ``mesh``).  ``ctx``: the rank's process
    group (from :func:`initialize_from_flags`); without one, a one-process
    run."""
    _refuse_unported(args)
    _check_layout(args)
    if ctx is None:
        if args.num_nodes > 1:
            raise ValueError("--num-nodes > 1: join the group first "
                             "(initialize_from_flags) and pass its context")
        ctx = initialize_from_flags(device=args.device)
    comm, device = ctx.comm, ctx.device
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    if args.parallel == "ep":
        return _build_ep(args, comm, device, dtype)
    model = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads, compute_dtype=dtype,
        attn_impl=attn_impl(args), remat=args.remat, remat_policy=args.remat_policy,
        device=device, comm=comm)
    state = init_lm_state(model, seed=SEED, config=optimizer_config(args))
    if args.parallel in ("tp", "pp", "3d"):
        return _build_model_parallel(args, comm, device, model, state)
    if args.parallel == "fsdp_pl":
        from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
            gather_fsdp_pl_params,
            make_fsdp_pl_lm_train_step,
            shard_fsdp_pl_state,
        )

        step = make_fsdp_pl_lm_train_step(model, comm, fused_ce_chunks=args.fused_ce_chunks)
        state = shard_fsdp_pl_state(state, comm)
        step.params_fn = lambda st: gather_fsdp_pl_params(st, comm)
    elif args.parallel == "fsdp":
        from distributed_machine_learning_tpu_torch.parallel.fsdp import (
            gather_fsdp_params,
            make_fsdp_lm_train_step,
            shard_fsdp_state,
        )

        state, unravel, n_elems = shard_fsdp_state(state, comm)
        step = make_fsdp_lm_train_step(model, comm, unravel, n_elems,
                                       fused_ce_chunks=args.fused_ce_chunks,
                                       overlap=args.overlap_update)
        join = getattr(step, "join", lambda st: None)
        step.params_fn = lambda st: gather_fsdp_params(st, unravel, n_elems, comm,
                                                       full=join(st))
    else:
        step = make_lm_train_step(model, comm, guard_nonfinite=args.guard_nonfinite,
                                  dynamic_scale=args.loss_scale == "dynamic",
                                  fused_ce_chunks=args.fused_ce_chunks)
        step.params_fn = lambda st: unwrap_dynamic_scale(st).params
    axis = "seq" if args.parallel in ("ring", "ulysses") else "batch"

    on_device = _to_device(device)

    def place(tokens, targets):
        return on_device(*shard_lm_batch(tokens, targets, comm.rank, comm.world, axis))

    return step, state, place, model


def _to_device(device):
    """Host token batches (numpy) → long tensors on ``device``."""
    def place(tokens, targets):
        return (torch.from_numpy(np.ascontiguousarray(tokens)).to(device, torch.long),
                torch.from_numpy(np.ascontiguousarray(targets)).to(device, torch.long))

    return place


def _build_model_parallel(args, comm, device, model, state):
    """``build``'s tp, pp and 3d branches (the reference's ``cli/lm.py:645-
    739``): each step is built first, so its checks speak before the state is
    laid out."""
    from distributed_machine_learning_tpu_torch.parallel import pipeline as pp

    on_device = _to_device(device)
    eval_model = model.clone(device="meta", attn_impl="dense")
    M = args.microbatches
    if args.parallel == "tp":
        from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
            gather_tp_params,
            make_tp_lm_train_step,
            shard_tp_batch,
            shard_tp_state,
        )

        step = make_tp_lm_train_step(model, comm)
        state = shard_tp_state(state, comm)
        step.mesh = {"model": comm}
        step.params_fn = lambda st: gather_tp_params(st, comm)
        place = lambda x, y: on_device(*shard_tp_batch(x, y))  # noqa: E731
    elif args.parallel == "pp":
        v = (args.pp_chunks or 2) if args.pp_schedule == "interleaved" else 1
        if args.pp_schedule == "1f1b":
            from distributed_machine_learning_tpu_torch.parallel.pipeline_1f1b import (
                make_pp_1f1b_lm_train_step,
            )

            step = make_pp_1f1b_lm_train_step(model, comm, M)
        elif args.pp_schedule == "interleaved":
            from distributed_machine_learning_tpu_torch.parallel.pipeline_interleaved import (
                make_pp_interleaved_lm_train_step,
            )

            step = make_pp_interleaved_lm_train_step(model, comm, M, v)
        else:
            step = pp.make_pp_lm_train_step(model, comm, M, overlap_update=args.overlap_update)
        state = pp.pipeline_state(state, comm, v)
        step.mesh = {"pipe": comm}
        place = lambda x, y: pp.microbatch(*on_device(x, y), M)  # noqa: E731
    else:
        from distributed_machine_learning_tpu_torch.parallel import parallel3d as p3

        mesh = p3.make_3d_mesh(comm, p3.check_3d_mesh(comm.world, args.dp, args.pp, args.tp),
                               args.pp, args.tp)
        step = p3.make_3d_lm_train_step(model, mesh, M, zero1_dp=args.zero1_dp)
        state = p3.shard_3d_state(state, mesh, zero1_dp=args.zero1_dp)
        step.mesh = mesh
        place = lambda x, y: p3.shard_3d_batch(  # noqa: E731
            mesh["batch"], *pp.microbatch(*on_device(x, y), M))
    if args.parallel != "tp":
        def params_fn(st):
            host = gather_state(args, step, st)
            order = pp.layout_order(run_layout(args), args.n_layers)
            return {k: v.to(device) for k, v in
                    pp.unstack_lm_params(host.params, args.n_layers, order).items()}

        step.params_fn = params_fn
    step.eval_model = eval_model
    state.model.mesh = step.mesh
    return step, state, place, state.model


def _build_ep(args, comm, device, dtype):
    """``build``'s ep branch (the reference's ``cli/lm.py:461-604``): the
    mesh's Comms, the model built with them, the seeded state with this
    rank's experts, and the step.  At one rank the one-device MoE step."""
    from distributed_machine_learning_tpu_torch.models.moe import MoETransformerLM
    from distributed_machine_learning_tpu_torch.parallel import expert_parallel as ep_mod
    from distributed_machine_learning_tpu_torch.runtime.distributed import mesh_comms

    dp, ep, sp = ep_layout(args)
    on_device = _to_device(device)
    shape = dict(vocab_size=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
                 n_heads=args.n_heads, n_kv_heads=args.n_kv_heads, remat=args.remat,
                 n_experts=args.n_experts, capacity_factor=args.capacity_factor,
                 compute_dtype=dtype, moe_impl=args.moe_impl)
    if comm.world == 1:
        model = MoETransformerLM(**shape, attn_impl=attn_impl(args), device=device)
        state = ep_mod.init_moe_state(model, seed=SEED, config=optimizer_config(args))
        step = ep_mod.make_ep_train_step(model)
        step.params_fn = lambda st: st.params
        return step, state, on_device, model
    grouped = args.moe_impl == "grouped"
    axes = {"batch": dp, "expert": ep, **({"seq": sp} if sp > 1 else {})}
    mesh = mesh_comms(comm, axes)
    seq = "seq" if sp > 1 else None
    model = MoETransformerLM(
        **shape, attn_impl=attn_impl(args), device=device, comm=mesh.get("seq"),
        expert_comm=mesh["expert"],
        token_comms=tuple(mesh.values()) if grouped else (mesh["batch"],),
        ep_slots_per_owner=args.ep_slots)
    if grouped:
        step = ep_mod.make_ep_grouped_train_step(model, mesh, comm, seq_axis=seq)
    else:
        step = ep_mod.make_ep_train_step(model, mesh)
    state = ep_mod.init_moe_state(model, seed=SEED, config=optimizer_config(args))
    ep_mod.shard_ep_state(state, mesh["expert"])
    step.mesh = mesh
    step.params_fn = lambda st: ep_mod.gather_ep_params(st, mesh["expert"])
    step.eval_model = MoETransformerLM(**shape, attn_impl="dense", device="meta")
    model.mesh = mesh
    place = lambda x, y: on_device(*ep_mod.shard_ep_batch(  # noqa: E731
        x, y, mesh, grouped, seq))
    return step, state, place, model


def run_layout(args) -> str | None:
    """The parameter layout tag a run saves and must resume from (the
    reference's ``cli/lm.py:870-885``)."""
    if args.parallel == "pp" and args.pp_schedule == "interleaved":
        from distributed_machine_learning_tpu_torch.parallel.pipeline_interleaved import (
            interleaved_layout_tag,
        )

        return interleaved_layout_tag(args.num_nodes, args.pp_chunks or 2)
    return "pp-contiguous" if args.parallel in ("pp", "3d") else None


def gather_state(args, step, state):
    """The whole state a tp, pp or 3d run saves, as a ``HostState`` (tp: a
    dp run's leaves; pp and 3d: the pipeline layout).  Every rank must call
    it."""
    mesh = step.mesh
    if args.parallel == "tp":
        from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
            gather_tp_state,
        )

        return gather_tp_state(state, mesh["model"])
    from distributed_machine_learning_tpu_torch.parallel.pipeline import gather_pipeline_state

    return gather_pipeline_state(state, mesh["pipe"], mesh.get("model"), mesh.get("batch"))


def load_data(args):
    """``(corpus, eval_corpus)`` under ``--data-dir`` (both None without it),
    as the reference's main loads them (``cli/lm.py:773-817``): every text
    file under the directory as bytes; ``--vocab`` raised to 257 when
    smaller; with ``--eval-batches`` the final 10 % held out (the whole
    corpus for both, with a warning, when it is too small to split)."""
    if args.data_dir is None:
        return None, None
    corpus = load_corpus(args.data_dir)
    if args.vocab < VOCAB_SIZE:
        rank0_print(f"--data-dir is byte-level: vocab {args.vocab} -> {VOCAB_SIZE} "
                    "(256 bytes + BOS)")
        args.vocab = VOCAB_SIZE
    if not args.eval_batches:
        rank0_print(f"corpus: {len(corpus)} tokens from {args.data_dir}")
        return corpus, None
    corpus, eval_corpus = split_corpus(corpus, eval_frac=0.1,
                                       min_eval_tokens=args.seq_len + 1)
    if len(eval_corpus) == len(corpus):
        # The documented degrade path: training-set perplexity must not pass
        # for held-out perplexity.
        rank0_print("WARNING: corpus too small to hold out an eval slice — eval will "
                    "run on in-distribution training windows")
        rank0_print(f"corpus: {len(corpus)} tokens from {args.data_dir}")
    else:
        rank0_print(f"corpus: {len(corpus)} train tokens from {args.data_dir}, "
                    f"{len(eval_corpus)} held-out eval tokens")
    return corpus, eval_corpus


def resume(args, state):
    """``state`` from the newest valid checkpoint under ``--ckpt-dir``
    (restored into its tensors in place), or unchanged when there is none.
    Refuses a checkpoint of another parameter layout (:func:`run_layout`)
    or optimizer; this run's optimizer config wins over the saved one.
    Under tp, pp and 3d the local model carries its ``mesh`` (``build``)."""
    from distributed_machine_learning_tpu_torch.train.checkpoint import (
        checkpoint_config,
        checkpoint_layout,
        latest_checkpoint,
        restore_checkpoint,
    )

    if not args.ckpt_dir:
        raise ValueError("--resume requires --ckpt-dir")
    latest = latest_checkpoint(args.ckpt_dir)
    if latest is None:
        rank0_print(f"No checkpoint under {args.ckpt_dir}; starting from scratch.")
        return state
    saved_layout, layout = checkpoint_layout(latest), run_layout(args)
    # A checkpoint without a tag is a plain (per-layer) one, which a
    # contiguous pipeline stacks on load, as the reference's pre-tag rule.
    if not (saved_layout == layout or (saved_layout is None
                                       and layout in (None, "pp-contiguous"))):
        raise ValueError(f"checkpoint parameter layout {saved_layout!r} does not match "
                         f"this run's {layout!r} (same tree structure, permuted layers — "
                         "resume with the schedule/chunks/device-count it was saved under)")
    saved_cfg = checkpoint_config(latest)
    if type(saved_cfg) is not type(state.config):
        raise ValueError(f"checkpoint was trained with {type(saved_cfg).__name__} but "
                         f"this run uses --optimizer {args.optimizer}; the LM resume path "
                         "requires a matching optimizer")
    config = state.config
    if args.parallel == "fsdp_pl":  # a dp-layout checkpoint: this rank's blocks of it
        from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
            load_fsdp_pl_state,
        )

        state = load_fsdp_pl_state(state, restore_checkpoint(latest, files_verified=True))
    elif args.parallel == "tp":
        from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
            load_tp_state,
        )

        state = load_tp_state(state, restore_checkpoint(latest, files_verified=True),
                              state.model.mesh["model"])
    elif args.parallel == "ep" and hasattr(state.model, "mesh"):
        from distributed_machine_learning_tpu_torch.parallel.expert_parallel import (
            load_ep_state,
        )

        state = load_ep_state(state, restore_checkpoint(latest, files_verified=True),
                              state.model.mesh["expert"])
    elif args.parallel in ("pp", "3d"):
        from distributed_machine_learning_tpu_torch.parallel.pipeline import (
            load_pipeline_state,
        )

        mesh = state.model.mesh
        state = load_pipeline_state(state, restore_checkpoint(latest, files_verified=True),
                                    mesh["pipe"], mesh.get("model"), layout, mesh.get("batch"))
    else:
        state = restore_checkpoint(latest, state, files_verified=True)
    state.config = config
    rank0_print(f"Resumed from {latest} (step {state.step})")
    return state


def run(args, ctx: DistributedContext):
    """Train this rank as ``main`` does, after the group is up; returns the
    final state (saved under ``--ckpt-dir`` when given)."""
    corpus, eval_corpus = load_data(args)
    step, state, place, model = build(args, ctx)
    mesh = getattr(step, "mesh", None)
    shape = ("" if mesh is None else " mesh=" + "x".join(f"{k}{c.world}" for k, c in
                                                         mesh.items()))
    if args.parallel == "pp":
        shape += f" schedule={args.pp_schedule} microbatches={args.microbatches}"
    elif args.parallel == "3d":
        shape += f" microbatches={args.microbatches}" + (" zero1_dp" if args.zero1_dp else "")
    rank0_print(f"lm parallel={args.parallel} devices={ctx.num_nodes} ({model.device}) "
                f"d_model={args.d_model} layers={args.n_layers} "
                f"seq_len={args.seq_len} batch={args.batch_size} "
                f"attn={model.attn_impl}{shape} backend={ctx.backend or 'none'} "
                f"wire={ctx.comm.wire}")
    # One stream for the whole run, as the reference's: a restart within the
    # process continues it; a new process starts it from its seed.
    rng = np.random.default_rng(SEED)

    def batches():
        if corpus is not None:
            # Every rank draws the same full global batch from the seed and
            # place() shards it, as on the synthetic path.
            yield from TextWindowLoader(corpus, args.batch_size, args.seq_len, seed=SEED)
            return
        for _ in range(args.max_iters):
            block = synthetic_tokens(rng, args.batch_size, args.seq_len, args.vocab)
            yield block[:, :-1], block[:, 1:]

    if args.resume:
        state = resume(args, state)

    def run_once(s):
        """Train, then save: the unit a supervised restart retries."""
        if args.loss_scale == "dynamic":
            s = with_dynamic_scale(s)
        s, _ = train_epoch(step, s, batches(), place_batch=place, max_iters=args.max_iters)
        s = unwrap_dynamic_scale(s)
        if args.ckpt_dir:
            from distributed_machine_learning_tpu_torch.train.checkpoint import (
                save_checkpoint,
            )

            if args.parallel == "fsdp_pl":  # every leaf whole: a dp run's files
                from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
                    gather_fsdp_pl_state,
                )

                path = save_checkpoint(args.ckpt_dir, gather_fsdp_pl_state(s, ctx.comm))
            elif args.parallel in ("tp", "pp", "3d"):
                path = save_checkpoint(args.ckpt_dir, gather_state(args, step, s),
                                       layout=run_layout(args))
            elif args.parallel == "ep" and hasattr(step, "mesh"):  # experts gathered
                from distributed_machine_learning_tpu_torch.parallel.expert_parallel import (
                    gather_ep_state,
                )

                path = save_checkpoint(args.ckpt_dir, gather_ep_state(s, step.mesh["expert"]))
            else:
                path = save_checkpoint(args.ckpt_dir, s)
            rank0_print(f"Saved checkpoint to {path}")
        return s

    try:
        if args.resume == "auto":
            # On any failure: a fresh state, restored from the newest valid
            # checkpoint (or none), trained again, up to --max-restarts times.
            from distributed_machine_learning_tpu_torch.runtime.supervisor import (
                run_attempts,
            )

            def attempt(restart_idx):
                nonlocal step, place, model
                s = state
                if restart_idx > 0:
                    step, fresh, place, model = build(args, ctx)
                    s = resume(args, fresh)
                return run_once(s)

            state = run_attempts(attempt, max_restarts=args.max_restarts)
        else:
            state = run_once(state)
        if args.eval_batches:
            # Every rank evaluates the whole held-out batches on its own
            # (dense, one program: the reference's eval); rank 0 prints.
            dev = ctx.device
            held_out = (eval_windows(eval_corpus, args.batch_size, args.seq_len,
                                     args.eval_batches) if corpus is not None
                        else synthetic_batches(args, SEED + 1, args.eval_batches))
            held_out = ((torch.from_numpy(x).to(dev, torch.long),
                         torch.from_numpy(y).to(dev, torch.long)) for x, y in held_out)
            evaluate_lm(make_lm_eval_step(getattr(step, "eval_model", model)),
                        step.params_fn(state), held_out)
    finally:
        if getattr(step, "overlap", False):
            # No gather may be in flight when the group shuts down.
            step.join(state)
            step.close()
    return state


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    # Refuse before joining the group, so a refusal never waits for peers.
    _refuse_unported(args)
    _check_layout(args)
    ctx = initialize_from_flags(args.master_ip, args.rank, args.num_nodes, device=args.device)
    try:
        run(args, ctx)
    finally:
        ctx.shutdown()


if __name__ == "__main__":
    main()
