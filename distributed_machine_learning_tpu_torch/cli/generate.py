"""Text generation entry point of the port: serve a TransformerLM.

Counterpart of ``distributed_machine_learning_tpu/cli/generate.py``: the
weights of a ``cli.lm`` checkpoint (``--ckpt-dir``: the newest valid one,
verified) or random ones from ``--seed`` (``--random-init``), the
byte-level prompt encoding, the sampling flags, ``--compute-dtype``,
``--kv-cache-dtype`` (``int8``: int8 rows plus f32 scales per slot),
``--quant int8``, a routed-expert target (``--moe``, ``--n-experts``,
``--capacity-factor``, ``--moe-impl``; decode routes dropless), speculative
decoding (``--spec-gamma`` draft tokens a verify round, the draft from
``--draft-ckpt-dir`` or random from seed 11, its shape from ``--draft-*``,
defaulting to the target's) and tensor-parallel decode (``--tp N``: N
ranks, one process each, started here; the target sharded, the draft
whole on every rank).  All of them compose, with the reference's defaults
and guards.  Runs on the GPU unless ``--device cpu`` is given.

Usage::

    python -m distributed_machine_learning_tpu_torch.cli.generate \
        --ckpt-dir ckpts --prompt "The " --max-new-tokens 32 --temperature 0 \
        --d-model 2048 --n-layers 8 --n-heads 16 --n-kv-heads 4 --vocab 32000 \
        [--draft-ckpt-dir draft --draft-d-model 512 --draft-n-layers 2 \
         --draft-n-heads 16 --draft-n-kv-heads 4 --spec-gamma 4] [--tp 2]

The model flags must describe the checkpoint's model.  ``--tp N`` takes
the ranks' backend from where they run (``runtime/distributed``: nccl with
a card a rank, gloo when ranks share a card or run on the CPU), so unlike
the reference it needs no N devices; rank 0's tokens are printed, and every
rank must return the same.  A pipeline-layout checkpoint (``cli.lm
--parallel pp`` or ``3d``: stacked blocks, tagged contiguous or interleaved)
is unstacked on restore.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from distributed_machine_learning_tpu_torch import resolve_device
from distributed_machine_learning_tpu_torch.convert import init_params
from distributed_machine_learning_tpu_torch.data.text import (
    VOCAB_SIZE,
    decode_tokens,
    encode_prompt,
)
from distributed_machine_learning_tpu_torch.inference.generate import (
    make_generate_fn,
    make_tp_generate_fn,
)
from distributed_machine_learning_tpu_torch.inference.speculative import (
    make_speculative_generate_fn,
    make_tp_speculative_generate_fn,
)
from distributed_machine_learning_tpu_torch.models.moe import MoETransformerLM
from distributed_machine_learning_tpu_torch.models.transformer import (
    TransformerLM,
)
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

DRAFT_SEED = 11  # the reference's random-init draft seed


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", default=None,
                   help="serve the newest valid cli.lm checkpoint under this directory")
    p.add_argument("--random-init", action="store_true",
                   help="serve freshly initialized weights (from --seed)")
    p.add_argument("--prompt", default="The ")
    p.add_argument("--max-new-tokens", dest="max_new_tokens", default=128,
                   type=int)
    p.add_argument("--temperature", default=1.0, type=float,
                   help="0 = greedy decoding")
    p.add_argument("--top-k", dest="top_k", default=None, type=int)
    p.add_argument("--top-p", dest="top_p", default=None, type=float,
                   help="nucleus sampling over the tempered distribution "
                        "(temperature, then top-k, then top-p)")
    p.add_argument("--seed", default=0, type=int,
                   help="seeds the random weights and the sampler")
    p.add_argument("--d-model", dest="d_model", default=256, type=int)
    p.add_argument("--n-layers", dest="n_layers", default=4, type=int)
    p.add_argument("--n-heads", dest="n_heads", default=8, type=int)
    p.add_argument("--n-kv-heads", dest="n_kv_heads", default=None, type=int)
    p.add_argument("--moe", action="store_true",
                   help="serve a Switch-MoE model: per-token routing inside the "
                        "cached decode loop; pair with --n-experts etc.")
    p.add_argument("--n-experts", dest="n_experts", default=8, type=int)
    p.add_argument("--capacity-factor", dest="capacity_factor", default=1.25,
                   type=float)
    p.add_argument("--moe-impl", dest="moe_impl", default="einsum",
                   choices=["einsum", "grouped"])
    p.add_argument("--vocab", default=None, type=int,
                   help="default: byte-level 257")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kv-cache-dtype", dest="kv_cache_dtype", default=None,
                   choices=["int8", "bfloat16", "float32"],
                   help="decode cache storage dtype (default: compute dtype)")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="weight-only int8 serving through the W8A16 kernel")
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel decode over this many ranks (one "
                        "process each: heads, d_ff and the KV cache sharded; "
                        "composes with --quant int8, --moe and --spec-gamma)")
    p.add_argument("--spec-gamma", dest="spec_gamma", default=0, type=int,
                   help="speculative decoding with this many draft tokens a "
                        "verify round (0 = off); the draft defaults to the "
                        "target's architecture at random init unless the "
                        "--draft-* flags say otherwise")
    p.add_argument("--draft-ckpt-dir", dest="draft_ckpt_dir", default=None,
                   help="cli.lm checkpoint of the draft; absent: a random-init "
                        "draft (exact output, poor acceptance)")
    p.add_argument("--draft-d-model", dest="draft_d_model", default=None, type=int,
                   help="draft architecture (defaults mirror the target's flags)")
    p.add_argument("--draft-n-layers", dest="draft_n_layers", default=None, type=int)
    p.add_argument("--draft-n-heads", dest="draft_n_heads", default=None, type=int)
    p.add_argument("--draft-n-kv-heads", dest="draft_n_kv_heads", default=None,
                   type=int)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def restore_lm_params(ckpt_dir: str, say=print) -> dict:
    """The parameters of the newest valid checkpoint under ``ckpt_dir``, as
    CPU tensors by state_dict name (its files verified by the fallback
    chain, its leaves by the restore): the one restore path of the target
    and the draft.  A pipeline-layout checkpoint (``cli.lm --parallel pp``
    or ``3d``) is unstacked into per-layer leaves in the order its layout
    tag names, contiguous or interleaved, as the reference's
    ``_restore_lm_params`` does."""
    from distributed_machine_learning_tpu_torch.parallel.pipeline import (
        layout_order,
        unstack_lm_params,
    )
    from distributed_machine_learning_tpu_torch.train.checkpoint import (
        checkpoint_layout,
        latest_checkpoint,
        restore_checkpoint,
    )

    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    params = restore_checkpoint(latest, files_verified=True).params
    stacked = [t for name, t in params.items() if name.startswith("blocks.")
               and not name.split(".")[1].isdigit()]
    if stacked:
        n_layers = stacked[0].shape[0]
        params = unstack_lm_params(params, n_layers,
                                   layout_order(checkpoint_layout(latest), n_layers))
    say(f"restored {latest}")
    return params


def target_model(args, device):
    """The target of ``args``' flags on ``device``, weights not filled."""
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    shape = dict(vocab_size=args.vocab or VOCAB_SIZE, d_model=args.d_model,
                 n_layers=args.n_layers, n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
                 compute_dtype=dtype, device=device,
                 kv_cache_dtype=getattr(torch, args.kv_cache_dtype) if args.kv_cache_dtype
                 else None)
    if args.moe:
        return MoETransformerLM(**shape, n_experts=args.n_experts,
                                capacity_factor=args.capacity_factor,
                                moe_impl=args.moe_impl)
    return TransformerLM(**shape)


def serving_models(args, device, say=print):
    """The target in its serving form (the int8 twin under ``--quant int8``,
    else its weights stored in the compute dtype) and, under
    ``--spec-gamma``, the draft (compute dtype, sharing ``--kv-cache-dtype``),
    both on ``device``."""
    vocab = args.vocab or VOCAB_SIZE
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    kv_dtype = getattr(torch, args.kv_cache_dtype) if args.kv_cache_dtype else None
    model = target_model(args, device)
    if args.ckpt_dir:
        model.load_state_dict(restore_lm_params(args.ckpt_dir, say))
    else:
        init_params(model, seed=args.seed)
        say("WARNING: --random-init weights (untrained output)")
    # Serving configuration: quantize from the f32 weights, or store the
    # weights in the compute dtype once (decode reads them every step).
    model = quantize_lm(model) if args.quant == "int8" else model.to(dtype)
    draft = None
    if args.spec_gamma > 0:
        # A plain dense LM even for an MoE target: it only proposes.
        draft = TransformerLM(
            vocab_size=vocab, d_model=args.draft_d_model or args.d_model,
            n_layers=args.draft_n_layers or args.n_layers,
            n_heads=args.draft_n_heads or args.n_heads,
            n_kv_heads=(args.draft_n_kv_heads if args.draft_n_kv_heads is not None
                        else args.n_kv_heads),
            compute_dtype=dtype, kv_cache_dtype=kv_dtype, device=device)
        if args.draft_ckpt_dir:
            draft.load_state_dict(restore_lm_params(args.draft_ckpt_dir, say))
        else:
            init_params(draft, seed=DRAFT_SEED)
            say("WARNING: random-init draft (exact output, poor acceptance)")
        draft = draft.to(dtype).eval()
    return model.eval(), draft


def generate_tokens(args, device, comm=None, say=print, timing: dict | None = None
                    ) -> list[int]:
    """The generated token ids of ``args``' request on ``device``; with
    ``comm``, as one rank of a ``--tp`` group.  ``timing`` receives the
    request's host seconds (prompt to the last token) as ``"seconds"``."""
    model, draft = serving_models(args, device, say)
    kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
              quantize=args.quant)
    if draft is not None and comm is not None:
        fn = make_tp_speculative_generate_fn(model, draft, args.max_new_tokens, comm,
                                             gamma=args.spec_gamma, **kw)
    elif draft is not None:
        fn = make_speculative_generate_fn(model, draft, args.max_new_tokens,
                                          gamma=args.spec_gamma, **kw)
    elif comm is not None:
        fn = make_tp_generate_fn(model, args.max_new_tokens, comm, **kw)
    else:
        fn = make_generate_fn(model, args.max_new_tokens, **kw)
    del model  # a --tp rank keeps only its local slice
    vocab = args.vocab or VOCAB_SIZE
    prompt = torch.tensor([encode_prompt(args.prompt, vocab)], dtype=torch.long)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = fn(prompt, gen)[0, prompt.shape[1]:].tolist()  # .tolist() waits for the card
    if timing is not None:
        timing["seconds"] = time.perf_counter() - t0
    if draft is not None:
        st = fn.stats
        say(f"speculative: {st['rounds']} rounds, {st['accepted']} draft tokens accepted "
            f"({st['accepted'] / st['rounds']:.2f} a round, gamma {args.spec_gamma})")
    return out


def _tp_rank(rank: int, world: int, init_method: str, args) -> dict:
    """One ``--tp`` rank: join the group, serve, report."""
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    ctx = initialize_from_flags(rank=rank, num_nodes=world, device=args.device,
                                init_method=init_method)
    try:
        build.reset_launch_counts()
        say = print if rank == 0 else (lambda *a: None)
        timing: dict = {}
        tokens = generate_tokens(args, ctx.device, ctx.comm, say, timing)
        launches = {k: n for k, n in build.launches.items() if n}
        return dict(tokens=tokens, launches=launches, backend=ctx.backend,
                    wire=ctx.comm.wire, seconds=timing["seconds"])
    finally:
        ctx.shutdown()


def main(argv=None) -> list[int]:
    """Generate and print; returns the generated token ids."""
    args = make_parser().parse_args(argv)
    if not args.ckpt_dir and not args.random_init:
        raise ValueError("pass --ckpt-dir (a cli.lm checkpoint) or --random-init")
    if args.tp < 1:
        raise ValueError(f"--tp must be >= 1, got {args.tp}")
    if args.tp > 1:
        from distributed_machine_learning_tpu_torch.runtime.launch import spawn

        from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
            check_tp_layout,
        )

        resolve_device(args.device)  # both refuse before any rank starts
        check_tp_layout(target_model(args, "meta"), args.tp)
        ranks = spawn(_tp_rank, args.tp, (args,))
        print(f"tp={args.tp} backend={ranks[0]['backend']} wire={ranks[0]['wire']}")
        print("tp rank kernel launches: "
              + json.dumps([r["launches"] for r in ranks], sort_keys=True))
        print("tp rank request seconds: " + json.dumps([round(r["seconds"], 4) for r in ranks]))
        out = ranks[0]["tokens"]
        if any(r["tokens"] != out for r in ranks):
            raise RuntimeError("tensor-parallel ranks returned different tokens: "
                               f"{[r['tokens'] for r in ranks]}")
    else:
        out = generate_tokens(args, resolve_device(args.device))
    print(args.prompt + decode_tokens(out, args.vocab or VOCAB_SIZE))
    return out


if __name__ == "__main__":
    main()
