"""Text generation entry point of the port: serve a TransformerLM.

Counterpart of ``distributed_machine_learning_tpu/cli/generate.py``: the
weights of a ``cli.lm`` checkpoint (``--ckpt-dir``: the newest valid one,
verified) or random ones from ``--seed`` (``--random-init``), the
byte-level prompt encoding, the sampling flags, ``--compute-dtype``,
``--kv-cache-dtype`` (``int8``: int8 rows plus f32 scales per slot) and
``--quant int8``.  Runs on the GPU unless ``--device cpu`` is given.

Usage::

    python -m distributed_machine_learning_tpu_torch.cli.generate \
        --ckpt-dir ckpts --prompt "The " --max-new-tokens 32 --temperature 0 \
        --d-model 2048 --n-layers 8 --n-heads 16 --n-kv-heads 4 --vocab 32000

The model flags must describe the checkpoint's model.  Pipeline-layout
checkpoints (stacked blocks) are not ported yet (ROADMAP A5c); neither are
``--moe``, ``--tp`` and speculative decoding (ROADMAP A8).
"""

from __future__ import annotations

import argparse

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
)
from distributed_machine_learning_tpu_torch.models.transformer import (
    TransformerLM,
)
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm


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
    p.add_argument("--vocab", default=None, type=int,
                   help="default: byte-level 257")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kv-cache-dtype", dest="kv_cache_dtype", default=None,
                   choices=["int8", "bfloat16", "float32"],
                   help="decode cache storage dtype (default: compute dtype)")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="weight-only int8 serving through the W8A16 kernel")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def restore_lm_params(ckpt_dir: str) -> dict:
    """The parameters of the newest valid checkpoint under ``ckpt_dir``, as
    CPU tensors by state_dict name (its files verified by the fallback
    chain, its leaves by the restore)."""
    from distributed_machine_learning_tpu_torch.train.checkpoint import (
        checkpoint_layout,
        latest_checkpoint,
        restore_checkpoint,
    )

    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    if checkpoint_layout(latest) is not None:
        raise NotImplementedError(
            f"checkpoint {latest} holds a pipeline layout "
            f"({checkpoint_layout(latest)!r}); unstacking it is not ported yet: "
            "ROADMAP A5c")
    params = restore_checkpoint(latest, files_verified=True).params
    print(f"restored {latest}")
    return params


def main(argv=None) -> list[int]:
    """Generate and print; returns the generated token ids."""
    args = make_parser().parse_args(argv)
    if not args.ckpt_dir and not args.random_init:
        raise ValueError("pass --ckpt-dir (a cli.lm checkpoint) or --random-init")
    device = resolve_device(args.device)
    vocab = args.vocab or VOCAB_SIZE
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    kv_dtype = getattr(torch, args.kv_cache_dtype) if args.kv_cache_dtype else None
    model = TransformerLM(vocab_size=vocab, d_model=args.d_model,
                          n_layers=args.n_layers, n_heads=args.n_heads,
                          n_kv_heads=args.n_kv_heads, compute_dtype=dtype,
                          kv_cache_dtype=kv_dtype, device=device)
    if args.ckpt_dir:
        model.load_state_dict(restore_lm_params(args.ckpt_dir))
    else:
        init_params(model, seed=args.seed)
        print("WARNING: --random-init weights (untrained output)")
    # Serving configuration: quantize from the f32 weights, or store the
    # weights in the compute dtype once (decode reads them every step).
    model = quantize_lm(model) if args.quant == "int8" else model.to(dtype)
    model.eval()

    prompt = torch.tensor([encode_prompt(args.prompt, vocab)], dtype=torch.long)
    fn = make_generate_fn(model, args.max_new_tokens,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, quantize=args.quant)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = fn(prompt, gen)[0, prompt.shape[1]:].tolist()
    print(args.prompt + decode_tokens(out, vocab))
    return out


if __name__ == "__main__":
    main()
