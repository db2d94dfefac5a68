"""Autoregressive generation with a KV cache: prefill once, then one token
per decode step.

Counterpart of ``distributed_machine_learning_tpu/inference/generate.py``
(``warp_logits``, ``_sample``, ``make_generate_fn``, ``generate``,
``make_serving_step``).  The reference jits the whole loop; here it is an
eager Python loop over the model, whose decode position is a host int, so
a step syncs with the device only where the EOS early exit must read the
tokens.  Sampling is f32 and draws from an explicit ``torch.Generator``
(its bits differ from ``jax.random``'s: greedy decoding is the
cross-framework contract).  The cache takes the model's
``kv_cache_dtype`` (``init_cache``): an int8 cache serves through the same
loop.  An MoE model (``models/moe.py``) serves through it too: under a
cache its experts route dropless through the grouped path, as the
reference's decode clone does.  :func:`make_tp_generate_fn` runs the same
loop on one rank of a tensor-parallel group over this rank's local-width
model (``parallel/tensor_parallel.py``); speculative decoding is
``inference/speculative.py``.
"""

from __future__ import annotations

from functools import partial

import torch

from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

CACHE_QUANTUM = 512  # cache allocations round up to this (decode-kernel tiling)


def warp_logits(logits: torch.Tensor, temperature: float, top_k: int | None,
                top_p: float | None) -> torch.Tensor:
    """Temperature, then top-k, then top-p (nucleus: the smallest set whose
    tempered probability mass reaches p).  f32 out, masked entries -inf.
    ``temperature`` must be > 0."""
    logits = logits.float() / temperature
    if top_k is not None:
        if top_k > logits.shape[-1]:
            raise ValueError(f"top_k={top_k} exceeds the vocabulary size "
                             f"{logits.shape[-1]}")
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p  # the prefix + the crossing token
        thresh = torch.where(keep_sorted, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, float("-inf"), logits)
    return logits


def _sample(logits: torch.Tensor, generator: torch.Generator | None,
            temperature: float, top_k: int | None,
            top_p: float | None = None) -> torch.Tensor:
    """One token per row: [B, V] → [B] int64.  Greedy (temperature 0) is
    an f32 argmax, before any warping."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def check_serving_form(model, quantize: str | None, name: str = "quantize") -> None:
    """``model`` must be in the serving form ``quantize`` names: its int8
    twin (``ops.quant.quantize_lm``) for "int8", a float model for None."""
    if quantize not in (None, "int8"):
        raise ValueError(f"{name} must be None or 'int8', got {quantize!r}")
    if model.weight_quant != quantize:
        raise ValueError(
            f"{name}={quantize!r} but the model has weight_quant="
            f"{model.weight_quant!r}; pass ops.quant.quantize_lm(model) for int8")


def make_generate_fn(model, max_new_tokens: int, temperature: float = 0.0,
                     top_k: int | None = None, quantize: str | None = None,
                     top_p: float | None = None, eos_id: int | None = None):
    """``fn(prompt [B, Lp] int, generator=None) -> tokens [B, Lp + max_new]``
    with the prompt kept as a prefix.

    ``quantize="int8"`` expects the int8 twin of the model
    (``ops.quant.quantize_lm``; :func:`generate` converts for you).  With
    ``eos_id`` decoding stops as soon as every row has emitted it; rows
    that finish early emit ``eos_id`` for their remaining slots, and their
    earlier tokens equal the ``eos_id=None`` run's."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    check_serving_form(model, quantize)
    sample = partial(_sample, temperature=temperature, top_k=top_k, top_p=top_p)

    @torch.inference_mode()
    def fn(prompt: torch.Tensor, generator: torch.Generator | None = None):
        return _generate_body(model, sample, max_new_tokens, eos_id,
                              prompt.to(device=model.device, dtype=torch.long),
                              generator)

    return fn


def _generate_body(model, sample, max_new_tokens: int, eos_id: int | None,
                   prompt: torch.Tensor, generator) -> torch.Tensor:
    B, Lp = prompt.shape
    max_len = Lp + max_new_tokens
    cache = model.init_cache(B, -(-max_len // CACHE_QUANTUM) * CACHE_QUANTUM)
    logits = model(prompt, cache=cache, start=0, last_only=True)
    tok = sample(logits[:, -1], generator)
    if eos_id is None:
        toks = [tok]
        for i in range(max_new_tokens - 1):
            logits = model(tok[:, None], cache=cache, start=Lp + i)
            tok = sample(logits[:, -1], generator)
            toks.append(tok)
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

    done = tok == eos_id
    buf = torch.full((B, max_new_tokens), eos_id, dtype=torch.long,
                     device=prompt.device)
    buf[:, 0] = tok
    i = 1
    while i < max_new_tokens and not bool(done.all()):
        logits = model(tok[:, None], cache=cache, start=Lp + i - 1)
        nxt = sample(logits[:, -1], generator)
        nxt = torch.where(done, eos_id, nxt)
        done = done | (nxt == eos_id)
        buf[:, i] = nxt
        tok = nxt
        i += 1
    return torch.cat([prompt, buf], dim=1)


def make_tp_generate_fn(model, max_new_tokens: int, comm, temperature: float = 0.0,
                        top_k: int | None = None, quantize: str | None = None,
                        top_p: float | None = None, eos_id: int | None = None):
    """Tensor-parallel generation on this rank of ``comm``: the Megatron
    decode layout (heads, the KV cache and ``d_ff`` ÷ tp; the row-parallel
    projections summed over the ranks), each rank running
    :func:`make_generate_fn`'s loop on its local-width model, with its
    weights sliced from ``model`` (the global model in its serving form:
    the int8 twin for ``quantize="int8"``).  K1, K4 and K6 see local shapes.
    Every rank samples from the same logits; with one generator seed on
    every rank, every rank returns the same tokens."""
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        tp_local_model,
    )

    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    local = tp_local_model(model, comm, quantize)
    return make_generate_fn(local, max_new_tokens, temperature, top_k,
                            quantize=quantize, top_p=top_p, eos_id=eos_id)


def _default_generator(model, generator):
    if generator is not None:
        return generator
    return torch.Generator(device=model.device).manual_seed(0)


def generate(model, prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: int | None = None, generator: torch.Generator | None = None,
             quantize: str | None = None, top_p: float | None = None,
             eos_id: int | None = None) -> torch.Tensor:
    """One-shot wrapper around :func:`make_generate_fn` (a dense or MoE
    model); ``quantize="int8"`` converts a float model with
    ``quantize_lm``."""
    if quantize == "int8":
        model = quantize_lm(model)
    fn = make_generate_fn(model, max_new_tokens, temperature, top_k,
                          quantize=quantize, top_p=top_p, eos_id=eos_id)
    return fn(torch.as_tensor(prompt), _default_generator(model, generator))


def make_serving_step(model, max_new_tokens: int, temperature: float = 0.0,
                      top_k: int | None = None, quantize: str | None = None,
                      top_p: float | None = None,
                      generator: torch.Generator | None = None,
                      eos_id: int | None = None):
    """``step(prompts) -> outputs`` over plain lists of token ids: prompts
    are grouped by length and each group runs as one batched generate
    call; the generator threads through calls."""
    if quantize == "int8":
        model = quantize_lm(model)
    fn = make_generate_fn(model, max_new_tokens, temperature, top_k,
                          quantize=quantize, top_p=top_p, eos_id=eos_id)
    gen = _default_generator(model, generator)

    def step(prompts):
        if any(len(p) == 0 for p in prompts):
            raise ValueError("serving step got an empty prompt")
        outs: list = [None] * len(prompts)
        by_len: dict[int, list[int]] = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)
        for length in sorted(by_len):
            idxs = by_len[length]
            batch = torch.tensor([[int(t) for t in prompts[i]] for i in idxs],
                                 dtype=torch.long)
            tokens = fn(batch, gen).cpu()
            for row, i in zip(tokens.tolist(), idxs):
                outs[i] = [int(t) for t in row]
        return outs

    return step
