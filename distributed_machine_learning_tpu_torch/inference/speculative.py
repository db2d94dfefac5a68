"""Speculative decoding: a draft proposes, the target verifies.

Counterpart of ``distributed_machine_learning_tpu/inference/speculative.py``
(``sampled_acceptance``, ``make_speculative_generate_fn``,
``make_tp_speculative_generate_fn`` and the body they share).  Each round
the draft runs γ+1 one-token steps (the last processes its own final
proposal, which keeps its cache one token behind the committed stream),
and the target verifies ``[cur, d_0..d_{γ-1}]`` in one multi-token
continuation pass against its cache.  The rule keeps the output
distribution the target's:

- greedy (temperature 0): accept the longest prefix where the draft's
  token equals the target's argmax, then emit the target's argmax at the
  first mismatch (or the bonus token when all γ survive).  The stream is
  the target-only greedy stream under matched numerics (f32, as the tests
  pin it).  In bf16 the reference documents one caveat, which holds here
  too: where the top-2 logits are within one bf16 ulp, the γ+1-token
  verify pass and the one-token decode step may break the tie differently;
- sampled: accept ``d_i`` with probability ``min(1, p_i(d_i)/q_i(d_i))``
  (both warped by temperature, top-k and top-p); on rejection sample from
  ``norm(max(p_i − q_i, 0))``, on full acceptance the bonus from ``p_γ``
  (:func:`sampled_acceptance`).  Draws come from one ``torch.Generator``.

Rollback is moving the frontier: slots past it are masked and overwritten
by the next write.  Both caches share one frontier (they advance by γ+1
and rewind by the same count).  At batch 1 the frontier is a host int, so
the draft's decode steps take K4 at a qualifying allocation, and the
round's one device sync reads the accepted count.  At B > 1 each row keeps
its own frontier (a [B] tensor: per-row cache writes, positions and masks,
the einsum), rows that reach ``max_new_tokens`` freeze and ride along,
and the round's one sync is the loop's condition.  The output buffer keeps
the reference's slack, ``max_new + (γ+1)·(2 if batched else 1)``, and the
cache allocation rounds ``prompt + budget + 1`` up to 512 slots, so the
allocation (and K4's qualification) is the reference's.
"""

from __future__ import annotations

from functools import partial

import torch

from distributed_machine_learning_tpu_torch.inference.generate import (
    CACHE_QUANTUM,
    check_serving_form,
    warp_logits,
)


def sampled_acceptance(d: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                       u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Leviathan accept/reject-residual rule, per row.

    ``d`` [B, γ] draft proposals; ``q`` [B, γ, V] draft and ``p`` [B, γ+1,
    V] target probabilities (both warped); ``u`` [B, γ] uniforms.  Returns
    ``(n_acc, resid)``: ``n_acc[b]`` the length of row b's accepted prefix
    (accept d_i iff u_i·q_i(d_i) < p_i(d_i)), and ``resid[b]`` the [V]
    distribution the correction token samples from: ``norm(max(p_i − q_i,
    0))`` at the first rejection i, or ``p_γ`` on full acceptance."""
    gamma = d.shape[1]
    V = p.shape[-1]
    p_d = p[:, :gamma].gather(2, d[..., None])[..., 0]
    q_d = q.gather(2, d[..., None])[..., 0]
    acc = u * q_d < p_d
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    p_row = p.gather(1, n_acc[:, None, None].expand(-1, 1, V))[:, 0]
    q_at = torch.clamp(n_acc, max=gamma - 1)[:, None, None].expand(-1, 1, V)
    q_row = torch.where((n_acc < gamma)[:, None], q.gather(1, q_at)[:, 0],
                        torch.zeros_like(p_row))
    resid = torch.clamp(p_row - q_row, min=0.0)
    resid = resid / torch.clamp(resid.sum(dim=-1, keepdim=True), min=1e-30)
    return n_acc, resid


def _validate_speculative_args(target_model, draft_model, max_new_tokens: int,
                               gamma: int, quantize, draft_quantize) -> None:
    """The speculative factories' shared contract (the reference's)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if target_model.vocab_size != draft_model.vocab_size:
        raise ValueError(
            f"target and draft must share a vocabulary (got "
            f"{target_model.vocab_size} vs {draft_model.vocab_size})")
    for name, q in (("quantize", quantize), ("draft_quantize", draft_quantize)):
        if q not in (None, "int8"):
            raise ValueError(f"{name} must be None or 'int8', got {q!r}")


def make_speculative_generate_fn(target_model, draft_model, max_new_tokens: int,
                                 gamma: int = 4, temperature: float = 0.0,
                                 top_k: int | None = None, top_p: float | None = None,
                                 quantize: str | None = None,
                                 draft_quantize: str | None = None):
    """``fn(prompt [B, Lp] int, generator=None) -> tokens [B, Lp + max_new]``.

    Rows share the prompt length, not its content.  ``quantize`` /
    ``draft_quantize`` ``"int8"`` expect that model's int8 twin
    (``ops.quant.quantize_lm``), as ``make_generate_fn`` does.  Each row's
    stream follows the target's sampling distribution (greedy: the target's
    greedy stream).  After a call, ``fn.stats`` holds ``rounds`` (verify
    passes), ``accepted`` (draft tokens accepted, over live rows) and
    ``rows``."""
    _validate_speculative_args(target_model, draft_model, max_new_tokens, gamma,
                               quantize, draft_quantize)
    check_serving_form(target_model, quantize)
    check_serving_form(draft_model, draft_quantize, "draft_quantize")
    body = partial(_speculative_body, target_model, draft_model, max_new_tokens,
                   gamma, temperature, top_k, top_p)

    @torch.inference_mode()
    def fn(prompt: torch.Tensor, generator: torch.Generator | None = None):
        prompt = prompt.to(device=target_model.device, dtype=torch.long)
        return body(prompt, generator, fn.stats)

    fn.stats = {}
    return fn


def make_tp_speculative_generate_fn(target_model, draft_model, max_new_tokens: int,
                                    comm, gamma: int = 4, temperature: float = 0.0,
                                    top_k: int | None = None,
                                    top_p: float | None = None,
                                    quantize: str | None = None,
                                    draft_quantize: str | None = None):
    """Speculative decoding with a tensor-parallel target, on this rank of
    ``comm``: the target at its local width (the Megatron decode layout of
    ``inference.generate.make_tp_generate_fn``; this rank's weights sliced
    from ``target_model``), the draft whole on every rank.  Every rank runs
    the same rounds on the same generator seed, so every rank returns the
    same tokens."""
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        tp_local_model,
    )

    _validate_speculative_args(target_model, draft_model, max_new_tokens, gamma,
                               quantize, draft_quantize)
    local = tp_local_model(target_model, comm, quantize)
    return make_speculative_generate_fn(local, draft_model, max_new_tokens, gamma,
                                        temperature, top_k, top_p, quantize,
                                        draft_quantize)


def _speculative_body(tm, dm, max_new_tokens: int, gamma: int, temperature: float,
                      top_k, top_p, prompt: torch.Tensor, generator,
                      stats: dict) -> torch.Tensor:
    greedy = temperature == 0.0
    warp = partial(warp_logits, temperature=temperature, top_k=top_k, top_p=top_p)

    def pick(logits):  # one token a row, and (sampled) its warped distribution
        if greedy:
            return torch.argmax(logits.float(), dim=-1), None
        probs = torch.softmax(warp(logits), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0], probs

    B, Lp = prompt.shape
    dev = prompt.device
    batched = B > 1
    budget = max_new_tokens + (gamma + 1) * (2 if batched else 1)
    cache_len = -(-(Lp + budget + 1) // CACHE_QUANTUM) * CACHE_QUANTUM
    tcache, dcache = tm.init_cache(B, cache_len), dm.init_cache(B, cache_len)
    # Prefill both models (every row from 0: one scalar frontier); the
    # target's last logits give the first committed token.
    cur, _ = pick(tm(prompt, cache=tcache, start=0, last_only=True)[:, -1])
    dm(prompt, cache=dcache, start=0, last_only=True)
    out = torch.zeros((B, budget), dtype=torch.long, device=dev)
    out[:, 0] = cur
    steps = torch.arange(gamma + 1, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    if batched:  # per-row frontiers and output pointers, on the device
        pos = torch.full((B,), Lp, dtype=torch.long, device=dev)
        ptr = torch.ones(B, dtype=torch.long, device=dev)
        accepted = torch.zeros((), dtype=torch.long, device=dev)
    else:
        pos, ptr, accepted = Lp, 1, 0
    rounds = 0
    while bool((ptr < max_new_tokens).any()) if batched else ptr < max_new_tokens:
        # Draft: γ+1 one-token steps from the last committed token.
        tok, toks, qs = cur, [], []
        for j in range(gamma + 1):
            tok, q = pick(dm(tok[:, None], cache=dcache, start=pos + j)[:, -1])
            toks.append(tok)
            qs.append(q)
        d = torch.stack(toks[:gamma], dim=1)  # [B, γ]
        # Verify: one target pass over [cur, d_0..d_{γ-1}]; row (b, i)
        # predicts the slot of d_i.
        vlogits = tm(torch.cat([cur[:, None], d], dim=1), cache=tcache, start=pos)
        if greedy:
            tbest = torch.argmax(vlogits, dim=-1)
            n_acc = torch.cumprod((d == tbest[:, :gamma]).long(), dim=1).sum(dim=1)
            t_new = tbest.gather(1, n_acc[:, None])[:, 0]
        else:
            p = torch.softmax(warp(vlogits), dim=-1)
            u = torch.rand((B, gamma), generator=generator, device=dev)
            n_acc, resid = sampled_acceptance(d, torch.stack(qs[:gamma], dim=1), p, u)
            t_new = torch.multinomial(resid, 1, generator=generator)[:, 0]
        rounds += 1
        if batched:
            done = ptr >= max_new_tokens  # frozen rows commit nothing
            adv = torch.where(done, 0, n_acc + 1)
            window = torch.where(steps[None] == n_acc[:, None], t_new[:, None],
                                 torch.cat([d, torch.zeros_like(d[:, :1])], dim=1))
            out[rows, ptr[:, None] + steps] = window
            accepted = accepted + torch.where(done, 0, n_acc).sum()
            pos, ptr = pos + adv, ptr + adv
            cur = torch.where(done, cur, t_new)
        else:
            n = int(n_acc[0])  # the round's one device sync
            out[:, ptr:ptr + n] = d[:, :n]
            out[:, ptr + n] = t_new
            pos, ptr, accepted = pos + n + 1, ptr + n + 1, accepted + n
            cur = t_new
    stats.update(rounds=rounds, accepted=int(accepted), rows=B)
    return torch.cat([prompt, out[:, :max_new_tokens]], dim=1)
