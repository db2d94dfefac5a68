"""Fused LM head + cross-entropy: the loss without the [T, vocab] logits.

Counterpart of ``distributed_machine_learning_tpu/ops/fused_ce.py``.
Computes

    mean over tokens of  [ logsumexp(h·Wᵀ + b) − (h·Wᵀ + b)[target] ]

chunk by chunk over the vocabulary: each chunk materializes only a
[T, chunk] logit block, keeps a running online logsumexp (the max-rescaling
recurrence flash attention uses over keys) and picks out the target logit
of the tokens whose target falls in the chunk.  Peak logit memory drops
from T·V to T·ceil(V / num_chunks).

The port's head weight is ``[V, E]`` (``nn.Linear``), so a chunk is a row
slice of it.  The chunk products are ``torch.matmul`` in the inputs'
dtype (bf16 stays bf16, as the model's own head projection runs), the
logits taken to f32; the logsumexp and softmax bookkeeping is f32.  The
reference computes these products outside any Pallas kernel, as XLA dots,
so they have no kernel of their own here.  The backward replays the same
loop from the saved per-token logsumexp (``probs = exp(logits − lse)``),
accumulating dh and writing each chunk's dW and db, so its peak memory
matches the forward's.  The loss equals the
unfused one to f32 rounding (the reductions run in another order).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite -inf stand-in (running-max init)


def _chunk_bounds(V: int, num_chunks: int) -> list[tuple[int, int]]:
    """(start, stop) of each vocab chunk; empty tail chunks are dropped."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    C = -(-V // num_chunks)
    return [(s, min(s + C, V)) for s in range(0, V, C)]


def _block(h, weight, bias, start: int, stop: int) -> torch.Tensor:
    """f32 logits of vocab rows [start, stop): the product in the inputs'
    dtype, the bias added in f32."""
    logits = torch.matmul(h, weight[start:stop].t()).float()
    return logits + bias[start:stop].float()


def _targets_in(targets, start: int, stop: int):
    """(mask of the tokens whose target lies in [start, stop), the target's
    column in the chunk, clamped for the others)."""
    inside = (targets >= start) & (targets < stop)
    return inside, (targets - start).clamp(0, stop - start - 1)


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, weight, bias, targets, num_chunks: int):
        T = hidden.shape[0]
        m = torch.full((T,), NEG_INF, dtype=torch.float32, device=hidden.device)
        s = torch.zeros((T,), dtype=torch.float32, device=hidden.device)
        tgt = torch.zeros((T,), dtype=torch.float32, device=hidden.device)
        bounds = _chunk_bounds(weight.shape[0], num_chunks)
        for start, stop in bounds:
            logits = _block(hidden, weight, bias, start, stop)  # [T, C] f32
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            inside, col = _targets_in(targets, start, stop)
            picked = logits.gather(1, col[:, None])[:, 0]
            tgt = tgt + torch.where(inside, picked, 0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, weight, bias, targets, lse)
        ctx.bounds = bounds
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, targets, lse = ctx.saved_tensors
        T = hidden.shape[0]
        scale = g.float() / T  # d(mean)/d(per-token loss)
        dt = hidden.dtype
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
        dw = torch.empty(weight.shape, dtype=weight.dtype, device=weight.device)
        db = torch.empty(bias.shape, dtype=bias.dtype, device=bias.device)
        for start, stop in ctx.bounds:
            logits = _block(hidden, weight, bias, start, stop)  # recomputed
            dlogits = torch.exp(logits - lse[:, None])
            inside, col = _targets_in(targets, start, stop)
            dlogits.scatter_add_(1, col[:, None], -inside.float()[:, None])  # - one-hot
            dlogits *= scale  # [T, C] f32
            db[start:stop] = dlogits.sum(0).to(bias.dtype)
            dlogits = dlogits.to(dt)  # the products in the inputs' dtype
            dh += torch.matmul(dlogits, weight[start:stop]).float()
            dw[start:stop] = torch.matmul(dlogits.t(), hidden).to(weight.dtype)
        return dh.to(hidden.dtype), dw, db, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, targets: torch.Tensor,
                               num_chunks: int = 8) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(hidden @ weight.T + bias)`` against
    ``targets`` without materializing the [T, V] logits; differentiable in
    ``hidden``, ``weight`` and ``bias``.

    ``hidden`` [T, E]; ``weight`` [V, E] (the port's ``lm_head.weight``);
    ``bias`` [V]; ``targets`` [T] int.  ``num_chunks``: vocab chunks; peak
    logit memory is T × ceil(V / num_chunks) f32."""
    if hidden.dim() != 2 or weight.dim() != 2 or hidden.shape[1] != weight.shape[1]:
        raise ValueError(f"want hidden [T, E] and weight [V, E], got "
                         f"{tuple(hidden.shape)} and {tuple(weight.shape)}")
    return _FusedLinearCE.apply(hidden, weight, bias, targets, num_chunks)
