"""Ring attention over a sequence-sharded process group, and dense attention.

Counterpart of ``distributed_machine_learning_tpu/ops/ring_attention.py``.
:func:`ring_self_attention` is the einsum ring: each rank keeps its query
chunk, the K/V chunks rotate around the ring (rank r sends to r + 1, one
:meth:`Comm.shift` per hop) and every chunk pair is merged densely into an
online-softmax running state in f32.  It is plain PyTorch, as the
reference is plain XLA; its gradient comes from autograd through the
block math and through :class:`_Hop`, whose backward is the reverse hop
(the transpose of the reference's ``lax.ppermute``).
:func:`dense_self_attention` is the one-device reference semantics.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _online_update(carry, q, k, v, q_pos, k_pos, scale):
    """One block update of the (m, l, o) running triple (natural exp, as
    the reference): q [B, Lq, H, D], k/v [B, Lk, H, D] widened."""
    m, l, o = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    # Masked entries must contribute 0 even in a fully masked row.
    p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o * alpha.transpose(1, 2)[..., None] + pv


class _Hop(torch.autograd.Function):
    """One ring hop (rank r → r + 1) as an autograd node; its backward sends
    the gradients the other way (r + 1 → r)."""

    @staticmethod
    def forward(ctx, comm, *payload):
        ctx.comm = comm
        return comm.shift(payload)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.comm.shift(grads, -1))


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        comm) -> torch.Tensor:
    """Exact causal attention over sequence chunks sharded on ``comm``'s
    ranks (chunk r holds global positions [r·Lc, (r+1)·Lc)): q [B, Lc, H, D]
    and k/v [B, Lc, Hkv, D] (Hkv | H: the narrow chunks travel and are
    widened per block) → [B, Lc, H, D] in q's dtype.  Every rank must call
    it, in the same order: n − 1 hops forward, n − 1 reverse hops in the
    backward."""
    n = comm.world
    B, Lc, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"query heads ({H}) must be a multiple of K/V heads ({Hkv})")
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    arange = torch.arange(Lc, device=q.device)
    q_pos = comm.rank * Lc + arange
    m = torch.full((B, H, Lc), NEG_INF, dtype=torch.float32, device=q.device)
    carry = (m, torch.zeros_like(m),
             torch.zeros((B, Lc, H, D), dtype=torch.float32, device=q.device))
    kv = (k, v)
    for s in range(n):
        # After s hops this rank holds the chunk that started on rank - s.
        k_pos = (comm.rank - s) % n * Lc + arange
        kc, vc = (t.repeat_interleave(rep, dim=2) if rep > 1 else t for t in kv)
        carry = _online_update(carry, q, kc, vc, q_pos, k_pos, scale)
        if s < n - 1:
            kv = _Hop.apply(comm, *kv)
    _, l, o = carry
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def dense_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor | None = None) -> torch.Tensor:
    """Exact causal attention, [B, L, H, D] in and out (k/v full width).
    f32 scores and softmax, masked scores at -1e30, output in q's dtype."""
    B, L, H, D = q.shape
    if positions is None:
        positions = torch.arange(L, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    causal = positions[:, None] >= positions[None, :]
    s = torch.where(causal, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
