"""Dense causal self-attention: prefill below the flash threshold.

Counterpart of ``dense_self_attention`` in
``distributed_machine_learning_tpu/ops/ring_attention.py``.  The ring
(sequence-sharded) attention of that module belongs to the parallelism
slice and is not ported yet.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
