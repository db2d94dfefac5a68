"""Ulysses sequence parallelism: all-to-all head-sharded attention.

Counterpart of ``distributed_machine_learning_tpu/ops/ulysses.py``, the
second context-parallel scheme beside the ring (``ops/ring_attention.py``,
``ops/ring_flash_attention.py``).  One all-to-all re-shards the
activations from sequence-sharded [B, L/n, H, D] to head-sharded
[B, L, H/n, D]; every rank runs ordinary causal attention over the *full*
sequence for its slice of heads; a second all-to-all restores sequence
sharding.  The local attention is the flash kernels (K1 forward, K2/K3
backward, GQA-native) where ``flash_wins`` holds for the full L, dense
attention below.

Ulysses makes 2 all-to-alls of activation size whatever n (the ring makes
n − 1 rotations), but needs ``n_heads % n == 0`` and holds full-L scores
per head slice.  Both are exact.  Each all-to-all is an autograd node whose
backward is the inverse all-to-all, so every rank must call every Ulysses
attention, forward and backward, in the same order (as the ring's hops).
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.ops.collectives import all_to_all as _all_to_all
from distributed_machine_learning_tpu_torch.ops.flash_attention import (
    flash_self_attention,
    flash_wins,
)
from distributed_machine_learning_tpu_torch.ops.ring_attention import dense_self_attention


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm,
                           local_attn: str = "auto") -> torch.Tensor:
    """Exact causal attention over sequence chunks sharded on ``comm``'s
    ranks (chunk r holds global positions [r·Lc, (r+1)·Lc)): q [B, Lc, H, D]
    and k/v [B, Lc, Hkv, D] → [B, Lc, H, D] in q's dtype.

    ``local_attn``: the attention over the full sequence after the head
    re-shard: "dense", "flash" (K1-K3 on the card), or "auto" (flash where
    ``flash_wins(L)`` holds for the full L)."""
    n = comm.world
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"query heads ({H}) must be a multiple of K/V heads ({Hkv})")
    rep = H // Hkv
    if n == 1:
        return dense_self_attention(q, k.repeat_interleave(rep, dim=2) if rep > 1 else k,
                                    v.repeat_interleave(rep, dim=2) if rep > 1 else v)
    if H % n:
        raise ValueError(f"Ulysses needs n_heads divisible by the sequence-axis size: "
                         f"{H} heads over {n} devices (use the ring instead)")
    L = q.shape[1] * n
    use_flash = local_attn == "flash" or (local_attn == "auto" and flash_wins(L))
    if rep > 1 and Hkv % n == 0:
        # GQA narrow path: query head block r maps onto kv block r (h → h //
        # rep keeps blocks when n | Hkv), so the narrow K/V travel: H + 2·Hkv
        # heads a token instead of 3·H.  q viewed [B, Lc, Hkv, rep, D] packs
        # with k and v on the rep axis; one all-to-all splits the shared
        # Hkv axis, so q and kv blocks align by construction.
        B, Lc, _, D = q.shape
        pack = torch.cat([q.reshape(B, Lc, Hkv, rep, D), k[:, :, :, None],
                          v[:, :, :, None]], dim=3)  # [B, Lc, Hkv, rep+2, D]
        pack = _all_to_all(pack, comm, 2, 1)  # [B, L, Hkv/n, rep+2, D]
        hkv_l = pack.shape[2]
        q2 = pack[:, :, :, :rep].reshape(B, L, hkv_l * rep, D)
        k2, v2 = pack[:, :, :, rep], pack[:, :, :, rep + 1]
        if use_flash:
            out = flash_self_attention(q2, k2, v2)  # GQA-native: narrow K/V as-is
        else:
            out = dense_self_attention(q2, k2.repeat_interleave(rep, dim=2),
                                       v2.repeat_interleave(rep, dim=2))
        return _all_to_all(out, comm, 1, 2)
    if rep > 1:
        # Hkv not divisible by n: widen first (the blocks would not align),
        # paying the wide all-to-all.
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    # seq-sharded → head-sharded: rank r keeps heads [r·H/n, (r+1)·H/n) over
    # the full sequence; q, k and v ride one stacked all-to-all.
    qkv = _all_to_all(torch.stack([q, k, v], dim=2), comm, 3, 1)  # [B, L, 3, H/n, D]
    local = flash_self_attention if use_flash else dense_self_attention
    out = local(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    return _all_to_all(out, comm, 1, 2)  # head-sharded → seq-sharded
