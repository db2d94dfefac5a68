"""Model-FLOPs estimates, so a training throughput carries an MFU.

A copy of ``transformer_train_flops_per_token`` and ``mfu`` from
``distributed_machine_learning_tpu/utils/flops.py``.  The peak is the
H100 SXM's dense bf16 tensor-core rate (NVIDIA data sheet), not the
reference's TPU figure.
"""

from __future__ import annotations

# Dense bf16 peak of one H100 SXM (989 TFLOP/s at a 700 W power limit).
DEFAULT_PEAK_TFLOPS = 989.0


def transformer_train_flops_per_token(
    n_params: int, n_layers: int, d_model: int, seq_len: int,
    causal: bool = True,
) -> float:
    """~6·P per token for the matmuls (fwd 2P + bwd 4P) plus the attention
    score/value matmuls: 12·L·d·T per token fwd+bwd (2 matmuls × 2 FLOPs ×
    T·d each, × 3 for training).  ``causal=True`` counts the attention term
    at T/2, the work a causal kernel performs (tiles above the diagonal are
    skipped)."""
    attn = 12.0 * n_layers * d_model * seq_len
    if causal:
        attn /= 2.0
    return 6.0 * n_params + attn


def mfu(achieved_flops_per_sec: float,
        peak_tflops: float = DEFAULT_PEAK_TFLOPS) -> float:
    return achieved_flops_per_sec / (peak_tflops * 1e12)


def train_mfu_per_rank(tokens_per_sec: float, flops_per_token: float, ranks: int,
                       peak_tflops: float = DEFAULT_PEAK_TFLOPS) -> float:
    """MFU of one rank of a training run that takes ``tokens_per_sec`` in
    all over ``ranks`` ranks: every scheme of ``cli.lm`` splits the model's
    FLOPs evenly over its ranks (dp, fsdp and fsdp_pl by rows, ring and
    ulysses by sequence, tp by heads and columns, pp by layers, 3d by all
    three), so a rank does ``1/ranks`` of them, against one card's peak."""
    return mfu(tokens_per_sec * flops_per_token / ranks, peak_tflops)
