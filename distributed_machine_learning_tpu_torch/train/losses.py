"""Loss functions.

Counterpart of ``distributed_machine_learning_tpu/train/losses.py``: the
mean softmax cross-entropy of ``torch.nn.CrossEntropyLoss``, in f32, and
the top-1 correct count of the reference's eval.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in f32 over all leading axes ([B, C]
    classification and [B, L, C] token logits alike)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def lm_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, L] targets (already shifted
    by the caller) of logits [B, L, V]."""
    return cross_entropy_loss(logits, targets)


def count_correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 correct-prediction count (part1/main.py:71-72)."""
    return (logits.argmax(-1) == labels).sum()
