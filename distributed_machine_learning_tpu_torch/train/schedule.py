"""Gradient clipping by global norm.

From ``distributed_machine_learning_tpu/train/schedule.py``: the clip
(``--clip-norm``) only; the learning-rate schedules (``--lr-schedule``)
are ROADMAP A4.
"""

from __future__ import annotations

import torch


def global_norm(grads: list) -> torch.Tensor:
    """f32 global L2 norm of a list of tensors."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """Scale the gradients so their global L2 norm is at most ``max_norm``."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm(grads), min=1e-12), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads]
