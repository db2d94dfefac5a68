"""Learning-rate schedules and gradient clipping by global norm.

Counterpart of ``distributed_machine_learning_tpu/train/schedule.py``:
``constant`` (the reference's fixed lr 0.1, ``part1/main.py:120``),
``warmup_cosine`` (linear warmup 0 → peak, then cosine decay to
``end_lr``) and ``step_decay`` (×``gamma`` at each boundary), each a pure
``step -> lr`` function.  The reference evaluates them inside its compiled
step in f32; here the step counter is a host int, so the rate is computed
on the host in the same f32 arithmetic (numpy) and handed to the update as
a Python float.  The clip (``--clip-norm``) scales the synced gradients.
"""

from __future__ import annotations

import numpy as np
import torch


def constant(lr: float):
    """The reference's behaviour: a fixed rate."""
    return lambda step: float(np.float32(lr))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, end_lr: float = 0.0):
    """Linear warmup 0 → peak over ``warmup_steps``, then cosine decay to
    ``end_lr`` at ``total_steps``."""
    if total_steps <= warmup_steps:
        raise ValueError(f"total_steps={total_steps} must exceed warmup_steps={warmup_steps}")
    f32 = np.float32

    def schedule(step):
        s = f32(step)
        if s < warmup_steps:
            return float(f32(peak_lr) * s / f32(max(warmup_steps, 1)))
        progress = np.clip((s - f32(warmup_steps)) / f32(total_steps - warmup_steps),
                           f32(0.0), f32(1.0))
        cos = f32(end_lr) + f32(0.5) * f32(peak_lr - end_lr) * (
            f32(1) + np.cos(f32(np.pi) * progress))
        return float(f32(cos))

    return schedule


def step_decay(lr: float, boundaries: tuple[int, ...], gamma: float = 0.1):
    """Multiply the rate by ``gamma`` at each boundary step."""
    bounds = sorted(int(b) for b in boundaries)

    def schedule(step):
        passed = sum(1 for b in bounds if int(step) >= b)
        return float(np.float32(lr) * np.float32(gamma) ** np.int32(passed))

    return schedule


def global_norm(grads: list) -> torch.Tensor:
    """f32 global L2 norm of a list of tensors."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """Scale the gradients so their global L2 norm is at most ``max_norm``."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm(grads), min=1e-12), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads]
