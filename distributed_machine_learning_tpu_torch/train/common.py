"""The non-finite-gradient guard shared by the train steps.

Counterpart of ``tree_all_finite``/``guard_update`` in
``distributed_machine_learning_tpu/train/common.py``.  The reference
computes both states and selects per leaf inside the compiled step; the
port's update runs in place (K7 writes the parameters and moments), so
the guard decides before it: one device flag read per step (the loop
syncs on the loss anyway).
"""

from __future__ import annotations

from typing import Callable

import torch


def tree_all_finite(tree) -> torch.Tensor:
    """0-dim bool tensor: every element of every tensor in ``tree`` (a dict
    or a sequence of tensors) is finite."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def guard_update(finite, state, update: Callable) -> bool:
    """Run ``update(state)`` where ``finite`` holds, else leave ``state``
    untouched: parameters, moments and step counter stay as they were (the
    skipped step shows on the host as an unchanged ``state.step``).
    Returns whether the update ran."""
    if not bool(finite):
        return False
    update(state)
    return True
