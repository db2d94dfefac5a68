"""Gradient-sync collectives over the ranks of a :class:`Comm`.

Counterpart of ``distributed_machine_learning_tpu/ops/collectives.py``.
Each takes this rank's gradients (a list of tensors) and returns the synced
list; every rank ends with identical bits.
"""

from __future__ import annotations


def all_reduce_sum(grads: list, comm) -> list:
    """``dist.all_reduce(SUM)`` per parameter (part2/2b/main.py:101-106): the
    reference sums and never divides by the world size (SURVEY.md §2.4).
    In place."""
    return [comm.all_reduce_(g) for g in grads]


def all_reduce_mean(grads: list, comm) -> list:
    """DDP averaging semantics: the sum over ranks, divided by the world."""
    return [comm.all_reduce_(g).div_(comm.world) for g in grads]


def gather_scatter_sum(grads: list, comm) -> list:
    """part2a's gather → sum → scatter (part2/2a/main.py:89-116) as an
    all-gather followed by the same sum on every rank, accumulated in rank
    order 0..W−1 as the reference's loop at ``:104-107`` does."""
    out = []
    for g in grads:
        parts = comm.all_gather(g)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        out.append(acc)
    return out
