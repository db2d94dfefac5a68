"""Deterministic data sharding with DistributedSampler semantics.

A copy of ``distributed_machine_learning_tpu/data/sharding.py``.  The
reference shards with ``DistributedSampler(training_set, rank=rank,
num_replicas=nodes, shuffle=False, seed=69143)``
(``part2/2a/main.py:158-159``): indices ``0..N-1``, padded from the head
to a multiple of ``num_replicas``, rank-strided, so rank ``r`` sees
samples ``r, r+W, r+2W, ...``.
"""

from __future__ import annotations

import numpy as np


def _order(num_samples: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    if shuffle:  # torch shuffles with a generator seeded seed + epoch
        return np.random.default_rng(seed + epoch).permutation(num_samples)
    return np.arange(num_samples)


def shard_indices(num_samples: int, rank: int, num_replicas: int, shuffle: bool = False,
                  seed: int = 69143, epoch: int = 0) -> np.ndarray:
    """Indices this rank consumes, DistributedSampler-compatible."""
    if not 0 <= rank < num_replicas:
        raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
    indices = _order(num_samples, shuffle, seed, epoch)
    total = ((num_samples + num_replicas - 1) // num_replicas) * num_replicas
    if total > num_samples:  # pad by wrapping from the head
        indices = np.concatenate([indices, indices[: total - num_samples]])
    return indices[rank::num_replicas]


def exact_shard_indices(num_samples: int, rank: int, num_replicas: int,
                        shuffle: bool = False, seed: int = 69143,
                        epoch: int = 0) -> np.ndarray:
    """Indices under an exact partition (no wrap padding): across ranks every
    index appears once; per-rank counts differ by at most one."""
    if not 0 <= rank < num_replicas:
        raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
    return _order(num_samples, shuffle, seed, epoch)[rank::num_replicas]
