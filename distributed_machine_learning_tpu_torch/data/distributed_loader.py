"""Per-rank batches with DistributedSampler layout.

Counterpart of ``distributed_machine_learning_tpu/data/distributed_loader.py``.
In the reference each of the W workers runs its own
``DataLoader(DistributedSampler(rank, W, shuffle=False))``
(``part2/2a/main.py:158-167``): rank r's step-i batch is
``shard_indices(N, r, W)[i·b:(i+1)·b]``, and the union over ranks is the
contiguous block part1 consumes at batch W·b.  The JAX package feeds every
rank from one process, so its loader yields the rank-major global batch;
the port runs one process per rank, so this loader yields rank r's own
slice: the same examples as row block r of that global batch.
"""

from __future__ import annotations

from typing import Iterator

from distributed_machine_learning_tpu_torch.data.cifar10 import Dataset
from distributed_machine_learning_tpu_torch.data.sharding import shard_indices


class DistributedBatchLoader:
    """Yields rank ``rank``'s batches of ``per_rank_batch`` examples."""

    def __init__(self, dataset: Dataset, per_rank_batch: int, num_ranks: int, rank: int,
                 drop_last: bool = True):
        if per_rank_batch <= 0 or num_ranks <= 0:
            raise ValueError(f"per_rank_batch and num_ranks must be positive, got "
                             f"{per_rank_batch}, {num_ranks}")
        self.dataset = dataset
        self.per_rank_batch = per_rank_batch
        self.drop_last = drop_last
        self.indices = shard_indices(len(dataset), rank, num_ranks)

    def __len__(self) -> int:
        n, b = len(self.indices), self.per_rank_batch
        return n // b if self.drop_last else -(-n // b)

    def __iter__(self) -> Iterator[tuple]:
        imgs, labels = self.dataset.images, self.dataset.labels
        b = self.per_rank_batch
        for step in range(len(self)):
            idx = self.indices[step * b: (step + 1) * b]
            yield imgs[idx], labels[idx]
