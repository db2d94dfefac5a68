"""Minimal batched loader.

Counterpart of ``distributed_machine_learning_tpu/data/loader.py``
(``DataLoader(batch_size, shuffle=False)`` of ``part2/2a/main.py:162-167``):
augmentation and normalization run on the device, so the host side is
contiguous uint8 slicing.  No prefetch thread here (``data/native_loader.py``
prefetches in C++); the retry policy wraps it from outside
(``data/retry.py``, ``--loader-retries``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from distributed_machine_learning_tpu_torch.data.cifar10 import Dataset


class BatchLoader:
    """(images_u8, labels) batches over ``indices`` (default: all)."""

    def __init__(self, dataset: Dataset, batch_size: int, indices: np.ndarray | None = None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = np.arange(len(dataset)) if indices is None else np.asarray(indices)

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple]:
        imgs, labels = self.dataset.images, self.dataset.labels
        for lo in range(0, len(self.indices), self.batch_size):
            idx = self.indices[lo: lo + self.batch_size]
            yield imgs[idx], labels[idx]
