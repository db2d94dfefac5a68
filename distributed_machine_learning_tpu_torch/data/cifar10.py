"""CIFAR-10 without torchvision.

Counterpart of ``distributed_machine_learning_tpu/data/cifar10.py``.  The
reference loads CIFAR-10 through ``torchvision.datasets.CIFAR10``
(``part1/main.py:96-97``), which unpickles the standard
``cifar-10-batches-py`` payload; this parses that layout directly:

1. an extracted ``cifar-10-batches-py/`` (or its ``.tar.gz``) under ``root``;
2. otherwise the deterministic synthetic stand-in (seeded numpy, the same
   shapes, dtype and label distribution, bit for bit the JAX package's),
   marked ``synthetic=True``.

It never attempts the download the JAX loader tries: the machines this
runs on have no network.  Images are NHWC uint8; normalization and
augmentation happen on the device (``augment.py``).
"""

from __future__ import annotations

import functools
import os
import pickle
import tarfile
from dataclasses import dataclass

import numpy as np

# Reference normalization constants (part1/main.py:82-83).
CIFAR10_MEAN = np.array([125.3, 123.0, 113.9], dtype=np.float32) / 255.0
CIFAR10_STD = np.array([63.0, 62.1, 66.7], dtype=np.float32) / 255.0

_DIRNAME = "cifar-10-batches-py"
_TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_FILES = ["test_batch"]


@dataclass
class Dataset:
    images: np.ndarray  # (N, 32, 32, 3) uint8, NHWC
    labels: np.ndarray  # (N,) int32
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.labels)


def _load_batches(batch_dir: str, files: list) -> tuple:
    images, labels = [], []
    for name in files:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        # (N, 3072) uint8, row-major CHW -> NHWC
        images.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(d[b"labels"], dtype=np.int32))
    return np.concatenate(images), np.concatenate(labels)


def _maybe_extract(root: str) -> str | None:
    batch_dir = os.path.join(root, _DIRNAME)
    if os.path.isdir(batch_dir):
        return batch_dir
    tar_path = os.path.join(root, "cifar-10-python.tar.gz")
    if os.path.isfile(tar_path):
        with tarfile.open(tar_path, "r:gz") as tar:
            tar.extractall(root, filter="data")
        return batch_dir if os.path.isdir(batch_dir) else None
    return None


@functools.lru_cache(maxsize=2)
def _synthetic(train: bool, seed: int = 69143) -> Dataset:
    """Deterministic stand-in with CIFAR shapes and class-conditional means
    (so a model can learn from it); the JAX package's, draw for draw.  Made
    once a process (a run of several parts, or a supervised restart, reuses
    it; the loaders only read it)."""
    n = 50_000 if train else 10_000
    rng = np.random.default_rng(seed + (0 if train else 1))
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    base = rng.integers(0, 256, size=(10, 32, 32, 3), dtype=np.int64)
    noise = rng.integers(-40, 41, size=(n, 32, 32, 3), dtype=np.int64)
    images = np.clip(base[labels] + noise, 0, 255).astype(np.uint8)
    return Dataset(images=images, labels=labels, synthetic=True)


def load_cifar10(root: str = "./data", train: bool = True,
                 allow_synthetic: bool = True) -> Dataset:
    """CIFAR-10's train or test split from ``root``, else the synthetic
    stand-in (or FileNotFoundError with ``allow_synthetic=False``)."""
    batch_dir = _maybe_extract(root) if os.path.isdir(root) else None
    if batch_dir is not None:
        images, labels = _load_batches(batch_dir, _TRAIN_FILES if train else _TEST_FILES)
        return Dataset(images=images, labels=labels, synthetic=False)
    if allow_synthetic:
        return _synthetic(train)
    raise FileNotFoundError(f"CIFAR-10 not found under {root!r} (no download is "
                            "attempted); pass allow_synthetic=True for the stand-in")
