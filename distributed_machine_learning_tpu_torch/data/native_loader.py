"""ctypes bridge to the C++ prefetching batch loader.

Counterpart of ``distributed_machine_learning_tpu/data/native_loader.py``
over the port's own copy of its source, ``native/dataloader.cc``: batch
assembly runs in a C++ worker thread behind a bounded queue (the role of
torch's DataLoader workers in the reference, ``part2/2a/main.py:162-167``).
The shared library is compiled on first use with the system ``g++`` into
``build/native/libdml_loader-<source hash>.so`` at the repo root (the
directory ``.gitignore`` lists), written under a temporary name and
renamed, so concurrent builders race benignly and an edited source never
loads a stale library.  When no toolchain is there,
:func:`native_available` is False and :func:`native_unavailable_reason`
says why; ``--loader auto`` then takes the Python loaders (the same batch
stream, element for element), ``--loader native`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from distributed_machine_learning_tpu_torch.data.cifar10 import Dataset
from distributed_machine_learning_tpu_torch.data.sharding import shard_indices

SRC = Path(__file__).resolve().parents[1] / "native" / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None
_lib_error: str | None = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdml_loader-{digest}.so"


def _compile(lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(SRC), "-o",
           str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, lib_path)


def _load():
    """Compile (once) and load the shared library; cache the outcome."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            lib.dl_create.restype = ctypes.c_void_p
            lib.dl_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64]
            lib.dl_next.restype = ctypes.c_int64
            lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.dl_destroy.restype = None
            lib.dl_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _lib_error = f"native loader unavailable: {detail}"
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_unavailable_reason() -> str | None:
    _load()
    return _lib_error


class NativeBatchLoader:
    """Drop-in for ``loader.BatchLoader`` backed by the C++ worker."""

    def __init__(self, dataset: Dataset, batch_size: int, indices: np.ndarray | None = None,
                 prefetch: int = 4):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        lib = _load()
        if lib is None:
            raise RuntimeError(_lib_error)
        self._lib = lib
        # Contiguous copies owned by this object: the C++ side reads them for
        # the lifetime of every handle made in __iter__.
        self._images = np.ascontiguousarray(dataset.images, dtype=np.uint8)
        self._labels = np.ascontiguousarray(dataset.labels, dtype=np.int32)
        self._indices = np.ascontiguousarray(
            np.arange(len(dataset)) if indices is None else indices, dtype=np.int64)
        self.batch_size = batch_size
        self.prefetch = prefetch
        self._row_bytes = int(np.prod(self._images.shape[1:]))
        self._row_shape = self._images.shape[1:]

    def __len__(self) -> int:
        return (len(self._indices) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        handle = self._lib.dl_create(self._images.ctypes.data, self._labels.ctypes.data,
                                     self._row_bytes, self._indices.ctypes.data,
                                     len(self._indices), self.batch_size, self.prefetch)
        if not handle:
            raise RuntimeError("dl_create failed (bad arguments)")
        try:
            while True:
                out_i = np.empty((self.batch_size, *self._row_shape), np.uint8)
                out_l = np.empty((self.batch_size,), np.int32)
                rows = self._lib.dl_next(handle, out_i.ctypes.data, out_l.ctypes.data)
                if rows == 0:
                    return
                yield out_i[:rows], out_l[:rows]
        finally:
            self._lib.dl_destroy(handle)


class NativeDistributedBatchLoader(NativeBatchLoader):
    """Drop-in for ``distributed_loader.DistributedBatchLoader``: rank
    ``rank``'s batches of ``per_rank_batch`` (its DistributedSampler slice,
    whole batches only), assembled by the C++ worker."""

    def __init__(self, dataset: Dataset, per_rank_batch: int, num_ranks: int, rank: int,
                 prefetch: int = 4):
        if per_rank_batch <= 0 or num_ranks <= 0:
            raise ValueError(f"per_rank_batch and num_ranks must be positive, got "
                             f"{per_rank_batch}, {num_ranks}")
        idx = shard_indices(len(dataset), rank, num_ranks)
        steps = len(idx) // per_rank_batch  # drop_last=True
        super().__init__(dataset, per_rank_batch, indices=idx[:steps * per_rank_batch],
                         prefetch=prefetch)
        self.per_rank_batch = per_rank_batch
