"""The port's native loader (its own copy of ``native/dataloader.cc``, built
with g++ into the gitignored ``build/native/``) and its retry wrapper,
against the port's Python loaders and the JAX package's native loader and
``retry_batches``.  The batch streams must be equal element for element."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from distributed_machine_learning_tpu_torch.data import native_loader as tnl
from distributed_machine_learning_tpu_torch.data.cifar10 import Dataset
from distributed_machine_learning_tpu_torch.data.distributed_loader import (
    DistributedBatchLoader,
)
from distributed_machine_learning_tpu_torch.data.loader import BatchLoader
from distributed_machine_learning_tpu_torch.data.retry import RetryPolicy, retry_batches


def _dataset(n=203, seed=3) -> Dataset:
    rng = np.random.default_rng(seed)
    return Dataset(images=rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                   labels=rng.integers(0, 10, n).astype(np.int32))


def _equal(a, b) -> bool:
    a, b = list(a), list(b)
    return len(a) == len(b) and all(
        x[0].dtype == y[0].dtype and np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def test_builds_into_the_gitignored_build_dir():
    assert tnl.native_available(), tnl.native_unavailable_reason()
    assert tnl.native_unavailable_reason() is None
    path = tnl.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.name.startswith("libdml_loader-")


@pytest.mark.parametrize("batch", [16, 64, 203, 300])
def test_single_stream_equals_python_and_jax_native(batch):
    from distributed_machine_learning_tpu.data.cifar10 import Dataset as JDataset
    from distributed_machine_learning_tpu.data.native_loader import NativeBatchLoader as JNative

    ds = _dataset()
    idx = np.random.default_rng(1).permutation(len(ds))[:150]
    port = tnl.NativeBatchLoader(ds, batch, indices=idx)
    assert len(port) == len(BatchLoader(ds, batch, indices=idx))
    assert _equal(port, BatchLoader(ds, batch, indices=idx))
    assert _equal(port, JNative(JDataset(ds.images, ds.labels), batch, indices=idx))


@pytest.mark.parametrize("world,per_rank", [(2, 8), (4, 5), (3, 64)])
def test_rank_streams_equal_python_and_jax_native_rows(world, per_rank):
    """Rank r's native stream is the port's Python DistributedBatchLoader's,
    and row block r of the JAX native loader's rank-major global batches."""
    from distributed_machine_learning_tpu.data.cifar10 import Dataset as JDataset
    from distributed_machine_learning_tpu.data.native_loader import (
        NativeDistributedBatchLoader as JNative,
    )

    ds = _dataset()
    jax_batches = list(JNative(JDataset(ds.images, ds.labels), per_rank, world))
    for r in range(world):
        port = tnl.NativeDistributedBatchLoader(ds, per_rank, world, r)
        assert len(port) == len(DistributedBatchLoader(ds, per_rank, world, r))
        assert _equal(port, DistributedBatchLoader(ds, per_rank, world, r))
        rows = [(x[r * per_rank:(r + 1) * per_rank], y[r * per_rank:(r + 1) * per_rank])
                for x, y in jax_batches]
        assert _equal(port, rows)


def test_abandoned_epoch_stops_the_worker():
    ds = _dataset(2000)
    loader = tnl.NativeBatchLoader(ds, 8, prefetch=2)
    for _ in range(3):  # the 40-iteration cap abandons epochs mid-way
        assert len(list(itertools.islice(iter(loader), 3))) == 3


class _Flaky:
    """A seekable source whose batches at ``bad`` raise ``times`` times."""

    def __init__(self, n: int, bad: dict):
        self.n, self.bad, self.fails = n, dict(bad), {}

    def __call__(self, start: int):
        for i in range(start, self.n):
            if self.fails.get(i, 0) < self.bad.get(i, 0):
                self.fails[i] = self.fails.get(i, 0) + 1
                raise OSError(f"flaky read at {i}")
            yield i


@pytest.mark.parametrize("bad,max_retries,per_batch", [
    ({3: 1}, 3, 2),           # one retry recovers
    ({2: 5, 6: 1}, 5, 2),     # batch 2 skipped after 2 attempts, 6 retried
    ({1: 9}, 1, 3),           # the budget runs out: the error surfaces
])
def test_retry_policy_vs_jax(bad, max_retries, per_batch, capsys):
    from distributed_machine_learning_tpu.data.retry import RetryPolicy as JPolicy
    from distributed_machine_learning_tpu.data.retry import retry_batches as jretry
    from distributed_machine_learning_tpu.runtime.faults import FaultEvents as JEvents

    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents

    outs = []
    for policy, retry, events in (
            (RetryPolicy(max_retries, per_batch, backoff_s=0.0), retry_batches, FaultEvents()),
            (JPolicy(max_retries, per_batch, backoff_s=0.0), jretry, JEvents())):
        got, err = [], None
        try:
            for b in retry(_Flaky(10, bad), policy, events, start=1):
                got.append(b)
        except OSError as exc:
            err = str(exc)
        outs.append((got, err, events.loader_retries, events.skipped_batches,
                     capsys.readouterr().out))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError) as port:
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError) as ref:
        JPolicy(max_retries=-1)
    assert str(port.value) == str(ref.value)
