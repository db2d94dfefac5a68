"""Overlap-aware sharded weight update: the consume-phase gather.

Counterpart of ``distributed_machine_learning_tpu/parallel/overlap.py``.
The flat-shard schemes' step splits in two ("Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training", arxiv 2004.13336):

- an **update phase**: forward/backward, the gradient reduce-scatter and
  the shard-local optimizer step, ending at the updated shard;
- a **consume phase**: the gather of the updated shards back into the
  full vector, dispatched at once and consumed by the next step's
  forward.  It is a bucketed ring (:func:`ops.ring.ring_all_gather_flat`,
  :data:`DEFAULT_GATHER_BUCKETS` buckets) that runs behind the host's work
  between the steps (the loss sync, the next batch's placement).

The reference dispatches the gather as its own XLA program.  Eager PyTorch
has no such asynchronous program on every wire (gloo's calls block the
host), so the port runs the gather on one background thread
(:class:`GatherThread`); the main thread issues no collective until it has
taken the result, so every rank issues its calls in one order.  Both
phases only move data, so the overlapped trajectory is bit for bit the
sync step's.

:class:`GatherSpanClock` keeps the ``param_gather`` span: from the
gather's dispatch to its observed readiness (the thread syncs the device
once its hops are done); ``pop()`` hands it to the train loop's
``param_gather_s`` once.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from distributed_machine_learning_tpu_torch.ops.ring import ring_all_gather_flat

# Buckets of the consume-phase ring gather: the reference's choice (enough
# payloads in flight a hop, few enough that each stays fat).
DEFAULT_GATHER_BUCKETS = 4


class GatherThread:
    """The consume-phase gather on one background thread:
    ``submit(shard)`` returns a Future of ``(full vector, seconds from
    dispatch to ready)``."""

    def __init__(self, comm, n_buckets: int = DEFAULT_GATHER_BUCKETS):
        self.comm, self.n_buckets = comm, n_buckets
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="param_gather")

    def _gather(self, shard: torch.Tensor, t0: float):
        if not shard.is_cuda:
            return ring_all_gather_flat(shard, self.comm, self.n_buckets), time.perf_counter() - t0
        with torch.cuda.device(shard.device):  # the current card is per thread
            full = ring_all_gather_flat(shard, self.comm, self.n_buckets)
            torch.cuda.current_stream().synchronize()
        return full, time.perf_counter() - t0

    def submit(self, shard: torch.Tensor) -> Future:
        return self._pool.submit(self._gather, shard, time.perf_counter())

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class GatherSpanClock:
    """The in-flight gather's span: ``open(future)`` at dispatch,
    ``close()`` at the next step's consume (waits for it, returns its full
    vector, keeps its seconds), ``pop()`` the last closed span, once."""

    def __init__(self):
        self._future: Future | None = None
        self._last_s: float | None = None

    def open(self, future: Future) -> None:
        self._future = future

    def close(self):
        """The in-flight gather's full vector (None if none is in flight)."""
        if self._future is None:
            return None
        full, self._last_s = self._future.result()
        self._future = None
        return full

    def pop(self) -> float | None:
        v, self._last_s = self._last_s, None
        return v
