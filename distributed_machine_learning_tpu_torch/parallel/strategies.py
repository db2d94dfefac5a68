"""The pluggable gradient-synchronization layer.

Counterpart of ``distributed_machine_learning_tpu/parallel/strategies.py``:
the reference's one varying layer (SURVEY.md §1), what happens between
``loss.backward()`` and ``optimizer.step()``:

  ==============  =====================================  =========
  strategy        reference                              reduction
  ==============  =====================================  =========
  none            part1 (one process, no sync)           —
  gather_scatter  part2/2a ``gatherAndScatter``          SUM
  all_reduce      part2/2b ``allReduce``                 SUM
  ring            part3 DDP bucketed ring (25 MB)        MEAN
  ==============  =====================================  =========

A strategy maps this rank's gradients (a list of tensors, the model's
parameter order) to the synced list over a
:class:`~distributed_machine_learning_tpu_torch.runtime.distributed.Comm`.
A stateful strategy (the error-feedback compressed ring) also implements
``init_state(grads)`` and ``apply(grads, state, comm) -> (synced,
new_state)``; its state is this rank's own residual, a flat f32 vector
(error feedback is rank-local by construction).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from distributed_machine_learning_tpu_torch.ops.collectives import (
    all_reduce_mean,
    all_reduce_sum,
    gather_scatter_sum,
)
from distributed_machine_learning_tpu_torch.ops.ring import (
    CODEC_IMPLS,
    DEFAULT_BUCKET_BYTES,
    WIRE_SCHEMES,
    get_wire_scheme,
    ring_all_reduce,
)


def flatten(grads: list) -> torch.Tensor:
    """The gradients raveled into one flat vector, in list order."""
    return torch.cat([g.reshape(-1) for g in grads])


def unflatten(flat: torch.Tensor, like: list) -> list:
    """Views of ``flat`` shaped like each tensor of ``like``."""
    out, start = [], 0
    for t in like:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


@dataclass(frozen=True)
class SyncStrategy:
    """Base: grads → synced grads over ``comm``."""

    name = "base"
    stateful = False

    def __call__(self, grads: list, comm) -> list:
        raise NotImplementedError

    def init_state(self, grads: list):
        return None

    def apply(self, grads: list, state, comm):
        return self(grads, comm), state


@dataclass(frozen=True)
class NoSync(SyncStrategy):
    """part1: one process, no gradient exchange."""

    name = "none"

    def __call__(self, grads, comm):
        return grads


@dataclass(frozen=True)
class AllReduce(SyncStrategy):
    """part2b: one all-reduce per parameter; SUM by default (§2.4)."""

    name = "all_reduce"
    mean: bool = False

    def __call__(self, grads, comm):
        return all_reduce_mean(grads, comm) if self.mean else all_reduce_sum(grads, comm)


@dataclass(frozen=True)
class GatherScatter(SyncStrategy):
    """part2a: gather → rank-order sum → scatter, as an all-gather and the
    same sum on every rank."""

    name = "gather_scatter"

    def __call__(self, grads, comm):
        return gather_scatter_sum(grads, comm)


@dataclass(frozen=True)
class RingAllReduce(SyncStrategy):
    """part3: the bucketed explicit ring, DDP mean semantics.

    ``compress`` picks the per-hop codec (``none``, ``bf16`` cast-only,
    ``int8`` per-chunk symmetric int8 + f32 scale, ``topk``);
    ``error_feedback`` (int8/topk) carries this rank's compression error
    into the next step's gradient (EF-SGD), which makes the strategy
    stateful; ``codec_impl="pallas"`` runs the int8 codec through the
    hand-written kernels K8-K10 (bitwise equal to ``"xla"``, their plain
    versions).  ``topology`` (the hierarchical plan) is ROADMAP A5c
    (``ops/topology.py``).  (The
    deprecated ``--wire-dtype bfloat16`` becomes ``compress="bf16"`` in the
    CLI.)
    """

    name = "ring"
    mean: bool = True
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    compress: str = "none"
    topk_frac: float = 0.125
    error_feedback: bool = True
    topology: str | None = None
    codec_impl: str = "xla"

    def __post_init__(self):
        if self.compress not in WIRE_SCHEMES:
            raise ValueError(f"unknown ring compress scheme {self.compress!r}; choose "
                             f"from {WIRE_SCHEMES}")
        if self.codec_impl not in CODEC_IMPLS:
            raise ValueError(f"unknown ring codec impl {self.codec_impl!r}; choose "
                             f"from {CODEC_IMPLS}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got {self.topk_frac}")
        if self.topology is not None:
            raise NotImplementedError(
                "--ring-topology is not ported yet: ROADMAP A5c (ops/topology.py, "
                "the hierarchical ring)")

    def scheme(self):
        return get_wire_scheme(self.compress, topk_frac=self.topk_frac,
                               codec_impl=self.codec_impl)

    @property
    def stateful(self):  # type: ignore[override]
        return self.error_feedback and self.compress in ("int8", "topk")

    def __call__(self, grads, comm):
        flat = ring_all_reduce(flatten(grads), comm, mean=self.mean,
                               bucket_bytes=self.bucket_bytes, scheme=self.scheme())
        return unflatten(flat, grads)

    def init_state(self, grads):
        if not self.stateful:
            return None
        return torch.zeros(sum(g.numel() for g in grads), dtype=torch.float32,
                           device=grads[0].device)

    def apply(self, grads, state, comm):
        if not self.stateful:
            return self(grads, comm), state
        # EF-SGD: reduce (gradient + carried residual); the new residual is
        # the compression error the ring itself observed on this rank.
        synced, new_state = ring_all_reduce(
            flatten(grads) + state, comm, mean=self.mean, bucket_bytes=self.bucket_bytes,
            scheme=self.scheme(), return_residual=True)
        return unflatten(synced, grads), new_state


STRATEGIES = {
    "none": NoSync,
    "gather_scatter": GatherScatter,
    "all_reduce": AllReduce,
    "ring": RingAllReduce,
}


def get_strategy(name: str, **kwargs) -> SyncStrategy:
    try:
        return STRATEGIES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown sync strategy {name!r}; choose from "
                         f"{sorted(STRATEGIES)}") from None
