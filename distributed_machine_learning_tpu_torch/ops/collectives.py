"""Gradient-sync collectives over the ranks of a :class:`Comm`, and the
differentiable collectives the sharded layers call.

Counterpart of ``distributed_machine_learning_tpu/ops/collectives.py``.
Each sync takes this rank's gradients (a list of tensors) and returns the
synced list; every rank ends with identical bits.

:func:`all_to_all` (Ulysses' head re-shard, the expert dispatch of
``ops/grouped.py``) and :func:`mean_over` (the MoE aux statistics over the
token-sharded axes) are autograd nodes: each carries the backward the
reference's ``lax.all_to_all`` and ``lax.pmean`` transpose to, so every rank
must call them, forward and backward, in the same order.
"""

from __future__ import annotations

import math

import torch


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


class _AllToAll(torch.autograd.Function):
    """``comm.all_to_all(t, split_dim, concat_dim)`` as an autograd node; its
    backward is the inverse all-to-all (split the gradient on
    ``concat_dim``, concatenate on ``split_dim``)."""

    @staticmethod
    def forward(ctx, t, comm, split_dim: int, concat_dim: int):
        ctx.comm, ctx.dims = comm, (split_dim, concat_dim)
        return comm.all_to_all(t, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.comm.all_to_all(g.contiguous(), concat_dim, split_dim), None, None, None


def all_to_all(t: torch.Tensor, comm, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all of ``t`` over ``comm`` (``Comm.all_to_all``),
    differentiable: the reference's ``lax.all_to_all(..., tiled=True)``."""
    return _AllToAll.apply(t, comm, split_dim, concat_dim)


def _mean_f32(comms, t: torch.Tensor) -> torch.Tensor:
    out = t.to(torch.float32, copy=True).contiguous()
    for c in comms:
        c.all_reduce_(out)
    return out.div_(math.prod(c.world for c in comms)).to(t.dtype)


class _MeanOver(torch.autograd.Function):
    """The mean over the ranks of every Comm of ``comms`` (the sum over each
    in turn, then the division); backward the same mean of the gradient:
    ``lax.pmean``'s transpose, a psum of the cotangent over the axes divided
    by their size."""

    @staticmethod
    def forward(ctx, t, comms):
        ctx.comms = comms
        return _mean_f32(comms, t)

    @staticmethod
    def backward(ctx, g):
        return _mean_f32(ctx.comms, g), None


def mean_over(comms, t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks of each Comm of ``comms`` (f32 sums, in
    ``comms``' order), differentiable as ``lax.pmean`` over those axes;
    ``t`` itself when no Comm has more than one rank."""
    comms = tuple(c for c in comms if c.world > 1)
    if not comms:
        return t
    return _MeanOver.apply(t, comms)
