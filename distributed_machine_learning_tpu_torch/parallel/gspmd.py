"""The shared recipe of the per-leaf sharded-parameter schemes: per-layer
FSDP now, tensor and expert parallelism later.

Counterpart of ``distributed_machine_learning_tpu/parallel/gspmd.py``.  The
reference declares where each leaf lives (a ``PartitionSpec`` from a rule
table) and lets XLA's SPMD partitioner place the collectives.  The port
has no partitioner, so the recipe is explicit:

- a rule ``spec_for(name, shape) -> dim | None`` names the dimension a
  leaf is split along over the ranks (None: replicated);
  :func:`param_specs` maps it over the parameters, :func:`state_shardings`
  gives every moment its parameter's entry (``train/optimizers.moment_layout``);
- :func:`shard_state` leaves each rank its own contiguous block of every
  split parameter and moment (a ``narrow`` view of a non-leading dimension
  is neither contiguous nor 16-byte aligned, and K7 takes neither);
- :class:`GatherLeaf` is the collective pair at a leaf's use: forward an
  all-gather of the blocks along the dimension, backward a reduce-scatter
  of the gradient back to the rank's block (the sum over the ranks);
- :func:`make_cached_sharded_step` keeps one built step per optimizer
  config, as the reference caches one jitted program per state structure
  (its config is static metadata).
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_machine_learning_tpu_torch.train.optimizers import moment_layout

SpecFor = Callable[[str, tuple], "int | None"]


def param_specs(params: dict, spec_for: SpecFor) -> dict:
    """The rule over the parameters: name → split dimension or None."""
    return {name: spec_for(name, tuple(p.shape)) for name, p in params.items()}


def state_shardings(state, spec_for: SpecFor) -> dict:
    """``{"params": specs, "momentum": specs of the moment slot}``: the
    moments follow their parameter's entry."""
    specs = param_specs(state.params, spec_for)
    return {"params": specs, "momentum": moment_layout(specs, state.params, state.momentum)}


def block_of(t: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    """Block ``rank`` of W equal blocks of ``t`` along ``dim``, as a fresh
    contiguous tensor."""
    part = t.narrow(dim, rank * (t.shape[dim] // world), t.shape[dim] // world)
    return torch.empty(part.shape, dtype=t.dtype, device=t.device).copy_(part)


def moment_trees(momentum, params: dict) -> list[dict]:
    """The params-shaped dicts of the moment slot (one for SGD, mu and nu
    for AdamW), by ``moment_layout``'s reading of its structure."""
    return ([momentum] if moment_layout(params, params, momentum) is params
            else list(momentum.values()))


@torch.no_grad()
def shard_state(state, comm, spec_for: SpecFor) -> dict:
    """Leave this rank its own block of every split parameter (the
    parameter's ``data`` becomes the block) and of each of its moments, in
    place; replicated leaves stay whole.  Returns the parameters' specs."""
    layout = state_shardings(state, spec_for)
    specs = layout["params"]
    mom_specs = layout["momentum"]
    for name, p in state.params.items():
        if specs[name] is not None:
            p.data = block_of(p.data, specs[name], comm.rank, comm.world)
    for tree, tree_specs in ([(state.momentum, mom_specs)] if mom_specs is specs
                             else [(state.momentum[k], v) for k, v in mom_specs.items()]):
        for name, dim in tree_specs.items():
            if dim is not None:
                tree[name] = block_of(tree[name], dim, comm.rank, comm.world)
    return specs


def gathered_host_state(state, gather_tree: Callable):
    """The whole state as a dp-layout ``HostState`` (what a tp or ep run
    saves): ``gather_tree(tree)`` gives the whole leaves of a params-shaped
    dict of this rank's parts, on the host.  Every rank must call it."""
    from distributed_machine_learning_tpu_torch.train.checkpoint import HostState

    params = gather_tree(state.params)
    trees = [gather_tree(t) for t in moment_trees(state.momentum, state.params)]
    momentum = trees[0] if len(trees) == 1 else dict(zip(state.momentum, trees))
    return HostState(params=params, momentum=momentum, batch_stats={}, step=int(state.step),
                     config=state.config)


@torch.no_grad()
def load_host_state(state, host, local: Callable):
    """A dp-layout ``HostState`` (a restored checkpoint) into a sharded
    state, in place: ``local(name, whole)`` is this rank's part of each
    leaf and moment; then the step counter."""
    for name, p in state.params.items():
        p.copy_(local(name, host.params[name]))
    for mine, saved in zip(moment_trees(state.momentum, state.params),
                           moment_trees(host.momentum, host.params)):
        for name, t in mine.items():
            t.copy_(local(name, saved[name]))
    state.step = int(host.step)
    return state


def gather_dim(block: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """Every rank's ``block`` concatenated along ``dim`` in rank order (one
    ``all_gather_flat``)."""
    world = comm.world
    flat = comm.all_gather_flat(block.reshape(-1)).view(world, *block.shape)
    shape = list(block.shape)
    shape[dim] *= world
    if dim == 0:
        return flat.view(shape)
    return flat.movedim(0, dim).reshape(shape)


def reduce_scatter_dim(full: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """The sum over the ranks of ``full``, of which this rank keeps block
    ``rank`` along ``dim`` (one ``reduce_scatter``)."""
    world = comm.world
    shape = list(full.shape)
    shape[dim] //= world
    blocks = full.unflatten(dim, (world, shape[dim])).movedim(dim, 0).contiguous()
    return comm.reduce_scatter(blocks.reshape(-1)).view(shape)


class GatherLeaf(torch.autograd.Function):
    """A split leaf at its use: forward all-gathers the blocks along
    ``dim``; backward reduce-scatters the full gradient back to this rank's
    block and divides by W (the mean over the ranks' batch rows)."""

    @staticmethod
    def forward(ctx, block, dim: int, comm):
        ctx.dim, ctx.comm = dim, comm
        return gather_dim(block.detach(), dim, comm)

    @staticmethod
    def backward(ctx, grad):
        comm = ctx.comm
        return reduce_scatter_dim(grad, ctx.dim, comm).div_(comm.world), None, None


def make_cached_sharded_step(build: Callable):
    """``step(state, x, y)`` running ``build(state)``'s step, built once per
    optimizer config (type and field values) and kept."""
    cache: dict = {}

    def step(state, x, y):
        key = (type(state.config).__name__, state.config)
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = build(state)
        return fn(state, x, y)

    step.cache = cache
    return step
