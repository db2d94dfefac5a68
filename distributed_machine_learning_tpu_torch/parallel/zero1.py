"""ZeRO-1: optimizer-state sharding under replicated parameters.

Counterpart of ``distributed_machine_learning_tpu/parallel/zero1.py``
(``Zero1State``, ``shard_zero1_state``, ``zero1_params``,
``make_zero1_train_step``, ``zero1_memory_footprint``).  The middle rung of
the ZeRO family:

- replicated data parallelism (``parallel/strategies.py``): parameters and
  momentum on every rank;
- **ZeRO-1 (this module)**: parameters replicated as one padded flat
  vector, momentum sharded 1/W;
- ZeRO-3 (``parallel/fsdp.py``): both sharded.

The step (MEAN gradient semantics):

  1. forward and backward on the replicated parameters (this rank's rows);
  2. the flattened gradient reduce-scattered, divided by W
     (``fsdp.flat_mean_grad_shard``, shared with ZeRO-3);
  3. the optimizer on this rank's slice of the parameters against its
     momentum shard: with ``AdamWConfig(fused=True)`` one K7 launch;
  4. the updated slices all-gathered back into the replicated vector.

``padded_len`` pads only to a multiple of W, so rank r's slice of the
replicated vector starts at r·n/W elements: off a 16-byte boundary
whenever n/W is not a multiple of 4 (VGG-11's 9,225,610 parameters at W 2
and 4).  K7 takes 16-byte-aligned operands only, so step 3 updates a
contiguous copy of the slice (n/W elements, its own allocation), which
step 4 gathers; nothing else reads the slice in place.

``overlap=True`` ends the step at the updated shard and gathers it on a
background thread behind the host's work between steps
(``parallel/overlap.py``, through ZeRO-3's protocol), bit for bit the sync
trajectory.  Until the next step (or ``step.join(state)``) takes the
gather, the state's ``param_flat`` is None.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from distributed_machine_learning_tpu_torch.parallel.fsdp import (
    prefetch_step,
    adopt_batch_stats,
    bind,
    cnn_inputs,
    flat_mean_grad_shard,
    flat_update,
    flatten_padded,
    fsdp_memory_footprint,
    refuse_lars,
    shard_moments,
)
from distributed_machine_learning_tpu_torch.runtime.mesh import padded_len
from distributed_machine_learning_tpu_torch.train.state import TrainState


@dataclass
class Zero1State:
    """Replicated padded flat f32 parameters and this rank's 1/W momentum
    shard (AdamW: ``{"mu", "nu"}``, each its own flat tensor), the step
    counter (host int), the optimizer config and BatchNorm's running
    statistics by name (replicated)."""

    param_flat: torch.Tensor | None
    momentum_shards: torch.Tensor | dict
    step: int
    config: object
    batch_stats: dict = field(default_factory=dict)


def shard_zero1_state(state: TrainState, comm):
    """A replicated TrainState → this rank's :class:`Zero1State`, with
    ``unravel`` (flat → parameters by name) and the unpadded parameter count
    ``n_elems``.  The model's parameters become views of ``param_flat``."""
    refuse_lars(state.config, "ZeRO-1")
    flat, mom, unravel, n_elems = flatten_padded(state, comm.world)
    z1 = Zero1State(param_flat=flat, momentum_shards=shard_moments(mom, comm.rank, comm.world),
                    step=state.step, config=state.config, batch_stats=state.batch_stats)
    bind(state.model, unravel(flat))
    return z1, unravel, n_elems


def zero1_params(state: Zero1State, unravel, n_elems: int) -> dict:
    """The parameters by name (for eval, a checkpoint or a comparison):
    copies out of the replicated vector, no collective."""
    if state.param_flat is None:
        raise ValueError("the overlap step's gather of this state is in flight: call "
                         "step.join(state) first")
    return {k: v.clone() for k, v in unravel(state.param_flat[:n_elems]).items()}


def make_zero1_train_step(model, comm, unravel, n_elems: int, augment: bool = True,
                          overlap: bool = False):
    """The ZeRO-1 step for the VGG models, each rank its rows of the global
    batch (see the module docstring).  Every rank must call it each time.

    ``overlap=True``: the updated shard's gather runs behind the host's work
    until the next step takes it (``fsdp.prefetch_step``, the protocol
    ZeRO-3 runs); the step carries ``join(state)`` (waits for the gather in
    flight and installs its full vector into ``state`` if it was dispatched
    for it; call it before any other collective and before the group shuts
    down), ``pop_gather_seconds()`` (the train loop's ``param_gather_s``)
    and ``close()``.

    Returns ``step(state, images_u8, labels) -> (state, loss)``: the state
    updated in place, the loss averaged over the ranks."""
    rank, world = comm.rank, comm.world

    def body(z1: Zero1State, full: torch.Tensor, images_u8, labels):
        bind(model, unravel(full[:n_elems]))
        adopt_batch_stats(model, z1.batch_stats)
        x = cnn_inputs(images_u8, comm, z1.step, augment)
        loss, stats, grad_shard = flat_mean_grad_shard(model, comm, x, labels, full.numel())
        n = full.numel() // world
        p_shard = full[rank * n:(rank + 1) * n].clone()  # aligned for K7 (module note)
        flat_update(z1.config, p_shard, z1.momentum_shards, grad_shard, z1.step)
        z1.step += 1
        if stats:
            model.set_batch_stats(stats)
        z1.param_flat = None  # the next vector is the gather of p_shard
        return z1, loss, p_shard

    def fetch(z1: Zero1State):
        if z1.param_flat is None:
            raise ValueError("Zero1State without parameters: its gather was dispatched by "
                             "another step, or dropped by a prefetch miss")
        return z1.param_flat

    if not overlap:
        def step(z1: Zero1State, images_u8, labels):
            z1, loss, p_shard = body(z1, fetch(z1), images_u8, labels)
            z1.param_flat = comm.all_gather_flat(p_shard)
            return z1, loss

        return step

    step = prefetch_step(comm, body, fetch, lambda z1: z1.param_flat)
    take = step.join

    def join(z1: Zero1State):
        full = take(z1)
        if full is not None:
            z1.param_flat = full
        return z1.param_flat

    step.join = join
    return step


def zero1_memory_footprint(n_params: int, n_dev: int, bytes_per_elem: int = 4) -> dict:
    """Parameter and momentum bytes a rank: replicated vs ZeRO-1 vs ZeRO-3.
    ZeRO-1 counts the padded replicated vector plus the 1/W momentum shard
    (the reference's accounting: one momentum vector)."""
    fp = fsdp_memory_footprint(n_params, n_dev, bytes_per_elem)
    padded = padded_len(n_params, n_dev)
    fp["zero1"] = (padded + padded // n_dev) * bytes_per_elem
    return fp
