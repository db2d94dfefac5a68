"""Composed 3-D parallelism: data × pipeline × tensor over dp·pp·tp ranks.

Counterpart of ``distributed_machine_learning_tpu/parallel/parallel3d.py``.
The reference runs one program over a ``("batch", "pipe", "model")`` mesh:
the pipe axis manual (the GPipe tick loop of ``parallel/pipeline.py``), the
model and batch axes left to XLA's partitioner.  Here every rank is a
process at mesh coordinates (d, p, t), rank = (d·pp + p)·tp + t (``model``
innermost, as the reference orders its mesh), with one ``Comm`` per axis
(``runtime/distributed.mesh_comms``):

- model: the rank's stage layers at local width (``tensor_parallel``'s
  training layout, the head split by vocabulary, the embedding whole, as
  ``p3_param_spec`` keeps it);
- pipe: GPipe over the stages (``pipeline.make_pipeline_step``);
- batch: each microbatch's rows split over the data group; after the
  pipeline's backward every gradient and the loss are averaged over it.

``zero1_dp`` (``--zero1-dp``, ZeRO-1 × 3-D): each leaf's moments are kept
1/dp over the data group, along the largest free dimension dp divides
(:func:`p3_zero1_moment_spec`: not the stacked layer dimension, not the
split one, never the embedding's); a rank updates its block of the
parameter (one K7 launch a leaf) and the updated blocks are all-gathered
back (``gspmd.gather_dim``): elementwise, so the trajectory is plain 3-D's.
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.parallel.gspmd import (
    block_of,
    gather_dim,
    moment_trees,
)
from distributed_machine_learning_tpu_torch.parallel.pipeline import (
    _is_block,
    gpipe_table,
    make_pipeline_step,
    microbatch,
    pipeline_state,
)
from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
    shard_tp_state,
    tp_spec_for,
)
from distributed_machine_learning_tpu_torch.runtime.distributed import mesh_comms
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config

DATA_AXIS = "batch"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
MESH_AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS)

__all__ = ["MESH_AXES", "make_3d_mesh", "p3_param_spec", "p3_zero1_moment_spec",
           "p3_zero1_grad_spec", "shard_3d_state", "make_3d_lm_train_step", "shard_3d_batch",
           "microbatch"]


def check_3d_mesh(world: int, dp, pp: int, tp: int) -> int:
    """The reference's mesh checks (``cli/lm.py:713-726``); returns dp
    (default: world // (pp·tp))."""
    if pp < 1 or tp < 1:
        raise ValueError(f"--pp and --tp must be >= 1, got pp={pp} tp={tp}")
    if dp is not None and dp < 1:
        raise ValueError(f"--dp must be >= 1, got {dp}")
    dp = dp if dp is not None else max(world // (pp * tp), 1)
    if dp * pp * tp != world:
        raise ValueError(f"3-D mesh dp×pp×tp = {dp}×{pp}×{tp} = {dp * pp * tp} must equal "
                         f"the device count {world} (a prefix-subset mesh would silently "
                         "idle the rest)")
    return dp


def make_3d_mesh(comm, dp: int, pp: int, tp: int) -> dict:
    """The (dp, pp, tp) mesh over ``comm``'s ranks: one Comm per axis of
    :data:`MESH_AXES`, ``model`` innermost."""
    check_3d_mesh(comm.world, dp, pp, tp)
    return mesh_comms(comm, {DATA_AXIS: dp, PIPE_AXIS: pp, MODEL_AXIS: tp})


def p3_param_spec(name: str, shape) -> tuple:
    """The 3-D layout of one leaf of the pipeline layout (``blocks.<leaf>``
    stacked ``[n_layers, ...]``, or a boundary leaf), one entry per
    dimension: the stacked layer dimension over ``pipe``, the tensor-parallel
    split (``tensor_parallel.tp_spec_for``, the embedding whole) over
    ``model``, None elsewhere."""
    stacked = _is_block(name)
    inner = shape[1:] if stacked else shape
    axes = [None] * len(inner)
    spec = tp_spec_for(name, embed=False)
    if spec is not None:
        axes[spec[0]] = MODEL_AXIS
    return tuple([PIPE_AXIS] + axes if stacked else axes)


def p3_zero1_moment_spec(name: str, shape, dp: int, base=None) -> tuple:
    """A moment's layout under ZeRO-1 × 3-D (the reference's rule,
    ``:115-146``): its parameter's (``base``, default :func:`p3_param_spec`)
    plus the data axis on the largest still-free dimension dp divides
    (ties: the first); the embedding's moments stay whole."""
    if name.split(".")[0] == "embed":
        return (None,) * len(shape)
    base = tuple(p3_param_spec(name, shape) if base is None else base)
    axes = list(base) + [None] * (len(shape) - len(base))
    best = None
    for i, d in enumerate(shape):
        if axes[i] is None and d % dp == 0 and d >= dp and (best is None or d > shape[best]):
            best = i
    if best is not None:
        axes[best] = DATA_AXIS
    return tuple(axes)


def p3_zero1_grad_spec(name: str, shape, dp: int, base=None) -> tuple:
    """The gradient's layout at the update (``:149-170``): the moment's, the
    pipe axis dropped (a stage's gradients are its own rows already)."""
    return tuple(None if a == PIPE_AXIS else a
                 for a in p3_zero1_moment_spec(name, shape, dp, base))


def zero1_dims(stage, dp: int) -> dict:
    """For each local leaf of a 3-D stage (its TP slices, one layer each),
    the dimension its moments are split along over the data group, or None:
    :func:`p3_zero1_moment_spec` on the leaf (the free dimensions keep their
    global width on the rank, the layer dimension is the pipe's)."""
    dims = {}
    for name, p in stage.named_parameters():
        spec = tp_spec_for(name, embed=False)
        base = [None] * p.dim()
        if spec is not None:
            base[spec[0]] = MODEL_AXIS
        axes = p3_zero1_moment_spec(name, tuple(p.shape), dp, tuple(base))
        dims[name] = axes.index(DATA_AXIS) if DATA_AXIS in axes else None
    return dims


@torch.no_grad()
def shard_3d_state(state, mesh: dict, zero1_dp: bool = False, v: int = 1):
    """A replicated TrainState (the same seeded weights on every rank) as
    this rank's 3-D state: its TP slices (``shard_tp_state``, the head split,
    the embedding whole), its stage (``pipeline_state``), and with
    ``zero1_dp`` its data-group block of every moment along
    :func:`zero1_dims` (the stage keeps the dims as ``stage.zero1``)."""
    tp_state = shard_tp_state(state, mesh[MODEL_AXIS], vocab_parallel="head")
    st = pipeline_state(tp_state, mesh[PIPE_AXIS], v)
    st.model.zero1 = None
    if zero1_dp:
        data = mesh[DATA_AXIS]
        dims = zero1_dims(st.model, data.world)
        for tree in moment_trees(st.momentum, st.params):
            for name, dim in dims.items():
                if dim is not None and data.world > 1:
                    tree[name] = block_of(tree[name], dim, data.rank, data.world)
        st.model.zero1 = dims if data.world > 1 else None
    return st


def zero1_update(data, dims: dict, config):
    """The update of a ZeRO-1 × 3-D stage: per leaf, this rank's block of
    the parameter and gradient along ``dims`` through the optimizer with its
    moment blocks (one call, one K7 launch, a leaf; a leaf without a dim
    whole), then every updated block all-gathered back into its parameter
    in one collective (each leaf is the ranks' blocks concatenated along its
    dim, as ``gspmd.gather_dim`` makes it)."""
    update = update_fn_for_config(config)

    def run(params, momentum, grads, config, step):
        trees = moment_trees(momentum, params)
        pending = []
        for name, p in params.items():
            dim = dims[name] if data.world > 1 else None
            moms = [{name: t[name]} for t in trees]
            mom = moms[0] if len(moms) == 1 else dict(zip(momentum, moms))
            if dim is None:
                update({name: p}, mom, {name: grads[name]}, config, step=step)
                continue
            block = block_of(p.detach(), dim, data.rank, data.world)
            g = block_of(grads[name], dim, data.rank, data.world)
            update({name: block}, mom, {name: g}, config, step=step)
            pending.append((p, dim, block))
        if pending:
            sizes = [b.numel() for _, _, b in pending]
            every = data.all_gather_flat(torch.cat([b.reshape(-1) for _, _, b in pending]))
            rows = [row.split(sizes) for row in every.view(data.world, -1)]
            with torch.no_grad():
                for i, (p, dim, b) in enumerate(pending):
                    p.copy_(torch.cat([row[i].view(b.shape) for row in rows], dim))
        return params, momentum

    return run


def gather_zero1_moments(state, data) -> list:
    """The moment trees of a ZeRO-1 × 3-D stage with every split moment
    gathered whole over the data group (a plain 3-D stage's: as they are)."""
    dims = getattr(state.model, "zero1", None)
    trees = moment_trees(state.momentum, state.params)
    if not dims or data.world == 1:
        return trees
    return [{n: (gather_dim(t[n], dims[n], data) if dims[n] is not None else t[n])
             for n in t} for t in trees]


def make_3d_lm_train_step(model, mesh: dict, num_microbatches: int, zero1_dp: bool = False):
    """``step(state, tokens_mb, targets_mb) -> (state, loss)`` over the
    mesh (state from :func:`shard_3d_state` with the same ``zero1_dp``,
    inputs from :func:`shard_3d_batch`): GPipe over the pipe group, TP
    inside every stage, the gradient mean over the data group.  ``model``
    is the global model (the checks read it)."""
    if model.attn_impl not in ("dense", "flash"):
        raise ValueError("3-D step supports attn_impl dense/flash/auto (sequence-sharded "
                         "impls have no axis here)")
    pp, tp = mesh[PIPE_AXIS].world, mesh[MODEL_AXIS].world
    if model.n_layers % pp:
        raise ValueError(f"n_layers={model.n_layers} must divide into {pp} pipeline stages")
    if model.n_heads % tp:
        raise ValueError(f"n_heads={model.n_heads} must be divisible by the model-axis "
                         f"size {tp}")
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")
    inner = make_pipeline_step(model, mesh[PIPE_AXIS], num_microbatches,
                               gpipe_table(num_microbatches, pp), data=mesh[DATA_AXIS])

    def step(state, tokens_mb, targets_mb):
        if bool(getattr(state.model, "zero1", None)) != (zero1_dp and mesh[DATA_AXIS].world > 1):
            raise ValueError(f"the state was placed with zero1_dp={not zero1_dp}; pass the "
                             "same flag to shard_3d_state and make_3d_lm_train_step")
        return inner(state, tokens_mb, targets_mb)

    step.waits = inner.waits
    return step


def shard_3d_batch(data, tokens_mb, targets_mb):
    """This data rank's rows of each microbatch of ``[M, mb, L]`` stacks
    (microbatch and sequence dims whole)."""
    dp = data.world
    mb = tokens_mb.shape[1]
    if mb % dp:
        raise ValueError(f"microbatch size {mb} must be divisible by the {dp}-device data "
                         "axis (global batch = microbatches × mb; pick a batch divisible by "
                         "microbatches × dp)")
    rows = slice(data.rank * mb // dp, (data.rank + 1) * mb // dp)
    return tokens_mb[:, rows], targets_mb[:, rows]
