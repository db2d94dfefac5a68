"""Expert parallelism for the MoE transformer: the state layout and the
train steps.

Counterpart of ``distributed_machine_learning_tpu/parallel/expert_parallel.py``.
The reference declares the expert leaves (``w_in``/``b_in``/``w_out``/
``b_out`` of every ``MoEMLP``, leading ``[n_experts, ...]`` axis) sharded
over its mesh's ``expert`` axis and everything else replicated, then jits
the step: GSPMD for the einsum dispatch, a manual ``shard_map`` for the
grouped one.  Here every rank is a process of a mesh of Comms
(``runtime/distributed.mesh_comms``): the model is built with its expert
Comm and token Comms (``models/moe.py``), :func:`shard_ep_state` keeps this
rank's block of each expert leaf and its moments (``parallel/gspmd.py``),
and the steps below sync the gradients.

- :func:`make_ep_train_step`: the einsum step over a (batch, expert) mesh.
  The batch shards over ``batch``; the activations are whole on every
  expert rank, which computes its own experts for them (capacity of the
  global batch) and sums the combine over the expert ranks.  The gradients
  and the loss are averaged over the data ranks: the reference's GSPMD
  program, which equals the one-device step.  Without a mesh: the
  one-device step.
- :func:`make_ep_grouped_train_step`: the dropless grouped step over a
  (batch, expert) or (batch, expert, seq) mesh.  The batch shards over
  data × expert and, with ``seq_axis``, the sequence over ``seq`` (ring or
  Ulysses attention over it: MoE × context parallelism); token rows reach
  their experts through an all-to-all.  Every rank's loss is its local
  cross-entropy plus the aux loss (global statistics, added once on every
  rank); the expert leaves' gradients are summed over the non-expert axes
  only (the cross terms on the expert axis arrive through the all-to-all's
  backward), every other leaf's over all of them, and both are divided by
  ``n_total``, the product of all mesh axes (reference ``:244-249``).

A checkpoint holds the plain layout (:func:`gather_ep_state`: the expert
leaves gathered whole), which ``cli.generate --moe --ckpt-dir`` serves and
:func:`load_ep_state` slices again on resume.
"""

from __future__ import annotations

import math

import torch

from distributed_machine_learning_tpu_torch.models.moe import SEQ_LOCAL_ATTN_IMPLS
from distributed_machine_learning_tpu_torch.models.transformer import SEQ_SHARDED
from distributed_machine_learning_tpu_torch.parallel.gspmd import (
    block_of,
    gather_dim,
    gathered_host_state,
    load_host_state,
    shard_state,
)
from distributed_machine_learning_tpu_torch.runtime.distributed import (
    mean_over_ranks_,
    sum_over_ranks_,
)
from distributed_machine_learning_tpu_torch.train.lm_step import init_lm_state
from distributed_machine_learning_tpu_torch.train.losses import lm_cross_entropy
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config

_EXPERT_PARAMS = {"w_in", "b_in", "w_out", "b_out"}


def is_expert_path(name: str) -> bool:
    """An expert-owned leaf (the reference's ``_is_expert_path``): a
    ``w_in``/``b_in``/``w_out``/``b_out`` of an ``moe`` module."""
    module, _, leaf = name.rpartition(".")
    return leaf in _EXPERT_PARAMS and "moe" in module.split(".")


def ep_spec_for(name: str, shape: tuple) -> int | None:
    """The reference's ``ep_spec_for`` as a ``gspmd`` rule: expert leaves
    split along their leading (expert) axis, the rest whole."""
    return 0 if is_expert_path(name) else None


def shard_ep_state(state, expert_comm) -> dict:
    """Leave this rank its experts' block of every expert leaf and of its
    moments, in place (``gspmd.shard_state``); returns the specs."""
    return shard_state(state, expert_comm, ep_spec_for)


def init_moe_state(model, seed: int = 69143, config=None):
    """Fresh weights and a TrainState for an MoE model, as ``init_lm_state``."""
    return init_lm_state(model, seed=seed, config=config)


def moe_loss(model, tokens: torch.Tensor, targets: torch.Tensor):
    """``(ce + aux_loss_weight · Σ aux, ce)`` of one forward: the mean
    next-token cross-entropy and each layer's Switch aux loss (reference
    ``_moe_step_impl``)."""
    ce = lm_cross_entropy(model(tokens), targets)
    aux = sum(model.aux_losses(), torch.zeros((), device=ce.device))
    return ce + model.aux_loss_weight * aux, ce


def _backward_and_update(state, tokens, targets, sync):
    """Forward, backward, ``sync(grads, ce)`` (in place), the optimizer."""
    model = state.model
    model.zero_grad(set_to_none=True)
    loss, ce = moe_loss(model, tokens, targets)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    ce = ce.detach()
    sync(grads, ce)
    update_fn_for_config(state.config)(state.params, state.momentum, grads, state.config,
                                       step=state.step)
    state.step += 1
    return state, ce


def make_ep_train_step(model, mesh: dict | None = None):
    """The einsum EP(+DP) step ``step(state, tokens, targets) -> (state,
    ce)``.  Without a mesh: the one-device step (any ``moe_impl``).  With a
    mesh ``{"batch": Comm, "expert": Comm}``: ``model`` is built with
    ``expert_comm=mesh["expert"]`` and ``token_comms=(mesh["batch"],)``, its
    state sharded by :func:`shard_ep_state`, and each rank passes its data
    rank's rows (:func:`shard_ep_batch`)."""
    if model.attn_impl not in SEQ_LOCAL_ATTN_IMPLS:
        raise ValueError(
            "expert-parallel step requires a sequence-LOCAL attention (dense/flash/auto): "
            "the sequence is not sharded here, so the ring/ulysses impls have no axis to "
            "run over")
    if mesh is None:
        return lambda state, x, y: _backward_and_update(state, x, y, lambda g, c: None)
    if model.moe_impl != "einsum":
        raise ValueError(
            "the expert-sharded GSPMD step requires moe_impl='einsum' "
            f"(got {model.moe_impl!r}): the dispatch/combine einsums are what XLA "
            "partitions into the all-to-all; the grouped ragged_dot path does not shard "
            "over the expert axis")
    ep = mesh["expert"].world
    if model.n_experts % ep:
        raise ValueError(f"n_experts={model.n_experts} must be divisible by the "
                         f"expert-axis size {ep}")
    data = mesh["batch"]

    def sync(grads, ce):
        # Every leaf's gradient is whole on each expert rank (the expert
        # leaves its own block's): the mean over the data ranks.
        mean_over_ranks_(data, [*grads.values(), ce])

    return lambda state, x, y: _backward_and_update(state, x, y, sync)


def make_ep_grouped_train_step(model, mesh: dict, world, seq_axis: str | None = None):
    """The dropless grouped EP step over ``mesh`` (``{"batch", "expert"}`` and,
    with ``seq_axis``, ``"seq"``: Comms of this rank's mesh axes), ``world``
    the Comm of all its ranks.  ``model`` is built with
    ``expert_comm=mesh["expert"]``, every mesh Comm in ``token_comms`` and,
    under ``seq_axis``, ``comm=mesh["seq"]`` (its ring or Ulysses attention);
    each rank passes its rows and chunk (:func:`shard_ep_batch`).  Returns
    ``step(state, tokens, targets) -> (state, ce)``, ce averaged over every
    rank (reference ``make_ep_grouped_train_step``); ``step.world`` is
    ``world``."""
    if model.moe_impl != "grouped":
        raise ValueError(
            "make_ep_grouped_train_step requires moe_impl='grouped' "
            f"(got {model.moe_impl!r}); use make_ep_train_step for the einsum path")
    if seq_axis is None:
        if model.attn_impl not in SEQ_LOCAL_ATTN_IMPLS:
            raise ValueError(
                f"sequence-sharded attention ({model.attn_impl!r}) requires seq_axis= "
                "(the MoE x context-parallel layout)")
        axes = ("batch", "expert")
    else:
        axes = ("batch", "expert", seq_axis)
        sp = mesh[seq_axis].world
        if model.attn_impl not in SEQ_SHARDED and sp > 1:
            raise ValueError(
                f"attn_impl={model.attn_impl!r} cannot shard the sequence: axis "
                f"{seq_axis!r} has size {sp}; use ring/ring_flash/ulysses or a "
                "seq-axis size of 1")
        if model.attn_impl == "ulysses" and model.n_heads % sp:
            raise ValueError(f"Ulysses needs n_heads divisible by the seq-axis size: "
                             f"{model.n_heads} heads over {sp}")
    ep = mesh["expert"].world
    if model.n_experts % ep:
        raise ValueError(f"n_experts={model.n_experts} must be divisible by the "
                         f"expert-axis size {ep}")
    n_total = math.prod(mesh[a].world for a in axes)
    others = [mesh[a] for a in axes if a != "expert"]

    def sync(grads, ce):
        # ∂(Σ_ranks loss_rank)/∂θ summed, then / n_total: the loss is the
        # mean over the ranks.  An expert leaf sums over the non-expert axes
        # only (its block differs along the expert axis).
        expert = [g for name, g in grads.items() if is_expert_path(name)]
        rest = [g for name, g in grads.items() if not is_expert_path(name)]
        sum_over_ranks_(world, rest)
        for c in others:
            sum_over_ranks_(c, expert)
        for g in grads.values():
            g.div_(n_total)
        mean_over_ranks_(world, [ce])

    def step(state, x, y):
        return _backward_and_update(state, x, y, sync)

    step.world = world  # the Comm of the sums over every rank
    return step


def shard_ep_batch(tokens, targets, mesh: dict, grouped: bool, seq_axis: str | None = None):
    """This rank's part of a global [B, L] batch: the rows of its data rank
    (einsum: ``P("batch", None)``), or of its (data, expert) pair, data
    major, and under ``seq_axis`` its chunk of the sequence (grouped:
    ``P(("batch", "expert"), seq)``)."""
    data, expert = mesh["batch"], mesh["expert"]
    shards, index = data.world, data.rank
    if grouped:
        shards, index = shards * expert.world, index * expert.world + expert.rank
    B = tokens.shape[0]
    if B % shards:
        raise ValueError(f"batch {B} is not divisible by {shards} row shards")
    rows = slice(index * B // shards, (index + 1) * B // shards)
    tokens, targets = tokens[rows], targets[rows]
    if seq_axis is not None:
        c = mesh[seq_axis]
        L = tokens.shape[1]
        cols = slice(c.rank * L // c.world, (c.rank + 1) * L // c.world)
        tokens, targets = tokens[:, cols], targets[:, cols]
    return tokens, targets


def gather_ep_tree(tree: dict, expert_comm, to_cpu: bool = False) -> dict:
    """The whole leaves of a params-shaped dict of this rank's blocks: each
    expert leaf all-gathered over ``expert_comm`` along its expert axis
    (``to_cpu`` on a host wire: gathered on the host, not back through the
    card).  Every rank must call it."""
    host = to_cpu and expert_comm.wire in ("host", "gloo")
    out = {}
    with torch.no_grad():
        for name, t in tree.items():
            t = t.detach().cpu() if host else t.detach()
            whole = gather_dim(t, 0, expert_comm) if is_expert_path(name) else t.clone()
            out[name] = whole.to("cpu") if to_cpu else whole
    return out


def gather_ep_params(state, expert_comm) -> dict:
    """The full parameters by name (the plain layout)."""
    return gather_ep_tree(state.params, expert_comm)


def gather_ep_state(state, expert_comm):
    """The whole state as a plain-layout ``HostState`` of CPU tensors (what
    an ep run saves).  Every rank must call it."""
    return gathered_host_state(state, lambda t: gather_ep_tree(t, expert_comm, to_cpu=True))


def load_ep_state(state, host, expert_comm):
    """A plain-layout ``HostState`` (a restored checkpoint) into an EP state,
    in place: this rank's block of every expert leaf and moment, the other
    leaves whole, the step counter."""
    return load_host_state(state, host, lambda name, t: (
        block_of(t, 0, expert_comm.rank, expert_comm.world) if is_expert_path(name) else t))
