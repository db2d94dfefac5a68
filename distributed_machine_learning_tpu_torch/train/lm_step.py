"""The LM train step, dynamic loss scaling, batch sharding and the eval step.

Counterpart of ``distributed_machine_learning_tpu/train/lm_step.py``:
forward, mean next-token cross-entropy, backward, the optimizer from the
state's config, the step counter.  With a ``comm`` of W ranks the step is
the reference's ``make_lm_train_step(model, mesh=...)`` over a (batch,
seq) mesh of (W, 1) (``--parallel dp``: each rank its rows) or (1, W)
(``--parallel ring`` or ``ulysses``: each rank its sequence chunk, the
model's attention a ring or two all-to-alls over ``comm``): after the backward the gradients and the loss are
averaged over the ranks (the reference's ``pmean``), so every rank applies
the same update to the same parameters.  The reference compiles this into one donated program; here it
runs eagerly and updates the state in place, so ``step(state, tokens,
targets)`` returns the same state object and the loss tensor (the caller
syncs on it).  The gradients stay on the parameters (``p.grad``) until
the next step clears them.  ``fused_ce_chunks`` fuses the head and the
loss (``ops/fused_ce.py``): the [B, L, vocab] logits are never
materialized.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from distributed_machine_learning_tpu_torch.convert import init_params
from distributed_machine_learning_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from distributed_machine_learning_tpu_torch.runtime.distributed import mean_over_ranks_
from distributed_machine_learning_tpu_torch.train.common import (
    guard_update,
    tree_all_finite,
)
from distributed_machine_learning_tpu_torch.train.losses import lm_cross_entropy
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config
from distributed_machine_learning_tpu_torch.train.state import TrainState

# Dynamic loss-scale clamps: the scale never collapses below 1 (an unscaled
# loss must always be representable) and never exceeds 2^24 (past that, f32
# gradient accumulation itself loses integer precision).
_MIN_SCALE = 1.0
_MAX_SCALE = 2.0**24


@dataclass
class DynamicScaleState:
    """A TrainState plus dynamic loss-scale bookkeeping (host values).

    The loss is multiplied by ``loss_scale`` before the backward pass and
    the gradients divided by it after; overflow (a non-finite gradient)
    skips the update and halves the scale, ``growth_interval`` consecutive
    good steps double it.  ``step``/``params``/``config`` delegate to the
    inner state, so drivers that read only those work on either."""

    inner: TrainState
    loss_scale: float
    good_steps: int
    growth_interval: int = 200

    @property
    def step(self) -> int:
        return self.inner.step


def with_dynamic_scale(state: TrainState, init_scale: float = 2.0**15,
                       growth_interval: int = 200) -> DynamicScaleState:
    """Wrap a TrainState for ``make_lm_train_step(dynamic_scale=True)``."""
    if init_scale < _MIN_SCALE or init_scale > _MAX_SCALE:
        raise ValueError(f"init_scale must be in [{_MIN_SCALE}, {_MAX_SCALE}], "
                         f"got {init_scale}")
    if growth_interval < 1:
        raise ValueError(f"growth_interval must be >= 1, got {growth_interval}")
    return DynamicScaleState(inner=state, loss_scale=float(init_scale),
                             good_steps=0, growth_interval=growth_interval)


def unwrap_dynamic_scale(state):
    """The plain TrainState inside (identity for an unwrapped state)."""
    return state.inner if isinstance(state, DynamicScaleState) else state


def lm_loss(model, tokens: torch.Tensor, targets: torch.Tensor,
            fused_ce_chunks: int | None = None) -> torch.Tensor:
    """The LM training loss, one definition for the replicated step below
    and the ZeRO-3 step (``parallel/fsdp.py``): mean next-token
    cross-entropy of the model's f32 logits (the parameters live in the
    model).  With ``fused_ce_chunks`` the model returns its post-``ln_f``
    hidden states and ``ops/fused_ce.py`` scans the vocab in that many
    chunks, the head's weights cast to the compute dtype as its projection
    casts them."""
    if not fused_ce_chunks:
        return lm_cross_entropy(model(tokens), targets)
    hidden = model(tokens, return_hidden=True)
    head, cd = model.lm_head, model.compute_dtype
    return fused_linear_cross_entropy(hidden.reshape(-1, hidden.shape[-1]),
                                      head.weight.to(cd), head.bias.to(cd),
                                      targets.reshape(-1), fused_ce_chunks)


def _backward(model, loss: torch.Tensor, comm) -> tuple[dict, torch.Tensor]:
    """Gradients of ``loss`` on the parameters, by name (the previous step's
    are cleared first), and the detached loss; with ``comm`` both are
    averaged over its ranks in place (every rank reaches this call)."""
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    loss = loss.detach()
    if comm is not None:
        mean_over_ranks_(comm, [*grads.values(), loss])
    return grads, loss


def _apply_update(state: TrainState, grads: dict) -> None:
    update_fn_for_config(state.config)(state.params, state.momentum, grads,
                                       state.config, step=state.step)
    state.step += 1


def _lm_step_impl(model, state: TrainState, tokens, targets, *, guard: bool, comm,
                  fused_ce_chunks: int | None = None):
    grads, loss = _backward(model, lm_loss(model, tokens, targets, fused_ce_chunks), comm)
    if guard:
        # Non-finite gradients skip the update wholesale (step counter
        # included); the non-finite loss still returns so the host sees it.
        # Decided on the averaged gradients: every rank decides the same.
        guard_update(tree_all_finite(grads), state, partial(_apply_update, grads=grads))
    else:
        _apply_update(state, grads)
    return state, loss


def _lm_scaled_step_impl(model, sstate: DynamicScaleState, tokens, targets, *, comm,
                         fused_ce_chunks: int | None = None):
    """The dynamic-loss-scaled step (guard always on; gradients unscaled
    after the mean over the ranks, as the reference)."""
    scale = sstate.loss_scale
    loss = lm_loss(model, tokens, targets, fused_ce_chunks)
    grads, scaled_loss = _backward(model, loss * scale, comm)
    for g in grads.values():
        g.div_(scale)
    finite = guard_update(tree_all_finite(grads), sstate.inner,
                          partial(_apply_update, grads=grads))
    grown = sstate.good_steps + 1 >= sstate.growth_interval
    if finite:
        sstate.loss_scale = min(scale * 2.0, _MAX_SCALE) if grown else scale
        sstate.good_steps = 0 if grown else sstate.good_steps + 1
    else:
        sstate.loss_scale = max(scale * 0.5, _MIN_SCALE)
        sstate.good_steps = 0
    # The unscaled loss (non-finite on overflow steps, which is how the
    # host observes the backoff).
    return sstate, scaled_loss / scale


def make_lm_train_step(model, comm=None, guard_nonfinite: bool = False,
                       dynamic_scale: bool = False, fused_ce_chunks: int | None = None):
    """Build ``step(state, tokens, targets) -> (state, loss)``.

    Without ``comm`` (or at world 1): one device, the reference's no-mesh
    case.  With a ``comm`` of W ranks: each rank passes its shard of the
    global batch (:func:`shard_lm_batch`) and every rank must call the step
    each time; gradients and loss are averaged over the ranks before the
    update.  A dense or flash model shards the batch (dp); a ring or
    Ulysses model the sequence, over the same ``comm``.

    ``guard_nonfinite``: a non-finite gradient skips the update (state and
    step counter unchanged).  ``dynamic_scale``: dynamic loss scaling
    (implies the guard); the step then takes a :class:`DynamicScaleState`
    (:func:`with_dynamic_scale`).  ``fused_ce_chunks``: the fused head+loss
    (:func:`lm_loss`)."""
    if comm is not None and comm.world == 1:
        comm = None
    if dynamic_scale:
        return partial(_lm_scaled_step_impl, model, comm=comm,
                       fused_ce_chunks=fused_ce_chunks)
    return partial(_lm_step_impl, model, guard=guard_nonfinite, comm=comm,
                   fused_ce_chunks=fused_ce_chunks)


def shard_lm_batch(tokens, targets, rank: int, world: int, axis: str):
    """This rank's part of a global [B, L] batch (numpy arrays or tensors):
    rows ``[r·B/W, (r+1)·B/W)`` for ``axis="batch"`` (dp, fsdp), columns
    ``[r·L/W, (r+1)·L/W)`` for ``axis="seq"`` (ring, ulysses), as the reference's
    ``shard_lm_batch`` places them on a (batch, seq) mesh of (W, 1) or
    (1, W).  Every rank draws the same global batch from the seed."""
    dim = {"batch": 0, "seq": 1}[axis]
    n = tokens.shape[dim]
    if n % world:
        raise ValueError(f"{axis} length {n} is not divisible by {world} ranks")
    part = slice(rank * n // world, (rank + 1) * n // world)
    index = (part,) if dim == 0 else (slice(None), part)
    return tokens[index], targets[index]


def make_lm_eval_step(model):
    """LM eval: ``(params, tokens, targets) -> (nll_sum, count)``, the sum of
    per-token negative log-likelihoods (f32 tensor) and the token count, so
    callers pool exact corpus perplexity.  Runs dense attention, as the
    reference clones its model to dense: a parameterless dense twin on the
    meta device, called with ``params``."""
    dense = model if model.attn_impl == "dense" else model.clone(
        attn_impl="dense", device="meta")

    @torch.no_grad()
    def eval_step(params, tokens, targets):
        logits = torch.func.functional_call(dense, params, (tokens,))
        nll = lm_cross_entropy(logits, targets) * targets.numel()
        return nll, targets.numel()

    return eval_step


def init_lm_state(model, seed: int = 69143, config=None) -> TrainState:
    """Fresh f32 weights for ``model`` from ``seed`` (``convert.init_params``,
    a ``torch.Generator``: not the reference's Flax init) and a TrainState
    with zero moments; ``config`` defaults to ``AdamWConfig()``."""
    init_params(model, seed=seed)
    return TrainState.create(model, config)
