"""ZeRO-3 / FSDP sharded data parallelism on one flat vector: the LM step.

Counterpart of the LM side of ``distributed_machine_learning_tpu/parallel/fsdp.py``
(``FSDPState``, ``flatten_padded``, ``shard_fsdp_state``,
``gather_fsdp_params``, ``make_fsdp_lm_train_step``,
``fsdp_memory_footprint``).  Every rank owns a 1/W slice of the flattened
f32 parameter vector and of each AdamW moment vector (each its own
contiguous tensor), and a train step

  1. all-gathers the parameter shards into the full vector
     (:meth:`Comm.all_gather_flat`) and makes the model's parameters views
     of it,
  2. runs forward and backward on the full parameters (this rank's rows of
     the global batch),
  3. flattens and pads the gradients, reduce-scatters them
     (:meth:`Comm.reduce_scatter`) and divides by W, so the rank holds the
     mean gradient of the slice it owns,
  4. updates its shard alone through ``update_fn_for_config``: with
     ``AdamWConfig(fused=True)`` one K7 launch a step on the flat shard,

and the loss is averaged over the ranks.  Optimizer memory drops from 2·P
to 2·P/W a rank, for the same 2·(W−1)/W·P bytes a step as a ring
all-reduce.  ``overlap=True`` ends the step at the updated shard and
gathers it for the next step behind the host's work between steps
(``parallel/overlap.py``); the trajectory is bit for bit the sync step's.

The flat order is the port's own: ``model.named_parameters()`` order,
each tensor row-major (torch's layout, e.g. ``nn.Linear``'s [out, in]),
padded with zeros to ``runtime.mesh.padded_len(n, W)``.  The reference
ravels its Flax tree in sorted-key order, so the two flat vectors differ;
compare parameter trees (:func:`gather_fsdp_params`), never flat vectors.
Dense attention only, as in the reference (sequence-sharded attention
needs a second mesh axis).  The CNN step (``make_fsdp_train_step``,
``flat_mean_grad_shard``) and ZeRO-1 are not ported (ROADMAP A5b).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from distributed_machine_learning_tpu_torch.runtime.mesh import padded_len
from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config
from distributed_machine_learning_tpu_torch.train.state import TrainState

FLAT = "flat"  # the one leaf name of the flat update's dicts


@dataclass
class FSDPState:
    """Sharded training state of this rank: its slice of the padded flat
    parameter vector (f32) and of the momentum (AdamW: ``{"mu": t, "nu":
    t}``, each flat like ``param_shard``; SGD: one flat tensor), the step
    counter (host int) and the optimizer config."""

    param_shard: torch.Tensor
    momentum_shards: torch.Tensor | dict
    step: int
    config: object


class Unravel:
    """Flat vector → the model's parameters by name, as views: the inverse
    of the flat order (``named_parameters()``, each tensor row-major)."""

    def __init__(self, model):
        self.layout = [(name, tuple(p.shape), p.numel()) for name, p in model.named_parameters()]
        self.n_elems = sum(n for _, _, n in self.layout)

    def __call__(self, flat: torch.Tensor) -> dict:
        out, off = {}, 0
        for name, shape, n in self.layout:
            out[name] = flat[off:off + n].view(shape)
            off += n
        return out


def _flat_pad(tensors, padded: int) -> torch.Tensor:
    """The tensors raveled in order into one zero-padded f32 vector."""
    tensors = list(tensors)
    flat = torch.zeros(padded, dtype=torch.float32, device=tensors[0].device)
    off = 0
    for t in tensors:
        flat[off:off + t.numel()] = t.detach().reshape(-1)
        off += t.numel()
    return flat


def flatten_padded(state: TrainState, world: int):
    """Params and momentum as W-divisible padded flat vectors: ``(param
    flat, momentum flat (a dict for AdamW), unravel, n_elems)``.  Each
    moment ravels in the parameters' order, so index i of ``mu``/``nu`` is
    the moment of parameter element i."""
    params = state.params
    unravel = Unravel(state.model)
    padded = padded_len(unravel.n_elems, world)
    flat = _flat_pad(params.values(), padded)
    if isinstance(state.config, AdamWConfig):
        mom = {w: _flat_pad((state.momentum[w][k] for k in params), padded)
               for w in ("mu", "nu")}
    else:
        mom = _flat_pad((state.momentum[k] for k in params), padded)
    return flat, mom, unravel, unravel.n_elems


def _shard(flat: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = flat.numel() // world
    return flat[rank * n:(rank + 1) * n].clone()  # its own contiguous, aligned tensor


def shard_fsdp_state(state: TrainState, comm):
    """A replicated TrainState (the same on every rank) → this rank's
    :class:`FSDPState`, with ``unravel`` (flat → parameters by name) and the
    unpadded parameter count ``n_elems``.  The model's own parameter storage
    is given up: from the first step on they are views of the gathered
    vector."""
    if type(state.config).__name__ == "LARSConfig":
        raise ValueError("ZeRO-3/FSDP cannot shard LARS (per-layer norms are not "
                         "sliceable); use sgd or adamw")
    flat, mom, unravel, n_elems = flatten_padded(state, comm.world)
    r, w = comm.rank, comm.world
    mom = ({k: _shard(v, r, w) for k, v in mom.items()} if isinstance(mom, dict)
           else _shard(mom, r, w))
    fstate = FSDPState(param_shard=_shard(flat, r, w), momentum_shards=mom, step=state.step,
                       config=state.config)
    _bind(state.model, unravel(flat))
    return fstate, unravel, n_elems


def _bind(model, params: dict) -> None:
    """Make the model's parameters the given tensors' views (no copy)."""
    for name, p in model.named_parameters():
        p.data = params[name]


def gather_fsdp_params(fstate: FSDPState, unravel, n_elems: int, comm,
                       full: torch.Tensor | None = None) -> dict:
    """The full parameters by name (for eval, a checkpoint or a comparison):
    the shards all-gathered, or ``full`` when the caller holds the gathered
    vector already.  Every rank must call it (it is a collective)."""
    if full is None:
        full = comm.all_gather_flat(fstate.param_shard)
    return {k: v.clone() for k, v in unravel(full[:n_elems]).items()}


def _update(fstate: FSDPState, grad_shard: torch.Tensor) -> None:
    """The optimizer's step on this rank's shard, in place: one leaf."""
    mom = fstate.momentum_shards
    moments = ({w: {FLAT: t} for w, t in mom.items()} if isinstance(mom, dict)
               else {FLAT: mom})
    update_fn_for_config(fstate.config)({FLAT: fstate.param_shard}, moments,
                                        {FLAT: grad_shard}, fstate.config, step=fstate.step)
    fstate.step += 1


def make_fsdp_lm_train_step(model, comm, unravel, n_elems: int,
                            fused_ce_chunks: int | None = None, overlap: bool = False):
    """ZeRO-3 for the transformer LM: parameters and optimizer state
    sharded 1/W over ``comm``'s ranks, the batch sharded over the same
    ranks (``shard_lm_batch(..., axis="batch")``).  Every rank must call the
    step each time.

    ``overlap=True``: the prefetch protocol (``parallel/overlap.py``): the
    step ends at the updated shard and dispatches the gather of the next
    step's parameters; a step whose state is not the one the in-flight
    gather was dispatched for (the first step, a rebound or rewritten
    state) gathers anew.  The step then has ``pop_gather_seconds()`` (the
    train loop's ``param_gather_s``) and ``join(state)`` (waits for the
    in-flight gather and returns its full vector if it is ``state``'s,
    else None; call it before any other collective, and before the group
    is shut down).

    Returns ``step(fstate, tokens, targets) -> (fstate, loss)``: the state
    updated in place, the loss averaged over the ranks."""
    if model.attn_impl != "dense":
        raise ValueError("FSDP LM step requires attn_impl='dense' (sequence-sharded "
                         "attention needs a second mesh axis)")
    world = comm.world

    def body(fstate: FSDPState, full: torch.Tensor, tokens, targets):
        _bind(model, unravel(full[:n_elems]))
        loss = lm_loss(model, tokens, targets, fused_ce_chunks)
        model.zero_grad(set_to_none=True)
        loss.backward()
        flat_grads = _flat_pad((p.grad for p in model.parameters()), full.numel())
        model.zero_grad(set_to_none=True)
        grad_shard = comm.reduce_scatter(flat_grads).div_(world)
        del flat_grads
        loss = loss.detach()
        if world > 1:
            comm.all_reduce_(loss).div_(world)
        _update(fstate, grad_shard)
        return fstate, loss

    if not overlap:
        def step(fstate: FSDPState, tokens, targets):
            return body(fstate, comm.all_gather_flat(fstate.param_shard), tokens, targets)

        return step

    from distributed_machine_learning_tpu_torch.parallel.overlap import (
        GatherSpanClock,
        GatherThread,
    )

    gather = GatherThread(comm)
    clock = GatherSpanClock()
    sent: dict = {"key": None}  # the shard (tensor, version) the gather in flight is of

    def key(fstate):
        shard = fstate.param_shard
        return shard, shard._version

    def join(fstate: FSDPState):
        full = clock.close()
        prev, sent["key"] = sent["key"], None
        hit = prev is not None and prev[0] is fstate.param_shard \
            and prev[1] == fstate.param_shard._version
        return full if hit else None

    def step(fstate: FSDPState, tokens, targets):
        full = join(fstate)
        if full is None:  # prefetch miss: gather now
            full = comm.all_gather_flat(fstate.param_shard)
        fstate, loss = body(fstate, full, tokens, targets)
        del full
        sent["key"] = key(fstate)
        clock.open(gather.submit(fstate.param_shard))
        return fstate, loss

    step.overlap = True
    step.join = join
    step.pop_gather_seconds = clock.pop
    step.close = gather.close
    return step


def fsdp_memory_footprint(n_params: int, n_dev: int, bytes_per_elem: int = 4) -> dict:
    """Optimizer-state bytes a rank: replicated data parallelism vs ZeRO-3
    shards (two moment vectors)."""
    replicated = 2 * n_params * bytes_per_elem
    sharded = 2 * padded_len(n_params, n_dev) // n_dev * bytes_per_elem
    return {"replicated": replicated, "fsdp": sharded}
