"""ZeRO-3 / FSDP sharded data parallelism on one flat vector: the CNN and
LM steps.

Counterpart of ``distributed_machine_learning_tpu/parallel/fsdp.py``
(``FSDPState``, ``flatten_padded``, ``flat_mean_grad_shard``,
``shard_fsdp_state``, ``gather_fsdp_params``, ``make_fsdp_train_step``,
``make_fsdp_lm_train_step``, ``fsdp_memory_footprint``).  Every rank owns
a 1/W slice of the flattened f32 parameter vector and of each momentum
vector (each its own contiguous tensor), and a train step

  1. all-gathers the parameter shards into the full vector
     (:meth:`Comm.all_gather_flat`) and makes the model's parameters views
     of it,
  2. runs forward and backward on the full parameters (this rank's rows of
     the global batch),
  3. flattens and pads the gradients, reduce-scatters them
     (:meth:`Comm.reduce_scatter`) and divides by W, so the rank holds the
     mean gradient of the slice it owns (:func:`flat_mean_grad_shard`,
     shared with ZeRO-1 in ``parallel/zero1.py``),
  4. updates its shard alone through ``update_fn_for_config``: with
     ``AdamWConfig(fused=True)`` one K7 launch a step on the flat shard,

and the loss (and the CNN's BatchNorm statistics) are averaged over the
ranks.  Optimizer memory drops from 2·P to 2·P/W a rank, for the same
2·(W−1)/W·P bytes a step as a ring all-reduce.  ``overlap=True`` ends the
step at the updated shard and gathers it for the next step behind the
host's work between steps (``parallel/overlap.py``); the trajectory is bit
for bit the sync step's.

The flat order is the port's own: ``model.named_parameters()`` order,
each tensor row-major (torch's layout, e.g. ``nn.Linear``'s [out, in],
``nn.Conv2d``'s OIHW), padded with zeros to ``runtime.mesh.padded_len(n,
W)``.  The reference ravels its Flax tree in sorted-key order, so the two
flat vectors differ; compare parameter trees (:func:`gather_fsdp_params`),
never flat vectors.  The LM step takes dense attention only, as in the
reference (sequence-sharded attention needs a second mesh axis).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from distributed_machine_learning_tpu_torch.data.augment import augment_batch, normalize
from distributed_machine_learning_tpu_torch.runtime.distributed import mean_over_ranks_
from distributed_machine_learning_tpu_torch.runtime.mesh import padded_len
from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss
from distributed_machine_learning_tpu_torch.train.losses import cross_entropy_loss
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config
from distributed_machine_learning_tpu_torch.train.state import TrainState
from distributed_machine_learning_tpu_torch.train.step import SEED

FLAT = "flat"  # the one leaf name of the flat update's dicts


@dataclass
class FSDPState:
    """Sharded training state of this rank: its slice of the padded flat
    parameter vector (f32) and of the momentum (AdamW: ``{"mu": t, "nu":
    t}``, each flat like ``param_shard``; SGD: one flat tensor), the step
    counter (host int), the optimizer config, and BatchNorm's running
    statistics by name (replicated; the model's own buffers once a step has
    run; empty for the LM)."""

    param_shard: torch.Tensor
    momentum_shards: torch.Tensor | dict
    step: int
    config: object
    batch_stats: dict = field(default_factory=dict)


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
    flat, momentum flat (a dict for AdamW), unravel, n_elems)``, the front
    half every flat-shard scheme shares (ZeRO-1 and ZeRO-3).  Each moment
    ravels in the parameters' order, so index i of ``mu``/``nu`` is the
    moment of parameter element i."""
    params = state.params
    unravel = Unravel(state.model)
    padded = padded_len(unravel.n_elems, world)
    flat = _flat_pad(params.values(), padded)
    if isinstance(state.config, AdamWConfig):
        mom = {w: _flat_pad((state.momentum[w][k] for k in params), padded)
               for w in ("mu", "nu")}
    else:
        mom = _flat_pad((state.momentum[k] for k in params), padded)
        narrow = getattr(state.config, "momentum_dtype", None)
        if narrow:  # SGD's narrowed buffers stay narrow on the shard
            mom = mom.to(getattr(torch, narrow))
    return flat, mom, unravel, unravel.n_elems


def shard_flat(flat: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Block ``rank`` of W equal blocks of a flat vector, as its own
    contiguous, 16-byte-aligned tensor (what K7 takes)."""
    n = flat.numel() // world
    return flat[rank * n:(rank + 1) * n].clone()


def shard_moments(mom, rank: int, world: int):
    """Each flat momentum vector (one, or AdamW's dict) → this rank's block."""
    if isinstance(mom, dict):
        return {k: shard_flat(v, rank, world) for k, v in mom.items()}
    return shard_flat(mom, rank, world)


def refuse_lars(config, scheme: str) -> None:
    if type(config).__name__ == "LARSConfig":
        raise ValueError(f"{scheme} cannot shard LARS (per-layer norms are not "
                         "sliceable); use sgd or adamw")


def shard_fsdp_state(state: TrainState, comm):
    """A replicated TrainState (the same on every rank) → this rank's
    :class:`FSDPState`, with ``unravel`` (flat → parameters by name) and the
    unpadded parameter count ``n_elems``.  The model's own parameter storage
    is given up: from the first step on they are views of the gathered
    vector; BatchNorm's statistics stay the model's buffers."""
    refuse_lars(state.config, "ZeRO-3/FSDP")
    flat, mom, unravel, n_elems = flatten_padded(state, comm.world)
    r, w = comm.rank, comm.world
    fstate = FSDPState(param_shard=shard_flat(flat, r, w), momentum_shards=shard_moments(mom, r, w),
                       step=state.step, config=state.config, batch_stats=state.batch_stats)
    bind(state.model, unravel(flat))
    return fstate, unravel, n_elems


def bind(model, params: dict) -> None:
    """Make the model's parameters the given tensors' views (no copy)."""
    for name, p in model.named_parameters():
        p.data = params[name]


def adopt_batch_stats(model, stats: dict) -> None:
    """Install a flat state's BatchNorm statistics into the model's buffers
    and make the state hold the buffers themselves (after a restore or a
    rebind the state's tensors are its own)."""
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, t in stats.items():
            if t is not buffers[name]:
                buffers[name].copy_(t)
                stats[name] = buffers[name]


def gather_fsdp_params(fstate: FSDPState, unravel, n_elems: int, comm,
                       full: torch.Tensor | None = None) -> dict:
    """The full parameters by name (for eval, a checkpoint or a comparison):
    the shards all-gathered, or ``full`` when the caller holds the gathered
    vector already.  Every rank must call it (it is a collective)."""
    if full is None:
        full = comm.all_gather_flat(fstate.param_shard)
    return {k: v.clone() for k, v in unravel(full[:n_elems]).items()}


def flat_update(config, param_shard: torch.Tensor, momentum, grad_shard: torch.Tensor,
                step: int) -> None:
    """The optimizer's step on one flat shard, in place: one leaf (one K7
    launch under ``AdamWConfig(fused=True)``)."""
    moments = ({w: {FLAT: t} for w, t in momentum.items()} if isinstance(momentum, dict)
               else {FLAT: momentum})
    update_fn_for_config(config)({FLAT: param_shard}, moments, {FLAT: grad_shard}, config,
                                 step=step)


def _update(fstate: FSDPState, grad_shard: torch.Tensor) -> None:
    flat_update(fstate.config, fstate.param_shard, fstate.momentum_shards, grad_shard,
                fstate.step)
    fstate.step += 1


def cnn_inputs(images_u8, comm, step: int, augment: bool):
    """The CNN step's input: crop/flip from the generator of (SEED, rank,
    step) and normalize, as ``train/step.py`` draws them, or normalize only."""
    return augment_batch(images_u8, SEED, comm.rank, step) if augment else normalize(images_u8)


def flat_mean_grad_shard(model, comm, x, labels, padded: int):
    """The back half of the flat-shard schemes' step, one copy so ZeRO-1 and
    ZeRO-3 cannot drift apart: the loss and gradients on the full
    parameters (the model's), flattened and padded to ``padded``, the MEAN
    gradient reduce-scattered so this rank holds only the slice it owns;
    BatchNorm's moved statistics and the loss averaged over the ranks.
    Returns ``(loss, new_stats, grad_shard)`` (``new_stats`` not installed)."""
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(x, train=True), labels)
    loss.backward()
    flat_grads = _flat_pad((p.grad for p in model.parameters()), padded)
    model.zero_grad(set_to_none=True)
    grad_shard = comm.reduce_scatter(flat_grads).div_(comm.world)
    del flat_grads
    with torch.no_grad():
        stats = model.new_batch_stats()
        loss = loss.detach()
        mean_over_ranks_(comm, [*stats, loss])
    return loss, stats, grad_shard


def prefetch_step(comm, body, fetch, own):
    """The overlap protocol (``parallel/overlap.py``), one copy for the
    ZeRO-1 and ZeRO-3 steps.  ``body(state, full, x, y) -> (state, loss,
    shard)`` runs a step on the full parameter vector ``full`` and ends at
    the updated ``shard``, whose gather, dispatched on the background
    thread, is the next step's full vector.  That gather is for the state it
    was dispatched with as long as ``own(state)`` (the state's parameter
    tensor: ZeRO-3's shard, ZeRO-1's vector, None while its gather is in
    flight) is the same tensor at the same version; a step given any other
    state (the first step, a rebound or rewritten state: a prefetch miss)
    takes its full vector from ``fetch(state)``.  ``comm.gather_in_flight``
    is set from the dispatch to the join (a checkpoint save over that comm
    refuses).  The step carries ``pop_gather_seconds()`` (the train loop's
    ``param_gather_s``), ``join(state)`` (waits for the gather in flight and
    returns its full vector if it is ``state``'s, else None; call it before
    any other collective, and before the group is shut down) and
    ``close()``."""
    from distributed_machine_learning_tpu_torch.parallel.overlap import (
        GatherSpanClock,
        GatherThread,
    )

    gather, clock = GatherThread(comm), GatherSpanClock()
    sent: dict = {"key": None}  # (state, own(state), its version) at the dispatch

    def key(state):
        t = own(state)
        return state, t, None if t is None else t._version

    def join(state):
        full = clock.close()
        comm.gather_in_flight = False
        prev, sent["key"] = sent["key"], None
        now = key(state)
        hit = prev is not None and prev[0] is now[0] and prev[1] is now[1] and prev[2] == now[2]
        return full if hit else None

    def step(state, x, y):
        full = join(state)
        if full is None:  # prefetch miss: fetch now
            full = fetch(state)
        state, loss, shard = body(state, full, x, y)
        del full
        sent["key"] = key(state)
        comm.gather_in_flight = True
        clock.open(gather.submit(shard))
        return state, loss

    step.overlap = True
    step.join = join
    step.pop_gather_seconds = clock.pop
    step.close = gather.close
    return step


def _build(comm, body, overlap: bool):
    """ZeRO-3's step around ``body``: the full vector gathered from the
    state's shard, before the body (sync) or behind the host's work
    (``overlap``, :func:`prefetch_step`)."""
    def fetch(fstate: FSDPState):
        return comm.all_gather_flat(fstate.param_shard)

    if overlap:
        return prefetch_step(comm, body, fetch, lambda fstate: fstate.param_shard)

    def step(fstate: FSDPState, x, y):
        fstate, loss, _ = body(fstate, fetch(fstate), x, y)
        return fstate, loss

    return step


def make_fsdp_train_step(model, comm, unravel, n_elems: int, augment: bool = True,
                         overlap: bool = False):
    """ZeRO-3 for the VGG models: parameters and momentum sharded 1/W over
    ``comm``'s ranks, each rank its rows of the global batch; MEAN gradient
    semantics (the replicated step's, ``train/step.py``), BatchNorm's
    statistics averaged over the ranks (sync BN).  ``unravel``/``n_elems``
    come from :func:`shard_fsdp_state`.  Every rank must call the step each
    time.  ``overlap=True``: the prefetch protocol (see
    :func:`make_fsdp_lm_train_step`), bit for bit the sync step.

    Returns ``step(fstate, images_u8, labels) -> (fstate, loss)``: the state
    updated in place, the loss averaged over the ranks."""

    def body(fstate: FSDPState, full: torch.Tensor, images_u8, labels):
        bind(model, unravel(full[:n_elems]))
        adopt_batch_stats(model, fstate.batch_stats)
        x = cnn_inputs(images_u8, comm, fstate.step, augment)
        loss, stats, grad_shard = flat_mean_grad_shard(model, comm, x, labels, full.numel())
        _update(fstate, grad_shard)
        if stats:
            model.set_batch_stats(stats)
        return fstate, loss, fstate.param_shard

    return _build(comm, body, overlap)


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
        bind(model, unravel(full[:n_elems]))
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
        return fstate, loss, fstate.param_shard

    return _build(comm, body, overlap)


def fsdp_memory_footprint(n_params: int, n_dev: int, bytes_per_elem: int = 4) -> dict:
    """Optimizer-state bytes a rank: replicated data parallelism vs ZeRO-3
    shards (two moment vectors)."""
    replicated = 2 * n_params * bytes_per_elem
    sharded = 2 * padded_len(n_params, n_dev) // n_dev * bytes_per_elem
    return {"replicated": replicated, "fsdp": sharded}
