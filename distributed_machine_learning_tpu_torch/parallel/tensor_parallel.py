"""Tensor parallelism: the Megatron layout, one process per rank.

Counterpart of ``distributed_machine_learning_tpu/parallel/tensor_parallel.py``.
The reference declares where each leaf lives (``tp_spec_for``) and lets
XLA's partitioner insert the collectives; here each rank is a process
holding its slice of the weights, and the model places the collectives
itself (``models/transformer.py``: Megatron's f and g, the vocabulary-split
embedding and head).

Training (``tp_spec_for``, ``shard_tp_state``, ``make_tp_lm_train_step``,
``shard_tp_batch``): every rank holds

- column-parallel (``qkv``, ``q``, ``kv``, ``fc_in``): its block of heads
  (of ``d_ff``) of the output features, weight and bias; a fused
  projection's parts (q/k/v, k/v) sliced each on its own, so the local
  layout is the fused one at H/tp;
- row-parallel (``out``, ``fc_out``): its block of the input features, the
  bias whole (added once after the sum);
- the embedding and the head: its block of the vocabulary (rows of both;
  the loss is :func:`vocab_parallel_cross_entropy`, so the [B, L, V]
  logits never exist on one rank); under the 3-D step the embedding stays
  whole, as the reference's ``p3_param_spec`` keeps it;
- the LayerNorms whole.

Each rank's AdamW runs per local leaf (one K7 launch a leaf with
``--fused-update``), LARS with each split leaf's norms summed over the
ranks (:func:`split_leaf_norm`: the whole leaf's trust ratio, as the
reference's); attention runs on the rank's H/tp heads and Hkv/tp KV heads
(K1-K3 under flash).

Decode (``tp_decode_params``, ``tp_local_decode_clone``, ``tp_local_model``;
the reference's ``tp_decode_spec_for``, ``tp_decode_params`` and
``inference/generate.py``'s ``tp_local_decode_clone``; ``cli.generate --tp
N`` spawns the ranks):

- column-parallel (``qkv``, ``q``, ``kv``, ``fc_in``; each expert's
  ``w_in``/``b_in``) as in training;
- row-parallel (``out``, ``fc_out``; each expert's ``w_out``): this rank's
  block of the input features, the bias divided by tp (the model's sum over
  the ranks adds it back), an int8 projection's per-output-channel scales
  whole (they commute with the sum);
- whole on every rank: the embedding, the LayerNorms, the head and the MoE
  router (every rank routes alike).

Int8 weights are quantized from the global model before they are sliced,
so each rank's scales are the global ones.
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.parallel.gspmd import (
    gathered_host_state,
    load_host_state,
    moment_trees,
)
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config
from distributed_machine_learning_tpu_torch.train.state import TrainState

ATTN_IMPLS = ("dense", "flash", "auto")

# Column-parallel projections: module name → the parts a fused output
# feature axis holds (each part is H·D, or d_ff, features).
_COLUMN = {"qkv": 3, "q": 1, "kv": 2, "fc_in": 1}
_ROW = ("out", "fc_out")


def check_tp_layout(model, tp: int) -> None:
    """The reference's divisibility rules of the Megatron decode layout."""
    if model.n_heads % tp:
        raise ValueError(f"n_heads={model.n_heads} must be divisible by tp={tp}")
    n_kv = model.config["n_kv_heads"]
    if n_kv is not None and n_kv % tp:
        raise ValueError(f"n_kv_heads={n_kv} must be divisible by tp={tp}")
    if model.d_ff % tp:
        raise ValueError(f"d_ff={model.d_ff} must be divisible by tp={tp}")


def _block(t: torch.Tensor, dim: int, parts: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim``, viewed as ``parts``
    equal parts each cut into ``tp`` blocks (block ``rank`` of every part,
    concatenated in part order)."""
    n = t.shape[dim]
    shape = (*t.shape[:dim], parts, tp, n // (parts * tp), *t.shape[dim + 1:])
    return t.reshape(shape).select(dim + 1, rank).flatten(dim, dim + 1).contiguous()


def tp_decode_params(state_dict: dict, tp: int, rank: int) -> dict:
    """Rank ``rank``'s local state_dict of a float or int8 (dense or MoE)
    model's ``state_dict`` under the layout of the module note."""
    out = {}
    for key, t in state_dict.items():
        module, _, leaf = key.rpartition(".")
        name = module.rpartition(".")[2]
        if name in _COLUMN:
            parts = _COLUMN[name]
            # weight [out, in]; w_q [in, out]; bias and scale [out].
            dim = 1 if leaf == "w_q" else 0
            out[key] = _block(t, dim, parts, tp, rank)
        elif name in _ROW:
            if leaf == "weight":  # [out, in]
                out[key] = _block(t, 1, 1, tp, rank)
            elif leaf == "w_q":  # [in, out]
                out[key] = _block(t, 0, 1, tp, rank)
            elif leaf == "bias":
                out[key] = t / tp
            else:  # the int8 scales, per output channel
                out[key] = t
        elif name == "moe" and leaf in ("w_in", "w_in_q"):  # [E, D, F]
            out[key] = _block(t, 2, 1, tp, rank)
        elif name == "moe" and leaf in ("b_in", "w_in_scale"):  # [E, F]
            out[key] = _block(t, 1, 1, tp, rank)
        elif name == "moe" and leaf in ("w_out", "w_out_q"):  # [E, F, D]
            out[key] = _block(t, 1, 1, tp, rank)
        elif name == "moe" and leaf == "b_out":
            out[key] = t / tp
        else:
            out[key] = t
    return out


def tp_local_decode_clone(model, comm, quantize: str | None):
    """``model``'s config at this rank's local width (heads, KV heads and
    ``d_ff`` ÷ tp, the global head width pinned, dense cached attention,
    ``tp_comm=comm``), with fresh weights, after the layout's checks."""
    tp = comm.world
    check_tp_layout(model, tp)
    n_kv = model.config["n_kv_heads"]
    return model.clone(n_heads=model.n_heads // tp,
                       n_kv_heads=None if n_kv is None else n_kv // tp,
                       d_ff=model.d_ff // tp, head_dim=model.head_dim,
                       attn_impl="dense", weight_quant=quantize, tp_comm=comm)


def tp_local_model(model, comm, quantize: str | None):
    """This rank's local-width decode model, its weights sliced from
    ``model`` (in its serving form: the int8 twin when ``quantize`` is
    "int8")."""
    from distributed_machine_learning_tpu_torch.inference.generate import (
        check_serving_form,
    )

    check_serving_form(model, quantize)
    local = tp_local_decode_clone(model, comm, quantize)
    local.load_state_dict(tp_decode_params(model.state_dict(), comm.world, comm.rank))
    dtype = next(model.parameters()).dtype  # weights stored in the compute dtype stay so
    return (local if dtype == torch.float32 else local.to(dtype)).eval()


# -- training -------------------------------------------------------------------
def tp_spec_for(name: str, embed: bool = True):
    """How the training layout splits the leaf ``name`` (a state_dict name)
    over the model axis: ``(dim, parts)`` (the leaf's ``dim``, viewed as
    ``parts`` equal parts each cut into tp blocks) or None (whole on every
    rank); the reference's ``tp_spec_for`` in the port's [out, in] layout.
    ``embed=False``: the embedding whole (the 3-D layout)."""
    module, _, leaf = name.rpartition(".")
    mod = module.rpartition(".")[2]
    if mod in _COLUMN:
        return 0, _COLUMN[mod]
    if mod in _ROW:
        return (1, 1) if leaf == "weight" else None
    if mod == "embed":
        return (0, 1) if embed else None
    if mod == "lm_head":
        return 0, 1
    return None


def _unblock(blocks: list, dim: int, parts: int) -> torch.Tensor:
    """The inverse of :func:`_block` over every rank's block, in rank order."""
    t0 = blocks[0]
    k = t0.shape[dim] // parts
    split = [b.reshape(*b.shape[:dim], parts, k, *b.shape[dim + 1:]) for b in blocks]
    whole = torch.stack(split, dim + 1)  # [..., parts, tp, k, ...]
    return whole.reshape(*t0.shape[:dim], parts * len(blocks) * k, *t0.shape[dim + 1:])


def tp_shard_params(tree: dict, tp: int, rank: int, embed: bool = True) -> dict:
    """Rank ``rank``'s slices of a params-shaped dict (parameters, moments)
    under :func:`tp_spec_for`, each a fresh contiguous tensor."""
    out = {}
    for name, t in tree.items():
        spec = tp_spec_for(name, embed)
        out[name] = t if spec is None else _block(t, spec[0], spec[1], tp, rank)
    return out


def check_tp_train(model, tp: int) -> None:
    """The reference's guards of the TP step (``:113-136``)."""
    if model.attn_impl not in ATTN_IMPLS:
        raise ValueError("tensor-parallel step supports dense/flash/auto attention; "
                         "ring attention composes with TP via the 3-D mesh step")
    if model.n_heads % tp:
        raise ValueError(f"n_heads={model.n_heads} must be divisible by the model-axis "
                         f"size {tp} (heads are sharded over 'model')")
    n_kv = model.config["n_kv_heads"]
    if n_kv is not None and n_kv % tp:
        raise ValueError(f"n_kv_heads={n_kv} must be divisible by the model-axis size "
                         f"{tp} (K/V heads are sharded over 'model')")


def tp_local_train_clone(model, comm, vocab_parallel: str = "both"):
    """``model``'s config at this rank's local width in the training layout
    (heads, KV heads and ``d_ff`` ÷ tp, the global head width pinned, the
    head and, under "both", the embedding split by vocabulary), with fresh
    weights."""
    tp = comm.world
    check_tp_train(model, tp)
    check_tp_layout(model, tp)
    n_kv = model.config["n_kv_heads"]
    return model.clone(n_heads=model.n_heads // tp,
                       n_kv_heads=None if n_kv is None else n_kv // tp,
                       d_ff=model.d_ff // tp, head_dim=model.head_dim, tp_comm=comm,
                       vocab_parallel=vocab_parallel)


@torch.no_grad()
def shard_tp_state(state, comm, vocab_parallel: str = "both") -> TrainState:
    """A replicated TrainState (the same seeded weights on every rank) in
    the training layout: a new TrainState over this rank's local-width
    model, its parameters and moments this rank's slices
    (:func:`tp_shard_params`), the step and config kept."""
    embed = vocab_parallel == "both"
    local = tp_local_train_clone(state.model, comm, vocab_parallel)
    local.load_state_dict(tp_shard_params(state.model.state_dict(), comm.world, comm.rank,
                                          embed))
    trees = [tp_shard_params(t, comm.world, comm.rank, embed)
             for t in moment_trees(state.momentum, state.params)]
    momentum = trees[0] if len(trees) == 1 else dict(zip(state.momentum, trees))
    return TrainState(model=local, momentum=momentum, step=state.step, config=state.config)


def gather_tp_tree(tree: dict, comm, embed: bool = True, to_cpu: bool = False) -> dict:
    """The whole leaves of a params-shaped dict of this rank's slices: each
    split leaf all-gathered over ``comm`` and reassembled.  Every rank must
    call it."""
    out = {}
    for name, t in tree.items():
        spec = tp_spec_for(name, embed)
        with torch.no_grad():
            whole = (t.detach().clone() if spec is None or comm.world == 1
                     else _unblock(comm.all_gather(t.detach()), *spec))
        out[name] = whole.to("cpu") if to_cpu else whole
    return out


def gather_tp_params(state, comm) -> dict:
    """The full parameters by name (a dp run's), gathered over ``comm``."""
    return gather_tp_tree(state.params, comm, state.model.vocab_parallel == "both")


def gather_tp_state(state, comm):
    """The whole state as a dp-layout ``HostState`` of CPU tensors (what a
    tp run saves: a dp run's files).  Every rank must call it."""
    embed = state.model.vocab_parallel == "both"
    return gathered_host_state(state, lambda t: gather_tp_tree(t, comm, embed, to_cpu=True))


def load_tp_state(state, host, comm):
    """A dp-layout ``HostState`` (a restored checkpoint) into a TP state, in
    place: this rank's slice of every leaf and moment, the step counter."""
    embed = state.model.vocab_parallel == "both"
    return load_host_state(state, host, lambda name, t: tp_shard_params(
        {name: t}, comm.world, comm.rank, embed)[name])


class _VocabParallelCE(torch.autograd.Function):
    """Mean cross-entropy of logits split by vocabulary over ``comm``: the
    row max, then the sum of exponentials and the target's logit (which
    only its owning rank holds) summed over the ranks; f32 throughout."""

    @staticmethod
    def forward(ctx, logits, targets, comm):
        rows = logits.shape[-1]
        start = comm.rank * rows
        m = comm.all_reduce_(logits.detach().amax(-1), "max")
        e = torch.exp(logits - m[:, None])
        local = targets - start
        inside = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        picked = (logits.gather(1, local[:, None])[:, 0] - m) * inside
        sums = comm.all_reduce_(torch.stack([e.sum(-1), picked]))
        ctx.save_for_backward(e, sums[0], local, inside)
        return (torch.log(sums[0]) - sums[1]).mean()

    @staticmethod
    def backward(ctx, grad):
        e, total, local, inside = ctx.saved_tensors
        g = e / total[:, None]
        g.scatter_add_(1, local[:, None], -inside.to(g.dtype)[:, None])
        return g * (grad / e.shape[0]), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 comm) -> torch.Tensor:
    """The mean next-token cross-entropy of this rank's vocabulary block of
    the f32 logits [..., V/tp] against global ``targets`` [...]: every rank
    gets the same loss, and the gradient of its own block."""
    return _VocabParallelCE.apply(logits.reshape(-1, logits.shape[-1]).float(),
                                  targets.reshape(-1), comm)


def tp_lm_loss(model, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The LM loss of a training-layout TP model (its head split by
    vocabulary)."""
    return vocab_parallel_cross_entropy(model(tokens), targets, model.tp_comm)


def make_tp_lm_train_step(model, comm):
    """The TP LM step (the reference's ``make_tp_lm_train_step`` on a (1, tp)
    mesh): ``model`` is the global model (the guards read it); the state
    comes from :func:`shard_tp_state` and every rank passes the whole batch
    (:func:`shard_tp_batch`).  Returns ``step(state, tokens, targets) ->
    (state, loss)``: forward over the local heads, the vocabulary-parallel
    loss, backward, and the optimizer on every local leaf, in place (the
    gradients stay on the parameters until the next step)."""
    check_tp_train(model, comm.world)

    def step(state, tokens, targets):
        local = state.model
        local.zero_grad(set_to_none=True)
        loss = tp_lm_loss(local, tokens, targets)
        loss.backward()
        grads = {name: p.grad for name, p in local.named_parameters()}
        extra = {}
        if type(state.config).__name__ == "LARSConfig":
            extra["norm"] = split_leaf_norm(comm, local.vocab_parallel == "both")
        update_fn_for_config(state.config)(state.params, state.momentum, grads, state.config,
                                           step=state.step, **extra)
        state.step += 1
        return state, loss.detach()

    return step


def split_leaf_norm(comm, embed: bool = True):
    """LARS's leaf norm under the training layout: a split leaf's squares
    summed over ``comm``'s ranks, so every rank scales its slice by the
    whole leaf's trust ratio (the reference's GSPMD step computes the norms
    of whole leaves); a whole leaf's own norm."""
    def norm(name, t):
        if tp_spec_for(name, embed) is None or comm.world == 1:
            return torch.linalg.vector_norm(t)
        return comm.all_reduce_(t.square().sum()).sqrt()

    return norm


def shard_tp_batch(tokens, targets):
    """Tokens/targets of the (1, tp) mesh: the whole batch on every rank,
    sequence whole (the reference's ``shard_tp_batch``)."""
    return tokens, targets
