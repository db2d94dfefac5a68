"""Pipeline parallelism: GPipe over a pipe group of ranks, one process each.

Counterpart of ``distributed_machine_learning_tpu/parallel/pipeline.py``.
The reference stacks the transformer blocks along a leading layer axis,
shards that axis over a ``pipe`` mesh axis and runs one SPMD tick loop in
which every device applies its span and ``ppermute``s the activation one
hop; ``jax.grad`` of the loop is the reverse pipeline.  Here every rank is
a process holding its stage (:class:`PipelineStage`): its layers, and the
boundary modules (embedding, ``ln_f``, head) whole, as the reference keeps
them replicated.  A step runs a schedule's table of ticks
(:func:`run_pipeline`): in each tick a rank runs at most one forward
sub-step (a microbatch through its span; the first stage embeds, the last
takes the loss) and one backward sub-step (``torch.autograd.backward`` of a
saved microbatch's span output with the gradient from downstream), then
posts all its sends and receives of the tick together
(``Comm.exchange``).  The activations travel in the compute dtype; stages
form a chain (the reference's wasted last-to-first hop is dropped), except
where the interleaved schedule's layer order wraps around.

GPipe (this module's table): all forwards, then all backwards in the
reverse order of the ticks, so a stage holds every microbatch's graph:
O(M) activation memory.  1F1B (``parallel/pipeline_1f1b.py``) and the
interleaved schedule (``parallel/pipeline_interleaved.py``) share the
engine and the step (:func:`make_pipeline_step`).

After the backward, the boundary modules' gradients (non-zero on the stage
that used them) and the loss (the last stage's) are summed over the pipe
group (:func:`pp_grads_and_update`), then optionally averaged over a data
group (the 3-D step), and the optimizer runs on every local leaf (one K7
launch a leaf with ``--fused-update``).  ``overlap_update`` (GPipe's
``--overlap-update``) instead updates each stage's 1/P slice of the flat
boundary vector and all-gathers the slices back while the stage's blocks
update (:func:`sharded_boundary_update`): bit for bit the sync update.

Layouts: the pipeline checkpoint stacks every block leaf to ``[n_layers,
...]`` under ``blocks.<leaf>`` (:func:`stack_lm_params`), in layer order
("pp-contiguous"), or in the interleaved order (its tag).  Stage s of P
holds stacked rows ``s·n/P ..`` (contiguous spans, or its interleaved
chunks).
"""

from __future__ import annotations

import threading
import time

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_machine_learning_tpu_torch.models.transformer import (
    embed_tokens,
    head_logits,
    rope_tables,
)
from distributed_machine_learning_tpu_torch.parallel.gspmd import moment_trees
from distributed_machine_learning_tpu_torch.runtime.distributed import (
    mean_over_ranks_,
    sum_over_ranks_,
)
from distributed_machine_learning_tpu_torch.train.losses import lm_cross_entropy
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config
from distributed_machine_learning_tpu_torch.train.state import TrainState

CONTIGUOUS = "pp-contiguous"
BOUNDARY = ("embed", "ln_f", "lm_head")
FWD, BWD = 0, 1  # message tags: activations downstream, gradients upstream


def _is_block(name: str) -> bool:
    return name.startswith("blocks.")


def stack_lm_params(params: dict, n_layers: int, order=None) -> dict:
    """Per-layer parameters by state_dict name (``blocks.<i>.<leaf>``) → the
    pipeline layout: each block leaf stacked to ``[n_layers, ...]`` under
    ``blocks.<leaf>``, rows in ``order`` (default: layer order); the
    boundary leaves as they are."""
    order = list(range(n_layers)) if order is None else list(order)
    out: dict = {}
    for name, t in params.items():
        if not _is_block(name):
            out[name] = t
            continue
        layer, leaf = name.split(".", 2)[1:]
        if layer == "0":
            out[f"blocks.{leaf}"] = torch.stack([params[f"blocks.{i}.{leaf}"] for i in order])
    return out


def unstack_lm_params(params: dict, n_layers: int, order=None) -> dict:
    """The inverse of :func:`stack_lm_params` (eval, serving, checks)."""
    order = list(range(n_layers)) if order is None else list(order)
    out: dict = {}
    for name, t in params.items():
        if not _is_block(name):
            out[name] = t
            continue
        leaf = name.split(".", 1)[1]
        for pos, layer in enumerate(order):
            out[f"blocks.{layer}.{leaf}"] = t[pos]
    return dict(sorted(out.items(), key=lambda kv: _name_key(kv[0])))


def _name_key(name: str):
    """The model's parameter order: embed, blocks by layer, ln_f, lm_head."""
    head = name.split(".")[0]
    rank = {"embed": 0, "blocks": 1, "ln_f": 2, "lm_head": 3}.get(head, 4)
    layer = int(name.split(".")[1]) if head == "blocks" and name.split(".")[1].isdigit() else 0
    return rank, layer


def _reject_lars(config) -> None:
    """The reference's guard of every pipeline schedule: a stage holds only
    its layers, so LARS's per-leaf norms would change with the stage count."""
    if type(config).__name__ == "LARSConfig":
        raise ValueError("LARS is not supported under pipeline/3-D parallelism: per-leaf "
                         "weight/grad norms would be computed on per-stage slices; use sgd "
                         "or adamw (elementwise updates are exact on any slice)")


def check_pipeline(model, num_stages: int, num_microbatches: int):
    """The reference's checks of ``make_pipeline_step`` (``:452-467``)."""
    if model.attn_impl not in ("dense", "flash"):
        raise ValueError("pipeline step supports attn_impl='dense' or 'flash' (the pipe-axis "
                         "shard_map is fully manual, so the flash kernel runs on local "
                         "shapes); sequence-sharded impls need a second mesh axis")
    if model.n_layers % num_stages:
        raise ValueError(f"n_layers={model.n_layers} must divide evenly into {num_stages} "
                         "pipeline stages")
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")


def stage_layers(n_layers: int, num_stages: int, stage: int, v: int = 1) -> list:
    """The global layers of ``stage`` in its local (stacked) order: its
    contiguous span (v = 1), or its v interleaved chunks, chunk-major."""
    from distributed_machine_learning_tpu_torch.parallel.pipeline_interleaved import (
        _interleaved_order,
    )

    per = n_layers // num_stages
    return _interleaved_order(n_layers, num_stages, v)[stage * per:(stage + 1) * per]


class PipelineStage(nn.Module):
    """One rank's stage of a :class:`TransformerLM` (possibly a TP rank's
    local-width model): the embedding, ``ln_f`` and the head whole, and the
    blocks of ``layer_ids`` (global layers, in local order, in ``chunks``
    equal chunks).  Takes the model's modules (no copy)."""

    def __init__(self, model, layer_ids: list, chunks: int = 1):
        super().__init__()
        for attr in ("compute_dtype", "tp_comm", "vocab_parallel", "head_dim", "remat_block",
                     "attn_impl", "n_layers", "d_model", "vocab_size", "config", "n_heads"):
            setattr(self, attr, getattr(model, attr))
        self.embed = model.embed
        self.blocks = nn.ModuleList(model.blocks[i] for i in layer_ids)
        self.ln_f = model.ln_f
        self.lm_head = model.lm_head
        self.layer_ids = list(layer_ids)
        self.chunks = chunks

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def global_name(self, name: str) -> str:
        """A local parameter name → the model's (``blocks.<j>`` → the global
        layer)."""
        if not _is_block(name):
            return name
        _, j, leaf = name.split(".", 2)
        return f"blocks.{self.layer_ids[int(j)]}.{leaf}"

    def span(self, x, positions, rope, chunk: int = 0):
        """Chunk ``chunk`` of the stage's layers over ``x``."""
        per = len(self.blocks) // self.chunks
        for block in self.blocks[chunk * per:(chunk + 1) * per]:
            if self.remat_block:
                x = checkpoint(block, x, positions, rope, use_reentrant=False)
            else:
                x = block(x, positions, rope)
        return x

    def loss(self, x, targets):
        """The mean cross-entropy of the head on the last span's output (the
        vocabulary-parallel loss when the head is split)."""
        logits = head_logits(self, self.ln_f(x))
        if self.vocab_parallel is not None:
            from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
                vocab_parallel_cross_entropy,
            )

            return vocab_parallel_cross_entropy(logits, targets, self.tp_comm)
        return lm_cross_entropy(logits, targets)


@torch.no_grad()
def pipeline_state(state, pipe, v: int = 1) -> TrainState:
    """A replicated TrainState (or a TP rank's, ``shard_tp_state``) as this
    pipe rank's stage: a new TrainState over its :class:`PipelineStage`
    (its layers, the boundary modules), with the moments of those leaves."""
    _reject_lars(state.config)
    model = state.model
    stage = PipelineStage(model, stage_layers(model.n_layers, pipe.world, pipe.rank, v), v)
    names = [stage.global_name(n) for n, _ in stage.named_parameters()]
    local = [n for n, _ in stage.named_parameters()]
    trees = [{ln: t[gn] for ln, gn in zip(local, names)}
             for t in moment_trees(state.momentum, state.params)]
    momentum = trees[0] if len(trees) == 1 else dict(zip(state.momentum, trees))
    return TrainState(model=stage, momentum=momentum, step=state.step, config=state.config)


# -- the schedule engine ------------------------------------------------------
def gpipe_table(M: int, P: int, v: int = 1) -> list:
    """Per stage, the ticks' ``(forward, backward)`` items, each ``(m, k)``
    (microbatch m through virtual stage k = c·P + s, chunk c of stage s) or
    None: the reference's interleaved decomposition of the forward ticks
    (``u = t − s``: i = u mod P, c = (u div P) mod v, g = u div (v·P),
    m = g·P + i; v = 1 is GPipe), then every backward in the reverse order of
    the ticks, as ``jax.grad`` of the tick loop runs them."""
    groups = -(-M // P)
    T = v * groups * P + P - 1
    table = []
    for s in range(P):
        fwd = []
        for t in range(T):
            u = t - s
            item = None
            if 0 <= u < v * groups * P:
                m = (u // (v * P)) * P + u % P
                if m < M:
                    item = (m, ((u // P) % v) * P + s)
            fwd.append(item)
        table.append([(f, None) for f in fwd] + [(None, b) for b in reversed(fwd)])
    return table


def _send_items(table: list, P: int, K: int, s: int, t: int):
    """The messages rank ``s`` receives at tick ``t``: ``(key, src, tag)``
    from every rank's items of the tick (every rank reads the whole table)."""
    out = []
    for d in range(P):
        if d == s:
            continue
        f, b = table[d][t]
        if f is not None and f[1] < K - 1 and (f[1] + 1) % P == s:
            out.append(((f[0], f[1] + 1), d, FWD))
        if b is not None and b[1] > 0 and (b[1] - 1) % P == s:
            out.append(((b[0], b[1] - 1), d, BWD))
    return out


def run_pipeline(stage: PipelineStage, pipe, table: list, tokens_mb, targets_mb,
                 waits: list | None = None) -> torch.Tensor:
    """Run ``table`` (:func:`gpipe_table`'s form) on this rank's stage: the
    forward and backward sub-steps of each tick, then the tick's messages.
    Leaves the stage's gradients summed over the microbatches on its
    parameters; returns the f32 loss (the mean over the microbatches, on the
    last stage; 0 elsewhere).  ``waits``: the host seconds of each tick's
    exchange are appended."""
    P, s = pipe.world, pipe.rank
    v = stage.chunks
    K = P * v
    M, mb, L = tokens_mb.shape
    shape, dtype = (mb, L, stage.d_model), stage.compute_dtype
    positions = torch.arange(L, device=tokens_mb.device)
    rope = rope_tables(positions, stage.head_dim)
    inbox: dict = {}  # (m, k) -> activation (FWD) or its gradient (BWD)
    saved: dict = {}  # (m, k) -> (span input, span output or loss)
    loss = torch.zeros((), dtype=torch.float32, device=tokens_mb.device)
    for t in range(len(table[s])):
        f, b = table[s][t]
        sends = []
        if f is not None:
            m, k = f
            if k == 0:
                x = embed_tokens(stage, tokens_mb[m])
            else:
                x = inbox.pop((FWD, m, k)).requires_grad_()
            y = stage.span(x, positions, rope, k // P)
            if k == K - 1:
                y = stage.loss(y, targets_mb[m])
                loss += y.detach()
            else:
                sends.append((y.detach(), (k + 1) % P, FWD, (m, k + 1)))
            saved[(m, k)] = (x, y)
        if b is not None:
            m, k = b
            x, y = saved.pop((m, k))
            if k == K - 1:
                (y / M).backward()
            else:
                torch.autograd.backward(y, inbox.pop((BWD, m, k)))
            if k > 0:
                sends.append((x.grad, (k - 1) % P, BWD, (m, k - 1)))
        remote = []
        for payload, dst, tag, key in sends:
            if dst == s:
                inbox[(tag, *key)] = payload.detach()
            else:
                remote.append((payload, dst, tag))
        recvs = _send_items(table, P, K, s, t)
        if remote or recvs:
            t0 = time.perf_counter()
            got = pipe.exchange(remote, [(shape, dtype, src, tag) for _, src, tag in recvs])
            if waits is not None:
                waits.append(time.perf_counter() - t0)
            for (key, _, tag), x in zip(recvs, got):
                inbox[(tag, *key)] = x
    assert not saved and not inbox, "the schedule left microbatches unfinished"
    return loss / M


# -- the update ---------------------------------------------------------------
def _flat_boundary(tree: dict) -> list:
    return [n for n in tree if n.split(".")[0] in BOUNDARY]


def sharded_boundary_update(state, grads: dict, pipe, update) -> threading.Thread:
    """The reference's ``_sharded_boundary_update``: this stage updates its
    1/P slice of the flat (embed, ln_f, lm_head) parameter and moment
    vectors (one optimizer call: one K7 launch), then the updated slices
    are all-gathered back into every stage's leaves, on a thread the
    caller joins after the blocks' update (nothing else is collective
    meanwhile).  Bit for bit the replicated update: the same summed
    gradients, an elementwise rule on any slice, and a gather that moves
    data only.  The moments stay whole on every stage."""
    names = _flat_boundary(state.params)
    params = state.params
    trees = moment_trees(state.momentum, params)
    sizes = [params[n].numel() for n in names]
    n = sum(sizes)
    shard = -(-n // pipe.world)
    lo = pipe.rank * shard

    def part(vectors):
        flat = torch.cat([t.detach().reshape(-1) for t in vectors])
        flat = torch.nn.functional.pad(flat, (0, shard * pipe.world - n))
        return flat[lo:lo + shard].clone()

    p = part(params[x] for x in names)
    g = part(grads[x] for x in names)
    moms = [part(t[x] for x in names) for t in trees]
    mom_tree = ({"flat": moms[0]} if len(trees) == 1
                else {k: {"flat": m} for k, m in zip(state.momentum, moms)})
    update({"flat": p}, mom_tree, {"flat": g}, state.config, step=state.step)

    def gather():
        with torch.no_grad():
            for whole, dsts in ((p, [params[x] for x in names]),
                                *((m, [t[x] for x in names]) for m, t in zip(moms, trees))):
                flat = pipe.all_gather_flat(whole)[:n]
                for dst, src in zip(dsts, flat.split(sizes)):
                    dst.copy_(src.view_as(dst))

    thread = threading.Thread(target=gather, name="pp-boundary-gather")
    thread.start()
    return thread


def pp_grads_and_update(state, pipe, loss: torch.Tensor, data=None,
                        overlap_update: bool = False) -> torch.Tensor:
    """The shared back half of every schedule (the reference's
    ``pp_grads_and_update``): the boundary modules' gradients and the loss
    summed over the pipe group (each non-zero on one stage), every gradient
    and the loss averaged over ``data`` (the 3-D step's data group), then
    the update of every local leaf: the optimizer of the state's config, on
    the data group's blocks of a ZeRO-1 × 3-D stage
    (``parallel3d.zero1_update``), or with ``overlap_update`` the boundary
    leaves' sharded over the pipe group (:func:`sharded_boundary_update`).
    Returns the loss."""
    _reject_lars(state.config)
    params = state.params
    grads = {}
    for name, p in params.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[name] = p.grad
    sum_over_ranks_(pipe, [*(grads[n] for n in _flat_boundary(params)), loss])
    if data is not None:
        mean_over_ranks_(data, [*grads.values(), loss])
    update = update_fn_for_config(state.config)
    if getattr(state.model, "zero1", None):
        from distributed_machine_learning_tpu_torch.parallel.parallel3d import zero1_update

        update = zero1_update(data, state.model.zero1, state.config)
    if not overlap_update or pipe.world == 1:
        update(params, state.momentum, grads, state.config, step=state.step)
    else:
        thread = sharded_boundary_update(state, grads, pipe, update_fn_for_config(state.config))
        blocks = [n for n in params if _is_block(n)]
        trees = moment_trees(state.momentum, params)
        sub = [{n: t[n] for n in blocks} for t in trees]
        update({n: params[n] for n in blocks},
               sub[0] if len(sub) == 1 else dict(zip(state.momentum, sub)),
               {n: grads[n] for n in blocks}, state.config, step=state.step)
        thread.join()
    state.step += 1
    return loss


def make_pipeline_step(model, pipe, num_microbatches: int, table: list, data=None,
                       overlap_update: bool = False):
    """The shared pipeline step (the reference's ``make_pipeline_step``):
    ``step(state, tokens_mb, targets_mb) -> (state, loss)`` runs ``table``,
    then :func:`pp_grads_and_update`; ``step.waits`` holds each step's host
    seconds spent in the pipe exchange (the stage's wait on its
    neighbours and the wire)."""

    def step(state, tokens_mb, targets_mb):
        if tokens_mb.shape[0] != num_microbatches:
            raise ValueError(f"expected {num_microbatches} microbatches, got input shaped "
                             f"{tuple(tokens_mb.shape)} (use microbatch(tokens, targets, "
                             f"{num_microbatches}))")
        stage = state.model
        stage.zero_grad(set_to_none=True)
        waits: list = []
        loss = run_pipeline(stage, pipe, table, tokens_mb, targets_mb, waits)
        step.waits.append(sum(waits))
        loss = pp_grads_and_update(state, pipe, loss, data, overlap_update)
        return state, loss

    step.waits = []
    return step


def make_pp_lm_train_step(model, pipe, num_microbatches: int, overlap_update: bool = False):
    """The GPipe step over the pipe group ``pipe`` (state from
    :func:`init_pipeline_state`, inputs from :func:`microbatch`).
    ``overlap_update``: the boundary modules' update sharded over the pipe
    group (:func:`sharded_boundary_update`), bit for bit the sync one."""
    check_pipeline(model, pipe.world, num_microbatches)
    return make_pipeline_step(model, pipe, num_microbatches,
                              gpipe_table(num_microbatches, pipe.world),
                              overlap_update=overlap_update)


def init_pipeline_state(model, pipe, seed: int = 69143, config=None, v: int = 1) -> TrainState:
    """The seeded replicated state (``init_lm_state``), as this rank's stage."""
    from distributed_machine_learning_tpu_torch.train.lm_step import init_lm_state

    return pipeline_state(init_lm_state(model, seed=seed, config=config), pipe, v)


def microbatch(tokens, targets, num_microbatches: int):
    """[B, L] → [M, B/M, L] microbatch stacks."""
    B = tokens.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by num_microbatches={num_microbatches}")
    shape = (num_microbatches, B // num_microbatches, *tokens.shape[1:])
    return tokens.reshape(shape), targets.reshape(shape)


# -- the layouts' whole states --------------------------------------------------
def _whole_stage_tree(stage, tree: dict, pipe, tp=None, embed_split: bool = False) -> dict:
    """A stage's params-shaped dict (local names) as the pipeline layout's
    whole tree: TP slices gathered over ``tp``, each block leaf stacked over
    the stage's layers and gathered over ``pipe`` in stage order (which is
    the layout's row order).  CPU tensors.  Every rank must call it."""
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import gather_tp_tree

    if tp is not None:
        tree = gather_tp_tree(tree, tp, embed_split)
    out: dict = {}
    per = len(stage.blocks)
    for name, t in tree.items():
        if not _is_block(name):
            out[name] = t.detach().to("cpu", copy=True)
            continue
        _, j, leaf = name.split(".", 2)
        if j != "0":
            continue
        local = torch.stack([tree[f"blocks.{i}.{leaf}"].detach() for i in range(per)])
        whole = torch.cat(pipe.all_gather(local)) if pipe.world > 1 else local
        out[f"blocks.{leaf}"] = whole.to("cpu")
    return dict(sorted(out.items(), key=lambda kv: _name_key(kv[0])))


def gather_pipeline_state(state, pipe, tp=None, data=None):
    """The whole state in the pipeline layout (blocks stacked in the
    layout's row order, every leaf at full width; a ZeRO-1 × 3-D stage's
    moments gathered over ``data`` first) as a ``HostState`` of CPU tensors:
    what a pp or 3d run saves.  Every rank must call it."""
    from distributed_machine_learning_tpu_torch.parallel.parallel3d import (
        gather_zero1_moments,
    )
    from distributed_machine_learning_tpu_torch.train.checkpoint import HostState

    stage = state.model
    params = _whole_stage_tree(stage, dict(state.params), pipe, tp)
    trees = [_whole_stage_tree(stage, t, pipe, tp) for t in gather_zero1_moments(state, data)]
    momentum = trees[0] if len(trees) == 1 else dict(zip(state.momentum, trees))
    return HostState(params=params, momentum=momentum, batch_stats={}, step=int(state.step),
                     config=state.config)


@torch.no_grad()
def load_pipeline_state(state, host, pipe, tp=None, layout: str | None = CONTIGUOUS,
                        data=None):
    """A pipeline-layout ``HostState`` (a restored checkpoint; a per-layer
    one is stacked first, in ``layout``'s order) into this rank's stage, in
    place: its rows of every stacked leaf (its TP slices under ``tp``; a
    ZeRO-1 × 3-D stage's data-group blocks of the moments), the boundary
    leaves, the step counter."""
    from distributed_machine_learning_tpu_torch.parallel.gspmd import block_of
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        tp_shard_params,
    )

    stage = state.model
    dims = getattr(stage, "zero1", None)
    per = len(stage.blocks)

    def local(tree: dict) -> dict:
        if any(_is_block(n) and n.split(".")[1].isdigit() for n in tree):
            tree = stack_lm_params(tree, stage.n_layers, layout_order(layout, stage.n_layers))
        out = {}
        for name in state.params:
            if _is_block(name):
                _, j, leaf = name.split(".", 2)
                out[name] = tree[f"blocks.{leaf}"][pipe.rank * per + int(j)]
            else:
                out[name] = tree[name]
        if tp is not None:
            out = tp_shard_params(out, tp.world, tp.rank, embed=False)
        return out

    for name, t in local(host.params).items():
        state.params[name].copy_(t)
    for mine, saved in zip(moment_trees(state.momentum, state.params),
                           moment_trees(host.momentum, host.params)):
        for name, t in local(saved).items():
            if dims and dims[name] is not None:
                t = block_of(t, dims[name], data.rank, data.world)
            mine[name].copy_(t)
    state.step = int(host.step)
    return state


def layout_order(layout: str | None, n_layers: int):
    """The stacked row order a layout tag names (None: not a pipeline
    layout): layer order for "pp-contiguous", the interleaved order for an
    interleaved tag (which raises if it does not parse)."""
    from distributed_machine_learning_tpu_torch.parallel.pipeline_interleaved import (
        _interleaved_order,
        parse_interleaved_layout,
    )

    inter = parse_interleaved_layout(layout)
    if inter is not None:
        return _interleaved_order(n_layers, *inter)
    return list(range(n_layers)) if layout == CONTIGUOUS else None
