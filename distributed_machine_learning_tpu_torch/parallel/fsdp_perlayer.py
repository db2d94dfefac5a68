"""Per-layer FSDP: ZeRO-3 with each leaf gathered at its use.

Counterpart of ``distributed_machine_learning_tpu/parallel/fsdp_perlayer.py``
(``fsdp_pl_spec_for``, ``shard_fsdp_pl_state``,
``make_fsdp_pl_lm_train_step``, ``fsdp_pl_sharded_fraction``).  The flat
scheme (``parallel/fsdp.py``) gathers the whole parameter vector before the
forward and keeps it, and a full gradient vector, through the step.  Here
every leaf is split 1/W along its largest W-divisible dimension
(:func:`fsdp_pl_spec_for`, the reference's rule; leaves with no such
dimension stay replicated) and the train step

1. gathers a layer's leaves when the layer runs (:class:`gspmd.GatherLeaf`:
   the embedding before the forward, each block's attention half at the
   block's entry, its LN2+MLP half at the MLP's entry, ``ln_f`` and the
   head at ``ln_f``), and drops them when the next part starts;
2. keeps none of them for the backward: a saved tensor that is a gathered
   weight (or a view of one) is stored as a recipe and gathered again when
   the backward needs it (``saved_tensors_hooks``), so the gathered
   parameters resident at any time are O(one layer), as the reference's
   use-site gathers are (its ``:20-27``);
3. reduce-scatters each split leaf's gradient to the rank's block in the
   backward (mean over the ranks' rows) and averages the replicated
   leaves' gradients and the loss over the ranks;
4. runs the optimizer per leaf on the rank's blocks: one K7 launch a leaf
   a step under ``AdamWConfig(fused=True)``.

The port's ``nn.Linear`` weights are [out, in] where Flax's kernels are
[in, out], so the rule may pick the transposed dimension of a leaf; every
leaf is gathered whole before use, so nothing computed changes, and the
fraction of elements split is the reference's.  Attention is dense, flash
(K1 forward, K2/K3 backward) or auto, each rank on its rows.  The gathers
run where the layer needs them, synchronously: no prefetch of layer i+1
under layer i yet.
"""

from __future__ import annotations

import weakref

import torch
from torch import nn

from distributed_machine_learning_tpu_torch.parallel.gspmd import (
    GatherLeaf,
    block_of,
    gather_dim,
    make_cached_sharded_step,
    moment_trees,
    shard_state,
)
from distributed_machine_learning_tpu_torch.runtime.distributed import mean_over_ranks_
from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config

ATTN_IMPLS = ("dense", "flash", "auto")


def fsdp_pl_spec_for(n: int):
    """The shape-keyed ZeRO-3 rule: each leaf split along its largest
    n-divisible dimension (ties: the first), or None (replicated) when no
    dimension divides; the reference's exact rule (``:81-91``)."""

    def spec_for(name, shape):
        del name
        best = None
        for i, d in enumerate(shape):
            if d % n == 0 and d >= n and (best is None or d > shape[best]):
                best = i
        return best

    return spec_for


class _Regather:
    """A saved gathered weight, stored as the recipe that makes it again."""

    __slots__ = ("name", "dtype", "size", "stride", "offset")

    def __init__(self, name, dtype, size, stride, offset):
        self.name, self.dtype = name, dtype
        self.size, self.stride, self.offset = size, stride, offset


class PerLayerLayout:
    """A sharded model's per-layer layout: each leaf's split dimension and
    full shape, the groups of leaves gathered together, and the forward
    hooks and saved-tensor hooks of the step (active only inside it)."""

    def __init__(self, model, comm, dims: dict, full_shapes: dict):
        self.comm, self.dims, self.full_shapes = comm, dims, full_shapes
        self.params = dict(model.named_parameters())
        self.owners, self.cast = {}, {}
        for mod_name, mod in model.named_modules():
            for attr, _ in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{attr}" if mod_name else attr
                self.owners[name] = (mod, attr)
                # Linear leaves go in the compute dtype, as _project casts them.
                self.cast[name] = (model.compute_dtype if isinstance(mod, nn.Linear)
                                   else torch.float32)
        self.active = False
        self.held: list = []
        self.live: dict = {}  # storage address -> (weakref to the tensor, leaf name)
        if comm.world > 1:
            self._install(model)

    def _group(self, prefixes) -> list:
        return [n for n in self.params if n.startswith(prefixes) and self.dims[n] is not None]

    def _install(self, model) -> None:
        embed = self._group(("embed.",))
        model.register_forward_pre_hook(lambda m, a: self.enter(embed))
        for i, block in enumerate(model.blocks):
            attn = self._group((f"blocks.{i}.ln1.", f"blocks.{i}.attn."))
            mlp = self._group((f"blocks.{i}.ln2.", f"blocks.{i}.fc_in.", f"blocks.{i}.fc_out."))
            block.register_forward_pre_hook(lambda m, a, g=attn: self.enter(g))
            block.register_forward_hook(lambda m, a, out: self.release())
            block.mlp = self._wrap(block.mlp, mlp)  # an instance attribute: remat calls it too
        head = self._group(("ln_f.", "lm_head."))
        model.ln_f.register_forward_pre_hook(lambda m, a: self.enter(head))

    def _wrap(self, fn, group):
        def run(x):
            if not self.active:
                return fn(x)
            self.enter(group)
            try:
                return fn(x)
            finally:
                self.release()

        return run

    def enter(self, group) -> None:
        """Drop the leaves gathered so far and gather ``group``."""
        if not self.active:
            return
        self.release()
        for name in group:
            full = GatherLeaf.apply(self.params[name], self.dims[name], self.comm)
            t = full.to(self.cast[name])
            mod, attr = self.owners[name]
            mod.__dict__[attr] = t  # shadows the parameter (the rank's block) until released
            self.held.append((mod, attr))
            self.live[t.untyped_storage().data_ptr()] = (weakref.ref(t), name)

    def release(self) -> None:
        for mod, attr in self.held:
            mod.__dict__.pop(attr, None)
        self.held.clear()

    def pack(self, t: torch.Tensor):
        entry = self.live.get(t.untyped_storage().data_ptr())
        if entry is None or entry[0]() is None:
            return t
        return _Regather(entry[1], t.dtype, t.shape, t.stride(), t.storage_offset())

    def unpack(self, saved):
        if not isinstance(saved, _Regather):
            return saved
        name = saved.name
        full = gather_dim(self.params[name].detach(), self.dims[name], self.comm)
        return full.to(saved.dtype).as_strided(saved.size, saved.stride, saved.offset)

    def finish(self) -> None:
        self.active = False
        self.release()
        self.live.clear()


def layout_of(model) -> PerLayerLayout:
    layout = getattr(model, "fsdp_pl", None)
    if layout is None:
        raise ValueError("the model's state is not sharded: call shard_fsdp_pl_state first")
    return layout


def shard_fsdp_pl_state(state, comm):
    """A replicated TrainState (the same on every rank) in the per-layer
    layout, in place: each parameter's ``data`` and each moment become this
    rank's block of the leaf (its own contiguous tensor) per
    :func:`fsdp_pl_spec_for`; replicated leaves stay whole.  Returns the
    state."""
    if type(state.config).__name__ == "LARSConfig":
        raise ValueError("per-layer FSDP cannot shard LARS (per-layer norms need a "
                         "cross-shard reduction); use sgd or adamw")
    model = state.model
    full_shapes = {name: tuple(p.shape) for name, p in state.params.items()}
    spec_for = fsdp_pl_spec_for(comm.world)
    dims = (shard_state(state, comm, spec_for) if comm.world > 1
            else {name: spec_for(name, shape) for name, shape in full_shapes.items()})
    model.fsdp_pl = PerLayerLayout(model, comm, dims, full_shapes)
    return state


def fsdp_pl_sharded_fraction(state, world: int) -> float:
    """Fraction of parameter elements the rule splits over ``world`` ranks
    (biases of non-divisible width stay replicated); a diagnostic for
    tests and sizing."""
    layout = getattr(state.model, "fsdp_pl", None)
    shapes = (layout.full_shapes if layout is not None
              else {name: tuple(p.shape) for name, p in state.params.items()})
    rule = fsdp_pl_spec_for(world)
    total = split = 0
    for name, shape in shapes.items():
        size = 1
        for d in shape:
            size *= d
        total += size
        if rule(name, shape) is not None:
            split += size
    return split / max(total, 1)


def make_fsdp_pl_lm_train_step(model, comm, fused_ce_chunks: int | None = None):
    """The per-layer FSDP LM step (see the module docstring); the state
    comes from :func:`shard_fsdp_pl_state`, each rank passes its rows of the
    global batch (``shard_lm_batch(..., axis="batch")``) and every rank must
    call the step each time.  Returns ``step(state, tokens, targets) ->
    (state, loss)``: the state updated in place, the loss averaged over the
    ranks."""
    if model.attn_impl not in ATTN_IMPLS:
        raise ValueError("per-layer FSDP supports dense/flash/auto attention "
                         "(sequence-sharded ring/ulysses need a second mesh axis)")

    def build(state):
        layout = layout_of(model)
        update = update_fn_for_config(state.config)
        replicated = [n for n, d in layout.dims.items() if d is None or comm.world == 1]

        def step(state, tokens, targets):
            model.zero_grad(set_to_none=True)
            layout.active = True
            try:
                with torch.autograd.graph.saved_tensors_hooks(layout.pack, layout.unpack):
                    loss = lm_loss(model, tokens, targets, fused_ce_chunks)
                layout.release()
                loss.backward()
            finally:
                layout.finish()
            grads = {name: p.grad for name, p in model.named_parameters()}
            loss = loss.detach()
            mean_over_ranks_(comm, [*(grads[n] for n in replicated), loss])
            update(state.params, state.momentum, grads, state.config, step=state.step)
            state.step += 1
            return state, loss

        return step

    return make_cached_sharded_step(build)


def gather_fsdp_pl_params(state, comm) -> dict:
    """The full parameters by name (for eval or a comparison): every split
    leaf all-gathered.  Every rank must call it (collectives)."""
    dims = layout_of(state.model).dims
    with torch.no_grad():
        return {name: (gather_dim(p, dims[name], comm) if dims[name] is not None
                       and comm.world > 1 else p.detach().clone())
                for name, p in state.params.items()}


def gather_fsdp_pl_state(state, comm):
    """The whole state as a dp-layout ``HostState`` of CPU tensors (what
    ``save_checkpoint`` writes: the same files as a dp run's), gathered leaf
    by leaf.  Every rank must call it."""
    from distributed_machine_learning_tpu_torch.train.checkpoint import HostState

    dims = layout_of(state.model).dims
    split = comm.world > 1

    def whole(name, t):
        with torch.no_grad():
            full = gather_dim(t, dims[name], comm) if split and dims[name] is not None else t
            return full.to("cpu", copy=True)

    params = {name: whole(name, p) for name, p in state.params.items()}
    trees = [{name: whole(name, tree[name]) for name in state.params}
             for tree in moment_trees(state.momentum, state.params)]
    momentum = trees[0] if len(trees) == 1 else dict(zip(state.momentum, trees))
    return HostState(params=params, momentum=momentum, batch_stats={}, step=int(state.step),
                     config=state.config)


@torch.no_grad()
def load_fsdp_pl_state(state, host):
    """A dp-layout ``HostState`` (a restored checkpoint) into a sharded
    state, in place: each leaf's and moment's block for this rank, the step
    counter.  Returns the state (its config is kept)."""
    layout = layout_of(state.model)
    comm, dims = layout.comm, layout.dims

    def put(dst, src, name):
        if tuple(src.shape) != layout.full_shapes[name]:
            raise ValueError(f"leaf {name}: checkpoint shape {tuple(src.shape)} != "
                             f"the model's {layout.full_shapes[name]}")
        if comm.world > 1 and dims[name] is not None:
            src = block_of(src, dims[name], comm.rank, comm.world)
        dst.copy_(src)

    for name, p in state.params.items():
        put(p, host.params[name], name)
    for mine, saved in zip(moment_trees(state.momentum, state.params),
                           moment_trees(host.momentum, host.params)):
        for name in state.params:
            put(mine[name], saved[name], name)
    state.step = int(host.step)
    return state
