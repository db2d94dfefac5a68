"""Sort-based grouped expert MLP: the dropless MoE compute path.

Counterpart of ``distributed_machine_learning_tpu/ops/grouped.py``
(``sort_by_expert``, ``grouped_expert_mlp``).  Token rows are sorted by
their routed expert (a stable counting sort), each expert's contiguous
group goes through its two projections, and the rows are unsorted.  Every
token reaches its expert: there is no capacity and nothing drops.

The reference runs each projection as one ``lax.ragged_dot`` over the
groups, a plain matrix product that XLA compiles (no Pallas kernel).  Here
each non-empty group is one ``torch.matmul`` against its expert's weight,
so the group sizes come to the host once a call: one device sync per MoE
layer.  With int8 expert weights (``w_in_scale``/``w_out_scale`` given)
each used expert's int8 weight is widened to the compute dtype (exact)
for its product, and the per-expert per-output-channel scales multiply the
product's rows afterwards, as the reference applies them.

Expert parallelism (:func:`grouped_expert_mlp_ep`, the reference's
``grouped_expert_mlp_ep``): each rank of the expert Comm holds ``E / ep``
experts and its own token rows; the rows travel to their expert's owner in
one all-to-all (``ops/collectives.all_to_all``), are grouped there by local
expert and multiplied as above, and ride the inverse all-to-all home.
The slot scatter and gather are autograd nodes whose backwards are each
other (the reference's custom VJPs), never a scatter-add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from distributed_machine_learning_tpu_torch.ops.collectives import all_to_all


def sort_by_expert(expert_idx: torch.Tensor, n_experts: int):
    """``(order, inv_order, group_sizes)``: ``order`` sorts token rows so
    expert 0's come first (stable), ``inv_order`` undoes it, and
    ``group_sizes[e]`` counts expert e's tokens.  A counting sort, as the
    reference's: each token's rank within its expert (a cumulative sum of
    the routing one-hot) plus its group's base offset is its destination."""
    n = expert_idx.shape[0]
    onehot = F.one_hot(expert_idx.long(), n_experts)  # [N, E]
    ranks = torch.cumsum(onehot, dim=0)  # 1-based rank at the token's own expert
    group_sizes = ranks[-1] if n else onehot.sum(0)
    offsets = torch.cumsum(group_sizes, dim=0) - group_sizes  # exclusive prefix
    dest = offsets[expert_idx.long()] + (ranks * onehot).sum(1) - 1
    order = torch.empty_like(dest).scatter_(
        0, dest, torch.arange(n, device=dest.device))
    return order, dest, group_sizes


def _grouped_matmul(x: torch.Tensor, w: torch.Tensor, sizes: list) -> torch.Tensor:
    """Rows of ``x`` sorted into groups of ``sizes``; group e times
    ``w[e]`` (widened to ``x``'s dtype)."""
    outs = [part @ w[e].to(x.dtype)
            for e, part in enumerate(torch.split(x, sizes)) if sizes[e]]
    if not outs:  # no rows: still a product, so ``w`` gets its zero gradient
        return x @ w[0].to(x.dtype)
    return torch.cat(outs)


def grouped_expert_mlp(tokens: torch.Tensor, expert_idx: torch.Tensor,
                       w_in: torch.Tensor, b_in: torch.Tensor,
                       w_out: torch.Tensor, b_out: torch.Tensor, *,
                       activation=None, w_in_scale: torch.Tensor | None = None,
                       w_out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Dropless routed expert MLP over [N, D] token rows (already in the
    compute dtype); ``expert_idx`` [N]; weights carry the leading expert
    axis (``w_in`` [E, D, F], ``w_out`` [E, F, D]; int8 with scales [E, F]
    and [E, D] for int8 serving).  Returns [N, D] in ``tokens.dtype``; the
    caller applies the router-probability scale.  ``activation`` defaults
    to the tanh GELU."""
    act = activation or (lambda h: F.gelu(h, approximate="tanh"))
    order, inv_order, group_sizes = sort_by_expert(expert_idx, w_in.shape[0])
    sizes = group_sizes.tolist()  # the one host sync of the call
    xs = tokens[order]
    eids = expert_idx.long()[order]
    dt = tokens.dtype
    h = _grouped_matmul(xs, w_in, sizes)
    if w_in_scale is not None:
        h = h * w_in_scale[eids].to(dt)
    h = act(h + b_in.to(dt)[eids])
    ys = _grouped_matmul(h, w_out, sizes)
    if w_out_scale is not None:
        ys = ys * w_out_scale[eids].to(dt)
    ys = ys + b_out.to(dt)[eids]
    return ys[inv_order]


class _ScatterRows(torch.autograd.Function):
    """Rows of ``x`` set at slots ``idx`` of a zero [n_out, D] buffer.  The
    slots are unique but for the trash slot the caller slices away, so the
    exact gradient is the gather back by ``idx`` (reference
    ``_scatter_rows``)."""

    @staticmethod
    def forward(ctx, x, idx, n_out: int):
        ctx.save_for_backward(idx)
        return x.new_zeros((n_out, x.shape[1])).index_copy_(0, idx, x)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.index_select(0, idx), None, None


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` for slots ``idx`` of unique rows (the trash row aside):
    the exact gradient sets the rows back, unaddressed rows zero (reference
    ``_gather_rows``)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_in = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.new_zeros((ctx.n_in, g.shape[1])).index_copy_(0, idx, g), None


def grouped_expert_mlp_ep(tokens: torch.Tensor, expert_idx: torch.Tensor,
                          w_in: torch.Tensor, b_in: torch.Tensor,
                          w_out: torch.Tensor, b_out: torch.Tensor, *, comm,
                          n_experts_global: int, activation=None,
                          slots_per_owner: int | None = None,
                          return_dropped: bool = False):
    """Routed expert MLP under expert parallelism over ``comm``'s ranks.

    ``tokens`` [N_local, D] are this rank's rows (in the compute dtype),
    ``expert_idx`` [N_local] each row's GLOBAL expert; the weights hold this
    rank's ``E_local = n_experts_global / ep`` experts (rank r owns global
    experts ``[r·E_local, (r+1)·E_local)``).  Returns [N_local, D] in
    ``tokens.dtype`` (the caller applies the router scale) and, with
    ``return_dropped``, the count of this rank's dropped rows (int tensor).

    1. Slot: row i goes to owner ``o = expert // E_local`` at slot
       ``o·S + (its rank among the rows for o)``, S = ``slots_per_owner`` or
       N_local (a rank cannot send more than N_local rows to one owner:
       dropless).  A row past S is dropped: it goes to a trash slot past the
       buffer, gets zero output and zero gradient.
    2. One all-to-all: chunk o of the [ep·S, D] send buffer lands on rank o,
       the expert ids beside it (−1 marks an empty slot).
    3. The received rows counting-sort by local expert, empty slots last;
       one product an expert with rows (the group sizes read on the host).
    4. Unsort, the inverse all-to-all, the gather by the slot map.
    """
    act = activation or (lambda h: F.gelu(h, approximate="tanh"))
    ep = comm.world
    e_local = w_in.shape[0]
    if e_local * ep != n_experts_global:
        raise ValueError(f"local expert axis {e_local} x mesh axis {ep} != "
                         f"n_experts_global {n_experts_global}")
    n, d = tokens.shape
    if slots_per_owner is not None and not 1 <= slots_per_owner <= n:
        raise ValueError(f"slots_per_owner must be in [1, N_local={n}], got "
                         f"{slots_per_owner} (None = dropless N_local slots)")
    S = n if slots_per_owner is None else slots_per_owner
    dev = tokens.device
    expert_idx = expert_idx.long()
    owner = expert_idx // e_local
    oh = F.one_hot(owner, ep)
    rank = (torch.cumsum(oh, 0) * oh).sum(1) - 1  # within-owner, 0-based
    valid = rank < S
    slot = torch.where(valid, owner * S + rank, torch.full_like(rank, ep * S))
    send = _ScatterRows.apply(tokens, slot, ep * S + 1)[:ep * S]
    send_ids = torch.full((ep * S + 1,), -1, dtype=torch.long, device=dev)
    send_ids = send_ids.index_copy_(0, slot, expert_idx)[:ep * S]
    recv = all_to_all(send, comm, 0, 0)  # block s: rank s's rows for this rank
    recv_ids = comm.all_to_all(send_ids.contiguous(), 0, 0)
    # Local grouping: the empty slots form a last group, left out of the
    # products (their output is zero).
    le = torch.where(recv_ids >= 0, recv_ids - comm.rank * e_local,
                     torch.full_like(recv_ids, e_local))
    order, inv_order, group_sizes = sort_by_expert(le, e_local + 1)
    sizes = group_sizes[:e_local].tolist()  # the one host sync of the call
    real = sum(sizes)
    xs = recv[order[:real]]
    eids = le[order[:real]]
    dt = tokens.dtype
    h = act(_grouped_matmul(xs, w_in, sizes) + b_in.to(dt)[eids])
    ys = _grouped_matmul(h, w_out, sizes) + b_out.to(dt)[eids]
    ys = torch.cat([ys, ys.new_zeros((ep * S - real, d))])[inv_order]
    back = all_to_all(ys, comm, 0, 0)
    # Dropped rows gather the appended zero row at the trash slot.
    back = torch.cat([back, back.new_zeros((1, d))])
    y = _GatherRows.apply(back, slot)
    if return_dropped:
        return y, (~valid).sum()
    return y
