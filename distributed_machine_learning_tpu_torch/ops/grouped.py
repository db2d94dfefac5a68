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

``grouped_expert_mlp_ep`` (expert parallelism over a manual all-to-all)
is not ported yet: ROADMAP A5c.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    if not outs:
        return x.new_zeros((0, w.shape[-1]))
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
