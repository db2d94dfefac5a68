"""Mixture-of-Experts transformer LM (Switch-style top-1 routing).

Counterpart of ``distributed_machine_learning_tpu/models/moe.py``
(``MoEMLP``, ``MoETransformerLM``).  Every expert parameter carries a
leading ``[n_experts, ...]`` axis, in the reference's layout (``w_in``
[E, D, F], ``b_in`` [E, F], ``w_out`` [E, F, D], ``b_out`` [E, D]); the
router is an f32 ``Linear(D, E)``.

Two compute paths behind one f32 router (``moe_impl``):

- ``"einsum"``: Switch capacity, ``ceil(N / E · capacity_factor)`` tokens
  an expert; overflow tokens get a zero MLP output and pass through the
  residual unchanged (static one-hot dispatch and combine einsums);
- ``"grouped"``: dropless, sorted by expert (``ops/grouped.py``).

Serving routes dropless whatever ``moe_impl`` says: a decode step's N is
B·1, where capacity would drop colliding tokens.  The blocks route
dropless whenever a cache or a paged pool is given (the reference's clone
with ``decode=True``).  The Switch load-balancing loss ``E · Σ_e f_e·P_e``
of the last training forward is each layer's ``moe.aux_loss``
(:meth:`MoETransformerLM.aux_losses`), where the reference sows it.

``weight_quant="int8"`` serves int8 experts (``w_in_q``/``w_out_q`` with
per-expert per-output-channel scales, from ``ops.quant.quantize_lm_params``)
through the grouped path, and the attention projections and the head
through K6 (``QuantLinear``); the router stays f32.  It requires decode.

Tensor-parallel decode: with ``tp_comm`` the experts hold their local
``d_ff`` slice (column-parallel ``w_in``, row-parallel ``w_out``), the
router is whole on every rank (identical routing), and the mixture's output
is summed over the ranks (``b_out`` pre-divided by tp).

Manual expert parallelism (``expert_axis``, ``token_axes``, the bounded
send slots) is not ported yet: ROADMAP A5c.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_machine_learning_tpu_torch.models.transformer import (
    SEQ_SHARDED,
    TransformerLM,
    tp_sum,
)
from distributed_machine_learning_tpu_torch.ops.grouped import grouped_expert_mlp
from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

MOE_IMPLS = ("einsum", "grouped")
_EP_NOT_PORTED = ("manual expert parallelism (expert_axis, token_axes, "
                  "ep_slots_per_owner) is not ported yet: ROADMAP A5c")


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")  # Flax nn.gelu is the tanh form


class MoEMLP(nn.Module):
    """Top-1 routed expert MLP over [B, T, D] activations (see the module
    note).  ``forward(x, dropless=False)``; ``aux_loss`` holds the last
    training (not dropless) forward's Switch load-balancing loss (f32
    scalar)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 capacity_factor: float = 1.25,
                 compute_dtype: torch.dtype = torch.float32,
                 moe_impl: str = "einsum", weight_quant: str | None = None,
                 tp_comm: Comm | None = None, device=None):
        super().__init__()
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be 'einsum' or 'grouped', got {moe_impl!r}")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant must be None or 'int8', got {weight_quant!r}")
        self.n_experts = n_experts
        self.d_ff = d_ff
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.moe_impl = moe_impl
        self.weight_quant = weight_quant
        self.tp_comm = tp_comm
        self.aux_loss: torch.Tensor | None = None
        E, D = n_experts, d_model
        self.router = nn.Linear(D, E, device=device)
        if weight_quant == "int8":
            for name, shape, dtype in (
                    ("w_in_q", (E, D, d_ff), torch.int8),
                    ("w_in_scale", (E, d_ff), torch.float32),
                    ("w_out_q", (E, d_ff, D), torch.int8),
                    ("w_out_scale", (E, D), torch.float32),
                    ("b_in", (E, d_ff), torch.float32),
                    ("b_out", (E, D), torch.float32)):
                init = torch.ones if name.endswith("scale") else torch.zeros
                self.register_buffer(name, init(shape, dtype=dtype, device=device))
        else:
            self.w_in = nn.Parameter(torch.zeros(E, D, d_ff, device=device))
            self.b_in = nn.Parameter(torch.zeros(E, d_ff, device=device))
            self.w_out = nn.Parameter(torch.zeros(E, d_ff, D, device=device))
            self.b_out = nn.Parameter(torch.zeros(E, D, device=device))

    def route(self, tokens: torch.Tensor):
        """Top-1 routing of ``tokens`` [N, D] by the f32 router (a small
        product whose argmax decides the routing): (the chosen expert's
        probability [N], the expert [N], every probability [N, E])."""
        gate = F.linear(tokens.float(), self.router.weight.float(),
                        self.router.bias.float())
        probs = torch.softmax(gate, dim=-1)
        expert_prob, expert_idx = probs.max(dim=-1)
        return expert_prob, expert_idx, probs

    def forward(self, x: torch.Tensor, dropless: bool = False) -> torch.Tensor:
        if self.weight_quant is not None and not dropless:
            raise ValueError(
                "weight_quant is a serving feature (int8 experts are not "
                "trainable); it requires the dropless serving path (decode: "
                "give a cache)")
        if self.tp_comm is not None and not dropless:
            raise ValueError(
                "tp_comm is the manual tensor-parallel decode wiring (serving "
                "only); training-time expert parallelism is ROADMAP A5c")
        B, T, D = x.shape
        N, E = B * T, self.n_experts
        tokens = x.reshape(N, D)
        expert_prob, expert_idx, probs = self.route(tokens)
        if not dropless:  # training: the aux loss and the capacity's one-hot
            onehot = F.one_hot(expert_idx, E).float()  # [N, E]
            # Switch aux loss: E · Σ_e (token fraction)·(mean router prob).
            self.aux_loss = E * torch.sum(onehot.mean(0) * probs.mean(0))
        dt = self.compute_dtype
        scale = expert_prob[:, None].to(dt)
        if self.moe_impl == "grouped" or dropless:
            quant = self.weight_quant == "int8"
            y = grouped_expert_mlp(
                tokens.to(dt), expert_idx,
                self.w_in_q if quant else self.w_in, self.b_in,
                self.w_out_q if quant else self.w_out, self.b_out,
                w_in_scale=self.w_in_scale if quant else None,
                w_out_scale=self.w_out_scale if quant else None)
            # The row-parallel w_out's partial sums (b_out and the router
            # scale commute with the sum: both are whole on every rank).
            return tp_sum(self.tp_comm, y * scale).reshape(B, T, D)
        # Each token's 1-based place in its expert's queue; overflow drops.
        capacity = max(1, math.ceil(N / E * self.capacity_factor))
        pos = torch.cumsum(onehot, dim=0) * onehot
        within = (pos > 0) & (pos <= capacity)
        # Overflow places are clamped into range and masked out by `within`.
        slot = F.one_hot((pos - 1).clamp(0, capacity - 1).long(), capacity).float()
        dmask = (slot * within.float()[..., None]).to(dt)
        xe = torch.einsum("nd,nec->ecd", tokens.to(dt), dmask)
        h = _gelu(torch.einsum("ecd,edf->ecf", xe, self.w_in.to(dt))
                  + self.b_in.to(dt)[:, None, :])
        ye = (torch.einsum("ecf,efd->ecd", h, self.w_out.to(dt))
              + self.b_out.to(dt)[:, None, :])
        y = torch.einsum("ecd,nec->nd", ye, dmask)
        return (y * scale).reshape(B, T, D)


class MoETransformerLM(TransformerLM):
    """Decoder-only LM with a routed expert MLP in every block (the shared
    :class:`~distributed_machine_learning_tpu_torch.models.transformer.Block`
    wiring).  Takes :class:`TransformerLM`'s arguments (decode with a scalar
    or per-row frontier, int8 caches, the tensor-parallel local clone) plus
    the expert configuration; attention runs dense, flash or auto."""

    def __init__(self, vocab_size: int, d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 8, n_experts: int = 8, d_ff: int | None = None,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
                 moe_impl: str = "einsum", expert_axis: str | None = None,
                 token_axes: tuple = (), ep_slots_per_owner: int | None = None,
                 **kwargs):
        if expert_axis is not None or token_axes or ep_slots_per_owner is not None:
            raise NotImplementedError(_EP_NOT_PORTED)
        if kwargs.get("attn_impl", "dense") in SEQ_SHARDED:
            raise NotImplementedError(
                "MoETransformerLM runs the sequence-local attentions (dense/flash/"
                "auto); MoE x context parallelism is ROADMAP A5c")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be 'einsum' or 'grouped', got {moe_impl!r}")
        self._moe_config = dict(n_experts=n_experts, capacity_factor=capacity_factor,
                                aux_loss_weight=aux_loss_weight, moe_impl=moe_impl)
        super().__init__(vocab_size, d_model, n_layers, n_heads, d_ff, **kwargs)
        self.config.update(self._moe_config)
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.moe_impl = moe_impl

    def _block(self, device, remat_mlp: bool, moe=None):
        moe = MoEMLP(self.d_model, self._moe_config["n_experts"], self.d_ff,
                     self._moe_config["capacity_factor"], self.compute_dtype,
                     self._moe_config["moe_impl"], self.weight_quant, self.tp_comm,
                     device)
        return super()._block(device, remat_mlp, moe)

    def aux_losses(self) -> list:
        """Each layer's Switch aux loss from the last forward (the
        reference's sown ``losses/load_balancing``)."""
        return [block.moe.aux_loss for block in self.blocks]

    def forward(self, tokens: torch.Tensor, cache=None, start=0,
                last_only: bool = False, paged=None,
                return_hidden: bool = False) -> torch.Tensor:
        if self.weight_quant is not None and cache is None and paged is None:
            raise ValueError(
                "weight_quant is a serving-decode feature (int8 weights are not "
                "trainable); give a cache (inference/generate.py does)")
        return super().forward(tokens, cache=cache, start=start, last_only=last_only,
                               paged=paged, return_hidden=return_hidden)
