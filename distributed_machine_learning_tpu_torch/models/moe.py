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

Expert parallelism (the reference's ``expert_axis``, ``token_axes`` and
``ep_slots_per_owner``; ``parallel/expert_parallel.py`` builds the steps):
``expert_comm`` is the expert axis's Comm.  The expert leaves are allocated
whole and then sharded in place (``shard_ep_state``: rank r keeps experts
``[r·E/ep, (r+1)·E/ep)``), so a forward reads the local count off ``w_in``.

- ``moe_impl="grouped"``: each rank routes its own token rows and sends
  them to their experts' owners (``ops/grouped.grouped_expert_mlp_ep``:
  one all-to-all each way, dropless or bounded by ``ep_slots_per_owner``
  send slots an owner, ``last_dropped`` counting the rows a bound drops);
- ``moe_impl="einsum"``: the activations are whole on every expert rank
  (the reference's GSPMD step); each rank dispatches the tokens of its own
  experts with the Switch capacity of the GLOBAL batch (each token's place
  in its expert's queue counts the tokens of the lower data ranks: one
  all-gather of the per-expert counts over ``token_comms``), and the
  combine's partial outputs are summed over the expert ranks (``tp_sum``;
  the dispatch's input passes ``copy_to_tp``, so its gradient sums over
  them too).

``token_comms`` are the Comms the token rows are sharded over: the aux
loss's token fraction and mean probability are averaged over them first
(``ops/collectives.mean_over``, backward as ``lax.pmean`` transposes), so it
is the global batch's on every rank.  MoE × context parallelism: a model
whose ``comm`` (the sequence Comm) is among ``token_comms`` takes the
sequence-sharded attentions (ring, ring_flash, ulysses).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_machine_learning_tpu_torch.models.transformer import (
    SEQ_SHARDED,
    TransformerLM,
    copy_to_tp,
    tp_sum,
)
from distributed_machine_learning_tpu_torch.ops.collectives import mean_over
from distributed_machine_learning_tpu_torch.ops.grouped import (
    grouped_expert_mlp,
    grouped_expert_mlp_ep,
)
from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

MOE_IMPLS = ("einsum", "grouped")
# The attentions that need no sequence axis.
SEQ_LOCAL_ATTN_IMPLS = ("dense", "flash", "auto")


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")  # Flax nn.gelu is the tanh form


def check_ep_config(n_experts: int, moe_impl: str, weight_quant, tp_comm, expert_comm,
                    slots) -> None:
    """The reference ``MoEMLP``'s guards of the expert-parallel fields
    (``models/moe.py:115-135``), in its words."""
    if slots is not None and (expert_comm is None or moe_impl != "grouped"):
        raise ValueError(
            "ep_slots_per_owner bounds the manual-EP dispatch all-to-all; it requires "
            "expert_axis (the shard_map EP path) — without it the grouped path is "
            "dropless and the bound would be silently ignored")
    if weight_quant is not None and expert_comm is not None:
        raise NotImplementedError(
            "int8 expert serving is single-host (no manual-EP shard_map decode path "
            "exists to quantize)")
    if tp_comm is not None and expert_comm is not None:
        raise NotImplementedError(
            "TP decode and manual-EP shard_map do not compose (one shard_map program "
            "each); shard experts' d_ff via tp")
    if expert_comm is not None and n_experts % expert_comm.world:
        raise ValueError(f"n_experts={n_experts} must divide over expert axis size "
                         f"{expert_comm.world}")


class MoEMLP(nn.Module):
    """Top-1 routed expert MLP over [B, T, D] activations (see the module
    note).  ``forward(x, dropless=False)``; ``aux_loss`` holds the last
    training (not dropless) forward's Switch load-balancing loss (f32
    scalar)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 capacity_factor: float = 1.25,
                 compute_dtype: torch.dtype = torch.float32,
                 moe_impl: str = "einsum", weight_quant: str | None = None,
                 tp_comm: Comm | None = None, device=None,
                 expert_comm: Comm | None = None, token_comms: tuple = (),
                 ep_slots_per_owner: int | None = None):
        super().__init__()
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be 'einsum' or 'grouped', got {moe_impl!r}")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant must be None or 'int8', got {weight_quant!r}")
        check_ep_config(n_experts, moe_impl, weight_quant, tp_comm, expert_comm,
                        ep_slots_per_owner)
        self.expert_comm = expert_comm
        self.token_comms = tuple(token_comms)
        self.ep_slots_per_owner = ep_slots_per_owner
        self.last_dropped: torch.Tensor | None = None
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
                "tp_axis is the manual TP-decode wiring (serving only); training-time "
                "expert parallelism is the EP step (parallel/expert_parallel.py)")
        B, T, D = x.shape
        N, E = B * T, self.n_experts
        tokens = x.reshape(N, D)
        expert_prob, expert_idx, probs = self.route(tokens)
        if not dropless:  # training: the aux loss and the capacity's one-hot
            onehot = F.one_hot(expert_idx, E).float()  # [N, E]
            # Switch aux loss: E · Σ_e (token fraction)·(mean router prob),
            # the fractions averaged over the token-sharded ranks first.
            frac = mean_over(self.token_comms, onehot.mean(0))
            mean_prob = mean_over(self.token_comms, probs.mean(0))
            self.aux_loss = E * torch.sum(frac * mean_prob)
        dt = self.compute_dtype
        scale = expert_prob[:, None].to(dt)
        if self.expert_comm is not None:
            if self.moe_impl == "grouped":
                y, self.last_dropped = grouped_expert_mlp_ep(
                    tokens.to(dt), expert_idx, self.w_in, self.b_in, self.w_out,
                    self.b_out, comm=self.expert_comm, n_experts_global=E,
                    slots_per_owner=self.ep_slots_per_owner, return_dropped=True)
                return (y * scale).reshape(B, T, D)
            if dropless:
                raise ValueError("einsum expert parallelism is a training path; serve "
                                 "the gathered model (parallel/expert_parallel.py)")
            return (self._einsum_ep(tokens, onehot) * scale).reshape(B, T, D)
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
        capacity = max(1, math.ceil(N / E * self.capacity_factor))
        # Each token's 1-based place in its expert's queue.
        pos = torch.cumsum(onehot, dim=0) * onehot
        return (self._dispatch(tokens.to(dt), pos, capacity) * scale).reshape(B, T, D)

    def _dispatch(self, tokens, pos, capacity: int):
        """Switch dispatch → expert FFN → combine over this module's experts
        (places ``pos`` [N, E_local], 1-based, 0 where not routed; overflow
        places drop): three static einsums in the compute dtype."""
        dt = self.compute_dtype
        w_in, b_in, w_out, b_out = self.w_in, self.b_in, self.w_out, self.b_out
        within = (pos > 0) & (pos <= capacity)
        # Overflow places are clamped into range and masked out by `within`.
        slot = F.one_hot((pos - 1).clamp(0, capacity - 1).long(), capacity).float()
        dmask = (slot * within.float()[..., None]).to(dt)
        xe = torch.einsum("nd,nec->ecd", tokens, dmask)
        h = _gelu(torch.einsum("ecd,edf->ecf", xe, w_in.to(dt))
                  + b_in.to(dt)[:, None, :])
        ye = (torch.einsum("ecf,efd->ecd", h, w_out.to(dt))
              + b_out.to(dt)[:, None, :])
        return torch.einsum("ecd,nec->nd", ye, dmask)

    def _einsum_ep(self, tokens: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        """The einsum path on this expert rank's experts, its capacity and
        queue places those of the global batch (the module note); [N, D]
        summed over the expert ranks."""
        comm, E = self.expert_comm, self.n_experts
        e_local = self.w_in.shape[0]
        if e_local * comm.world != E:
            raise ValueError(f"local expert axis {e_local} x mesh axis {comm.world} != "
                             f"n_experts_global {E}")
        n_global = tokens.shape[0] * math.prod(c.world for c in self.token_comms)
        capacity = max(1, math.ceil(n_global / E * self.capacity_factor))
        pos = torch.cumsum(onehot, dim=0)
        for c in self.token_comms:  # the tokens of the lower ranks queue first
            if c.world > 1:
                counts = c.all_gather(pos[-1].contiguous())
                pos = pos + sum(counts[:c.rank], torch.zeros_like(pos[-1]))
        e0 = comm.rank * e_local
        pos = (pos * onehot)[:, e0:e0 + e_local]
        x = copy_to_tp(comm, tokens.to(self.compute_dtype))
        return tp_sum(comm, self._dispatch(x, pos, capacity))


class MoETransformerLM(TransformerLM):
    """Decoder-only LM with a routed expert MLP in every block (the shared
    :class:`~distributed_machine_learning_tpu_torch.models.transformer.Block`
    wiring).  Takes :class:`TransformerLM`'s arguments (decode with a scalar
    or per-row frontier, int8 caches, the tensor-parallel local clone) plus
    the expert configuration and the expert-parallel fields of
    :class:`MoEMLP` (``expert_comm``, ``token_comms``,
    ``ep_slots_per_owner``).  Attention runs dense, flash or auto; ring,
    ring_flash or ulysses over ``comm`` when ``comm`` is one of
    ``token_comms`` (MoE × context parallelism)."""

    def __init__(self, vocab_size: int, d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 8, n_experts: int = 8, d_ff: int | None = None,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
                 moe_impl: str = "einsum", expert_comm: Comm | None = None,
                 token_comms: tuple = (), ep_slots_per_owner: int | None = None,
                 **kwargs):
        seq_sharded = any(c is kwargs.get("comm") for c in token_comms)
        if kwargs.get("attn_impl", "dense") in SEQ_SHARDED and not seq_sharded:
            raise NotImplementedError(
                "MoETransformerLM runs the sequence-local attention kernels "
                "(dense/flash/auto) under plain apply; the sequence-sharded impls "
                "(ring/ring_flash/ulysses) need the MoE x context-parallel step, which "
                "clones the model with the seq axis in token_axes "
                "(parallel/expert_parallel.py::make_ep_grouped_train_step)")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be 'einsum' or 'grouped', got {moe_impl!r}")
        self._moe_config = dict(n_experts=n_experts, capacity_factor=capacity_factor,
                                aux_loss_weight=aux_loss_weight, moe_impl=moe_impl,
                                expert_comm=expert_comm, token_comms=tuple(token_comms),
                                ep_slots_per_owner=ep_slots_per_owner)
        super().__init__(vocab_size, d_model, n_layers, n_heads, d_ff, **kwargs)
        self.config.update(self._moe_config)
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.moe_impl = moe_impl

    def _block(self, device, remat_mlp: bool, moe=None):
        c = self._moe_config
        moe = MoEMLP(self.d_model, c["n_experts"], self.d_ff, c["capacity_factor"],
                     self.compute_dtype, c["moe_impl"], self.weight_quant, self.tp_comm,
                     device, c["expert_comm"], c["token_comms"], c["ep_slots_per_owner"])
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
