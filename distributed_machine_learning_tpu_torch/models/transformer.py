"""Decoder-only transformer LM: dense MHA or GQA, with a decode KV cache.

Counterpart of ``distributed_machine_learning_tpu/models/transformer.py``
(``apply_rope``, ``Attention``, ``Block``, ``TransformerLM``) for the
serving path: pre-LN blocks, tanh-GELU MLP, split-half RoPE in f32,
Flax-style LayerNorm (epsilon 1e-6, f32 statistics), f32 logits.

The decode KV cache is head-major ``[B, Hkv, S, D]`` and lives outside
the module (:class:`KVCache`, from :meth:`TransformerLM.init_cache`).  The
decode frontier ``start`` is a host int (one frontier for every row), or
a [B] int tensor on the model's device (a frontier per row: batched
speculative decoding, where rows commit different counts each round;
the reference's ``decode_batched_frontier``).  Each row writes its L
fresh K/V rows (and int8 scales) at its own offset, and RoPE and the
causal masks take [B, L] positions.  Attention dispatch matches the
reference's decode path:

- prefill (L > 1, scalar start 0): flash when ``flash_wins(L)``, dense
  below, over the fresh K/V (whatever the cache dtype);
- a multi-token continuation (L > 1 at a scalar start > 0, or any L under
  per-row frontiers: speculative decoding's verify pass): the fresh
  queries attend the whole cache, masked by absolute position, through
  the grouped einsum (:func:`_cached_attention`) or, for int8 caches, the
  scale-folding einsum (:func:`_cached_attention_quant`);
- one-token decode at a scalar frontier: ``cached_flash_attention`` when
  the allocation qualifies and holds at least 4096 slots, the grouped
  einsum otherwise; under per-row frontiers always the einsum (the kernel
  clamps its reads at one scalar frontier);
- with an int8 cache (``kv_cache_dtype=torch.int8``: int8 rows plus one
  f32 scale per (kv head, slot), written together by
  :func:`quantize_kv`), one-token decode takes the scale-folding einsum;
  with ``int8_tiered_dispatch=True`` (the reference's
  ``_INT8_TIERED_DISPATCH``, default off) it takes the int8 mode of
  ``cached_flash_attention`` while a scalar position is below
  :data:`INT8_TIER_BREAK_EVEN_PCT` % of the allocation, when that
  qualifies (never under per-row frontiers).  The scalar position is a
  host int, so the switch is a plain ``if``.

Tensor parallelism (the reference's Megatron layout): a model built at
its local width (``n_heads``, ``n_kv_heads`` and ``d_ff`` ÷ tp, ``head_dim``
pinned to the global width) with ``tp_comm`` set sums the row-parallel
attention out-projection and ``fc_out`` over the ranks of ``tp_comm`` (in
f32, rounded once to the compute dtype: :func:`tp_sum`, Megatron's g, whose
backward is the identity).  Decode (``vocab_parallel=None``): embeddings,
the head and the LayerNorms stay whole on every rank, the row-parallel
biases are pre-divided by tp.  Training (``vocab_parallel`` "head" or
"both"): the input of every column-parallel projection passes
:func:`copy_to_tp` (Megatron's f: identity forward, the sum over the ranks
backward), the row-parallel biases are added once after the sum, the head
is split by vocabulary (this rank's logits [B, L, V/tp]: the loss is
``parallel/tensor_parallel.vocab_parallel_cross_entropy``) and, under
"both", the embedding too (a masked lookup summed over the ranks).  So
every replicated leaf (the LayerNorms, the row-parallel biases, a whole
embedding) gets the same gradient on every rank with no reduction of its
own (``parallel/tensor_parallel.py`` slices the weights).

The feed-forward sub-layer is the dense GELU MLP, or a routed expert
mixture (``models/moe.py`` builds its blocks with ``moe=``), which routes
dropless whenever a cache or a paged pool is given.

Per-row (paged) decode serves the continuous-batching engine: one token
per lane, each lane at its own position, its K/V written into a shared
paged pool through its block table (:class:`PagedKV`) and attended by
``paged_flash_attention``.  (The reference engine gathers the pages into
a dense per-row cache and runs the einsum instead; see
``inference/continuous.py``.)

Training: the full causal pass is differentiable (flash attention's
backward is an autograd Function over K2/K3).  Context-parallel training
shards the sequence over the ranks of ``comm`` (the model's
:class:`~distributed_machine_learning_tpu_torch.runtime.distributed.Comm`):
``attn_impl="ring"`` is the einsum ring, ``"ring_flash"`` the ring over the
chunk kernels K11-K13, ``"ulysses"`` two all-to-alls around attention over
the full sequence on a slice of the heads (``ops/ulysses.py``: K1-K3 where
flash wins); rank r's chunk holds global positions ``r·Lc + arange(Lc)``,
which RoPE sees.  Parameters stay f32 and
each projection casts them to the compute dtype, as Flax's
``Dense(dtype=...)`` does.  ``remat=True`` checkpoints the LN2+MLP
sub-layer (``remat_policy="mlp"``: attention's saved ``(out, lse)`` stay
resident, so the backward never re-runs attention) or the whole block
(``"block"``), with ``torch.utils.checkpoint`` (reference
``models/transformer.py:614-709``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_machine_learning_tpu_torch.ops.decode_attention import (
    cached_flash_attention,
    decode_flash_qualifies,
    paged_flash_attention,
)
from distributed_machine_learning_tpu_torch.ops.flash_attention import (
    _needs_pad,
    flash_self_attention,
    flash_wins,
)
from distributed_machine_learning_tpu_torch.ops.quant import QuantLinear
from distributed_machine_learning_tpu_torch.ops.ring_attention import (
    dense_self_attention,
    ring_self_attention,
)
from distributed_machine_learning_tpu_torch.ops.ring_flash_attention import (
    ring_flash_self_attention,
)
from distributed_machine_learning_tpu_torch.ops.ulysses import ulysses_self_attention
from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

LN_EPS = 1e-6  # Flax LayerNorm's epsilon (torch's default is 1e-5)
DECODE_KERNEL_MIN_SLOTS = 4096  # the reference's decode-kernel threshold
# The tiered int8 switch's break-even, pos/S in percent (the reference's
# _INT8_TIER_BREAK_EVEN_PCT, measured on its TPU; kept until the card's
# crossover decides it).
INT8_TIER_BREAK_EVEN_PCT = 19
KV_CACHE_DTYPES = (torch.int8, torch.bfloat16, torch.float32)


def rope_tables(positions: torch.Tensor, head_dim: int,
                base: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``(cos, sin)`` tables for :func:`rotate`, built once per forward
    and shared by every layer: [1, L, 1, D] for ``positions`` [L] (one
    frontier), [B, L, 1, D] for [B, L] (a frontier per row).  ``cos``
    repeats the half-width cosines, ``sin`` holds ``(-sin, sin)``."""
    d_half = head_dim // 2
    freqs = base ** (-torch.arange(d_half, dtype=torch.float32,
                                   device=positions.device) / d_half)
    angles = positions.float()[..., None] * freqs  # [..., L, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    cos, sin = torch.cat([cos, cos], -1)[..., None, :], torch.cat([-sin, sin], -1)[..., None, :]
    if positions.dim() == 1:
        return cos[None], sin[None]
    return cos, sin


def rotate(x: torch.Tensor, tables: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Split-half RoPE of [B, L, H, D] with precomputed tables, f32 math,
    dtype preserved: ``[x1·cos − x2·sin, x2·cos + x1·sin]`` (bit for bit the
    reference's ``[x1·cos − x2·sin, x1·sin + x2·cos]``)."""
    cos, sin = tables
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotate [B, L, H, D] by per-position angles (split halves, not
    interleaved pairs); f32 math, dtype preserved.  ``positions``: [L]."""
    return rotate(x, rope_tables(positions, x.shape[-1], base))


def _ring_flash_wins(chunk_len: int) -> bool:
    """The ring → ring_flash upgrade policy (reference
    ``models/transformer.py:179-194``): the length policy of one-device flash
    applied to the local chunk, minus the lengths that one-device flash
    pads, since the ring kernels have no pad path."""
    return flash_wins(chunk_len) and not _needs_pad(chunk_len)


def _repeat_kv(t: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, L, Hkv, D] → [B, L, Hkv·n_rep, D] (each kv head repeated in
    place, the ``jnp.repeat(axis=2)`` grouping)."""
    return t if n_rep == 1 else t.repeat_interleave(n_rep, dim=2)


def _cached_mask(s: torch.Tensor, q_positions: torch.Tensor) -> torch.Tensor:
    """Causal frontier mask of scores [B, Hkv, rep, Lq, S]: slot j is seen by
    a query at position p iff j <= p.  ``q_positions``: [Lq] (one frontier)
    or [B, Lq] (a frontier per row)."""
    slots = torch.arange(s.shape[-1], device=s.device)
    if q_positions.dim() == 1:
        mask = slots[None, :] <= q_positions[:, None]  # [Lq, S]
    else:
        mask = (slots[None, None, :] <= q_positions[:, :, None])[:, None, None]
    return torch.where(mask, s, float("-inf"))


def _cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      q_positions: torch.Tensor) -> torch.Tensor:
    """Queries [B, Lq, H, D] at ``q_positions`` ([Lq], or [B, Lq] under
    per-row frontiers) against the whole head-major cache [B, Hkv, S, D],
    GQA-native (query heads grouped [Hkv, rep], no repeated cache); f32
    softmax, q's dtype out."""
    B, Lq, H, D = q.shape
    Hkv = k_cache.shape[1]
    qg = q.float().reshape(B, Lq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhrd,bhkd->bhrqk", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    p = torch.softmax(_cached_mask(s, q_positions), dim=-1)
    out = torch.einsum("bhrqk,bhkd->bqhrd", p, v_cache.float())
    return out.reshape(B, Lq, H, D).to(q.dtype)


def _cached_attention_quant(q: torch.Tensor, k_int: torch.Tensor, ks: torch.Tensor,
                            v_int: torch.Tensor, vs: torch.Tensor,
                            q_positions: torch.Tensor) -> torch.Tensor:
    """:func:`_cached_attention` over an int8 cache [B, Hkv, S, D] with f32
    scales [B, Hkv, S], the scales folded into the f32 score and
    probability path (reference ``_cached_attention_quant``): ``s·ks`` after
    the QK einsum, ``p·vs`` before the PV einsum.  Plain PyTorch on every
    device, as the reference leaves it to XLA."""
    B, Lq, H, D = q.shape
    Hkv = k_int.shape[1]
    qg = q.float().reshape(B, Lq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhrd,bhkd->bhrqk", qg, k_int.float()) * (1.0 / math.sqrt(D))
    s = s * ks[:, :, None, None, :]
    p = torch.softmax(_cached_mask(s, q_positions), dim=-1)
    out = torch.einsum("bhrqk,bhkd->bqhrd", p * vs[:, :, None, None, :], v_int.float())
    return out.reshape(B, Lq, H, D).to(q.dtype)


def _sum_f32(comm: Comm, y: torch.Tensor) -> torch.Tensor:
    """``y`` summed over ``comm``'s ranks in f32, rounded once to its dtype."""
    return comm.all_reduce_(y.to(torch.float32, copy=True).contiguous()).to(y.dtype)


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the sum over the ranks forward, the identity backward."""

    @staticmethod
    def forward(ctx, y, comm):
        return _sum_f32(comm, y)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over the ranks backward
    (each rank's heads or columns give a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(ctx.comm, grad), None


def tp_sum(comm: Comm | None, y: torch.Tensor) -> torch.Tensor:
    """The row-parallel projection's partial outputs summed over the
    tensor-parallel ranks of ``comm`` (the reference's ``psum`` over its
    ``tp_axis``), in f32 and rounded once to ``y``'s dtype; the gradient
    passes through unchanged.  ``y`` itself without a group."""
    if comm is None or comm.world == 1:
        return y
    return _ReduceFromTP.apply(y, comm)


def copy_to_tp(comm: Comm | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` entering the tensor-parallel region: unchanged, its gradient
    summed over the ranks of ``comm`` (f32, rounded once)."""
    if comm is None or comm.world == 1:
        return x
    return _CopyToTP.apply(x, comm)


def vocab_parallel_embedding(tokens: torch.Tensor, weight: torch.Tensor,
                             comm: Comm | None) -> torch.Tensor:
    """The lookup of ``tokens`` in an embedding split by vocabulary over
    ``comm`` (this rank holds rows ``rank·V/tp ..``): each rank looks up
    the tokens it holds, zeros elsewhere, and the f32 rows are summed over
    the ranks (exact: one rank holds each token)."""
    rows = weight.shape[0]
    start = 0 if comm is None else comm.rank * rows
    local = tokens - start
    inside = (local >= 0) & (local < rows)
    e = F.embedding(local.clamp(0, rows - 1), weight) * inside[..., None]
    return tp_sum(comm, e)


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 cache write's arithmetic (reference ``models/transformer.py``
    ``_write``): per row of the last dim, ``amax = max |t|`` in f32, ``s =
    amax / 127`` (1 where amax is 0), codes ``clip(round(t / s), -127,
    127)`` with round half to even.  Returns (int8 codes, f32 scales of
    shape ``t.shape[:-1]``)."""
    tf = t.float()
    amax = tf.abs().amax(-1)
    s = torch.where(amax > 0, amax / 127.0, 1.0)
    codes = torch.clamp(torch.round(tf / s[..., None]), -127, 127).to(torch.int8)
    return codes, s


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``'s contract: f32 statistics and affine,
    epsilon 1e-6, output in the compute dtype.  (Flax takes the variance as
    E[x²] − E[x]², torch's kernel in one pass of its own: they agree to f32
    rounding.)"""

    def __init__(self, dim: int, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), LN_EPS)
        return y.to(self.compute_dtype)


def _linear(in_f: int, out_f: int, quant: bool, cd: torch.dtype, device):
    if quant:
        return QuantLinear(in_f, out_f, compute_dtype=cd, device=device)
    return nn.Linear(in_f, out_f, device=device)


def _project(layer: nn.Module, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """A projection in the compute dtype (weights cast to it, as Flax's
    ``Dense(dtype=...)`` does; a no-op once the weights are stored in it)."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    return F.linear(x.to(cd), layer.weight.to(cd), layer.bias.to(cd))


@dataclass
class KVCache:
    """Per-layer head-major decode caches, each [B, Hkv, S, D]; with an
    int8 cache also per-layer f32 scales [B, Hkv, S] (None otherwise)."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]
    key_scales: list[torch.Tensor] | None = None
    value_scales: list[torch.Tensor] | None = None

    def layer(self, i: int) -> tuple:
        """Layer i's ``(keys, values, key_scales, value_scales)``."""
        if self.key_scales is None:
            return self.keys[i], self.values[i], None, None
        return self.keys[i], self.values[i], self.key_scales[i], self.value_scales[i]


@dataclass
class PagedKV:
    """One paged decode step's view of the shared pool: per-layer pools
    [num_blocks + 1, Hkv, block_size, D], block tables [W, MB] int32 (lane
    w's logical block j is pool row ``tables[w, j]``) and positions [W]
    int32 (lane w writes and attends position ``positions[w]``)."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]
    tables: torch.Tensor
    positions: torch.Tensor


def _row_parallel(layer: nn.Module, x: torch.Tensor, cd: torch.dtype, comm: Comm | None,
                  bias_after: bool) -> torch.Tensor:
    """A row-parallel projection summed over ``comm`` (:func:`tp_sum`): its
    bias inside the sum (decode: pre-divided by tp), or added once after it
    (``bias_after``: the training layout, the bias whole on every rank)."""
    if not bias_after or comm is None or comm.world == 1:
        return tp_sum(comm, _project(layer, x, cd))
    return tp_sum(comm, F.linear(x.to(cd), layer.weight.to(cd))) + layer.bias.to(cd)


class Attention(nn.Module):
    """Causal self-attention: fused ``qkv`` for MHA, ``q`` + ``kv`` for GQA.
    ``head_dim`` pins the per-head width (default ``d_model // n_heads``; a
    tensor-parallel rank's local clone keeps the global one).  ``tp_train``:
    the training layout of the tensor-parallel region (see the module
    note)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int | None,
                 attn_impl: str, compute_dtype: torch.dtype,
                 weight_quant: str | None, device=None, comm: Comm | None = None,
                 int8_tiered_dispatch: bool = False, head_dim: int | None = None,
                 tp_comm: Comm | None = None, tp_train: bool = False):
        super().__init__()
        self.comm = comm or Comm()
        self.tp_comm = tp_comm
        self.tp_train = tp_train
        self.int8_tiered_dispatch = int8_tiered_dispatch
        if head_dim is None and d_model % n_heads:
            raise ValueError("n_heads must divide d_model")
        self.n_heads = n_heads
        self.head_dim = head_dim or d_model // n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        if n_heads % self.n_kv_heads:
            raise ValueError(f"n_kv_heads={self.n_kv_heads} must divide "
                             f"n_heads={n_heads}")
        self.attn_impl = attn_impl
        self.compute_dtype = compute_dtype
        quant = weight_quant == "int8"
        hd = self.head_dim
        if self.n_kv_heads == n_heads:
            self.qkv = _linear(d_model, 3 * n_heads * hd, quant, compute_dtype, device)
        else:
            self.q = _linear(d_model, n_heads * hd, quant, compute_dtype, device)
            self.kv = _linear(d_model, 2 * self.n_kv_heads * hd, quant,
                              compute_dtype, device)
        self.out = _linear(n_heads * hd, d_model, quant, compute_dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, rope,
                cache: tuple | None = None,
                start=0, paged: tuple | None = None) -> torch.Tensor:
        """``rope``: the :func:`rope_tables` of ``positions``.  ``cache``: this
        layer's ``(k_cache, v_cache, k_scale, v_scale)`` (scales None unless
        the cache is int8).  ``start``: the frontier, a host int or a [B]
        tensor (then ``positions`` is [B, L]).  ``paged``: this layer's
        ``(k_pool, v_pool, tables, positions, page, slot)``, where each
        lane's fresh K/V row goes to ``pool[page[w], :, slot[w]]``."""
        B, L, E = x.shape
        H, Hkv, hd, cd = self.n_heads, self.n_kv_heads, self.head_dim, self.compute_dtype
        if self.tp_train:
            x = copy_to_tp(self.tp_comm, x)
        if Hkv == H:
            qkv = _project(self.qkv, x, cd).reshape(B, L, 3, H, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = _project(self.q, x, cd).reshape(B, L, H, hd)
            kv = _project(self.kv, x, cd).reshape(B, L, 2, Hkv, hd)
            k, v = kv[:, :, 0], kv[:, :, 1]
        q = rotate(q, rope)
        k = rotate(k, rope)
        if paged is not None:
            k_pool, v_pool, tables, lane_pos, page, slot = paged
            k_pool[page, :, slot] = k[:, 0]
            v_pool[page, :, slot] = v[:, 0]
            out = paged_flash_attention(q, k_pool, v_pool, tables, lane_pos)
        elif cache is not None:
            out = self._cached(q, k, v, cache, positions, start)
        elif self.attn_impl in SEQ_SHARDED:
            # GQA: the narrow K/V chunks travel the ring, or the narrow K/V
            # ride the all-to-all when the group divides Hkv.  Ulysses picks
            # its own local kernel ("ulysses owns its attention").
            sharded = {"ring": ring_self_attention, "ring_flash": ring_flash_self_attention,
                       "ulysses": ulysses_self_attention}[self.attn_impl]
            out = sharded(q, k, v, self.comm)
        elif self.attn_impl == "flash" or (self.attn_impl == "auto" and flash_wins(L)):
            out = flash_self_attention(q, k, v)
        else:
            n_rep = H // Hkv
            out = dense_self_attention(
                q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), positions)
        return _row_parallel(self.out, out.reshape(B, L, H * hd), cd, self.tp_comm,
                             self.tp_train)

    def _cached(self, q, k, v, cache: tuple, positions, start) -> torch.Tensor:
        """Write the fresh K/V at the frontier and attend (the dispatch of
        the module note)."""
        if self.attn_impl in SEQ_SHARDED:
            raise ValueError("decode runs dense cached attention; clone the model "
                             'with attn_impl="dense"')
        B, L, H, hd = q.shape
        k_cache, v_cache, k_scale, v_scale = cache
        per_row = torch.is_tensor(start)
        if per_row:  # each row's L slots at its own offset
            rows = torch.arange(B, device=q.device)[:, None]
            at = (rows, slice(None), positions)  # indexes [B, L, Hkv, ...]
            if k_scale is None:
                k_cache[at], v_cache[at] = k, v
            else:
                for buf, sbuf, t in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
                    buf[at], sbuf[at] = quantize_kv(t)
        elif k_scale is None:
            k_cache[:, :, start:start + L] = k.transpose(1, 2)
            v_cache[:, :, start:start + L] = v.transpose(1, 2)
        else:  # int8 rows and their scales, written together
            for rows_, scales, t in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
                codes, sc = quantize_kv(t.transpose(1, 2))
                rows_[:, :, start:start + L] = codes
                scales[:, :, start:start + L] = sc
        if L > 1 and not per_row and start == 0:
            # Prefill: the cache was empty, so attention is plain causal
            # attention over the fresh K/V (flash by length alone, whatever
            # attn_impl says).
            if flash_wins(L):
                return flash_self_attention(q, k, v)
            n_rep = H // k.shape[2]
            return dense_self_attention(
                q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), positions)
        S = k_cache.shape[2]
        one = L == 1 and not per_row
        if k_scale is not None:
            if (one and self.int8_tiered_dispatch and decode_flash_qualifies(S)
                    and start * 100 < S * INT8_TIER_BREAK_EVEN_PCT):
                return cached_flash_attention(q, k_cache, v_cache, start,
                                              k_scale=k_scale, v_scale=v_scale)
            return _cached_attention_quant(q, k_cache, k_scale, v_cache, v_scale,
                                           positions)
        if one and decode_flash_qualifies(S) and S >= DECODE_KERNEL_MIN_SLOTS:
            return cached_flash_attention(q, k_cache, v_cache, start)
        return _cached_attention(q, k_cache, v_cache, positions)


class Block(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + fc_out(gelu(fc_in(ln2(x)))),
    or + moe(ln2(x)) when a routed expert MLP is given (``moe``: a module
    called as ``moe(h, dropless=...)``; the reference's ``mlp_factory``).
    ``remat_mlp``: the LN2+MLP sub-layer is recomputed in the backward
    instead of saving its activations (the selective remat policy).
    ``tp_comm``: the tensor-parallel group (``fc_out`` is row-parallel and
    summed over it; an expert mixture sums its own); ``tp_train`` its
    training layout (see the module note)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 n_kv_heads: int | None, attn_impl: str,
                 compute_dtype: torch.dtype, weight_quant: str | None,
                 device=None, remat_mlp: bool = False, comm: Comm | None = None,
                 int8_tiered_dispatch: bool = False, head_dim: int | None = None,
                 tp_comm: Comm | None = None, moe: nn.Module | None = None,
                 tp_train: bool = False):
        super().__init__()
        quant = weight_quant == "int8"
        self.compute_dtype = compute_dtype
        self.remat_mlp = remat_mlp
        self.tp_comm = tp_comm
        self.tp_train = tp_train
        self.ln1 = LayerNorm(d_model, compute_dtype, device)
        self.attn = Attention(d_model, n_heads, n_kv_heads, attn_impl,
                              compute_dtype, weight_quant, device, comm,
                              int8_tiered_dispatch, head_dim, tp_comm, tp_train)
        self.ln2 = LayerNorm(d_model, compute_dtype, device)
        if moe is not None:
            self.moe = moe
        else:
            self.fc_in = _linear(d_model, d_ff, quant, compute_dtype, device)
            self.fc_out = _linear(d_ff, d_model, quant, compute_dtype, device)

    def mlp(self, x: torch.Tensor, dropless: bool = False) -> torch.Tensor:
        """LN2 + feed-forward sub-layer (the residual is added by the caller).
        ``dropless``: an expert mixture routes every token (serving)."""
        cd = self.compute_dtype
        if hasattr(self, "moe"):
            return self.moe(self.ln2(x), dropless=dropless)
        h = self.ln2(x)
        if self.tp_train:
            h = copy_to_tp(self.tp_comm, h)
        h = F.gelu(_project(self.fc_in, h, cd), approximate="tanh")  # Flax's tanh form
        return _row_parallel(self.fc_out, h, cd, self.tp_comm, self.tp_train)

    def forward(self, x, positions, rope, cache=None, start=0,
                paged=None):
        x = x + self.attn(self.ln1(x), positions, rope, cache, start, paged)
        if cache is not None or paged is not None:
            return x + self.mlp(x, dropless=True)
        if self.remat_mlp:
            return x + checkpoint(self.mlp, x, use_reentrant=False)
        return x + self.mlp(x)


# The attentions over a sequence chunk of this rank (the others see the
# whole sequence).
SEQ_SHARDED = ("ring", "ring_flash", "ulysses")
_ATTN_IMPLS = ("dense", "flash", "auto", *SEQ_SHARDED)
VOCAB_PARALLEL = (None, "head", "both")


def embed_tokens(m, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding of ``tokens`` in the compute dtype, by a model or a
    pipeline stage ``m`` (its ``embed``, ``compute_dtype``, ``tp_comm`` and
    ``vocab_parallel``): a vocabulary-split lookup under "both"."""
    if m.vocab_parallel == "both":
        e = vocab_parallel_embedding(tokens, m.embed.weight, m.tp_comm)
    else:
        e = F.embedding(tokens, m.embed.weight)
    return e.to(m.compute_dtype)


def head_logits(m, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of post-``ln_f`` hidden states ``x`` by ``m``'s head: this
    rank's vocabulary columns when the head is split (``vocab_parallel``)."""
    if m.vocab_parallel is not None:
        x = copy_to_tp(m.tp_comm, x)
    return _project(m.lm_head, x, m.compute_dtype).float()


class TransformerLM(nn.Module):
    """Causal LM: tokens [B, L] → f32 logits [B, L, vocab].

    ``forward(tokens)`` is the full causal pass (``attn_impl`` dense,
    flash or auto; ring, ring_flash or ulysses on this rank's sequence chunk
    of the context-parallel group ``comm``).  ``forward(tokens, cache=...,
    start=s)`` is the decode path: writes K/V for positions s..s+L-1 into
    the cache and attends against it (prefill at s = 0, then one token per
    call, or several mid-stream: a continuation); ``s`` is a host int, or a
    [B] tensor of per-row frontiers.
    ``forward(tokens [W, 1], paged=PagedKV(...))`` is one paged decode
    step: every lane at its own position.
    ``weight_quant="int8"`` builds :class:`QuantLinear` projections (load
    weights from ``ops.quant.quantize_lm_params``).  ``kv_cache_dtype``
    (None: the compute dtype; ``torch.int8``, ``torch.bfloat16`` or
    ``torch.float32``) is the decode cache's storage; ``int8_tiered_dispatch``
    the int8 cache's tiered switch (see the module note).  ``remat`` with
    ``remat_policy`` "mlp" or "block": activation checkpointing on the
    full causal pass (see the module note).  ``head_dim`` and ``tp_comm``:
    a tensor-parallel rank's local-width model, ``vocab_parallel`` its
    training layout (None: decode's; "head": the head split by vocabulary;
    "both": the embedding too; see the module note)."""

    def __init__(self, vocab_size: int, d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 8, d_ff: int | None = None,
                 attn_impl: str = "dense",
                 compute_dtype: torch.dtype = torch.float32,
                 n_kv_heads: int | None = None, kv_cache_dtype=None,
                 weight_quant: str | None = None, remat: bool = False,
                 remat_policy: str = "mlp", device=None, comm: Comm | None = None,
                 int8_tiered_dispatch: bool = False, head_dim: int | None = None,
                 tp_comm: Comm | None = None, vocab_parallel: str | None = None):
        super().__init__()
        if attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl={attn_impl!r}; use one of {_ATTN_IMPLS}")
        if kv_cache_dtype is not None and kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be None or one of {KV_CACHE_DTYPES}, "
                             f"got {kv_cache_dtype!r}")
        if remat_policy not in ("mlp", "block"):
            raise ValueError(f"remat_policy must be 'mlp' or 'block', got "
                             f"{remat_policy!r}")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant must be None or 'int8', got "
                             f"{weight_quant!r}")
        if vocab_parallel not in VOCAB_PARALLEL:
            raise ValueError(f"vocab_parallel must be one of {VOCAB_PARALLEL}, got "
                             f"{vocab_parallel!r}")
        tp = 1 if tp_comm is None else tp_comm.world
        if vocab_parallel is not None and vocab_size % tp:
            raise ValueError(f"vocab_size={vocab_size} must be divisible by the model-axis "
                             f"size {tp} (the head is split by vocabulary)")
        self.config = dict(
            vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
            n_heads=n_heads, d_ff=d_ff, attn_impl=attn_impl,
            compute_dtype=compute_dtype, n_kv_heads=n_kv_heads,
            kv_cache_dtype=kv_cache_dtype, weight_quant=weight_quant, remat=remat,
            remat_policy=remat_policy, comm=comm,
            int8_tiered_dispatch=int8_tiered_dispatch, head_dim=head_dim,
            tp_comm=tp_comm, vocab_parallel=vocab_parallel)
        self.comm = comm or Comm()
        self.tp_comm = tp_comm
        self.vocab_parallel = vocab_parallel
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.d_ff = d_ff or 4 * d_model
        self.attn_impl = attn_impl
        self.remat = remat
        self.remat_block = remat and remat_policy == "block"
        self.compute_dtype = compute_dtype
        self.kv_cache_dtype = kv_cache_dtype
        self.weight_quant = weight_quant
        self.int8_tiered_dispatch = int8_tiered_dispatch
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.head_dim = head_dim or d_model // n_heads
        self.embed = nn.Embedding(vocab_size // tp if vocab_parallel == "both" else vocab_size,
                                  d_model, device=device)
        self.blocks = nn.ModuleList(
            self._block(device, remat_mlp=remat and remat_policy == "mlp")
            for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, compute_dtype, device)
        self.lm_head = _linear(d_model, vocab_size // tp if vocab_parallel else vocab_size,
                               weight_quant == "int8", compute_dtype, device)

    def _block(self, device, remat_mlp: bool, moe: nn.Module | None = None) -> Block:
        """One block of this config (a subclass passes its expert mixture)."""
        return Block(self.d_model, self.n_heads, self.d_ff, self.config["n_kv_heads"],
                     self.attn_impl, self.compute_dtype, self.weight_quant, device,
                     remat_mlp=remat_mlp, comm=self.config["comm"],
                     int8_tiered_dispatch=self.int8_tiered_dispatch,
                     head_dim=self.config["head_dim"], tp_comm=self.tp_comm, moe=moe,
                     tp_train=self.vocab_parallel is not None)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def clone(self, device=None, **overrides) -> "TransformerLM":
        """A new model of this class and config (with ``overrides``) on
        ``device`` (default: this model's); its weights are freshly
        initialized, not copied."""
        return type(self)(**{**self.config, **overrides},
                          device=self.device if device is None else device)

    def init_cache(self, batch: int, slots: int) -> KVCache:
        """Zeroed head-major caches [batch, Hkv, slots, D] per layer, in
        ``kv_cache_dtype`` (default the compute dtype), on the model's
        device; an int8 cache also gets zeroed f32 scales [batch, Hkv,
        slots] per layer."""
        shape = (batch, self.n_kv_heads, slots, self.head_dim)
        dtype = self.kv_cache_dtype or self.compute_dtype

        def mk(shape=shape, dtype=dtype):
            return [torch.zeros(shape, dtype=dtype, device=self.device) for _ in self.blocks]

        if dtype != torch.int8:
            return KVCache(mk(), mk())
        return KVCache(mk(), mk(), mk(shape[:3], torch.float32), mk(shape[:3], torch.float32))

    def forward(self, tokens: torch.Tensor, cache: KVCache | None = None,
                start=0, last_only: bool = False,
                paged: PagedKV | None = None,
                return_hidden: bool = False) -> torch.Tensor:
        """``last_only=True`` returns logits for the last position only
        ([B, 1, vocab]): the head runs on one row per sequence.
        ``return_hidden=True`` returns the post-``ln_f`` hidden states [B, L,
        E] in the compute dtype instead of logits, skipping the head."""
        B, L = tokens.shape
        layer_paged = None
        if paged is not None:
            if cache is not None or L != 1:
                raise ValueError("a paged decode step takes one token per lane "
                                 "and no dense cache")
            lane_pos = paged.positions.long()
            positions = lane_pos[:, None]  # [W, 1]: RoPE per lane
            bs = paged.keys[0].shape[2]
            page = paged.tables.gather(1, (lane_pos // bs)[:, None])[:, 0].long()
            layer_paged = [(k, v, paged.tables, paged.positions, page, lane_pos % bs)
                           for k, v in zip(paged.keys, paged.values)]
        elif torch.is_tensor(start):  # a frontier per row: [B, L] positions
            if cache is None:
                raise ValueError("per-row frontiers need a cache")
            start = start.to(device=tokens.device, dtype=torch.long)
            positions = start[:, None] + torch.arange(L, device=tokens.device)
        else:
            # A ring or Ulysses rank's chunk sits at rank·L in the global
            # sequence.
            offset = self.comm.rank * L if self.attn_impl in SEQ_SHARDED else start
            positions = torch.arange(offset, offset + L, device=tokens.device)
        rope = rope_tables(positions, self.head_dim)
        x = embed_tokens(self, tokens)
        for i, block in enumerate(self.blocks):
            layer_cache = None if cache is None else cache.layer(i)
            if self.remat_block and layer_cache is None and layer_paged is None:
                x = checkpoint(block, x, positions, rope, use_reentrant=False)
                continue
            x = block(x, positions, rope, layer_cache, start,
                      None if layer_paged is None else layer_paged[i])
        if last_only:
            x = x[:, -1:]
        x = self.ln_f(x)
        if return_hidden:
            return x
        return head_logits(self, x)
