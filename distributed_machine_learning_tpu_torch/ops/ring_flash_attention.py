"""Ring flash attention: context parallelism with flash chunk kernels.

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/ring_flash_attention.py``.
The sequence is sharded over the ranks of a process group; each rank keeps
its query chunk and the K/V chunks rotate around the ring (rank r sends to
r + 1), one :meth:`Comm.shift` per hop.  Each ring step merges the
visiting chunk into an online-softmax carry ``(m, l, acc)`` that stays in
f32 between steps (O(Lc) state), and no score matrix ever reaches memory.

The visiting chunk's rank ``(rank - s) % n`` picks the step's kind:

- its own chunk (step 0): the diagonal, causal within the chunk;
- an earlier chunk: full attention, no mask;
- a later chunk: the identity (no launch; the hop still happens).

The backward is the reference's second pass: ``delta = rowsum(dO * O)``
and the forward's logsumexp stay with Q; K/V rotate again with their f32
dK/dV, which every step adds to and which arrive home after n hops (a hop
on every step, on every rank).  Grouped-query attention is native: the
narrow K/V chunks travel, and dK/dV stay narrow (K13 sums each KV group's
query heads in f32 inside the block; the reference writes per-query-head
buffers and sums them in f32 outside, ``_group_sum``).

Layouts: q, dO [B, Lc, H, D] and k, v [B, Lc, Hkv, D] as the model holds
them; m, l, lse and delta f32 [B, H, Lc]; acc and dq f32 [B, Lc, H, D];
the traveling dk, dv f32 [B, Lc, Hkv, D].

Each chunk step has a kernel (``csrc/ring_flash.cu``: K11 forward, K12 dQ,
K13 dK/dV) and a plain version (``chunk_*_reference``, the reference's
tile arithmetic ``_tile_scores``/``_online_update``/``_dq_contrib``/
``_dkv_contrib`` with its blocks).  The wrappers ``_chunk_fwd``,
``_chunk_dq`` and ``_chunk_dkv`` update their accumulators in place: on
CUDA tensors by launching the kernel (anything it does not take raises),
on CPU tensors through the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distributed_machine_learning_tpu_torch.ops import build
from distributed_machine_learning_tpu_torch.ops.flash_attention import (
    LOG2E,
    NEG_INF,
    _check_kernel_inputs,
    _pick,
)

SOURCE = "ring_flash"


def _grouped(t: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, Lc, H, D] → f32 [B, Hkv, rep, Lc, D] (a KV group's query heads
    side by side)."""
    B, Lc, H, D = t.shape
    return t.permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv, Lc, D).float()


def _ungrouped(t: torch.Tensor) -> torch.Tensor:
    """f32 [B, Hkv, rep, Lc, D] → [B, Lc, H, D]."""
    B, Hkv, rep, Lc, D = t.shape
    return t.reshape(B, Hkv * rep, Lc, D).permute(0, 2, 1, 3).contiguous()


def _tiles(Lc: int, causal: bool, block: int | None):
    """(query slice, key slice, diagonal?) of every tile a chunk step runs,
    as the reference's grid and ``_dispatch_tiles`` do: square blocks of the
    largest power of two <= 512 dividing Lc; on the diagonal step the tiles
    above the diagonal are skipped and the one on it is masked."""
    blk = block or _pick(Lc, 512)
    for q0 in range(0, Lc, blk):
        for k0 in range(0, q0 + blk if causal else Lc, blk):
            yield slice(q0, q0 + blk), slice(k0, k0 + blk), causal and k0 == q0


def _masked(s: torch.Tensor, qs: slice, ks: slice) -> torch.Tensor:
    pos = torch.arange(s.shape[-1], device=s.device)
    keep = (ks.start + pos)[None, :] <= (qs.start + torch.arange(s.shape[-2],
                                                                 device=s.device))[:, None]
    return torch.where(keep, s, NEG_INF)


def chunk_fwd_reference(q, k, v, m, l, acc, causal: bool, block: int | None = None):
    """Plain version of K11: the carry ``(m, l, acc)`` after merging the
    visiting chunk k/v into it, returned as new tensors.  Scores are f32
    dots scaled into log2 space; on the diagonal the masked scores are
    -1e30 and their probability is forced to 0; P is rounded to v's dtype
    before P·V, the row sum uses the f32 P.  No normalization (the ring
    divides by l once, after its last step)."""
    B, Lc, H, D = q.shape
    Hkv = k.shape[2]
    scale = LOG2E / math.sqrt(D)
    qg = _grouped(q, Hkv)
    kf = k.permute(0, 2, 1, 3).unsqueeze(2).float()  # [B, Hkv, 1, Lc, D]
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)
    m = m.reshape(B, Hkv, H // Hkv, Lc).clone()
    l = l.reshape(B, Hkv, H // Hkv, Lc).clone()
    acc = _grouped(acc, Hkv).clone()
    for qs, ks, diag in _tiles(Lc, causal, block):
        s = (qg[..., qs, :] @ kf[..., ks, :].transpose(-1, -2)) * scale
        if diag:
            s = _masked(s, qs, ks)
        m_new = torch.maximum(m[..., qs], s.amax(-1))
        alpha = torch.exp2(m[..., qs] - m_new)
        p = torch.exp2(s - m_new[..., None])
        if diag:
            p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
        l[..., qs] = l[..., qs] * alpha + p.sum(-1)
        pv = p.to(v.dtype).float() @ vt[..., ks, :].float()
        acc[..., qs, :] = acc[..., qs, :] * alpha[..., None] + pv
        m[..., qs] = m_new
    return m.reshape(B, H, Lc), l.reshape(B, H, Lc), _ungrouped(acc)


def _p_ds(q, k, v, do, lse, delta, qs, ks, diag, scale):
    """P and dS of one tile (f32 [B, Hkv, rep, bq, bk]) from the saved lse:
    ``p = exp2(s·scale·log2e − lse)``, ``ds = p·(dO·Vᵀ − delta)·scale``."""
    s = (q[..., qs, :] @ k[..., ks, :].transpose(-1, -2)) * (scale * LOG2E)
    if diag:
        s = _masked(s, qs, ks)
    p = torch.exp2(s - lse[..., qs, None])
    if diag:
        p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
    dp = do[..., qs, :] @ v[..., ks, :].transpose(-1, -2)
    return p, p * (dp - delta[..., qs, None]) * scale


def _bwd_operands(q, k, v, do, lse, delta):
    B, Lc, H, D = q.shape
    Hkv = k.shape[2]
    kv = (t.permute(0, 2, 1, 3).unsqueeze(2).float() for t in (k, v))
    return (_grouped(q, Hkv), *kv, _grouped(do, Hkv),
            lse.reshape(B, Hkv, H // Hkv, Lc), delta.reshape(B, Hkv, H // Hkv, Lc))


def chunk_dq_reference(q, k, v, do, lse, delta, dq, causal: bool,
                       block: int | None = None):
    """Plain version of K12: ``dq`` (f32 [B, Lc, H, D]) plus this chunk
    pair's dQ, ``dS·K`` with dS rounded to k's dtype, as a new tensor."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kf, vf, dog, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    acc = _grouped(dq, k.shape[2]).clone()
    for qs, ks, diag in _tiles(q.shape[1], causal, block):
        _, ds = _p_ds(qg, kf, vf, dog, lse, delta, qs, ks, diag, scale)
        acc[..., qs, :] += ds.to(k.dtype).float() @ kf[..., ks, :]
    return _ungrouped(acc)


def chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv, causal: bool,
                        block: int | None = None):
    """Plain version of K13: the traveling ``(dk, dv)`` (f32 [B, Lc, Hkv,
    D]) plus this rank's query chunk's contribution to the visiting chunk,
    ``dSᵀ·Q`` and ``Pᵀ·dO`` (dS rounded to q's dtype, P to dO's), each KV
    group's query heads summed in f32; new tensors."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kf, vf, dog, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    gk = dk.permute(0, 2, 1, 3).float().clone()  # [B, Hkv, Lc, D]
    gv = dv.permute(0, 2, 1, 3).float().clone()
    for qs, ks, diag in _tiles(q.shape[1], causal, block):
        p, ds = _p_ds(qg, kf, vf, dog, lse, delta, qs, ks, diag, scale)
        gk[..., ks, :] += (ds.to(q.dtype).float().transpose(-1, -2) @ qg[..., qs, :]).sum(2)
        gv[..., ks, :] += (p.to(do.dtype).float().transpose(-1, -2) @ dog[..., qs, :]).sum(2)
    return gk.permute(0, 2, 1, 3).contiguous(), gv.permute(0, 2, 1, 3).contiguous()


_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 9
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 12
                + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 12
                 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _check_f32(shape, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"ring flash kernel needs {name} as a contiguous f32 "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _inputs(q, k, v, do=None):
    """Check what the kernels take; (bf16?, B, Lc, H, Hkv, D, strides)."""
    B, Lc, H, D = q.shape
    extra = {} if do is None else {"dO": do}
    bf16 = _check_kernel_inputs(q.dtype, D, q=q, k=k, v=v, **extra)
    strides = [s for t in (q, k, v, *extra.values()) for s in t.stride()[:3]]
    return bf16, B, Lc, H, k.shape[2], D, strides


def _launch_fwd(q, k, v, m, l, acc, causal: bool) -> None:
    """K11 on CUDA tensors: the carry updated in place."""
    bf16, B, Lc, H, Hkv, D, strides = _inputs(q, k, v)
    _check_f32((B, H, Lc), m=m, l=l)
    _check_f32((B, Lc, H, D), acc=acc)
    fn = build.function(SOURCE, "ring_flash_fwd", _FWD_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
                acc.data_ptr(), *strides, B, Lc, H, Hkv, D, int(bf16), int(causal),
                (1.0 / math.sqrt(D)) * LOG2E, build.stream_handle(q.device))
    build.check(status, "ring_flash_fwd")
    build.count_launch("ring_flash_fwd")


def _launch_dq(q, k, v, do, lse, delta, dq, causal: bool) -> None:
    """K12 on CUDA tensors: dq += this chunk pair's dQ, in place."""
    bf16, B, Lc, H, Hkv, D, strides = _inputs(q, k, v, do)
    _check_f32((B, H, Lc), lse=lse, delta=delta)
    _check_f32((B, Lc, H, D), dq=dq)
    fn = build.function(SOURCE, "ring_flash_dq", _DQ_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), *strides, B, Lc, H, Hkv, D, int(bf16),
                int(causal), (1.0 / math.sqrt(D)) * LOG2E, 1.0 / math.sqrt(D),
                build.stream_handle(q.device))
    build.check(status, "ring_flash_dq")
    build.count_launch("ring_flash_dq")


def _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal: bool) -> None:
    """K13 on CUDA tensors: the traveling dk, dv += this rank's query
    chunk's contribution, in place."""
    bf16, B, Lc, H, Hkv, D, strides = _inputs(q, k, v, do)
    _check_f32((B, H, Lc), lse=lse, delta=delta)
    _check_f32((B, Lc, Hkv, D), dk=dk, dv=dv)
    fn = build.function(SOURCE, "ring_flash_dkv", _DKV_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides, B, Lc, H, Hkv, D,
                int(bf16), int(causal), (1.0 / math.sqrt(D)) * LOG2E, 1.0 / math.sqrt(D),
                build.stream_handle(q.device))
    build.check(status, "ring_flash_dkv")
    build.count_launch("ring_flash_dkv")


def _chunk_fwd(q, k, v, m, l, acc, causal: bool) -> None:
    """One forward ring step: merge k/v into the carry in place (K11 on
    CUDA tensors, the plain version on CPU tensors)."""
    if q.is_cuda:
        _launch_fwd(q, k, v, m, l, acc, causal)
        return
    for t, new in zip((m, l, acc), chunk_fwd_reference(q, k, v, m, l, acc, causal)):
        t.copy_(new)


def _chunk_dq(q, k, v, do, lse, delta, dq, causal: bool) -> None:
    """dq += one chunk pair's dQ, in place (K12 / its plain version)."""
    if q.is_cuda:
        _launch_dq(q, k, v, do, lse, delta, dq, causal)
        return
    dq.copy_(chunk_dq_reference(q, k, v, do, lse, delta, dq, causal))


def _chunk_dkv(q, k, v, do, lse, delta, dk, dv, causal: bool) -> None:
    """The traveling dk, dv += one chunk pair's contribution, in place
    (K13 / its plain version)."""
    if q.is_cuda:
        _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal)
        return
    for t, new in zip((dk, dv), chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv,
                                                    causal)):
        t.copy_(new)


def step_kind(comm, s: int) -> bool | None:
    """Ring step ``s``'s kind on this rank: True for the diagonal (its own
    chunk, causal), False for an earlier chunk (full), None for a later
    chunk (the identity)."""
    src = (comm.rank - s) % comm.world
    if src == comm.rank:
        return True
    return False if src < comm.rank else None


def _ring_forward(q, k, v, comm):
    """``(out, lse)``: n chunk steps, n − 1 hops (the reference's
    ``_ring_fwd_impl``)."""
    B, Lc, H, D = q.shape
    m = torch.full((B, H, Lc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Lc, H, D), dtype=torch.float32, device=q.device)
    kv = (k, v)
    for s in range(comm.world):
        kind = step_kind(comm, s)
        if kind is not None:
            _chunk_fwd(q, *kv, m, l, acc, causal=kind)
        if s < comm.world - 1:
            kv = comm.shift(kv)
    l1 = l.clamp_min(1e-30)
    out = (acc / l1.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m + torch.log2(l1)


class _RingFlash(torch.autograd.Function):
    """The reference's custom VJP: forward saves (q, k, v, out, lse); the
    backward rotates K/V with their traveling f32 dK/dV, n hops."""

    @staticmethod
    def forward(ctx, q, k, v, comm):
        out, lse = _ring_forward(q, k, v, comm)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.comm = comm
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        comm = ctx.comm
        do = do.contiguous()
        # delta = rowsum(dO * O) in f32, [B, Lc, H] → the lse layout [B, H, Lc].
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        grads = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        payload = (k, v, grads, torch.zeros_like(grads))
        for s in range(comm.world):
            kind = step_kind(comm, s)
            kc, vc, dkc, dvc = payload
            if kind is not None:
                _chunk_dq(q, kc, vc, do, lse, delta, dq, causal=kind)
                _chunk_dkv(q, kc, vc, do, lse, delta, dkc, dvc, causal=kind)
            # Every step rotates, so the traveling dK/dV complete the circle.
            payload = comm.shift(payload)
        return dq.to(q.dtype), payload[2].to(k.dtype), payload[3].to(v.dtype), None


def ring_flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              comm) -> torch.Tensor:
    """Exact causal attention over sequence chunks sharded on ``comm``'s
    ranks (chunk r holds global positions [r·Lc, (r+1)·Lc)): q [B, Lc, H, D]
    and k/v [B, Lc, Hkv, D] (Hkv | H) → [B, Lc, H, D], differentiable in q,
    k and v.  Every rank must call it, in the same order (each call makes
    n − 1 hops forward and n backward)."""
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"want q [B,Lc,H,D] and k, v [B,Lc,Hkv,D] with Hkv | H; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _RingFlash.apply(q, k, v, comm)
