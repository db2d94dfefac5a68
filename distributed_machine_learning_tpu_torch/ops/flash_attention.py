"""Causal flash attention, forward and backward: prefill and training.

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/flash_attention.py``
(``flash_self_attention`` over ``_flash_fwd`` and ``_flash_bwd``).  The
core is a ``torch.autograd.Function`` (the reference's ``jax.custom_vjp``):
its forward saves ``(q, k, v, out, lse)``, its backward forms
``delta = rowsum(dO * O)`` in f32 and recomputes the scores tile by tile
from the saved lse.  CUDA tensors go through the hand-written kernels
(``csrc/flash_fwd.cu``: K1 with its lse; ``csrc/flash_bwd.cu``: K2 dQ and
K3 dK/dV); CPU tensors through :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`, the same blockwise recurrences
written in PyTorch.  Either way the backward never differentiates through
the forward's loop.

The length policy (``flash_wins``) and the pad path for lengths the TPU
kernel cannot tile (``_needs_pad``/``_padded_len``) are copied from the
reference so the model dispatches at the same lengths; the pad sits
outside the Function, so autograd's pad and slice route the gradients.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from distributed_machine_learning_tpu_torch.ops import build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL = "flash_fwd"
BWD_SOURCE = "flash_bwd"


def _pick(L: int, target: int) -> int:
    """Largest power-of-two block <= target that divides L."""
    b = 1
    for c in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        if c <= target and c <= L and L % c == 0:
            b = c
    return b


def _needs_pad(L: int) -> bool:
    """True when L's largest power-of-two divisor (capped at 512) is
    below 128 and is not L itself: such lengths are zero-padded."""
    bq = _pick(L, 512)
    return not (bq % 128 == 0 or bq == L)


def _padded_len(L: int) -> int:
    """Smallest multiple of 512 >= L."""
    return -(-L // 512) * 512


def flash_wins(L: int) -> bool:
    """The reference's length policy for flash over dense attention:
    always from 2048 up, from 1024 when L needs no pad, and at 512-1023
    only when 512 divides L."""
    if L >= 2048:
        return True
    if L >= 1024:
        return not _needs_pad(L)
    return L >= 512 and _pick(L, 512) == 512


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, block: int | None = None,
                              return_lse: bool = False):
    """Plain PyTorch version of K1: causal attention by the blockwise
    online-softmax recurrence of the reference kernel.

    q [B, L, H, D], k/v [B, L, Hkv, D] (Hkv | H; query head h reads kv
    head h // (H/Hkv)) → [B, L, H, D] in q's dtype, and with ``return_lse``
    also the f32 logsumexp [B, H, L] in log2 space (``m + log2(l)``, as the
    kernels write it).  Scores are f32 dots of the input values, scaled
    into log2 space; masked scores are -1e30 and their probability is forced
    to 0; P is rounded to V's dtype before P·V while the row sum uses the
    f32 P.  ``block`` defaults to the reference's block (largest power of
    two <= 512 dividing L); a length the reference pads takes blocks of 512
    with a short last one, which is what the padded call computes for the
    real rows."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    blk = block or (512 if _needs_pad(L) else _pick(L, 512))
    scale = (1.0 / math.sqrt(D)) * LOG2E
    # [B, Hkv, rep, L, D]: the query heads of one kv group side by side.
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, rep, L, D).float()
    kf = k.permute(0, 2, 1, 3).unsqueeze(2).float()  # [B, Hkv, 1, L, D]
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty_like(qg)
    lse = torch.empty(qg.shape[:-1], dtype=torch.float32, device=q.device)
    pos = torch.arange(L, device=q.device)
    for q0 in range(0, L, blk):
        qb = qg[..., q0:q0 + blk, :]
        nq = qb.shape[-2]
        m = torch.full(qb.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, q0 + nq, blk):
            s = (qb @ kf[..., k0:k0 + blk, :].transpose(-1, -2)) * scale
            causal = pos[k0:k0 + blk][None, :] <= pos[q0:q0 + nq][:, None]
            s = torch.where(causal, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
            l = l * alpha + p.sum(-1)
            pv = p.to(v.dtype).float() @ vt[..., k0:k0 + blk, :].float()
            acc = acc * alpha[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[..., q0:q0 + nq, :] = acc / l[..., None]
        lse[..., q0:q0 + nq] = m + torch.log2(l)
    out = out.reshape(B, H, L, D).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, lse.reshape(B, H, L)
    return out


def flash_attention_backward_reference(q, k, v, do, lse, delta,
                                       block: int | None = None):
    """Plain PyTorch version of K2 and K3: ``(dq, dk, dv)`` of causal
    attention from the forward's lse and ``delta = rowsum(dO * O)`` (both
    f32 [B, H, L]), tile by tile as the reference's ``_dq_contrib`` /
    ``_dkv_contrib``: ``p = exp2(s·scale·log2e − lse)`` (masked scores
    -1e30, their p forced to 0), ``dp = dO·Vᵀ``, ``ds = p·(dp − delta)·
    scale``; ``ds`` is rounded to k's dtype before ``dS·K`` and ``dSᵀ·Q``,
    ``p`` to dO's dtype before ``pᵀ·dO``, accumulation in f32.  dk and dv
    sum each KV group's query heads in f32 and round once, as K3 does (the
    reference writes them per query head in the input dtype and sums
    those).  Outputs in q's, k's and v's dtypes."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    blk = block or (512 if _needs_pad(L) else _pick(L, 512))
    scale = 1.0 / math.sqrt(D)

    def grouped(t):  # [B, L, H, D] → f32 [B, Hkv, rep, L, D]
        return t.permute(0, 2, 1, 3).reshape(B, Hkv, rep, L, D).float()

    qg, dog = grouped(q), grouped(do)
    kf = k.permute(0, 2, 1, 3).unsqueeze(2).float()  # [B, Hkv, 1, L, D]
    vf = v.permute(0, 2, 1, 3).unsqueeze(2).float()
    lse = lse.reshape(B, Hkv, rep, L)
    delta = delta.reshape(B, Hkv, rep, L)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((B, Hkv, L, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    pos = torch.arange(L, device=q.device)
    for q0 in range(0, L, blk):
        qs = slice(q0, min(q0 + blk, L))
        for k0 in range(0, qs.stop, blk):
            ks = slice(k0, k0 + blk)
            s = (qg[..., qs, :] @ kf[..., ks, :].transpose(-1, -2)) * (scale * LOG2E)
            causal = pos[ks][None, :] <= pos[qs][:, None]
            s = torch.where(causal, s, NEG_INF)
            p = torch.exp2(s - lse[..., qs, None])
            p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
            dp = dog[..., qs, :] @ vf[..., ks, :].transpose(-1, -2)
            ds = (p * (dp - delta[..., qs, None]) * scale).to(k.dtype).float()
            dq[..., qs, :] += ds @ kf[..., ks, :]
            dk[..., ks, :] += (ds.transpose(-1, -2) @ qg[..., qs, :]).sum(2)
            pt = p.to(do.dtype).float().transpose(-1, -2)
            dv[..., ks, :] += (pt @ dog[..., qs, :]).sum(2)
    dq = dq.reshape(B, H, L, D).permute(0, 2, 1, 3).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
_BWD_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
                    + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_BWD_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                     + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _check_kernel_inputs(dtype, D: int, **tensors) -> bool:
    """Raise on what the kernels do not take; True for bf16."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash kernel takes bf16 or f32, got {dtype}")
    bf16 = dtype == torch.bfloat16
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"flash kernel needs q, k, v (and dO) in one dtype; "
                             f"{name} is {t.dtype}, q is {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash kernel needs {name} with a contiguous "
                             f"last dim, got strides {t.stride()}")
        # The bf16 kernels read through TMA maps: a 16-byte aligned base
        # and strides in multiples of 16 bytes.
        if bf16 and (any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"flash kernel needs 16-byte aligned rows of "
                             f"{name}, got strides {t.stride()}")
    if D not in (32, 64, 128):
        raise ValueError(f"flash kernel supports head dim 32, 64 or 128, got {D}")
    return bf16


def _check_rows(lse: torch.Tensor, delta: torch.Tensor, shape) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"flash backward needs {name} as a contiguous f32 "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K1 on CUDA tensors: ``(out [B, L, H, D], lse f32 [B, H, L])``."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    bf16 = _check_kernel_inputs(q.dtype, D, q=q, k=k, v=v)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    fn = build.function(KERNEL, "flash_fwd", _FWD_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], B, L, H, Hkv, D, int(bf16),
                (1.0 / math.sqrt(D)) * LOG2E, build.stream_handle(q.device))
    build.check(status, KERNEL)
    build.count_launch(KERNEL)
    return out, lse


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """K2 on CUDA tensors: dq [B, L, H, D] in q's dtype."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    bf16 = _check_kernel_inputs(q.dtype, D, q=q, k=k, v=v, dO=do)
    _check_rows(lse, delta, (B, H, L))
    dq = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    fn = build.function(BWD_SOURCE, "flash_bwd_dq", _BWD_DQ_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                _strides(q, k, v, do, dq), B, L, H, Hkv, D, int(bf16),
                (1.0 / math.sqrt(D)) * LOG2E, 1.0 / math.sqrt(D),
                build.stream_handle(q.device))
    build.check(status, "flash_bwd_dq")
    build.count_launch("flash_bwd_dq")
    return dq


def _launch_dkv(q, k, v, do, lse, delta):
    """K3 on CUDA tensors: (dk, dv) [B, L, Hkv, D], each KV group's query
    heads summed."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    bf16 = _check_kernel_inputs(q.dtype, D, q=q, k=k, v=v, dO=do)
    _check_rows(lse, delta, (B, H, L))
    dk = torch.empty((B, L, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    fn = build.function(BWD_SOURCE, "flash_bwd_dkv", _BWD_DKV_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _strides(q, k, v, do, dk, dv), B, L, H, Hkv, D, int(bf16),
                (1.0 / math.sqrt(D)) * LOG2E, 1.0 / math.sqrt(D),
                build.stream_handle(q.device))
    build.check(status, "flash_bwd_dkv")
    build.count_launch("flash_bwd_dkv")
    return dk, dv


def _launch_bwd(q, k, v, do, lse, delta):
    """K2 then K3: ``(dq, dk, dv)``."""
    return (_launch_dq(q, k, v, do, lse, delta),
            *_launch_dkv(q, k, v, do, lse, delta))


class _FlashCore(torch.autograd.Function):
    """The custom-VJP core (reference ``_flash_core``): kernels on CUDA
    tensors, plain versions on CPU tensors.  ``_launch``/``_launch_bwd``
    are read at call time, so a caller can route them to plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda:
            out, lse = _launch(q, k, v)
        else:
            out, lse = flash_attention_reference(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O) in f32: O(L·D) elementwise, a plain op (the
        # reference leaves it to XLA).  [B, L, H] → [B, H, L], the lse layout.
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        if q.is_cuda:
            return _launch_bwd(q, k, v, do, lse, delta)
        return flash_attention_backward_reference(q, k, v, do, lse, delta)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q [B,L,H,D] and k, v [B,L,Hkv,D] of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, L, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != L or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"query heads {H} must be a multiple of K/V heads "
                         f"{k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def flash_self_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Causal attention, q [B, L, H, D] and k/v [B, L, Hkv, D] → [B, L, H, D],
    differentiable in q, k and v.

    On CUDA tensors: the flash kernels (bf16 or f32, head dim 32, 64 or
    128); anything else they do not take raises.  On CPU tensors: the plain
    versions.  Lengths whose largest power-of-two divisor is under 128 are
    zero-padded to a multiple of 512 and sliced back, as in the reference
    (exact for causal attention: padded keys follow every real query, and
    padded query rows get a zero dO, so they add nothing to dk and dv)."""
    _check_shapes(q, k, v)
    L = q.shape[1]
    if not _needs_pad(L):
        return _FlashCore.apply(q, k, v)
    pad = (0, 0, 0, 0, 0, _padded_len(L) - L)
    return _FlashCore.apply(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad))[:, :L]
