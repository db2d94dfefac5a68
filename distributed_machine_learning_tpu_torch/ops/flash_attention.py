"""Causal flash attention, forward only: the prefill attention of serving.

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/flash_attention.py``
(``flash_self_attention`` over ``_flash_fwd``).  CUDA tensors go through
the hand-written kernel ``csrc/flash_fwd.cu``; CPU tensors through
:func:`flash_attention_reference`, the same blockwise online-softmax
recurrence written in PyTorch.  No VJP: serving needs none (the training
slice adds the backward kernels).

The length policy (``flash_wins``) and the pad path for lengths the TPU
kernel cannot tile (``_needs_pad``/``_padded_len``) are copied from the
reference so the model dispatches at the same lengths.
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
                              v: torch.Tensor,
                              block: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: causal attention by the
    blockwise online-softmax recurrence of the reference kernel.

    q [B, L, H, D], k/v [B, L, Hkv, D] (Hkv | H; query head h reads kv
    head h // (H/Hkv)) → [B, L, H, D] in q's dtype.  Scores are f32 dots
    of the input values, scaled into log2 space; masked scores are -1e30
    and their probability is forced to 0; P is rounded to V's dtype
    before P·V while the row sum uses the f32 P.  ``block`` defaults to
    the reference's block (largest power of two <= 512 dividing L); a
    length the reference pads takes blocks of 512 with a short last one,
    which is what the padded call computes for the real rows."""
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
        out[..., q0:q0 + nq, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, L, D).permute(0, 2, 1, 3).to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    bf16 = q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash kernel needs q, k, v in one dtype; "
                             f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash kernel needs {name} with a contiguous "
                             f"last dim, got strides {t.stride()}")
        # The bf16 kernel copies rows in 16-byte chunks.
        if bf16 and (any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"flash kernel needs 16-byte aligned rows of "
                             f"{name}, got strides {t.stride()}")
    if D not in (32, 64, 128):
        raise ValueError(f"flash kernel supports head dim 32, 64 or 128, got {D}")
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    fn = build.function(KERNEL, "flash_fwd", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], B, L, H, Hkv, D, int(bf16),
                (1.0 / math.sqrt(D)) * LOG2E, build.stream_handle(q.device))
    build.check(status, KERNEL)
    build.count_launch(KERNEL)
    return out


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
    """Causal attention, q [B, L, H, D] and k/v [B, L, Hkv, D] → [B, L, H, D].

    On CUDA tensors: the flash kernel (bf16 or f32, head dim 32, 64 or
    128); anything else it does not take raises.  On CPU tensors: the plain version.
    Lengths whose largest power-of-two divisor is under 128 are zero-padded
    to a multiple of 512 and sliced back, as in the reference (exact for
    causal attention: padded keys follow every real query)."""
    _check_shapes(q, k, v)
    L = q.shape[1]
    attend = _launch if q.is_cuda else flash_attention_reference
    if not _needs_pad(L):
        return attend(q, k, v)
    pad = (0, 0, 0, 0, 0, _padded_len(L) - L)
    return attend(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad))[:, :L]
