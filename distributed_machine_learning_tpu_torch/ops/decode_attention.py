"""Flash decode: one query token against a head-major KV cache.

Counterpart of ``cached_flash_attention`` in
``distributed_machine_learning_tpu/ops/pallas/decode_attention.py``, in
its bf16/f32-cache mode (the int8-cache mode waits: the reference model
never routes int8 caches to it by default).  CUDA tensors go through the
hand-written kernel ``csrc/decode_attention.cu``; CPU tensors through
:func:`cached_attention_reference`, the reference kernel's blockwise
recurrence in PyTorch.

The position is a host int: the port tracks the decode frontier on the
host (``start + L`` is known there), so a step needs no device sync.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distributed_machine_learning_tpu_torch.ops import build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL = "decode_attention"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


def pick_block_s(S: int) -> int | None:
    """Largest divisor of S that is <= 512 and a multiple of 128 (or S
    itself when S <= 128); None when there is none."""
    if S <= 128:
        return S
    best = None
    for b in range(128, min(S, 512) + 1, 128):
        if S % b == 0:
            best = b
    return best


def decode_flash_qualifies(S: int) -> bool:
    """The reference's dispatch rule: the cache length must tile into
    full S blocks of at least 128 slots (tiny and awkward lengths take the
    einsum)."""
    b = pick_block_s(S)
    return b is not None and (b >= 128 or b == S)


def cached_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel.

    q [B, 1, H, D] at position ``pos``; caches [B, Hkv, S, D] with slot j
    holding position j.  Walks S blocks up to the one holding ``pos``
    (slots past ``pos`` are masked, never read beyond that block), with
    q cast to the cache dtype, f32 scores in log2 space, P rounded to the
    cache dtype before P·V.  Returns [B, 1, H, D] in q's dtype."""
    B, _, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    bs = pick_block_s(S)
    scale = (1.0 / math.sqrt(D)) * LOG2E
    qg = q.to(k_cache.dtype).float().reshape(B, Hkv, rep, D)
    m = torch.full((B, Hkv, rep), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for s0 in range(0, (pos // bs + 1) * bs, bs):
        kb = k_cache[:, :, s0:s0 + bs].float()
        s = torch.einsum("bhrd,bhsd->bhrs", qg, kb) * scale
        slot = s0 + torch.arange(kb.shape[2], device=q.device)
        s = torch.where(slot <= pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhrs,bhsd->bhrd", p.to(v_cache.dtype).float(),
                          v_cache[:, :, s0:s0 + bs].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: int) -> torch.Tensor:
    B, _, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    dtype = k_cache.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode kernel takes bf16 or f32 caches, got {dtype}")
    if q.dtype != dtype or v_cache.dtype != dtype:
        raise ValueError(f"decode kernel needs q and both caches in one dtype; "
                         f"got q {q.dtype}, k {dtype}, v {v_cache.dtype}")
    if D not in (32, 64, 128) or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode kernel supports head dim 32/64/128 and group "
                         f"size 1/2/4/8; got D={D}, H/Hkv={H // Hkv}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode kernel needs contiguous 16-byte aligned {name}")
    out = torch.empty_like(q)
    fn = build.function(KERNEL, "decode_attention", _ARGTYPES)
    status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), B, H, Hkv, S, D, pos,
                int(dtype == torch.bfloat16), (1.0 / math.sqrt(D)) * LOG2E,
                build.stream_handle(q.device))
    build.check(status, KERNEL)
    build.count_launch(KERNEL)
    return out


def cached_flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step of attention: q [B, 1, H, D] at position ``pos``
    (a host int) against caches [B, Hkv, S, D] → [B, 1, H, D] in q's dtype.

    On CUDA tensors: the decode kernel (reads slots 0..pos only); on CPU
    tensors: the plain version."""
    B, Lq, H, D = q.shape
    if Lq != 1:
        raise ValueError(f"decode attention is single-token (got Lq={Lq})")
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4:
        raise ValueError(f"caches must be [B, Hkv, S, D] of one shape; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k_cache.shape)}")
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache of {S} slots")
    if pick_block_s(S) is None:
        raise ValueError(f"cache length {S} does not tile; check "
                         "decode_flash_qualifies")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must lie on one device")
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, pos)
    return cached_attention_reference(q, k_cache, v_cache, pos)
