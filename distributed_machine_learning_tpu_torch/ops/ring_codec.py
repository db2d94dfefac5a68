"""The int8 ring-hop codec: K8 (encode), K9 (decode-add), K10 (decode).

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/ring_codec.py``.
Each hop of part3's compressed ring (``--ring-compress int8``) quantizes
the partial it sends (``encode_int8``, with the error-feedback residual
``v − q·scale`` when the strategy carries one), adds what arrives into its
accumulator chunk (``decode_add_int8``) and, in the all-gather, decodes the
relayed payload (``decode_int8``).  CUDA tensors go through the
hand-written kernels of ``csrc/ring_codec.cu``; CPU tensors through the
plain versions below, which are also what ``Int8Scheme(impl="xla")`` runs
on either device.

The recipe (the reference's, op for op)::

    amax  = max|v|                        (NaN propagates)
    scale = truncate(amax/127 if amax > 0 else 1)   (16 significand bits)
    q     = clip(round_half_even(v/scale), -127, 127) as int8  (NaN -> 0)

The truncated scale makes every ``q·scale`` exact in f32, so kernel, plain
version and the reference agree BIT FOR BIT (values, payload, residual);
the tests hold them to that.  The scale stays a one-element device tensor:
nothing here syncs with the host.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_machine_learning_tpu_torch.ops import build

SOURCE = "ring_codec"
ENCODE, DECODE_ADD, DECODE = "ring_encode_int8", "ring_decode_add_int8", "ring_decode_int8"
# 0xFFFFFF00 as an int32: zeroes the low 8 mantissa bits of an f32.
_SCALE_MASK = -256
_ENCODE_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_DECODE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p]


def truncate_scale(scale: torch.Tensor) -> torch.Tensor:
    """A positive f32 scale with its low 8 mantissa bits zeroed: 16
    significand bits, so ``q·scale`` (|q| ≤ 127, 7 bits) is exact in f32."""
    return (scale.view(torch.int32) & _SCALE_MASK).view(torch.float32)


def chunk_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-chunk scale from ``max|v|``: ``amax/127``, 1 for an all-zero
    (or NaN) chunk, truncated."""
    return truncate_scale(torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)))


def _quantize(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = torch.round(v / scale)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r.clamp(-127, 127)).to(torch.int8)


def quantize_chunk_int8(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K8 without residual: ``(q int8 [L], scale f32 [1])``."""
    v = v.float()
    amax = v.abs().max() if v.numel() else v.new_zeros(())
    scale = chunk_scale(amax)
    return _quantize(v, scale), scale.reshape(1)


def encode_int8_reference(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K8: ``(q, scale)``."""
    return quantize_chunk_int8(v)


def encode_int8_residual_reference(v: torch.Tensor):
    """Plain K8 with the residual: ``(q, scale, v − q·scale)``."""
    q, scale = quantize_chunk_int8(v)
    return q, scale, v.float() - q.float() * scale


def decode_add_int8_reference(q: torch.Tensor, scale: torch.Tensor,
                              acc: torch.Tensor) -> torch.Tensor:
    """Plain K9: ``acc += q·scale`` in place; returns ``acc``."""
    return acc.add_(q.float() * scale)


def decode_int8_reference(q: torch.Tensor, scale: torch.Tensor, length: int) -> torch.Tensor:
    """Plain K10: ``q·scale`` as a new f32 [length]."""
    return q[:length].float() * scale


def _check(name: str, t: torch.Tensor, dtype, device, numel: int | None = None) -> None:
    if t.dtype != dtype:
        raise ValueError(f"ring codec kernel needs {name} of {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"ring codec kernel: {name} on {t.device}, expected {device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"ring codec kernel: {name} has {t.numel()} elements, want {numel}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"ring codec kernel needs {name} contiguous and 16-byte aligned")


def _launch_encode(v: torch.Tensor, residual: bool):
    """K8 on the card: ``(q, scale)`` or ``(q, scale, err)``."""
    if v.dim() != 1:
        raise ValueError(f"ring codec kernel takes a flat chunk, got shape {tuple(v.shape)}")
    _check("v", v, torch.float32, v.device)
    n = v.numel()
    q = torch.empty(n, dtype=torch.int8, device=v.device)
    scale = torch.empty(1, dtype=torch.float32, device=v.device)
    err = torch.empty(n, dtype=torch.float32, device=v.device) if residual else None
    amax = torch.empty(1, dtype=torch.int32, device=v.device)
    fn = build.function(SOURCE, ENCODE, _ENCODE_ARGS)
    status = fn(v.data_ptr(), n, q.data_ptr(), scale.data_ptr(),
                err.data_ptr() if residual else None, amax.data_ptr(),
                8 * build.sm_count(v.device), build.stream_handle(v.device))
    build.check(status, ENCODE)
    build.count_launch(ENCODE)
    return (q, scale, err) if residual else (q, scale)


def _launch_decode_add(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """K9 on the card: ``acc += q·scale`` in place."""
    n = acc.numel()
    _check("acc", acc, torch.float32, acc.device)
    _check("q", q, torch.int8, acc.device, n)
    _check("scale", scale, torch.float32, acc.device, 1)
    fn = build.function(SOURCE, DECODE_ADD, _DECODE_ARGS)
    status = fn(q.data_ptr(), scale.data_ptr(), acc.data_ptr(), n,
                8 * build.sm_count(acc.device), build.stream_handle(acc.device))
    build.check(status, DECODE_ADD)
    build.count_launch(DECODE_ADD)
    return acc


def _launch_decode(q: torch.Tensor, scale: torch.Tensor, length: int) -> torch.Tensor:
    """K10 on the card: ``q·scale`` as a new f32 [length]."""
    _check("q", q, torch.int8, q.device, length)
    _check("scale", scale, torch.float32, q.device, 1)
    out = torch.empty(length, dtype=torch.float32, device=q.device)
    fn = build.function(SOURCE, DECODE, _DECODE_ARGS)
    status = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), length,
                8 * build.sm_count(q.device), build.stream_handle(q.device))
    build.check(status, DECODE)
    build.count_launch(DECODE)
    return out


def encode_int8(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat f32 chunk: ``(q int8 [L], scale f32 [1])``; K8 on
    CUDA tensors, its plain version on CPU tensors."""
    return _launch_encode(v, False) if v.is_cuda else encode_int8_reference(v)


def encode_int8_residual(v: torch.Tensor):
    """Quantize and emit the residual: ``(q, scale, v − q·scale)``; K8."""
    return _launch_encode(v, True) if v.is_cuda else encode_int8_residual_reference(v)


def decode_add_int8(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """One reduce-scatter arrival, in place: ``acc += q·scale``; K9."""
    if acc.is_cuda:
        return _launch_decode_add(q, scale, acc)
    return decode_add_int8_reference(q, scale, acc)


def decode_int8(q: torch.Tensor, scale: torch.Tensor, length: int) -> torch.Tensor:
    """The all-gather relay's decode: ``q·scale`` as f32 [length]; K10."""
    if q.is_cuda:
        return _launch_decode(q, scale, length)
    return decode_int8_reference(q, scale, length)
