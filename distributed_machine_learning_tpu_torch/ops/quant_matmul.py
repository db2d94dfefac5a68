"""Weight-only int8 matmul (W8A16): ``x @ (q * scale)`` reading int8 weights.

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/quant_matmul.py``
(``int8_matmul`` over ``_kernel``, and ``quantize_int8``).  CUDA tensors go
through the hand-written kernel ``csrc/quant_matmul.cu``, on the route
:func:`int8_route` names (the wgmma mainloop for prefill, the
weight-streaming mma.sync kernel for decode, whose contraction
:func:`skinny_splits` cuts over a thread-block cluster, a byte-staged tile
for columns not a multiple of 16); CPU tensors through
:func:`int8_matmul_reference`.  Both cast x to bf16, widen the
int8 weights to bf16 exactly, accumulate in f32, scale each output column
in f32 and return ``x.dtype``.

``torch.matmul(x, w_bf16 * scale)`` computes the same function but reads
a dequantized weight from memory; the port never calls it.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_machine_learning_tpu_torch.ops import build

KERNEL = "quant_matmul"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# The skinny (decode) route, as csrc/quant_matmul.cu fixes it: at most 16
# rows; a warp owns 128 output columns and a slice of the contraction in
# k16 blocks, staged through its own ring of 5 blocks; 8 warps a block;
# at most 8 blocks (one thread-block cluster) share a column tile.
SKINNY_R, SKINNY_COLS, SKINNY_WARPS, SKINNY_STAGES, SKINNY_MAX_SPLITS = 16, 128, 8, 5, 8
# The kernel's routes, in the C entry point's numbering (csrc/quant_matmul.cu):
# the skinny weight-streaming kernel (decode; with K % 16 != 0 a byte-staged
# 16 x 64 tile), the 128 x 128 mma.sync tile that stages q byte by byte
# (columns not a multiple of 16), the wgmma/TMA mainloop.
ROUTES = ("skinny", "tile", "wgmma")
# Calls per route since the last reset (one per kernel call, as
# ``build.launches["quant_matmul"]`` counts them).
route_calls: dict[str, int] = dict.fromkeys(ROUTES, 0)


def int8_route(R: int, D: int, K: int) -> str:
    """The kernel route of an [R, D] x [D, K] product: ``"skinny"`` for R <=
    16 (decode); ``"wgmma"`` when K % 16 == 0 (TMA needs 16-byte rows of q);
    else ``"tile"`` (a byte-level LM head, vocab 257).  D takes no part: every
    route needs D % 8 == 0, which the wrapper checks."""
    del D
    if R <= SKINNY_R:
        return "skinny"
    return "wgmma" if K % 16 == 0 else "tile"


def reset_route_calls() -> None:
    for name in route_calls:
        route_calls[name] = 0


def skinny_splits(R: int, D: int, K: int, n_sms: int) -> int:
    """Blocks (one thread-block cluster, at most 8) that share a 128-column
    tile's contraction on the skinny route: about three blocks for every
    four SMs over all column tiles, as long as each warp keeps at least two
    k16 blocks; 1 off the route and for the byte-staged K % 16 != 0 case.
    (On an H100 the time per GEMM of one decode step's shapes is least at
    64-128 blocks: more splits cost more in the cluster's reduction than
    they add in bytes in flight; ``tools/decode_kernel_sweep.py --k6``.)"""
    if R > SKINNY_R or K % 16:
        return 1
    tiles = -(-K // SKINNY_COLS)
    return max(1, min(SKINNY_MAX_SPLITS, round(0.75 * n_sms / tiles),
                      -(-D // 16) // (2 * SKINNY_WARPS)))


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a [D, K] matrix:
    ``(q int8 [D, K], scale f32 [K])`` with ``w ≈ q * scale``.  An all-zero
    column gets scale 1."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16(x) @ bf16(q) with f32
    accumulation (bf16 products are exact in f32), times the column
    scale, in x's dtype."""
    acc = x.to(torch.bfloat16).float() @ q.float()
    return (acc * scale.float()).to(x.dtype)


def _launch(x: torch.Tensor, q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    R, D = x.shape
    K = q.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8 kernel returns bf16 or f32; x is {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int8 kernel takes int8 weights and f32 scales; got "
                         f"{q.dtype}, {scale.dtype}")
    if D % 8:
        raise ValueError(f"int8 kernel needs D % 8 == 0 (16-byte rows of x); "
                         f"got D={D}")
    xb = x.to(torch.bfloat16).contiguous()
    for name, t in (("x", xb), ("q", q), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8 kernel needs contiguous 16-byte aligned {name}")
    out = torch.empty((R, K), dtype=x.dtype, device=x.device)
    route = int8_route(R, D, K)
    splits = skinny_splits(R, D, K, build.sm_count(x.device))
    fn = build.function(KERNEL, "w8a16_matmul", _ARGTYPES)
    status = fn(xb.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                R, D, K, int(x.dtype == torch.bfloat16), splits, ROUTES.index(route),
                build.stream_handle(x.device))
    build.check(status, KERNEL)
    build.count_launch(KERNEL)
    route_calls[route] += 1
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """[R, D] × int8 [D, K] × f32 scale [K] → [R, K] in x's dtype.

    On CUDA tensors: the W8A16 kernel on the route :func:`int8_route`
    names (ragged R and K handled inside it); on CPU tensors: the plain
    version."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or scale.shape != (q.shape[1],):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
    if not (x.device == q.device == scale.device):
        raise ValueError("x, q and scale must lie on one device")
    if x.is_cuda:
        return _launch(x, q, scale)
    return int8_matmul_reference(x, q, scale)
