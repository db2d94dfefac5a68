"""The int8 ring-hop codec: K8 (encode), K9 (decode-add), K10 (decode).

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/ring_codec.py``.
Each hop of part3's compressed ring (``--ring-compress int8``) quantizes
the partial it sends (``encode_int8``, with the error-feedback residual
``v − q·scale`` when the strategy carries one), adds what arrives into its
accumulator chunk (``decode_add_int8``) and, after the all-gather's last
hop, decodes every payload straight into its row of the ring's output in
one call (``decode_rows_int8``; ``decode_int8`` is its one-row case).
CUDA tensors go through the hand-written kernels of
``csrc/ring_codec.cu``; CPU tensors through the
plain versions below, which are also what ``Int8Scheme(impl="xla")`` runs
on either device.  K8 is one cooperative launch (every block resident at
once, or the launch fails and the wrapper raises) whose grid, slices and
shared-memory staging :func:`encode_plan` sets.

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
from typing import NamedTuple

import torch

from distributed_machine_learning_tpu_torch.ops import build

SOURCE = "ring_codec"
ENCODE, DECODE_ADD, DECODE = "ring_encode_int8", "ring_decode_add_int8", "ring_decode_int8"
DECODE_ROWS = "ring_decode_rows_int8"  # K10's C entry; it counts as DECODE
# 0xFFFFFF00 as an int32: zeroes the low 8 mantissa bits of an f32.
_SCALE_MASK = -256
_ENCODE_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p]
_BUDGET_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
_CENSUS_ARGS = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 3
_DECODE_ADD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p]
_DECODE_ROWS_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p]
# Rows of one K10 launch: DEC_MAX_ROWS of csrc/ring_codec.cu (the row table
# is a kernel parameter); a longer list is split into launches of this many.
DECODE_ROWS_MAX = 32


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


def decode_rows_int8_reference(payloads, out: torch.Tensor, rows, length: int) -> torch.Tensor:
    """Plain batched K10: ``out[rows[k], :length] = q_k·scale_k`` for each
    payload ``(q_k, scale_k)``; the rest of ``out`` is left alone."""
    for (q, scale), i in zip(payloads, rows):
        out[i, :length] = decode_int8_reference(q, scale, length)
    return out


def _check(name: str, t: torch.Tensor, dtype, device, numel: int | None = None) -> None:
    if t.dtype != dtype:
        raise ValueError(f"ring codec kernel needs {name} of {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"ring codec kernel: {name} on {t.device}, expected {device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"ring codec kernel: {name} has {t.numel()} elements, want {numel}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"ring codec kernel needs {name} contiguous and 16-byte aligned")


# K8's launch plan.  ENCODE_MAX_GRID mirrors ENC_MAX_GRID of
# csrc/ring_codec.cu.  The rule's constants come from tools/codec_sweep.py
# --sweep on the card (PERF.md gives the readings): as many blocks as are
# resident, one an SM until a slice would pass ENCODE_ONE_BLOCK_SLICE
# elements, then two; fewer, fuller blocks only below ENCODE_MIN_SLICE
# elements a block.
ENCODE_MAX_GRID = 1024
ENCODE_ONE_BLOCK_SLICE = 16384
ENCODE_MIN_SLICE = 4096


class EncodePlan(NamedTuple):
    """K8's launch: ``grid`` co-resident blocks; block b owns elements
    ``[b·slice, (b+1)·slice)`` of the chunk (the last block fewer, plus the
    ``n % 4`` tail); the first ``staged`` of them come on chip (in the
    kernel's ENC_STAGES bulk copies), the rest of the slice is read from
    HBM/L2 again after the barrier.  ``slice`` and ``staged`` are multiples
    of 4."""

    grid: int
    slice: int
    staged: int


def encode_blocks_per_sm(n: int, sm_count: int) -> int:
    """The rule's K8 blocks an SM for a chunk of ``n``: 2 once one block an
    SM would own more than ENCODE_ONE_BLOCK_SLICE elements."""
    return 1 if n <= sm_count * ENCODE_ONE_BLOCK_SLICE else 2


def encode_plan(n: int, sm_count: int, smem_per_block: int,
                blocks_per_sm: int | None = None) -> EncodePlan:
    """K8's plan for a chunk of ``n`` f32 on ``sm_count`` SMs, a block
    staging at most ``smem_per_block`` bytes (the budget at
    ``blocks_per_sm``, by default :func:`encode_blocks_per_sm`): at most
    ``sm_count · blocks_per_sm`` blocks (all resident at once), none given
    fewer than ENCODE_MIN_SLICE elements unless the chunk is shorter, the
    slices as equal as 16-byte vectors allow."""
    if blocks_per_sm is None:
        blocks_per_sm = encode_blocks_per_sm(n, sm_count)
    nvec = n // 4
    most = max(1, min(sm_count * blocks_per_sm, ENCODE_MAX_GRID))
    blocks = min(most, max(1, -(-nvec // (ENCODE_MIN_SLICE // 4))))
    slice_vec = -(-nvec // blocks)
    grid = -(-nvec // slice_vec) if slice_vec else 1
    staged_vec = min(slice_vec, smem_per_block // 16)
    return EncodePlan(grid, 4 * slice_vec, 4 * staged_vec)


def encode_slices(plan: EncodePlan, n: int) -> list[tuple[int, int, int]]:
    """What each K8 block of ``plan`` owns of a chunk of ``n`` elements, as
    the kernel indexes it: ``(start, staged_stop, stop)``, the staged part
    ``[start, staged_stop)`` on chip and ``[staged_stop, stop)`` read from
    HBM/L2; the last block's ``stop`` takes in the ``n % 4`` tail."""
    body = n - n % 4
    out = []
    for b in range(plan.grid):
        start = min(b * plan.slice, body)
        stop = min(start + plan.slice, body)
        out.append((start, min(stop, start + plan.staged), stop))
    start, staged_stop, _ = out[-1]
    out[-1] = (start, staged_stop, n)
    return out


_budgets: dict = {}
_plans: dict = {}


def stage_budget(device, blocks_per_sm: int) -> int:
    """Bytes of shared memory a K8 block may stage with ``blocks_per_sm``
    blocks on each SM, by the occupancy calculator on the card."""
    key = (device, blocks_per_sm)
    if key not in _budgets:
        out = ctypes.c_int(0)
        fn = build.function(SOURCE, "ring_encode_stage_budget", _BUDGET_ARGS)
        with torch.cuda.device(device):  # the C side sizes the current device
            status = fn(blocks_per_sm, ctypes.byref(out))
        build.check(status, "ring_encode_stage_budget")
        _budgets[key] = out.value
    return _budgets[key]


def device_encode_plan(device, n: int) -> EncodePlan:
    """The plan K8 launches with for a chunk of ``n`` on ``device``."""
    key = (device, n)
    if key not in _plans:
        sms = build.sm_count(device)
        bps = encode_blocks_per_sm(n, sms)
        _plans[key] = encode_plan(n, sms, stage_budget(device, bps), bps)
    return _plans[key]


# K8's per-block maxima, one buffer per (device, stream).  A launch writes
# every slot it reads before the grid barrier, so the buffer is never
# zeroed (no memset), and calls in one stream never share it in flight.  A
# buffer made while a graph is captured belongs to that graph and is not
# kept (as K5's counters): warm up on the capture stream.
_partials: dict = {}


def _encode_partials(device, stream: int) -> torch.Tensor:
    have = _partials.get((device, stream))
    if have is not None:
        return have
    fresh = torch.empty(ENCODE_MAX_GRID, dtype=torch.int32, device=device)
    if not torch.cuda.is_current_stream_capturing():
        _partials[(device, stream)] = fresh
    return fresh


def _launch_encode(v: torch.Tensor, residual: bool, plan: EncodePlan | None = None):
    """K8 on the card: ``(q, scale)`` or ``(q, scale, err)``; ``plan``
    defaults to :func:`device_encode_plan`."""
    if v.dim() != 1:
        raise ValueError(f"ring codec kernel takes a flat chunk, got shape {tuple(v.shape)}")
    _check("v", v, torch.float32, v.device)
    n = v.numel()
    plan = plan or device_encode_plan(v.device, n)
    q = torch.empty(n, dtype=torch.int8, device=v.device)
    scale = torch.empty(1, dtype=torch.float32, device=v.device)
    err = torch.empty(n, dtype=torch.float32, device=v.device) if residual else None
    stream = torch.cuda.current_stream(v.device).cuda_stream
    partials = _encode_partials(v.device, stream)
    fn = build.function(SOURCE, ENCODE, _ENCODE_ARGS)
    with torch.cuda.device(v.device):  # the C side sizes and launches on the current device
        status = fn(v.data_ptr(), n, q.data_ptr(), scale.data_ptr(),
                    err.data_ptr() if residual else None, partials.data_ptr(), plan.grid,
                    plan.slice // 4, plan.staged // 4, ctypes.c_void_p(stream))
    build.check(status, ENCODE)
    build.count_launch(ENCODE)
    return (q, scale, err) if residual else (q, scale)


def graph_census(graph: torch.cuda.CUDAGraph) -> dict:
    """Kernel nodes, cooperative kernel nodes and memset nodes of a graph
    captured with ``keep_graph=True``."""
    out = [ctypes.c_int(0) for _ in range(3)]
    fn = build.function(SOURCE, "ring_codec_graph_census", _CENSUS_ARGS)
    build.check(fn(graph.raw_cuda_graph(), *(ctypes.byref(x) for x in out)),
                "ring_codec_graph_census")
    return dict(zip(("kernels", "cooperative", "memsets"), (x.value for x in out)))


def _launch_decode_add(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """K9 on the card: ``acc += q·scale`` in place."""
    n = acc.numel()
    _check("acc", acc, torch.float32, acc.device)
    _check("q", q, torch.int8, acc.device, n)
    _check("scale", scale, torch.float32, acc.device, 1)
    fn = build.function(SOURCE, DECODE_ADD, _DECODE_ADD_ARGS)
    with torch.cuda.device(acc.device):  # the C side sizes the grid for the current device
        status = fn(q.data_ptr(), scale.data_ptr(), acc.data_ptr(), n,
                    build.stream_handle(acc.device))
    build.check(status, DECODE_ADD)
    build.count_launch(DECODE_ADD)
    return acc


def _launch_decode_rows(qs, scales, dsts, length: int) -> None:
    """K10 on the card, ONE launch: ``dsts[k][:] = qs[k]·scales[k]`` for at
    most DECODE_ROWS_MAX rows, each of ``length`` elements (16-byte
    aligned, contiguous; the destinations f32 views, written in place)."""
    if not 1 <= len(dsts) <= DECODE_ROWS_MAX or not len(qs) == len(scales) == len(dsts):
        raise ValueError(f"ring codec K10 takes 1 to {DECODE_ROWS_MAX} rows a launch, each "
                         f"with codes, a scale and a destination; got {len(qs)}, "
                         f"{len(scales)}, {len(dsts)}")
    device = dsts[0].device
    for k, (q, scale, dst) in enumerate(zip(qs, scales, dsts)):
        _check(f"destination {k}", dst, torch.float32, device, length)
        _check(f"q {k}", q, torch.int8, device, length)
        _check(f"scale {k}", scale, torch.float32, device, 1)
    table = [(ctypes.c_void_p * len(dsts))(*(t.data_ptr() for t in ts))
             for ts in (qs, scales, dsts)]
    fn = build.function(SOURCE, DECODE_ROWS, _DECODE_ROWS_ARGS)
    with torch.cuda.device(device):  # launch where the stream lives
        status = fn(*table, len(dsts), length, build.stream_handle(device))
    build.check(status, DECODE_ROWS)
    build.count_launch(DECODE)


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
    """One payload's decode: ``q·scale`` as a new f32 [length]; K10 with a
    table of one row."""
    if not q.is_cuda:
        return decode_int8_reference(q, scale, length)
    out = torch.empty(length, dtype=torch.float32, device=q.device)
    _launch_decode_rows([q], [scale], [out], length)
    return out


def decode_rows_int8(payloads, out: torch.Tensor, rows, length: int) -> torch.Tensor:
    """The all-gather's decode: ``out[rows[k], :length] = q_k·scale_k`` for
    each payload ``(q_k, scale_k)``, straight into ``out`` (f32, 2-D, rows
    16-byte aligned); K10, one launch per DECODE_ROWS_MAX rows.  Returns
    ``out``."""
    if not out.is_cuda:
        return decode_rows_int8_reference(payloads, out, rows, length)
    if out.dim() != 2 or len(rows) != len(payloads):
        raise ValueError(f"ring codec K10 decodes {len(payloads)} payloads into rows {rows} "
                         f"of a 2-D out, got shape {tuple(out.shape)}")
    dsts = [out[i, :length] for i in rows]
    for k in range(0, len(dsts), DECODE_ROWS_MAX):
        part = payloads[k:k + DECODE_ROWS_MAX]
        _launch_decode_rows([q for q, _ in part], [s for _, s in part],
                            dsts[k:k + DECODE_ROWS_MAX], length)
    return out
