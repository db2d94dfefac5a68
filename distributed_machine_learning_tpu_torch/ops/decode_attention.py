"""Flash decode: one query token against a head-major KV cache (K4), or
against a shared paged pool through per-lane block tables (K5).

Counterparts of ``cached_flash_attention`` (both modes: bf16/f32
caches, and int8 caches with one f32 scale per (kv head, slot),
dequantized in f32) and ``paged_flash_attention`` in
``distributed_machine_learning_tpu/ops/pallas/decode_attention.py``.
CUDA tensors go through the hand-written kernels
``csrc/decode_attention.cu`` (the entry points ``decode_attention`` and
``decode_attention_int8``, counted apart) and ``csrc/paged_attention.cu``;
CPU tensors through :func:`cached_attention_reference` and
:func:`paged_attention_reference`, the kernels' blockwise recurrence in
PyTorch.

K4's position is a host int: the port tracks the decode frontier on the
host (``start + L`` is known there), so a step needs no device sync, and
the split of slots 0..pos across blocks (:func:`decode_split`) is chosen
from it.
K5's positions are a device tensor, one per lane; the kernel plans its
work units from them on the card (:func:`paged_units` models the plan),
on a grid and with a workspace that :func:`paged_plan` sizes from what the
host knows: the lanes, the kv heads and the table's width.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from distributed_machine_learning_tpu_torch.ops import build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL = "decode_attention"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])
INT8_KERNEL = "decode_attention_int8"
_INT8_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_void_p])
# Fewest slots one block of K4 walks when a row's slots are split across
# blocks (K4's block step at head dim 128 is 128 slots; below it the
# per-block merge and the combine cost more than they save).
DECODE_MIN_CHUNK = 128
# S-block targets of the reference (decode_attention.py:214): int8 caches
# stream bigger blocks; the plain version walks the same blocks, so it sums
# in the reference's order.
BLOCK_TARGET = 512
INT8_BLOCK_TARGET = 2048
PAGED_KERNEL = "paged_attention"
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
# The paged kernel's plan, as csrc/paged_attention.cu fixes it: a unit's
# slots are cut into tiles of PAGED_TILE (one ring stage); a unit holds at
# least PAGED_MIN_CHUNK slots (a tile for each of its 4 warps) and at most
# the slots whose pages fit its PAGED_TABLE staged table entries; at most
# PAGED_MAX_LANES lanes.
PAGED_TILE, PAGED_MIN_CHUNK, PAGED_TABLE, PAGED_MAX_LANES = 16, 64, 512, 1024
# Blocks of the paged kernel per SM (two fit at D 128 in bf16).
PAGED_BLOCKS_PER_SM = 2


def pick_block_s(S: int, target: int = BLOCK_TARGET) -> int | None:
    """Largest divisor of S that is <= ``target`` and a multiple of 128 (or
    S itself when S <= 128); None when there is none."""
    if S <= 128:
        return S
    best = None
    for b in range(128, min(S, target) + 1, 128):
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
                               v_cache: torch.Tensor, pos: int,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel.

    q [B, 1, H, D] at position ``pos``; caches [B, Hkv, S, D] with slot j
    holding position j.  Walks S blocks up to the one holding ``pos``
    (slots past ``pos`` are masked, never read beyond that block), f32
    scores in log2 space, online softmax with f32 state.  bf16/f32 caches:
    q cast to the cache dtype, P rounded to the cache dtype before P·V.
    int8 caches (with ``k_scale``/``v_scale`` [B, Hkv, S] f32): each block
    dequantized in f32 (``k_int · k_scale``), q cast to f32, P kept in f32,
    in 2048-slot blocks.  Returns [B, 1, H, D] in q's dtype."""
    B, _, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    quant = k_cache.dtype == torch.int8
    bs = pick_block_s(S, INT8_BLOCK_TARGET if quant else BLOCK_TARGET)
    scale = (1.0 / math.sqrt(D)) * LOG2E
    work = torch.float32 if quant else k_cache.dtype
    qg = q.to(work).float().reshape(B, Hkv, rep, D)
    m = torch.full((B, Hkv, rep), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for s0 in range(0, (pos // bs + 1) * bs, bs):
        kb = k_cache[:, :, s0:s0 + bs].float()
        vb = v_cache[:, :, s0:s0 + bs].float()
        if quant:
            kb = kb * k_scale[:, :, s0:s0 + bs, None]
            vb = vb * v_scale[:, :, s0:s0 + bs, None]
        s = torch.einsum("bhrd,bhsd->bhrs", qg, kb) * scale
        slot = s0 + torch.arange(kb.shape[2], device=q.device)
        s = torch.where(slot <= pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhrs,bhsd->bhrd", p.to(work).float(), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_split(B: int, Hkv: int, pos: int, n_sms: int) -> tuple[int, int]:
    """``(splits, chunk)``: how many blocks share the slots 0..pos of one
    (batch row, kv head) of K4 and how many contiguous slots each walks.
    As many splits as keep every block in one wave of about two blocks per
    SM (``2·n_sms // (B·Hkv)``, at least 1), but no chunk under
    :data:`DECODE_MIN_CHUNK` slots (one split holds them all when there are
    fewer); ``chunk·splits >= pos + 1``.  Reads nothing of the card but
    its SM count."""
    n = pos + 1
    want = max(1, 2 * n_sms // (B * Hkv))
    splits = max(1, min(want, n // DECODE_MIN_CHUNK))
    return splits, -(-n // splits)


def _split_workspace(q: torch.Tensor, Hkv: int,
                     pos: int) -> tuple[int, int, torch.Tensor | None]:
    """K4's ``(splits, chunk)`` for this call and its f32 scratch, allocated
    per call (per split: the partial acc [B·H, D], then m and l [B·H]; the
    kernel writes every value before the combine reads it); None with one
    split."""
    B, _, H, D = q.shape
    splits, chunk = decode_split(B, Hkv, pos, build.sm_count(q.device))
    workspace = (torch.empty(splits * B * H * (D + 2), dtype=torch.float32,
                             device=q.device) if splits > 1 else None)
    return splits, chunk, workspace


def _check_launch(q: torch.Tensor, H: int, Hkv: int, D: int, tensors: tuple) -> None:
    if D not in (32, 64, 128) or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode kernel supports head dim 32/64/128 and group "
                         f"size 1/2/4/8; got D={D}, H/Hkv={H // Hkv}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode kernel takes a bf16 or f32 query, got {q.dtype}")
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode kernel needs contiguous 16-byte aligned {name}")


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: int) -> torch.Tensor:
    """The bf16/f32 mode: q cast to the cache dtype, as the reference's
    kernel does; the output written in q's dtype (f32 straight from the
    f32 state when q is f32 and the cache bf16)."""
    B, _, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    dtype = k_cache.dtype
    if dtype not in (torch.bfloat16, torch.float32) or v_cache.dtype != dtype:
        raise ValueError(f"decode kernel takes bf16 or f32 caches of one dtype, "
                         f"got k {dtype}, v {v_cache.dtype}")
    qc = q.to(dtype).contiguous()
    _check_launch(q, H, Hkv, D, (("q", qc), ("k_cache", k_cache), ("v_cache", v_cache)))
    out_f32 = q.dtype == torch.float32
    out = torch.empty(q.shape, dtype=torch.float32 if out_f32 else dtype,
                      device=q.device)
    splits, chunk, workspace = _split_workspace(q, Hkv, pos)
    fn = build.function(KERNEL, "decode_attention", _ARGTYPES)
    status = fn(qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), None if workspace is None else workspace.data_ptr(),
                B, H, Hkv, S, D, pos, chunk, splits,
                int(dtype == torch.bfloat16), int(out_f32), (1.0 / math.sqrt(D)) * LOG2E,
                build.stream_handle(q.device))
    build.check(status, KERNEL)
    build.count_launch(KERNEL)
    return out.to(q.dtype)


def _launch_int8(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: int, k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """The int8 mode: int8 rows and f32 scales, dequantized in f32 in
    registers; q read in its own dtype (bf16 or f32), the output written in
    it."""
    B, _, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if v_cache.dtype != torch.int8:
        raise ValueError(f"int8 decode kernel needs an int8 v_cache, got {v_cache.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"int8 decode kernel needs f32 scales, got {k_scale.dtype}, "
                         f"{v_scale.dtype}")
    _check_launch(q, H, Hkv, D, (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                                 ("k_scale", k_scale), ("v_scale", v_scale)))
    out = torch.empty_like(q)
    splits, chunk, workspace = _split_workspace(q, Hkv, pos)
    fn = build.function(KERNEL, "decode_attention_int8", _INT8_ARGTYPES)
    status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                None if workspace is None else workspace.data_ptr(),
                B, H, Hkv, S, D, pos, chunk, splits, int(q.dtype == torch.bfloat16),
                (1.0 / math.sqrt(D)) * LOG2E, build.stream_handle(q.device))
    build.check(status, INT8_KERNEL)
    build.count_launch(INT8_KERNEL)
    return out


def cached_flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One decode step of attention: q [B, 1, H, D] at position ``pos``
    (a host int) against caches [B, Hkv, S, D] → [B, 1, H, D] in q's dtype.
    int8 caches need their f32 scales ``k_scale``/``v_scale`` [B, Hkv, S].

    On CUDA tensors: the decode kernel's mode for the cache dtype (reads
    slots 0..pos only); on CPU tensors: the plain version."""
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
    quant = k_cache.dtype == torch.int8
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 caches need k_scale/v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (B, Hkv, S):
                raise ValueError(f"{name} must be [B, Hkv, S] = {(B, Hkv, S)}, "
                                 f"got {tuple(t.shape)}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"k_scale/v_scale go with int8 caches, not {k_cache.dtype}")
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache of {S} slots")
    if pick_block_s(S) is None:
        raise ValueError(f"cache length {S} does not tile; check "
                         "decode_flash_qualifies")
    tensors = (q, k_cache, v_cache) + ((k_scale, v_scale) if quant else ())
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the caches and the scales must lie on one device")
    if q.is_cuda:
        if quant:
            return _launch_int8(q, k_cache, v_cache, pos, k_scale, v_scale)
        return _launch(q, k_cache, v_cache, pos)
    return cached_attention_reference(q, k_cache, v_cache, pos, k_scale, v_scale)


# ---------------------------------------------------------------------------
# Paged decode attention (K5): ragged per-lane frontiers through block tables
# ---------------------------------------------------------------------------


def paged_chunk_cap(bs: int) -> int:
    """Most slots one unit may hold: a multiple of :data:`PAGED_TILE` whose
    pages (at most (chunk - 1) // bs + 2 of them) fit the staged table."""
    return ((PAGED_TABLE - 2) * bs + 1) // PAGED_TILE * PAGED_TILE


def paged_plan(W: int, Hkv: int, MB: int, bs: int, n_sms: int) -> tuple[int, int, int]:
    """``(grid, target, max_units)`` of the paged kernel for W lanes, Hkv kv
    heads and tables of MB blocks of bs slots: ``grid`` blocks (two per SM,
    fewer when the table cannot give that many units), planning about
    ``target`` units (``grid`` less one unit per (lane, kv head) for the
    lanes' ragged last chunks), and ``max_units``, the most units any
    positions can give (the workspace's size): a lane's units number
    ceil(n / chunk) <= n / chunk + 1, and the chunk is at least the live
    slots over ``target``, or else capped at :func:`paged_chunk_cap`."""
    slots = MB * bs
    most = W * Hkv * -(-slots // PAGED_MIN_CHUNK)
    grid = max(1, min(PAGED_BLOCKS_PER_SM * n_sms, most))
    target = max(grid - W * Hkv, (grid + 1) // 2)
    capped = -(-W * Hkv * slots // paged_chunk_cap(bs))
    return grid, target, min(most, W * Hkv + max(target, capped))


def paged_units(positions, Hkv: int, MB: int, bs: int,
                n_sms: int) -> list[tuple[int, int, int, int]]:
    """The paged kernel's plan, in Python: its units ``(lane, kv head, lo,
    hi)`` in the order the kernel numbers them (unit u goes to block u mod
    grid).  Positions are clamped into the table; lane w's n = pos + 1
    slots are cut into chunks of a size every block derives from the sum
    of n over the lanes, and the units of a lane run over its kv heads,
    then its chunks."""
    W = len(positions)
    slots = MB * bs
    _, target, _ = paged_plan(W, Hkv, MB, bs, n_sms)
    ns = [min(max(int(p), 0), slots - 1) + 1 for p in positions]
    want = -(-Hkv * sum(ns) // target)
    chunk = min(paged_chunk_cap(bs),
                max(PAGED_MIN_CHUNK, -(-want // PAGED_TILE) * PAGED_TILE))
    units = []
    for w, n in enumerate(ns):
        for hk in range(Hkv):
            for lo in range(0, n, chunk):
                units.append((w, hk, lo, min(n - 1, lo + chunk - 1)))
    return units


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_tables: torch.Tensor,
                              positions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel.

    q [W, 1, H, D]; pools [num_blocks + 1, Hkv, block_size, D];
    block_tables [W, MB] int32 (lane w's logical block j lives in pool row
    ``block_tables[w, j]``); positions [W] int32 (lane w attends slots
    0..positions[w]).  Walks each lane's table page by page up to its
    frontier page (table entries past it are never read: a lane past its
    frontier re-reads that page, masked), by K4's recurrence: q cast to the
    pool dtype, f32 scores in log2 space, P rounded to the pool dtype
    before P·V.  Returns [W, 1, H, D] in q's dtype."""
    W, _, H, D = q.shape
    Hkv, bs = k_pool.shape[1], k_pool.shape[2]
    scale = (1.0 / math.sqrt(D)) * LOG2E
    qg = q.to(k_pool.dtype).float().reshape(W, Hkv, H // Hkv, D)
    pos = positions.long()
    frontier = pos // bs
    lanes = torch.arange(W, device=q.device)
    m = torch.full((W, Hkv, H // Hkv), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for j in range(int(frontier.max()) + 1):
        page = block_tables[lanes, torch.clamp(frontier, max=j)].long()
        s = torch.einsum("whrd,whsd->whrs", qg, k_pool[page].float()) * scale
        slot = j * bs + torch.arange(bs, device=q.device)
        s = torch.where((slot[None, :] <= pos[:, None])[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        p = torch.where(s > 0.5 * NEG_INF, p, 0.0)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("whrs,whsd->whrd", p.to(v_pool.dtype).float(),
                          v_pool[page].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(W, 1, H, D).to(q.dtype)


# The paged kernel's arrival counters, one per (lane, kv head), per stream:
# zero between calls (the last unit of a split lane resets its counter), so
# a call needs no memset.  Calls in one stream run in order, so they never
# share a counter in flight; calls on two streams get two buffers.  A buffer
# outgrown by more lanes or heads is kept, never freed: a CUDA graph
# captured earlier still holds its address.  A buffer made while a graph is
# captured is zeroed by that graph's own memset before each replay of the
# call, and is not kept: outside the graph it would hold garbage until the
# graph first ran.  (So warm up on the capture stream, as torch.cuda.graph
# advises, and the graph reuses that stream's buffer with no memset.)
# Serving replicas launch from several threads: a buffer is made and
# installed under a lock, so two threads growing one stream's buffer at
# once keep one buffer and never drop the other unkept.
_counters: dict = {}
_outgrown: list = []
_counters_lock = threading.Lock()


def _paged_counters(device, stream: int, n: int) -> torch.Tensor:
    with _counters_lock:
        have = _counters.get((device, stream))
        if have is not None and have.numel() >= n:
            return have
        fresh = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return fresh
        if have is not None:
            _outgrown.append(have)
        _counters[(device, stream)] = fresh
        return fresh


def _paged_launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_tables: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    W, _, H, D = q.shape
    Hkv, bs = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    dtype = k_pool.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged kernel takes bf16 or f32 pools, got {dtype}")
    if q.dtype != dtype or v_pool.dtype != dtype:
        raise ValueError(f"paged kernel needs q and both pools in one dtype; "
                         f"got q {q.dtype}, k {dtype}, v {v_pool.dtype}")
    if D not in (32, 64, 128) or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"paged kernel supports head dim 32/64/128 and group "
                         f"size 1/2/4/8; got D={D}, H/Hkv={H // Hkv}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged kernel needs contiguous 16-byte aligned {name}")
    if not (block_tables.is_contiguous() and positions.is_contiguous()):
        raise ValueError("paged kernel needs contiguous block_tables and positions")
    if W > PAGED_MAX_LANES:
        raise ValueError(f"paged kernel takes at most {PAGED_MAX_LANES} lanes, got {W}")
    grid, target, max_units = paged_plan(W, Hkv, MB, bs, build.sm_count(q.device))
    out = torch.empty_like(q)
    # Per unit: f32 partial acc [H/Hkv, D]; then running max and sum.
    workspace = torch.empty(max_units * (H // Hkv) * (D + 2), dtype=torch.float32,
                            device=q.device)
    fn = build.function(PAGED_KERNEL, "paged_attention", _PAGED_ARGTYPES)
    stream = build.stream_handle(q.device)
    counters = _paged_counters(q.device, stream.value, W * Hkv)
    status = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                workspace.data_ptr(), counters.data_ptr(),
                W, H, Hkv, D, bs, MB, k_pool.shape[0], grid, target, max_units,
                int(dtype == torch.bfloat16), (1.0 / math.sqrt(D)) * LOG2E, stream)
    build.check(status, PAGED_KERNEL)
    build.count_launch(PAGED_KERNEL)
    return out


def paged_flash_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """One decode step of attention for W lanes at their own frontiers,
    through block tables over a shared pool (the contract of
    :func:`paged_attention_reference`).

    On CUDA tensors: the paged kernel, which reads each lane's slots
    0..positions[w] only (the tables and positions are trusted there:
    checking their values would cost a device sync; the kernel clamps a
    position into its table so no read leaves it); on CPU tensors: the
    plain version, after checking that every position lies in its table
    and every table entry in the pool."""
    W, Lq, H, D = q.shape
    if Lq != 1:
        raise ValueError(f"paged decode attention is single-token (got Lq={Lq})")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must be [num_blocks, Hkv, block_size, D] of one "
                         f"shape; got {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    Hkv, bs = k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != W \
            or positions.shape != (W,):
        raise ValueError(f"need block_tables [W, MB] and positions [W] for "
                         f"W={W}; got {tuple(block_tables.shape)}, "
                         f"{tuple(positions.shape)}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError(f"block_tables and positions must be int32; got "
                         f"{block_tables.dtype}, {positions.dtype}")
    if not (q.device == k_pool.device == v_pool.device == block_tables.device
            == positions.device):
        raise ValueError("q, the pools, the tables and the positions must "
                         "lie on one device")
    if q.is_cuda:
        return _paged_launch(q, k_pool, v_pool, block_tables, positions)
    slots = block_tables.shape[1] * bs
    if bool(((positions < 0) | (positions >= slots)).any()):
        raise ValueError(f"positions {positions.tolist()} outside the tables' "
                         f"{slots} slots")
    if bool(((block_tables < 0) | (block_tables >= k_pool.shape[0])).any()):
        raise ValueError(f"block table entries outside the pool of "
                         f"{k_pool.shape[0]} blocks")
    return paged_attention_reference(q, k_pool, v_pool, block_tables, positions)
