#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card: build, check, serve, train, time.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from ``distributed_machine_learning_tpu_torch/ops/csrc`` (one
   nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card, at
   the serving and training paths' shapes, with a stated tolerance (f32
   matmuls in the references: TF32 is switched off): K1 with its lse, K4
   in both modes (bf16, and int8 rows with f32 scales from the model's
   quantized write, q bf16 at the serving shape at B 8 and B 1, at block
   and split edges, and q f32 at a small one), K6 on its three routes
   (decode R, prefill R and a ragged prefill R at every projection shape,
   f32 x), K5, the flash backward pair K2 (dQ) and K3 (dK/dV) at the trainer's
   heads, in f32, at head dim 32, at a length ending inside their tiles
   and through the autograd Function at a padded length, and the fused
   AdamW K7 on f32, bf16 and ragged leaves (8 ulp); the ring flash chunk
   kernels K11 (forward carry), K12 (dQ) and K13 (dK/dV) at the ring
   path's chunk (B 1, Lc 4096, H 16 / Hkv 4, D 128, bf16; the diagonal
   step and a full step with a carry and accumulators in), in f32 at Lc
   32, D 32, and in bf16 at Lc 100 and 2100 (chunks that end inside a
   128-row tile), timed at a full step; K1-K3 and K11-K13 log
   their TFLOP/s, share of the bound and factor over SDPA (K12/K13 also
   their diagonal step's time), and the ptxas lines (entries, registers,
   spills, warnings) of their sources are printed.  SDPA's backward, the
   yardstick of K2/K3 (causal) and K12/K13 (non-causal), is timed under
   each fused backend pinned (``sdpa_backward_ms``); the fastest counts.
3. Serves the d2048 / 8-layer / 16-head / 4-KV-head / 32k-vocab LM
   (random weights from a seed, bf16) at batch 8 with a 4096-token prompt
   and 32 new tokens through ``make_generate_fn``: once in bf16, once with
   int8 weights.  Launch counts are zeroed just before and read just after
   those two runs; each kernel must have run, and K6's calls by route
   must be the int8 generate's: its 40 prefill projections on the wgmma
   mainloop, the head and the decode steps on the skinny tile.  The logits
   of the first step (prefill) and of the second (one decode step) are
   compared with the same model on the plain path.
4. Times each kernel (device time: a CUDA graph of the call replayed
   between CUDA events, after warm-up) beside its bound, its plain version
   and one PyTorch library call computing the same function; per mode,
   prefill + first token and the decode loop (model step + greedy sample)
   between CUDA events, repeated, as median and range; and a
   torch.profiler view of a few decode steps.
   Then the card's crossover of the tiered int8 switch: K4's int8 mode
   against the scale-folding einsum at S 32768, B 1 and 8, across fills.
4b. Serves the same model with an int8 KV cache through
   ``make_generate_fn``: (a) the default dispatch at the same traffic
   (launches: K1 once per layer, K4 in neither mode; first-two-step logits
   against the plain path; decode timing, peak memory and greedy agreement
   against the bf16-KV run); (b) the tiered switch on, B 8 × prompt 128 ×
   1024 new tokens, K4's int8 mode launched exactly where 100·p < 19·S
   (1312 times), its first 16 steps' logits against the default dispatch
   on the same tokens; (c) ``python -m ...cli.generate --random-init
   --kv-cache-dtype int8`` at full width, which must exit 0.
5. Serves the same model through the continuous-batching engine
   (``ContinuousEngine``, 8 lanes over a paged pool of 2080 blocks of 16
   slots): 16 requests of seeded prompt lengths (256-4096) and new-token
   counts (8-64), submitted at once, drained three times with the latency
   lever only and three times with both levers under a ``RegimeScheduler``.
   Launch counts are zeroed before and read after these runs: the paged
   decode kernel, flash prefill and the int8 GEMM must each have run.
   Gates: one decode step's logits with all 8 lanes at ragged positions,
   kernel path vs plain path, for both levers; every request's first token
   against the plain path.  Reports how many requests equal
   ``make_generate_fn`` at batch 1 token for token; times the engine's
   decode step, its tokens/s over a drain, prefill per prompt length and
   the device idle share over a few steps.
5b. Serves the same model through the serving fleet (``runtime/serving``
   router, ``serving_worker`` threads, an in-process hub): three engine
   replicas (ENGINE's config each, one shared model and int8 twin, a pool
   each, every one warmed on both prefill paths and both levers before
   any worker starts), 2 live and 1 spare, 32 requests of the engine
   traffic's distribution through ``router.submit``.  (a) steady, the
   latency lever: exactly once with no eviction, every request well
   formed, first tokens
   against the plain path, K1 and K5 launched; the device idle share over
   the run.  (b) under a ``RegimeScheduler``, replica 0 drained after 8
   completions and another live replica killed after 16: exactly once,
   1 eviction, 1 drain, 4 promotions, a regime flip, K6 launched.  Reports
   tokens/s beside the lone engine's drain of the same requests, request
   and per-stage latency quantiles, the longest beat gap of a live
   replica and the launches of each run; then ``python -m
   ...cli.serve --engine --replicas 2 --spares 1 --requests 64
   --drain-after 16``, which must exit 0 with the audit passing.  Step 2
   also holds K5 over 4-slot pages at head dim 32 and K6 at that CLI
   engine's shapes to their plain versions.
6. Trains the same model through ``cli.lm``'s ``build`` and
   ``train_epoch``, as its ``main`` runs them (``--parallel dp``, B 4 ×
   L 4096, bf16 compute over f32 master weights, ``--fused-update``,
   ``--attn flash``, 8 steps): launch counts zeroed just before and read
   just after, K1, K2 and K3 once per layer and K7 once per leaf in every
   step; losses finite and falling.  Reports step ms (median and range),
   tokens/s, MFU, peak memory and the device idle share; runs two steps
   with ``--remat --remat-policy mlp`` (same step-0 loss); gates one step
   kernel path vs plain path (loss, every leaf's gradient, the parameters
   after the update).  K2, K3 and K7 are timed beside their bounds, plain
   versions and one library call each (SDPA's backward, the fastest
   pinned backend; torch's fused AdamW over the same 117 tensors).

7. Trains the reference-parity VGG-11 parts through ``cli.common.run_part``,
   as their ``main`` runs it, each rank a process sharing the card (gloo
   over host buffers): part1 (world 1, batch 256), part2a, part2b and part3
   (world 2, batch 64 a rank) and part3 with ``--ring-compress int8
   --ring-codec-impl pallas`` (world 4), 40 iterations each.  Launch counts
   are zeroed just before and read just after in every rank: K8 and K9
   once per bucket per hop, K10 once per bucket (the all-gather's batched
   decode), as the formula says, and nowhere else.  Gates:
   losses finite (falling for the BN parts; the BN-free parts sit on the ln
   10 plateau for the reference's 40 iterations); every rank's synced
   gradients bit for bit equal; one int8 step through the kernels equal
   bit for bit to the same step through the plain codec, on every rank.
   Reports step ms, the sync inside the step, images/s, backend and wire;
   then part3 int8 through the real command (two processes of
   ``python -m ...cli.part3 --master-ip --rank --num-nodes``).

8. Trains the same LM context-parallel through ``cli.lm``'s ``build`` and
   ``train_epoch`` in 4 spawned ranks sharing the card (gloo over host
   buffers): ``--parallel ring --num-nodes 4``, B 1 × L 16384 (a chunk of
   4096 tokens a rank), bf16, ``--fused-update``, ``--attn flash`` (the
   upgrade rule picks ``ring_flash``), 6 steps.  Launch counts zeroed just
   before and read just after on every rank: K11, K12 and K13 once per
   layer per chunk pair (8·(r+1) a step on rank r), K1-K3 never, K7 once
   per leaf.  Gates: every rank's parameters bit for bit equal; losses
   finite and falling; the step-0 loss against the one-process dp path on
   the same batch; one step kernel path vs plain path on every rank (the
   trainer's limits).  Reports step ms, tokens/s, hop and gradient-mean ms
   a step (CUDA events), peak memory per rank and the device idle share;
   then the real command: two processes of ``python -m
   ...cli.lm --parallel ring --num-nodes 2`` at 2 layers × L 8192.

Step 2 also holds the int8 ring codec K8 (with and without residual), K9
and K10 to their plain versions BIT FOR BIT at the VGG path's chunk
lengths, a single element, a ragged length, a length past what K8 can
stage on chip, an all-zero and a NaN chunk, and chunks whose largest |v|
or NaN sits in K8's last block; K8 also in CUDA graphs replayed twice and
out of order; the batched K10 at the all-gather's (world, chunk) points,
rows in the ring's order, in one launch.  A profiler trace of one K8 call
must show one kernel and no memset, and one of an int8 ring call one K10
kernel for its all-gather and no copy after it.  All three are timed at the
VGG path's four chunk lengths, K8 with and without the residual, and the
all-gather's decode per ring call beside its bound and one ``torch.mul``.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  Exits nonzero, printing
no result, without a CUDA device or outside the repository.
``--check-only`` stops after step 2 (a short first run of new kernels).
``--perturb NAME`` builds one kernel from a deliberately broken copy of
its source (under ``build/perturbed/``; the checkout is not touched), runs
the kernel checks and the logit checks (for a training kernel: the trainer
step gates) against it, and reports which of them catch the fault: it
exits 0 only if the kernel checks catch it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# The served model and traffic.
MODEL = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
             n_kv_heads=4)
BATCH, PROMPT, NEW_TOKENS, SEED = 8, 4096, 32, 0
# The continuous engine: its config and traffic (requests submitted at once,
# each run drained ENGINE_REPEATS times).
ENGINE = dict(max_lanes=8, block_size=16, num_blocks=2080, max_len=4160)
ENGINE_REQUESTS, ENGINE_REPEATS = 16, 3
# The serving fleet: engine replicas (threads of this process, ENGINE's
# config each, one shared model and int8 twin, a paged pool each) behind
# the router over an in-process hub; FLEET_REQUESTS of engine_traffic's
# distribution.  Run (b) drains replica 0 after FLEET_DRAIN_AFTER
# completions and kills another live replica after FLEET_KILL_AFTER.  Its
# promotions: the 2 first, the spare when the drain starts, and the
# drained replica (a spare again) when the eviction heals the fleet.
FLEET = dict(replicas=2, spares=1)
FLEET_REQUESTS, FLEET_DRAIN_AFTER, FLEET_KILL_AFTER = 32, 8, 16
FLEET_PROMOTIONS = 4
# The serve CLI's --engine model on the card (heads of dim 32) and pool.
CLI_ENGINE_LM = dict(vocab_size=32, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2)
CLI_ENGINE = dict(max_lanes=4, block_size=4, num_blocks=32, max_len=16, max_new=8)
# The trainer (cli.lm --parallel dp on one card) at the model's full width.
TRAIN = dict(seq_len=4096, batch_size=4, max_iters=8)

# Kernel vs plain on the card, bf16 outputs, judged row by row (a row is
# one output vector: one query head of attention, one row of a GEMM), so
# the limit scales with what the row holds: a long attention row averages
# thousands of slots and its values are ~50x smaller than a short row's.
# The two versions run the same recurrence with f32 state but round P and
# the output to bf16 at different places (bf16 spacing 2^-8 relative).
# A row fails if one element is off by more than ROW_ELEM_TOL x max|plain
# row| (2 to 4 bf16 spacings of the row's largest value) or its rms error
# exceeds ROW_RMS_TOL x rms(plain row).  Readings on an H100 80GB HBM3
# (700 W), worst row: flash 7.8e-3 / 4.5e-3, decode 7.8e-3 / 3.7e-3, int8
# GEMM 7.6e-3 / 9.4e-4.  Leaving out the frontier slot at position 4095
# (``--perturb decode-drop-frontier-slot``) reads 4.8e-2 / 5.2e-2.  The
# paged kernel is held to the same limits.
ROW_ELEM_TOL = 2.0 ** -6
ROW_RMS_TOL = 1e-2
# First-step (prefill) and second-step (one decode step) logits, kernel
# path vs plain path of one model, max |diff| over the batch and vocab;
# logits have a standard deviation of ~1.  Set at ~2.5x the readings
# (0.037-0.039 in both steps and modes on an H100 80GB HBM3, 700 W); a
# dropped key tile reads 1.56-1.66 and a dropped GEMM K tile 1.71-2.16.
# A single left-out slot (0.043-0.063) is the kernel checks' to catch.
LOGIT_TOL = 0.1
# K1's lse (log2 space, values ~10 at L 4096), kernel vs plain, max |diff|:
# both sum the same f32 probabilities in another order, ~1e-5; a wrong
# base or a dropped key tile moves it by O(1).
LSE_TOL = 1e-3
# The attention gradients use the row gates above, with each row's scale
# bounded below by this fraction of the whole tensor's (max, rms): a few
# rows are zero in exact arithmetic and rounding noise in both versions
# (dq of query 0, which sees only key 0: there dS = P (dP - delta) and
# dP = delta = dO . v0).
GRAD_ROW_FLOOR = 1e-3
# K7 (fused AdamW) vs its plain version: the reference's parity contract,
# at most 8 ulp (in the leaf's dtype) on params and moments after one
# update; FMA contraction is the kernel's one freedom (it rounds
# b1 m + (1 - b1) g once where the plain chain rounds twice).  An ulp is
# taken at the larger of the result and the terms it sums: where b1 m and
# (1 - b1) g cancel, one rounding of a term is hundreds of ulps of the
# result (455 measured between XLA's chain and the port's on the CPU).
ADAMW_ULP_TOL = 8

# Faults for ``--perturb``: (kernel, source text, replacement[, file]),
# each a plausible bug the checks must catch; the file under ops/csrc
# holding the text defaults to the kernel's ``<kernel>.cu``.
PERTURBATIONS = {
    # Every query tile past the first loses key tile 0 (128 keys).  The
    # forward mainloop lives in the header K1 and K11 share; the fault is
    # K1's alone.
    "flash-drop-first-tile": (
        "flash_fwd",
        "const bool edge = (CAUSAL && j == qt) || ((j + 1) * BKV > L);\n      if (edge) {\n"
        "#pragma unroll\n        for (int i = 0; i < BKV / 2; ++i) {\n"
        "          float val = s[i] * scale_log2;",
        "const bool edge = (CAUSAL && j == qt) || ((j + 1) * BKV > L) || (KIND == FLASH && j == 0"
        " && qt > 0);\n      if (edge) {\n#pragma unroll\n        for (int i = 0; i < BKV / 2; ++i)"
        " {\n          float val = (KIND == FLASH && j == 0 && qt > 0) ? NEG_INF : s[i] * scale_log2;",
        "flash_fwd_sm90.cuh"),
    # Every query past the first tile loses its own key (the diagonal).
    "flash-drop-diagonal": (
        "flash_fwd", "if ((CAUSAL && key > row) || key >= L) val = NEG_INF;",
        "if ((CAUSAL && key > row - (KIND == FLASH && row >= BQ)) || key >= L) val = NEG_INF;",
        "flash_fwd_sm90.cuh"),
    # The decode step leaves out the slot at the frontier (pos itself): the
    # last split's walk stops one slot short.
    "decode-drop-frontier-slot": (
        "decode_attention", "const int hi = min(pos, lo + chunk - 1);",
        "const int hi = min(pos - 1, lo + chunk - 1);"),
    # K4's combine leaves out the last split's partial.
    "decode-drop-last-split": (
        "decode_attention", "for (int s = 0; s < splits; ++s) {",
        "for (int s = 0; s < splits - 1; ++s) {"),
    # K4's int8 mode ignores the V scales (dequantizes V by 1).
    "decode-int8-ignore-v-scale": (
        "decode_attention", "vsc[u] = C::QUANT ? __ldg(vsb + slot) : 1.f;",
        "vsc[u] = 1.f;"),
    # The wgmma mainloop skips the last k-tile of the contraction (producer
    # and consumers alike, so nothing waits on a tile never loaded).
    "int8-drop-last-ktile": (
        "quant_matmul", "const int nk = (D + WG_BK - 1) / WG_BK;  // k-tiles of the contraction",
        "const int nk = max(1, (D + WG_BK - 1) / WG_BK - 1);"),
    # The wgmma route's widening leaves each tile's last d-row at zero.
    "int8-widen-drop-last-row": (
        "quant_matmul", "raw[i] = *reinterpret_cast<const uint4*>(",
        "raw[i] = r == WG_BK - 1 ? make_uint4(0u, 0u, 0u, 0u) : *reinterpret_cast<const uint4*>("),
    # The decode (skinny) route drops the last stage (k16 block) of the
    # contraction.
    "int8-skinny-drop-last-ktile": (
        "quant_matmul",
        "const int nkb = (D + 15) / 16;", "const int nkb = (D + 15) / 16 - 1;"),
    # The skinny route's cluster reduction leaves out the last block's slice.
    "int8-skinny-drop-split": (
        "quant_matmul", "for (int s = 0; s < splits; ++s) {",
        "for (int s = 0; s < splits - 1; ++s) {"),
    # The paged step stages logical block j as physical block j.
    "paged-ignore-table": (
        "paged_attention", "tables[static_cast<size_t>(w) * MB + p0 + i]", "p0 + i"),
    # The paged step leaves out the slot at each lane's frontier.
    "paged-drop-frontier-slot": (
        "paged_attention", "const int hi = min(s_n[w] - 1, lo + chunk - 1);",
        "const int hi = min(s_n[w] - 2, lo + chunk - 1);"),
    # The merge of a split lane leaves out its last unit.
    "paged-drop-last-unit": (
        "paged_attention", "const int nb = min(G::MERGE_UNITS, cw - b0);",
        "const int nb = min(G::MERGE_UNITS, cw - b0 - 1);"),
    # K2 leaves out each query row's diagonal key tile (the 64 keys that
    # hold its own).  K2 and K3 run on the backward header's FLASH kind,
    # beside the ring's K12 and K13; these two faults are K2's and K3's
    # alone.
    "dq-drop-diagonal-tile": (
        "flash_bwd", "s[i] = masked<CAUSAL>(row, key, L) ? 0.f",
        "s[i] = masked<CAUSAL>(row, key, L) || (KIND == FLASH && key >= (row & ~(BKV - 1))) ? 0.f",
        "flash_bwd_sm90.cuh"),
    # K3 leaves out the last query tile of every query head.
    "dkv-drop-last-qtile": (
        "flash_bwd", "const int nq = (L + BQT - 1) / BQT - first_qt;",
        "const int nq = (L + BQT - 1) / BQT - first_qt - (KIND == FLASH);",
        "flash_bwd_sm90.cuh"),
    # The fused AdamW update drops the bias correction.
    "adamw-drop-bias-correction": (
        "fused_adamw", "(m / h.bc1) / (sqrtf(v / h.bc2) + h.eps)",
        "m / (sqrtf(v) + h.eps)"),
    # K8 keeps the full-precision scale (no truncation to 16 significand bits).
    "codec-no-scale-truncation": (
        "ring_codec", "return __uint_as_float(__float_as_uint(s) & SCALE_MASK);",
        "return s;"),
    # K9's last block skips the ragged tail (n % 16 elements).
    "codec-decode-add-skip-tail": (
        "ring_codec", "acc[j] = acc[j] + static_cast<float>(q[j]) * s;", "(void)j;"),
    # The batched K10 drops the last row of its table.
    "codec-rows-skip-last": (
        "ring_codec",
        "const dim3 grid(static_cast<unsigned>(tiles_for(n)), static_cast<unsigned>(rows));",
        "const dim3 grid(static_cast<unsigned>(tiles_for(n)), static_cast<unsigned>(rows - "
        "(rows > 1)));"),
    # K10 leaves each row's ragged tail (n % 16 elements) unwritten.
    "codec-decode-drop-tail16": (
        "ring_codec", "dst[j] = static_cast<float>(q[j]) * s;", "(void)j;"),
    # After K8's grid barrier each block scales by its own max alone.
    "codec-own-partial-only": (
        "ring_codec",
        "amax = max(amax, __ldcg(partials + b));",
        "amax = m;"),
    # K8 skips the ragged tail (n % 4 elements) in both passes.
    "codec-drop-tail": (
        "ring_codec",
        "const int tail = blockIdx.x == gridDim.x - 1 ? static_cast<int>(n - nvec * 4) : 0;",
        "const int tail = 0;"),
    # K8 skips the part of a slice past what shared memory stages.
    "codec-drop-overflow": (
        "ring_codec", "const long long end = hi;", "const long long end = lo + on_chip;"),
    # K11 ignores the carry in: every step starts from an empty (m, l, acc).
    "ring-fwd-ignore-carry": (
        "ring_flash", "const bool has_carry = row < L;  // padded rows start empty",
        "const bool has_carry = false;", "flash_fwd_sm90.cuh"),
    # K12 skips the last key tile of its walk.  K12 and K13's mainloops
    # live in the backward header.
    "ring-dq-skip-last-tile": (
        "ring_flash",
        "const int n_tiles = (min(CAUSAL ? q0 + BQ : L, L) + BKV - 1) / BKV;  // dQ's key-tile walk",
        "const int n_tiles = (min(CAUSAL ? q0 + BQ : L, L) + BKV - 1) / BKV - 1;",
        "flash_bwd_sm90.cuh"),
    # K13 adds only the first query head of each KV group.
    "ring-dkv-first-head-only": (
        "ring_flash", "const int n_iters = rep * nq;  // (query head of the group, query tile)",
        "const int n_iters = nq;", "flash_bwd_sm90.cuh"),
    # The diagonal step's mask drops each row's own key, in K12 and K13.
    "ring-bwd-drop-diagonal": (
        "ring_flash", "return (CAUSAL && key > row) || key >= L || row >= L;",
        "return (CAUSAL && key >= row) || key >= L || row >= L;", "flash_bwd_sm90.cuh"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


_CAPTURE_STREAM = None  # time_ms's warm-up and capture stream, made on first use


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms of one ``fn()``: captured once in a CUDA graph and replayed
    ``iters`` times between CUDA events, so the Python and launch overhead
    of the wrappers is not in the number (the host side is timed end to end
    by ``time_serving``).  The warm-up runs on the capture stream, so state
    a wrapper keeps per stream (K5's arrival counters) exists before the
    capture and the graph holds the kernels alone."""
    import torch

    global _CAPTURE_STREAM
    if _CAPTURE_STREAM is None:
        _CAPTURE_STREAM = torch.cuda.Stream()
    _CAPTURE_STREAM.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(_CAPTURE_STREAM):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=_CAPTURE_STREAM):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def compare(name: str, got, want, failed: list, floor: float = 0.0,
            tol: tuple = (ROW_ELEM_TOL, ROW_RMS_TOL)) -> float:
    """Hold a kernel's output against its plain version row by row (see
    ROW_ELEM_TOL; ``tol`` is (element, rms)); returns the max abs error,
    appends ``name`` to ``failed`` if a row is out of tolerance.  ``floor``
    (a fraction of the whole output's largest value, resp. rms) bounds each
    row's scale from below, for outputs with rows that are zero in exact
    arithmetic (see GRAD_ROW_FLOOR)."""
    import torch

    elem_tol, rms_tol = tol
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = got - want
    tiny = torch.finfo(torch.float32).tiny
    peak = max(floor * float(want.abs().max()), tiny)
    level = max(floor * float(want.square().mean().sqrt()), tiny)
    elem = err.abs().amax(-1) / want.abs().amax(-1).clamp_min(peak)
    rms = err.square().mean(-1).sqrt() / want.square().mean(-1).sqrt().clamp_min(level)
    bad = int(((elem > elem_tol) | (rms > rms_tol)).sum())
    max_abs = float(err.abs().max())
    log(f"  {name}: max_abs_err={max_abs:.3e}, worst row: elem_err/max|ref|="
        f"{float(elem.max()):.3e} (tol {elem_tol:.4g}), rms_err/rms(ref)="
        f"{float(rms.max()):.3e} (tol {rms_tol:g}) -> "
        f"{'ok' if not bad else f'{bad} of {len(rms)} rows BAD'}")
    if bad:
        failed.append(name)
    return max_abs


def raise_failed(failed: list) -> None:
    if failed:
        raise AssertionError(f"outside tolerance: {'; '.join(failed)}")


def plain_decode_rows(qs, scales, dsts, length: int) -> None:
    """K10's launcher as its plain version: each row decoded into its
    destination."""
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    for q, scale, dst in zip(qs, scales, dsts):
        dst.copy_(rc.decode_int8_reference(q, scale, length))


@contextlib.contextmanager
def plain_kernels(ring_block: int | None = None):
    """Route the model's, the trainers', the ring codec's and the ring
    attention's kernel entry points to their plain PyTorch versions, on the
    card too: the reference the kernel path is held to.  Attention without
    a gradient (serving) takes the plain forward directly; with one
    (training) it takes the port's autograd Function with its forward and
    backward launchers swapped for the plain versions, so the backward
    never runs through the forward's loop.  ``ring_block``: the tile of the
    ring chunk steps' plain versions (default: the reference's)."""
    import torch

    from distributed_machine_learning_tpu_torch.models import transformer
    from distributed_machine_learning_tpu_torch.ops import decode_attention as da
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops import fused_adamw as fadam
    from distributed_machine_learning_tpu_torch.ops import quant
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    flash = fa.flash_self_attention

    def in_place(plain, n_out):
        """A ring chunk step's plain version, writing into its accumulators
        (the last ``n_out`` tensor arguments) as the kernel does."""
        def run(*args):
            outs = plain(*args, block=ring_block)
            for t, new in zip(args[-1 - n_out:-1], outs if n_out > 1 else (outs,)):
                t.copy_(new)
        return run

    def plain_flash(q, k, v):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return flash(q, k, v)
        return fa.flash_attention_reference(q, k, v)

    swaps = [(transformer, "flash_self_attention", plain_flash),
             (fa, "_launch", lambda q, k, v: fa.flash_attention_reference(
                 q, k, v, return_lse=True)),
             (fa, "_launch_bwd", fa.flash_attention_backward_reference),
             (fadam, "_launch", fadam.fused_adamw_reference),
             (transformer, "cached_flash_attention", da.cached_attention_reference),
             (transformer, "paged_flash_attention", da.paged_attention_reference),
             (quant, "int8_matmul", qm.int8_matmul_reference),
             (rc, "_launch_encode", lambda v, residual: (
                 rc.encode_int8_residual_reference(v) if residual
                 else rc.encode_int8_reference(v))),
             (rc, "_launch_decode_add", rc.decode_add_int8_reference),
             (rc, "_launch_decode_rows", plain_decode_rows),
             (rf, "_launch_fwd", in_place(rf.chunk_fwd_reference, 3)),
             (rf, "_launch_dq", in_place(rf.chunk_dq_reference, 1)),
             (rf, "_launch_dkv", in_place(rf.chunk_dkv_reference, 2))]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    try:
        for mod, attr, fn in swaps:
            setattr(mod, attr, fn)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_flash(torch, fa, rows: dict, timing: bool) -> None:
    B, H, Hkv, D = 8, 16, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, failed = [], []
    for L in (4096, 2100):  # 2100 takes the pad path (to 2560)
        q = torch.randn(B, L, H, D, device="cuda", generator=gen).bfloat16()
        k = torch.randn(B, L, Hkv, D, device="cuda", generator=gen).bfloat16()
        v = torch.randn(B, L, Hkv, D, device="cuda", generator=gen).bfloat16()
        got = fa.flash_self_attention(q, k, v)
        _, lse = fa._launch(q, k, v)  # the kernel on these rows as they are
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_reference(q, k, v, return_lse=True)
        errs.append(compare(f"flash_fwd B={B} L={L} H={H} Hkv={Hkv} D={D}", got,
                            want, failed))
        lse_err = float((lse - want_lse).abs().max())
        log(f"  flash_fwd lse L={L}: max_abs_err={lse_err:.3e} (tol {LSE_TOL:g}) -> "
            f"{'ok' if lse_err <= LSE_TOL else 'BAD'}")
        if not lse_err <= LSE_TOL:
            failed.append(f"flash_fwd lse L={L}")
        rows.setdefault("flash_fwd", {})["max_abs_err"] = max(errs)
        if L != 4096 or not timing:
            continue
        flops = 2.0 * 2.0 * D * (L * (L + 1) / 2) * B * H
        nbytes = 2 * (2 * B * L * H * D + 2 * B * L * Hkv * D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                      (q, k.repeat_interleave(H // Hkv, 2),
                       v.repeat_interleave(H // Hkv, 2)))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows["flash_fwd"].update(
            ms=time_ms(lambda: fa.flash_self_attention(q, k, v)),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(q, k, v), iters=3),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            **bound(flops, BF16_FLOPS, nbytes),
            shape=f"B={B} L={L} H={H} Hkv={Hkv} D={D} bf16, one call per layer")
        log_rate("flash_fwd", rows["flash_fwd"], flops, "SDPA causal")
    raise_failed(failed)


def log_rate(name: str, row: dict, flops: float, library: str) -> None:
    """A timed kernel's achieved rate, its share of the bound and its factor
    over the library call."""
    log(f"  {name}: {row['ms']:.4f} ms, {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.1%} of its {row['bound_ms']:.4f} ms bound "
        f"({row['bound_by']}), {row['ms'] / row['library_ms']:.2f}x {library} "
        f"({row['library_ms']:.4f} ms)")


def bound(ops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# K2/K3 check cases (B, L, H, Hkv, D, dtype): the trainer's heads at B 1,
# an f32 case, a head-dim-32 case at small L and a length that ends inside
# K2's 128-row and K3's 64-row tiles; the padded length runs through the
# autograd Function in check_flash_bwd.
BWD_CASES = [(1, 4096, 16, 4, 128, "bfloat16"), (1, 1024, 4, 2, 64, "float32"),
             (2, 512, 4, 2, 32, "bfloat16"), (2, 200, 8, 2, 128, "bfloat16")]
BWD_PAD_CASE = (1, 2100, 16, 4, 128, "bfloat16")  # pads to 2560


def bwd_inputs(torch, fa, B, L, H, Hkv, D, dtype, gen):
    """q, k, v, dO and the plain forward's lse and delta = rowsum(dO o O):
    the backward kernels and their plain version get the same inputs."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(B, L, n, D, device="cuda", generator=gen).to(dt)
                   for n in (H, Hkv, Hkv, H))
    out, lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def check_flash_bwd(torch, fa, rows: dict, timing: bool) -> None:
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs: dict = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    failed: list = []
    for case in BWD_CASES:
        args = bwd_inputs(torch, fa, *case, gen)
        dq = fa._launch_dq(*args)
        dk, dv = fa._launch_dkv(*args)
        torch.cuda.synchronize()
        want = fa.flash_attention_backward_reference(*args)
        label = "B={} L={} H={} Hkv={} D={} {}".format(*case)
        errs["flash_bwd_dq"].append(compare(f"flash_bwd_dq {label}", dq, want[0], failed,
                                            GRAD_ROW_FLOOR))
        for name, got, ref in (("dk", dk, want[1]), ("dv", dv, want[2])):
            errs["flash_bwd_dkv"].append(compare(f"flash_bwd_dkv {name} {label}", got, ref,
                                                 failed, GRAD_ROW_FLOOR))
    # A padded length through the autograd Function (pad and slice outside).
    B, L, H, Hkv, D, dtype = BWD_PAD_CASE
    q, k, v, do, _, _ = bwd_inputs(torch, fa, *BWD_PAD_CASE, gen)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(fa.flash_self_attention(q, k, v), (q, k, v), do)
    with plain_kernels():
        want = torch.autograd.grad(fa.flash_self_attention(q, k, v), (q, k, v), do)
    label = f"B={B} L={L} (padded) H={H} Hkv={Hkv} D={D} {dtype}, autograd"
    errs["flash_bwd_dq"].append(compare(f"flash_bwd_dq {label}", got[0], want[0], failed,
                                        GRAD_ROW_FLOOR))
    for name, i in (("dk", 1), ("dv", 2)):
        errs["flash_bwd_dkv"].append(compare(f"flash_bwd_dkv {name} {label}", got[i], want[i],
                                             failed, GRAD_ROW_FLOOR))
    for name, e in errs.items():
        rows[name] = {"max_abs_err": max(e)}
    raise_failed(failed)
    if not timing:
        return
    B, L, H, Hkv, D = TRAIN["batch_size"], TRAIN["seq_len"], MODEL["n_heads"], \
        MODEL["n_kv_heads"], MODEL["d_model"] // MODEL["n_heads"]
    args = bwd_inputs(torch, fa, B, L, H, Hkv, D, "bfloat16", gen)
    pairs = B * H * L * (L + 1) / 2.0
    row_bytes = 2 * 4 * B * H * L  # lse and delta, f32
    qo = 2 * B * L * H * D  # one bf16 [B, L, H, D]
    kv = 2 * B * L * Hkv * D
    plain_ms = time_ms(lambda: fa.flash_attention_backward_reference(*args), iters=2,
                       warmup=1)
    # The yardstick: SDPA's backward (one call gives dq, dk and dv), the
    # fastest fused backend.
    library_ms, backend = sdpa_backward_ms(torch, *args[:4], True, "causal")
    shape = (f"B={B} L={L} H={H} Hkv={Hkv} D={D} bf16, one call per layer per step; "
             "plain and library ms are of the whole backward (dq, dk, dv); library: SDPA "
             f"backward, causal, {backend}")
    rows["flash_bwd_dq"].update(
        ms=time_ms(lambda: fa._launch_dq(*args)), plain_ms=plain_ms, library_ms=library_ms,
        **bound(6.0 * D * pairs, BF16_FLOPS, 3 * qo + 2 * kv + row_bytes), shape=shape)
    rows["flash_bwd_dkv"].update(
        ms=time_ms(lambda: fa._launch_dkv(*args)), plain_ms=plain_ms, library_ms=library_ms,
        **bound(8.0 * D * pairs, BF16_FLOPS, 2 * qo + 4 * kv + row_bytes), shape=shape)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        r = rows[name]
        flops = (6.0 if name == "flash_bwd_dq" else 8.0) * D * pairs
        log(f"  {name}: {r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.1%} of its {r['bound_ms']:.4f} ms bound), plain "
            f"backward {plain_ms:.2f}, SDPA backward {library_ms:.4f} ({backend})")
    pair = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    log(f"  K2 + K3: {pair:.4f} ms, {pair / library_ms:.2f}x SDPA's backward ({backend})")


def ulp_err(got, want, *terms) -> float:
    """max |got - want| in units of the last place (of want's dtype: 24
    significant bits for f32, 8 for bf16) of the larger of |want| and the
    |terms| it sums (see ADAMW_ULP_TOL)."""
    import torch

    bits = 8 if want.dtype == torch.bfloat16 else 24
    scale = want.float().abs()
    for t in terms:
        scale = torch.maximum(scale, t.abs())
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - bits)
    return float(((got.float() - want.float()).abs() / ulp).max())


def adamw_ulp_errs(got, want, old, cfg) -> list:
    """ulp errors of (p, mu, nu) after one update from ``old`` (p, mu, nu,
    g), each at the scale of the terms the update sums."""
    p, mu, nu, g = (t.float() for t in old)
    terms = ([p], [cfg.beta1 * mu, (1 - cfg.beta1) * g],
             [cfg.beta2 * nu, (1 - cfg.beta2) * g * g])
    return [ulp_err(got[i], want[i], *terms[i]) for i in range(3)]


def adamw_scalars(step: int, config):
    """lr, bc1, bc2 as the trainer computes them (f32, from the step)."""
    from distributed_machine_learning_tpu_torch.train.adamw import bias_corrections

    return (config.learning_rate, *bias_corrections(config, step))


def check_adamw(torch, fadam, rows: dict, timing: bool) -> None:
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig

    cfg = AdamWConfig()
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def leaf(n, dtype):
        """A leaf of n params at step 10 with non-zero moments."""
        p = (0.02 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
        mu = 1e-3 * torch.randn(n, device="cuda", generator=gen)
        nu = 1e-6 * torch.rand(n, device="cuda", generator=gen)
        g = (1e-3 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
        return p, mu, nu, g

    worst, worst_abs, failed = 0.0, 0.0, []
    # An f32 leaf, a bf16 leaf, a length that is no multiple of the vector.
    for n, dtype in ((2048 * 2048, torch.float32), (2048 * 1024, torch.bfloat16),
                     (1_000_003, torch.float32), (1_000_003, torch.bfloat16)):
        state = leaf(n, dtype)
        got = [t.clone() for t in state]
        want = [t.clone() for t in state]
        fadam.fused_adamw_leaf(*got, *adamw_scalars(10, cfg), **hyper)
        torch.cuda.synchronize()
        fadam.fused_adamw_reference(*want, *adamw_scalars(10, cfg), **hyper)
        errs = adamw_ulp_errs(got, want, state, cfg)
        worst = max(worst, *errs)
        worst_abs = max(worst_abs, *(float((got[i].float() - want[i].float()).abs().max())
                                     for i in range(3)))
        ok = max(errs) <= ADAMW_ULP_TOL and all(bool(torch.isfinite(t).all()) for t in got)
        log(f"  fused_adamw n={n} {str(dtype)[6:]}: ulp error p/mu/nu "
            f"{errs[0]:.0f}/{errs[1]:.0f}/{errs[2]:.0f} (tol {ADAMW_ULP_TOL}) -> "
            f"{'ok' if ok else 'BAD'}")
        if not ok:
            failed.append(f"fused_adamw n={n} {dtype}")
    rows["fused_adamw"] = {"max_abs_err": worst_abs, "max_ulp_err": worst}
    raise_failed(failed)
    if not timing:
        return
    # Every leaf of the trainer's model (f32 params), one launch each.
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM

    shapes = [p.shape for p in TransformerLM(**MODEL, device="meta").parameters()]
    leaves = [leaf(math.prod(s), torch.float32) for s in shapes]
    n = sum(p.numel() for p, *_ in leaves)
    lr, bc1, bc2 = adamw_scalars(10, cfg)

    def run(update):
        for p, mu, nu, g in leaves:
            update(p, mu, nu, g, lr, bc1, bc2, **hyper)

    ms = time_ms(lambda: run(fadam.fused_adamw_leaf), iters=5, warmup=1)
    plain_ms = time_ms(lambda: run(fadam.fused_adamw_reference), iters=2, warmup=1)
    params = [p.clone().requires_grad_() for p, *_ in leaves]
    for q, (_, _, _, g) in zip(params, leaves):
        q.grad = g.clone()
    opt = torch.optim.AdamW(params, lr=lr, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
                            weight_decay=cfg.weight_decay, fused=True)
    library_ms = eager_ms(torch, opt.step, iters=5)
    rows["fused_adamw"].update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound(15.0 * n, F32_FLOPS, 28 * n),
        shape=f"all {len(leaves)} leaves of the model ({n} f32 params), one launch per "
              "leaf; library: torch.optim.AdamW(fused=True).step() over the same tensors")
    log(f"  fused_adamw, {len(leaves)} leaves, {n} params: {ms:.3f} ms "
        f"({28 * n / ms / 1e9:.2f} TB/s), bound {rows['fused_adamw']['bound_ms']:.3f}, plain "
        f"{plain_ms:.2f}, torch fused AdamW {library_ms:.3f}")


# The int8 ring codec K8-K10, held BITWISE to its plain version (the
# reference's contract: a truncated scale makes every q * scale exact): the
# chunk lengths of the VGG path (VGG-11 with BN, 9,231,114 parameters in 25
# MiB buckets of 6,553,600 + 2,677,514: at world 4, the part3 int8 phase,
# then at world 2, the cli.part3 run), a single element,
# a ragged 4097 and the whole gradient as one chunk (CODEC_OVER_CAPACITY:
# 36.9 MB, past what the card's shared memory can stage, so K8 reads each
# slice's excess from HBM twice); then an all-zero chunk, a chunk holding
# one NaN, and chunks whose largest |v| or NaN sits in the last block's
# slice (the last element: the ragged tail).
CODEC_PATH_LENGTHS = (1_638_400, 669_379, 3_276_800, 1_338_757)
CODEC_OVER_CAPACITY = 9_231_114
CODEC_LENGTHS = (*CODEC_PATH_LENGTHS, 1, 4097, CODEC_OVER_CAPACITY)
# The all-gather's batched K10 at the path's (world, chunk length) points:
# world 4 is the part3 int8 phase, world 2 the cli.part3 run.
CODEC_ALLGATHER = ((4, 1_638_400), (4, 669_379), (2, 3_276_800), (2, 1_338_757))
CODEC_SETS = 8  # fewest buffer sets the codec timings rotate over (past the L2)
CODEC_ROTATE_BYTES = 200e6  # operand bytes the sets span at least (4x the L2)


def codec_row(name: str, n: int, residual: bool = True,
              first: int = CODEC_PATH_LENGTHS[0], rows: int = 1) -> str:
    """The key of a codec kernel's row at chunk length ``n``: the bare name
    at ``first`` (K8 with the residual), ``name:n=N`` at other lengths,
    ``ring_encode_int8:n=N,no_residual`` for K8 without the residual,
    ``ring_decode_int8:rows=W,n=N`` for a K10 launch of W > 1 rows (the
    all-gather's)."""
    if not residual:
        return f"{name}:n={n},no_residual"
    if rows > 1:
        return f"{name}:rows={rows},n={n}"
    return name if n == first else f"{name}:n={n}"


@contextlib.contextmanager
def codec_row_tally(tally: dict):
    """Count the codec's launches by ``codec_row`` key into ``tally``
    (the wrappers count per kernel), passing every call on."""
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    saved = rc._launch_encode, rc._launch_decode_add, rc._launch_decode_rows

    def count(key):
        tally[key] = tally.get(key, 0) + 1

    def encode(v, residual, plan=None):
        count(codec_row("ring_encode_int8", v.numel(), residual))
        return saved[0](v, residual, plan)

    def decode_add(q, scale, acc):
        count(codec_row("ring_decode_add_int8", acc.numel()))
        return saved[1](q, scale, acc)

    def decode_rows(qs, scales, dsts, length):
        count(codec_row("ring_decode_int8", length, rows=len(dsts)))
        return saved[2](qs, scales, dsts, length)

    rc._launch_encode, rc._launch_decode_add, rc._launch_decode_rows = (
        encode, decode_add, decode_rows)
    try:
        yield
    finally:
        rc._launch_encode, rc._launch_decode_add, rc._launch_decode_rows = saved


def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality (NaNs included) of two tensors of one dtype."""
    view = {4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def check_codec(torch, rc, rows: dict, timing: bool) -> None:
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [(f"n={n}", 0.01 * torch.randn(n, device="cuda", generator=gen))
             for n in CODEC_LENGTHS]
    cases.append(("zero n=4097", torch.zeros(4097, device="cuda")))
    nan = torch.randn(4097, device="cuda", generator=gen)
    nan[1234] = float("nan")
    cases.append(("one NaN n=4097", nan))
    for n, what in ((669_379, "max"), (669_379, "NaN"), (CODEC_OVER_CAPACITY, "max")):
        last = 0.01 * torch.randn(n, device="cuda", generator=gen)
        last[-1] = float("nan") if what == "NaN" else 1.0
        cases.append((f"{what} last n={n}", last))
    failed = []
    for n in CODEC_LENGTHS:
        log(f"  ring codec K8 plan n={n}: {rc.device_encode_plan(torch.device('cuda', 0), n)}")
    plan = rc.device_encode_plan(torch.device("cuda", 0), CODEC_OVER_CAPACITY)
    if plan.staged >= plan.slice:
        failed.append(f"n={CODEC_OVER_CAPACITY} is not past the on-chip capacity: {plan}")
    for label, v in cases:
        acc = torch.randn(v.numel(), device="cuda", generator=gen)
        got_r = rc.encode_int8_residual(v)
        got = rc.encode_int8(v)
        got_add = rc.decode_add_int8(got_r[0], got_r[1], acc.clone())
        got_dec = rc.decode_int8(got_r[0], got_r[1], v.numel())
        torch.cuda.synchronize()
        want_r = rc.encode_int8_residual_reference(v)
        want_add = rc.decode_add_int8_reference(want_r[0], want_r[1], acc.clone())
        want_dec = rc.decode_int8_reference(want_r[0], want_r[1], v.numel())
        checks = {"K8 q": (got_r[0], want_r[0]), "K8 scale": (got_r[1], want_r[1]),
                  "K8 residual": (got_r[2], want_r[2]), "K8 q (no residual)": (got[0], want_r[0]),
                  "K8 scale (no residual)": (got[1], want_r[1]), "K9": (got_add, want_add),
                  "K10": (got_dec, want_dec)}
        bad = [name for name, (a, b) in checks.items() if not bits_equal(torch, a, b)]
        log(f"  ring codec {label}: scale {float(want_r[1]):.6g}, bitwise "
            f"{'ok' if not bad else 'BAD: ' + ', '.join(bad)}")
        failed += [f"{name} {label}" for name in bad]
    failed += check_codec_graphs(torch, rc, gen)
    failed += check_decode_rows(torch, rc, gen)
    for name in ("ring_encode_int8", "ring_decode_add_int8", "ring_decode_int8"):
        rows[name] = {"max_abs_err": 0.0 if not failed else float("nan")}
    raise_failed(failed)
    if timing:
        codec_trace(torch, rc)
        ring_call_trace(torch)
        time_codec(torch, rc, rows)


def allgather_case(torch, rc, world: int, n: int, gen):
    """The all-gather's decode at (world, n) as the ring lays it out: W
    payloads, a [W, n rounded up to 16] f32 out, the rows in the ring's
    order on rank 0 (its own, 1, then each arrival's: 0, W-1, ..., 2)."""
    payloads = [rc.encode_int8(0.01 * torch.randn(n, device="cuda", generator=gen))
                for _ in range(world)]
    out = torch.empty(world, -(-n // 16) * 16, device="cuda")
    return payloads, out, [1 % world] + [(-s) % world for s in range(world - 1)]


def check_decode_rows(torch, rc, gen) -> list:
    """The batched K10 bit for bit its plain version at the all-gather's
    (world, n) points: every element of ``out``, pad columns included (both
    start from the same sentinel bits), and one launch a call.  Returns the
    names of the failed checks."""
    from distributed_machine_learning_tpu_torch.ops import build

    failed = []
    for world, n in CODEC_ALLGATHER:
        payloads, out, order = allgather_case(torch, rc, world, n, gen)
        out.view(torch.int32).copy_(torch.arange(out.numel(), device="cuda").view(out.shape))
        want = rc.decode_rows_int8_reference(payloads, out.clone(), order, n)
        before = build.launches[rc.DECODE]
        got = rc.decode_rows_int8(payloads, out, order, n)
        torch.cuda.synchronize()
        launches = build.launches[rc.DECODE] - before
        ok = bits_equal(torch, got, want) and launches == 1
        log(f"  ring codec batched K10 W={world} n={n} rows {order}: {launches} launch(es), "
            f"bitwise {'ok' if ok else 'BAD'}")
        if not ok:
            failed.append(f"batched K10 W={world} n={n}")
    return failed


def check_codec_graphs(torch, rc, gen) -> list:
    """K8 captured in CUDA graphs on a fresh stream, bit for bit its plain
    version: one graph of both modes at the largest path chunk replayed
    twice, then two graphs (the two world-4 chunks) replayed out of order.
    Returns the names of the failed checks."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    failed, graphs = [], []
    for n in (max(CODEC_PATH_LENGTHS), *CODEC_PATH_LENGTHS[:2]):
        v = 0.01 * torch.randn(n, device="cuda", generator=gen)
        v[n // 2] = 3.0
        with torch.cuda.stream(stream):  # warm up where the graph is captured
            rc.encode_int8_residual(v)
            rc.encode_int8(v)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs = (*rc.encode_int8_residual(v), *rc.encode_int8(v))
        # v stays referenced: torch.cuda.graph empties the allocator's cache
        # before each capture, and a freed input would be unmapped under
        # the earlier graphs.
        graphs.append((f"graph n={n}", graph, v, outs, rc.encode_int8_residual_reference(v)))
    order = [0, 0, 2, 1, 2, 1]  # graph 0 twice, then the other two out of order
    for k, i in enumerate(order):
        label, graph, _, outs, (wq, ws, we) = graphs[i]
        for t in outs:
            t.fill_(7)  # stale output bits would pass as a result
        graph.replay()
        torch.cuda.synchronize()
        names = ("q", "scale", "residual", "q (no residual)", "scale (no residual)")
        bad = [name for name, a, b in zip(names, outs, (wq, ws, we, wq, ws))
               if not bits_equal(torch, a, b)]
        log(f"  ring codec K8 {label}, replay {k} (order {order}): bitwise "
            f"{'ok' if not bad else 'BAD: ' + ', '.join(bad)}")
        if bad:
            failed.append(f"K8 {label} replay {k}")
    return failed


def codec_trace(torch, rc) -> None:
    """One K8 call at the largest path chunk is one kernel and no memset:
    the graph it captures into holds one cooperative kernel node and no
    memset node (``rc.graph_census``), and the profiler's device events of
    the call, eager and replayed, show one K8 kernel and no memset."""
    v = 0.01 * torch.randn(max(CODEC_PATH_LENGTHS), device="cuda")
    rc.encode_int8_residual(v)  # the default stream's buffer, made before the trace
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the stream's barrier buffer, made outside the graph
        rc.encode_int8_residual(v)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        rc.encode_int8_residual(v)
    census = rc.graph_census(graph)
    log(f"  ring codec K8 captured call, graph nodes: {census}")
    failed = [] if census == {"kernels": 1, "cooperative": 1, "memsets": 0} else [
        f"K8 captured call: {census}"]
    graph.instantiate()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, fn in (("eager", lambda: rc.encode_int8_residual(v)), ("graph", graph.replay)):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [x for x in names if "encode_kernel" in x]
        memsets = [x for x in names if "memset" in x.lower()]
        log(f"  ring codec K8 trace, {label} call: device events {names}")
        if len(kernels) != 1 or memsets:
            failed.append(f"K8 {label} call: {len(kernels)} encode kernels, memsets {memsets}")
    del graph
    raise_failed(failed)


class MirrorComm:
    """A ring of ``world`` ranks in one process whose every hop hands back
    what was sent: it drives ``ring_all_reduce_flat``'s kernels, in the
    path's order, without a second process (the sums are not a real
    all-reduce's)."""

    def __init__(self, world: int):
        self.world, self.rank = world, 0

    def send_recv(self, payload, dst, src):
        return tuple(payload)


def ring_call_trace(torch) -> None:
    """The profiler's device events of one int8 ring call as the path makes
    it (world 4, the first 25 MiB bucket, mean, the residual): the
    all-gather's W decodes are ONE K10 kernel, and no copy kernel or memcpy
    runs after it (its rows land in the output; chunk 1,638,400 is a
    multiple of 16, so the result is a view)."""
    from distributed_machine_learning_tpu_torch.ops import ring

    world, n = CODEC_ALLGATHER[0]
    x = 0.01 * torch.randn(world * n, device="cuda")
    scheme, comm = ring.Int8Scheme("pallas"), MirrorComm(world)
    ring.ring_all_reduce_flat(x, comm, mean=True, scheme=scheme, return_residual=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ring.ring_all_reduce_flat(x, comm, mean=True, scheme=scheme, return_residual=True)
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    decodes = [start for start, name in events if "decode_rows_kernel" in name]
    after = [name for start, name in events
             if decodes and start > decodes[0] and "copy" in name.lower()]
    counts = {k: sum(k in name for _, name in events)
              for k in ("encode_kernel", "decode_add_kernel", "decode_rows_kernel")}
    log(f"  int8 ring call trace (W {world}, chunk {n}): {len(events)} device events, codec "
        f"kernels {counts}, copies after K10: {after}")
    if len(decodes) != 1 or after:
        raise AssertionError(f"int8 ring call: {len(decodes)} K10 kernels, copies after it "
                             f"{after}")


def time_codec(torch, rc, rows: dict, lengths=CODEC_PATH_LENGTHS) -> None:
    """K8 (with and without the residual), K9 and K10 at each chunk length,
    each call finding its operands out of L2 as a hop does: the captured
    function runs the call over at least CODEC_SETS distinct buffer sets
    spanning CODEC_ROTATE_BYTES, and the time is per call.  Rows: keyed by
    ``codec_row`` (the bare names at the first length)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for n in lengths:
        sets = max(CODEC_SETS, math.ceil(CODEC_ROTATE_BYTES / (9 * n)))
        vs = [0.01 * torch.randn(n, device="cuda", generator=gen) for _ in range(sets)]
        accs = [torch.randn(n, device="cuda", generator=gen) for _ in range(sets)]
        encs = [rc.encode_int8_residual(v)[:2] for v in vs]
        scales = [float(sc) for _, sc in encs]  # host copies for the library calls' alpha

        def per_call(fn, iters: int = 10, sets=sets) -> float:
            return time_ms(lambda: [fn(i) for i in range(sets)], iters=iters) / sets

        try:
            accs[0].add_(encs[0][0], alpha=scales[0])
            add_label = "acc.add_(q, alpha=scale) (int8 q promoted)"

            def library_add(i, accs=accs, encs=encs, scales=scales):
                accs[i].add_(encs[i][0], alpha=scales[i])
        except RuntimeError:
            add_label = "acc.add_(q.float() * scale) (alpha refused for int8 q)"

            def library_add(i, accs=accs, encs=encs):
                accs[i].add_(encs[i][0].float() * encs[i][1])

        def row_key(name, residual=True, n=n):
            return codec_row(name, n, residual, lengths[0])

        shape = f"n={n} f32, operands out of L2 (rotated over {sets} buffer sets)"
        timed = {
            row_key("ring_encode_int8"): dict(
                ms=per_call(lambda i: rc.encode_int8_residual(vs[i])),
                plain_ms=per_call(lambda i: rc.encode_int8_residual_reference(vs[i]), iters=3),
                library_ms=None, **bound(3.0 * n, F32_FLOPS, 9 * n + 4),
                shape=shape + ", with the residual; library: none (no one call: "
                      "quantize_per_tensor takes the scale given and clips at -128)"),
            row_key("ring_encode_int8", False): dict(
                ms=per_call(lambda i: rc.encode_int8(vs[i])),
                plain_ms=per_call(lambda i: rc.encode_int8_reference(vs[i]), iters=3),
                library_ms=None, **bound(2.0 * n, F32_FLOPS, 5 * n + 4),
                shape=shape + ", without the residual; library: none"),
            row_key("ring_decode_add_int8"): dict(
                ms=per_call(lambda i: rc.decode_add_int8(*encs[i], accs[i])),
                plain_ms=per_call(lambda i: rc.decode_add_int8_reference(*encs[i], accs[i]),
                                  iters=3),
                library_ms=per_call(library_add), **bound(2.0 * n, F32_FLOPS, 9 * n + 4),
                shape=shape + f", in place; library: {add_label}"),
            row_key("ring_decode_int8"): dict(
                ms=per_call(lambda i: rc.decode_int8(*encs[i], n)),
                plain_ms=per_call(lambda i: rc.decode_int8_reference(*encs[i], n), iters=3),
                library_ms=per_call(lambda i: encs[i][0].float().mul_(encs[i][1])),
                **bound(1.0 * n, F32_FLOPS, 5 * n + 4),
                shape=shape + "; one row; library: q.float().mul_(scale)")}
        for key, row in timed.items():
            log_codec_row(rows, key, row)
        del vs, accs, encs
    time_allgather(torch, rc, rows)


def log_codec_row(rows: dict, key: str, row: dict) -> None:
    base = rows.get(key.split(":")[0], {})
    rows.setdefault(key, {"max_abs_err": base.get("max_abs_err", 0.0)}).update(row)
    library = row["library_ms"]
    log(f"  {key}: {row['ms']:.5f} ms ({row['bound_ms'] / row['ms']:.1%} of the "
        f"{row['bound_ms']:.5f} ms bound), plain {row['plain_ms']:.4f}, library "
        + ("none" if library is None else f"{library:.5f}"))


def time_allgather(torch, rc, rows: dict) -> None:
    """The all-gather's decode work per ring call at each CODEC_ALLGATHER
    point: ``out`` allocated as the ring does (``torch.empty``) and the W
    payloads decoded into it by one batched K10 call, operands rotated out
    of L2 as ``time_codec`` does.  Bound: 5·W·n + 4·W bytes; library:
    ``torch.mul`` of the W codes stacked into one [W, n] int8 tensor (outside
    the timed region) by the W scales, into ``out[:, :n]``."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    for world, n in CODEC_ALLGATHER:
        sets = max(CODEC_SETS, math.ceil(CODEC_ROTATE_BYTES / (5 * world * n)))
        cases = [allgather_case(torch, rc, world, n, gen) for _ in range(sets)]
        stacked = [(torch.stack([q for q, _ in p]), torch.cat([s for _, s in p]))
                   for p, _, _ in cases]
        stride = cases[0][1].shape[1]

        def per_call(fn, iters: int = 10) -> float:
            return time_ms(lambda: [fn(*c) for c in cases], iters=iters) / sets

        def library(i):
            q2d, scales = stacked[i]
            torch.mul(q2d, scales.view(-1, 1), out=cases[i][1][:, :n])

        row = dict(
            ms=per_call(lambda p, _, order: rc.decode_rows_int8(
                p, torch.empty(world, stride, device="cuda"), order, n)),
            plain_ms=per_call(lambda p, _, order: rc.decode_rows_int8_reference(
                p, torch.empty(world, stride, device="cuda"), order, n), iters=3),
            library_ms=time_ms(lambda: [library(i) for i in range(sets)]) / sets,
            **bound(1.0 * world * n, F32_FLOPS, 5 * world * n + 4 * world),
            shape=f"the all-gather's decode per ring call: W={world} payloads of n={n} into a "
                  f"[{world}, {stride}] f32 out, operands out of L2 (rotated over {sets} sets); "
                  "library: torch.mul(q2d, scales.view(-1, 1), out=out[:, :n])")
        log_codec_row(rows, codec_row("ring_decode_int8", n, rows=world), row)
        del cases, stacked


# K4's check positions at S 4608 (both modes, B 8 and B 1): the first
# slot, 512-slot block edges, the frontier of the main path's middle decode
# step (4111), the last slot, and the edges of K4's split chunks there
# (decode_split: B 8 cuts pos 4095 into 8 chunks of 512; B 1 cuts pos 4111
# into 32 chunks of 129, pos 255 into 2 of 128).
DECODE_POSITIONS = {8: (0, 511, 512, 2047, 2048, 4095, 4111, 4607), 1: (0, 255, 256, 4111)}


def decode_split_line(da, B: int, Hkv: int, pos: int) -> str:
    from distributed_machine_learning_tpu_torch.ops import build

    splits, chunk = da.decode_split(B, Hkv, pos, build.sm_count(0))
    return f"{splits} split(s) of {chunk} slots, {splits * Hkv * B} blocks"


def time_decode(da, label: str, run, plain, library, B, H, Hkv, D, pos, nbytes: float,
                flops: float) -> dict:
    """K4 (either mode) at one shape: kernel, plain version and library
    call timed, the bound, one log line."""
    row = dict(ms=time_ms(run, iters=50), plain_ms=time_ms(plain),
               library_ms=time_ms(library, iters=50) if library else None,
               **bound(flops, F32_FLOPS, nbytes))
    log(f"  {label} B={B} pos={pos} ({decode_split_line(da, B, Hkv, pos)}): "
        f"{row['ms']:.4f} ms, {nbytes / row['ms'] / 1e6:.1f} GB/s, "
        f"{row['bound_ms'] / row['ms']:.1%} of its {row['bound_ms']:.4f} ms bound"
        + (f", {row['ms'] / row['library_ms']:.2f}x SDPA ({row['library_ms']:.4f} ms)"
           if library else "")
        + f"; plain {row['plain_ms']:.4f} ms")
    return row


def check_decode(torch, da, rows: dict, timing: bool) -> None:
    """K4 (bf16 caches) at the serving shape (B 8, S 4608, H 16/4, D 128)
    and at B 1, at DECODE_POSITIONS, with the row gates.  Timed at the main
    path's middle decode position beside its bytes bound, its plain version
    and SDPA on the frontier's K/V repeated to every query head; B 8 is the
    row of the kernels line, B 1 is logged."""
    S, H, Hkv, D = 4608, 16, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs, failed, cases = [], [], {}
    for B, positions in DECODE_POSITIONS.items():
        q = torch.randn(B, 1, H, D, device="cuda", generator=gen).bfloat16()
        kc = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).bfloat16()
        vc = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).bfloat16()
        cases[B] = q, kc, vc
        for pos in positions:
            got = da.cached_flash_attention(q, kc, vc, pos)
            torch.cuda.synchronize()
            errs.append(compare(f"decode_attention B={B} S={S} pos={pos} "
                                f"({decode_split_line(da, B, Hkv, pos)})", got,
                                da.cached_attention_reference(q, kc, vc, pos), failed))
    rows["decode_attention"] = {"max_abs_err": max(errs)}
    raise_failed(failed)
    if not timing:
        return
    pos = PROMPT + NEW_TOKENS // 2 - 1  # the middle decode step of the main path
    n = pos + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B in (8, 1):
        q, kc, vc = cases[B]
        kr = kc[:, :, :n].repeat_interleave(H // Hkv, 1).contiguous()
        vr = vc[:, :, :n].repeat_interleave(H // Hkv, 1).contiguous()
        qt = q.transpose(1, 2).contiguous()
        row = time_decode(
            da, "decode_attention", lambda: da.cached_flash_attention(q, kc, vc, pos),
            lambda: da.cached_attention_reference(q, kc, vc, pos),
            lambda: sdpa(qt, kr, vr), B, H, Hkv, D, pos,
            nbytes=2 * B * Hkv * n * D * 2 + 2 * B * H * D * 2,
            flops=4.0 * B * H * n * D)  # f32 FMAs on the CUDA cores
        if B == 8:
            rows["decode_attention"].update(
                **row, shape=f"B={B} S_alloc={S} H={H} Hkv={Hkv} D={D} bf16 pos={pos}, "
                             "one call per layer per decode step")


# K4's int8 mode in f32 (q f32, a small shape), kernel vs plain: both
# dequantize each value in f32 the same way and keep P in f32, so only the
# order of the f32 sums differs; per row (worst element / max|row|, rms).
INT8_F32_TOL = (1e-4, 1e-5)
# K6 with f32 x, kernel vs plain: the same bf16-exact products summed in f32
# in another order (per row: worst element / max|row|, rms).
GEMM_F32_TOL = (1e-4, 1e-4)


def int8_cache(torch, B, Hkv, S, D, gen):
    """An int8 cache and its f32 scales, from random bf16 K/V through the
    model's quantized write."""
    from distributed_machine_learning_tpu_torch.models.transformer import quantize_kv

    k = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).bfloat16()
    return (*quantize_kv(k), *quantize_kv(v))


def check_decode_int8(torch, da, rows: dict, timing: bool) -> None:
    """K4's int8 mode at the serving shape (B 8, S 4608, H 16/4, D 128, q
    bf16) and at B 1, at DECODE_POSITIONS, with the row gates; q f32 at a
    small shape with INT8_F32_TOL.  Timed at the main path's middle decode
    position beside its bytes bound, its plain version and the
    scale-folding einsum on the same cache (no one PyTorch call computes
    it)."""
    from distributed_machine_learning_tpu_torch.models.transformer import (
        _cached_attention_quant,
    )

    S, H, Hkv, D = 4608, 16, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs, failed, cases = [], [], {}
    for B, positions in DECODE_POSITIONS.items():
        q = torch.randn(B, 1, H, D, device="cuda", generator=gen).bfloat16()
        kq, ks, vq, vs = int8_cache(torch, B, Hkv, S, D, gen)
        cases[B] = q, kq, ks, vq, vs
        for pos in positions:
            got = da.cached_flash_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            errs.append(compare(f"decode_attention_int8 B={B} S={S} pos={pos} "
                                f"({decode_split_line(da, B, Hkv, pos)})", got,
                                da.cached_attention_reference(q, kq, vq, pos, ks, vs), failed))
    small = int8_cache(torch, 2, 2, 1024, 64, gen)
    qf = torch.randn(2, 1, 8, 64, device="cuda", generator=gen)
    for pos in (0, 700, 1023):
        got = da.cached_flash_attention(qf, small[0], small[2], pos, k_scale=small[1],
                                        v_scale=small[3])
        torch.cuda.synchronize()
        compare(f"decode_attention_int8 f32 q B=2 S=1024 H=8 Hkv=2 D=64 pos={pos}", got,
                da.cached_attention_reference(qf, small[0], small[2], pos, *small[1::2]),
                failed, tol=INT8_F32_TOL)
    rows["decode_attention_int8"] = {"max_abs_err": max(errs)}
    raise_failed(failed)
    if not timing:
        return
    pos = PROMPT + NEW_TOKENS // 2 - 1  # the middle decode step of the main path
    n = pos + 1
    positions = torch.tensor([pos], device="cuda")
    for B in (8, 1):
        q, kq, ks, vq, vs = cases[B]
        row = time_decode(
            da, "decode_attention_int8",
            lambda: da.cached_flash_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs),
            lambda: da.cached_attention_reference(q, kq, vq, pos, ks, vs), None,
            B, H, Hkv, D, pos, nbytes=2 * B * Hkv * n * (D + 4) + 2 * B * H * D * 2,
            flops=4.0 * B * H * n * D + 2.0 * B * Hkv * n * D)  # dots + dequantization
        row["context_ms"] = time_ms(lambda: _cached_attention_quant(q, kq, ks, vq, vs,
                                                                    positions))
        log(f"  decode_attention_int8 B={B}: no one PyTorch call computes it; the "
            f"scale-folding einsum on the same cache (reads all {S} slots): "
            f"{row['context_ms']:.4f} ms")
        if B == 8:
            rows["decode_attention_int8"].update(
                **row, shape=f"B={B} S_alloc={S} H={H} Hkv={Hkv} D={D} int8 + f32 scales, "
                             f"q bf16 pos={pos}, one call per layer per decode step below "
                             "the break-even")


# The card's crossover of the tiered int8 switch: K4's int8 mode (reads
# O(pos)) vs the scale-folding einsum (reads the whole allocation) at the
# reference's measurement allocation, per batch, across fills pos/S.
CROSSOVER_S = 32768
CROSSOVER_FILLS = (0.05, 0.1, 0.19, 0.3, 0.5, 0.95)


def crossover(torch, da) -> None:
    """Log both ladders and the fill where the kernel stops winning
    (linear between the ladder's points); records, decides nothing."""
    from distributed_machine_learning_tpu_torch.models.transformer import (
        INT8_TIER_BREAK_EVEN_PCT,
        _cached_attention_quant,
    )

    H, Hkv, D = MODEL["n_heads"], MODEL["n_kv_heads"], MODEL["d_model"] // MODEL["n_heads"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    for B in (1, 8):
        shape = (B, Hkv, CROSSOVER_S, D)
        kq = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        vq = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        ks = torch.rand(shape[:3], device="cuda", generator=gen) / 127
        vs = torch.rand(shape[:3], device="cuda", generator=gen) / 127
        q = torch.randn(B, 1, H, D, device="cuda", generator=gen).bfloat16()
        kernel, einsum = [], []
        for f in CROSSOVER_FILLS:
            pos = int(f * CROSSOVER_S)
            positions = torch.tensor([pos], device="cuda")
            kernel.append(time_ms(lambda: da.cached_flash_attention(
                q, kq, vq, pos, k_scale=ks, v_scale=vs), iters=50))
            einsum.append(time_ms(lambda: _cached_attention_quant(
                q, kq, ks, vq, vs, positions), iters=10))
        cross = None
        for i, f in enumerate(CROSSOVER_FILLS):
            if kernel[i] >= einsum[i]:
                if i == 0:
                    cross = f
                else:
                    d0, d1 = einsum[i - 1] - kernel[i - 1], einsum[i] - kernel[i]
                    f0 = CROSSOVER_FILLS[i - 1]
                    cross = f0 + (f - f0) * d0 / (d0 - d1)
                break
        log(f"int8 tier crossover B={B} S_alloc={CROSSOVER_S} H={H} Hkv={Hkv} D={D} q bf16 "
            f"(ms per call, fills {list(CROSSOVER_FILLS)}): kernel "
            f"{[round(x, 4) for x in kernel]}; einsum {[round(x, 4) for x in einsum]}; "
            + (f"crossover pos/S = {cross:.3f}" if cross is not None else
               "the kernel wins at every fill")
            + f" (the reference's break-even: {INT8_TIER_BREAK_EVEN_PCT} %)")
        del kq, vq, ks, vs
        torch.cuda.empty_cache()


def gemm_shapes():
    """(D, K) of every int8 projection of one forward: per layer q, kv,
    out, fc_in, fc_out, then the LM head."""
    E, F, V = MODEL["d_model"], 4 * MODEL["d_model"], MODEL["vocab_size"]
    kv = 2 * MODEL["n_kv_heads"] * (E // MODEL["n_heads"])
    return [(E, E), (E, kv), (E, E), (E, F), (F, E)] * MODEL["n_layers"] + [(E, V)]


def check_int8(torch, qm, rows: dict, timing: bool) -> None:
    """K6 against its plain version at every projection shape of the LM (and
    its head) at decode R (8, the skinny route), prefill R (8 x 4096, the
    wgmma route) and a ragged prefill R (8 x 4095: rows past R inside the
    last 128-row tile), with the row gates; then timed over one forward's
    GEMMs at both R."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs, failed = [], []
    for R in (BATCH, BATCH * PROMPT, BATCH * (PROMPT - 1)):
        for D, K in ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
                     (2048, 32000)):
            x = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
            w = torch.randn(D, K, device="cuda", generator=gen) / math.sqrt(D)
            q, s = qm.quantize_int8(w)
            got = qm.int8_matmul(x, q, s)
            torch.cuda.synchronize()
            errs.append(compare(f"quant_matmul R={R} D={D} K={K} "
                                f"({qm.int8_route(R, D, K)} route)", got,
                                qm.int8_matmul_reference(x, q, s), failed))
            del x, got
    # f32 x (an f32 output, staged as f32 boxes) on the wgmma route, ragged
    # in R and in K's last 256-column tile, and on the byte-staged tile.
    for R, D, K in ((300, 512, 2064), (300, 512, 257)):
        x = torch.randn(R, D, device="cuda", generator=gen)
        q, s = qm.quantize_int8(torch.randn(D, K, device="cuda", generator=gen) / math.sqrt(D))
        got = qm.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        compare(f"quant_matmul f32 x R={R} D={D} K={K} ({qm.int8_route(R, D, K)} route)", got,
                qm.int8_matmul_reference(x, q, s), failed, tol=GEMM_F32_TOL)
    raise_failed(failed)
    if not timing:
        rows["quant_matmul:decode_step"] = {"max_abs_err": max(errs)}
        return
    # Every int8 GEMM of one forward, in order, on distinct weights (the
    # 0.47 GB of weights do not fit the 50 MB L2: each call reads its
    # weights from memory, as in serving).
    weights = []
    for D, K in gemm_shapes():
        w = torch.randn(D, K, device="cuda", generator=gen) / math.sqrt(D)
        q, s = qm.quantize_int8(w)
        weights.append((q, s, (q.float() * s).bfloat16()))
    E = MODEL["d_model"]
    for label, R in (("decode_step", BATCH), ("prefill", BATCH * PROMPT)):
        xs = {D: torch.randn(R, D, device="cuda", generator=gen).bfloat16()
              for D in (E, 4 * E)}
        head_x = xs[E][:BATCH]  # the head runs on the last position only
        calls = [(xs[q.shape[0]] if i < len(weights) - 1 else head_x, q, s, wd)
                 for i, (q, s, wd) in enumerate(weights)]

        def run(fn, calls=calls):
            for x, q, s, wd in calls:
                fn(x, q, s, wd)

        ops = sum(2.0 * x.shape[0] * q.shape[0] * q.shape[1] for x, q, _, _ in calls)
        nbytes = sum(x.numel() * 2 + q.numel() + 4 * q.shape[1]
                     + 2 * x.shape[0] * q.shape[1] for x, q, _, _ in calls)
        iters = 10 if label == "decode_step" else 2
        rows[f"quant_matmul:{label}"] = dict(
            max_abs_err=max(errs),
            ms=time_ms(lambda: run(lambda x, q, s, wd: qm.int8_matmul(x, q, s)),
                       iters=iters, warmup=1),
            plain_ms=time_ms(lambda: run(
                lambda x, q, s, wd: qm.int8_matmul_reference(x, q, s)),
                iters=iters, warmup=1),
            library_ms=time_ms(lambda: run(lambda x, q, s, wd: torch.matmul(x, wd)),
                               iters=iters, warmup=1),
            **bound(ops, BF16_FLOPS, nbytes),
            shape=f"{len(calls)} calls: 40 projections at R={R} + LM head at "
                  f"R={BATCH}" if label == "prefill" else
                  f"{len(calls)} calls at R={R} (one decode step)")
        r = rows[f"quant_matmul:{label}"]
        log(f"  quant_matmul {label}: {r['ms']:.3f} ms, {nbytes / r['ms'] / 1e6:.1f} GB/s, "
            f"{ops / r['ms'] / 1e9:.1f} TFLOP/s")


def paged_case(torch, bs: int, gen):
    """K5's check inputs: 9 lanes (8 at ragged positions, the last idle on
    the scratch block at position 0), H 16 / Hkv 4, D 128, bf16; tables as
    wide as the engine's (max_len slots), each lane's row a slice of one
    seeded permutation of the pool's blocks."""
    H, Hkv, D = MODEL["n_heads"], MODEL["n_kv_heads"], MODEL["d_model"] // MODEL["n_heads"]
    positions = [0, bs - 1, bs, 511, 1000, 2047, 4095, 4159]
    mb = -(-ENGINE["max_len"] // bs)
    n = len(positions) * mb
    tables = torch.full((len(positions) + 1, mb), n, dtype=torch.int32, device="cuda")
    tables[:-1] = torch.randperm(n, generator=gen, device="cuda").int().reshape(-1, mb)
    q = torch.randn(len(positions) + 1, 1, H, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=gen).bfloat16()
    pos = torch.tensor(positions + [0], dtype=torch.int32, device="cuda")
    return q, k, v, tables, pos


def check_paged(torch, da, rows: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4)
    errs, failed = [], []
    for bs in (16, 128):
        q, k, v, tables, pos = paged_case(torch, bs, gen)
        got = da.paged_flash_attention(q, k, v, tables, pos)
        torch.cuda.synchronize()
        errs.append(compare(f"paged_attention bs={bs} W={len(pos)} positions="
                            f"{pos.tolist()}", got,
                            da.paged_attention_reference(q, k, v, tables, pos), failed))
    rows["paged_attention"] = {"max_abs_err": max(errs)}
    raise_failed(failed)


def check_fleet_shapes(torch, da, qm) -> None:
    """K5 and K6 at the serve CLI's --engine shapes on the card: K5 over
    4-slot pages (a 16-slot tile spans four of them), f32 and bf16 pools,
    H 4 / Hkv 2, D 32, 4 lanes at ragged positions plus an idle one; K6 on
    f32 x at every projection of that model and its 32-column head, at
    decode R 4 and prefill R 1-3.  Row gates as elsewhere."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg, E = CLI_ENGINE, CLI_ENGINE_LM["d_model"]
    H, Hkv = CLI_ENGINE_LM["n_heads"], CLI_ENGINE_LM["n_kv_heads"]
    bs, mb = cfg["block_size"], cfg["max_len"] // cfg["block_size"]
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        positions = [0, 3, 4, 15]
        n = len(positions) * mb
        tables = torch.full((len(positions) + 1, mb), n, dtype=torch.int32, device="cuda")
        tables[:-1] = torch.randperm(n, generator=gen, device="cuda").int().reshape(-1, mb)
        q = torch.randn(len(positions) + 1, 1, H, E // H, device="cuda", generator=gen).to(dtype)
        k = torch.randn(n + 1, Hkv, bs, E // H, device="cuda", generator=gen).to(dtype)
        v = torch.randn(n + 1, Hkv, bs, E // H, device="cuda", generator=gen).to(dtype)
        pos = torch.tensor(positions + [0], dtype=torch.int32, device="cuda")
        got = da.paged_flash_attention(q, k, v, tables, pos)
        torch.cuda.synchronize()
        compare(f"paged_attention cli engine bs={bs} {dtype} positions={pos.tolist()}", got,
                da.paged_attention_reference(q, k, v, tables, pos), failed)
    kv = 2 * Hkv * (E // H)
    for R in (cfg["max_lanes"], 1, 3):
        for D, K in ((E, E), (E, kv), (E, 4 * E), (4 * E, E), (E, CLI_ENGINE_LM["vocab_size"])):
            x = torch.randn(R, D, device="cuda", generator=gen)
            qw, sc = qm.quantize_int8(torch.randn(D, K, device="cuda", generator=gen) / math.sqrt(D))
            got = qm.int8_matmul(x, qw, sc)
            torch.cuda.synchronize()
            compare(f"quant_matmul cli engine f32 x R={R} D={D} K={K} "
                    f"({qm.int8_route(R, D, K)} route)", got,
                    qm.int8_matmul_reference(x, qw, sc), failed, tol=GEMM_F32_TOL)
    raise_failed(failed)


def eager_ms(torch, fn, iters: int = 3) -> float:
    """Device-timeline ms of one ``fn()`` run eagerly (for functions that
    sync with the host and cannot be captured in a CUDA graph)."""
    fn()
    return event_ms(torch, lambda: [fn() for _ in range(iters)]) / iters


# SDPA's fused backends, each pinned in turn for the backward yardsticks.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_backward_ms(torch, q, k, v, do, causal: bool, label: str, iters: int = 20,
                     warmup: int = 3):
    """The yardstick of an attention backward: one SDPA backward (dq, dk
    and dv in one call) on q, dO [B, L, H, D] and k, v [B, L, Hkv, D] (K/V
    repeated to H heads), under each fused backend pinned with
    ``sdpa_kernel`` in turn, eager between CUDA events over ``iters`` calls
    after ``warmup``; a backend that refuses the shape is logged and
    skipped.  The unpinned default is timed and logged beside them.
    Returns (fastest ms, its backend's name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in
                  (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    dot = do.transpose(1, 2).contiguous()

    def timed(ctx):
        with ctx:
            out = sdpa(qt, kt, vt, is_causal=causal)
            run = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                              retain_graph=True)
            for _ in range(warmup):
                run()
            return event_ms(torch, lambda: [run() for _ in range(iters)]) / iters

    times = {}
    for name in SDPA_BACKENDS:
        try:
            times[name] = timed(sdpa_kernel(getattr(SDPBackend, name)))
        except RuntimeError as exc:  # the backend does not take this shape
            log(f"  SDPA backward ({label}) {name}: refused ({str(exc).splitlines()[0][:120]})")
            continue
        log(f"  SDPA backward ({label}) {name}: {times[name]:.4f} ms")
    log(f"  SDPA backward ({label}) unpinned default: "
        f"{timed(contextlib.nullcontext()):.4f} ms")
    if not times:
        raise RuntimeError(f"SDPA backward ({label}): no fused backend takes the shape")
    best = min(times, key=times.get)
    return times[best], best


def time_paged(torch, da, rows: dict, step) -> None:
    """K5 at the engine's step shape: one layer's pools, tables and
    positions of a real decode step (8 lanes at ragged positions), with a
    random bf16 query."""
    kp, vp, tables, positions = step.keys[0], step.values[0], step.tables, step.positions
    W, (Hkv, bs, D), H = tables.shape[0], kp.shape[1:], MODEL["n_heads"]
    gen = torch.Generator(device=kp.device).manual_seed(5)
    q = torch.randn(W, 1, H, D, device=kp.device, generator=gen).to(kp.dtype)
    pos = positions.tolist()
    n = sum(p + 1 for p in pos)
    # K and V rows up to each frontier, the table entries that reach them,
    # the positions, q and the output.
    nbytes = (2 * n * Hkv * D * 2 + 4 * sum(p // bs + 1 for p in pos) + 4 * W
              + 2 * W * H * D * 2)
    flops = 4.0 * H * D * n  # f32 FMAs on the CUDA cores (q·k and p·v)
    rows["paged_attention"].update(
        ms=time_ms(lambda: da.paged_flash_attention(q, kp, vp, tables, positions), iters=50),
        plain_ms=eager_ms(torch, lambda: da.paged_attention_reference(
            q, kp, vp, tables, positions)),
        library_ms=None, **bound(flops, F32_FLOPS, nbytes),
        shape=f"W={W} H={H} Hkv={Hkv} D={D} {str(kp.dtype)[6:]} block_size={bs} "
              f"table={tables.shape[1]} blocks, positions={pos}, one call per "
              "layer per engine step")
    r = rows["paged_attention"]
    log(f"  paged_attention at an engine step (positions {pos}): {r['ms']:.4f} ms, "
        f"{nbytes / r['ms'] / 1e6:.1f} GB/s, bound {r['bound_ms']:.4f} ms")
    # Context only: no one PyTorch call computes paged attention; a gather
    # of every lane's pages into a dense cache, then SDPA (two calls).
    S = tables.shape[1] * bs
    rep = H // Hkv
    mask = torch.arange(S, device=kp.device)[None, :] <= positions[:, None].long()

    def gather_sdpa():
        kd = kp[tables.long()].transpose(1, 2).reshape(W, Hkv, S, D)
        vd = vp[tables.long()].transpose(1, 2).reshape(W, Hkv, S, D)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kd.repeat_interleave(rep, 1), vd.repeat_interleave(rep, 1),
            attn_mask=mask[:, None, None, :])

    r["context_ms"] = time_ms(gather_sdpa, iters=20)
    log(f"  context, two PyTorch calls (gather of the pages + SDPA): {r['context_ms']:.4f} ms")


def make_models(torch, pkg):
    """The served model in both modes (random weights from SEED) and the
    batch of prompts."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

    device = pkg.resolve_device()
    master = TransformerLM(**MODEL, compute_dtype=torch.bfloat16, device=device)
    init_params(master, seed=SEED)
    models = {"int8": quantize_lm(master).eval()}
    models["bf16"] = master.to(torch.bfloat16).eval()
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompt = torch.randint(0, MODEL["vocab_size"], (BATCH, PROMPT),
                           generator=gen, device=device)
    return models, prompt


def generate_fns(models, new_tokens: int | None = None) -> dict:
    from distributed_machine_learning_tpu_torch.inference.generate import (
        make_generate_fn,
    )

    n = new_tokens or NEW_TOKENS
    return {mode: make_generate_fn(m, n, quantize=None if mode == "bf16" else "int8")
            for mode, m in models.items()}


def run_main_path(torch, build, fns: dict, prompt, rows: dict) -> dict:
    """One generate per mode with the launch counts zeroed just before and
    read just after; every kernel of the path must have run, and K6 on the
    routes the int8 generate's shapes call for."""
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm

    build.reset_launch_counts()
    qm.reset_route_calls()
    outs = {mode: fns[mode](prompt) for mode in ("bf16", "int8")}
    torch.cuda.synchronize()
    launches = dict(build.launches)
    log(f"main path launches (bf16 + int8 generate): {launches}")
    want = {"flash_fwd": 2 * MODEL["n_layers"],
            "decode_attention": 2 * MODEL["n_layers"] * (NEW_TOKENS - 1)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches, want {n}")
    if launches["quant_matmul"] == 0:
        raise AssertionError("quant_matmul never launched on the int8 path")
    # K6's routes on the int8 generate: the prefill's 5 projections a layer
    # at R = B x prompt on the wgmma mainloop; the head (last position only)
    # and every decode step's 41 GEMMs at R = B on the skinny tile.
    routes = dict(qm.route_calls)
    want_routes = {"wgmma": 5 * MODEL["n_layers"], "tile": 0,
                   "skinny": 1 + (5 * MODEL["n_layers"] + 1) * (NEW_TOKENS - 1)}
    log(f"main path int8 GEMM calls by route: {routes} (want {want_routes})")
    if routes != want_routes or sum(routes.values()) != launches["quant_matmul"]:
        raise AssertionError(f"quant_matmul routes {routes}, want {want_routes}")
    for name, n in launches.items():
        for key, row in rows.items():
            if key.split(":")[0] == name:
                row["launches"] = n
    for mode, out in outs.items():
        if out.shape != (BATCH, PROMPT + NEW_TOKENS):
            raise AssertionError(f"{mode}: output shape {tuple(out.shape)}")
        if not torch.equal(out[:, :PROMPT], prompt):
            raise AssertionError(f"{mode}: prompt prefix not preserved")
        if int(out.min()) < 0 or int(out.max()) >= MODEL["vocab_size"]:
            raise AssertionError(f"{mode}: token ids out of range")
    return outs


def cache_slots() -> int:
    """The cache allocation generate makes: prompt + new tokens, rounded
    up to 512 slots (4608 here, on the decode kernel)."""
    return -(-(PROMPT + NEW_TOKENS) // 512) * 512


def check_logits(torch, mode: str, model, prompt, out) -> None:
    """Logits of the first step (prefill) and of the second (one decode
    step on generate's first token), kernel path vs plain path of the same
    model, within LOGIT_TOL; generate's first two tokens must be the kernel
    path's argmaxes.  Logs every reading before it raises."""
    def two_steps():
        cache = model.init_cache(BATCH, cache_slots())
        first = model(prompt, cache=cache, start=0, last_only=True)[:, -1]
        second = model(out[:, PROMPT, None], cache=cache, start=PROMPT)[:, -1]
        return first, second

    with torch.inference_mode():
        got = two_steps()
        with plain_kernels():
            want = two_steps()
    failed = []
    for i, (g, w) in enumerate(zip(got, want)):
        step = ("first (prefill)", "second (decode)")[i]
        diff = float((g - w).abs().max())
        agree = int((g.argmax(-1) == w.argmax(-1)).sum())
        same = torch.equal(out[:, PROMPT + i], g.argmax(-1))
        log(f"{mode}: {step} logits kernel vs plain path: max_abs_diff={diff:.4f} "
            f"(tol {LOGIT_TOL}), logit std {float(w.std()):.3f}, argmax agree "
            f"{agree}/{BATCH}, generate's token = kernel-path argmax: {same}")
        if not torch.isfinite(g).all() or diff > LOGIT_TOL or not same:
            failed.append(step)
    if failed:
        raise AssertionError(f"{mode}: {', '.join(failed)} logits disagree")


def event_ms(torch, fn) -> float:
    """Device-timeline ms of one ``fn()`` between CUDA events (host launch
    gaps included: the stream waits on them)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def spread(xs: list) -> str:
    xs = sorted(xs)
    return f"median {xs[len(xs) // 2]:.3f} (range {xs[0]:.3f}-{xs[-1]:.3f}, n={len(xs)})"


def time_serving(torch, mode: str, model, fn, prompt, reps: int = 10) -> None:
    """Per mode, between CUDA events: the whole request (generate), prefill
    + first token, and the decode loop (model step + greedy sample, as
    generate runs it) over NEW_TOKENS - 1 steps, each repeated."""
    total = [event_ms(torch, lambda: fn(prompt)) for _ in range(3)]
    steps = NEW_TOKENS - 1
    with torch.inference_mode():
        cache = model.init_cache(BATCH, cache_slots())

        def prefill():
            return model(prompt, cache=cache, start=0, last_only=True)[:, -1].argmax(-1)

        first = prefill()
        ttft = [event_ms(torch, prefill) for _ in range(5)]

        def decode_loop():
            tok = first
            for i in range(steps):
                tok = model(tok[:, None], cache=cache, start=PROMPT + i)[:, -1].argmax(-1)

        decode_loop()  # warm
        decode = [event_ms(torch, decode_loop) / steps for _ in range(reps)]
    med = sorted(decode)[len(decode) // 2]
    log(f"{mode}: generate B={BATCH} prompt={PROMPT} new={NEW_TOKENS} (CUDA events, ms): "
        f"request {spread(total)}; prefill+first token {spread(ttft)}; decode "
        f"ms/step {spread(decode)} -> {BATCH / med * 1e3:.0f} tok/s at the median")


def serve(torch, build, models, prompt, rows: dict):
    fns = generate_fns(models)
    for warm in generate_fns(models, 2).values():  # first launches, cuBLAS handles
        warm(prompt[:, :512])
    torch.cuda.synchronize()
    outs = run_main_path(torch, build, fns, prompt, rows)
    for mode, out in outs.items():
        check_logits(torch, mode, models[mode], prompt, out)
    for mode, out in outs.items():
        time_serving(torch, mode, models[mode], fns[mode], prompt)
    profile_decode(torch, models["bf16"], prompt)
    return outs["bf16"]


# The int8-KV serving path: (a) the default dispatch at the main path's
# traffic; (b) the tiered switch on, B 8 × prompt 128 × 1024 new tokens: the
# cache rounds to 1536 slots and decode positions run 128-1150, of which
# those with 100·p < 19·1536 (128-291) take K4's int8 mode.
KV_TIERED = dict(prompt=128, new_tokens=1024)
KV_TIERED_STEPS = 16  # steps held against the default dispatch


def kv_int8_model(torch, model, tiered: bool):
    """``model``'s weights (bf16) in a model with an int8 KV cache."""
    m = model.clone(kv_cache_dtype=torch.int8, int8_tiered_dispatch=tiered)
    m.load_state_dict(model.state_dict())
    return m.to(torch.bfloat16).eval()


def peak_gb(torch, fn) -> float:
    """Peak device memory (GB) allocated while ``fn()`` runs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def kv_expected_kernel_launches(prompt: int, new_tokens: int) -> int:
    """K4-int8 launches of one tiered generate: one per layer for each decode
    position p (prompt .. prompt + new_tokens - 2) with 100·p < S·19, S the
    cache allocation (prompt + new_tokens rounded up to 512)."""
    from distributed_machine_learning_tpu_torch.models.transformer import (
        INT8_TIER_BREAK_EVEN_PCT,
    )

    S = -(-(prompt + new_tokens) // 512) * 512
    steps = [p for p in range(prompt, prompt + new_tokens - 1)
             if p * 100 < S * INT8_TIER_BREAK_EVEN_PCT]
    return MODEL["n_layers"] * len(steps)


def teacher_forced_logits(torch, model, prompt, tokens, slots: int, steps: int) -> list:
    """Logits of prefill and ``steps`` decode steps fed ``tokens`` (so two
    models are compared along one token stream)."""
    Lp = prompt.shape[1]
    with torch.inference_mode():
        cache = model.init_cache(prompt.shape[0], slots)
        out = [model(prompt, cache=cache, start=0, last_only=True)[:, -1]]
        for i in range(steps):
            out.append(model(tokens[:, Lp + i, None], cache=cache, start=Lp + i)[:, -1])
    return out


def serve_kv_int8(torch, build, models, prompt, rows: dict, bf16_out) -> None:
    """The int8 KV cache through ``make_generate_fn`` at full width: (a) the
    default dispatch (every decode step on the scale-folding einsum, K4's
    int8 mode never), (b) the tiered switch on (K4's int8 mode exactly
    where the rule says), launch counts zeroed just before and read just
    after each; then (c) the real command."""
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn

    kv = kv_int8_model(torch, models["bf16"], tiered=False)
    fn = make_generate_fn(kv, NEW_TOKENS)
    make_generate_fn(kv, 2)(prompt[:, :512])  # first launches
    torch.cuda.synchronize()
    build.reset_launch_counts()
    out = fn(prompt)
    torch.cuda.synchronize()
    launches_a = dict(build.launches)
    log(f"int8-KV path (a), default dispatch, launches: {launches_a}")
    want = {"flash_fwd": MODEL["n_layers"], "decode_attention_int8": 0, "decode_attention": 0}
    for name, n in want.items():
        if launches_a[name] != n:
            raise AssertionError(f"int8-KV (a): {name} launched {launches_a[name]} times, "
                                 f"want {n}")
    if out.shape != (BATCH, PROMPT + NEW_TOKENS) or not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError(f"int8-KV (a): output {tuple(out.shape)} malformed")
    check_logits(torch, "int8-KV (a)", kv, prompt, out)
    gen, ref = out[:, PROMPT:], bf16_out[:, PROMPT:]
    firsts = [next((i for i in range(NEW_TOKENS) if gen[b, i] != ref[b, i]), None)
              for b in range(BATCH)]
    bf16_fn = make_generate_fn(models["bf16"], NEW_TOKENS)
    peaks = {"bf16-KV": peak_gb(torch, lambda: bf16_fn(prompt)),
             "int8-KV": peak_gb(torch, lambda: fn(prompt))}
    S = cache_slots()
    per_layer = {"bf16-KV": 2 * BATCH * MODEL["n_kv_heads"] * S * 128 * 2,
                 "int8-KV": 2 * BATCH * MODEL["n_kv_heads"] * S * (128 + 4)}
    log(f"int8-KV (a) vs bf16-KV generate: greedy tokens equal "
        f"{int((gen == ref).sum())}/{gen.numel()}, first differing step per row {firsts}; "
        f"peak memory GB {peaks}; cache bytes (all layers) "
        f"{ {k: v * MODEL['n_layers'] for k, v in per_layer.items()} }")
    time_serving(torch, "int8-KV (a)", kv, fn, prompt)
    profile_decode(torch, kv, prompt, label="int8-KV (a) decode")

    tiered = kv_int8_model(torch, models["bf16"], tiered=True)
    del kv
    Lp, n_new = KV_TIERED["prompt"], KV_TIERED["new_tokens"]
    short = prompt[:, :Lp].contiguous()
    fn_t = make_generate_fn(tiered, n_new)
    make_generate_fn(tiered, 2)(short)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out_t = fn_t(short)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches_b = dict(build.launches)
    log(f"int8-KV path (b), tiered switch on, B={BATCH} prompt={Lp} new={n_new} "
        f"({seconds:.2f} s, {BATCH * n_new / seconds:.0f} tok/s host clock), launches: "
        f"{launches_b}")
    want_k = kv_expected_kernel_launches(Lp, n_new)
    if launches_b["decode_attention_int8"] != want_k or launches_b["decode_attention"] != 0:
        raise AssertionError(f"int8-KV (b): decode_attention_int8 launched "
                             f"{launches_b['decode_attention_int8']} times (want {want_k}), "
                             f"decode_attention {launches_b['decode_attention']} (want 0)")
    if out_t.shape != (BATCH, Lp + n_new) or not torch.equal(out_t[:, :Lp], short) \
            or int(out_t.min()) < 0 or int(out_t.max()) >= MODEL["vocab_size"]:
        raise AssertionError(f"int8-KV (b): output {tuple(out_t.shape)} malformed")
    # The tiered run's first steps against the default dispatch, both fed the
    # tiered run's tokens in a cache of the same allocation.
    slots = -(-(Lp + n_new) // 512) * 512
    default = kv_int8_model(torch, models["bf16"], tiered=False)
    got = teacher_forced_logits(torch, tiered, short, out_t, slots, KV_TIERED_STEPS)
    want = teacher_forced_logits(torch, default, short, out_t, slots, KV_TIERED_STEPS)
    del default, tiered
    diffs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    agree = [torch.equal(g.argmax(-1), w.argmax(-1)) for g, w in zip(got, want)]
    same = all(torch.equal(g.argmax(-1), out_t[:, Lp + i]) for i, g in enumerate(got))
    first = next((i for i, a in enumerate(agree) if not a), None)
    log(f"int8-KV (b) vs the default dispatch over the first {KV_TIERED_STEPS} steps: "
        f"tokens equal at every step: {first is None}"
        + ("" if first is None else f" (first disagreement at step {first}, logit gap "
           f"{diffs[first]:.4f})")
        + f"; max |logit diff| {max(diffs):.4f} (tol {LOGIT_TOL}); generate's tokens = the "
        f"tiered path's argmax: {same}")
    if max(diffs) > LOGIT_TOL or not same:
        raise AssertionError("int8-KV (b): the tiered dispatch disagrees with the default")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["kv_int8_launches"] = launches_a[name] + launches_b[name]
        if name == "decode_attention_int8":
            row["launches"] = launches_b[name]
    run_generate_cli(torch)


def run_generate_cli(torch) -> None:
    """(c) The real command at full width with an int8 KV cache; it must
    exit 0 and print the prompt and its continuation."""
    import os

    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.generate",
           "--random-init", "--kv-cache-dtype", "int8", "--d-model", str(MODEL["d_model"]),
           "--n-layers", str(MODEL["n_layers"]), "--n-heads", str(MODEL["n_heads"]),
           "--n-kv-heads", str(MODEL["n_kv_heads"]), "--vocab", str(MODEL["vocab_size"]),
           "--max-new-tokens", "32", "--temperature", "0"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    text = next((ln for ln in res.stdout.splitlines() if ln.startswith("The ")), None)
    log(f"cli.generate --kv-cache-dtype int8 ({time.perf_counter() - t0:.1f} s): exit code "
        f"{res.returncode}; output: {text and text[:200]!r}")
    if res.returncode != 0 or text is None:
        raise AssertionError(f"cli.generate: exit code {res.returncode}; output tail "
                             f"{(res.stdout + res.stderr)[-2000:]}")


def engine_traffic(torch, n: int = ENGINE_REQUESTS):
    """``n`` requests from SEED: prompt lengths in 256-4096 (the first two
    4096 and 300, so flash and dense prefill both run), new-token counts in
    8-64, token ids over the vocabulary."""
    gen = torch.Generator().manual_seed(SEED)
    lens = [4096, 300] + torch.randint(256, 4097, (n - 2,), generator=gen).tolist()
    news = torch.randint(8, 65, (n,), generator=gen).tolist()
    prompts = [torch.randint(0, MODEL["vocab_size"], (n,), generator=gen).tolist()
               for n in lens]
    return prompts, news


def drain_engine(torch, engine, prompts, news):
    """Submit every request at once and drain: (completions by rid, wall
    seconds of the drain, prefills included)."""
    for rid, (p, n) in enumerate(zip(prompts, news)):
        engine.submit(rid, p, max_new=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.drain()
    torch.cuda.synchronize()
    return {d["rid"]: d for d in done}, time.perf_counter() - t0


def check_completions(done: dict, prompts, news, label: str) -> None:
    if sorted(done) != list(range(len(prompts))):
        raise AssertionError(f"{label}: completed {sorted(done)}")
    for rid, d in done.items():
        toks, lp = d["tokens"], len(prompts[rid])
        if toks[:lp] != prompts[rid] or d["generated"] != news[rid] \
                or len(toks) != lp + news[rid]:
            raise AssertionError(f"{label}: request {rid} came back malformed")
        if min(toks) < 0 or max(toks) >= MODEL["vocab_size"]:
            raise AssertionError(f"{label}: request {rid} has token ids out of range")


def run_engine_path(torch, build, model, prompts, news, rows: dict) -> dict:
    """The engine's main path: ENGINE_REPEATS drains with the latency lever
    only (run a), then ENGINE_REPEATS with both levers under a fresh
    RegimeScheduler at its defaults (run b), launch counts zeroed just
    before and read just after.  Returns per run the last engine, the
    completions of every drain and their wall seconds."""
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )
    from distributed_machine_learning_tpu_torch.runtime.scheduler import (
        RegimeScheduler,
    )

    warm = ContinuousEngine(model, EngineConfig(**ENGINE), device=model.device)
    warm.warmup(prompt_lens=(300, 2048))  # first launches of each prefill path
    del warm
    runs: dict = {"a": {"done": [], "seconds": []}, "b": {"done": [], "seconds": []}}
    torch.cuda.synchronize()
    build.reset_launch_counts()
    for run, levers in (("a", ("latency",)), ("b", ("latency", "throughput"))):
        for _ in range(ENGINE_REPEATS):
            sched = RegimeScheduler() if run == "b" else None
            trace: list = []
            if sched is not None:  # record the lever of every step
                sched.observe = (lambda q, w, observe=sched.observe, trace=trace:
                                 trace.append(observe(q, w)) or trace[-1])
            engine = ContinuousEngine(model, EngineConfig(**ENGINE, levers=levers),
                                      scheduler=sched, device=model.device)
            done, seconds = drain_engine(torch, engine, prompts, news)
            runs[run]["done"].append(done)
            runs[run]["seconds"].append(seconds)
            runs[run]["engine"] = engine
            if sched is not None:
                flips = [i for i in range(1, len(trace)) if trace[i] != trace[i - 1]]
                log(f"engine run (b): regime flips {sched.flips} at steps {flips} of "
                    f"{len(trace)} ({' -> '.join([trace[0]] + [trace[i] for i in flips])})")
                if sched.flips < 1:
                    raise AssertionError("run (b): the regime scheduler never flipped")
    torch.cuda.synchronize()
    launches = dict(build.launches)
    log(f"engine path launches (runs a and b, {ENGINE_REPEATS} drains each): {launches}")
    for name in ("paged_attention", "flash_fwd", "quant_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the engine path")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["engine_launches"] = launches[name]
        if name == "paged_attention":
            row["launches"] = launches[name]
    for run, r in runs.items():
        for done in r["done"]:
            check_completions(done, prompts, news, f"engine run ({run})")
        same = all(d[k]["tokens"] == r["done"][0][k]["tokens"]
                   for d in r["done"][1:] for k in d)
        gen = sum(news)
        log(f"engine run ({run}): {len(prompts)} requests, {gen} generated tokens; "
            f"drain s {spread(r['seconds'])} -> generated tok/s "
            f"{spread([gen / x for x in r['seconds']])}; repeat drains give the "
            f"same tokens: {same}; levers by request "
            f"{[r['done'][-1][k]['lever'][0] for k in sorted(r['done'][-1])]}")
    by_len: dict = {}
    for done in runs["a"]["done"]:
        for rid, d in done.items():
            by_len.setdefault(len(prompts[rid]), []).append(d["prefill_s"] * 1e3)
    log("engine run (a) prefill ms by prompt length (host clock, token readback "
        "included): " + "; ".join(f"{n}: {spread(v)}" for n, v in sorted(by_len.items())))
    return runs


def check_first_tokens(torch, engine, done: dict, prompts, label: str) -> None:
    """Each request's prefill logits, kernel path vs plain path, within
    LOGIT_TOL; its first generated token must be the kernel path's argmax,
    and the plain path's unless the plain logits of the two tokens lie
    within LOGIT_TOL of each other (a near-tie of bf16 logits)."""
    from distributed_machine_learning_tpu_torch.inference.kv_blocks import blocks_needed

    worst, ties, failed = 0.0, [], []
    with torch.inference_mode():
        for rid, d in sorted(done.items()):
            model, lp = engine.models[d["lever"]], len(prompts[rid])
            tokens = torch.tensor([prompts[rid]], device=model.device)
            slots = blocks_needed(lp, ENGINE["block_size"]) * ENGINE["block_size"]

            def first():
                cache = model.init_cache(1, slots)
                return model(tokens, cache=cache, start=0, last_only=True)[0, -1]

            got = first()
            with plain_kernels():
                want = first()
            diff = float((got - want).abs().max())
            worst = max(worst, diff)
            tok, plain_tok = d["tokens"][lp], int(want.argmax())
            gap = float(want[plain_tok] - want[tok])
            if tok != plain_tok:
                ties.append((rid, round(gap, 4)))
            if not torch.isfinite(got).all() or diff > LOGIT_TOL \
                    or tok != int(got.argmax()) or gap > LOGIT_TOL:
                failed.append(rid)
    log(f"{label}: first tokens vs plain path over {len(done)} requests: prefill "
        f"logits max_abs_diff {worst:.4f} (tol {LOGIT_TOL}); first token = plain "
        f"argmax in {len(done) - len(ties)}, near-ties (request, plain logit gap) "
        f"{ties}; failed {failed}")
    if failed:
        raise AssertionError(f"{label}: first tokens of requests {failed} disagree")


def report_generate_parity(torch, model, done: dict, prompts) -> None:
    """Report (no gate): requests whose engine tokens equal the port's
    make_generate_fn at batch 1, and where the first divergence falls."""
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn

    same, diverged = 0, []
    for rid, d in sorted(done.items()):
        lp, n = len(prompts[rid]), d["generated"]
        out = make_generate_fn(model, n)(torch.tensor([prompts[rid]]))[0, lp:].tolist()
        ours = d["tokens"][lp:]
        if out == ours:
            same += 1
        else:
            diverged.append((rid, next(i for i in range(n) if out[i] != ours[i]), n))
    log(f"engine run (a) vs make_generate_fn at B=1: {same}/{len(done)} requests "
        f"equal token for token; diverged (request, first differing token, of): "
        f"{diverged}")


def check_engine_step(torch, model, prompts, news):
    """One engine decode step with all 8 lanes at ragged positions: its
    logits, kernel path vs plain path, for both levers, within LOGIT_TOL.
    Returns the engine (with its lanes in flight) and the step's inputs."""
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )

    engine = ContinuousEngine(model, EngineConfig(**ENGINE), device=model.device)
    for rid in range(ENGINE["max_lanes"]):
        engine.submit(rid, prompts[rid], max_new=news[rid])
    engine.step()  # admits (prefills) all 8 and runs their first decode step
    if engine.in_flight() != ENGINE["max_lanes"]:
        raise AssertionError(f"engine: {engine.in_flight()} lanes in flight")
    step = engine.decode_inputs()
    failed = []
    for lever in ("latency", "throughput"):
        got = engine.decode_logits(lever, step)
        with plain_kernels():
            want = engine.decode_logits(lever, step)
        diff = float((got - want).abs().max())
        agree = int((got.argmax(-1) == want.argmax(-1)).sum())
        log(f"engine decode step ({lever}, positions {step.positions.tolist()}): "
            f"logits kernel vs plain path max_abs_diff={diff:.4f} (tol {LOGIT_TOL}), "
            f"argmax agree {agree}/{len(got)}")
        if not torch.isfinite(got).all() or diff > LOGIT_TOL:
            failed.append(lever)
    if failed:
        raise AssertionError(f"engine decode-step logits disagree: {failed}")
    return engine, step


def time_engine(torch, model, prompts) -> None:
    """Engine decode step ms between CUDA events (8 lanes in flight, no
    admission or retirement in the window), per lever, then a profiler view
    of latency-lever steps."""
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )

    engine = ContinuousEngine(model, EngineConfig(**ENGINE), device=model.device)
    for rid in range(ENGINE["max_lanes"]):
        engine.submit(rid, prompts[rid], max_new=64)
    engine.step()
    for lever in ("latency", "throughput"):
        engine.note_lever(lever)
        engine.step()  # warm
        ms = [event_ms(torch, engine.step) for _ in range(20)]
        med = sorted(ms)[len(ms) // 2]
        log(f"engine decode step ({lever}, 8 lanes, CUDA events, ms): {spread(ms)} -> "
            f"{ENGINE['max_lanes'] / med * 1e3:.0f} tok/s at the median")
    engine.note_lever("latency")
    engine.step()
    profile_steps(torch, "engine decode step (latency, 8 lanes)",
                  lambda i: engine.step())
    if engine.in_flight() != ENGINE["max_lanes"]:
        raise AssertionError("engine timing window saw a retirement")
    engine.abort_all()


def serve_engine(torch, build, da, model, rows: dict) -> None:
    prompts, news = engine_traffic(torch)
    log(f"engine traffic: prompt lengths {[len(p) for p in prompts]}, new tokens {news}")
    runs = run_engine_path(torch, build, model, prompts, news, rows)
    for run in ("a", "b"):
        check_first_tokens(torch, runs[run]["engine"], runs[run]["done"][-1], prompts,
                           f"engine run ({run})")
    report_generate_parity(torch, model, runs["a"]["done"][-1], prompts)
    del runs
    engine, step = check_engine_step(torch, model, prompts, news)
    time_paged(torch, da, rows, step)
    engine.abort_all()
    del engine, step
    time_engine(torch, model, prompts)


def fleet_engines(torch, model, n: int) -> list:
    """``n`` engine replicas over ``model`` (ENGINE's config, both levers):
    one int8 twin shared by all, a paged pool each.  Each is warmed on both
    prefill paths and both levers before any worker thread starts."""
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )

    engines = []
    for _ in range(n):
        engine = ContinuousEngine(model, EngineConfig(**ENGINE), device=model.device,
                                  lever_models=engines[0].models if engines else None)
        engine.warmup(prompt_lens=(300, 2048))
        engines.append(engine)
    torch.cuda.synchronize(model.device)
    return engines


def fleet_run(torch, engines, prompts, news, *, scheduler=None, drain_after: int = 0,
              kill_after: int = 0, profile: bool = False) -> dict:
    """One fleet run: a router over an in-process hub (FLEET replicas live,
    the rest spares), one worker thread per engine, every request submitted
    through ``router.submit`` with back-pressure.  Beat times count from the
    moment the replicas are live.  ``drain_after``: drain
    replica 0 after that many completions; ``kill_after``: then stop another
    live replica's worker (its own stop event) and wait for its eviction.
    Returns the verdict, the completions by request index, the wall seconds
    from the first submit to idle, each rank's beat times and, with
    ``profile``, the run's device busy share (torch.profiler, CUDA only)."""
    import threading

    from distributed_machine_learning_tpu_torch.runtime import serving, serving_worker
    from distributed_machine_learning_tpu_torch.runtime import transport as tr

    beats: dict = {}

    def sync():  # every card the replicas run on
        for device in {engine.device for engine in engines}:
            torch.cuda.synchronize(device)

    class BeatLog(tr.InProcTransport):
        def publish_beat(self, rank, payload):
            beats.setdefault(rank, []).append(time.monotonic())
            super().publish_beat(rank, payload)

    prof, victim, result = None, None, {"busy": None}
    if profile:  # started before the fleet: its start holds up every thread a while
        from torch.profiler import ProfilerActivity, profile as tracer
        try:
            prof = tracer(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as exc:  # the tracer is optional: report, keep serving
            log(f"fleet profiler: not measured ({type(exc).__name__}: {exc})")
            prof = None
    hub = tr.InProcHub()
    cfg = serving.ServingConfig(replicas=FLEET["replicas"], max_queue=len(prompts),
                                micro_batch=ENGINE["max_lanes"],
                                max_outstanding=ENGINE["max_lanes"], poll_s=0.005)
    router = serving.ServingRouter(tr.InProcTransport(hub), cfg, scheduler=scheduler)
    stops = [threading.Event() for _ in engines]
    workers = [serving_worker.start_worker_thread(
        BeatLog(hub), rank, None, stops[rank],
        serving_worker.ServingWorkerConfig(micro_batch=ENGINE["max_lanes"]), engine=engine)
        for rank, engine in enumerate(engines)]
    stop_router = threading.Event()
    rt = threading.Thread(target=router.run, args=(stop_router,), name="fleet-router",
                          daemon=True)
    rt.start()
    try:
        deadline = time.monotonic() + 30.0
        while len(router._replicas) < FLEET["replicas"]:
            if time.monotonic() > deadline:
                raise AssertionError("fleet: replicas never went live")
            time.sleep(0.005)
        live_mono = time.monotonic()
        sync()
        t0 = time.perf_counter()
        rids, drained = [], drain_after <= 0
        deadline = time.monotonic() + 300.0

        def chaos():
            nonlocal drained, victim
            if not drained and router.completed >= drain_after:
                drained = router.drain(0)
            if kill_after and victim is None and router.completed >= kill_after:
                with router._lock:
                    live = [r for r, rep in sorted(router._replicas.items())
                            if r != 0 and not rep.draining]
                victim = live[0]
                stops[victim].set()

        for p, n in zip(prompts, news):
            while True:
                try:
                    rids.append(router.submit(p, max_new=n))
                    break
                except serving.Overloaded:
                    time.sleep(0.005)
            chaos()
        while router.completed < len(prompts) and time.monotonic() < deadline:
            chaos()
            time.sleep(0.002)
        if not router.wait_idle(max(deadline - time.monotonic(), 1.0)):
            raise AssertionError(f"fleet: not idle in time: {router.audit()}")
        sync()
        result["seconds"] = time.perf_counter() - t0
        result["span"] = (live_mono, time.monotonic())
        if prof is not None:
            prof.__exit__(None, None, None)
            result["busy"], prof = device_busy(torch, prof), None
        if victim is not None:  # the kill's eviction comes a beat timeout later
            while router.evictions < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
        by_rid = {rid: i for i, rid in enumerate(rids)}
        done = {}
        for rid, i in by_rid.items():
            entry = router.result(rid)
            levers = [ev.get("lever") for ev in entry["events"] if ev.get("stage") == "decode"]
            done[i] = {"tokens": entry["result"], "lever": levers[-1] if levers else None,
                       "generated": len(entry["result"] or ()) - len(prompts[i])}
        result["done"] = done
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        result["verdict"] = router.close()
        stop_router.set()
        for stop in stops:
            stop.set()
        for t, _ in workers:
            t.join(timeout=30)
        rt.join(timeout=10)
    result["beats"], result["victim"] = beats, victim
    return result


def log_fleet_run(run: str, r: dict, news, card: str) -> None:
    v, gen = r["verdict"], sum(news)
    lat = v["latency"]
    log(f"fleet run ({run}) [{card}]: {v['completed']}/{v['admitted']} completed, "
        f"exactly_once {v['exactly_once']}, {v['promotions']} promotions, "
        f"{v['evictions']} evictions, {v['drains']} drains, {v['duplicates_discarded']} "
        f"duplicates; {gen} generated tokens in {r['seconds']:.3f} s -> "
        f"{gen / r['seconds']:.1f} generated tok/s")
    log(f"fleet run ({run}) request latency s [{card}]: p50 {lat['p50']:.4f}, p95 "
        f"{lat['p95']:.4f}, p99 {lat['p99']:.4f}, max {lat['max']:.4f}")
    for stage in ("queued", "dispatched", "bound", "prefill", "decode", "completed", "requeued"):
        q = v["stage_latency"].get(stage)
        if q:
            log(f"  stage {stage:10s} s [{card}]: p50 {q['p50']:.4f}, p95 {q['p95']:.4f}, "
                f"p99 {q['p99']:.4f}, max {q['max']:.4f}")


def serve_fleet(torch, build, model, rows: dict, card: str) -> None:
    """The serving fleet at full width: engine replicas behind the router.
    (a) steady: FLEET live + spares, no scheduler (the latency lever),
    FLEET_REQUESTS requests; gates: exactly once with no eviction, every
    request well formed, first tokens against the plain path, K1 and K5
    launched; the
    device idle share over the run from the profiler.  (b) chaos: the same
    under a RegimeScheduler, replica 0 drained and another live replica
    killed; gates: exactly once, one eviction, one drain, FLEET_PROMOTIONS
    promotions, a regime flip, K6 launched.  Reports tokens/s beside the
    lone engine's drain of the same requests, latency and stage quantiles,
    the longest beat gap of a live replica, the launches of each run; then
    the real ``cli.serve --engine``."""
    from distributed_machine_learning_tpu_torch.runtime.scheduler import RegimeScheduler

    prompts, news = engine_traffic(torch, FLEET_REQUESTS)
    log(f"fleet traffic: {FLEET_REQUESTS} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, new tokens {news}")
    engines = fleet_engines(torch, model, FLEET["replicas"] + FLEET["spares"])
    lone, seconds = drain_engine(torch, engines[0], prompts, news)
    log(f"fleet: the lone engine's drain of the same requests (latency lever) [{card}]: "
        f"{seconds:.3f} s -> {sum(news) / seconds:.1f} generated tok/s")

    build.reset_launch_counts()
    a = fleet_run(torch, engines, prompts, news, profile=True)
    launches_a = dict(build.launches)
    log_fleet_run("a", a, news, card)
    log(f"fleet run (a) launches [{card}]: {launches_a}")
    t_lo, t_hi = a["span"]
    gaps = []
    for rank, ts in sorted(a["beats"].items()):
        ts = [t for t in ts if t_lo <= t <= t_hi]
        if len(ts) > 1:
            gaps.append((max(b - x for x, b in zip(ts, ts[1:])), rank))
    if gaps:
        gap, rank = max(gaps)
        log(f"fleet run (a): longest beat gap of a live replica {gap * 1e3:.1f} ms "
            f"(replica {rank}; beat interval 50 ms, eviction at 2000 ms) [{card}]")
    if a["busy"] is None:
        log("fleet run (a) profiler: not measured (no device events traced)")
    else:
        n, busy, window, by_name = a["busy"]
        log(f"fleet run (a) profiler (CUDA activity only) [{card}]: {n} device events, "
            f"busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms device window, "
            f"device idle share {1 - busy / max(window, 1e-9):.3f}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"  {us / 1e3:9.1f} ms  {name[:90]}")
    v = a["verdict"]
    if not (v["exactly_once"] and v["admitted"] == v["completed"] == FLEET_REQUESTS):
        raise AssertionError(f"fleet run (a): not exactly once: {v}")
    if v["evictions"] or v["promotions"] != FLEET["replicas"]:
        raise AssertionError(f"fleet run (a): a healthy replica was evicted: {v['evictions']} "
                             f"evictions, {v['promotions']} promotions")
    for name in ("flash_fwd", "paged_attention"):
        if launches_a[name] == 0:
            raise AssertionError(f"fleet run (a): {name} never launched")
    check_completions(a["done"], prompts, news, "fleet run (a)")
    same = sum(a["done"][i]["tokens"] == lone[i]["tokens"] for i in range(FLEET_REQUESTS))
    log(f"fleet run (a) vs the lone engine's drain: {same}/{FLEET_REQUESTS} requests equal "
        f"token for token")

    # Run (b) on fresh engines: a killed replica leaves its engine mid-flight.
    del engines
    gc.collect()
    engines = fleet_engines(torch, model, FLEET["replicas"] + FLEET["spares"])
    sched = RegimeScheduler()
    build.reset_launch_counts()
    b = fleet_run(torch, engines, prompts, news, scheduler=sched,
                  drain_after=FLEET_DRAIN_AFTER, kill_after=FLEET_KILL_AFTER)
    launches_b = dict(build.launches)
    log_fleet_run("b", b, news, card)
    log(f"fleet run (b): killed replica {b['victim']}; regime {sched.lever} after "
        f"{sched.flips} flip(s); levers by request "
        f"{[b['done'][i]['lever'][0] for i in range(FLEET_REQUESTS)]}")
    log(f"fleet run (b) launches [{card}]: {launches_b}")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["fleet_launches"] = launches_a[name] + launches_b[name]
    v = b["verdict"]
    want = dict(exactly_once=True, admitted=FLEET_REQUESTS, completed=FLEET_REQUESTS,
                evictions=1, drains=1, promotions=FLEET_PROMOTIONS)
    if any(v[k] != x for k, x in want.items()):
        raise AssertionError(f"fleet run (b): {({k: v[k] for k in want})}, want {want}")
    if sched.flips < 1:
        raise AssertionError("fleet run (b): the regime scheduler never flipped")
    if launches_b["quant_matmul"] == 0:
        raise AssertionError("fleet run (b): quant_matmul never launched")
    check_completions(b["done"], prompts, news, "fleet run (b)")
    # The plain path is swapped in module-wide: only with every fleet thread gone.
    check_first_tokens(torch, engines[0], a["done"], prompts, "fleet run (a)")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    run_serve_cli(torch)


def run_serve_cli(torch) -> None:
    """The real ``cli.serve --engine`` on the card: two replicas and a spare
    of the tiny engine (heads of dim 32), 64 requests, a drain after 16; it
    must exit 0 with the exactly-once audit passing."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as tel:
        cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.serve",
               "--engine", "--replicas", "2", "--spares", "1", "--requests", "64",
               "--drain-after", "16", "--telemetry-dir", tel]
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith(("fleet:", "requests:", "fleet events:", "latency:",
                                   "regime:", "exactly-once"))]
        log(f"cli.serve --engine ({time.perf_counter() - t0:.1f} s): exit code "
            f"{res.returncode}; " + " | ".join(lines))
        if res.returncode != 0 or "exactly-once audit: PASS" not in res.stdout:
            raise AssertionError(f"cli.serve --engine: exit code {res.returncode}; output "
                                 f"tail {(res.stdout + res.stderr)[-2000:]}")


# Trainer gates, kernel path vs plain path of one train step from the same
# state (step 2, after a warm step: the moments are non-zero), each at
# ~2.5x its reading on an H100 80GB HBM3 (700 W): the mean loss over the
# B x L tokens (3.6e-5); each leaf's gradient by relative L2 (worst
# 3.85e-2, the last layer's q projection, whose gradient sums dq rows that
# cancel; median 4.5e-3); each leaf's parameters after the update, their
# difference relative to the update's norm (worst 6.3e-2, the embedding,
# whose rows first seen in this step move by ~lr sign(g); median 6.4e-3).
# Both versions round P, dS and the outputs to bf16, at other places.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 0.1
TRAIN_UPDATE_TOL = 0.15
# --remat --remat-policy mlp recomputes the same ops on the same inputs:
# its step-0 loss equals the plain run's up to this relative difference.
REMAT_LOSS_RTOL = 1e-6


def trainer_args(*extra: str, iters: int | None = None):
    """cli.lm's flags for the trainer's main path (full width, bf16,
    fused AdamW, flash attention)."""
    from distributed_machine_learning_tpu_torch.cli import lm

    return lm.make_parser().parse_args([
        "--parallel", "dp", "--d-model", str(MODEL["d_model"]),
        "--n-layers", str(MODEL["n_layers"]), "--n-heads", str(MODEL["n_heads"]),
        "--n-kv-heads", str(MODEL["n_kv_heads"]), "--vocab", str(MODEL["vocab_size"]),
        "--seq-len", str(TRAIN["seq_len"]), "--batch-size", str(TRAIN["batch_size"]),
        "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--fused-update",
        "--attn", "flash", "--max-iters", str(iters or TRAIN["max_iters"]), *extra])


def recorded(step, losses: list):
    """The train step, keeping each step's loss tensor."""
    def run(state, tokens, targets):
        state, loss = step(state, tokens, targets)
        losses.append(loss)
        return state, loss
    return run


def run_trainer(torch, build, rows: dict) -> dict:
    """The trainer's main path, as cli.lm's main runs it (build, then
    train_epoch over the synthetic stream), with the launch counts zeroed
    just before and read just after: per step K1, K2 and K3 once per layer
    and K7 once per leaf.  Reports step ms (median and range over the
    timed steps), tokens/s, MFU and peak memory; returns the losses."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch
    from distributed_machine_learning_tpu_torch.utils.flops import (
        mfu,
        transformer_train_flops_per_token,
    )

    args = trainer_args()
    step, state, place, model = lm.build(args)
    n_leaves = sum(1 for _ in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    losses: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    state, timer = train_epoch(recorded(step, losses), state, lm.synthetic_batches(args),
                               place_batch=place, max_iters=args.max_iters)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n, layers = args.max_iters, MODEL["n_layers"]
    log(f"trainer path launches ({n} steps): {launches}")
    want = {"flash_fwd": layers * n, "flash_bwd_dq": layers * n, "flash_bwd_dkv": layers * n,
            "fused_adamw": n_leaves * n}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{name}: {launches[name]} launches on the trainer path, "
                                 f"want {count}")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["train_launches"] = launches[name]
        if name in ("flash_bwd_dq", "flash_bwd_dkv", "fused_adamw"):
            row["launches"] = launches[name]
    values = [float(x) for x in losses]
    if state.step != n or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"trainer: step {state.step} of {n}, losses {values}")
    # Random weights on uniform random tokens: the loss starts near
    # ln(vocab) (logits of std ~1 add ~0.5) and AdamW pulls it down.
    first_ok = abs(values[0] - math.log(MODEL["vocab_size"])) < 1.5
    if not first_ok or values[-1] >= values[0]:
        raise AssertionError(f"trainer losses out of line: {values}")
    ms = [t * 1e3 for t in timer.times]
    med = sorted(ms)[len(ms) // 2]
    tokens = TRAIN["batch_size"] * TRAIN["seq_len"]
    fpt = transformer_train_flops_per_token(n_params, layers, MODEL["d_model"],
                                            TRAIN["seq_len"])
    log(f"trainer: d{MODEL['d_model']}/{layers}L/GQA-{MODEL['n_kv_heads']}, "
        f"{n_params} params in {n_leaves} leaves, B={TRAIN['batch_size']} "
        f"L={TRAIN['seq_len']} bf16, fused AdamW, flash; losses "
        f"{[round(v, 4) for v in values]}")
    log(f"trainer: step ms (host clock to the loss sync, iteration 0 untimed) {spread(ms)} "
        f"-> {tokens / med * 1e3:.0f} tokens/s, MFU {mfu(fpt * tokens / med * 1e3):.4f} "
        f"({fpt:.4g} FLOPs/token at 989 TFLOP/s); peak memory {peak_gb:.2f} GB")
    profile_steps(torch, "train step", lambda i: step(state, *place(*next(
        lm.synthetic_batches(args, seed=i, count=1)))), steps=3)
    return {"losses": values}


def check_remat(torch, build, first_loss: float) -> None:
    """Two steps with --remat --remat-policy mlp: the same step-0 loss as
    the plain run (the same weights, batch and kernels), and attention is
    not recomputed (K1 once per layer per step)."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    args = trainer_args("--remat", "--remat-policy", "mlp", iters=2)
    step, state, place, _ = lm.build(args)
    losses: list = []
    build.reset_launch_counts()
    train_epoch(recorded(step, losses), state, lm.synthetic_batches(args), place_batch=place,
                max_iters=2)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    diff = abs(float(losses[0]) - first_loss) / abs(first_loss)
    log(f"remat mlp: losses {[float(x) for x in losses]}, step-0 loss vs the plain run: "
        f"relative diff {diff:.3e} (tol {REMAT_LOSS_RTOL:g}); launches {launches}")
    if diff > REMAT_LOSS_RTOL or launches["flash_fwd"] != 2 * MODEL["n_layers"]:
        raise AssertionError("remat run disagrees with the plain run")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_train_step(torch, label: str = "trainer") -> None:
    """One train step through the kernels and the same step through the
    plain versions (plain_kernels), from one state after a warm step; the
    loss, every leaf's gradient and every leaf's parameters after the
    update are held to the TRAIN_* limits.  Logs every reading first."""
    from distributed_machine_learning_tpu_torch.cli import lm

    args = trainer_args(iters=2)
    (x0, y0), (x1, y1) = lm.synthetic_batches(args)
    step, state, place, model = lm.build(args)
    step(state, *place(x0, y0))  # warm: non-zero moments
    step_p, state_p, _, model_p = lm.build(args)
    with torch.no_grad():
        for p, q in zip(model_p.parameters(), model.parameters()):
            p.copy_(q)
        for which in ("mu", "nu"):
            for k, v in state_p.momentum[which].items():
                v.copy_(state.momentum[which][k])
    state_p.step = state.step
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    x, y = place(x1, y1)
    _, loss = step(state, x, y)
    with plain_kernels():
        _, loss_p = step_p(state_p, x, y)
    torch.cuda.synchronize()
    loss, loss_p = float(loss), float(loss_p)
    params_p = dict(model_p.named_parameters())
    grad_err, update_err = {}, {}
    for k, p in model.named_parameters():
        grad_err[k] = rel_l2(p.grad, params_p[k].grad)
        update_err[k] = float((p.detach() - params_p[k].detach()).float().norm()
                              / (params_p[k].detach() - before[k]).float().norm()
                              .clamp_min(1e-30))
    worst_g = max(grad_err, key=grad_err.get)
    worst_u = max(update_err, key=update_err.get)
    log(f"{label} step, kernel vs plain path: loss {loss:.6f} vs {loss_p:.6f} (diff "
        f"{abs(loss - loss_p):.3e}, tol {TRAIN_LOSS_TOL:g}); gradient rel L2 worst "
        f"{grad_err[worst_g]:.3e} ({worst_g}), median "
        f"{sorted(grad_err.values())[len(grad_err) // 2]:.3e} (tol {TRAIN_GRAD_TOL:g}); "
        f"params after the update, diff / update norm worst {update_err[worst_u]:.3e} "
        f"({worst_u}), median {sorted(update_err.values())[len(update_err) // 2]:.3e} "
        f"(tol {TRAIN_UPDATE_TOL:g})")
    failed = []
    if not (math.isfinite(loss) and math.isfinite(loss_p)) or abs(loss - loss_p) > TRAIN_LOSS_TOL:
        failed.append("loss")
    if not grad_err[worst_g] <= TRAIN_GRAD_TOL:
        failed.append(f"gradient of {worst_g}")
    if not update_err[worst_u] <= TRAIN_UPDATE_TOL:
        failed.append(f"update of {worst_u}")
    if failed:
        raise AssertionError(f"{label} step, kernel vs plain: {', '.join(failed)} disagree")


def train(torch, build, rows: dict) -> None:
    """The trainer phases: the main path with its counts, the remat run,
    the kernel-vs-plain step gates."""
    t0 = time.perf_counter()
    out = run_trainer(torch, build, rows)
    check_remat(torch, build, out["losses"][0])
    check_train_step(torch)
    log(f"trainer phases: {time.perf_counter() - t0:.1f} s")


# The reference-parity VGG-11 parts (step 7), at the reference's widths:
# (label, strategy, world, per-rank batch, BatchNorm, flags).  Each run is
# `world` processes sharing the card.
VGG_RUNS = [
    ("part1", "none", 1, 256, False, []),
    ("part2a", "gather_scatter", 2, 64, False, []),
    ("part2b", "all_reduce", 2, 64, False, []),
    ("part3", "ring", 2, 64, True, []),
    ("part3 int8", "ring", 4, 64, True, ["--ring-compress", "int8", "--ring-codec-impl",
                                          "pallas"]),
]
VGG_ITERS = 40  # the reference's protocol: 40 iterations, iteration 0 untimed
VGG_PLATEAU_TOL = 0.05  # |loss - ln 10| of the BN-free parts (read: at most 0.008)
CODEC_KERNELS = ("ring_encode_int8", "ring_decode_add_int8", "ring_decode_int8")


def codec_launches_per_step(world: int, n_params: int) -> dict:
    """K8/K9/K10 launches per step per rank of the int8 ring with error
    feedback: B buckets, each a ring of W-1 reduce-scatter encodes (with the
    residual) and one all-gather encode, W-1 decode-adds and one batched
    decode of the all-gather's W payloads."""
    from distributed_machine_learning_tpu_torch.ops.ring import (
        DEFAULT_BUCKET_BYTES,
        _bucket_bounds,
    )

    b = len(_bucket_bounds(n_params, DEFAULT_BUCKET_BYTES, 4))
    return {"ring_encode_int8": b * world, "ring_decode_add_int8": b * (world - 1),
            "ring_decode_int8": b}


def _snapshot(state, step):
    clone = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    momentum = {k: v.clone() for k, v in state.momentum.items()}
    res = step.sync_state()
    return clone, momentum, None if res is None else res.clone(), state.step


def _restore(state, step, snap) -> None:
    import torch

    params, momentum, res, counter = snap
    with torch.no_grad():
        state.model.load_state_dict(params)
        for k, v in momentum.items():
            state.momentum[k].copy_(v)
    step.set_sync_state(None if res is None else res.clone())
    state.step = counter


def vgg_rank(rank: int, world: int, init_method: str, label: str, flags: list) -> dict:
    """One rank of a VGG run: ``cli.common.run_part`` as the part's ``main``
    runs it, the launch counts zeroed just before and read just after; then
    one more step whose synced gradients (and residual) are hashed, and for
    the int8 run the same step again through the plain codec from the same
    state (``plain_kernels``), compared bit for bit."""
    import hashlib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 is f32, as in the reference
    torch.backends.cudnn.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import common, part3
    from distributed_machine_learning_tpu_torch.ops import build

    _, strategy, _, batch, use_bn, _ = next(r for r in VGG_RUNS if r[0] == label)
    parser = part3.make_parser() if strategy == "ring" else common.make_flag_parser("")
    args = common.parse_flags(parser, [*flags, "--num-nodes", str(world), "--rank", str(rank),
                                       "--max-iters", str(VGG_ITERS)])
    kwargs = {"bucket_bytes": args.bucket_mb * 2**20} if strategy == "ring" else None
    codec_rows: dict = {}
    build.reset_launch_counts()
    with codec_row_tally(codec_rows):
        res = common.run_part(strategy, batch, use_bn, args, kwargs, init_method=init_method,
                              shutdown=False)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    out = {k: res[k] for k in ("losses", "times", "sync_ms", "backend", "wire", "device")}
    out["launches"] = dict(build.launches)
    out["codec_rows"] = codec_rows
    out["n_params"] = sum(p.numel() for p in res["state"].model.parameters())
    try:
        step, state = res["step"], res["state"]
        images, labels = res["place"](*next(res["batches"]()))
        # Device busy/idle over a few steps (every rank steps: collectives).
        taken = [0]

        def one(_i=None):
            step(state, images, labels)
            taken[0] += 1

        if rank == 0:
            profile_steps(torch, f"vgg {label} train step, rank 0 of {world}", one, steps=3)
        while taken[0] < 3:  # the same step count on every rank, profiled or not
            one()
        seen: dict = {}

        def observe(grads, residual):
            seen["grads"] = torch.cat([g.reshape(-1) for g in grads]).clone()
            seen["res"] = None if residual is None else residual.clone()

        step.observe = observe
        # The bitwise step gate needs the same gradients from the same
        # state twice: deterministic convolution algorithms from here on.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        snap = _snapshot(state, step)
        step(state, images, labels)
        flat = seen["grads"]
        out["digest"] = hashlib.sha256(flat.view(torch.int32).cpu().numpy().tobytes()).hexdigest()
        if "int8" in label:
            kernel = dict(seen)
            _restore(state, step, snap)
            with plain_kernels():
                step(state, images, labels)
            sync()
            out["plain_equal"] = {
                "grads": bits_equal(torch, kernel["grads"], seen["grads"]),
                "residual": bits_equal(torch, kernel["res"], seen["res"])}
    finally:
        res["ctx"].shutdown()
    return out


def run_vgg(torch, rows: dict) -> None:
    """The VGG parts (VGG_RUNS), each through its ranks; gates: finite,
    falling losses; the int8 run's K8/K9/K10 launches per step equal the
    formula on every rank (and no codec launch elsewhere), and rank 0's
    launches by codec row (``codec_row_tally``; a row's ``launches``) sum
    to each kernel's count; every rank's
    synced gradients bit for bit the same; the int8 step through the
    kernels equal to the same step through the plain codec, bit for bit,
    on every rank.  Reports step ms, the sync inside the step, images/s and
    the wire."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    failed = []
    for label, strategy, world, batch, use_bn, flags in VGG_RUNS:
        t0 = time.perf_counter()
        ranks = spawn(vgg_rank, world, (label, flags), timeout_s=600)
        r0 = ranks[0]
        losses = r0["losses"]
        head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        finite = all(math.isfinite(x) for r in ranks for x in r["losses"])
        ms = [t * 1e3 for t in r0["times"]]
        sync = r0["sync_ms"][1:]
        med = sorted(ms)[len(ms) // 2]
        log(f"vgg {label}: world {world} x batch {batch} ({r0['n_params']} params, "
            f"{'BN' if use_bn else 'no BN'}), backend {r0['backend'] or 'none'}, "
            f"wire {r0['wire']}, "
            f"{r0['device']}; {time.perf_counter() - t0:.1f} s with process start")
        log(f"vgg {label}: losses {[round(x, 4) for x in losses[:3]]} ... "
            f"{[round(x, 4) for x in losses[-3:]]} (first-5 mean {head:.4f}, last-5 "
            f"{tail:.4f}); step ms (host clock, rank 0) {spread(ms)} -> "
            f"{world * batch / med * 1e3:.0f} images/s"
            + (f"; sync in the step (CUDA events) {spread(sync)}" if sync else ""))
        # BN-free VGG-11 at lr 0.1 sits on the ln 10 plateau for the
        # reference's 40 iterations (read on the CPU port: 2.2988-2.3108);
        # it must stay finite and on it.  With BN the loss must fall.
        plateau = all(abs(x - math.log(10)) < VGG_PLATEAU_TOL for r in ranks for x in r["losses"])
        if not finite or not (tail < head if use_bn else plateau):
            failed.append(f"{label}: losses not finite and "
                          f"{'falling' if use_bn else 'on the ln 10 plateau'}")
        if world > 1:
            same = len({r["digest"] for r in ranks}) == 1
            log(f"vgg {label}: synced gradients bit for bit equal on all {world} ranks: {same}")
            if not same:
                failed.append(f"{label}: ranks' synced gradients differ")
        want = (codec_launches_per_step(world, r0["n_params"]) if "int8" in label
                else dict.fromkeys(CODEC_KERNELS, 0))
        per_step = [{k: r["launches"][k] / VGG_ITERS for k in CODEC_KERNELS} for r in ranks]
        ok = all(p == want for p in per_step)
        log(f"vgg {label}: codec launches per step by rank {per_step} (want {want}): "
            f"{'ok' if ok else 'BAD'}")
        if not ok:
            failed.append(f"{label}: codec launches per step")
        if "int8" in label:
            eq = [r["plain_equal"] for r in ranks]
            log(f"vgg {label}: one step kernels vs plain codec, bit for bit (grads, residual) "
                f"by rank: {eq}")
            if not all(e["grads"] and e["residual"] for e in eq):
                failed.append(f"{label}: kernel step differs from the plain-codec step")
            tally = r0["codec_rows"]
            by_kernel = {k: sum(c for key, c in tally.items() if key.split(":")[0] == k)
                         for k in CODEC_KERNELS}
            ok = by_kernel == {k: r0["launches"][k] for k in CODEC_KERNELS}
            log(f"vgg {label}: codec launches by row, rank 0: {tally}: "
                f"{'ok' if ok else 'BAD'} (sums {by_kernel})")
            if not ok:
                failed.append(f"{label}: codec launches by row do not sum to the counts")
            for key, row in rows.items():
                if key.split(":")[0] in CODEC_KERNELS:
                    row["launches"] = tally.get(key, 0)
            for k in CODEC_KERNELS:  # the device time each kernel leaves above its bound
                timed = [row for key, row in rows.items()
                         if key.split(":")[0] == k and "ms" in row]
                if timed:
                    gap = sum(row["launches"] * (row["ms"] - row["bound_ms"]) for row in timed)
                    log(f"vgg {label}: {k}, launches x (ms - bound) over the rows, rank 0: "
                        f"{gap:.4f} ms")
        for key, row in rows.items():
            name = key.split(":")[0]
            row["vgg_launches"] = row.get("vgg_launches", 0) + (
                r0["codec_rows"].get(key, 0) if name in CODEC_KERNELS else r0["launches"][name])
    if failed:
        raise AssertionError("vgg: " + "; ".join(failed))


def run_vgg_cli(torch, backend: str | None = None) -> None:
    """part3 int8 through the real command: two processes of
    ``python -m distributed_machine_learning_tpu_torch.cli.part3`` with
    ``--master-ip/--rank/--num-nodes``; both exit 0 and rank 0 prints the
    reference's protocol lines (and, if ``backend`` is given, names it in
    its banner)."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.part3",
           "--master-ip", f"127.0.0.1:{port}", "--num-nodes", "2", "--ring-compress", "int8",
           "--ring-codec-impl", "pallas", "--max-iters", "21", "--eval-batches", "4"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    lines = [ln for ln in outs[0].splitlines() if ln.startswith((
        "strategy=", "Loss at", "Total execution", "Average execution", "Test set"))]
    log(f"cli.part3 int8, 2 processes ({time.perf_counter() - t0:.1f} s): exit codes {rcs}; "
        f"rank 0: {lines}")
    want = ("strategy=ring world_size=2", "Loss at 20th batch is ", "Total execution time is",
            "Average execution time is", "Test set: Average loss")
    if rcs != [0, 0] or not all(any(ln.startswith(w) for ln in lines) for w in want) \
            or (backend and f"backend={backend}" not in lines[0]):
        raise AssertionError(f"cli.part3: exit codes {rcs}; output tails "
                             f"{[o[-2000:] for o in outs]}")


# The ring flash chunk kernels K11-K13 (step 2), held to their plain
# versions with the row gates of K1-K3 at the ring path's chunk: rank 1 of
# a two-chunk ring, B 1, Lc 4096, H 16 / Hkv 4, D 128, bf16 (the diagonal
# step from the empty carry, then the full step with the diagonal's carry
# in, and K12/K13 adding into the diagonal step's dq and traveling dK/dV),
# f32 at Lc 32, D 32, and bf16 at chunk lengths that end inside a 128-row
# tile (Lc 100: one partial tile; 2100: 16 full tiles and a tail of 52
# rows).  m within LSE_TOL, l within LSE_TOL relative.
RING_CHECKS = [(4096, 16, 4, 128, "bfloat16"), (32, 4, 2, 32, "float32"),
               (100, 16, 4, 128, "bfloat16"), (2100, 16, 4, 128, "bfloat16")]


def ring_block(Lc: int) -> int:
    """The plain versions' tile in the ring checks: the reference's (the
    largest power of two <= 512 dividing Lc) where that is 512 or Lc, else
    512 with a short last tile (Lc 2100's own would be 4: 275,625 tiles a
    full step).  The tile orders the plain sums and nothing else."""
    return min(Lc, 512)


def ring_case(torch, rf, Lc, H, Hkv, D, dtype, gen):
    """q, dO of chunk 1; (k, v) of chunk 1 (diagonal) and chunk 0 (full);
    the lse and delta = rowsum(dO o O) of the two-chunk rows (plain)."""
    dt = getattr(torch, dtype)
    q, do = (torch.randn(1, Lc, H, D, device="cuda", generator=gen).to(dt) for _ in "ab")
    own, prev = ([torch.randn(1, Lc, Hkv, D, device="cuda", generator=gen).to(dt)
                  for _ in "ab"] for _ in "ab")
    m = torch.full((1, H, Lc), -1e30, device="cuda")
    empty = (m, torch.zeros_like(m), torch.zeros(1, Lc, H, D, device="cuda"))
    blk = ring_block(Lc)
    m1, l1, acc1 = rf.chunk_fwd_reference(q, *prev, *rf.chunk_fwd_reference(
        q, *own, *empty, True, blk), False, blk)
    out = (acc1 / l1.transpose(1, 2)[..., None]).to(dt)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, do, own, prev, empty, m1 + torch.log2(l1), delta


def check_ring_flash(torch, rf, rows: dict, timing: bool) -> None:
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs: dict = {"ring_flash_fwd": [], "ring_flash_dq": [], "ring_flash_dkv": []}
    failed: list = []
    for Lc, H, Hkv, D, dtype in RING_CHECKS:
        q, do, own, prev, empty, lse, delta = ring_case(torch, rf, Lc, H, Hkv, D, dtype, gen)
        carry = empty
        dq = torch.zeros(1, Lc, H, D, device="cuda")
        dk, dv = torch.zeros(1, Lc, Hkv, D, device="cuda"), torch.zeros(1, Lc, Hkv, D,
                                                                        device="cuda")
        for causal, (k, v) in ((True, own), (False, prev)):
            label = f"{'diagonal' if causal else 'full'} Lc={Lc} H={H} Hkv={Hkv} D={D} {dtype}"
            got = [t.clone() for t in carry]
            rf._launch_fwd(q, k, v, *got, causal)
            gdq, gdk, gdv = dq.clone(), dk.clone(), dv.clone()
            rf._launch_dq(q, k, v, do, lse, delta, gdq, causal)
            rf._launch_dkv(q, k, v, do, lse, delta, gdk, gdv, causal)
            torch.cuda.synchronize()
            blk = ring_block(Lc)
            want = rf.chunk_fwd_reference(q, k, v, *carry, causal, blk)
            m_err = float((got[0] - want[0]).abs().max())
            l_err = float(((got[1] - want[1]) / want[1]).abs().max())
            log(f"  ring_flash_fwd {label}: m max_abs_err={m_err:.3e}, l max_rel_err="
                f"{l_err:.3e} (tol {LSE_TOL:g}) -> "
                f"{'ok' if max(m_err, l_err) <= LSE_TOL else 'BAD'}")
            if not max(m_err, l_err) <= LSE_TOL:
                failed.append(f"ring_flash_fwd m/l {label}")
            errs["ring_flash_fwd"].append(compare(f"ring_flash_fwd acc {label}", got[2],
                                                  want[2], failed))
            want_dq = rf.chunk_dq_reference(q, k, v, do, lse, delta, dq, causal, blk)
            errs["ring_flash_dq"].append(compare(f"ring_flash_dq {label}", gdq, want_dq,
                                                 failed, GRAD_ROW_FLOOR))
            want_kv = rf.chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv, causal, blk)
            for name, g, w in (("dk", gdk, want_kv[0]), ("dv", gdv, want_kv[1])):
                errs["ring_flash_dkv"].append(compare(f"ring_flash_dkv {name} {label}", g, w,
                                                      failed, GRAD_ROW_FLOOR))
            # The full step starts from the diagonal step's results.
            carry, dq, (dk, dv) = want, want_dq, want_kv
    for name, e in errs.items():
        rows[name] = {"max_abs_err": max(e)}
    raise_failed(failed)
    if timing:
        time_ring_flash(torch, rf, rows, gen)


def time_ring_flash(torch, rf, rows: dict, gen) -> None:
    """K11-K13 at the ring path's full step (an earlier chunk, every pair,
    B 1, Lc 4096, H 16 / Hkv 4, D 128, bf16) beside their bounds, plain
    versions and one library call: SDPA (non-causal, K/V repeated) for K11,
    SDPA's backward (one call: dq, dk, dv; the fastest pinned backend) for
    K12 and K13; the diagonal step's times are logged beside them."""
    Lc, H, Hkv, D, dtype = RING_CHECKS[0]
    q, do, own, prev, empty, lse, delta = ring_case(torch, rf, Lc, H, Hkv, D, dtype, gen)
    carry = [t.clone() for t in rf.chunk_fwd_reference(q, *own, *empty, True)]
    dq = torch.zeros(1, Lc, H, D, device="cuda")
    dk, dv = torch.zeros(1, Lc, Hkv, D, device="cuda"), torch.zeros(1, Lc, Hkv, D, device="cuda")
    k, v = prev
    pairs = float(H * Lc * Lc)
    qo, kv, rowb = 2 * Lc * H * D, 2 * Lc * Hkv * D, 4 * H * Lc  # bf16 q/dO, k/v; f32 row
    acc_q, acc_kv = 4 * Lc * H * D, 4 * Lc * Hkv * D  # f32 accumulators
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                  (q, k.repeat_interleave(H // Hkv, 2), v.repeat_interleave(H // Hkv, 2)))
    bwd_ms, backend = sdpa_backward_ms(torch, q, k, v, do, False, "non-causal")
    cases = {
        "ring_flash_fwd": (lambda c: rf._launch_fwd(q, k, v, *carry, c),
                           lambda: rf.chunk_fwd_reference(q, k, v, *carry, False),
                           4.0 * D * pairs, qo + 2 * kv + 4 * rowb + 2 * acc_q,
                           time_ms(lambda: sdpa(qt, kt, vt)),
                           "SDPA, non-causal, K/V repeated"),
        "ring_flash_dq": (lambda c: rf._launch_dq(q, k, v, do, lse, delta, dq, c),
                          lambda: rf.chunk_dq_reference(q, k, v, do, lse, delta, dq, False),
                          6.0 * D * pairs, 2 * qo + 2 * kv + 2 * rowb + 2 * acc_q, bwd_ms,
                          f"SDPA backward, non-causal, {backend}: dq, dk and dv"),
        "ring_flash_dkv": (lambda c: rf._launch_dkv(q, k, v, do, lse, delta, dk, dv, c),
                           lambda: rf.chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv,
                                                          False),
                           8.0 * D * pairs, 2 * qo + 2 * kv + 2 * rowb + 4 * acc_kv, bwd_ms,
                           f"SDPA backward, non-causal, {backend}: dq, dk and dv"),
    }
    for name, (kernel, plain, flops, nbytes, library_ms, library) in cases.items():
        full_ms = time_ms(lambda: kernel(False))
        diag_ms = time_ms(lambda: kernel(True))
        rows[name].update(
            ms=full_ms, plain_ms=eager_ms(torch, plain, iters=2), library_ms=library_ms,
            **bound(flops, BF16_FLOPS, nbytes),
            shape=f"full ring step, B=1 Lc={Lc} H={H} Hkv={Hkv} D={D} bf16 "
                  f"(diagonal step {diag_ms:.4f} ms); library: {library}")
        log(f"  {name}: diagonal step {diag_ms:.4f} ms ({diag_ms / full_ms:.2f}x the full "
            f"step), plain (full) {rows[name]['plain_ms']:.2f}")
        log_rate(f"{name} full step", rows[name], flops, library)


# The context-parallel trainer (step 8): cli.lm --parallel ring at the
# model's full width, RING["world"] ranks sharing the card (gloo over host
# buffers), each rank a chunk of seq_len / world = 4096 tokens.
RING = dict(world=4, seq_len=16384, batch_size=1, max_iters=6)
# The real command: two processes of cli.lm --parallel ring, cut to 2 layers.
RING_CLI = dict(world=2, n_layers=2, seq_len=8192, max_iters=3)
# The ring path's step-0 loss (the mean CE over B 1 x L 16384 tokens at the
# seeded weights, ~ln 32000 = 10.4) against the one-process dp path (K1 over
# the whole sequence) on the same batch: both bf16, with P and the
# activations rounded at other places (64-key tiles of one chunk vs of the
# whole row); per-token differences of ~1e-3 average down over 16384
# tokens, so 2e-3 is an order of magnitude above the expected reading.
RING_DP_LOSS_TOL = 2e-3
RING_KERNELS = ("ring_flash_fwd", "ring_flash_dq", "ring_flash_dkv")
# The ring step gate holds each leaf's gradient, kernel path vs plain path,
# to TRAIN_GRAD_TOL or to RING_NOISE_FACTOR times the distance between two
# correct plain versions (the chunk steps tiled by 512, the reference's
# tile, and by RING_NOISE_BLOCK), whichever is larger.  At L 16384 the q
# projections' gradients sum dq rows over up to 16384 keys that cancel: on
# an H100 80GB HBM3 (700 W) kernel vs plain read 0.18 on
# blocks.5.attn.q.weight (median leaf 3.1e-3; the dp trainer's worst at
# L 4096 is 0.0385) and the two plain tilings 0.153 on the same leaf, with
# the loss within 8e-6 and every update within 7.5e-3.  A wrong kernel (a
# dropped tile, chunk or head) moves gradients by O(1), far above either
# limit.
RING_NOISE_BLOCK = 256
RING_NOISE_FACTOR = 2.5


def ring_args(rank: int, world: int, seq_len: int, iters: int):
    """cli.lm's flags for the ring path (full width, bf16, fused AdamW,
    --attn flash, which the upgrade rule turns into ring_flash)."""
    return trainer_args("--parallel", "ring", "--num-nodes", str(world), "--rank", str(rank),
                        "--seq-len", str(seq_len), "--batch-size", str(RING["batch_size"]),
                        iters=iters)


class WireTimer:
    """CUDA events around every ring hop (``Comm.shift``) and every gradient
    mean of a rank, summed per step: how long the stream waited on the
    wire (under the host wire each call is a D2H copy, TCP and an H2D
    copy)."""

    def __init__(self, torch):
        self.torch = torch
        self.events: dict = {"hop": [], "mean": []}
        self.marks: list = []

    def wrap(self, kind: str, fn):
        def timed(*args, **kwargs):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[kind].append((start, end))
            return out
        return timed

    def mark(self) -> None:
        self.marks.append({k: len(v) for k, v in self.events.items()})

    def per_step(self, kind: str) -> list:
        """ms of ``kind`` in each step after the first (call after a sync)."""
        ends = [m[kind] for m in self.marks]
        ev = self.events[kind]
        return [sum(s.elapsed_time(e) for s, e in ev[a:b]) for a, b in zip(ends, ends[1:])]


def ring_rank(rank: int, world: int, init_method: str) -> dict:
    """One rank of the ring path: cli.lm's build and train_epoch, as its
    main runs them, the launch counts zeroed just before and read just
    after; then a parameter digest, a profiled view on rank 0 (every rank
    steps alike), and one step through the kernels and the same step through
    the plain versions from the same state, compared leaf by leaf."""
    import hashlib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train import lm_step
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    args = ring_args(rank, world, RING["seq_len"], RING["max_iters"])
    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    try:
        step, state, place, model = lm.build(args, ctx)
        comm = model.comm
        wire = WireTimer(torch)
        comm.shift = wire.wrap("hop", comm.shift)
        lm_step.mean_over_ranks_ = wire.wrap("mean", lm_step.mean_over_ranks_)
        losses: list = []

        def run(state, tokens, targets):
            state, loss = step(state, tokens, targets)
            losses.append(loss)
            wire.mark()
            return state, loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        state, timer = train_epoch(run, state, lm.synthetic_batches(args), place_batch=place,
                                   max_iters=args.max_iters)
        torch.cuda.synchronize()
        out = {"launches": dict(build.launches), "losses": [float(x) for x in losses],
               "times": timer.times, "hop_ms": wire.per_step("hop"),
               "mean_ms": wire.per_step("mean"), "steps": state.step,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "attn": model.attn_impl,
               "backend": ctx.backend, "wire": comm.wire, "device": str(ctx.device),
               "n_leaves": sum(1 for _ in model.parameters())}
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().view(torch.int32).cpu().numpy().tobytes())
        out["digest"] = digest.hexdigest()

        def one(i):
            step(state, *place(*next(lm.synthetic_batches(args, seed=100 + i, count=1))))

        if rank == 0:
            profile_steps(torch, f"ring train step, rank 0 of {world}", one, steps=2)
        else:
            for i in range(2):
                one(i)
        torch.cuda.synchronize()
        out.update(ring_step_gate(torch, step, state, model, place, args))
        return out
    finally:
        ctx.shutdown()


def ring_step_gate(torch, step, state, model, place, args) -> dict:
    """One ring step through the kernels and the same step through the
    plain versions (plain_kernels) from one state, then the plain step
    again with the chunk steps tiled by RING_NOISE_BLOCK: the bf16 noise
    between two correct plain versions, per leaf.  The state is kept on the
    host in between.  Returns the loss pair, the worst and median leaf of
    the update error, and of the gradient error against its limit
    max(TRAIN_GRAD_TOL, RING_NOISE_FACTOR x that leaf's noise)."""
    from distributed_machine_learning_tpu_torch.cli import lm

    x, y = place(*next(lm.synthetic_batches(args, seed=200, count=1)))
    params = dict(model.named_parameters())
    snap = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    moments = {w: {k: v.to("cpu", copy=True) for k, v in state.momentum[w].items()}
               for w in ("mu", "nu")}
    counter = state.step

    def restore():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap[k])
            for w in ("mu", "nu"):
                for k, v in state.momentum[w].items():
                    v.copy_(moments[w][k])
        state.step = counter

    _, loss = step(state, x, y)
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    after = {k: p.detach().clone() for k, p in params.items()}
    restore()
    with plain_kernels():
        _, loss_p = step(state, x, y)
    torch.cuda.synchronize()
    grad_err, update_err = {}, {}
    for k, p in params.items():
        grad_err[k] = rel_l2(grads[k], p.grad)
        moved = (p.detach() - snap[k].to(p.device)).float().norm().clamp_min(1e-30)
        update_err[k] = float((after[k] - p.detach()).float().norm() / moved)
    del after
    grads = {k: p.grad.detach().clone() for k, p in params.items()}  # the plain path's
    restore()
    with plain_kernels(ring_block=RING_NOISE_BLOCK):
        step(state, x, y)
    torch.cuda.synchronize()
    noise = {k: rel_l2(p.grad, grads[k]) for k, p in params.items()}
    ratio = {k: grad_err[k] / max(TRAIN_GRAD_TOL, RING_NOISE_FACTOR * noise[k])
             for k in grad_err}
    med = lambda d: sorted(d.values())[len(d) // 2]  # noqa: E731
    worst_g, worst_u = max(ratio, key=ratio.get), max(update_err, key=update_err.get)
    worst_e = max(grad_err, key=grad_err.get)
    return {"gate": {"loss": float(loss), "loss_plain": float(loss_p),
                     "grad": (worst_g, grad_err[worst_g], noise[worst_g], ratio[worst_g],
                              med(grad_err), worst_e, grad_err[worst_e], noise[worst_e]),
                     "update": (worst_u, update_err[worst_u], med(update_err))}}


def ring_dp_loss(torch) -> float:
    """The step-0 loss of the one-process dp path (K1 over the whole
    sequence) on the ring path's first batch, at the same seeded weights."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss

    args = trainer_args("--seq-len", str(RING["seq_len"]), "--batch-size",
                        str(RING["batch_size"]), iters=1)
    _, _, place, model = lm.build(args)
    with torch.no_grad():
        loss = float(lm_loss(model, *place(*next(lm.synthetic_batches(args)))))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def run_ring(torch, rows: dict) -> None:
    """The ring path (RING) in its ranks; gates: K11/K12/K13 launched
    layers x (r + 1) times a step on rank r, K1-K3 never, K7 once per leaf a
    step; every rank's parameters bit for bit equal; losses finite and
    falling; the step-0 loss against the dp path; one step kernel vs plain
    on every rank.  Reports step ms, tokens/s, hop and gradient-mean ms a
    step, peak memory per rank and the wire."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    world, layers = RING["world"], MODEL["n_layers"]
    t0 = time.perf_counter()
    dp_loss = ring_dp_loss(torch)
    ranks = spawn(ring_rank, world, timeout_s=900)
    r0, n = ranks[0], RING["max_iters"]
    failed = []
    log(f"ring: world {world} x B {RING['batch_size']} x L {RING['seq_len']} (chunk "
        f"{RING['seq_len'] // world}), attn {r0['attn']}, backend {r0['backend']}, wire "
        f"{r0['wire']}, {r0['device']}; {time.perf_counter() - t0:.1f} s with process start")
    for r, out in enumerate(ranks):
        want = {name: layers * (r + 1) * n for name in RING_KERNELS}
        want.update(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                    fused_adamw=out["n_leaves"] * n)
        got = {k: out["launches"][k] for k in want}
        ok = got == want
        log(f"ring rank {r}: launches over {n} steps {got} (want {want}): "
            f"{'ok' if ok else 'BAD'}; peak memory {out['peak_gb']:.2f} GB")
        if not ok:
            failed.append(f"rank {r} launches")
    losses = r0["losses"]
    finite = all(math.isfinite(x) for r in ranks for x in r["losses"])
    same_loss = all(r["losses"] == losses for r in ranks)
    if not (finite and same_loss and losses[-1] < losses[0] and r0["steps"] == n
            and abs(losses[0] - math.log(MODEL["vocab_size"])) < 1.5):
        failed.append(f"losses {[r['losses'] for r in ranks]}")
    diff = abs(losses[0] - dp_loss)
    log(f"ring: losses {[round(x, 4) for x in losses]}; step-0 loss vs the one-process dp "
        f"path {losses[0]:.6f} vs {dp_loss:.6f} (diff {diff:.3e}, tol {RING_DP_LOSS_TOL:g})")
    if not diff <= RING_DP_LOSS_TOL:
        failed.append("step-0 loss vs dp")
    same = len({r["digest"] for r in ranks}) == 1
    log(f"ring: parameters bit for bit equal on all {world} ranks: {same}")
    if not same:
        failed.append("ranks' parameters differ")
    for r, out in enumerate(ranks):
        g = out["gate"]
        name, err, noise, ratio, median, name_e, err_e, noise_e = g["grad"]
        log(f"ring rank {r} step, kernel vs plain path: loss {g['loss']:.6f} vs "
            f"{g['loss_plain']:.6f} (tol {TRAIN_LOSS_TOL:g}); gradient rel L2 median "
            f"{median:.3e}, largest {err_e:.3e} ({name_e}; plain tiled {RING_NOISE_BLOCK} vs "
            f"plain: {noise_e:.3e}); worst against its limit {err:.3e} ({name}; limit "
            f"max({TRAIN_GRAD_TOL:g}, {RING_NOISE_FACTOR:g} x {noise:.3e}), ratio {ratio:.3f}); "
            f"update worst {g['update'][1]:.3e} ({g['update'][0]}), median "
            f"{g['update'][2]:.3e} (tol {TRAIN_UPDATE_TOL:g})")
        if not (abs(g["loss"] - g["loss_plain"]) <= TRAIN_LOSS_TOL
                and ratio <= 1.0 and g["update"][1] <= TRAIN_UPDATE_TOL):
            failed.append(f"rank {r} kernel vs plain step")
    ms = [t * 1e3 for t in r0["times"]]
    tokens = RING["batch_size"] * RING["seq_len"]
    log(f"ring: step ms (host clock to the loss sync, rank 0, iteration 0 untimed) "
        f"{spread(ms)} -> {tokens / sorted(ms)[len(ms) // 2] * 1e3:.0f} tokens/s")
    for r, out in enumerate(ranks):
        log(f"ring rank {r}: hops {spread(out['hop_ms'])} ms a step, gradient mean "
            f"{spread(out['mean_ms'])} ms a step (CUDA events)")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["ring_launches"] = sum(r["launches"][name] for r in ranks)
        if name in RING_KERNELS:
            row["launches"] = row["ring_launches"]
    if failed:
        raise AssertionError("ring: " + "; ".join(failed))


def run_ring_cli(torch, backend: str | None = None) -> None:
    """The ring path through the real command: RING_CLI["world"] processes
    of ``python -m distributed_machine_learning_tpu_torch.cli.lm --parallel
    ring --master-ip --rank --num-nodes`` (full width, cut to 2 layers);
    every process exits 0 and rank 0 prints the protocol lines (and, if
    ``backend`` is given, names it in its banner)."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world = RING_CLI["world"]
    args = ring_args(0, world, RING_CLI["seq_len"], RING_CLI["max_iters"])
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in (
        ("d_model", args.d_model), ("n_layers", RING_CLI["n_layers"]), ("n_heads", args.n_heads),
        ("n_kv_heads", args.n_kv_heads), ("vocab", args.vocab), ("seq_len", args.seq_len),
        ("batch_size", args.batch_size), ("max_iters", args.max_iters))]
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.lm",
           "--parallel", "ring", "--num-nodes", str(world), "--master-ip", f"127.0.0.1:{port}",
           "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--fused-update",
           "--attn", "flash", *flags]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith(("lm parallel=", "Total execution", "Average execution"))]
    log(f"cli.lm --parallel ring, {world} processes ({time.perf_counter() - t0:.1f} s): "
        f"exit codes {rcs}; rank 0: {lines}")
    want = (f"lm parallel=ring devices={world}", "Total execution time is",
            "Average execution time is")
    if rcs != [0] * world or not all(any(ln.startswith(w) for ln in lines) for w in want) \
            or "attn=ring_flash" not in lines[0] \
            or (backend and f"backend={backend}" not in lines[0]):
        raise AssertionError(f"cli.lm ring: exit codes {rcs}; output tails "
                             f"{[o[-2000:] for o in outs]}")


def perturb(torch, pkg, name: str) -> int:
    """Build one kernel from a broken copy of its source and report which
    checks catch it; 0 if the kernel checks do."""
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.ops import decode_attention as da
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops import fused_adamw as fadam
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm

    kernel, old, new, *where = PERTURBATIONS[name]
    fname = where[0] if where else f"{kernel}.cu"
    text = (build.CSRC / fname).read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the text to perturb is not in {fname} once")
    copy = build.BUILD_DIR.parent / "perturbed" / name
    copy.mkdir(parents=True, exist_ok=True)
    for src in [*build.CSRC.glob("*.cu"), *build.CSRC.glob("*.cuh")]:
        (copy / src.name).write_text(src.read_text())
    (copy / fname).write_text(text.replace(old, new))
    build.CSRC = copy  # every kernel builds from the copy; one of them differs
    build.build_all(["ring_codec"] if kernel == "ring_codec" else build.SOURCES)
    caught = []
    log(f"perturbation {name}: kernel checks")
    training = kernel in ("flash_bwd", "fused_adamw")
    if kernel == "ring_codec":
        from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

        checks = [lambda: check_codec(torch, rc, {}, timing=False)]
    elif kernel == "ring_flash":
        from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

        checks = [lambda: check_ring_flash(torch, rf, {}, timing=False)]
    elif training:
        checks = [lambda: check_flash_bwd(torch, fa, {}, timing=False),
                  lambda: check_adamw(torch, fadam, {}, timing=False)]
    else:
        checks = [lambda: check_flash(torch, fa, {}, timing=False),
                  lambda: check_decode(torch, da, {}, timing=False),
                  lambda: check_decode_int8(torch, da, {}, timing=False),
                  lambda: check_int8(torch, qm, {}, timing=False),
                  lambda: check_paged(torch, da, {})]
    for check in checks:
        try:
            check()
        except AssertionError as exc:
            caught.append(f"kernel: {exc}")
    if kernel in ("ring_codec", "ring_flash"):
        pass  # the kernel gates are what these faults must meet
    elif training:
        log(f"perturbation {name}: trainer step gates")
        try:
            check_train_step(torch, f"perturbation {name}")
        except AssertionError as exc:
            caught.append(f"trainer: {exc}")
    else:
        models, prompt = make_models(torch, pkg)
        outs = {mode: fn(prompt) for mode, fn in generate_fns(models).items()}
        log(f"perturbation {name}: logit checks")
        for mode, out in outs.items():
            try:
                check_logits(torch, mode, models[mode], prompt, out)
            except AssertionError as exc:
                caught.append(f"logits: {exc}")
        if kernel == "paged_attention":
            try:
                check_engine_step(torch, models["bf16"], *engine_traffic(torch))
            except AssertionError as exc:
                caught.append(f"engine logits: {exc}")
    log(f"perturbation {name}: caught by {len(caught)} check(s): {caught}")
    return 0 if any(c.startswith("kernel") for c in caught) else 1


def profile_decode(torch, model, prompt, steps: int = 4, label: str = "bf16 decode") -> None:
    """The profiler view of a few generate decode steps."""
    with torch.inference_mode():
        cache = model.init_cache(BATCH, cache_slots())
        logits = model(prompt, cache=cache, start=0, last_only=True)
        tok = logits[:, -1].argmax(-1)[:, None]
        model(tok, cache=cache, start=PROMPT)  # warm
        torch.cuda.synchronize()
        profile_steps(torch, label,
                      lambda i: model(tok, cache=cache, start=PROMPT + 1 + i), steps)


def profile_steps(torch, label: str, run, steps: int = 4) -> None:
    """Device busy share and top kernels over ``run(0..steps-1)``
    (torch.profiler); prints "not measured" if the tracer yields nothing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                run(i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = device_busy(torch, prof)
    except Exception as exc:  # the tracer is optional: report, keep serving results
        log(f"profiler: not measured ({type(exc).__name__}: {exc})")
        return
    if busy is None:
        log("profiler: not measured (no device events traced)")
        return
    n, busy_us, window, by_name = busy
    log(f"profiler, {label} x{steps}: {n} device events, busy "
        f"{busy_us / steps:.1f} us/step of a {window / steps:.1f} us/step device window, "
        f"host wall {wall_us / steps:.1f} us/step, device idle share "
        f"{1 - busy_us / max(window, 1e-9):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / steps:9.1f} us/step  {name[:90]}")


def device_busy(torch, prof):
    """(device events, busy us, device window us, us by kernel name) of a
    finished torch.profiler run, or None if it traced no device event."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return len(spans), busy, spans[-1][1] - spans[0][0], by_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true",
                    help="build and check the kernels, then stop")
    ap.add_argument("--perturb", choices=sorted(PERTURBATIONS),
                    help="show which checks catch a deliberately broken kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import distributed_machine_learning_tpu_torch as pkg
        from distributed_machine_learning_tpu_torch.ops import build
        from distributed_machine_learning_tpu_torch.ops import decode_attention as da
        from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
        from distributed_machine_learning_tpu_torch.ops import fused_adamw as fadam
        from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm
        from distributed_machine_learning_tpu_torch.ops import ring_codec as rc
        from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if args.perturb:
        return perturb(torch, pkg, args.perturb)

    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"kernel build (parallel nvcc): {time.perf_counter() - t0:.1f} s "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    for name in build.SOURCES:
        log_file = build.BUILD_DIR / f"{name}.log"
        if log_file.exists():
            # The Hopper mainloops' kernels (K1-K3, K6, K11-K13) also name
            # their entry and any ptxas warning (a serialized wgmma, an
            # ignored setmaxnreg).
            keys = ("registers", "spill") + (("Compiling entry", "warning", "Performance")
                                             if name in ("flash_fwd", "flash_bwd", "ring_flash",
                                                         "quant_matmul")
                                             else ())
            for line in log_file.read_text().splitlines():
                if any(k in line for k in keys):
                    log(f"  ptxas {name}: {line.strip()}")

    rows: dict = {}
    timing = not args.check_only
    log("kernel vs plain on the card:")
    check_flash(torch, fa, rows, timing)
    check_decode(torch, da, rows, timing)
    check_decode_int8(torch, da, rows, timing)
    check_int8(torch, qm, rows, timing)
    check_paged(torch, da, rows)
    check_fleet_shapes(torch, da, qm)
    check_flash_bwd(torch, fa, rows, timing)
    check_adamw(torch, fadam, rows, timing)
    check_codec(torch, rc, rows, timing)
    check_ring_flash(torch, rf, rows, timing)
    if args.check_only:
        log("check-only: kernels build and agree with their plain versions")
        return 0

    crossover(torch, da)
    models, prompt = make_models(torch, pkg)
    bf16_out = serve(torch, build, models, prompt, rows)
    t0 = time.perf_counter()
    serve_kv_int8(torch, build, models, prompt, rows, bf16_out)
    log(f"int8-KV phases: {time.perf_counter() - t0:.1f} s")
    del bf16_out
    t0 = time.perf_counter()
    serve_engine(torch, build, da, models["bf16"], rows)
    log(f"engine phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_fleet(torch, build, models["bf16"], rows, card)
    log(f"fleet phases: {time.perf_counter() - t0:.1f} s")
    del models, prompt
    gc.collect()
    torch.cuda.empty_cache()
    train(torch, build, rows)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_vgg(torch, rows)
    run_vgg_cli(torch)
    log(f"vgg phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_ring(torch, rows)
    run_ring_cli(torch)
    log(f"ring phases: {time.perf_counter() - t0:.1f} s")

    pallas = "distributed_machine_learning_tpu/ops/pallas/"
    replaces = {  # kernel name: (source, the TPU kernel body it replaces)
        "flash_fwd": ("flash_fwd", pallas + "flash_attention.py:295"),
        "flash_bwd_dq": ("flash_bwd", pallas + "flash_attention.py:408"),
        "flash_bwd_dkv": ("flash_bwd", pallas + "flash_attention.py:439"),
        "decode_attention": ("decode_attention", pallas + "decode_attention.py:99"),
        "decode_attention_int8": ("decode_attention", pallas + "decode_attention.py:99"),
        "quant_matmul": ("quant_matmul", pallas + "quant_matmul.py:60"),
        "paged_attention": ("paged_attention", pallas + "decode_attention.py:294"),
        "fused_adamw": ("fused_adamw", pallas + "fused_adamw.py:85"),
        "ring_encode_int8": ("ring_codec", pallas + "ring_codec.py:156"),
        "ring_decode_add_int8": ("ring_codec", pallas + "ring_codec.py:246"),
        "ring_decode_int8": ("ring_codec", pallas + "ring_codec.py:252"),
        "ring_flash_fwd": ("ring_flash", pallas + "ring_flash_attention.py:95"),
        "ring_flash_dq": ("ring_flash", pallas + "ring_flash_attention.py:208"),
        "ring_flash_dkv": ("ring_flash", pallas + "ring_flash_attention.py:238"),
    }
    kernels = []
    for key, row in rows.items():
        source, body = replaces[key.split(":")[0]]
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"distributed_machine_learning_tpu_torch/ops/csrc/{source}.cu",
            "replaces": body, "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "context_ms": row.get("context_ms"), "kv_int8_launches": row["kv_int8_launches"],
            "engine_launches": row["engine_launches"],
            "fleet_launches": row["fleet_launches"],
            "train_launches": row["train_launches"], "vgg_launches": row["vgg_launches"],
            "ring_launches": row["ring_launches"], "shape": row["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
