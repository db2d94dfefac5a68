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
   128-row tile), timed at a full step; at the EP cells' shapes (step
   10c) K1-K3 at B 4 and B 2 x L 2048, K11-K13 at B 2 x Lc 1024 and K7 on
   a rank's block of an expert leaf (4 x 2048 x 8192); K1-K3 and K11-K13 log
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
5c. The rest of serving (ROADMAP A8, ``serve_a8``), with a d512 / 2-layer
   / 16-head / 4-KV-head draft from seed 11 (head dim 32) and gamma 4:
   (a) speculative decoding at B 1 x 4096 + 128 new, the random draft and
   the target as its own draft, against vanilla greedy; K1 once a layer of
   each prefill, K4 once a draft layer a draft step (S 4608), never in the
   verify pass; rounds, accepted tokens a round, round ms and tokens/s
   beside vanilla B 1; (b) B 8 x 4096 + 64 on per-row frontiers (K4 never),
   each row against vanilla B 8; (c) sampled (temperature 0.8, top-k 50,
   top-p 0.95), 64 tokens in the vocabulary, and ``sampled_acceptance`` on
   the card against the CPU's in f64 (n_acc equal, residual 1e-6); (d) an
   int8 target against vanilla int8 greedy, K6's calls by route; (e) an int8
   KV cache at B 8 against vanilla int8-KV greedy; (f) the MoE model (d1024
   / 8 layers / 16 heads / 4 KV heads, 8 experts of d_ff 4096, bf16) at B 8
   x 1024 + 64: cached decode against the teacher-forced forward (0.1 on
   the logits at every position), int8 experts against the dequantized
   model (K6 on the attention projections and the head only), speculative
   against the MoE model, decode ms a step in bf16 and int8 at B 8 and 1;
   (h) ``python -m ...cli.generate --tp 2`` (ranks sharing the card) at
   MODEL's width and 2 of its 8 layers (a depth cut for the time limit) with a
   4096-byte prompt, bf16, then int8 with
   --spec-gamma 4: every rank exits 0 with one stream, K1 and K4 (and K6)
   launched on every rank, the stream against the single card's.  Greedy
   streams are judged by the tie rule (``tie_gate``): the emitted stream
   is fed back through the reference (vanilla greedy's loop; an MoE
   model's teacher-forced forward, ``routed_forward``), and every emitted
   token's reference logit must be within TIE_TOL (0.0625) of the top one.
   An MoE reference takes the path's expert where the two part at a router
   near-tie (top-2 probabilities within ROUTER_TOL, 0.02), and they may part
   at no more than FLIP_SHARE (5 %) of the decisions.
   Step 2 also holds K1, K4 and K6 at every shape these legs give them
   (``check_a8_shapes``).
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
6b. Checkpoints at full width, in a temporary directory under ``build/``
   (two checkpoints of 5.8 GB each; removed at the end, pass or fail).
   Save: ``cli.lm``'s run, 2 steps with ``--ckpt-dir`` (K1-K3 8 × 2, K7
   117 × 2), the bytes against 12 a parameter, then
   ``tools/ckpt_verify.py`` on the directory (exit 0).  Round trip: the
   checkpoint restored into a fresh model and state, every leaf bit for
   bit; two steps from one snapshot of the in-memory state on one batch
   (the baseline), then the restored state's step on it, bit for bit when
   the baseline is (else within its noise, the op named).  Resume:
   ``cli.lm --resume`` for 2 more steps (resumed from step 2, step 4
   saved, the trainer kernels launched again).  Generate: ``cli.generate
   --ckpt-dir --quant int8 --temperature 0`` with a 2048-byte prompt (K1
   and K6 launched), its greedy tokens equal to the in-memory step-4
   weights' through ``quantize_lm``.  Deploy: a ``DeployController``
   rolls step 4 onto 2 + 1 engine replicas (ENGINE's config, a model each)
   under engine_traffic, through ``load_serving_weights`` and
   ``swap_params``: promoted once, no rollback, exactly once, one version
   a completion, the new one after the promotion, first tokens against
   the plain path, K1, K5 and K6 launched; then ``python -m
   ...cli.deploy --replicas 4 --requests 300 --deploys 2``, and again with
   ``--inject regression@2`` (one rollback), both exit 0.  Save, restore,
   verify and load seconds and GB/s are logged with the card.  Leg (g) of
   step 5c (``ckpt_distill_leg``): ``cli.distill`` on the step-4
   checkpoint (a d512 / 2-layer draft, L 512, B 8, 40 iterations; exit 0,
   its loss falling), then ``cli.generate --draft-ckpt-dir --spec-gamma 4
   --quant int8 --temperature 0``, its stream against the plain command's
   and its acceptance beside the random draft's.

7. Trains the reference-parity VGG-11 parts through ``cli.common.run_part``,
   as their ``main`` runs it, each rank a process sharing the card (gloo
   over host buffers): part1 (world 1, batch 256), part2a, part2b and part3
   (world 2, batch 64 a rank) and part3 with ``--ring-compress int8
   --ring-codec-impl pallas`` (world 4), 20 iterations each (the
   reference's protocol runs 40; cut for the time limit), three runs'
   ranks at a time in that order (time limit: each run's times carry the
   others' load).  Launch counts
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
   4096 tokens a rank), the model's width at 1 of its 8 layers (depth cut
   to keep the whole run inside its time limit: 2 in PRs 18-19), bf16,
   ``--fused-update``,
   ``--attn flash`` (the upgrade rule picks ``ring_flash``), 3 steps.
   Launch counts zeroed just before and read just after on every rank:
   K11, K12 and K13 once per layer per chunk pair (2·(r+1) a step on rank
   r), K1-K3 never, K7 once
   per leaf.  Gates: every rank's parameters bit for bit equal; losses
   finite and falling; the step-0 loss against the one-process dp path on
   the same batch; one step kernel path vs plain path on every rank (the
   trainer's limits).  Reports step ms, tokens/s, hop and gradient-mean ms
   a step (CUDA events), peak memory per rank and the device idle share;
   then the real command: two processes of ``python -m
   ...cli.lm --parallel ring --num-nodes 2`` at 1 layer × L 8192.  The
   same for ``--parallel ulysses``, its ranks at once with the ring's (time
   limit: each path's times carry the other's load); then ``--parallel fsdp`` (flat ZeRO-3,
   W 2 × B 4 × L 2048 at 2 of the 8 layers (a depth cut for the time limit), sync
   and ``--overlap-update``), whose final state is
   saved under ``ShardSpec("fsdp", 2, n)`` and restored at worlds 1 and 4
   (logical prefixes bit for bit the saved ones) and served through
   ``load_serving_weights`` (greedy tokens equal to the gathered
   parameters quantized directly).
9. ``--parallel fsdp_pl`` (per-layer ZeRO-3) at the same shape with flash
   attention: ``cli.lm``'s run with ``--ckpt-dir`` for 2 steps, 2 more in
   the same process, then ``--resume`` for 2, bit for bit the
   uninterrupted run; K1-K3 once a layer a step and K7 once a leaf a step
   on every rank; ranks bit for bit; each rank's peak memory below flat
   fsdp's; against one-process dp; ``cli.generate --ckpt-dir`` on its
   checkpoint.
10. ZeRO-1 and FSDP's CNN step: VGG-11 (BN-free) at W 2 × B 64, AdamW
   with the fused update, 4 steps sync and 4 overlapped each (fsdp also
   with a rebound state after 2 steps): K7 once a step a rank, on rank 1's
   misaligned ZeRO-1 slice too; overlap and the prefetch miss bit for bit
   sync; moment bytes at ``zero1_memory_footprint``'s; against the
   one-process replicated step; the zero1 state saved, restored at worlds
   1 and 4, and a flipped byte caught and quarantined.
10b. ROADMAP A5c's model parallelism (``run_a5c``), through ``cli.lm``'s
   ``build`` and ``train_epoch`` in ranks sharing the card (gloo over host
   buffers), full width, bf16, fused AdamW, ``--attn flash``: (a) ``--parallel
   tp`` at W 2, B 2 x L 2048, 4 of the 8 layers, 3 steps; (b) ``--parallel
   pp`` at W 2, B 4 x L 2048 in 4 microbatches, 4 of the 8 layers: 1f1b, gpipe, gpipe
   ``--overlap-update`` and interleaved ``--pp-chunks 2``, 3 steps each
   (batches 0, 1, 0; 1f1b and interleaved saved at step 2 in their pipeline
   layouts, 1f1b resumed by ``cli.lm``'s run for 1 more); (c) ``--parallel
   3d`` at W 4, 4 layers, B 4 x L 2048 in 2 microbatches, 3 steps: dp 1 x pp
   2 x tp 2, dp 2 x pp 2 x tp 1 with ``--zero1-dp`` and without; (d)
   ``python -m ...cli.generate --ckpt-dir`` on both pipeline checkpoints and
   on their parameters saved again in the dp layout, B 1 x 4096 + 32.
   Launch counts zeroed before and read after each run on every rank: K1,
   K2 and K3 once a local layer a microbatch a step, K7 once a local leaf a
   step (gpipe ``--overlap-update``: the boundary's five leaves as one flat
   slice). Gates: the step-0 loss and every local leaf after the run
   against one-process dp on the same weights and batches (the fsdp_pl
   gates' loss limit; the leaves' scaled by a plain-vs-plain dp reading);
   the leaves TP keeps whole bit for bit across
   a TP group; tp's step kernel vs plain on every rank; ``--overlap-update``
   bit for bit sync gpipe; the resumed run bit for bit the uninterrupted
   one; ``--zero1-dp`` within 1e-6 of plain 3-D; every ``cli.generate``
   exits 0, each pipeline checkpoint's tokens equal to its dp-layout
   twin's. Reports step ms, tokens/s, MFU a rank, peak GB a rank, the wire's
   ms a step (TP sums, hops, the pipe and data groups' sums) and pp's idle
   share a stage beside (P-1)/(v*M+P-1). The three cells' ranks run at
   once (time limit), so each cell's times carry the others' load.
10c. ROADMAP A5c's expert parallelism (``run_ep``, after A5c's cells),
   through ``cli.lm``'s ``build`` and
   ``train_epoch``: ``--parallel ep`` at the model's width with E 8
   experts of d_ff 8192, capacity factor 1.25, 2 of the 8 layers, B 4 x L
   2048, bf16, fused AdamW, ``--attn flash``, 3 steps over batches 0, 1, 0:
   (a) ``--moe-impl einsum`` at W 2 (ep 2); (b) ``--moe-impl grouped`` at
   W 2, saved at step 2 in the plain layout, resumed by cli.lm's resume for
   1 more step, and served by ``python -m ...cli.generate --moe
   --ckpt-dir`` (B 1 x 4096 + 32); (c) grouped with ``--ep-slots`` 1024 of
   4096 (rows drop) and with ample slots; (d) grouped ``--ep-seq 2`` at W 4
   (dp 1 x ep 2 x seq 2; chunk 1024: ring_flash).  Launch counts zeroed
   before and read after each run on every rank: K1-K3 once a layer a step
   (not under --ep-seq), K11-K13 layers x (seq rank + 1) a step under
   --ep-seq, K7 once a local leaf a step.  Gates: losses finite and equal
   on every rank; the step-0 loss (not (c)'s bounded run) within the
   trainer's limit of the one-process MoE run of its impl on the same
   weights and batch, each local leaf's step-0 gradient (after the EP
   sync, before Adam) within max(0.1, 2.5 x that leaf's plain-vs-plain
   reading, ``EP_GRAD_NOISE``) of that run's, and every local leaf after
   the run within the A5c rule scaled by the MoE model's plain-vs-plain
   reading (``EP_UPDATE_NOISE``); the leaves outside the experts bit for
   bit across the ranks, the expert leaves across the ranks that hold the
   same experts; rows dropped in (c)'s bounded run and in no other; the
   resumed run and ample slots bit for bit (b); ``cli.generate`` exits 0.
   Reports the step-0 routing agreement with the one-process run, step ms,
   tokens/s, peak GB a rank and the wire's ms a step.
11. The A4 paths (``run_a4``), through the part CLIs' ``run_part`` and
   ``cli.lm``: (a) ResNet-18 part1 at B 256 (CIFAR stem, f32, 40
   iterations; its first step's loss and gradients against the same step
   of a CPU copy), then in bf16, then with ``--optimizer adamw
   --fused-update`` (K7 once a leaf a step; one step's update of all 62
   leaves, 10 to 2,359,296 elements, against the plain version within 8
   ulp); (b) ResNet-50 part1 at B 256
   (step ms, peak memory); (c) at W 2 on one card, ResNet-18 ``part3
   --ring-compress int8 --ring-codec-impl pallas --ckpt-dir --keep-last-n
   2`` (K8-K10 at ``codec_launches_per_step``), its ``--resume`` (params,
   BN statistics, momentum and step restored bit for bit, the residual's
   NOTE printed), a resumed ``part2b``'s next step bit for bit the
   uninterrupted one's, an ``--async-ckpt`` save, and ``--resume auto``
   whose second epoch raises once (one restart, from the newest checkpoint);
   (d) ``part2b`` VGG-11 ``--optimizer lars --lr-schedule cosine
   --warmup-steps 4 --grad-accum 2 --dist-eval --loader native`` at W 2 ×
   B 256: a LARS update on the card against the CPU update of the same
   gradients, ``--grad-accum 2`` against one B 256 step, the native
   loader's batches against the Python loader's, the sharded eval against
   the one-rank eval; (e) ``cli.parity --max-iters 4`` and
   ``--equivalence`` (exit 0, every row synthetic; run beside legs (c), (d)
   and step 12's card tests, so none of their timings is the parts' own);
   (f) ``cli.lm`` dp
   B 4 × L 4096 flash under ``--optimizer sgd --momentum-dtype bfloat16``
   and ``lars`` beside AdamW (K1-K3 launched, the same step-0 loss).
12. The card test of the latest slice (``tests/test_torch_kernels_cuda.py
   -k expert_parallel_paths_on_the_card``, ``--noconftest``; the other
   slices' card tests are left to the README's command: the time limit).

Step 2 also holds the int8 ring codec K8 (with and without residual), K9
and K10 to their plain versions BIT FOR BIT at the VGG path's chunk
lengths, ResNet-18's at world 2 (the a4 phase's part3 int8), a single
element, a ragged length, a length past what K8 can stage on chip, an
all-zero and a NaN chunk, and chunks whose largest |v| or NaN sits in
K8's last block; K8 also in CUDA graphs replayed twice and out of order;
the batched K10 at the all-gather's (world, chunk) points (ResNet-18's
too), rows in the ring's order, in one launch.  A profiler trace of one K8 call
must show one kernel and no memset, and one of an int8 ring call one K10
kernel for its all-gather and no copy after it.  All three are timed at the
VGG path's four chunk lengths, K8 with and without the residual, and the
all-gather's decode per ring call beside its bound and one ``torch.mul``.

The line before the last is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  Exits nonzero, printing
no result, without a CUDA device or outside the repository.
``--check-only`` stops after step 2 (a short first run of new kernels).
``--only a8,ckpt,tests`` runs step 2's checks untimed, then only the named
phases (``PHASES``) with their gates, and prints no result: a short loop
for the work on those paths.
``--perturb NAME`` builds one kernel from a deliberately broken copy of
its source (under ``build/perturbed/``; the checkout is not touched), runs
the kernel checks and the logit checks (for a training kernel: the trainer
step gates; for K1, K2, K3 and K7 also the a5c tp cell's gates) against
it, and reports which of them catch the fault: it exits 0 only if the
kernel checks catch it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# result (455 measured between XLA's chain and the port's on the CPU); p's
# terms include the Adam step at m's terms' scale (adamw_ulp_errs).
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
def plain_kernels(block: int | None = None):
    """Route the model's, the trainers', the ring codec's and the ring
    attention's kernel entry points to their plain PyTorch versions, on the
    card too: the reference the kernel path is held to.  Attention without
    a gradient (serving) takes the plain forward directly; with one
    (training) it takes the port's autograd Function with its forward and
    backward launchers swapped for the plain versions, so the backward
    never runs through the forward's loop.  ``block``: the tile of the
    training attention's plain versions (the ring chunk steps and the flash
    forward and backward; default: the reference's)."""
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
            outs = plain(*args, block=block)
            for t, new in zip(args[-1 - n_out:-1], outs if n_out > 1 else (outs,)):
                t.copy_(new)
        return run

    def plain_flash(q, k, v):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return flash(q, k, v)
        return fa.flash_attention_reference(q, k, v)

    swaps = [(transformer, "flash_self_attention", plain_flash),
             (fa, "_launch", lambda q, k, v: fa.flash_attention_reference(
                 q, k, v, block=block, return_lse=True)),
             (fa, "_launch_bwd", lambda *args: fa.flash_attention_backward_reference(
                 *args, block=block)),
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


def adamw_ulp_errs(got, want, old, cfg, step: int = 10) -> list:
    """ulp errors of (p, mu, nu) after one update at ``step`` from ``old``
    (p, mu, nu, g), each at the scale of the terms the update sums.  p sums
    p and lr·m̂/(√n̂ + eps), and m̂ carries the rounding of m's terms (the
    one place FMA contraction may round differently), so that term is
    taken at the scale of m's terms: lr·(|b1·mu| + |(1−b1)·g|)/bc1/(√n̂ +
    eps).  Where n̂ is near 0 it magnifies m's one rounding: over 250M
    elements drawn as below, contraction alone reads 41 ulp of p at p's
    own scale and 4 at this one (a CPU model of the two roundings)."""
    import torch

    lr, bc1, bc2 = adamw_scalars(step, cfg)
    p, mu, nu, g = (t.float() for t in old)
    b1_mu, g_mu = (cfg.beta1 * mu).abs(), ((1 - cfg.beta1) * g).abs()
    adam = lr * (b1_mu + g_mu) / bc1 / (torch.sqrt(want[2].float() / bc2) + cfg.eps)
    terms = ([p, adam], [b1_mu, g_mu], [cfg.beta2 * nu, (1 - cfg.beta2) * g * g])
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


# The Ulysses path's local attention (step 8): K1 forward and K2/K3 backward
# over the FULL sequence on H/W query heads and Hkv/W KV heads (the GQA
# narrow path: 1 KV head a rank at W 4).
ULYSSES_SHAPE = (1, 16384, 4, 1, 128)


def check_ulysses_shapes(torch, fa, rows: dict, timing: bool) -> None:
    """K1, K2 and K3 at the Ulysses shape against their plain versions (the
    row gates; the gradients with GRAD_ROW_FLOOR), and K1's lse; timed
    beside their bounds, the plain versions and SDPA (forward, and its
    fastest pinned backward)."""
    B, L, H, Hkv, D = ULYSSES_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(16)
    label = f"B={B} L={L} H={H} Hkv={Hkv} D={D} bf16 (Ulysses, W {RING['world']})"
    failed: list = []
    q, k, v, do, lse_p, delta = bwd_inputs(torch, fa, B, L, H, Hkv, D, "bfloat16", gen)
    out, lse = fa._launch(q, k, v)
    want = fa.flash_attention_reference(q, k, v)
    rows["flash_fwd:ulysses"] = {"max_abs_err": compare(f"flash_fwd {label}", out, want,
                                                        failed)}
    lse_err = float((lse - lse_p).abs().max())
    log(f"  flash_fwd lse ({label}): max_abs_err={lse_err:.3e} (tol {LSE_TOL:g})")
    if not lse_err <= LSE_TOL:
        failed.append("flash_fwd lse at the Ulysses shape")
    args = (q, k, v, do, lse_p, delta)
    dq = fa._launch_dq(*args)
    dk, dv = fa._launch_dkv(*args)
    torch.cuda.synchronize()
    ref = fa.flash_attention_backward_reference(*args)
    rows["flash_bwd_dq:ulysses"] = {"max_abs_err": compare(
        f"flash_bwd_dq {label}", dq, ref[0], failed, GRAD_ROW_FLOOR)}
    rows["flash_bwd_dkv:ulysses"] = {"max_abs_err": max(
        compare(f"flash_bwd_dkv {name} {label}", got, r, failed, GRAD_ROW_FLOOR)
        for name, got, r in (("dk", dk, ref[1]), ("dv", dv, ref[2])))}
    raise_failed(failed)
    if not timing:
        return
    pairs = B * H * L * (L + 1) / 2.0
    qo, kv, row_bytes = 2 * B * L * H * D, 2 * B * L * Hkv * D, 2 * 4 * B * H * L
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                  (q, k.repeat_interleave(H // Hkv, 2), v.repeat_interleave(H // Hkv, 2)))
    shape = f"{label}, one call per layer per step"
    rows["flash_fwd:ulysses"].update(
        ms=time_ms(lambda: fa._launch(q, k, v)),
        plain_ms=time_ms(lambda: fa.flash_attention_reference(q, k, v), iters=2, warmup=1),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
        **bound(4.0 * D * pairs, BF16_FLOPS, 2 * qo + 2 * kv + row_bytes // 2),
        shape=shape + "; library: SDPA causal")
    log_rate("flash_fwd (Ulysses shape)", rows["flash_fwd:ulysses"], 4.0 * D * pairs,
             "SDPA causal")
    plain_ms = time_ms(lambda: fa.flash_attention_backward_reference(*args), iters=2,
                       warmup=1)
    library_ms, backend = sdpa_backward_ms(torch, q, k, v, do, True, "Ulysses shape")
    shape += ("; plain and library ms are of the whole backward (dq, dk, dv); library: "
              f"SDPA backward, causal, {backend}")
    rows["flash_bwd_dq:ulysses"].update(
        ms=time_ms(lambda: fa._launch_dq(*args)), plain_ms=plain_ms, library_ms=library_ms,
        **bound(6.0 * D * pairs, BF16_FLOPS, 3 * qo + 2 * kv + row_bytes), shape=shape)
    rows["flash_bwd_dkv:ulysses"].update(
        ms=time_ms(lambda: fa._launch_dkv(*args)), plain_ms=plain_ms, library_ms=library_ms,
        **bound(8.0 * D * pairs, BF16_FLOPS, 2 * qo + 4 * kv + row_bytes), shape=shape)
    for name, flops in (("flash_bwd_dq", 6.0 * D * pairs), ("flash_bwd_dkv", 8.0 * D * pairs)):
        r = rows[f"{name}:ulysses"]
        log(f"  {name} (Ulysses shape): {r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.1f} "
            f"TFLOP/s, {r['bound_ms'] / r['ms']:.1%} of its {r['bound_ms']:.4f} ms bound), "
            f"plain backward {plain_ms:.2f}, SDPA backward {library_ms:.4f} ({backend})")
    pair = rows["flash_bwd_dq:ulysses"]["ms"] + rows["flash_bwd_dkv:ulysses"]["ms"]
    log(f"  K2 + K3 (Ulysses shape): {pair:.4f} ms, {pair / library_ms:.2f}x SDPA's backward")


def fsdp_shard_len(world: int) -> int:
    """Elements of one rank's flat shard of the model under fsdp at ``world``."""
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.runtime.mesh import padded_len

    n = sum(p.numel() for p in TransformerLM(**FSDP_MODEL, device="meta").parameters())
    return padded_len(n, world) // world


def flat_cnn_shard_len(world: int) -> int:
    """Elements of one rank's flat shard of FLAT_CNN's model at ``world``
    (ZeRO-1's momentum shard, FSDP's parameter shard)."""
    from distributed_machine_learning_tpu_torch.models.registry import get_model
    from distributed_machine_learning_tpu_torch.runtime.mesh import padded_len

    n = sum(p.numel() for p in get_model(FLAT_CNN["model"], device="meta").parameters())
    return padded_len(n, world) // world


def check_flat_adamw(torch, fadam, rows: dict, timing: bool, key: str = "fused_adamw:fsdp",
                     n: int | None = None, what: str = "") -> None:
    """K7 on one flat f32 shard (default the fsdp LM path's at FSDP["world"]
    ranks; ``n``/``what`` another path's): the 8-ulp gate against its plain
    version, then timed beside its bound (16 bytes an element read, 12
    written), the plain version and torch.optim.AdamW(fused=True) on the
    same tensor."""
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig

    cfg = AdamWConfig()
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    if n is None:
        n = fsdp_shard_len(FSDP["world"])
        what = f"fsdp, W {FSDP['world']}"
    gen = torch.Generator(device="cuda").manual_seed(8)
    state = [0.02 * torch.randn(n, device="cuda", generator=gen),
             1e-3 * torch.randn(n, device="cuda", generator=gen),
             1e-6 * torch.rand(n, device="cuda", generator=gen),
             1e-3 * torch.randn(n, device="cuda", generator=gen)]
    got = [t.clone() for t in state[:3]]
    fadam.fused_adamw_leaf(*got, state[3], *adamw_scalars(10, cfg), **hyper)
    want = [t.clone() for t in state[:3]]
    fadam.fused_adamw_reference(*want, state[3], *adamw_scalars(10, cfg), **hyper)
    torch.cuda.synchronize()
    errs = adamw_ulp_errs(got, want, state, cfg)
    ok = max(errs) <= ADAMW_ULP_TOL and all(bool(torch.isfinite(t).all()) for t in got)
    log(f"  fused_adamw on a flat shard (n={n} f32, {what}): ulp error "
        f"p/mu/nu {errs[0]:.0f}/{errs[1]:.0f}/{errs[2]:.0f} (tol {ADAMW_ULP_TOL}) -> "
        f"{'ok' if ok else 'BAD'}")
    rows[key] = {"max_abs_err": max(
        float((g - w).abs().max()) for g, w in zip(got, want)), "max_ulp_err": max(errs)}
    del got, want
    if not ok:
        raise AssertionError(f"fused_adamw on the flat shard ({what})")
    if not timing:
        return
    lr, bc1, bc2 = adamw_scalars(10, cfg)
    ms = time_ms(lambda: fadam.fused_adamw_leaf(*state, lr, bc1, bc2, **hyper), iters=10)
    plain_ms = time_ms(lambda: fadam.fused_adamw_reference(*state, lr, bc1, bc2, **hyper),
                       iters=2, warmup=1)
    p = state[0].clone().requires_grad_()
    p.grad = state[3]
    opt = torch.optim.AdamW([p], lr=lr, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
                            weight_decay=cfg.weight_decay, fused=True)
    library_ms = eager_ms(torch, opt.step, iters=5)
    rows[key].update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound(15.0 * n, F32_FLOPS, 28 * n),
        shape=f"one flat f32 shard of {n} elements ({what}), one launch a "
              "step; library: torch.optim.AdamW(fused=True).step() on the same tensor")
    r = rows[key]
    log(f"  fused_adamw flat shard ({what}): {ms:.4f} ms ({28 * n / ms / 1e9:.2f} TB/s, "
        f"{r['bound_ms'] / ms:.1%} of its {r['bound_ms']:.3f} ms bound), plain "
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
# The a4 phase's part3 int8 run: ResNet-18 (CIFAR stem) at world 2, whose
# chunks (``resnet18_chunks``) are checked here too, untimed.
RESNET18_PARAMS = 11_173_962
CODEC_SETS = 8  # fewest buffer sets the codec timings rotate over (past the L2)
CODEC_ROTATE_BYTES = 200e6  # operand bytes the sets span at least (4x the L2)


def resnet18_chunks(world: int = 2) -> list:
    """The ring's chunk lengths for ResNet-18's gradient at ``world``: each
    25 MiB bucket (6,553,600 + 4,620,362 elements) in ``world`` chunks of
    ceil(L / world) (``ops/ring.py``)."""
    from distributed_machine_learning_tpu_torch.ops.ring import (
        DEFAULT_BUCKET_BYTES,
        _bucket_bounds,
    )

    return sorted({-(-(b - a) // world)
                   for a, b in _bucket_bounds(RESNET18_PARAMS, DEFAULT_BUCKET_BYTES, 4)})


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
    lengths = [*CODEC_LENGTHS, *(n for n in resnet18_chunks() if n not in CODEC_LENGTHS)]
    cases = [(f"n={n}", 0.01 * torch.randn(n, device="cuda", generator=gen))
             for n in lengths]
    cases.append(("zero n=4097", torch.zeros(4097, device="cuda")))
    nan = torch.randn(4097, device="cuda", generator=gen)
    nan[1234] = float("nan")
    cases.append(("one NaN n=4097", nan))
    for n, what in ((669_379, "max"), (669_379, "NaN"), (CODEC_OVER_CAPACITY, "max")):
        last = 0.01 * torch.randn(n, device="cuda", generator=gen)
        last[-1] = float("nan") if what == "NaN" else 1.0
        cases.append((f"{what} last n={n}", last))
    failed = []
    for n in lengths:
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
    points = [*CODEC_ALLGATHER, *((2, n) for n in resnet18_chunks()
                                  if (2, n) not in CODEC_ALLGATHER)]
    for world, n in points:
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


def check_a8_shapes(torch, fa, da, qm) -> None:
    """K1, K4 and K6 against their plain versions at the shapes the A8 legs
    give them, with the row gates: the draft (D 32: prefill B 1 and B 8 x
    4096, decode B 1 at S 4608 past the prompt), the MoE model (D 64:
    prefill B 8 x 1024; its attention projections and head at decode R 8
    and prefill R 8 x 1024), the speculative verify pass (R = gamma + 1 at
    every projection of the target), and a --tp 2 rank (H 8 / Hkv 2, D 128:
    prefill B 1 x 4096, decode at S 4608; its local projections at R 1, 5
    and 4096)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    failed = []
    H, Hkv = MODEL["n_heads"], MODEL["n_kv_heads"]
    D32, D64, D128 = (A8_DRAFT["d_model"] // A8_DRAFT["n_heads"],
                      A8_MOE["d_model"] // A8_MOE["n_heads"], MODEL["d_model"] // H)
    for label, B, L, h, hkv, D in (("draft", 1, PROMPT, H, Hkv, D32),
                                   ("draft", BATCH, PROMPT, H, Hkv, D32),
                                   ("MoE", A8_MOE_BATCH, A8_MOE_PROMPT, H, Hkv, D64),
                                   ("tp rank", 1, PROMPT, H // A8_TP, Hkv // A8_TP, D128)):
        q = torch.randn(B, L, h, D, device="cuda", generator=gen).bfloat16()
        k = torch.randn(B, L, hkv, D, device="cuda", generator=gen).bfloat16()
        v = torch.randn(B, L, hkv, D, device="cuda", generator=gen).bfloat16()
        got = fa.flash_self_attention(q, k, v)
        torch.cuda.synchronize()
        compare(f"flash_fwd {label} B={B} L={L} H={h} Hkv={hkv} D={D}", got,
                fa.flash_attention_reference(q, k, v), failed)
        del q, k, v, got
    S = 4608
    for label, h, hkv, D, positions in (
            ("draft", H, Hkv, D32, (PROMPT, PROMPT + 63, PROMPT + 134)),
            ("tp rank", H // A8_TP, Hkv // A8_TP, D128, (PROMPT, PROMPT + A8_TP_NEW - 2))):
        q = torch.randn(1, 1, h, D, device="cuda", generator=gen).bfloat16()
        kc = torch.randn(1, hkv, S, D, device="cuda", generator=gen).bfloat16()
        vc = torch.randn(1, hkv, S, D, device="cuda", generator=gen).bfloat16()
        for pos in positions:
            got = da.cached_flash_attention(q, kc, vc, pos)
            torch.cuda.synchronize()
            compare(f"decode_attention {label} B=1 S={S} H={h} Hkv={hkv} D={D} pos={pos}",
                    got, da.cached_attention_reference(q, kc, vc, pos), failed)
    E, V, F = MODEL["d_model"], MODEL["vocab_size"], 4 * MODEL["d_model"]
    kv = 2 * Hkv * D128
    Em = A8_MOE["d_model"]
    cases = [("verify", A8_GAMMA + 1, D, K) for D, K in ((E, E), (E, kv), (E, F), (F, E), (E, V))]
    cases += [("MoE", R, D, K) for R in (A8_MOE_BATCH, A8_MOE_BATCH * A8_MOE_PROMPT)
              for D, K in ((Em, Em), (Em, 2 * Hkv * D64), (Em, V))]
    cases += [("tp rank", R, D, K) for R in (1, A8_GAMMA + 1, PROMPT)
              for D, K in ((E, E // A8_TP), (E, kv // A8_TP), (E // A8_TP, E),
                           (E, F // A8_TP), (F // A8_TP, E), (E, V))]
    for label, R, D, K in cases:
        x = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        w, s = qm.quantize_int8(torch.randn(D, K, device="cuda", generator=gen) / math.sqrt(D))
        got = qm.int8_matmul(x, w, s)
        torch.cuda.synchronize()
        compare(f"quant_matmul {label} R={R} D={D} K={K} ({qm.int8_route(R, D, K)} route)",
                got, qm.int8_matmul_reference(x, w, s), failed)
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
    from the first submit to idle, each rank's beat times, the router's
    eviction records and, with ``profile``, the run's device busy share
    (torch.profiler, CUDA only).  The tracer is stopped only once the router
    is closed and every worker has joined: its stop turns the run's device
    events into host records and holds every thread a while, as its start
    does, and a router that outlived it read that hold as dead replicas."""
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
        result["idle_wall"] = time.time()
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
        try:
            result["verdict"] = router.close()
            result["evicted"] = [e for e in hub_health(hub) if e["kind"] == "serve_evict"]
            stop_router.set()
            for stop in stops:
                stop.set()
            for t, _ in workers:
                t.join(timeout=30)
            rt.join(timeout=10)
        finally:
            if prof is not None:
                t_stop = time.perf_counter()
                prof.__exit__(None, None, None)
                result["tracer_stop_s"] = time.perf_counter() - t_stop
    if prof is not None:
        result["busy"] = device_busy(torch, prof)
    result["beats"], result["victim"] = beats, victim
    return result


def hub_health(hub) -> list:
    """The health records (promote, evict, demote) an in-process hub holds."""
    from distributed_machine_learning_tpu_torch.runtime import transport as tr

    return tr.InProcTransport(hub).read_health_events()


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
    if "tracer_stop_s" in a:
        log(f"fleet run (a): the tracer's stop took {a['tracer_stop_s']:.3f} s, after the "
            f"router closed [{card}]")
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
        why = [(e.get("rank"), e.get("why"), round(e["time"] - a["idle_wall"], 3))
               for e in a["evicted"]]
        raise AssertionError(f"fleet run (a): a healthy replica was evicted: {v['evictions']} "
                             f"evictions, {v['promotions']} promotions; (rank, why, s after "
                             f"the last request finished) {why}")
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


# The rest of serving (ROADMAP A8, step 5c): speculative decoding, MoE
# serving, cli.distill and --tp decode.  The speculative legs' draft: d512 /
# 2 layers / 16 heads / 4 KV heads (head dim 32, which K1 and K4 take), its
# weights from seed 11 as the CLI's random-init draft; gamma 4.
A8_DRAFT = dict(vocab_size=32000, d_model=512, n_layers=2, n_heads=16, n_kv_heads=4)
A8_DRAFT_SEED, A8_GAMMA = 11, 4
A8_NEW = dict(a=128, b=64, c=64, d=64, e=32)  # new tokens of legs (a)-(e)
A8_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
# JAX's measured MoE serving shape (bf16), B 8 x 1024 + 64 new; the cached
# decode is held against the teacher-forced forward over its first steps.
A8_MOE = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=4,
              n_experts=8, d_ff=4096)
A8_MOE_BATCH, A8_MOE_PROMPT, A8_MOE_NEW, A8_MOE_TF_STEPS = 8, 1024, 64, 8
# cli.generate --tp: ranks, a 4096-byte prompt (4096 tokens at vocab 32000),
# new tokens.
A8_TP, A8_TP_PROMPT, A8_TP_NEW = 2, "The " * 1024, 32
# Leg (h) serves MODEL's width at 2 of its 8 layers (a depth cut
# for the time limit: the a5c and ep cells), its own random weights from SEED.
A8_TP_LAYERS = 2
# cli.distill on the checkpoint phase's step-4 checkpoint.
A8_DISTILL = ["--draft-d-model", "512", "--draft-n-layers", "2", "--draft-n-heads", "16",
              "--draft-n-kv-heads", "4", "--seq-len", "512", "--batch-size", "8",
              "--max-iters", "40"]
A8_COLUMNS = ("spec", "moe", "distill", "tp")


# The tie rule on the card (JAX's bf16 caveat: two computations of one
# greedy stream may part where the top logits nearly tie), with fixed
# limits.  The stream a path emitted is fed back through the reference
# (``tie_gate``): vanilla greedy's loop teacher-forced on it, or for an MoE
# model its teacher-forced forward (``routed_forward``).  At every position
# the emitted token's reference logit must be at most TIE_TOL below the
# reference's top logit.  Two computations' logits read 0.031-0.039 apart
# (the verify pass vs one-token steps, two ranks' f32 sum vs one card; H100
# 80GB HBM3, 700 W), so their argmaxes may sit up to twice that apart;
# TIE_TOL is two bf16 ulps of a logit in [4, 8), where these random models'
# top logits sit.  A wrong path is off by O(1) (a dropped key tile reads
# 1.56-1.66).
TIE_TOL = 0.0625
# Routing: the path may choose another expert than the reference only
# where the reference's top-2 router probabilities are within ROUTER_TOL
# (two computations' router probabilities read 3.7e-3 to 9.5e-3 apart), and
# at no more than FLIP_SHARE of the decisions (readings: 4 of 66,048 for
# the cached decode against the teacher-forced forward; 968 of about 66,000
# for int8 experts against the dequantized model, knock-on flips included).
ROUTER_TOL = 0.02
FLIP_SHARE = 0.05


def decode_trace(torch, model, prompt, new: int, toks=None):
    """Vanilla greedy generate's loop (prefill, then one decode step a
    token, on the cache generate allocates), fed ``toks`` [B, new] when
    given (teacher forcing) or else its own argmax: (tokens [B, new], the
    f32 logits that predict them [B, new, V])."""
    B, Lp = prompt.shape
    with torch.inference_mode():
        cache = model.init_cache(B, -(-(Lp + new) // 512) * 512)
        logits = [model(prompt, cache=cache, start=0, last_only=True)[:, -1].float()]
        picks = [logits[-1].argmax(-1) if toks is None else toks[:, 0]]
        for i in range(new - 1):
            logits.append(model(picks[-1][:, None], cache=cache, start=Lp + i)[:, -1].float())
            picks.append(logits[-1].argmax(-1) if toks is None else toks[:, i + 1])
    return torch.stack(picks, 1), torch.stack(logits, 1)


class RouteTape:
    """The experts an MoE model's calls chose, by absolute position: a
    forward pre-hook reads each call's ``start`` (an int or a [B] tensor)
    and every layer's ``route`` records its choice.  A later call at a
    position overwrites an earlier one (a verify pass redoes the positions
    a rejected draft held), so ``experts(P)`` [layers, B, P] holds the
    choices behind each position's cache rows."""

    def __init__(self, torch, model):
        self.torch, self.calls, self.mods = torch, [], [b.moe for b in model.blocks]

        def pre(mod, args, kwargs):
            self.calls.append((args[0].shape, kwargs.get("start", 0), []))

        def recording(route):
            def recorded(tokens):
                out = route(tokens)
                self.calls[-1][2].append(out[1])
                return out
            return recorded

        self.handle = model.register_forward_pre_hook(pre, with_kwargs=True)
        for mod in self.mods:
            mod.route = recording(mod.route)

    def close(self):
        self.handle.remove()
        for mod in self.mods:
            del mod.route  # the class's method again

    def experts(self, P: int):
        torch = self.torch
        B, dev = self.calls[0][0][0], self.calls[0][2][0].device
        out = torch.full((len(self.mods), B, P), -1, dtype=torch.long, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        for (_, T), start, picks in self.calls:
            pos = (torch.as_tensor(start, device=dev).reshape(-1, 1)
                   + torch.arange(T, device=dev)).expand(B, T)
            keep = pos < P
            for li, idx in enumerate(picks):
                out[li, rows.expand(B, T)[keep], pos[keep]] = idx.reshape(B, T)[keep]
        if bool((out < 0).any()):
            raise AssertionError(f"the path left positions of the first {P} unrouted")
        return out


def routed_forward(torch, label: str, model, seq, chosen):
    """``model``'s teacher-forced forward over ``seq`` [B, P] (flash
    attention, dropless experts), its router taking the path's expert
    ``chosen`` [layers, B, P] wherever the two part at a router near-tie
    (the reference's top-2 probabilities within ROUTER_TOL), so that both
    compute each position from the same experts.  Raises where they part
    otherwise, or at more than FLIP_SHARE of the decisions.  Returns
    (logits [B, P, V] in the compute dtype, the routing's log line)."""
    ref = model.clone(attn_impl="flash")
    ref.load_state_dict(model.state_dict())
    ref.eval()
    flips, bad, widest = [], [], []

    def forcing(mod, want):
        def forced(tokens):
            _, idx, probs = type(mod).route(mod, tokens)
            top2 = probs.topk(2, dim=-1).values
            flip = want != idx
            near = flip & (top2[:, 0] - top2[:, 1] < ROUTER_TOL)
            flips.append(flip.sum())
            bad.append((flip & ~near).sum())
            widest.append(torch.where(near, top2[:, 0] - top2[:, 1], 0.0).max())
            idx = torch.where(near, want, idx)
            return probs.gather(1, idx[:, None])[:, 0], idx, probs
        return forced

    for li, block in enumerate(ref.blocks):
        block.moe.route = forcing(block.moe, chosen[li].reshape(-1))
    with torch.inference_mode():
        logits = ref(seq)
    n_flip, n_bad = int(sum(flips)), int(sum(bad))
    share = n_flip / chosen.numel()
    line = (f"; routing parts from the reference's at {n_flip} of {chosen.numel()} "
            f"decisions ({share:.2e}, limit {FLIP_SHARE}), {n_bad} of them beyond a "
            f"router near-tie (widest near-tie {float(max(widest)):.2e}, limit {ROUTER_TOL})")
    del ref
    if n_bad or share > FLIP_SHARE:
        raise AssertionError(f"{label}: the path's routing leaves the reference's{line}")
    return logits, line


def tie_gate(torch, label: str, model, prompt, got, routes=None) -> None:
    """The tie rule on a greedy stream ``got`` [B, n] that a path emitted
    after ``prompt``: fed back through the reference (vanilla greedy's loop
    of ``model``; an MoE ``model``'s ``routed_forward`` on the path's
    RouteTape ``routes``), every emitted token's reference logit within
    TIE_TOL of the reference's top logit.  Logs where the stream leaves the
    reference's argmax and by how much; raises beyond TIE_TOL."""
    B, L = prompt.shape
    n = got.shape[1]
    if routes is None:
        _, logits = decode_trace(torch, model, prompt, n, got)
        line = ""
    else:
        seq = torch.cat([prompt, got[:, :-1]], 1)
        full, line = routed_forward(torch, label, model, seq, routes.experts(L + n - 1))
        logits = full[:, L - 1:].float()
        del full
    top, best = logits.max(-1)
    gap = top - logits.gather(-1, got[..., None])[..., 0]
    off = (got != best).nonzero().tolist()
    notes = [f"row {b} at {j}: gap {float(gap[b, j]):.4f}" for b, j in off[:12]]
    worst = float(gap.max())
    log(f"{label}: {B * n - len(off)} of {B * n} tokens the reference's argmax, the others "
        f"{notes or 'none'}{' ...' if len(off) > 12 else ''}; largest gap {worst:.4f} (tol "
        f"{TIE_TOL}){line}")
    if worst > TIE_TOL or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: a token {worst:.4f} below the reference's top logit, "
                             f"beyond the tie rule's {TIE_TOL}")

def a8_draft(torch, device, kv_cache_dtype=None):
    """The legs' random draft in bf16 (the CLI's: seed 11)."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM

    draft = TransformerLM(**A8_DRAFT, compute_dtype=torch.bfloat16,
                          kv_cache_dtype=kv_cache_dtype, device=device)
    init_params(draft, seed=A8_DRAFT_SEED)
    return draft.to(torch.bfloat16).eval()


def host_s(torch, fn):
    """(result, host seconds) of ``fn()`` to its last kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def a8_spec_run(torch, build, fn, args, totals: dict):
    """One counted speculative run: (tokens, seconds, launches, stats)."""
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm

    build.reset_launch_counts()
    qm.reset_route_calls()
    out, secs = host_s(torch, lambda: fn(*args))
    launches = dict(build.launches)
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n
    return out, secs, launches, dict(fn.stats)


def a8_check_launches(label: str, launches: dict, want: dict) -> None:
    log(f"{label} launches: {launches} (want {want})")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} {launches[name]} launches, want {n}")


def a8_spec_b1(torch, build, target, draft, prompt, totals: dict) -> None:
    """(a) B 1 x 4096, 128 new, gamma 4, greedy: the random draft and the
    target as its own draft, against vanilla greedy; K1 once a layer of each
    prefill, K4 once a draft layer a draft step (gamma + 1 a round, S 4608),
    never in the verify pass."""
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )

    n, Lp = A8_NEW["a"], prompt.shape[1]
    vanilla = make_generate_fn(target, n)
    want, secs = host_s(torch, lambda: vanilla(prompt)[:, Lp:])
    tie_gate(torch, "(a) vanilla greedy B 1, teacher-forced through its own loop", target,
             prompt, want)
    _, van = host_s(torch, lambda: vanilla(prompt))
    log(f"(a) vanilla B 1: {n / van:.1f} tok/s ({van * 1e3 / n:.3f} ms a token; first "
        f"call {secs:.3f} s)")
    for label, d in (("random draft", draft), ("draft = target", target)):
        fn = make_speculative_generate_fn(target, d, n, gamma=A8_GAMMA)
        out, _, launches, st = a8_spec_run(torch, build, fn, (prompt,), totals)
        tie_gate(torch, f"(a) speculative B 1, {label}, teacher-forced through vanilla "
                 f"greedy ({int((out[:, Lp:] == want).sum())} of {n} tokens vanilla's)",
                 target, prompt, out[:, Lp:])
        layers = d.n_layers
        a8_check_launches(f"(a) {label}", launches, {
            "flash_fwd": MODEL["n_layers"] + layers,
            "decode_attention": layers * (A8_GAMMA + 1) * st["rounds"]})
        _, again = host_s(torch, lambda: fn(prompt))
        log(f"(a) {label} [{card_line()}]: {st['rounds']} rounds, "
            f"{st['accepted'] / st['rounds']:.3f} accepted tokens a round, round "
            f"{again * 1e3 / st['rounds']:.3f} ms, {n / again:.1f} tok/s against vanilla "
            f"{n / van:.1f} ({van / again:.3f}x)")


def a8_spec_batched(torch, build, target, draft, prompts, totals: dict) -> None:
    """(b) B 8 x 4096, 8 distinct prompts, 64 new: per-row frontiers (K4
    never: its reads stop at one scalar frontier), each row against vanilla
    B 8 greedy."""
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )

    n, (B, Lp) = A8_NEW["b"], prompts.shape
    vanilla = make_generate_fn(target, n)
    want = vanilla(prompts)[:, Lp:]
    _, van = host_s(torch, lambda: vanilla(prompts))
    fn = make_speculative_generate_fn(target, draft, n, gamma=A8_GAMMA)
    out, secs, launches, st = a8_spec_run(torch, build, fn, (prompts,), totals)
    tie_gate(torch, f"(b) speculative B 8, per-row frontiers, teacher-forced through vanilla "
             f"B 8 greedy ({int((out[:, Lp:] == want).all(1).sum())} of {B} rows vanilla's)",
             target, prompts, out[:, Lp:])
    a8_check_launches("(b)", launches, {"flash_fwd": MODEL["n_layers"] + A8_DRAFT["n_layers"],
                                        "decode_attention": 0})
    _, again = host_s(torch, lambda: fn(prompts))
    log(f"(b) speculative B {B} [{card_line()}]: {st['rounds']} rounds, "
        f"{st['accepted'] / (st['rounds'] * B):.3f} accepted tokens a round a row, round "
        f"{again * 1e3 / st['rounds']:.3f} ms, {B * n / again:.1f} tok/s against vanilla "
        f"{B * n / van:.1f} ({van / again:.3f}x)")


def a8_sampled(torch, build, target, draft, prompt, totals: dict) -> None:
    """(c) B 1, sampled (temperature 0.8, top-k 50, top-p 0.95), 64 new:
    exactly 64 tokens in the vocabulary; then the acceptance rule on the card
    against the CPU's in f64 on the same inputs (fixed uniforms)."""
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
        sampled_acceptance,
    )

    n, Lp = A8_NEW["c"], prompt.shape[1]
    fn = make_speculative_generate_fn(target, draft, n, gamma=A8_GAMMA, **A8_SAMPLING)
    gen = torch.Generator(device=prompt.device).manual_seed(SEED)
    out, secs, _, st = a8_spec_run(torch, build, fn, (prompt, gen), totals)
    new = out[:, Lp:]
    log(f"(c) sampled B 1 {A8_SAMPLING}: {new.shape[1]} tokens in [{int(new.min())}, "
        f"{int(new.max())}], {st['rounds']} rounds, {st['accepted'] / st['rounds']:.3f} "
        f"accepted a round, {secs:.3f} s")
    if new.shape != (1, n) or int(new.min()) < 0 or int(new.max()) >= MODEL["vocab_size"]:
        raise AssertionError(f"(c) sampled speculative: {tuple(new.shape)} tokens out of range")
    dev = prompt.device
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, V = 8, MODEL["vocab_size"]
    q = torch.softmax(3 * torch.randn(B, A8_GAMMA, V, device=dev, generator=g), -1)
    p = torch.softmax(3 * torch.randn(B, A8_GAMMA + 1, V, device=dev, generator=g), -1)
    p[:2, :A8_GAMMA] = q[:2]  # draft = target rows: every proposal accepted
    d = torch.multinomial(q.reshape(-1, V), 1, generator=g).reshape(B, A8_GAMMA)
    u = torch.rand(B, A8_GAMMA, device=dev, generator=g)
    n_acc, resid = sampled_acceptance(d, q, p, u)
    want_n, want_r = sampled_acceptance(*(t.cpu().double() if t.is_floating_point()
                                          else t.cpu() for t in (d, q, p, u)))
    err = float((resid.cpu().double() - want_r).abs().max())
    log(f"(c) sampled_acceptance on the card vs the CPU in f64: n_acc {n_acc.tolist()} vs "
        f"{want_n.tolist()}, residual max |diff| {err:.3e} (tol 1e-6)")
    if not torch.equal(n_acc.cpu(), want_n) or err > 1e-6:
        raise AssertionError("(c) sampled_acceptance on the card disagrees with the CPU's")


def a8_int8_target(torch, build, target8, draft, prompt, totals: dict) -> None:
    """(d) an int8 target (K6 in the prefill, the verify pass and the head),
    B 1, 64 new, against vanilla int8 greedy; K6's calls by route."""
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm

    n, Lp = A8_NEW["d"], prompt.shape[1]
    fn = make_speculative_generate_fn(target8, draft, n, gamma=A8_GAMMA, quantize="int8")
    out, secs, launches, st = a8_spec_run(torch, build, fn, (prompt,), totals)
    routes = dict(qm.route_calls)
    tie_gate(torch, "(d) speculative, int8 target, teacher-forced through vanilla int8 "
             "greedy", target8, prompt, out[:, Lp:])
    want_routes = {"wgmma": 5 * MODEL["n_layers"], "tile": 0,
                   "skinny": 1 + (5 * MODEL["n_layers"] + 1) * st["rounds"]}
    log(f"(d) int8 target: K6 calls by route {routes} (want {want_routes}); "
        f"{st['rounds']} rounds, {n / secs:.1f} tok/s")
    if routes != want_routes or launches["quant_matmul"] != sum(routes.values()):
        raise AssertionError(f"(d) quant_matmul routes {routes}, want {want_routes}")


def a8_kv_int8(torch, build, target, draft, prompts, totals: dict) -> None:
    """(e) an int8 KV cache (target and draft) at B 8, 32 new, against
    vanilla int8-KV greedy: per-row int8 rows and scales, the scale-folding
    einsum."""
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )

    n, Lp = A8_NEW["e"], prompts.shape[1]
    t8 = kv_int8_model(torch, target, tiered=False)
    d8 = kv_int8_model(torch, draft, tiered=False)
    fn = make_speculative_generate_fn(t8, d8, n, gamma=A8_GAMMA)
    out, secs, launches, st = a8_spec_run(torch, build, fn, (prompts,), totals)
    tie_gate(torch, "(e) speculative B 8, int8 KV, teacher-forced through vanilla int8-KV "
             "greedy", t8, prompts, out[:, Lp:])
    a8_check_launches("(e)", launches, {"decode_attention": 0, "decode_attention_int8": 0})
    del t8, d8


def a8_dequantized(torch, qm_model):
    """The float (bf16) twin of an int8 MoE model holding its dequantized
    weights: the int8 read path's serving reference."""
    sd = qm_model.state_dict()
    out = {}
    for key, t in sd.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "w_q":
            out[f"{module}.weight"] = (t.float() * sd[f"{module}.scale"]).t()
        elif leaf in ("w_in_q", "w_out_q"):
            out[f"{module}.{leaf[:-2]}"] = t.float() * sd[f"{module}.{leaf[:-2]}_scale"][:, None]
        elif leaf != "scale" and not leaf.endswith("_scale"):
            out[key] = t
    fm = qm_model.clone(weight_quant=None)
    fm.load_state_dict(out)
    return fm.to(torch.bfloat16).eval()


def a8_moe_teacher_forced(torch, moe, prompts, want) -> None:
    """(f) the cached decode's logits (prefill and the first A8_MOE_TF_STEPS
    steps of the stream ``want``) against the teacher-forced forward over
    the same tokens (``routed_forward``: flash attention on both, so the
    prompt's rows are computed as the prefill computes them; the decode's
    experts at router near-ties), within LOGIT_TOL at every position."""
    L, k = prompts.shape[1], A8_MOE_TF_STEPS
    tape = RouteTape(torch, moe)
    try:
        with torch.inference_mode():
            cache = moe.init_cache(prompts.shape[0], -(-(L + k + 1) // 512) * 512)
            cached = [moe(prompts, cache=cache, start=0, last_only=True)[:, -1].float()]
            for i in range(k):
                cached.append(moe(want[:, i:i + 1], cache=cache, start=L + i)[:, -1].float())
    finally:
        tape.close()
    cached = torch.stack(cached, 1)
    full, line = routed_forward(torch, "(f) MoE cached decode", moe,
                                torch.cat([prompts, want[:, :k]], 1), tape.experts(L + k))
    full = full[:, L - 1:].float()
    diff = float((cached - full).abs().max())
    log(f"(f) MoE cached decode vs teacher-forced (flash on both): max |logit diff| "
        f"{diff:.4f} over {cached.shape[0]} x {k + 1} positions (tol {LOGIT_TOL}; logit std "
        f"{float(full.std()):.3f}){line}")
    if not torch.isfinite(cached).all() or diff > LOGIT_TOL:
        raise AssertionError("(f) MoE cached decode disagrees with the teacher-forced forward")


def a8_decode_ms(torch, model, prompt, steps: int = 16) -> float:
    """Median decode ms a step (model step + greedy sample, CUDA events over
    ``steps`` steps, 3 repeats) after a prefill."""
    B, Lp = prompt.shape
    with torch.inference_mode():
        cache = model.init_cache(B, -(-(Lp + steps) // 512) * 512)
        first = model(prompt, cache=cache, start=0, last_only=True)[:, -1].argmax(-1)

        def loop():
            tok = first
            for i in range(steps):
                tok = model(tok[:, None], cache=cache, start=Lp + i)[:, -1].argmax(-1)

        loop()
        reps = sorted(event_ms(torch, loop) / steps for _ in range(3))
    return reps[1]


def a8_moe(torch, build, draft, totals: dict) -> None:
    """(f) MoE serving at JAX's measured shape: the cached decode against the
    teacher-forced forward; int8 experts against the dequantized model (K6
    on the attention projections and the head only: 3 a layer + 1 a
    forward); speculative decoding with an MoE target; decode ms a step,
    bf16 and int8, at B 8 and B 1."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )
    from distributed_machine_learning_tpu_torch.models.moe import MoETransformerLM
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

    dev = draft.device
    master = MoETransformerLM(**A8_MOE, moe_impl="grouped", compute_dtype=torch.bfloat16,
                              device=dev)
    init_params(master, seed=SEED)
    moe8 = quantize_lm(master).eval()
    moe = master.to(torch.bfloat16).eval()
    del master
    dq = a8_dequantized(torch, moe8)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    prompts = torch.randint(0, A8_MOE["vocab_size"], (A8_MOE_BATCH, A8_MOE_PROMPT),
                            generator=g, device=dev)
    L, n = A8_MOE_PROMPT, A8_MOE_NEW

    def counted(fn):
        build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, c in build.launches.items():
            totals[name] = totals.get(name, 0) + c
        return out, dict(build.launches)

    (want, _), l_bf16 = counted(lambda: decode_trace(torch, moe, prompts, n))
    a8_check_launches("(f) MoE bf16 generate", l_bf16, {
        "flash_fwd": A8_MOE["n_layers"], "decode_attention": 0, "quant_matmul": 0})
    a8_moe_teacher_forced(torch, moe, prompts, want)
    tape = RouteTape(torch, moe8)
    try:
        (int8, _), l_int8 = counted(lambda: decode_trace(torch, moe8, prompts, n))
    finally:
        tape.close()
    a8_check_launches("(f) MoE int8 generate (K6: attention and head only)", l_int8, {
        "flash_fwd": A8_MOE["n_layers"], "quant_matmul": (3 * A8_MOE["n_layers"] + 1) * n})
    tie_gate(torch, "(f) MoE int8 experts, teacher-forced through the dequantized model", dq,
             prompts, int8, tape)
    fn = make_speculative_generate_fn(moe, draft, n, gamma=A8_GAMMA)
    tape = RouteTape(torch, moe)
    try:
        (out, _), l_spec = counted(lambda: (fn(prompts), None))
    finally:
        tape.close()
    st = fn.stats
    tie_gate(torch, f"(f) MoE target, speculative B 8, teacher-forced through the MoE model "
             f"({int((out[:, L:] == want).all(1).sum())} of {out.shape[0]} rows vanilla's)",
             moe, prompts, out[:, L:], tape)
    log(f"(f) MoE speculative: {st['rounds']} rounds, launches {l_spec}")
    times = {f"{mode} B {B}": a8_decode_ms(torch, m, prompts[:B])
             for mode, m in (("bf16", moe), ("int8", moe8)) for B in (A8_MOE_BATCH, 1)}
    log(f"(f) MoE decode ms a step [{card_line()}]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; int8/bf16 at B {A8_MOE_BATCH} "
        f"{times[f'int8 B {A8_MOE_BATCH}'] / times[f'bf16 B {A8_MOE_BATCH}']:.3f}, at B 1 "
        f"{times['int8 B 1'] / times['bf16 B 1']:.3f}")
    del moe, moe8, dq


def a8_tp(torch, totals: dict) -> None:
    """(h) ``python -m ...cli.generate --tp 2`` at MODEL's width and
    A8_TP_LAYERS layers, a 4096-byte prompt, --random-init, greedy: bf16,
    then int8 weights with --spec-gamma 4 (the legs' draft, whole on every
    rank).  Every rank exits 0 with one stream, equal to the single card's
    (the same seeded weights) under the tie rule; K1, K4 (and K6) launched
    on every rank at local shapes."""
    import os

    import distributed_machine_learning_tpu_torch as pkg
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.data.text import encode_prompt
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

    dev = pkg.resolve_device()
    master = TransformerLM(**{**MODEL, "n_layers": A8_TP_LAYERS}, compute_dtype=torch.bfloat16,
                           device=dev)
    init_params(master, seed=SEED)  # cli.generate --random-init's weights (--seed 0)
    models = {"int8": quantize_lm(master).eval()}
    models["bf16"] = master.to(torch.bfloat16).eval()
    prompt = torch.tensor([encode_prompt(A8_TP_PROMPT, MODEL["vocab_size"])], device=dev)
    Lp = prompt.shape[1]
    base = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.generate",
            "--random-init", "--tp", str(A8_TP), "--d-model", str(MODEL["d_model"]),
            "--n-layers", str(A8_TP_LAYERS), "--n-heads", str(MODEL["n_heads"]),
            "--n-kv-heads", str(MODEL["n_kv_heads"]), "--vocab", str(MODEL["vocab_size"]),
            "--prompt", A8_TP_PROMPT, "--max-new-tokens", str(A8_TP_NEW), "--temperature", "0"]
    spec = ["--quant", "int8", "--spec-gamma", str(A8_GAMMA), "--draft-d-model", "512",
            "--draft-n-layers", "2", "--draft-n-heads", "16", "--draft-n-kv-heads", "4"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    layers = A8_TP_LAYERS
    for label, extra, mode in (("bf16", [], "bf16"), ("int8 + speculative", spec, "int8")):
        t0 = time.perf_counter()
        res = subprocess.run(base + extra, capture_output=True, text=True, env=env,
                             timeout=600)
        secs = time.perf_counter() - t0
        lines = res.stdout.splitlines()
        banner = next((ln for ln in lines if ln.startswith("tp=")), None)
        per_rank = next((ln for ln in lines if ln.startswith("tp rank kernel launches:")), None)
        stats = next((ln for ln in lines if ln.startswith("speculative:")), "")
        rank_s = next((ln for ln in lines if ln.startswith("tp rank request seconds:")), "")
        log(f"(h) cli.generate --tp {A8_TP} {label} ({secs:.1f} s): exit code "
            f"{res.returncode}; {banner}; {per_rank}; {rank_s}; {stats}")
        if res.returncode != 0 or banner is None or per_rank is None:
            raise AssertionError(f"(h) cli.generate --tp: exit code {res.returncode}; "
                                 f"output tail {(res.stdout + res.stderr)[-3000:]}")
        got = torch.tensor([[int(t) for t in lines[-1][len(A8_TP_PROMPT):].split()]],
                           device=dev)
        ranks = json.loads(per_rank.split(":", 1)[1])
        for r, rl in enumerate(ranks):
            for name, n in rl.items():
                totals[name] = totals.get(name, 0) + n
            need = ["flash_fwd", "decode_attention"] + (["quant_matmul"] if extra else [])
            if any(rl.get(k, 0) == 0 for k in need):
                raise AssertionError(f"(h) rank {r} launched {rl}, needs each of {need}")
            if not extra and (rl["flash_fwd"] != layers
                              or rl["decode_attention"] != layers * (A8_TP_NEW - 1)):
                raise AssertionError(f"(h) rank {r}: {rl}, want flash_fwd {layers} and "
                                     f"decode_attention {layers * (A8_TP_NEW - 1)}")
        model = models[mode]
        if got.shape != (1, A8_TP_NEW):
            raise AssertionError(f"(h) {tuple(got.shape)} tokens, want {(1, A8_TP_NEW)}")
        tie_gate(torch, f"(h) --tp {A8_TP} {label}, teacher-forced through the single card's "
                 f"vanilla greedy ({Lp}-token prompt)", model, prompt, got)
        if extra:
            one = make_speculative_generate_fn(model, a8_draft(torch, dev), A8_TP_NEW,
                                               gamma=A8_GAMMA, quantize="int8")
        else:
            one = make_generate_fn(model, A8_TP_NEW)
        one(prompt)
        _, single = host_s(torch, lambda: one(prompt))
        tp_s = max(json.loads(rank_s.split(":", 1)[1]))
        log(f"(h) {label} [{card_line()}]: a request ({Lp} + {A8_TP_NEW} tokens) on "
            f"{A8_TP} ranks sharing the card {tp_s:.3f} s (slowest rank) against "
            f"{single:.3f} s on the single card ({tp_s / single:.2f}x)")


def a8_record(rows: dict, column: str, totals: dict) -> None:
    for key, row in rows.items():
        row[f"{column}_launches"] = totals.get(key.split(":")[0], 0)


def serve_a8(torch, build, models, rows: dict) -> None:
    """Step 5c: legs (a)-(f) and (h) on the target in both modes (the
    checkpoint phase runs leg (g), cli.distill)."""
    dev = models["bf16"].device
    draft = a8_draft(torch, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    prompts = torch.randint(0, MODEL["vocab_size"], (BATCH, PROMPT), generator=g, device=dev)
    spec: dict = {}
    for leg, run in (("a", lambda: a8_spec_b1(torch, build, models["bf16"], draft,
                                              prompts[:1], spec)),
                     ("b", lambda: a8_spec_batched(torch, build, models["bf16"], draft,
                                                   prompts, spec)),
                     ("c", lambda: a8_sampled(torch, build, models["bf16"], draft,
                                              prompts[:1], spec)),
                     ("d", lambda: a8_int8_target(torch, build, models["int8"], draft,
                                                  prompts[:1], spec)),
                     ("e", lambda: a8_kv_int8(torch, build, models["bf16"], draft,
                                              prompts, spec))):
        t0 = time.perf_counter()
        run()
        log(f"A8 leg ({leg}): {time.perf_counter() - t0:.1f} s")
    a8_record(rows, "spec", spec)
    moe: dict = {}
    t0 = time.perf_counter()
    a8_moe(torch, build, draft, moe)
    log(f"A8 leg (f): {time.perf_counter() - t0:.1f} s")
    a8_record(rows, "moe", moe)
    gc.collect()
    torch.cuda.empty_cache()
    tp: dict = {}
    t0 = time.perf_counter()
    a8_tp(torch, tp)
    log(f"A8 leg (h): {time.perf_counter() - t0:.1f} s")
    a8_record(rows, "tp", tp)


def ckpt_distill_leg(torch, build, ckdir: str, state, card: str) -> dict:
    """(g) ``cli.distill`` on the step-4 checkpoint (exit 0, its loss
    falling), then ``cli.generate --draft-ckpt-dir --spec-gamma 4 --quant
    int8 --temperature 0``: its tokens against the plain command's stream
    (the in-memory step-4 weights, int8) under the tie rule, its acceptance
    beside the random draft's.  Returns the leg's launches."""
    from distributed_machine_learning_tpu_torch.cli import distill, generate
    from distributed_machine_learning_tpu_torch.data.text import encode_prompt
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

    device = state.model.device
    shape = ["--d-model", str(MODEL["d_model"]), "--n-layers", str(MODEL["n_layers"]),
             "--n-heads", str(MODEL["n_heads"]), "--n-kv-heads", str(MODEL["n_kv_heads"]),
             "--vocab", str(MODEL["vocab_size"]), "--device", str(device)]
    ddir = f"{ckdir}/draft"
    build.reset_launch_counts()
    t0 = time.perf_counter()
    path, lines = captured(distill.main, ["--target-ckpt-dir", ckdir, "--ckpt-dir", ddir,
                                          *shape, *A8_DISTILL])
    secs = time.perf_counter() - t0
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines if ln.startswith("iter ")]
    log(f"(g) cli.distill [{card}]: {secs:.1f} s; "
        + " | ".join(ln for ln in lines if ln.startswith(("distill:", "iter ", "Total",
                                                          "draft checkpoint"))))
    if len(losses) < 2 or not losses[-1] < losses[0] or not math.isfinite(losses[-1]):
        raise AssertionError(f"(g) cli.distill's loss does not fall: {losses}")
    draft_flags = A8_DISTILL[:8]
    flags = ["--ckpt-dir", ckdir, "--draft-ckpt-dir", ddir, "--spec-gamma", str(A8_GAMMA),
             "--quant", "int8", "--temperature", "0", "--prompt", CKPT_PROMPT,
             "--max-new-tokens", str(CKPT_NEW_TOKENS), *shape, *draft_flags]
    t0 = time.perf_counter()
    tokens, lines = captured(generate.main, flags)
    torch.cuda.synchronize()
    stats = next((ln for ln in lines if ln.startswith("speculative:")), "")
    log(f"(g) cli.generate --draft-ckpt-dir --spec-gamma {A8_GAMMA} --quant int8: "
        f"{time.perf_counter() - t0:.1f} s; {stats}")
    launches = dict(build.launches)
    model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16, device=device)
    model.load_state_dict(state.model.state_dict())
    model = quantize_lm(model).eval()
    prompt = torch.tensor([encode_prompt(CKPT_PROMPT, MODEL["vocab_size"])], device=device)
    tie_gate(torch, "(g) distilled draft, speculative, teacher-forced through cli.generate's "
             "vanilla greedy (int8, without --spec-gamma)", model, prompt,
             torch.tensor([tokens], device=device))
    fn = make_speculative_generate_fn(model, a8_draft(torch, device), CKPT_NEW_TOKENS,
                                      gamma=A8_GAMMA, quantize="int8")
    fn(prompt)
    st = fn.stats
    distilled = stats.split("(")[1].split(" a round")[0] if stats else "?"
    log(f"(g) accepted tokens a round: distilled draft {distilled}; the random draft "
        f"{st['accepted'] / st['rounds']:.2f} ({st['rounds']} rounds)")
    del model
    return launches


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


# The fused head+loss leg (step 6): the fused loss against the unfused one
# on one batch at the trainer's shape.  Both run the head's product in bf16
# with f32 logits and f32 logsumexp bookkeeping; they differ in the order of
# the vocab reductions (8 chunks of 4000 vs one pass), ~1e-7 relative on a
# loss of ~10.4.  The gradients are held to the trainer's kernel-vs-plain
# limit (TRAIN_GRAD_TOL, relative L2 per leaf).
FUSED_CE_CHUNKS = 8
FUSED_LOSS_TOL = 1e-4
# The corpus leg trains on the repo's own JAX package sources (a byte
# corpus; --data-dir needs no download) and evaluates on its held-out 10 %.
CORPUS_DIR = "distributed_machine_learning_tpu"
CORPUS_STEPS, CORPUS_EVAL_BATCHES = 3, 2


def check_fused_ce(torch, build) -> None:
    """The fused head+loss on the trainer's first batch and seeded weights:
    the loss within FUSED_LOSS_TOL of the unfused loss, every leaf's
    gradient within TRAIN_GRAD_TOL (relative L2), and the peak memory of
    each forward+backward above what was allocated before it."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss

    args = trainer_args(iters=1)
    _, _, place, model = lm.build(args)
    x, y = place(*next(lm.synthetic_batches(args)))
    out = {}
    for chunks in (None, FUSED_CE_CHUNKS):
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = lm_loss(model, x, y, chunks)
        loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        out[chunks] = (float(loss.detach()), grads, peak, seconds)
        del loss
    (loss_u, grads_u, peak_u, sec_u), (loss_f, grads_f, peak_f, sec_f) = out[None], out[
        FUSED_CE_CHUNKS]
    err = {k: rel_l2(grads_f[k], g) for k, g in grads_u.items()}
    worst = max(err, key=err.get)
    diff = abs(loss_f - loss_u)
    log(f"fused head+loss ({FUSED_CE_CHUNKS} vocab chunks) vs unfused, B "
        f"{TRAIN['batch_size']} x L {TRAIN['seq_len']} x vocab {MODEL['vocab_size']}: loss "
        f"{loss_f:.6f} vs {loss_u:.6f} (diff {diff:.3e}, tol {FUSED_LOSS_TOL:g}); gradient "
        f"rel L2 worst {err[worst]:.3e} ({worst}), median "
        f"{sorted(err.values())[len(err) // 2]:.3e} (tol {TRAIN_GRAD_TOL:g}); peak memory "
        f"of the forward+backward above the resident state {peak_f:.2f} GB fused vs "
        f"{peak_u:.2f} GB unfused (host clock {sec_f * 1e3:.1f} vs {sec_u * 1e3:.1f} ms, "
        "first calls)")
    if not (diff <= FUSED_LOSS_TOL and err[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError("fused head+loss disagrees with the unfused loss")


def run_fused_ce_paths(torch, build) -> None:
    """cli.lm dp with --fused-ce-chunks, as its main runs it: on the
    synthetic stream (build and train_epoch) and on the byte corpus of
    CORPUS_DIR with --eval-batches (``lm.run``: the corpus split, the
    held-out eval).  Launch counts zeroed just before and read just after
    each: K1-K3 once per layer a step, K7 once per leaf a step (the eval
    runs dense attention, no kernel).  Gates: losses finite, the eval's
    perplexity finite.  Reports step ms and peak memory."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    layers = MODEL["n_layers"]
    chunks = ("--fused-ce-chunks", str(FUSED_CE_CHUNKS))
    args = trainer_args(*chunks, iters=CORPUS_STEPS)
    step, state, place, model = lm.build(args)
    n_leaves = sum(1 for _ in model.parameters())
    losses: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    _, timer = train_epoch(recorded(step, losses), state, lm.synthetic_batches(args),
                           place_batch=place, max_iters=args.max_iters)
    torch.cuda.synchronize()
    launches, peak = dict(build.launches), torch.cuda.max_memory_allocated() / 1e9
    del step, state, place, model
    gc.collect()
    torch.cuda.empty_cache()
    want = {name: layers * CORPUS_STEPS for name in FLASH_KERNELS}
    want["fused_adamw"] = n_leaves * CORPUS_STEPS
    values = [float(x) for x in losses]
    log(f"cli.lm --fused-ce-chunks {FUSED_CE_CHUNKS}, synthetic: losses "
        f"{[round(v, 4) for v in values]}; step ms {spread([t * 1e3 for t in timer.times])}; "
        f"peak memory {peak:.2f} GB; launches {({k: launches[k] for k in want})} (want {want})")
    if {k: launches[k] for k in want} != want or not all(math.isfinite(v) for v in values):
        raise AssertionError("cli.lm --fused-ce-chunks on the synthetic stream")
    corpus = str(Path(__file__).resolve().parent / CORPUS_DIR)
    args = trainer_args(*chunks, "--data-dir", corpus, "--eval-batches",
                        str(CORPUS_EVAL_BATCHES), iters=CORPUS_STEPS)
    evals: list = []
    evaluate = lm.evaluate_lm
    lm.evaluate_lm = lambda *a: evals.append(evaluate(*a)) or evals[-1]
    train_epoch_ = lm.train_epoch
    times: list = []

    def timed_epoch(*a, **kw):
        state, timer = train_epoch_(*a, **kw)
        times.extend(timer.times)
        return state, timer

    lm.train_epoch = timed_epoch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        lm.run(args, initialize_from_flags(device=args.device))
        torch.cuda.synchronize()
    finally:
        lm.evaluate_lm, lm.train_epoch = evaluate, train_epoch_
    launches, peak = dict(build.launches), torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    nll, ppl = evals[0] if evals else (math.nan, math.nan)
    log(f"cli.lm --fused-ce-chunks {FUSED_CE_CHUNKS} --data-dir {CORPUS_DIR} --eval-batches "
        f"{CORPUS_EVAL_BATCHES}: {time.perf_counter() - t0:.1f} s; step ms {spread([t * 1e3 for t in times])}; "
        f"held-out eval nll/token {nll:.4f}, perplexity {ppl:.2f}; peak memory {peak:.2f} GB; "
        f"launches {({k: launches[k] for k in want})} (want {want})")
    if {k: launches[k] for k in want} != want or not math.isfinite(ppl):
        raise AssertionError("cli.lm --data-dir --eval-batches with the fused loss")


def train(torch, build, rows: dict) -> None:
    """The trainer phases: the main path with its counts, the remat run,
    the kernel-vs-plain step gates, the fused head+loss and the corpus."""
    t0 = time.perf_counter()
    out = run_trainer(torch, build, rows)
    check_remat(torch, build, out["losses"][0])
    check_train_step(torch)
    check_fused_ce(torch, build)
    run_fused_ce_paths(torch, build)
    log(f"trainer phases: {time.perf_counter() - t0:.1f} s")


# The checkpoint phase (step 6b): cli.lm's path for CKPT_STEPS steps, saved;
# resumed for CKPT_STEPS more; generated from and deployed.  The generate
# leg's prompt is 2048 bytes (a flash prefill, K1) at the 32k vocab.
CKPT_STEPS = 2
CKPT_PROMPT = "The " * 512
CKPT_NEW_TOKENS = 32
DEPLOY_REQUESTS_AFTER = 8  # requests submitted after the promotion
DEPLOY_WINDOW = 8  # canary completions before the judgement
# A full-width swap holds the worker's loop for seconds (1.93 GB of f32
# weights to the card, the int8 twin rebuilt, after the drain): beats stop
# meanwhile, so the router's eviction timeout and the commit wait are longer.
DEPLOY_REPLICA_TIMEOUT_S = 20.0
DEPLOY_COMMIT_TIMEOUT_S = 120.0
# The restored state's next step against the in-memory state's, when two
# steps from one snapshot are not bit for bit: each leaf's difference
# relative to its update, within max(0.1, 2.5 × that baseline noise), as the
# ring step gate does.
CKPT_NOISE_FLOOR, CKPT_NOISE_FACTOR = 0.1, 2.5


@contextlib.contextmanager
def timed_calls(module, names):
    """Record the wall seconds (host clock: the checkpoint work is disk,
    sha256 and pageable copies) of every call of ``module``'s functions
    ``names`` while the block runs; yields {name: [seconds, ...]}."""
    times = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times[name].append(time.perf_counter() - t0)
        return run

    try:
        for name, fn in saved.items():
            setattr(module, name, timed(name, fn))
        yield times
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def captured(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def check_trainer_launches(launches: dict, n_leaves: int, steps: int, label: str) -> None:
    layers = MODEL["n_layers"]
    want = {"flash_fwd": layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps, "fused_adamw": n_leaves * steps}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                 f"want {count}")


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def ckpt_save_leg(torch, build, ckdir: str, ctx, times: dict, card: str):
    """cli.lm's run (trainer_args, CKPT_STEPS steps, --ckpt-dir): launches
    gated, the bytes written against 12 bytes a parameter, the save's
    seconds, the free disk, then tools/ckpt_verify.py on the directory (exit
    0).  Returns (state, args, launches)."""
    import shutil

    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    args = trainer_args("--ckpt-dir", ckdir, iters=CKPT_STEPS)
    free0 = shutil.disk_usage(ckdir).free
    build.reset_launch_counts()
    state, lines = captured(lm.run, args, ctx)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    for line in lines:
        log(f"  cli.lm: {line}")
    path = f"{ckdir}/step_{CKPT_STEPS}"
    if f"Saved checkpoint to {path}" not in lines or state.step != CKPT_STEPS:
        raise AssertionError(f"checkpoint save leg: no save at step {CKPT_STEPS}: {lines}")
    n_leaves = sum(1 for _ in state.model.parameters())
    n_params = sum(p.numel() for p in state.model.parameters())
    check_trainer_launches(launches, n_leaves, CKPT_STEPS, "checkpoint save leg")
    leaf_bytes = sum(e["bytes"] for e in ck.checkpoint_manifest(path)["leaves"].values())
    on_disk = dir_bytes(path)
    save_s = times["save_checkpoint"][-1]
    log(f"checkpoint save [{card}]: {on_disk} bytes on disk ({leaf_bytes} of leaves: f32 "
        f"params, mu, nu of {n_params} parameters and the step) in {save_s:.3f} s -> "
        f"{on_disk / save_s / 1e9:.3f} GB/s; free disk {free0 / 1e9:.1f} -> "
        f"{shutil.disk_usage(ckdir).free / 1e9:.1f} GB; launches {launches}")
    if leaf_bytes != 12 * n_params + 4:
        raise AssertionError(f"checkpoint holds {leaf_bytes} bytes of leaves, want "
                             f"{12 * n_params + 4}")
    tool = Path(__file__).resolve().parent / "tools" / "ckpt_verify.py"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(tool), ckdir, "--quiet"], capture_output=True,
                         text=True, timeout=600)
    verify_s = time.perf_counter() - t0
    log(f"tools/ckpt_verify.py [{card}]: exit code {res.returncode} in {verify_s:.3f} s "
        f"({on_disk / verify_s / 1e9:.3f} GB/s, process start included): "
        f"{res.stdout.strip()[-300:]}")
    if res.returncode != 0:
        raise AssertionError(f"tools/ckpt_verify.py failed: {(res.stdout + res.stderr)[-2000:]}")
    return state, args, launches


def ckpt_round_trip(torch, state, args, path: str, card: str) -> None:
    """Restore ``path`` into a freshly built model and state: every leaf bit
    for bit equal to the in-memory state.  Then the next step: first two
    steps from one snapshot of the in-memory state on one batch (the
    baseline), then the restored state's step on the same batch, held bit
    for bit when the baseline is, else per leaf within
    max(CKPT_NOISE_FLOOR, CKPT_NOISE_FACTOR × the baseline's noise)."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.lm_step import make_lm_train_step

    _, fresh, place, _ = lm.build(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ck.restore_checkpoint(path, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = dir_bytes(path)
    want = {k: v for k, v in ck._state_leaves(state).items() if k != "step"}
    got = {k: v for k, v in ck._state_leaves(restored).items() if k != "step"}
    differ = [k for k in want if got[k].device != want[k].device
              or not torch.equal(got[k], want[k])]
    log(f"checkpoint restore (files and leaves verified) into a fresh state [{card}]: "
        f"{restore_s:.3f} s -> {nbytes / restore_s / 1e9:.3f} GB/s; {len(want)} leaves, "
        f"{len(differ)} differ from the in-memory state; step {restored.step}")
    if differ or restored.step != state.step or restored.config != state.config:
        raise AssertionError(f"restored state differs: leaves {differ[:5]}, step "
                             f"{restored.step} vs {state.step}")

    tokens, targets = place(*next(lm.synthetic_batches(args, seed=SEED + 2, count=1)))
    snap = {k: v.detach().clone() for k, v in want.items()}

    def run(st):
        loss = float(make_lm_train_step(st.model)(st, tokens, targets)[1])
        leaves = {k: v.detach().clone() for k, v in ck._state_leaves(st).items()
                  if k != "step"}
        grads = {k: p.grad.detach().clone() for k, p in st.model.named_parameters()}
        return loss, leaves, grads

    loss1, r1, g1 = run(state)
    with torch.no_grad():
        for k, t in want.items():
            t.copy_(snap[k])
    state.step = restored.step
    loss2, r2, g2 = run(state)
    bitwise = loss1 == loss2 and all(torch.equal(r1[k], r2[k]) for k in r1)
    if bitwise:
        del r2, g1, g2, snap
        loss3, r3, _ = run(restored)
        same = loss3 == loss1 and all(torch.equal(r3[k], r1[k]) for k in r1)
        log(f"restored step vs in-memory step on one batch [{card}]: the baseline (two "
            f"steps from one snapshot) is bit for bit (loss {loss1!r}); the restored "
            f"step {'is bit for bit too' if same else 'DIFFERS'} (loss {loss3!r})")
        if not same:
            bad = [k for k in r1 if not torch.equal(r3[k], r1[k])]
            raise AssertionError(f"the restored state's step differs: loss {loss3!r} vs "
                                 f"{loss1!r}, leaves {bad[:5]}")
        return
    # Not repeatable: name where the two runs part.
    def rel(a, k):  # difference relative to the step's update of the leaf
        return float((a[k] - r1[k]).float().norm()
                     / (r1[k] - snap[k]).float().norm().clamp_min(1e-30))

    noise = {k: rel(r2, k) for k in r1}
    del r2
    loss3, r3, _ = run(restored)
    grad_differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    op = ("the forward (the loss differs)" if loss1 != loss2 else
          f"the backward of {grad_differ[:3]}'s layers (their gradients differ)"
          if grad_differ else "the update (K7: equal gradients, different parameters)")
    limits = {k: max(CKPT_NOISE_FLOOR, CKPT_NOISE_FACTOR * noise[k]) for k in r1}
    errs = {k: rel(r3, k) for k in r1}
    worst = max(errs, key=lambda k: errs[k] / limits[k])
    log(f"restored step vs in-memory step [{card}]: the baseline is NOT bit for bit: "
        f"{op}; loss {loss1!r} / {loss2!r} / restored {loss3!r}; worst leaf {worst}: "
        f"{errs[worst]:.3e} of its update (limit {limits[worst]:.3e})")
    if any(errs[k] > limits[k] for k in r1) or not math.isfinite(loss3):
        raise AssertionError(f"the restored state's step exceeds the baseline noise at "
                             f"{worst}")


def ckpt_resume_leg(torch, build, ckdir: str, ctx, times: dict, card: str):
    """cli.lm --resume for CKPT_STEPS more steps: it must resume from
    step_CKPT_STEPS, end at step 2·CKPT_STEPS, save it and launch the trainer
    kernels again.  Returns (state, launches)."""
    from distributed_machine_learning_tpu_torch.cli import lm

    args = trainer_args("--ckpt-dir", ckdir, "--resume", iters=CKPT_STEPS)
    for name in times:
        times[name].clear()
    build.reset_launch_counts()
    state, lines = captured(lm.run, args, ctx)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    for line in lines:
        log(f"  cli.lm --resume: {line}")
    end = 2 * CKPT_STEPS
    want = [f"Resumed from {ckdir}/step_{CKPT_STEPS} (step {CKPT_STEPS})",
            f"Saved checkpoint to {ckdir}/step_{end}"]
    if any(w not in lines for w in want) or state.step != end:
        raise AssertionError(f"resume leg: want {want} and step {end}, got step "
                             f"{state.step}: {lines}")
    check_trainer_launches(launches, sum(1 for _ in state.model.parameters()), CKPT_STEPS,
                           "checkpoint resume leg")
    chain, restore, save = (times[k][0] for k in ("latest_checkpoint", "restore_checkpoint",
                                                  "save_checkpoint"))
    nbytes = dir_bytes(f"{ckdir}/step_{end}")
    log(f"checkpoint resume [{card}]: chain walk (sha256 of every file) {chain:.3f} s, "
        f"restore (leaves verified) {restore:.3f} s -> {nbytes / restore / 1e9:.3f} GB/s, "
        f"save of step_{end} {save:.3f} s -> {nbytes / save / 1e9:.3f} GB/s; launches "
        f"{launches}")
    return state, launches


def ckpt_generate_leg(torch, build, ckdir: str, state, times: dict, card: str,
                      shape: dict = MODEL) -> dict:
    """``cli.generate --ckpt-dir --quant int8 --temperature 0`` in this
    process (it must return, K1 and K6 launched); its greedy tokens must
    equal the same prompt's from the in-memory weights, quantized by
    quantize_lm, in the CLI's model (of ``shape``).  Returns the leg's
    launches."""
    from distributed_machine_learning_tpu_torch.cli import generate
    from distributed_machine_learning_tpu_torch.data.text import encode_prompt
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

    flags = ["--ckpt-dir", ckdir, "--quant", "int8", "--temperature", "0",
             "--prompt", CKPT_PROMPT, "--max-new-tokens", str(CKPT_NEW_TOKENS),
             "--d-model", str(shape["d_model"]), "--n-layers", str(shape["n_layers"]),
             "--n-heads", str(shape["n_heads"]), "--n-kv-heads", str(shape["n_kv_heads"]),
             "--vocab", str(shape["vocab_size"]), "--device", str(state.model.device)]
    for name in times:
        times[name].clear()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, lines = captured(generate.main, flags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.launches)
    path = f"{ckdir}/step_{2 * CKPT_STEPS}"
    log(f"cli.generate --ckpt-dir --quant int8 [{card}]: {seconds:.3f} s (chain walk "
        f"{times['latest_checkpoint'][0]:.3f} s, restore {times['restore_checkpoint'][0]:.3f}"
        f" s); {lines[0]!r}; launches {launches}")
    if lines[0] != f"restored {path}" or len(tokens) != CKPT_NEW_TOKENS:
        raise AssertionError(f"cli.generate --ckpt-dir: {lines[:1]}, {len(tokens)} tokens")
    for name in ("flash_fwd", "quant_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"cli.generate --ckpt-dir: {name} never launched")
    device = state.model.device
    model = TransformerLM(**shape, compute_dtype=torch.bfloat16, device=device)
    model.load_state_dict(state.model.state_dict())
    model = quantize_lm(model).eval()
    prompt = torch.tensor([encode_prompt(CKPT_PROMPT, shape["vocab_size"])])
    fn = make_generate_fn(model, CKPT_NEW_TOKENS, temperature=0.0, quantize="int8")
    want = fn(prompt, torch.Generator(device=device).manual_seed(0))[0, prompt.shape[1]:]
    want = want.tolist()
    log(f"cli.generate --ckpt-dir vs the in-memory step-{2 * CKPT_STEPS} weights: "
        f"{sum(a == b for a, b in zip(tokens, want))}/{CKPT_NEW_TOKENS} greedy tokens equal")
    if tokens != want:
        raise AssertionError(f"cli.generate --ckpt-dir tokens {tokens} != the in-memory "
                             f"weights' {want}")
    return launches


def deploy_engines(torch, n: int, device) -> list:
    """``n`` engine replicas at ENGINE's config, each over its own bf16 model
    (a swap on one must not touch another) holding the seeded random weights
    the serving phases use (version 0), each with its own int8 twin, warmed
    on both prefill paths and both levers; and version 0's f32 state_dict."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM

    engines, weights = [], None
    for _ in range(n):  # the first model's f32 init stays in ``weights``
        model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16, device=device)
        if weights is None:
            init_params(model, seed=SEED)
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        engine = ContinuousEngine(model.to(torch.bfloat16).eval(), EngineConfig(**ENGINE),
                                  device=model.device)
        engine.warmup(prompt_lens=(300, 2048))
        engines.append(engine)
    torch.cuda.synchronize()
    return engines, weights


def ckpt_deploy_leg(torch, build, ckdir: str, device, card: str) -> dict:
    """A DeployController deploys step_2·CKPT_STEPS onto FLEET's engine
    replicas (2 live + 1 spare, a RegimeScheduler on the router) while
    engine_traffic's requests flow: load_serving_weights, then each
    replica's on_swap calls engine.swap_params with the controller's loaded
    weights.  Gates: promoted once, no rollback; exactly once; every
    completion carries one version; every request submitted after the
    promotion carries the new one; their first tokens against the plain
    path under the new weights; K1, K5 and K6 launched.  Returns the leg's
    launches."""
    import threading

    from distributed_machine_learning_tpu_torch.runtime import deploy as deploy_mod
    from distributed_machine_learning_tpu_torch.runtime import serving, serving_worker
    from distributed_machine_learning_tpu_torch.runtime import transport as tr
    from distributed_machine_learning_tpu_torch.runtime.deploy import (
        DeployConfig,
        DeployController,
    )
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
    from distributed_machine_learning_tpu_torch.runtime.scheduler import RegimeScheduler

    prompts, news = engine_traffic(torch, FLEET_REQUESTS)
    engines, v0 = deploy_engines(torch, FLEET["replicas"] + FLEET["spares"], device)
    hub, events = tr.InProcHub(), FaultEvents()
    router = serving.ServingRouter(
        tr.InProcTransport(hub),
        serving.ServingConfig(replicas=FLEET["replicas"], max_queue=FLEET_REQUESTS,
                              micro_batch=ENGINE["max_lanes"],
                              max_outstanding=ENGINE["max_lanes"], poll_s=0.005,
                              replica_timeout_s=DEPLOY_REPLICA_TIMEOUT_S),
        scheduler=RegimeScheduler(), events=events)
    controller = DeployController(
        tr.InProcTransport(hub), router,
        DeployConfig(checkpoint_dir=ckdir, canary_replicas=1,
                     canary_every_n=FLEET["replicas"], canary_window=DEPLOY_WINDOW,
                     commit_timeout_s=DEPLOY_COMMIT_TIMEOUT_S, judge_timeout_s=300.0,
                     poll_s=0.01),
        events=events)
    swaps = []

    def on_swap_for(engine):
        def on_swap(version, rec):
            t0 = time.perf_counter()
            weights = v0 if version == 0 else controller.loaded[version]["params"]
            engine.swap_params(weights, version=version)
            torch.cuda.synchronize(engine.device)
            swaps.append((version, time.perf_counter() - t0))
        return on_swap

    stops = [threading.Event() for _ in engines]
    build.reset_launch_counts()
    workers = [serving_worker.start_worker_thread(
        tr.InProcTransport(hub), rank, None, stops[rank],
        serving_worker.ServingWorkerConfig(micro_batch=ENGINE["max_lanes"]),
        on_swap=on_swap_for(engine), engine=engine) for rank, engine in enumerate(engines)]
    stop_router = threading.Event()
    rt = threading.Thread(target=router.run, args=(stop_router,), daemon=True)
    rt.start()
    submitted, done_loading = [], threading.Event()

    def submit(i):
        while True:
            try:
                return router.submit(prompts[i % len(prompts)], max_new=news[i % len(news)])
            except serving.Overloaded:
                time.sleep(0.005)

    def load():
        i = 0
        while not done_loading.is_set():
            submitted.append((submit(i), i % len(prompts)))
            i += 1

    loader = threading.Thread(target=load, daemon=True)
    try:
        deadline = time.monotonic() + 60.0
        while len(router._replicas) < FLEET["replicas"]:
            if time.monotonic() > deadline:
                raise AssertionError("deploy leg: replicas never went live")
            time.sleep(0.005)
        loader.start()
        t0 = time.perf_counter()
        with timed_calls(deploy_mod, ("latest_checkpoint", "load_serving_weights")) as times:
            out = controller.poll_once()
        deploy_s = time.perf_counter() - t0
        done_loading.set()
        loader.join(timeout=60)
        if not router.wait_idle(300.0):
            raise AssertionError(f"deploy leg: not idle: {router.audit()}")
        after = [(submit(i), i) for i in range(DEPLOY_REQUESTS_AFTER)]
        if not router.wait_idle(300.0):
            raise AssertionError(f"deploy leg: not idle after the promotion: {router.audit()}")
        torch.cuda.synchronize()
        launches = dict(build.launches)
        live = sorted(router.audit()["weight_versions"])
        results = {rid: router.result(rid) for rid, _ in submitted + after}
    finally:
        verdict = router.close()
        stop_router.set()
        for stop in stops:
            stop.set()
        for t, _ in workers:
            t.join(timeout=30)
        rt.join(timeout=10)
    summary = controller.summary()
    log(f"deploy leg [{card}]: {out and out['outcome']} in {deploy_s:.3f} s (chain walk "
        f"{times['latest_checkpoint'][0]:.3f} s, load_serving_weights "
        f"{times['load_serving_weights'][0]:.3f} s, a canary window of {DEPLOY_WINDOW}, the "
        f"promotion); swaps (version, s) {swaps}; "
        f"{verdict['completed']}/{verdict['admitted']} completed, exactly_once "
        f"{verdict['exactly_once']}; {len(submitted)} requests during the deploy, "
        f"{len(after)} after; versions by request "
        f"{[results[rid]['version'] for rid, _ in submitted + after]}; history "
        f"{[(h['rank'], h['version'], h['why']) for h in summary['history']]}; launches "
        f"{launches}")
    if out is None or out["outcome"] != "promoted" or out["step"] != 2 * CKPT_STEPS:
        raise AssertionError(f"deploy leg: {out}")
    if (events.canary_promotions, events.canary_rollbacks) != (1, 0):
        raise AssertionError(f"deploy leg: {events.canary_promotions} promotions, "
                             f"{events.canary_rollbacks} rollbacks")
    if not (verdict["exactly_once"] and verdict["admitted"] == verdict["completed"]):
        raise AssertionError(f"deploy leg: not exactly once: {verdict}")
    if any(results[rid]["version"] not in (0, 1) for rid, _ in submitted + after):
        raise AssertionError("deploy leg: a completion without a single weights version")
    if any(results[rid]["version"] != 1 for rid, _ in after):
        raise AssertionError("deploy leg: a request after the promotion served the old "
                             "weights")
    for name in ("flash_fwd", "paged_attention", "quant_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"deploy leg: {name} never launched")
    done, after_prompts = {}, {}
    for rid, i in after:
        entry = results[rid]
        levers = [ev.get("lever") for ev in entry["events"] if ev.get("stage") == "decode"]
        done[len(done)] = {"tokens": entry["result"], "lever": levers[-1] if levers else None}
        after_prompts[len(after_prompts)] = prompts[i]
    # The plain path is swapped in module-wide: only with every fleet thread gone.
    check_first_tokens(torch, engines[live[0]], done, after_prompts,
                       "deploy leg, requests after the promotion (new weights)")
    del engines, v0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_deploy_cli(ckdir: str, device, card: str) -> None:
    """The real ``cli.deploy``: 4 replicas, 300 requests, 2 deploys, then again
    with a regression injected into deploy 2; both must exit 0, the second
    with one rollback."""
    import os

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    for n, extra in enumerate(([], ["--inject", "regression@2"])):
        cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.deploy",
               "--replicas", "4", "--requests", "300", "--deploys", "2",
               "--checkpoint-dir", f"{ckdir}/deploy_cli_{n}", "--device", str(device), *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith(("deploy ", "requests:", "deploys:", "exactly-once"))]
        log(f"cli.deploy {' '.join(extra)} [{card}] ({time.perf_counter() - t0:.1f} s): "
            f"exit code {res.returncode}; " + " | ".join(lines))
        want = "(1 promoted, 1 rolled back" if extra else "(2 promoted, 0 rolled back"
        if res.returncode != 0 or "exactly-once audit: PASS" not in res.stdout \
                or want not in res.stdout:
            raise AssertionError(f"cli.deploy {extra}: exit code {res.returncode}; output "
                                 f"tail {(res.stdout + res.stderr)[-2000:]}")


def checkpoint_phase(torch, build, rows: dict, card: str) -> None:
    """Step 6b: save, round trip, resume, generate and deploy at full width
    in a temporary directory under build/ (two checkpoints of ~5.8 GB),
    removed at the end whatever happens; every row of the kernels line gets
    the launches of the save, resume, generate and deploy legs."""
    import shutil
    import tempfile

    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    t_phase = time.perf_counter()
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="ckpt_phase_", dir=build_dir)
    ctx = initialize_from_flags(device=trainer_args().device)
    try:
        with timed_calls(ck, ("save_checkpoint", "restore_checkpoint",
                              "latest_checkpoint")) as times:
            state, args, l_save = ckpt_save_leg(torch, build, ckdir, ctx, times, card)
            ckpt_round_trip(torch, state, args, f"{ckdir}/step_{CKPT_STEPS}", card)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            state, l_resume = ckpt_resume_leg(torch, build, ckdir, ctx, times, card)
            l_gen = ckpt_generate_leg(torch, build, ckdir, state, times, card)
            t0 = time.perf_counter()
            l_distill = ckpt_distill_leg(torch, build, ckdir, state, card)
            log(f"A8 leg (g): {time.perf_counter() - t0:.1f} s")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        l_deploy = ckpt_deploy_leg(torch, build, ckdir, ctx.device, card)
        run_deploy_cli(ckdir, ctx.device, card)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for key, row in rows.items():
        name = key.split(":")[0]
        row["ckpt_launches"] = sum(leg.get(name, 0) for leg in (l_save, l_resume, l_gen,
                                                                 l_deploy))
        row["distill_launches"] = l_distill.get(name, 0)
    log(f"checkpoint phases: {time.perf_counter() - t_phase:.1f} s")


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
# The reference's protocol runs 40 iterations (iteration 0 untimed); cut to
# 20 (time limit).
VGG_ITERS = 20
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
    from concurrent.futures import ThreadPoolExecutor

    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    def one_run(label, world, flags):
        t0 = time.perf_counter()
        return spawn(vgg_rank, world, (label, flags), timeout_s=600), time.perf_counter() - t0

    failed = []
    # Three runs' ranks at a time, in VGG_RUNS' order (time limit): each
    # run's times carry the others' load.
    with ThreadPoolExecutor(3) as pool:
        running = [pool.submit(one_run, label, world, flags)
                   for label, _, world, _, _, flags in VGG_RUNS]
        results = [job.result() for job in running]
    for (label, strategy, world, batch, use_bn, flags), (ranks, seconds) in zip(VGG_RUNS,
                                                                                 results):
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
            f"{r0['device']}; {seconds:.1f} s with process start")
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


def ring_case(torch, rf, Lc, H, Hkv, D, dtype, gen, B: int = 1):
    """q, dO of chunk 1; (k, v) of chunk 1 (diagonal) and chunk 0 (full);
    the lse and delta = rowsum(dO o O) of the two-chunk rows (plain)."""
    dt = getattr(torch, dtype)
    q, do = (torch.randn(B, Lc, H, D, device="cuda", generator=gen).to(dt) for _ in "ab")
    own, prev = ([torch.randn(B, Lc, Hkv, D, device="cuda", generator=gen).to(dt)
                  for _ in "ab"] for _ in "ab")
    m = torch.full((B, H, Lc), -1e30, device="cuda")
    empty = (m, torch.zeros_like(m), torch.zeros(B, Lc, H, D, device="cuda"))
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
    for case in RING_CHECKS:
        check_ring_case(torch, rf, case, gen, errs, failed)
    for name, e in errs.items():
        rows[name] = {"max_abs_err": max(e)}
    raise_failed(failed)
    if timing:
        time_ring_flash(torch, rf, rows, gen)


def check_ring_case(torch, rf, case: tuple, gen, errs: dict, failed: list, B: int = 1) -> None:
    """K11-K13 against their plain versions at one RING_CHECKS shape and B
    rows: the diagonal step from the empty carry, then the full step from
    the diagonal's results."""
    Lc, H, Hkv, D, dtype = case
    q, do, own, prev, empty, lse, delta = ring_case(torch, rf, Lc, H, Hkv, D, dtype, gen, B)
    carry = empty
    dq = torch.zeros(B, Lc, H, D, device="cuda")
    dk, dv = (torch.zeros(B, Lc, Hkv, D, device="cuda") for _ in "kv")
    for causal, (k, v) in ((True, own), (False, prev)):
        label = (f"{'diagonal' if causal else 'full'} B={B} Lc={Lc} H={H} Hkv={Hkv} D={D} "
                 f"{dtype}")
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


# The context-parallel trainers (step 8): cli.lm --parallel ring and
# --parallel ulysses at the model's full width, RING["world"] ranks sharing
# the card (gloo over host buffers), each rank a chunk of seq_len / world =
# 4096 tokens.  Depth cut to RING["n_layers"] of the model's 8 layers, to
# keep the whole run inside its time limit (a step's time is the host
# wire's gradient mean, which scales with the parameters).
# (1 layer: a depth cut for the time limit.)
RING = dict(world=4, seq_len=16384, batch_size=1, max_iters=3, n_layers=1)
# The real command: two processes of cli.lm --parallel ring, cut to 1 layer.
RING_CLI = dict(world=2, n_layers=1, seq_len=8192, max_iters=3)
# The ring path's step-0 loss (the mean CE over B 1 x L 16384 tokens at the
# seeded weights, ~ln 32000 = 10.4) against the one-process dp path (K1 over
# the whole sequence) on the same batch: both bf16, with P and the
# activations rounded at other places (64-key tiles of one chunk vs of the
# whole row); per-token differences of ~1e-3 average down over 16384
# tokens, so 2e-3 is an order of magnitude above the expected reading.
# Ulysses runs K1 over the whole row on H/W heads: the same limit.
RING_DP_LOSS_TOL = 2e-3
RING_KERNELS = ("ring_flash_fwd", "ring_flash_dq", "ring_flash_dkv")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
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
# limit.  The Ulysses step gate is the same rule, its plain flash forward
# and backward tiled by 512 and by RING_NOISE_BLOCK.
RING_NOISE_BLOCK = 256
RING_NOISE_FACTOR = 2.5
# Each scheme's wire call, timed by CUDA events a step: (label, Comm method).
CP_WIRE = {"ring": ("hop", "shift"), "ulysses": ("all-to-all", "all_to_all")}


def cp_args(parallel: str, rank: int, world: int, seq_len: int, iters: int):
    """cli.lm's flags for a context-parallel path (full width, bf16, fused
    AdamW, --attn flash: the ring's upgrade rule turns it into ring_flash;
    Ulysses picks its local kernel itself)."""
    return trainer_args("--parallel", parallel, "--num-nodes", str(world), "--rank",
                        str(rank), "--seq-len", str(seq_len), "--batch-size",
                        str(RING["batch_size"]), "--n-layers", str(RING["n_layers"]),
                        iters=iters)


def ring_args(rank: int, world: int, seq_len: int, iters: int):
    return cp_args("ring", rank, world, seq_len, iters)


class WireTimer:
    """CUDA events around every call of a kind (a ring hop, ``Comm.shift``;
    an all-to-all, ``Comm.all_to_all``; a gradient mean) of a rank, summed
    per step: how long the stream waited on the wire (under the host wire
    each call is a D2H copy, TCP and an H2D copy)."""

    def __init__(self, torch):
        self.torch = torch
        self.events: dict = {}
        self.marks: list = []

    def wrap(self, kind: str, fn):
        self.events.setdefault(kind, [])

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


def param_digest(torch, tensors) -> str:
    import hashlib

    digest = hashlib.sha256()
    for p in tensors:
        digest.update(p.detach().contiguous().view(torch.int32).cpu().numpy().tobytes())
    return digest.hexdigest()


def cp_rank(rank: int, world: int, init_method: str, parallel: str = "ring") -> dict:
    """One rank of a context-parallel path: cli.lm's build and train_epoch,
    as its main runs them, the launch counts zeroed just before and read
    just after; then a parameter digest, a profiled view on rank 0 (every
    rank steps alike), and one step through the kernels and the same step
    through the plain versions from the same state, compared leaf by leaf."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train import lm_step
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    args = cp_args(parallel, rank, world, RING["seq_len"], RING["max_iters"])
    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    try:
        step, state, place, model = lm.build(args, ctx)
        comm = model.comm
        wire = WireTimer(torch)
        kind, method = CP_WIRE[parallel]
        setattr(comm, method, wire.wrap(kind, getattr(comm, method)))
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
               "times": timer.times, "wire_ms": wire.per_step(kind),
               "mean_ms": wire.per_step("mean"), "steps": state.step,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "attn": model.attn_impl,
               "backend": ctx.backend, "wire": comm.wire, "device": str(ctx.device),
               "n_leaves": sum(1 for _ in model.parameters()),
               "digest": param_digest(torch, model.parameters())}

        def one(i):
            step(state, *place(*next(lm.synthetic_batches(args, seed=100 + i, count=1))))

        if rank == 0:
            profile_steps(torch, f"{parallel} train step, rank 0 of {world}", one, steps=1)
        else:
            one(0)
        torch.cuda.synchronize()
        out.update(ring_step_gate(torch, step, state, model, place, args))
        return out
    finally:
        ctx.shutdown()


def ring_step_gate(torch, step, state, model, place, args) -> dict:
    """One context-parallel step through the kernels and the same step
    through the plain versions (plain_kernels) from one state, then the
    plain step again with the attention tiled by RING_NOISE_BLOCK: the bf16
    noise between two correct plain versions, per leaf.  The state is kept
    on the host in between.  Returns the loss pair, the worst and median
    leaf of the update error, and of the gradient error against its limit
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
    with plain_kernels(block=RING_NOISE_BLOCK):
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
    sequence) on the context-parallel paths' first batch, at the same
    seeded weights."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss

    args = trainer_args("--seq-len", str(RING["seq_len"]), "--batch-size",
                        str(RING["batch_size"]), "--n-layers", str(RING["n_layers"]), iters=1)
    _, _, place, model = lm.build(args)
    with torch.no_grad():
        loss = float(lm_loss(model, *place(*next(lm.synthetic_batches(args)))))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def cp_spawn(parallel: str) -> tuple:
    """A context-parallel path's ranks (``cp_rank``), spawned: (their
    records, seconds with process start)."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    t0 = time.perf_counter()
    ranks = spawn(cp_rank, RING["world"], (parallel,), timeout_s=900)
    return ranks, time.perf_counter() - t0


def run_cp(torch, rows: dict, parallel: str, dp_loss: float, spawned: tuple) -> None:
    """A context-parallel path (RING) in its ranks.  Gates: the ring
    launches K11/K12/K13 layers x (r + 1) times a step on rank r and K1-K3
    never; Ulysses K1, K2 and K3 layers times a step on every rank (its
    local attention over the full sequence) and K11-K13 never; K7 once per
    leaf a step; every rank's parameters bit for bit equal; losses finite
    and falling; the step-0 loss against the dp path (``dp_loss``); one
    step kernel vs plain on every rank.  Reports step ms, tokens/s, the
    wire calls' and the gradient mean's ms a step, peak memory per rank and
    the wire.  ``spawned``: ``cp_spawn(parallel)``'s result."""
    world, layers = RING["world"], RING["n_layers"]
    ranks, seconds = spawned
    r0, n = ranks[0], RING["max_iters"]
    failed = []
    log(f"{parallel}: world {world} x B {RING['batch_size']} x L {RING['seq_len']}, {layers} "
        f"layers (chunk "
        f"{RING['seq_len'] // world}), attn {r0['attn']}, backend {r0['backend']}, wire "
        f"{r0['wire']}, {r0['device']}; {seconds:.1f} s with process start")
    path_kernels = RING_KERNELS if parallel == "ring" else FLASH_KERNELS
    for r, out in enumerate(ranks):
        each = layers * (r + 1) * n if parallel == "ring" else layers * n
        want = {name: each for name in path_kernels}
        want.update({name: 0 for name in (*RING_KERNELS, *FLASH_KERNELS)
                     if name not in path_kernels})
        want["fused_adamw"] = out["n_leaves"] * n
        got = {k: out["launches"][k] for k in want}
        ok = got == want
        log(f"{parallel} rank {r}: launches over {n} steps {got} (want {want}): "
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
    log(f"{parallel}: losses {[round(x, 4) for x in losses]}; step-0 loss vs the one-process "
        f"dp path {losses[0]:.6f} vs {dp_loss:.6f} (diff {diff:.3e}, tol {RING_DP_LOSS_TOL:g})")
    if not diff <= RING_DP_LOSS_TOL:
        failed.append("step-0 loss vs dp")
    same = len({r["digest"] for r in ranks}) == 1
    log(f"{parallel}: parameters bit for bit equal on all {world} ranks: {same}")
    if not same:
        failed.append("ranks' parameters differ")
    for r, out in enumerate(ranks):
        g = out["gate"]
        name, err, noise, ratio, median, name_e, err_e, noise_e = g["grad"]
        log(f"{parallel} rank {r} step, kernel vs plain path: loss {g['loss']:.6f} vs "
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
    log(f"{parallel}: step ms (host clock to the loss sync, rank 0, iteration 0 untimed) "
        f"{spread(ms)} -> {tokens / sorted(ms)[len(ms) // 2] * 1e3:.0f} tokens/s")
    label = CP_WIRE[parallel][0]
    for r, out in enumerate(ranks):
        log(f"{parallel} rank {r}: {label} {spread(out['wire_ms'])} ms a step, gradient mean "
            f"{spread(out['mean_ms'])} ms a step (CUDA events)")
    for key, row in rows.items():
        name = key.split(":")[0]
        row[f"{parallel}_launches"] = sum(r["launches"][name] for r in ranks)
        if name in RING_KERNELS and parallel == "ring" or key.endswith(":ulysses") \
                and parallel == "ulysses":
            row["launches"] = row[f"{parallel}_launches"]
    if failed:
        raise AssertionError(f"{parallel}: " + "; ".join(failed))


def run_ring(torch, rows: dict) -> None:
    """The ring path alone, with its dp loss (``tools/cross_card_phases.py``)."""
    run_cp(torch, rows, "ring", ring_dp_loss(torch))


def run_ring_cli(torch, backend: str | None = None) -> None:
    """The ring path through the real command: RING_CLI["world"] processes
    of ``python -m distributed_machine_learning_tpu_torch.cli.lm --parallel
    ring --master-ip --rank --num-nodes`` (full width, cut to 1 layer);
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


# The ZeRO-3 trainer (step 9): cli.lm --parallel fsdp at the model's full
# width, FSDP["world"] ranks sharing the card (gloo over host buffers), dense
# attention (the reference's rule), B 4 x L 2048 (2 rows a rank): first the
# sync step, then --overlap-update, then (rank 0) --parallel dp on one
# process from the same seeded weights and batches.
# The ZeRO-3 cells (flat fsdp and fsdp_pl) run MODEL's width at 2 of its 8
# layers (depth cut to keep the whole run inside its time limit; at 1 layer
# flat fsdp's loss does not fall in its 4 steps: 10.864, 10.897, 10.898,
# 10.902 on an H100 80GB HBM3 at 700 W).
FSDP = dict(world=2, seq_len=2048, batch_size=4, max_iters=4, n_layers=2)
FSDP_MODEL = {**MODEL, "n_layers": FSDP["n_layers"]}


def fsdp_args(rank: int, world: int, *extra: str):
    return trainer_args("--parallel", "fsdp", "--num-nodes", str(world), "--rank", str(rank),
                        "--attn", "auto", "--seq-len", str(FSDP["seq_len"]), "--batch-size",
                        str(FSDP["batch_size"]), "--n-layers", str(FSDP["n_layers"]), *extra,
                        iters=FSDP["max_iters"])


def fsdp_rank(rank: int, world: int, init_method: str, ckdir: str) -> dict:
    """One rank of the fsdp path: cli.lm's build and train_epoch, the launch
    counts zeroed just before and read just after, once with the sync step
    and once with --overlap-update; the gathered parameters' digest after
    each; the sync run's final FSDPState saved under ShardSpec("fsdp", W, n)
    into ``ckdir`` (gathered, rank 0 writes), beside digests of its logical
    prefixes; then on rank 0, after its last collective, the one-process dp
    run (dense attention) from the same seed and batches, compared leaf by
    leaf with the gathered parameters, and the flat_ckpt checks of that
    checkpoint (``flat_ckpt_lm``)."""
    import hashlib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.parallel.fsdp import fsdp_memory_footprint
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec
    from distributed_machine_learning_tpu_torch.train.checkpoint import save_checkpoint
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    out: dict = {}
    final = None
    try:
        for mode, extra in (("sync", ()), ("overlap", ("--overlap-update",))):
            args = fsdp_args(rank, world, *extra)
            step, state, place, model = lm.build(args, ctx)
            losses: list = []
            run = recorded(step, losses)
            run.pop_gather_seconds = getattr(step, "pop_gather_seconds", None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            state, timer = train_epoch(run, state, lm.synthetic_batches(args),
                                       place_batch=place, max_iters=args.max_iters)
            torch.cuda.synchronize()
            launches = dict(build.launches)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            params = step.params_fn(state)
            if mode == "overlap":
                step.close()
            n_params = sum(p.numel() for p in params.values())
            out[mode] = {
                "launches": launches, "losses": [float(x) for x in losses],
                "times": timer.times, "gather_s": timer.param_gather_s, "steps": state.step,
                "peak_gb": peak_gb, "attn": model.attn_impl, "digest": param_digest(
                    torch, params.values()),
                "moment_bytes": sum(t.numel() * t.element_size()
                                    for t in state.momentum_shards.values()),
                "shard": state.param_shard.numel(),
                "memory": fsdp_memory_footprint(n_params, world)}
            out.update(backend=ctx.backend, wire=ctx.comm.wire, device=str(ctx.device))
            if mode == "sync" and rank == 0:
                final = {k: v.to("cpu", copy=True) for k, v in params.items()}
            if mode == "sync":  # the flat_ckpt phase's LM checkpoint
                saved = {"n": n_params, "params": hashlib.sha256(torch.cat(
                    [v.reshape(-1) for v in params.values()]).cpu().numpy().tobytes())
                    .hexdigest()}
                t0 = time.perf_counter()
                path = save_checkpoint(ckdir, state, shard_spec=ShardSpec("fsdp", world,
                                                                          n_elems=n_params),
                                       comm=ctx.comm)
                out["flat_save_s"] = time.perf_counter() - t0
            del step, state, place, model, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ctx.shutdown()
    if rank == 0:
        out["dp"] = fsdp_dp_compare(torch, final)
        out["flat_ckpt"] = flat_ckpt_lm(torch, build, path, final, saved)
    return out


def fsdp_dp_compare(torch, final: dict) -> dict:
    """--parallel dp on one process (dense attention, the same seeded
    weights and batches as the fsdp path): its step-0 loss, and each leaf of
    the fsdp run's gathered parameters ``final`` against dp's, as the
    difference over dp's update of the leaf (from the initial weights)."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    args = trainer_args("--attn", "dense", "--seq-len", str(FSDP["seq_len"]),
                        "--batch-size", str(FSDP["batch_size"]), "--n-layers",
                        str(FSDP["n_layers"]), iters=FSDP["max_iters"])
    step, state, place, model = lm.build(args)
    init = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    losses: list = []
    train_epoch(recorded(step, losses), state, lm.synthetic_batches(args), place_batch=place,
                max_iters=args.max_iters)
    err = {}
    for k, p in model.named_parameters():
        q = p.detach().cpu()
        err[k] = float((final[k] - q).norm() / (q - init[k]).norm().clamp_min(1e-30))
    worst = max(err, key=err.get)
    return {"losses": [float(x) for x in losses], "worst": (worst, err[worst]),
            "median": sorted(err.values())[len(err) // 2]}


def run_fsdp(torch, rows: dict, card: str) -> list:
    """The fsdp path (FSDP) in its ranks.  Gates: on every rank and in both
    runs K7 launched once a step (one flat shard) and K1-K3 and K11-K13
    never (dense attention); the overlap run's gathered parameters bit for
    bit the sync run's, and every rank's the same; losses finite and
    falling; each rank's moments at fsdp_memory_footprint's 1/W of dp's
    bytes; the gathered parameters against the one-process dp run (each
    leaf's difference over dp's update within TRAIN_UPDATE_TOL, the
    step-0 loss within TRAIN_LOSS_TOL); the flat_ckpt gates of the saved
    state (``report_flat_ckpt_lm``).  Reports step ms of both runs, the
    overlapped gathers' seconds (param_gather_s) and peak memory a rank.
    Returns each rank's sync-run peak memory (GB) for the fsdp_pl gate."""
    import shutil
    import tempfile

    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    world, n = FSDP["world"], FSDP["max_iters"]
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="flat_ckpt_", dir=build_dir)
    t0 = time.perf_counter()
    try:
        ranks = spawn(fsdp_rank, world, (ckdir,), timeout_s=900)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    r0 = ranks[0]
    failed = []
    log(f"fsdp: world {world} x B {FSDP['batch_size']} x L {FSDP['seq_len']} (B "
        f"{FSDP['batch_size'] // world} a rank), attn {r0['sync']['attn']}, backend "
        f"{r0['backend']}, wire {r0['wire']}, {r0['device']}; flat shard "
        f"{r0['sync']['shard']} f32 a rank; {time.perf_counter() - t0:.1f} s with process start")
    for r, out in enumerate(ranks):
        for mode in ("sync", "overlap"):
            o = out[mode]
            want = {name: 0 for name in (*RING_KERNELS, *FLASH_KERNELS)}
            want["fused_adamw"] = n
            got = {k: o["launches"][k] for k in want}
            mem = o["memory"]
            mem_ok = (o["moment_bytes"] == mem["fsdp"]
                      and mem["fsdp"] * world - mem["replicated"] < 8 * world)
            log(f"fsdp rank {r} {mode}: launches over {n} steps {got} (want {want}); moments "
                f"{o['moment_bytes'] / 1e9:.3f} GB a rank vs dp's {mem['replicated'] / 1e9:.3f} "
                f"(fsdp_memory_footprint {mem['fsdp'] / 1e9:.3f}); peak memory "
                f"{o['peak_gb']:.2f} GB; step ms {spread([t * 1e3 for t in o['times']])}"
                + (f"; param_gather_s {[round(g, 4) for g in o['gather_s']]}"
                   if mode == "overlap" else ""))
            if got != want:
                failed.append(f"rank {r} {mode} launches")
            if not mem_ok:
                failed.append(f"rank {r} {mode} moment bytes")
            if mode == "overlap" and len(o["gather_s"]) != n - 1:
                failed.append(f"rank {r}: {len(o['gather_s'])} overlapped gathers reported")
    sync, over = r0["sync"], r0["overlap"]
    losses = sync["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and sync["steps"] == n and abs(losses[0] - math.log(MODEL["vocab_size"])) < 1.5):
        failed.append(f"losses {losses}")
    digests = {out[m]["digest"] for out in ranks for m in ("sync", "overlap")}
    log(f"fsdp: losses {[round(x, 4) for x in losses]} (overlap "
        f"{[round(x, 4) for x in over['losses']]}); gathered parameters bit for bit equal "
        f"across ranks and between the sync and overlap runs: {len(digests) == 1}")
    if len(digests) != 1 or over["losses"] != losses:
        failed.append("the overlap run or a rank differs from the sync run")
    dp = r0["dp"]
    loss_diff = abs(dp["losses"][0] - losses[0])
    (leaf, worst), median = dp["worst"], dp["median"]
    log(f"fsdp vs one-process dp (dense, same weights and batches): step-0 loss "
        f"{losses[0]:.6f} vs {dp['losses'][0]:.6f} (diff {loss_diff:.3e}, tol "
        f"{TRAIN_LOSS_TOL:g}); params after {n} steps, diff / dp's update: worst {worst:.3e} "
        f"({leaf}), median {median:.3e} (tol {TRAIN_UPDATE_TOL:g})")
    if not (loss_diff <= TRAIN_LOSS_TOL and worst <= TRAIN_UPDATE_TOL):
        failed.append("fsdp vs dp")
    tokens = FSDP["batch_size"] * FSDP["seq_len"]
    for mode in ("sync", "overlap"):
        ms = [t * 1e3 for t in r0[mode]["times"]]
        log(f"fsdp {mode}: step ms (rank 0, iteration 0 untimed) {spread(ms)} -> "
            f"{tokens / sorted(ms)[len(ms) // 2] * 1e3:.0f} tokens/s")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["fsdp_launches"] = sum(out[m]["launches"][name] for out in ranks
                                   for m in ("sync", "overlap"))
        if key == "fused_adamw:fsdp":
            row["launches"] = row["fsdp_launches"]
        row["flat_ckpt_launches"] = r0["flat_ckpt"]["launches"].get(name, 0)
    if failed:
        raise AssertionError("fsdp: " + "; ".join(failed))
    log(f"flat_ckpt: the fsdp LM state saved (W {world}, gathered) in "
        f"{r0['flat_save_s']:.3f} s")
    report_flat_ckpt_lm(r0["flat_ckpt"], card)
    return [out["sync"]["peak_gb"] for out in ranks]


def card_device(torch):
    """The card the main process and rank 0 of a shared-card run use."""
    return torch.device("cuda", 0)


# ZeRO-1 and FSDP's CNN step (step 12): VGG-11 of the BN-free parts (2a/2b:
# 9,225,610 parameters, 18 leaves) at their per-rank batch, AdamW with the
# fused update, 2 ranks sharing the card.  Rank 1's slice of ZeRO-1's
# replicated vector starts at 4,612,805 f32: off a 16-byte boundary.
FLAT_CNN = dict(model="vgg11", world=2, per_rank=64, steps=4)
# Against the one-process replicated step (train/step.py, one backward pass
# over the global batch of 128): each step's loss within 1e-5 relative (the
# CNN tests' tolerance), each leaf's first gradient within TRAIN_GRAD_TOL
# (relative L2) of the ranks' reduce-scattered mean, and the parameters leaf
# by leaf, the difference over the replicated run's update within
# TRAIN_UPDATE_TOL (as fsdp_dp_compare).  Against the same step with the
# gradient taken as the ranks take it (a backward pass over each rank's 64
# images, summed and divided by W: flat_cnn_two_pass): the first gradient
# and the parameters after the steps elementwise within the CNN tests'
# rtol 1e-4 / atol 1e-6.  The first pair shows the cause of the elementwise
# gap to the one-pass step: cuDNN reduces 128 images in one call where the
# ranks sum two calls of 64, and AdamW's normalized step magnifies that
# where a gradient is ~1e-8 (PERF.md, Findings).
FLAT_CNN_LOSS_RTOL, FLAT_CNN_RTOL, FLAT_CNN_ATOL = 1e-5, 1e-4, 1e-6


def flat_cnn_batches(torch, device):
    """FLAT_CNN["steps"] global batches of the synthetic CIFAR-10 stand-in,
    on ``device``: (images uint8, labels long) each."""
    from distributed_machine_learning_tpu_torch.data.cifar10 import load_cifar10

    data = load_cifar10(root=str(Path(__file__).resolve().parent / "build" / "no_cifar"))
    b = FLAT_CNN["world"] * FLAT_CNN["per_rank"]
    return [(torch.from_numpy(data.images[i * b:(i + 1) * b]).to(device),
             torch.from_numpy(data.labels[i * b:(i + 1) * b]).to(device).long())
            for i in range(FLAT_CNN["steps"])]


def flat_cnn_state(torch, device, fused: bool = True):
    """FLAT_CNN's model (weights from cli.common's SEED) and a fresh AdamW
    TrainState."""
    from distributed_machine_learning_tpu_torch.cli.common import SEED
    from distributed_machine_learning_tpu_torch.models.registry import get_model, init_params
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = init_params(get_model(FLAT_CNN["model"], device=device), SEED)
    return model, TrainState.create(model, AdamWConfig(fused=fused))


def flat_cnn_rank(rank: int, world: int, init_method: str, ckdir: str) -> dict:
    """One rank of the zero1 and fsdp_cnn paths: for each scheme a sync run
    and an overlap run of FLAT_CNN["steps"] steps, the launch counts zeroed
    just before and read just after each; fsdp once more with a rebound
    state after 2 steps (a prefetch miss); each sync run's first
    reduce-scattered mean gradient, gathered whole; the zero1 sync run's
    final state saved under ShardSpec("zero1", W, n) (gathered, rank 0
    writes).  On rank 0, after its last collective: the one-process
    replicated step (train/step.py) and the two-pass one
    (flat_cnn_two_pass) on the global batches from the same weights."""
    import hashlib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the bitwise gates: one conv algorithm
    torch.backends.cudnn.benchmark = False
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.parallel import fsdp, zero1
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    comm, dev = ctx.comm, ctx.device
    batches = flat_cnn_batches(torch, dev)
    lo, hi = rank * FLAT_CNN["per_rank"], (rank + 1) * FLAT_CNN["per_rank"]
    out: dict = {"backend": ctx.backend, "wire": comm.wire, "device": str(dev)}
    final: dict = {}
    grads: dict = {}
    reduce_scatter, first = comm.reduce_scatter, []

    def first_grad(t):
        """The comm's reduce-scatter, keeping its first result: the step's
        gradient shard, divided by W in place by its caller."""
        shard = reduce_scatter(t)
        if not first:
            first.append(shard)
        return shard

    try:
        for scheme in ("zero1", "fsdp"):
            for mode in ("sync", "overlap", "miss"):
                if scheme == "zero1" and mode == "miss":
                    continue
                model, state = flat_cnn_state(torch, dev)
                shard, make = ((zero1.shard_zero1_state, zero1.make_zero1_train_step)
                               if scheme == "zero1" else
                               (fsdp.shard_fsdp_state, fsdp.make_fsdp_train_step))
                fstate, unravel, n = shard(state, comm)
                step = make(model, comm, unravel, n, augment=False, overlap=mode != "sync")
                losses, times, gathers = [], [], []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                build.reset_launch_counts()
                first.clear()
                comm.reduce_scatter = first_grad
                for i, (x, y) in enumerate(batches):
                    if mode == "miss" and i == 2:  # a rebound state: new tensors, same values
                        fstate = fsdp.FSDPState(
                            fstate.param_shard.clone(),
                            {k: v.clone() for k, v in fstate.momentum_shards.items()},
                            fstate.step, fstate.config, dict(fstate.batch_stats))
                    t0 = time.perf_counter()
                    fstate, loss = step(fstate, x[lo:hi], y[lo:hi])
                    losses.append(float(loss))
                    times.append(time.perf_counter() - t0)
                    g = getattr(step, "pop_gather_seconds", lambda: None)()
                    if g is not None:
                        gathers.append(g)
                full = step.join(fstate) if mode != "sync" else None
                torch.cuda.synchronize()
                launches = dict(build.launches)
                del comm.reduce_scatter
                if mode == "sync":
                    whole = unravel(comm.all_gather_flat(first[0])[:n])
                    if rank == 0:
                        grads[scheme] = {k: v.cpu() for k, v in whole.items()}
                    del whole
                params = (zero1.zero1_params(fstate, unravel, n) if scheme == "zero1"
                          else fsdp.gather_fsdp_params(fstate, unravel, n, comm, full=full))
                if mode != "sync":
                    step.close()
                flat = torch.cat([v.reshape(-1) for v in params.values()])
                moments = fstate.momentum_shards
                out[f"{scheme}:{mode}"] = {
                    "losses": losses, "times": times, "gather_s": gathers, "steps": fstate.step,
                    "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "digest": hashlib.sha256(flat.view(torch.int32).cpu().numpy()
                                             .tobytes()).hexdigest(),
                    "moment_bytes": sum(t.numel() * t.element_size() for t in moments.values()),
                    "flat_bytes": (fstate.param_flat if scheme == "zero1"
                                   else fstate.param_shard).numel() * 4,
                    "shard": n // world + (n % world > 0),
                    "memory": zero1.zero1_memory_footprint(n, world)}
                if mode == "sync" and rank == 0:
                    final[scheme] = {k: v.cpu() for k, v in params.items()}
                if scheme == "zero1" and mode == "sync":
                    t0 = time.perf_counter()
                    spec = ShardSpec("zero1", world, n_elems=n)
                    path = ck.save_checkpoint(ckdir, fstate, shard_spec=spec, comm=comm)
                    out["zero1_save_s"] = time.perf_counter() - t0
                    out["zero1_ckpt"] = (path, n, hashlib.sha256(
                        torch.cat([comm.all_gather_flat(v)[:n] for v in moments.values()])
                        .cpu().numpy().tobytes()).hexdigest(),
                        hashlib.sha256(fstate.param_flat[:n].cpu().numpy().tobytes())
                        .hexdigest())
                del model, state, fstate, step, params, flat
                first.clear()
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        ctx.shutdown()
    if rank == 0:
        out["replicated"] = flat_cnn_replicated(torch, dev, batches, final, grads)
    return out


def flat_cnn_two_pass(torch, dev, batches):
    """The replicated step with the global batch's gradient taken as the
    ranks take it: a backward pass over each rank's rows, the W gradients
    summed and divided by W (the reduce-scatter's mean), then the same
    fused AdamW update leaf by leaf.  Returns (its first gradient, its
    parameters after the batches), by name on the host."""
    from distributed_machine_learning_tpu_torch.data.augment import normalize
    from distributed_machine_learning_tpu_torch.train.losses import cross_entropy_loss
    from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config

    model, state = flat_cnn_state(torch, dev)
    world, per = FLAT_CNN["world"], FLAT_CNN["per_rank"]
    update = update_fn_for_config(state.config)
    first = None
    for images_u8, labels in batches:
        x, total = normalize(images_u8), None
        for r in range(world):
            model.zero_grad(set_to_none=True)
            rows = slice(r * per, (r + 1) * per)
            cross_entropy_loss(model(x[rows], train=True), labels[rows]).backward()
            g = {k: p.grad for k, p in model.named_parameters()}
            total = g if total is None else {k: total[k] + g[k] for k in g}
        model.zero_grad(set_to_none=True)
        grads = {k: v.div_(world) for k, v in total.items()}
        if first is None:
            first = {k: v.cpu() for k, v in grads.items()}
        with torch.no_grad():
            update(state.params, state.momentum, grads, state.config, step=state.step)
        state.step += 1
    return first, {k: p.detach().cpu() for k, p in model.named_parameters()}


def _allclose_report(torch, got: dict, want: dict) -> dict:
    """Whether every leaf of ``got`` is within FLAT_CNN_RTOL / FLAT_CNN_ATOL
    of ``want``, and the worst element's excess over the rtol term."""
    excess = {k: float(((got[k] - w).abs() - FLAT_CNN_RTOL * w.abs()).max())
              for k, w in want.items()}
    elem = max(excess, key=excess.get)
    return {"allclose": all(torch.allclose(got[k], w, rtol=FLAT_CNN_RTOL, atol=FLAT_CNN_ATOL)
                            for k, w in want.items()), "elem": (elem, excess[elem])}


def _worst_rel(got: dict, want: dict):
    """The leaf with the largest relative L2 difference, and that difference."""
    rel = {k: float((got[k] - w).norm() / w.norm().clamp_min(1e-30)) for k, w in want.items()}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def flat_cnn_replicated(torch, dev, batches, final: dict, grads: dict) -> dict:
    """The references of each scheme's sync run, from the same weights over
    the global batches.  The one-process replicated mean step (train/step.py,
    world 1): its losses; each scheme's first gradient against its first
    (the worst leaf's relative L2) and its parameters (each leaf's
    difference over the replicated run's update, the worst leaf).  The
    two-pass step (flat_cnn_two_pass): the first gradient and the
    parameters elementwise at the CNN tests' tolerances; and its first
    gradient against the one-pass one (the cause of their gap)."""
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    model, state = flat_cnn_state(torch, dev)
    init = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    step = make_train_step(model, augment=False)
    one_grad = {}

    def keep_first(synced, _res):
        if not one_grad:
            one_grad.update({k: g.cpu() for (k, _), g in zip(model.named_parameters(), synced)})

    step.observe = keep_first
    losses = [float(step(state, x, y)[1]) for x, y in batches]
    ref = {k: p.detach().cpu() for k, p in model.named_parameters()}
    two_grad, two_params = flat_cnn_two_pass(torch, dev, batches)
    out = {"losses": losses, "two_vs_one_grad": _worst_rel(two_grad, one_grad),
           "two_vs_one_params": _allclose_report(torch, two_params, ref)}
    for scheme, params in final.items():
        rel = {k: float((params[k] - w).norm() / (w - init[k]).norm().clamp_min(1e-30))
               for k, w in ref.items()}
        worst = max(rel, key=rel.get)
        out[scheme] = {"update": (worst, rel[worst]),
                       "one_pass": _allclose_report(torch, params, ref),
                       "grad_one": _worst_rel(grads[scheme], one_grad),
                       "grad_two": _allclose_report(torch, grads[scheme], two_grad),
                       "two_pass": _allclose_report(torch, params, two_params)}
    return out


def run_flat_cnn(torch, rows: dict, ckdir: str) -> dict:
    """The zero1 and fsdp_cnn paths (FLAT_CNN) in their ranks.  Gates: K7
    launched steps × 1 a rank in every run (one flat shard; rank 1's slice
    misaligned in ZeRO-1's replicated vector); the overlap runs (and fsdp's
    prefetch miss after a rebind) bit for bit the sync runs; each rank's
    moment bytes at zero1_memory_footprint's (two AdamW moment shards, the
    fsdp entry) and ZeRO-1's replicated vector plus one shard at its zero1
    entry; against the one-pass and the two-pass replicated steps as
    FLAT_CNN_RTOL's note says.  Returns the zero1 checkpoint's record for
    the flat_ckpt phase."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    world, n = FLAT_CNN["world"], FLAT_CNN["steps"]
    t0 = time.perf_counter()
    ranks = spawn(flat_cnn_rank, world, (ckdir,), timeout_s=900)
    r0, failed = ranks[0], []
    log(f"zero1/fsdp_cnn: {FLAT_CNN['model']} (BN-free), W {world} x B {FLAT_CNN['per_rank']} "
        f"a rank, AdamW fused, backend {r0['backend']}, wire {r0['wire']}, {r0['device']}; "
        f"flat shard {r0['zero1:sync']['shard']} f32 a rank; "
        f"{time.perf_counter() - t0:.1f} s with process start")
    for r, out in enumerate(ranks):
        for run in ("zero1:sync", "zero1:overlap", "fsdp:sync", "fsdp:overlap", "fsdp:miss"):
            o = out[run]
            got = {k: o["launches"][k] for k in ("fused_adamw", *FLASH_KERNELS)}
            want = {"fused_adamw": n, **{k: 0 for k in FLASH_KERNELS}}
            mem = o["memory"]
            mem_ok = o["moment_bytes"] == mem["fsdp"] and (
                not run.startswith("zero1")
                or o["flat_bytes"] + o["moment_bytes"] // 2 == mem["zero1"])
            log(f"{run} rank {r}: launches {got} (want {want}); moments "
                f"{o['moment_bytes'] / 1e6:.3f} MB a rank (footprint: fsdp "
                f"{mem['fsdp'] / 1e6:.3f}, zero1 {mem['zero1'] / 1e6:.3f}, replicated "
                f"{mem['replicated'] / 1e6:.3f}); peak memory {o['peak_gb']:.3f} GB; step ms "
                f"{spread([t * 1e3 for t in o['times'][1:]])}"
                + (f"; param_gather_s {[round(g, 4) for g in o['gather_s']]}"
                   if o["gather_s"] else ""))
            if got != want:
                failed.append(f"rank {r} {run} launches")
            if not mem_ok:
                failed.append(f"rank {r} {run} memory")
            if o["steps"] != n:
                failed.append(f"rank {r} {run} steps {o['steps']}")
        for scheme in ("zero1", "fsdp"):
            sync = out[f"{scheme}:sync"]
            for mode in ("overlap", "miss") if scheme == "fsdp" else ("overlap",):
                o = out[f"{scheme}:{mode}"]
                if o["digest"] != sync["digest"] or o["losses"] != sync["losses"]:
                    failed.append(f"rank {r} {scheme} {mode} differs from the sync run")
    rep = r0["replicated"]
    tol = f"rtol {FLAT_CNN_RTOL:g} / atol {FLAT_CNN_ATOL:g}"

    def close(c):
        return f"{c['allclose']} (worst |diff| - rtol·|x| {c['elem'][1]:.3e}, {c['elem'][0]})"

    (g_leaf, g_rel), c = rep["two_vs_one_grad"], rep["two_vs_one_params"]
    log(f"the two-pass step (2 x 64 images summed, / 2) vs the one-pass replicated step "
        f"(train/step.py, B {world * FLAT_CNN['per_rank']}): first gradient, worst leaf "
        f"{g_rel:.3e} relative L2 ({g_leaf}); params after {n} steps within {tol}: {close(c)}")
    for scheme in ("zero1", "fsdp"):
        losses = r0[f"{scheme}:sync"]["losses"]
        loss_ok = all(abs(a - b) <= FLAT_CNN_LOSS_RTOL * abs(b)
                      for a, b in zip(losses, rep["losses"]))
        c = rep[scheme]
        (leaf, worst), (g_leaf, g_rel) = c["update"], c["grad_one"]
        log(f"{scheme} vs the one-pass replicated step: losses "
            f"{[round(x, 6) for x in losses]} vs {[round(x, 6) for x in rep['losses']]} (rtol "
            f"{FLAT_CNN_LOSS_RTOL:g}): {loss_ok}; first reduce-scattered gradient, worst leaf "
            f"{g_rel:.3e} relative L2 ({g_leaf}; tol {TRAIN_GRAD_TOL:g}); params after {n} "
            f"steps, diff / the replicated update: worst {worst:.3e} ({leaf}; tol "
            f"{TRAIN_UPDATE_TOL:g}); within {tol}: {close(c['one_pass'])}")
        log(f"{scheme} vs the two-pass step: first reduce-scattered gradient within {tol}: "
            f"{close(c['grad_two'])}; params after {n} steps within {tol}: "
            f"{close(c['two_pass'])}")
        if not (loss_ok and worst <= TRAIN_UPDATE_TOL and g_rel <= TRAIN_GRAD_TOL
                and all(math.isfinite(x) for x in losses)):
            failed.append(f"{scheme} vs the replicated step")
        if not (c["grad_two"]["allclose"] and c["two_pass"]["allclose"]):
            failed.append(f"{scheme} vs the two-pass step")
        if not all(o[f"{scheme}:overlap"]["digest"] == o[f"{scheme}:sync"]["digest"]
                   for o in ranks):
            failed.append(f"{scheme} overlap")
    log(f"fsdp prefetch miss after a rebind: bit for bit the sync run: "
        f"{all(o['fsdp:miss']['digest'] == o['fsdp:sync']['digest'] for o in ranks)}")
    for key, row in rows.items():
        name = key.split(":")[0]
        for scheme in ("zero1", "fsdp"):
            row[f"{scheme}_cnn_launches"] = sum(
                out[f"{scheme}:{m}"]["launches"].get(name, 0) for out in ranks
                for m in ("sync", "overlap", "miss") if f"{scheme}:{m}" in out)
        if key == "fused_adamw:flat_cnn":
            row["launches"] = row["zero1_cnn_launches"] + row["fsdp_cnn_launches"]
    if failed:
        raise AssertionError("zero1/fsdp_cnn: " + "; ".join(failed))
    log(f"zero1 checkpoint save (W {world}, gathered): {r0['zero1_save_s']:.3f} s")
    return {"path": r0["zero1_ckpt"][0], "n": r0["zero1_ckpt"][1],
            "moments": r0["zero1_ckpt"][2], "params": r0["zero1_ckpt"][3]}


def flat_ckpt_zero1(torch, rec: dict) -> None:
    """The zero1 checkpoint at worlds 1 and 4: the logical prefixes bit for
    bit the saved ones (digests taken before the save); then a byte flipped
    in its largest file is caught and the checkpoint quarantined."""
    import hashlib

    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    n, failed = rec["n"], []
    for world in (1, 4):
        t0 = time.perf_counter()
        state, spec = ck.reshard_restore(rec["path"], world=world)
        s = time.perf_counter() - t0
        params = hashlib.sha256(state.param_flat[:n].numpy().tobytes()).hexdigest()
        moments = hashlib.sha256(torch.cat([v[:n] for v in state.momentum_shards.values()])
                                 .numpy().tobytes()).hexdigest()
        ok = params == rec["params"] and moments == rec["moments"] and spec.world == world
        log(f"flat_ckpt zero1 -> world {world}: logical prefixes bit for bit the saved ones: "
            f"{ok} ({s:.3f} s, padded length {state.param_flat.numel()})")
        if not ok:
            failed.append(f"zero1 reshard to world {world}")
    flip_byte(rec["path"])
    try:
        ck.reshard_restore(rec["path"], world=4)
        failed.append("a flipped byte was not caught")
    except ck.CheckpointVerifyError as exc:
        reason = ck.quarantine_reason(rec["path"])
        log(f"flat_ckpt zero1 with a flipped byte: caught ({str(exc)[:120]}...), quarantined: "
            f"{reason is not None}")
        if reason is None:
            failed.append("not quarantined")
    if failed:
        raise AssertionError("flat_ckpt: " + "; ".join(failed))


def flip_byte(step_dir: str) -> None:
    """Flip one byte in the middle of the largest file under ``state/``."""
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    fp = max((f for f in Path(step_dir, "state").rglob("*") if f.is_file()),
             key=lambda f: f.stat().st_size)
    with open(fp, "r+b") as f:
        f.seek(fp.stat().st_size // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    ck.forget_validated(step_dir)


def flat_ckpt_lm(torch, build, path: str, final: dict, saved: dict) -> dict:
    """The flat fsdp LM checkpoint (on rank 0 of the fsdp phase, after its
    group is down): reshard_restore at world 4, and at world 1 the restore
    load_serving_weights makes, give the saved logical prefixes bit for bit
    (the manifest's logical digests, taken from the bytes the save wrote,
    and the parameters' digest taken in memory before the save);
    load_serving_weights unravels it through the model's parameters, and
    the int8 model it loads serves the same greedy tokens as the gathered
    parameters quantized directly."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from distributed_machine_learning_tpu_torch.data.text import encode_prompt
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm_params
    from distributed_machine_learning_tpu_torch.runtime import deploy
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    n = saved["n"]
    leaves = ck.checkpoint_manifest(path)["leaves"]
    want = {"param_shards": leaves["param_shards"]["sha256"],
            "mu": leaves["momentum_shards/mu"]["sha256"],
            "nu": leaves["momentum_shards/nu"]["sha256"]}

    def prefixes_equal(state) -> bool:
        vecs = {"param_shards": state.param_shard, **state.momentum_shards}
        with ThreadPoolExecutor(3) as pool:  # hashlib releases the interpreter lock
            got = dict(zip(vecs, pool.map(
                lambda t: hashlib.sha256(memoryview(t[:n].numpy()).cast("B")).hexdigest(),
                vecs.values())))
        return got == want and got["param_shards"] == saved["params"]

    out: dict = {}
    t0 = time.perf_counter()
    state, _ = ck.reshard_restore(path, world=4)
    out["world4"] = (prefixes_equal(state), time.perf_counter() - t0, state.param_shard.numel())
    del state
    restored = []
    real = deploy.reshard_restore

    def kept(*a, **k):
        res = real(*a, **k)
        restored.append(res[0])
        return res

    deploy.reshard_restore = kept
    try:
        t0 = time.perf_counter()
        loaded = deploy.load_serving_weights(path, final)
        out["load_s"] = time.perf_counter() - t0
    finally:
        deploy.reshard_restore = real
    out["world1"] = (prefixes_equal(restored[0]), None, restored[0].param_shard.numel())
    del restored
    device = card_device(torch)
    prompt = torch.tensor([encode_prompt(CKPT_PROMPT, MODEL["vocab_size"])])
    tokens = {}
    build.reset_launch_counts()
    for label, qparams in (("checkpoint", loaded["quantized"]),
                           ("direct", quantize_lm_params(final))):
        model = TransformerLM(**FSDP_MODEL, compute_dtype=torch.bfloat16, weight_quant="int8",
                              device=device)
        model.load_state_dict(qparams)
        fn = make_generate_fn(model.eval(), CKPT_NEW_TOKENS, temperature=0.0, quantize="int8")
        got = fn(prompt, torch.Generator(device=device).manual_seed(0))[0, prompt.shape[1]:]
        tokens[label] = got.tolist()
        del model, fn
    torch.cuda.synchronize()
    out["launches"] = dict(build.launches)
    out["tokens_equal"] = tokens["checkpoint"] == tokens["direct"]
    out["n_tokens"] = len(tokens["checkpoint"])
    out["digest_equal"] = loaded["meta"]["digest"] == deploy.tree_digest(
        quantize_lm_params(final))
    return out


def report_flat_ckpt_lm(rec: dict, card: str) -> None:
    failed = []
    for world in (1, 4):
        ok, s, padded = rec[f"world{world}"]
        log(f"flat_ckpt fsdp LM -> world {world} [{card}]: logical prefixes bit for bit the "
            f"saved ones: {ok} ("
            + (f"{s:.3f} s, " if s is not None else "load_serving_weights' restore, ")
            + f"padded length {padded})")
        if not ok:
            failed.append(f"world {world}")
    log(f"flat_ckpt load_serving_weights (fsdp LM, world 1, unraveled through the model's "
        f"parameters) [{card}]: {rec['load_s']:.3f} s; quantized digest equal to the gathered "
        f"params' quantized directly: {rec['digest_equal']}; greedy tokens equal: "
        f"{rec['tokens_equal']} ({rec['n_tokens']} tokens); launches {rec['launches']}")
    if not (rec["tokens_equal"] and rec["digest_equal"]):
        failed.append("load_serving_weights")
    for name in ("flash_fwd", "quant_matmul"):
        if rec["launches"].get(name, 0) == 0:
            failed.append(f"{name} never launched serving the checkpoint")
    if failed:
        raise AssertionError("flat_ckpt: " + "; ".join(failed))


# Per-layer FSDP (step 13): cli.lm --parallel fsdp_pl at full width, FSDP's
# shape (W 2 sharing the card, B 4 x L 2048), flash attention, fused AdamW:
# 2 + 2 steps uninterrupted, then --ckpt-dir for 2 and --resume for 2.
def fsdp_pl_args(rank: int, world: int, *extra: str):
    return trainer_args("--parallel", "fsdp_pl", "--num-nodes", str(world), "--rank", str(rank),
                        "--attn", "flash", "--seq-len", str(FSDP["seq_len"]), "--batch-size",
                        str(FSDP["batch_size"]), "--n-layers", str(FSDP["n_layers"]), *extra,
                        iters=CKPT_STEPS)


def fsdp_pl_rank(rank: int, world: int, init_method: str, ckdir: str, card: str) -> dict:
    """One rank of the fsdp_pl path: cli.lm's run with --ckpt-dir for
    CKPT_STEPS steps (it saves step_2), its state then trained in the same
    process for CKPT_STEPS more over the same synthetic batches (what a
    resumed process sees): the uninterrupted run, whose launch counts are
    zeroed just before and read just after, beside its peak memory; then
    cli.lm's run with --resume for CKPT_STEPS, whose final gathered
    parameters must be the uninterrupted run's.  Through the uninterrupted
    run, at every backward's start, how many of the step's gathered leaves
    are still alive; on rank 0, the first step's gradient as it holds it
    (each split leaf's reduce-scattered block).  On rank 0, after its group
    is down: the
    one-process dp run (flash) over the same batches, compared leaf by leaf,
    and cli.generate --ckpt-dir on the resumed run's checkpoint
    (``ckpt_generate_leg``)."""
    from types import SimpleNamespace

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
        fsdp_pl_sharded_fraction,
        gather_fsdp_pl_params,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    out: dict = {"backend": ctx.backend, "wire": ctx.comm.wire, "device": str(ctx.device)}
    final = None
    real_build, built, losses, times = lm.build, [], [], []
    real_backward, resident, grads0 = torch.Tensor.backward, [], {}

    def first_grads(model) -> None:
        """Rank 0's first-step gradient on the host, with each leaf's split
        dimension: a split leaf's block (the mean over the ranks' rows), a
        replicated leaf whole."""
        if rank == 0:
            grads0["dims"] = dict(model.fsdp_pl.dims)
            grads0["grads"] = {name: p.grad.to("cpu", copy=True)
                               for name, p in model.named_parameters()}

    def build_recorded(*a, **k):
        """cli.lm's build, its step recording each loss and step time (the
        host clock to the loss sync)."""
        step, state, place, model = real_build(*a, **k)

        def run(s, x, y):
            t0 = time.perf_counter()
            s, loss = step(s, x, y)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            if len(losses) == 1:
                first_grads(model)
            return s, loss

        run.params_fn = step.params_fn
        built.append((run, state, place, model))
        return built[-1]

    def backward(loss, *a, **k):
        """At the backward's start: the step's gathered leaves still alive
        (held by a module or the graph), and the live table's entries (one a
        storage the forward's gathers used)."""
        live = built[-1][3].fsdp_pl.live.values()
        resident.append((sum(ref() is not None for ref, _ in live), len(live)))
        return real_backward(loss, *a, **k)

    lm.build = build_recorded
    torch.Tensor.backward = backward
    try:
        args = fsdp_pl_args(rank, world, "--ckpt-dir", ckdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_calls(ck, ("save_checkpoint",)) as ck_times:
            state, lines = captured(lm.run, args, ctx)
        out["save_run_s"] = time.perf_counter() - t0
        step, _, place, model = built[-1]
        state, _ = train_epoch(step, state, lm.synthetic_batches(args), place_batch=place,
                               max_iters=args.max_iters)
        torch.cuda.synchronize()
        torch.Tensor.backward = real_backward
        out["launches"] = dict(build.launches)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["resident"] = list(resident)
        out["losses"] = list(losses)
        out["cli_lines"] = [ln for ln in lines if ln.startswith(("Loss", "Average", "Saved"))]
        out["times"] = times[1:]  # step 0 warms up
        out["save_s"] = list(ck_times["save_checkpoint"])
        out["fraction"] = fsdp_pl_sharded_fraction(state, world)
        out["leaves"] = sum(1 for _ in model.parameters())
        out["block_elems"] = sum(p.numel() for p in model.parameters())
        params = step.params_fn(state)
        out["digest"] = param_digest(torch, params.values())
        if rank == 0:
            final = {k: v.to("cpu", copy=True) for k, v in params.items()}
        del step, state, place, model, params
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed, lines = captured(lm.run, fsdp_pl_args(rank, world, "--ckpt-dir", ckdir,
                                                       "--resume"), ctx)
        out["resume_s"] = time.perf_counter() - t0
        out["resume_lines"] = [ln for ln in lines if "Resumed" in ln or "Saved" in ln]
        out["resumed_steps"] = resumed.step
        out["resumed_digest"] = param_digest(torch, gather_fsdp_pl_params(resumed,
                                                                         ctx.comm).values())
        del resumed
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        lm.build = real_build
        torch.Tensor.backward = real_backward
        ctx.shutdown()
    if rank == 0:
        out["dp"] = fsdp_pl_dp_compare(torch, final, grads0)
        model = TransformerLM(**FSDP_MODEL, device=card_device(torch))
        model.load_state_dict(final)
        with timed_calls(ck, ("latest_checkpoint", "restore_checkpoint")) as times:
            out["generate"] = ckpt_generate_leg(torch, build, ckdir, SimpleNamespace(model=model),
                                                times, card, FSDP_MODEL)
    return out


def fsdp_pl_dp_compare(torch, final: dict, grads0: dict) -> dict:
    """--parallel dp on one process (flash, the same seeded weights, the
    same batches: two runs of CKPT_STEPS over the stream's start): its
    losses; rank 0's first gradient ``grads0`` against the same block of
    dp's first, leaf by leaf (relative L2); and each leaf of the fsdp_pl
    run's gathered parameters against dp's, as the difference over dp's
    update of the leaf."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.parallel.gspmd import block_of
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    args = trainer_args("--seq-len", str(FSDP["seq_len"]), "--batch-size",
                        str(FSDP["batch_size"]), "--n-layers", str(FSDP["n_layers"]),
                        iters=CKPT_STEPS)
    step, state, place, model = lm.build(args)
    init = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    losses: list = []
    grad_err: dict = {}

    def run(s, x, y):
        s, loss = step(s, x, y)
        if not grad_err:  # the gradients stay on the parameters until the next step
            for k, p in model.named_parameters():
                dim, q = grads0["dims"][k], p.grad.detach()
                q = (q if dim is None else block_of(q, dim, 0, FSDP["world"])).cpu()
                g = grads0["grads"][k]
                grad_err[k] = float((g - q).norm() / q.norm().clamp_min(1e-30))
        return s, loss

    for _ in range(2):
        train_epoch(recorded(run, losses), state, lm.synthetic_batches(args),
                    place_batch=place, max_iters=args.max_iters)
    err = {}
    for k, p in model.named_parameters():
        q = p.detach().cpu()
        err[k] = float((final[k] - q).norm() / (q - init[k]).norm().clamp_min(1e-30))
    worst, g_worst = max(err, key=err.get), max(grad_err, key=grad_err.get)
    return {"losses": [float(x) for x in losses], "worst": (worst, err[worst]),
            "median": sorted(err.values())[len(err) // 2],
            "grad_worst": (g_worst, grad_err[g_worst]),
            "grad_median": sorted(grad_err.values())[len(grad_err) // 2]}


def run_fsdp_pl(torch, rows: dict, flat_peaks: list, card: str) -> None:
    """The fsdp_pl path in its ranks.  Gates: on every rank K1, K2 and K3
    launched n_layers × steps and K7 leaves × steps (one a leaf a step);
    ranks bit for bit equal; the resumed run (--ckpt-dir at step 2, --resume
    to step 4) bit for bit the uninterrupted one; losses finite and
    falling; each rank's peak memory below the flat fsdp phase's at the same
    shape in this run; against one-process dp (step-0 loss within
    TRAIN_LOSS_TOL, each leaf's difference over dp's update within
    TRAIN_UPDATE_TOL; rank 0's block of the first step's reduce-scattered
    gradient, each leaf within TRAIN_GRAD_TOL of dp's same block, relative
    L2); no gathered leaf
    alive at any backward's start of the uninterrupted run (the backward
    gathers again what it needs); cli.generate --ckpt-dir from the resumed
    checkpoint (its own gates)."""
    import shutil
    import tempfile

    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    world, n = FSDP["world"], 2 * CKPT_STEPS
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="fsdp_pl_", dir=build_dir)
    t0 = time.perf_counter()
    try:
        ranks = spawn(fsdp_pl_rank, world, (ckdir, card), timeout_s=1000)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    r0, failed = ranks[0], []
    log(f"fsdp_pl: W {world} x B {FSDP['batch_size']} x L {FSDP['seq_len']}, attn flash, "
        f"backend {r0['backend']}, wire {r0['wire']}, {r0['device']}; {r0['leaves']} leaves, "
        f"{r0['block_elems']} f32 a rank ({r0['fraction']:.6f} of the elements split); "
        f"{time.perf_counter() - t0:.1f} s with process start")
    layers = FSDP["n_layers"]
    for r, out in enumerate(ranks):
        want = {"flash_fwd": layers * n, "flash_bwd_dq": layers * n,
                "flash_bwd_dkv": layers * n, "fused_adamw": out["leaves"] * n,
                **{k: 0 for k in RING_KERNELS}}
        got = {k: out["launches"].get(k, 0) for k in want}
        below = all(out["peak_gb"] < p for p in flat_peaks)
        log(f"fsdp_pl rank {r}: launches over {n} steps {got} (want {want}); peak memory "
            f"{out['peak_gb']:.2f} GB (flat fsdp's sync run, same shape: "
            f"{[round(p, 2) for p in flat_peaks]} GB): below {below}; step ms "
            f"{spread([t * 1e3 for t in out['times']])}; cli.lm --ckpt-dir run "
            f"{out['save_run_s']:.1f} s (save_checkpoint {[round(x, 3) for x in out['save_s']]}"
            f" s; {out['cli_lines']}); --resume run {out['resume_s']:.1f} s "
            f"{out['resume_lines']}")
        alive = max(a for a, _ in out["resident"])
        log(f"fsdp_pl rank {r}: at each of {len(out['resident'])} backwards' start, gathered "
            f"leaves alive / storages the forward's gathers used: "
            f"{sorted(set(out['resident']))} (want 0 alive)")
        if got != want:
            failed.append(f"rank {r} launches")
        if not below:
            failed.append(f"rank {r} peak memory {out['peak_gb']:.2f} GB not below flat fsdp's")
        if len(out["resident"]) != n or alive != 0 or min(g for _, g in out["resident"]) == 0:
            failed.append(f"rank {r}: gathered leaves resident at the backward {out['resident']}")
        if out["resumed_steps"] != n or out["resumed_digest"] != out["digest"]:
            failed.append(f"rank {r}: the resumed run differs from the uninterrupted one")
    digests = {o["digest"] for o in ranks} | {o["resumed_digest"] for o in ranks}
    losses = r0["losses"]
    log(f"fsdp_pl: losses {[round(x, 4) for x in losses]}; gathered parameters bit for bit "
        f"equal across ranks and between the uninterrupted and resumed runs: "
        f"{len(digests) == 1}")
    if len(digests) != 1:
        failed.append("ranks or the resumed run differ")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and abs(losses[0] - math.log(MODEL["vocab_size"])) < 1.5):
        failed.append(f"losses {losses}")
    dp = r0["dp"]
    loss_diff = abs(dp["losses"][0] - losses[0])
    (leaf, worst), median = dp["worst"], dp["median"]
    (g_leaf, g_worst) = dp["grad_worst"]
    log(f"fsdp_pl vs one-process dp (flash, same weights and batches): step-0 loss "
        f"{losses[0]:.6f} vs {dp['losses'][0]:.6f} (diff {loss_diff:.3e}, tol "
        f"{TRAIN_LOSS_TOL:g}); first reduce-scattered gradient (rank 0's blocks), "
        f"relative L2: worst {g_worst:.3e} ({g_leaf}), median {dp['grad_median']:.3e} (tol "
        f"{TRAIN_GRAD_TOL:g}); "
        f"params after {n} steps, diff / dp's update: worst {worst:.3e} ({leaf}), median "
        f"{median:.3e} (tol {TRAIN_UPDATE_TOL:g})")
    if not (loss_diff <= TRAIN_LOSS_TOL and worst <= TRAIN_UPDATE_TOL
            and g_worst <= TRAIN_GRAD_TOL):
        failed.append("fsdp_pl vs dp")
    tokens = FSDP["batch_size"] * FSDP["seq_len"]
    ms = [t * 1e3 for t in r0["times"]]
    log(f"fsdp_pl: step ms (rank 0, steps 1-3, the save between 1 and 2 not counted) "
        f"{spread(ms)} -> {tokens / sorted(ms)[len(ms) // 2] * 1e3:.0f} tokens/s [{card}]")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["fsdp_pl_launches"] = sum(out["launches"].get(name, 0) for out in ranks)
        row["ckpt_launches"] = row.get("ckpt_launches", 0) + r0["generate"].get(name, 0)
    if failed:
        raise AssertionError("fsdp_pl: " + "; ".join(failed))


# -- ROADMAP A5c: model parallelism (step 10b): cli.lm --parallel tp / pp / 3d
# at the model's full width, each rank a process sharing the card (gloo over
# host buffers), the seeded weights, bf16, fused AdamW, --attn flash.
# (a) tp W 2, B 2 x L 2048, 4 of the 8 layers (time limit), 3 steps; (b) pp
# W 2, B 4 x L 2048 in 4 microbatches, 4 of the 8 layers (time limit: the
# ep cells), each schedule 3 steps over
# the stream's batches 0, 1, 0 (1f1b saves at step 2 and is resumed for 1
# more by cli.lm's run; interleaved v 2 saves at step 2); (c) 3d W 4, 4
# layers, B 4 x L 2048
# in 2 microbatches, 3 steps: dp 1 x pp 2 x tp 2, dp 2 x pp 2 x tp 1 with
# --zero1-dp and without it; (d) cli.generate --ckpt-dir on the 1f1b and
# the interleaved checkpoints and on the same parameters saved in the dp
# layout, B 1 x 4096 + 32.
A5C = dict(seq_len=2048, tp_world=2, tp_batch=2, tp_layers=4, tp_steps=3, pp_world=2,
           pp_batch=4, pp_micro=4, pp_layers=4, p3_world=4, p3_batch=4, p3_micro=2,
           p3_layers=4, p3_steps=3, gen_new=32)
A5C_ORDER = {"tp": [0, 1, 2], "pp": [0, 1, 0], "3d": [0, 1, 2]}
A5C_PP = {"1f1b": ["--pp-schedule", "1f1b"], "gpipe": ["--pp-schedule", "gpipe"],
          "overlap": ["--pp-schedule", "gpipe", "--overlap-update"],
          "interleaved": ["--pp-schedule", "interleaved", "--pp-chunks", "2"]}
A5C_SAVES = ("1f1b", "interleaved")
A5C_3D = {"1x2x2": (1, 2, 2, False), "2x2x1 zero1": (2, 2, 1, True),
          "2x2x1": (2, 2, 1, False)}
A5C_PROMPT = "The " * 1024
# --zero1-dp against plain 3-D on the same mesh: the reference's bound on
# the losses of its two update-equivalent programs.
A5C_ZERO1_LOSS_TOL = 1e-6
# The vs-dp update gate's plain-vs-plain reading: two correct one-process
# dp runs through the plain versions, the attention tiled by 512 and by
# RING_NOISE_BLOCK, at the 3d cell's shape (4 layers, B 4 x L 2048, bf16,
# fused AdamW, batches 0, 1, 2) leave their worst leaf this far apart over
# its update (blocks.3.attn.kv.bias; median 4.752e-2), H100 80GB HBM3 at
# 700 W; ``python3 tools/a5c_noise.py`` reads it again (``a5c_noise``).
# A leaf after a run may sit RING_NOISE_FACTOR times that from dp's, or
# TRAIN_UPDATE_TOL, whichever is larger: TP's bf16 row-parallel partials
# round before their sum, so its leaves sit at this noise (one read 0.1668
# against a per-leaf limit of 0.1663 on that card).
A5C_UPDATE_NOISE = 1.084e-1


def a5c_runs(cell: str, rank: int, world: int) -> dict:
    """The cell's runs: name -> cli.lm's flags."""
    if cell == "tp":
        return {"tp": a5c_args("tp", rank, world, A5C["tp_batch"], A5C["tp_layers"])}
    if cell == "pp":
        return {name: a5c_args("pp", rank, world, A5C["pp_batch"], A5C["pp_layers"],
                               "--microbatches", str(A5C["pp_micro"]), *flags)
                for name, flags in A5C_PP.items()}
    return {name: a5c_args("3d", rank, world, A5C["p3_batch"], A5C["p3_layers"],
                           "--microbatches", str(A5C["p3_micro"]), "--dp", str(d), "--pp",
                           str(p), "--tp", str(t), *(["--zero1-dp"] if z else []))
            for name, (d, p, t, z) in A5C_3D.items()}


def a5c_args(parallel: str, rank: int, world: int, batch: int, layers: int, *extra: str):
    return trainer_args("--parallel", parallel, "--num-nodes", str(world), "--rank",
                        str(rank), "--seq-len", str(A5C["seq_len"]), "--batch-size",
                        str(batch), "--n-layers", str(layers), *extra, iters=2)


def a5c_batches(args, order) -> list:
    """The stream's batches in ``order`` (indices of its first draws)."""
    from distributed_machine_learning_tpu_torch.cli import lm

    drawn = list(lm.synthetic_batches(args, count=max(order) + 1))
    return [drawn[i] for i in order]


def a5c_dp_run(torch, args, order) -> tuple:
    """One-process dp over the batches ``order`` names: (losses, the initial
    and the final parameters), on the host."""
    from distributed_machine_learning_tpu_torch.cli import lm

    step, state, place, model = lm.build(args)
    init = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    losses = [float(step(state, *place(x, y))[1]) for x, y in a5c_batches(args, order)]
    final = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    del step, state, place, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses, init, final


def a5c_cell_args(cell: str):
    key = {"tp": "tp", "pp": "pp", "3d": "p3"}[cell]
    return trainer_args("--seq-len", str(A5C["seq_len"]), "--batch-size",
                        str(A5C[f"{key}_batch"]), "--n-layers", str(A5C[f"{key}_layers"]))


def a5c_dp_reference(torch, cell: str, path: str) -> list:
    """One-process dp (bf16, fused AdamW, flash, the seeded weights) at the
    cell's batch and depth over its batches: its final parameters saved to
    ``path`` (written aside, then renamed: the ranks wait for the name) for
    the ranks to hold their leaves to; returns its losses."""
    losses, _, final = a5c_dp_run(torch, a5c_cell_args(cell), A5C_ORDER[cell])
    torch.save(final, path + ".tmp")
    os.replace(path + ".tmp", path)
    return losses


def a5c_noise(torch) -> float:
    """The worst leaf's distance, after the 3d cell's steps and over dp's
    update of it, between two correct one-process dp runs through the plain
    versions, the attention tiled by 512 and by RING_NOISE_BLOCK (the ring
    gate's plain-vs-plain reading): A5C_UPDATE_NOISE (``tools/a5c_noise.py``)."""
    args, order = a5c_cell_args("3d"), A5C_ORDER["3d"]
    runs = []
    for block in (512, RING_NOISE_BLOCK):
        with plain_kernels(block=block):
            runs.append(a5c_dp_run(torch, args, order))
    (_, init, f_a), (_, _, f_b) = runs
    noise = {k: float((f_b[k] - f_a[k]).norm() / (f_a[k] - init[k]).norm().clamp_min(1e-30))
             for k in f_a}
    worst = max(noise, key=noise.get)
    log(f"a5c: one-process dp through the plain versions tiled 512 and {RING_NOISE_BLOCK}, "
        f"{A5C['p3_layers']} layers, B {A5C['p3_batch']}, {len(order)} steps: parameters apart "
        f"by median {sorted(noise.values())[len(noise) // 2]:.3e}, worst {noise[worst]:.3e} "
        f"({worst}) of dp's update")
    return noise[worst]


def a5c_local(model, mesh: dict, name: str, whole: dict):
    """The dp-layout leaf of ``whole`` as this rank holds ``name`` (its
    stage's layer, its TP slice, its block of the experts)."""
    from distributed_machine_learning_tpu_torch.parallel.expert_parallel import is_expert_path
    from distributed_machine_learning_tpu_torch.parallel.gspmd import block_of
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        tp_shard_params,
    )

    t = whole[model.global_name(name) if hasattr(model, "global_name") else name]
    tp, ex = mesh.get("model"), mesh.get("expert")
    if tp is not None and tp.world > 1:
        t = tp_shard_params({name: t}, tp.world, tp.rank, model.vocab_parallel == "both")[name]
    if ex is not None and ex.world > 1 and is_expert_path(name):
        t = block_of(t, 0, ex.rank, ex.world)
    return t


def wait_for_file(path: str, seconds: float = 600) -> None:
    """Returns once ``path`` exists (a reference another process writes)."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError(f"the reference {path} never appeared")
        time.sleep(0.5)


def a5c_vs_dp(init: dict, model, mesh: dict, dp_path: str,
              noise: float = A5C_UPDATE_NOISE) -> dict:
    """Each local leaf after the run against the dp reference's after the
    same steps (``a5c_dp_reference``, waited for at ``dp_path``): the
    distance over dp's update of the leaf, against max(TRAIN_UPDATE_TOL,
    RING_NOISE_FACTOR x ``noise``, the plain-vs-plain reading of the
    model): the worst ratio to that limit, its leaf and reading, and the
    median reading."""
    import torch

    wait_for_file(dp_path)
    dp = torch.load(dp_path, mmap=True)
    limit = max(TRAIN_UPDATE_TOL, RING_NOISE_FACTOR * noise)
    err = {}
    for name, p in model.named_parameters():
        want = a5c_local(model, mesh, name, dp).to(p.device).float()
        moved = (want - init[name].float()).norm().clamp_min(1e-30)
        err[name] = float((p.detach().float() - want).norm() / moved)
    worst = max(err, key=err.get)
    return {"worst": (worst, err[worst], err[worst] / limit),
            "median": sorted(err.values())[len(err) // 2]}


def device_digest(torch, tensors) -> tuple:
    """Two exact integer checksums of the tensors' bits, summed on the card
    (equal tensors give equal pairs; any flipped bit moves the weighted one)."""
    plain = weighted = 0
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(torch.int32 if t.element_size() == 4
                                                   else torch.int16).to(torch.int64)
        plain += int(bits.sum())
        weighted += int((bits * (torch.arange(bits.numel(), device=bits.device) % 65521
                                 + 1)).sum())
    return plain, weighted


def a5c_rank(rank: int, world: int, init_method: str, cells: tuple, ckdir: str) -> dict:
    """One rank of A5c cells of one world (``tp`` and ``pp``, or ``3d``),
    one after the other in one process group: {cell: its record}.  Each
    cell's dp reference is at ``{ckdir}/dp-{cell}.pt``
    (``a5c_dp_reference``)."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    try:
        return {cell: a5c_cell_rank(ctx, cell, f"{ckdir}/dp-{cell}.pt", ckdir)
                for cell in cells}
    finally:
        ctx.shutdown()


def a5c_cell_rank(ctx, cell: str, dp_path: str, ckdir: str) -> dict:
    """This rank of an A5c cell (``tp``, ``pp`` or ``3d``): each run through
    cli.lm's build and train_epoch over the cell's batches, the launch counts
    zeroed just before and read just after, every wire call timed
    (``WireTimer``), the step timed on the host clock to its loss sync; the
    local leaves after the run held against the dp reference's (and the
    leaves the TP layout keeps whole digested, for the check across TP
    ranks).  pp: 1f1b and interleaved save at step 2 (``lm.gather_state``
    and ``save_checkpoint``, as cli.lm's run saves), 1f1b is then resumed by
    cli.lm's run for 1 more; tp: one step kernel vs plain
    (``ring_step_gate``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import tp_spec_for
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    rank, world = ctx.rank, ctx.num_nodes
    out: dict = {"backend": ctx.backend, "wire": ctx.comm.wire, "device": str(ctx.device),
                 "runs": {}}
    for name, args in a5c_runs(cell, rank, world).items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step, state, place, model = lm.build(args, ctx)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        wire = WireTimer(torch)
        for axis, kind, method in (("model", "tp sum", "all_reduce_"),
                                   ("pipe", "hop", "exchange"),
                                   ("pipe", "pipe sum", "all_reduce_"),
                                   ("batch", "dp mean", "all_reduce_")):
            comm = step.mesh.get(axis)
            if comm is not None and comm.world > 1:
                setattr(comm, method, wire.wrap(kind, getattr(comm, method)))
        losses, times, rec = [], [], {}
        save = f"{ckdir}/{name}" if cell == "pp" and name in A5C_SAVES else None

        def run(s, x, y):
            t0 = time.perf_counter()
            s, loss = step(s, x, y)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            wire.mark()
            if save is not None and len(losses) == 2:
                with timed_calls(ck, ("save_checkpoint",)) as ck_times:
                    ck.save_checkpoint(save, lm.gather_state(args, step, s),
                                       layout=lm.run_layout(args))
                rec["save_s"] = ck_times["save_checkpoint"][0]
            return s, loss

        batches = a5c_batches(args, A5C_ORDER[cell])
        build.reset_launch_counts()
        state, _ = train_epoch(run, state, batches, place_batch=place,
                               max_iters=len(batches))
        torch.cuda.synchronize()
        rec.update(launches=dict(build.launches), losses=losses, times=times[1:],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   leaves=sum(1 for _ in model.parameters()),
                   elems=sum(p.numel() for p in model.parameters()),
                   digest=device_digest(torch, model.parameters()),
                   replicated=device_digest(torch, [
                       p for n, p in model.named_parameters()
                       if tp_spec_for(n, model.vocab_parallel == "both") is None]),
                   wire_ms={k: wire.per_step(k) for k, v in wire.events.items() if v},
                   waits=list(getattr(step, "waits", []))[1:], attn=model.attn_impl,
                   layers=getattr(model, "layer_ids", None),
                   mesh={k: (c.rank, c.world) for k, c in step.mesh.items()},
                   dp=a5c_vs_dp(init, model, step.mesh, dp_path))
        if cell == "tp":
            rec.update(ring_step_gate(torch, step, state, model, place, args))
        del step, state, place, model, init
        if name == "1f1b":
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            resumed, lines = captured(lm.run, a5c_args(
                "pp", rank, world, A5C["pp_batch"], A5C["pp_layers"], "--microbatches",
                str(A5C["pp_micro"]), *A5C_PP[name], "--ckpt-dir", save, "--resume",
                "--max-iters", "1"), ctx)
            rec["resume_s"] = time.perf_counter() - t0
            rec["resume_lines"] = [ln for ln in lines if "Resumed" in ln or "Saved" in ln]
            rec["resumed_step"] = resumed.step
            rec["resumed_digest"] = device_digest(torch, resumed.model.parameters())
            del resumed
        out["runs"][name] = rec
    return out


def a5c_generate_start(torch, ckdir: str) -> dict:
    """(d), started: every pipeline checkpoint of (b) restored and unstacked
    in this process and saved again in the dp layout (the parameters only);
    then ``python -m ...cli.generate --ckpt-dir`` on each of the four
    directories at once (B 1 x 4096 + 32, greedy, bf16), left running."""
    from distributed_machine_learning_tpu_torch.parallel import pipeline as pp
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    dirs = {}
    for name in A5C_SAVES:
        path = ck.latest_checkpoint(f"{ckdir}/{name}")
        layout = ck.checkpoint_layout(path)
        host = ck.restore_checkpoint(path)
        n = A5C["pp_layers"]
        params = pp.unstack_lm_params(host.params, n, pp.layout_order(layout, n))
        ck.save_checkpoint(f"{ckdir}/{name}-dp", ck.HostState(
            params=params, momentum={}, batch_stats={}, step=host.step, config=host.config))
        dirs[name] = (f"{ckdir}/{name}", layout, path)
        dirs[f"{name}-dp"] = (f"{ckdir}/{name}-dp", None, None)
        del host, params
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.generate",
           "--d-model", str(MODEL["d_model"]), "--n-layers", str(A5C["pp_layers"]),
           "--n-heads", str(MODEL["n_heads"]), "--n-kv-heads", str(MODEL["n_kv_heads"]),
           "--vocab", str(MODEL["vocab_size"]), "--prompt", A5C_PROMPT, "--max-new-tokens",
           str(A5C["gen_new"]), "--temperature", "0"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    procs = {k: subprocess.Popen([*cmd, "--ckpt-dir", d], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for k, (d, _, _) in dirs.items()}
    return {"dirs": dirs, "procs": procs, "t0": time.perf_counter()}


def a5c_generate_wait(job: dict) -> dict:
    done = {k: p.communicate(timeout=600) for k, p in job["procs"].items()}
    job["seconds"] = time.perf_counter() - job["t0"]
    return done


def a5c_generate_check(job: dict, card: str) -> list:
    """(d)'s gates: every command exits 0; the tokens from each pipeline
    checkpoint equal those from its dp-layout twin."""
    dirs, failed, tokens = job["dirs"], [], {}
    for k, (stdout, stderr) in job["done"].items():
        lines = stdout.splitlines()
        code = job["procs"][k].returncode
        tokens[k] = lines[-1] if lines else ""
        log(f"(d) cli.generate --ckpt-dir {k} ({dirs[k][1] or 'dp layout'}): exit code {code}; "
            f"{lines[:1]}")
        if code != 0:
            failed.append(f"cli.generate on {k}: exit code {code}: {stderr[-2000:]}")
    for name in A5C_SAVES:
        same = tokens[name] == tokens[f"{name}-dp"] and tokens[name] != ""
        log(f"(d) {name} checkpoint ({dirs[name][2]}): its {A5C['gen_new']} greedy tokens "
            f"equal the dp-layout twin's: {same}")
        if not same:
            failed.append(f"(d) {name}: tokens differ from the dp layout's")
    log(f"(d) four cli.generate commands at once, started once pp saved, collected after "
        f"the 3d cell [{card}]: {job['seconds']:.1f} s to the collection")
    return failed


def a5c_want(cell: str, name: str, out: dict) -> dict:
    """The launch formulas a rank of ``cell``'s run ``name``: K1, K2 and K3
    once a local layer a microbatch a step (tp: every layer, one
    microbatch); K7 once a local leaf a step (gpipe --overlap-update: the
    boundary's five leaves as one flat slice); K11-K13 never."""
    rec = out["runs"][name]
    steps = len(A5C_ORDER[cell])
    if cell == "tp":
        layers, micro, leaves = A5C["tp_layers"], 1, rec["leaves"]
    elif cell == "pp":
        layers, micro = len(rec["layers"]), A5C["pp_micro"]
        leaves = rec["leaves"] - (4 if name == "overlap" else 0)
    else:
        layers, micro, leaves = len(rec["layers"]), A5C["p3_micro"], rec["leaves"]
    want = {k: layers * micro * steps for k in FLASH_KERNELS}
    want["fused_adamw"] = leaves * steps
    want.update({k: 0 for k in RING_KERNELS})
    return want


def a5c_flops_per_token(layers: int) -> float:
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    model = TransformerLM(**{**MODEL, "n_layers": layers}, device="meta")
    return transformer_train_flops_per_token(sum(p.numel() for p in model.parameters()),
                                             layers, MODEL["d_model"], A5C["seq_len"])


def a5c_report(cell: str, ranks: list, dp_losses: list, totals: dict, failed: list,
               card: str) -> None:
    """The cell's gates and readings (see ``run_a5c``)."""
    from distributed_machine_learning_tpu_torch.utils.flops import train_mfu_per_rank

    key = {"tp": "tp", "pp": "pp", "3d": "p3"}[cell]
    batch, layers = A5C[f"{key}_batch"], A5C[f"{key}_layers"]
    r0 = ranks[0]
    log(f"a5c {cell}: W {len(ranks)}, B {batch} x L {A5C['seq_len']}, {layers} layers, "
        f"backend {r0['backend']}, wire {r0['wire']}, {r0['device']}; dp reference losses "
        f"{[round(x, 4) for x in dp_losses]}")
    for name in r0["runs"]:
        recs = [out["runs"][name] for out in ranks]
        for r, (out, rec) in enumerate(zip(ranks, recs)):
            want = a5c_want(cell, name, out)
            got = {k: rec["launches"].get(k, 0) for k in want}
            for k, n in got.items():
                totals[k] = totals.get(k, 0) + n
            u = rec["dp"]
            log(f"a5c {cell} {name} rank {r} (mesh {rec['mesh']}, layers {rec['layers']}): "
                f"launches {got} (want {want}); peak {rec['peak_gb']:.2f} GB; against dp after "
                f"the run, diff / dp's update median {u['median']:.3e}, worst against its limit "
                f"{u['worst'][1]:.3e} ({u['worst'][0]}, ratio {u['worst'][2]:.3f}; limit "
                f"max({TRAIN_UPDATE_TOL:g}, {RING_NOISE_FACTOR:g} x {A5C_UPDATE_NOISE:g})); "
                f"wire ms a step {({k: spread(v) for k, v in rec['wire_ms'].items()})}")
            if got != want:
                failed.append(f"{cell} {name} rank {r} launches {got} != {want}")
            if not u["worst"][2] <= 1.0:
                failed.append(f"{cell} {name} rank {r}: {u['worst'][0]} {u['worst'][1]:.3e} "
                              f"from dp (ratio {u['worst'][2]:.3f})")
        losses = recs[0]["losses"]
        diff = abs(losses[0] - dp_losses[0])
        log(f"a5c {cell} {name}: losses {[round(x, 5) for x in losses]}; step-0 loss vs dp "
            f"{losses[0]:.6f} vs {dp_losses[0]:.6f} (diff {diff:.3e}, tol {TRAIN_LOSS_TOL:g})")
        if not (all(math.isfinite(x) for x in losses) and diff <= TRAIN_LOSS_TOL
                and all(rec["losses"] == losses for rec in recs)):
            failed.append(f"{cell} {name}: losses {[rec['losses'] for rec in recs]}")
        # Replicated leaves bit for bit across the ranks of a TP group (and
        # every leaf across the ranks of a data group).
        groups: dict = {}
        for rec in recs:
            m = rec["mesh"]
            groups.setdefault((m.get("batch", (0, 1))[0], m.get("pipe", (0, 1))[0]),
                              set()).add(rec["replicated"])
            groups.setdefault(("data", m.get("pipe", (0, 1))[0], m.get("model", (0, 1))[0]),
                              set()).add(rec["digest"])
        same = all(len(v) == 1 for v in groups.values())
        log(f"a5c {cell} {name}: replicated leaves bit for bit across TP ranks, every leaf "
            f"across data ranks: {same}")
        if not same:
            failed.append(f"{cell} {name}: ranks' replicated leaves differ")
        ms = [t * 1e3 for t in recs[0]["times"]]
        tokens = batch * A5C["seq_len"]
        rate = tokens / sorted(ms)[len(ms) // 2] * 1e3
        per_rank = train_mfu_per_rank(rate, a5c_flops_per_token(layers), len(ranks),
                                      BF16_FLOPS / 1e12)
        line = (f"a5c {cell} {name} [{card}]: step ms (rank 0, host clock to the loss sync, "
                f"step 0 untimed) {spread(ms)} -> {rate:.0f} tokens/s, MFU {per_rank:.4f} a "
                f"rank ({per_rank * len(ranks):.4f} of the one card they share); peak GB a rank "
                f"{[round(rec['peak_gb'], 2) for rec in recs]}")
        if cell == "pp":
            v = 2 if name == "interleaved" else 1
            P, M = A5C["pp_world"], A5C["pp_micro"]
            idle = [round(sum(rec["waits"]) / max(sum(rec["times"]), 1e-9), 3) for rec in recs]
            line += (f"; bubble: idle share a stage (host seconds in the pipe exchange / step) "
                     f"{idle} beside (P-1)/(v*M+P-1) = {(P - 1) / (v * M + P - 1):.3f}")
        log(line)
    if cell == "tp":
        for r, out in enumerate(ranks):
            g = out["runs"]["tp"]["gate"]
            name, err, noise, ratio, median, name_e, err_e, noise_e = g["grad"]
            log(f"a5c tp rank {r} step, kernel vs plain path: loss {g['loss']:.6f} vs "
                f"{g['loss_plain']:.6f} (tol {TRAIN_LOSS_TOL:g}); gradient rel L2 median "
                f"{median:.3e}, largest {err_e:.3e} ({name_e}); worst against its limit "
                f"{err:.3e} ({name}; limit max({TRAIN_GRAD_TOL:g}, {RING_NOISE_FACTOR:g} x "
                f"{noise:.3e}), ratio {ratio:.3f}); update worst {g['update'][1]:.3e} "
                f"({g['update'][0]}), median {g['update'][2]:.3e} (tol {TRAIN_UPDATE_TOL:g})")
            if not (abs(g["loss"] - g["loss_plain"]) <= TRAIN_LOSS_TOL
                    and ratio <= 1.0 and g["update"][1] <= TRAIN_UPDATE_TOL):
                failed.append(f"tp rank {r} kernel vs plain step")
    if cell == "pp":
        for r, out in enumerate(ranks):
            runs = out["runs"]
            overlap = runs["overlap"]["digest"] == runs["gpipe"]["digest"]
            f = runs["1f1b"]
            resumed = f["resumed_step"] == 3 and f["resumed_digest"] == f["digest"]
            log(f"a5c pp rank {r}: gpipe --overlap-update bit for bit sync gpipe: {overlap}; "
                f"1f1b saved at step 2 in {f['save_s']:.2f} s, interleaved in "
                f"{runs['interleaved']['save_s']:.2f} s; the resumed run ({f['resume_s']:.1f} "
                f"s; {f['resume_lines']}) bit for bit the uninterrupted 3 steps: {resumed}")
            if not overlap:
                failed.append(f"pp rank {r}: --overlap-update differs from sync gpipe")
            if not resumed:
                failed.append(f"pp rank {r}: the resumed run differs from the uninterrupted")
    if cell == "3d":
        plain, zero1 = r0["runs"]["2x2x1"]["losses"], r0["runs"]["2x2x1 zero1"]["losses"]
        gap = max(abs(a - b) for a, b in zip(plain, zero1))
        same = all(out["runs"]["2x2x1"]["digest"] == out["runs"]["2x2x1 zero1"]["digest"]
                   for out in ranks)
        log(f"a5c 3d: --zero1-dp against plain 3-D on dp 2 x pp 2 x tp 1: largest loss gap "
            f"{gap:.3e} (tol {A5C_ZERO1_LOSS_TOL:g}); parameters bit for bit: {same}")
        if not gap <= A5C_ZERO1_LOSS_TOL:
            failed.append("3d: --zero1-dp losses differ from plain 3-D")


def run_a5c(torch, rows: dict, card: str, cells=("tp", "pp", "3d")) -> None:
    """The A5c phase (docstring step 10b).  Gates: every rank's launches at
    their formulas (``a5c_want``); losses finite, equal on every rank, the
    step-0 loss within TRAIN_LOSS_TOL of one-process dp's on the same
    weights and batch; every local leaf after the run within max(TRAIN_UPDATE_TOL,
    RING_NOISE_FACTOR x A5C_UPDATE_NOISE) of dp's (relative to dp's update
    of the leaf); the leaves the TP layout keeps whole bit for bit across a
    TP group, every leaf across a data group; tp: one step kernel vs plain
    on every rank (the ring's gate); pp: --overlap-update bit for bit sync
    gpipe, the resumed 1f1b run bit for bit the uninterrupted one; 3d:
    --zero1-dp within A5C_ZERO1_LOSS_TOL of plain 3-D; (d) every
    cli.generate exits 0 and each pipeline checkpoint's tokens equal its
    dp-layout twin's.  The three cells' ranks (2, 2 and 4 processes) run at
    once, the dp references in this process while they start, and (d)'s
    four commands once pp has saved (time limit): each cell's step times
    carry the others' load.
    Reports step ms, tokens/s, MFU a rank, peak GB a rank, the wire's ms a
    step and, for pp, the idle share a stage beside the bubble formula."""
    from concurrent.futures import ThreadPoolExecutor

    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="a5c_", dir=build_dir)
    totals: dict = {}
    failed: list = []
    generate: dict = {}
    groups = [[c] for c in ("pp", "tp", "3d") if c in cells]
    t0 = time.perf_counter()

    def run_group(group):
        world = {"tp": A5C["tp_world"], "pp": A5C["pp_world"], "3d": A5C["p3_world"]}[group[0]]
        ranks = spawn(a5c_rank, world, (tuple(group), ckdir), timeout_s=900)
        log(f"a5c {' and '.join(group)} ranks: done {time.perf_counter() - t0:.1f} s into "
            "the phase")
        if "pp" in group:
            generate.update(a5c_generate_start(torch, ckdir))
        return ranks

    try:
        with ThreadPoolExecutor(len(groups)) as pool:
            running = [pool.submit(run_group, g) for g in groups]
            # The references run while the ranks start; a rank waits for its
            # cell's file after its first run.
            dp_losses = {c: a5c_dp_reference(torch, c, f"{ckdir}/dp-{c}.pt")
                         for c in sorted(cells, key=("tp", "3d", "pp").index)}
            log(f"a5c dp references: {time.perf_counter() - t0:.1f} s")
            results = [r.result() for r in running]
        for group, ranks in zip(groups, results):
            for c in group:
                a5c_report(c, [r[c] for r in ranks], dp_losses[c], totals, failed, card)
        if generate:
            generate["done"] = a5c_generate_wait(generate)
            failed += a5c_generate_check(generate, card)
    finally:
        for p in generate.get("procs", {}).values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"a5c launches over the phase: {totals}")
    for key, row in rows.items():
        row["a5c_launches"] = totals.get(key.split(":")[0], 0)
    if failed:
        raise AssertionError("a5c: " + "; ".join(failed))


# -- ROADMAP A5c, expert parallelism (step 10c): cli.lm --parallel ep at the
# model's full width (d2048, 16 heads x 128, 4 KV heads, vocab 32000), E 8
# experts of d_ff 8192, capacity factor 1.25, bf16, fused AdamW, --attn
# flash; 2 of the 8 layers, B 4 x L 2048, 3 steps over the stream's batches
# 0, 1, 0 (a resumed run's step takes batch 0 again); ranks share the card
# over the host wire.  W 2 (ep 2): (a) einsum; (b) grouped (dropless), saved
# at step 2 in the plain layout, resumed by cli.lm's resume for 1 more, and
# served by cli.generate --moe --ckpt-dir (4096 + 32); (c) grouped with
# --ep-slots EP["slots"] (rows drop) and with ample slots (N_local: (b) bit
# for bit).  W 4: (d) grouped --ep-seq 2 (dp 1 x ep 2 x seq 2; the chunk is
# 1024, so attention runs ring_flash).
EP = dict(layers=2, batch=4, experts=8, slots=1024, seq_world=4)
# The EP cells' update gate: the A5c rule, max(TRAIN_UPDATE_TOL,
# RING_NOISE_FACTOR x a plain-vs-plain reading), with the reading of this
# model: two correct one-process grouped MoE runs at the cells' shape
# through the plain versions, the attention tiled by 512 and by
# RING_NOISE_BLOCK, leave their worst leaf this far apart over its update
# (embed.weight; median 0.2535), H100 80GB HBM3 at 700 W; ``python3
# tools/a5c_noise.py --ep`` reads it again (``ep_noise``).  bf16 rounding
# in attention flips a few top-1 routes (--ep-seq's ring flash kernels
# route 37 of 16,384 step-0 tokens unlike one-process flash), and a flipped
# token moves its expert's and the embedding's Adam updates: the dense
# model's reading (A5C_UPDATE_NOISE) is 3.5x smaller.
EP_UPDATE_NOISE = 3.758e-1
# The EP cells' step-0 gradient gate: each local leaf's gradient at step 0
# (its first moment after the step: (1 - beta1) x the gradient the update
# took, after the EP sync) against the one-process run's over the latter's
# norm, within max(EP_GRAD_FLOOR, RING_NOISE_FACTOR x the leaf's own
# plain-vs-plain reading).  EP_GRAD_NOISE, by leaf name with the layer
# taken out (the worse of the layers), is ``ep_noise``'s two plain runs at
# step 0, H100 80GB HBM3 at 700 W (``python3 tools/a5c_noise.py --ep``):
# bf16 attention tiled otherwise moves most leaves' step-0 gradients by
# 7-9 %, the router's bias by 15 %, and the leaves next to the loss (ln_f,
# lm_head) by 0.2-5 %; the floor holds those.  The faults the gate is for
# read far above it (``tools/a5c_noise.py --plant``: the expert leaves'
# seq-axis sum left out 0.62-0.84, / dp in place of / n_total 3.0).
EP_GRAD_FLOOR = 0.1
EP_GRAD_NOISE = {
    "embed.weight": 0.07369, "ln1.weight": 0.07418, "ln1.bias": 0.07856,
    "attn.q.weight": 0.08444, "attn.q.bias": 0.07409, "attn.kv.weight": 0.07214,
    "attn.kv.bias": 0.07907, "attn.out.weight": 0.0682, "attn.out.bias": 0.08222,
    "ln2.weight": 0.08683, "ln2.bias": 0.07458, "moe.w_in": 0.09147, "moe.b_in": 0.09071,
    "moe.w_out": 0.08741, "moe.b_out": 0.08333, "moe.router.weight": 0.09442,
    "moe.router.bias": 0.1472, "ln_f.weight": 0.02236, "ln_f.bias": 0.002176,
    "lm_head.weight": 0.05119, "lm_head.bias": 0.001674,
}
EP_ORDER = [0, 1, 0]
EP_W2 = ("einsum", "grouped", "slots", "ample")


def ep_n_local() -> int:
    """Token rows a rank of the W 2 grouped runs holds (B / (dp x ep) x L):
    the dropless send slots an owner."""
    return EP["batch"] // 2 * A5C["seq_len"]


def ep_args(run: str, rank: int = 0, world: int = 1, *extra: str):
    """cli.lm's flags of an EP run (one rank: the one-process reference of
    its impl)."""
    flags = ["--parallel", "ep", "--num-nodes", str(world), "--rank", str(rank),
             "--seq-len", str(A5C["seq_len"]), "--batch-size", str(EP["batch"]),
             "--n-layers", str(EP["layers"]), "--n-experts", str(EP["experts"]),
             "--moe-impl", "einsum" if run == "einsum" else "grouped"]
    if world > 1:
        flags += {"slots": ["--ep-slots", str(EP["slots"])],
                  "ample": ["--ep-slots", str(ep_n_local())],
                  "seq": ["--ep", "2", "--ep-seq", "2"]}.get(run, [])
    return trainer_args(*flags, *extra, iters=len(EP_ORDER))


def routed_step(torch, step, model, state, x, y):
    """One step, with its routes (``RouteTape``): (state, loss, experts
    [layers, *x.shape] as an int16 numpy array)."""
    tape = RouteTape(torch, model)
    try:
        state, loss = step(state, x, y)
    finally:
        tape.close()
    return state, loss, tape.experts(x.shape[1]).to("cpu", torch.int16).numpy()


def ep_kind(name: str) -> str:
    """A leaf's name without its layer (``blocks.1.moe.w_in`` ->
    ``moe.w_in``): the key of EP_GRAD_NOISE."""
    return re.sub(r"^blocks\.\d+\.", "", name)


def ep_grad_limit(name: str) -> float:
    return max(EP_GRAD_FLOOR, RING_NOISE_FACTOR * EP_GRAD_NOISE.get(ep_kind(name), 0.0))


def ep_noise(torch) -> tuple:
    """EP_UPDATE_NOISE's and EP_GRAD_NOISE's readings (see ``a5c_noise``):
    one-process grouped MoE at the EP cells' shape over EP_ORDER's batches,
    twice through the plain versions, the attention tiled by 512 and by
    RING_NOISE_BLOCK.  Returns the worst leaf's distance between the runs
    over the update, and each leaf kind's worst distance between their
    step-0 gradients over the gradient; both logged with their medians."""
    from distributed_machine_learning_tpu_torch.cli import lm

    args = ep_args("grouped")
    runs = []
    for block in (512, RING_NOISE_BLOCK):
        with plain_kernels(block=block):
            step, state, place, model = lm.build(args)
            init = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
            losses, grad0 = [], None
            for x, y in a5c_batches(args, EP_ORDER):
                losses.append(float(step(state, *place(x, y))[1]))
                if grad0 is None:
                    grad0 = {k: t.to("cpu", copy=True) for k, t in state.momentum["mu"].items()}
            final = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
            runs.append((losses, init, grad0, final))
            del step, state, place, model
            gc.collect()
            torch.cuda.empty_cache()
    (_, init, g_a, f_a), (_, _, g_b, f_b) = runs
    noise = {k: float((f_b[k] - f_a[k]).norm() / (f_a[k] - init[k]).norm().clamp_min(1e-30))
             for k in f_a}
    worst = max(noise, key=noise.get)
    grads = {k: float((g_b[k] - g_a[k]).norm() / g_a[k].norm().clamp_min(1e-30)) for k in g_a}
    kinds: dict = {}
    for k, v in grads.items():
        kinds[ep_kind(k)] = max(kinds.get(ep_kind(k), 0.0), v)
    log(f"ep: one-process grouped MoE through the plain versions tiled 512 and "
        f"{RING_NOISE_BLOCK}, {EP['layers']} layers, B {EP['batch']}, {len(EP_ORDER)} steps: "
        f"losses {runs[0][0]} and {runs[1][0]}; parameters apart by median "
        f"{sorted(noise.values())[len(noise) // 2]:.3e}, worst {noise[worst]:.3e} ({worst}) "
        f"of the update; step-0 gradients apart by median "
        f"{sorted(grads.values())[len(grads) // 2]:.3e} of the gradient, by leaf kind "
        f"(EP_GRAD_NOISE) {({k: float(f'{v:.4g}') for k, v in sorted(kinds.items())})}")
    return noise[worst], kinds


def save_aside(torch, tree: dict, path: str) -> None:
    """``tree`` saved to ``path``: written aside, then renamed (a reader
    waits for the name)."""
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)


def ep_reference(torch, impl: str, ckdir: str) -> dict:
    """One-process MoE on the seeded weights (``cli.lm --parallel ep`` at one
    rank: the one-device step) over EP_ORDER's batches: its first moments
    after step 0 saved to ``ckdir/grad0-{impl}.pt`` and its final
    parameters to ``ckdir/ref-{impl}.pt``; returns its losses and its
    step-0 experts [layers, B, L]."""
    from distributed_machine_learning_tpu_torch.cli import lm

    args = ep_args(impl)
    step, state, place, model = lm.build(args)
    losses, routes = [], None
    for i, (x, y) in enumerate(a5c_batches(args, EP_ORDER)):
        if i == 0:
            state, loss, routes = routed_step(torch, step, model, state, *place(x, y))
            save_aside(torch, {k: t.to("cpu") for k, t in state.momentum["mu"].items()},
                       f"{ckdir}/grad0-{impl}.pt")
        else:
            state, loss = step(state, *place(x, y))
        losses.append(float(loss))
    final = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    save_aside(torch, final, f"{ckdir}/ref-{impl}.pt")
    del step, state, place, model, final
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "routes": routes}


def ep_rank(rank: int, world: int, init_method: str, runs: tuple, ckdir: str,
            wait_for: str | None = None, plant: str | None = None) -> dict:
    """One rank of the EP runs of one world, one after the other in one
    process group: {"runs": {name: record}, ...}.  ``wait_for``: a file
    whose appearance the ranks wait for, their group joined and their card
    context made, before the first run builds (the card's memory).
    ``plant``: a fault in the gradient sync (``ep_plant``), for the gates'
    control."""
    import torch

    from distributed_machine_learning_tpu_torch.cli import lm  # noqa: F401 (imported early)
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    try:
        if wait_for is not None:
            torch.zeros(1, device=ctx.device)
            deadline = time.monotonic() + 600
            while not os.path.exists(wait_for):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{wait_for} never appeared")
                time.sleep(0.1)
        return {"backend": ctx.backend, "wire": ctx.comm.wire, "device": str(ctx.device),
                "runs": {name: ep_run(torch, ctx, name, ckdir, plant) for name in runs}}
    finally:
        ctx.shutdown()


def ep_plant(fault: str, step) -> None:
    """A deliberate fault in this process's EP gradient sync, the gates'
    control (``tools/a5c_noise.py --ep --plant``): ``seq-sum`` leaves the
    expert leaves unsummed over the seq axis; ``scale`` divides every
    gradient by the data axis's size in place of n_total (an Adam update
    hardly moves: the scale cancels in m / sqrt(v))."""
    from distributed_machine_learning_tpu_torch.parallel import expert_parallel as ep

    mesh, real = step.mesh, ep.sum_over_ranks_
    scale = math.prod(c.world for c in mesh.values()) / mesh["batch"].world

    def planted(comm, tensors):
        if fault == "seq-sum" and comm is mesh.get("seq"):
            return
        real(comm, tensors)
        if fault == "scale" and (comm is step.world or comm is mesh["batch"]):
            for t in tensors:
                t.mul_(scale)

    if fault not in ("seq-sum", "scale"):
        raise ValueError(f"unknown fault {fault!r}")
    ep.sum_over_ranks_ = planted


def ep_grad_vs_ref(model, mesh: dict, state, path: str) -> dict:
    """Each local leaf's step-0 gradient (its first moment after step 0)
    against the one-process run's (``ep_reference``, waited for at
    ``path``): the distance over the latter's norm, against the leaf's
    ``ep_grad_limit``: the worst ratio to its limit, its leaf and reading,
    the median reading, and each leaf kind's worst reading."""
    import torch

    wait_for_file(path)
    ref = torch.load(path, mmap=True)
    err, ratio = {}, {}
    for name, _ in model.named_parameters():
        got = state.momentum["mu"][name]
        want = a5c_local(model, mesh, name, ref).to(got.device)
        err[name] = float((got - want).norm() / want.norm().clamp_min(1e-30))
        ratio[name] = err[name] / ep_grad_limit(name)
    worst = max(ratio, key=ratio.get)
    kinds: dict = {}
    for name, e in err.items():
        kinds[ep_kind(name)] = max(kinds.get(ep_kind(name), 0.0), e)
    return {"worst": (worst, err[worst], ratio[worst]),
            "median": sorted(err.values())[len(err) // 2], "kinds": kinds}


def ep_run(torch, ctx, name: str, ckdir: str, plant: str | None = None) -> dict:
    """This rank of one EP run through cli.lm's build and train_epoch: the
    launch counts zeroed just before and read just after, the wire's calls
    timed (``WireTimer``), the step timed on the host clock to its loss
    sync, step 0's experts taped; the dropped rows a step; the local leaves'
    step-0 gradients (``ep_grad_vs_ref``) and the leaves after the run
    (``a5c_vs_dp``) against the one-process reference of its impl (not for
    ``slots``, whose drops the reference has not).  ``grouped`` saves at
    step 2 as cli.lm's run saves (``gather_ep_state``: the plain layout) and
    is then resumed by cli.lm's build and resume for 1 more step."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.parallel import expert_parallel as ep
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rank, world = ctx.rank, ctx.num_nodes
    args = ep_args(name, rank, world)
    t0 = time.perf_counter()
    step, state, place, model = lm.build(args, ctx)
    t_build = time.perf_counter()
    mesh = step.mesh
    if plant is not None:
        ep_plant(plant, step)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    impl = "einsum" if name == "einsum" else "grouped"
    wire = WireTimer(torch)
    for comm, kind, method in ((mesh["expert"], "all-to-all", "all_to_all"),
                               (mesh["expert"], "expert sums", "all_reduce_"),
                               (mesh.get("seq"), "hops", "shift"),
                               (mesh.get("seq"), "seq sums", "all_reduce_"),
                               (mesh["batch"], "data sums", "all_reduce_"),
                               (getattr(step, "world", None), "gradient sums",
                                "all_reduce_")):
        if comm is not None and comm.world > 1:  # fresh Comms of this build
            setattr(comm, method, wire.wrap(kind, getattr(comm, method)))
    losses, times, dropped, rec = [], [], [], {}
    save = f"{ckdir}/ep-grouped" if name == "grouped" else None

    def run(s, x, y):
        t0 = time.perf_counter()
        if losses:
            s, loss = step(s, x, y)
        else:
            s, loss, rec["routes"] = routed_step(torch, step, model, s, x, y)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        wire.mark()
        dropped.append(sum(int(b.moe.last_dropped) for b in model.blocks
                           if b.moe.last_dropped is not None))
        if len(losses) == 1 and name != "slots":
            rec["grad0"] = ep_grad_vs_ref(model, mesh, s, f"{ckdir}/grad0-{impl}.pt")
        if save is not None and len(losses) == 2:
            with timed_calls(ck, ("save_checkpoint",)) as ck_times:
                ck.save_checkpoint(save, ep.gather_ep_state(s, mesh["expert"]))
            rec["save_s"] = ck_times["save_checkpoint"][0]
            if rank == 0:  # the generate command may start
                Path(save + ".saved").touch()
        return s, loss

    batches = a5c_batches(args, EP_ORDER)
    build.reset_launch_counts()
    state, _ = train_epoch(run, state, batches, place_batch=place, max_iters=len(batches))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t_build
    rec.update(launches=dict(build.launches), losses=losses, times=times[1:],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               leaves=sum(1 for _ in model.parameters()), dropped=dropped,
               digest=device_digest(torch, model.parameters()),
               replicated=device_digest(torch, [p for n, p in model.named_parameters()
                                                if not ep.is_expert_path(n)]),
               experts=device_digest(torch, [p for n, p in model.named_parameters()
                                             if ep.is_expert_path(n)]),
               wire_ms={k: wire.per_step(k) for k, v in wire.events.items() if v},
               attn=model.attn_impl, mesh={k: (c.rank, c.world) for k, c in mesh.items()},
               ref=(None if name == "slots"
                    else a5c_vs_dp(init, model, mesh, f"{ckdir}/ref-{impl}.pt", EP_UPDATE_NOISE)))
    rec["seconds"] = {"build": t_build - t0, "steps": t_steps, "step 0": times[0],
                      "gate": time.perf_counter() - t_build - t_steps}
    del step, state, place, model, init
    if name == "grouped":
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rargs = ep_args(name, rank, world, "--ckpt-dir", save, "--resume", "--max-iters", "1")
        step, fresh, place, model = lm.build(rargs, ctx)
        resumed, lines = captured(lm.resume, rargs, fresh)
        resumed, _ = train_epoch(step, resumed, a5c_batches(rargs, [0]), place_batch=place,
                                 max_iters=1)
        torch.cuda.synchronize()
        rec["seconds"]["resume"] = time.perf_counter() - t0
        rec.update(resume_s=time.perf_counter() - t0, resume_lines=lines,
                   resumed_step=resumed.step,
                   resumed_digest=device_digest(torch, model.parameters()))
        del step, fresh, resumed, place, model
    return rec


def ep_block(run: str, mesh: dict) -> tuple:
    """The block of the global [B, L] batch a rank holds: (row block, row
    blocks, column block, column blocks)."""
    row, rows = mesh["batch"]
    if run != "einsum":  # the rows split over data x expert, data major
        row, rows = row * mesh["expert"][1] + mesh["expert"][0], rows * mesh["expert"][1]
    col, cols = mesh.get("seq", (0, 1))
    return row, rows, col, cols


def ep_want(run: str, rec: dict) -> dict:
    """A rank's launch formulas: K1-K3 once a layer a step (its local rows
    and chunk), K11-K13 layers x (seq rank + 1) x steps under --ep-seq, K7
    once a local leaf a step."""
    steps, layers = len(EP_ORDER), EP["layers"]
    seq = rec["mesh"].get("seq")
    want = {k: 0 if seq else layers * steps for k in FLASH_KERNELS}
    want.update({k: layers * (seq[0] + 1) * steps if seq else 0 for k in RING_KERNELS})
    want["fused_adamw"] = rec["leaves"] * steps
    return want


def ep_generate_start(ckdir: str) -> dict:
    """``python -m ...cli.generate --moe --ckpt-dir`` on (b)'s checkpoint (B
    1 x 4096 + 32, greedy, bf16), left running."""
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.generate",
           "--moe", "--n-experts", str(EP["experts"]), "--d-model", str(MODEL["d_model"]),
           "--n-layers", str(EP["layers"]), "--n-heads", str(MODEL["n_heads"]),
           "--n-kv-heads", str(MODEL["n_kv_heads"]), "--vocab", str(MODEL["vocab_size"]),
           "--prompt", A5C_PROMPT, "--max-new-tokens", str(A5C["gen_new"]),
           "--temperature", "0", "--ckpt-dir", f"{ckdir}/ep-grouped"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    return {"proc": subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, env=env), "t0": time.perf_counter()}


def ep_expert_ranks(recs: list) -> dict:
    """The ranks of a run by the expert block they hold: {expert rank: [rank]}."""
    out: dict = {}
    for r, rec in enumerate(recs):
        out.setdefault(rec["mesh"]["expert"][0], []).append(r)
    return out


def ep_expert_groups(recs: list) -> dict:
    """{expert rank: the set of its ranks' expert-leaf digests}: one digest
    each where the copies of a block agree bit for bit."""
    return {e: {recs[r]["experts"] for r in rs} for e, rs in ep_expert_ranks(recs).items()}


def ep_report(results: dict, refs: dict, failed: list, card: str) -> dict:
    """The EP cells' gates and readings (see ``run_ep``); returns the launch
    totals over every rank's runs."""
    totals: dict = {}
    tol = max(TRAIN_UPDATE_TOL, RING_NOISE_FACTOR * EP_UPDATE_NOISE)
    for ranks in results:
        world, r0 = len(ranks), ranks[0]
        log(f"ep W {world}: backend {r0['backend']}, wire {r0['wire']}, {r0['device']}")
        for name in r0["runs"]:
            recs = [out["runs"][name] for out in ranks]
            impl = "einsum" if name == "einsum" else "grouped"
            ref = refs[impl]
            for r, rec in enumerate(recs):
                want = ep_want(name, rec)
                got = {k: rec["launches"].get(k, 0) for k in want}
                for k, n in got.items():
                    totals[k] = totals.get(k, 0) + n
                u, g = rec["ref"], rec.get("grad0")
                vs = ("" if u is None else
                      f"; against the one-process {impl} run: step-0 gradients, diff / its "
                      f"norm median {g['median']:.3e}, worst {g['worst'][1]:.3e} "
                      f"({g['worst'][0]}, ratio {g['worst'][2]:.3f} to its limit "
                      f"{ep_grad_limit(g['worst'][0]):.4f}); after the run, diff / its update "
                      f"median {u['median']:.3e}, worst {u['worst'][1]:.3e} ({u['worst'][0]}, "
                      f"ratio {u['worst'][2]:.3f} to max({TRAIN_UPDATE_TOL:g}, "
                      f"{RING_NOISE_FACTOR:g} x {EP_UPDATE_NOISE:g}) = {tol:.4f})")
                log(f"ep {name} rank {r} (mesh {rec['mesh']}, attn {rec['attn']}): launches "
                    f"{got} (want {want}); peak {rec['peak_gb']:.2f} GB; dropped rows a step "
                    f"{rec['dropped']}{vs}; wire ms a step "
                    f"{({k: spread(v) for k, v in rec['wire_ms'].items()})}; host seconds "
                    f"{({k: round(v, 1) for k, v in rec['seconds'].items()})}")
                if got != want:
                    failed.append(f"ep {name} rank {r} launches {got} != {want}")
                if u is not None and not u["worst"][2] <= 1.0:
                    failed.append(f"ep {name} rank {r}: {u['worst'][0]} {u['worst'][1]:.3e} "
                                  f"from the one-process run (ratio {u['worst'][2]:.3f})")
                if g is not None and not g["worst"][2] <= 1.0:
                    failed.append(f"ep {name} rank {r}: step-0 gradient of {g['worst'][0]} "
                                  f"{g['worst'][1]:.3e} from the one-process run's (ratio "
                                  f"{g['worst'][2]:.3f})")
                if (name == "slots") != any(rec["dropped"]):
                    failed.append(f"ep {name} rank {r}: dropped rows {rec['dropped']}")
            losses = recs[0]["losses"]
            diff = abs(losses[0] - ref["losses"][0])
            log(f"ep {name}: losses {[round(x, 5) for x in losses]}; step-0 loss vs the "
                f"one-process {impl} run {losses[0]:.6f} vs {ref['losses'][0]:.6f} (diff "
                f"{diff:.3e}, tol {TRAIN_LOSS_TOL:g}{'; not gated: rows drop' if name == 'slots' else ''})")
            if not (all(math.isfinite(x) for x in losses)
                    and all(rec["losses"] == losses for rec in recs)
                    and (name == "slots" or diff <= TRAIN_LOSS_TOL)):
                failed.append(f"ep {name}: losses {[rec['losses'] for rec in recs]}")
            if name == "slots":
                n = sum(sum(rec["dropped"]) for rec in recs)
                log(f"ep slots: --ep-slots {EP['slots']} of N_local {ep_n_local()}: "
                    f"{n} token rows dropped over the ranks, layers and steps")
            # Step 0's experts against the one-process run's, block by block.
            same = total = 0
            seen = set()
            for rec in recs:
                row, rows, col, cols = block = ep_block(name, rec["mesh"])
                if block in seen:
                    continue
                seen.add(block)
                want_r = ref["routes"]
                r_len, c_len = want_r.shape[1] // rows, want_r.shape[2] // cols
                part = want_r[:, row * r_len:(row + 1) * r_len, col * c_len:(col + 1) * c_len]
                same += int((part == rec["routes"]).sum())
                total += part.size
            if name != "slots":
                kinds: dict = {}
                for rec in recs:
                    for k, e in rec["grad0"]["kinds"].items():
                        kinds[k] = max(kinds.get(k, 0.0), e)
                log(f"ep {name}: step-0 gradients vs the one-process {impl} run, diff / its "
                    f"norm by leaf kind (worst over the ranks) "
                    f"{({k: float(f'{v:.3g}') for k, v in sorted(kinds.items())})}")
            log(f"ep {name}: step-0 tokens routed as in the one-process {impl} run: "
                f"{same} of {total} ({same / max(total, 1):.6f})")
            # Leaves outside the experts bit for bit across every rank, the
            # expert leaves across the ranks that hold the same experts.
            alike = len({rec["replicated"] for rec in recs}) == 1
            shared = ep_expert_groups(recs)
            log(f"ep {name}: leaves outside the experts bit for bit across the ranks: {alike}; "
                f"expert leaves bit for bit across the ranks that hold the same experts: "
                f"{({e: len(d) == 1 for e, d in shared.items()})} (ranks a block "
                f"{({e: len(d) for e, d in ep_expert_ranks(recs).items()})})")
            if not alike:
                failed.append(f"ep {name}: ranks' replicated leaves differ")
            if any(len(d) != 1 for d in shared.values()):
                failed.append(f"ep {name}: the copies of an expert block differ")
            ms = [t * 1e3 for t in recs[0]["times"]]
            tokens = EP["batch"] * A5C["seq_len"]
            log(f"ep {name} W {world} [{card}]: step ms (rank 0, host clock to the loss sync, "
                f"step 0 untimed) {spread(ms)} -> {tokens / sorted(ms)[len(ms) // 2] * 1e3:.0f} "
                f"tokens/s; peak GB a rank {[round(rec['peak_gb'], 2) for rec in recs]}")
    by_rank: dict = {}  # run -> [record of each rank]
    for ranks in results:
        for out in ranks:
            for name, rec in out["runs"].items():
                by_rank.setdefault(name, []).append(rec)
    for r, (g, amp) in enumerate(zip(by_rank["grouped"], by_rank["ample"])):
        resumed = g["resumed_step"] == 3 and g["resumed_digest"] == g["digest"]
        ample = amp["digest"] == g["digest"] and amp["mesh"] == g["mesh"]
        log(f"ep rank {r}: grouped saved at step 2 in {g['save_s']:.2f} s; resumed "
            f"({g['resume_s']:.1f} s; {[ln for ln in g['resume_lines'] if 'Resumed' in ln]}) "
            f"bit for bit the uninterrupted 3 steps: {resumed}; --ep-slots {ep_n_local()} "
            f"(ample) bit for bit dropless: {ample}")
        if not resumed:
            failed.append(f"ep rank {r}: the resumed run differs from the uninterrupted")
        if not ample:
            failed.append(f"ep rank {r}: ample --ep-slots differs from dropless")
    return totals


def run_ep(torch, rows: dict, card: str) -> None:
    """The EP cells (docstring step 10c): (a) and (c)'s bounded run in W 2
    ranks and then (d)'s W 4 ranks (started at once, waiting to build)
    beside (b) and (c)'s ample run in W 2 ranks, the one-process references
    (einsum, then grouped) in this process while they start, (b)'s
    ``cli.generate`` once (b) has saved.  Gates:
    every rank's launches at their formulas (``ep_want``); losses finite
    and equal on every rank, the step-0 loss within TRAIN_LOSS_TOL of the
    one-process run of its impl on the same weights and batch (not
    ``slots``); every local leaf's step-0 gradient within its
    ``ep_grad_limit`` of that run's (``ep_grad_vs_ref``; not ``slots``) and
    every local leaf after the run within the A5c rule of that run's
    (``a5c_vs_dp``; not ``slots``); the leaves outside the experts bit for
    bit across the ranks, the expert leaves across the ranks that hold the
    same experts; ``slots`` drops rows and the others none; the
    resumed run and ample slots bit for bit (b); ``cli.generate`` exits 0.
    Reports the step-0 routing agreement, step ms, tokens/s, peak GB a rank
    and the wire's ms a step."""
    from concurrent.futures import ThreadPoolExecutor

    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="ep_", dir=build_dir)
    failed: list = []
    totals: dict = {}
    gen = None
    t0 = time.perf_counter()
    flag = f"{ckdir}/ep-w2.done"

    def group(world, runs, wait_for=None, done=None):
        """One process group's ranks over ``runs``; ``done`` touched after."""
        try:
            ranks = spawn(ep_rank, world, (runs, ckdir, wait_for), 900)
        finally:
            if done is not None:
                Path(done).touch()
        log(f"ep {', '.join(runs)} (W {world}): done {time.perf_counter() - t0:.1f} s into "
            "the cells")
        return ranks

    try:
        with ThreadPoolExecutor(3) as pool:
            # (d)'s W 4 ranks start at once but build only once (a) and the
            # bounded slots' W 2 ranks have ended (the card's memory).
            running = [pool.submit(group, 2, ("einsum", "slots"), None, flag),
                       pool.submit(group, 2, ("grouped", "ample")),
                       pool.submit(group, EP["seq_world"], ("seq",), flag)]
            refs = {impl: ep_reference(torch, impl, ckdir) for impl in ("einsum", "grouped")}
            log(f"ep one-process references: {time.perf_counter() - t0:.1f} s")
            while not os.path.exists(f"{ckdir}/ep-grouped.saved") and not running[1].done():
                time.sleep(0.2)
            if os.path.exists(f"{ckdir}/ep-grouped.saved"):
                gen = ep_generate_start(ckdir)
            results = [f.result() for f in running]
        log(f"ep ranks: done {time.perf_counter() - t0:.1f} s into the cells")
        totals = ep_report(results, refs, failed, card)
        if gen is None:
            failed.append("ep: (b) never saved; cli.generate not run")
        else:
            stdout, stderr = gen["proc"].communicate(timeout=600)
            code, lines = gen["proc"].returncode, stdout.splitlines()
            log(f"ep cli.generate --moe --ckpt-dir on (b)'s step-2 checkpoint, 4096 + "
                f"{A5C['gen_new']}: exit code {code} in {time.perf_counter() - gen['t0']:.1f} s "
                f"[{card}]; {lines[:1]}; last line ends {lines[-1][-60:] if lines else ''!r}")
            if code != 0 or not lines:
                failed.append(f"ep cli.generate: exit code {code}: {stderr[-2000:]}")
    finally:
        if gen is not None and gen["proc"].poll() is None:
            gen["proc"].kill()
            gen["proc"].wait()
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"ep launches over the cells: {totals}; cells {time.perf_counter() - t0:.1f} s")
    for key, row in rows.items():
        row["ep_launches"] = totals.get(key.split(":")[0], 0)
    if failed:
        raise AssertionError("ep: " + "; ".join(failed))


# K1-K3 at the A5c paths' shapes: a TP rank's heads (tp W 2 and 3d tp 2: H
# 8 / Hkv 2, B 2 rows) and a pipeline microbatch (pp and 3d dp 2: B 1, H 16
# / Hkv 4), L 2048; K7 on the flat boundary slice of gpipe's
# --overlap-update (a stage's half of embed + ln_f + lm_head).
A5C_SHAPES = [(2, 2048, 8, 2, 128), (1, 2048, 16, 4, 128)]


def check_a5c_shapes(torch, fa, fadam) -> None:
    gen = torch.Generator(device="cuda").manual_seed(20)
    failed: list = []
    for shape in A5C_SHAPES:
        check_flash_case(torch, fa, "a5c", shape, gen, failed)
    V, E = MODEL["vocab_size"], MODEL["d_model"]
    check_adamw_case(torch, fadam, "a5c boundary slice",
                     (-(-(2 * V * E + V + 2 * E) // A5C["pp_world"]),), gen, failed)
    raise_failed(failed)


def check_flash_case(torch, fa, tag: str, shape: tuple, gen, failed: list) -> None:
    """K1-K3 against their plain versions at one (B, L, H, Hkv, D), bf16."""
    B, L, H, Hkv, D = shape
    label = f"{tag} B={B} L={L} H={H} Hkv={Hkv} D={D} bf16"
    q, k, v, do, lse_p, delta = bwd_inputs(torch, fa, B, L, H, Hkv, D, "bfloat16", gen)
    out, lse = fa._launch(q, k, v)
    compare(f"flash_fwd {label}", out, fa.flash_attention_reference(q, k, v), failed)
    if not float((lse - lse_p).abs().max()) <= LSE_TOL:
        failed.append(f"flash_fwd lse {label}")
    args = (q, k, v, do, lse_p, delta)
    dq = fa._launch_dq(*args)
    dk, dv = fa._launch_dkv(*args)
    torch.cuda.synchronize()
    ref = fa.flash_attention_backward_reference(*args)
    compare(f"flash_bwd_dq {label}", dq, ref[0], failed, GRAD_ROW_FLOOR)
    compare(f"flash_bwd_dkv dk {label}", dk, ref[1], failed, GRAD_ROW_FLOOR)
    compare(f"flash_bwd_dkv dv {label}", dv, ref[2], failed, GRAD_ROW_FLOOR)


def check_adamw_case(torch, fadam, tag: str, shape: tuple, gen, failed: list) -> None:
    """K7 against its plain version on one f32 leaf of ``shape`` at step 10,
    within ADAMW_ULP_TOL."""
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig

    cfg = AdamWConfig()
    old = (0.02 * torch.randn(shape, device="cuda", generator=gen),
           1e-3 * torch.randn(shape, device="cuda", generator=gen),
           1e-6 * torch.rand(shape, device="cuda", generator=gen),
           1e-3 * torch.randn(shape, device="cuda", generator=gen))
    got, want = [t.clone() for t in old], [t.clone() for t in old]
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    fadam.fused_adamw_leaf(*got, *adamw_scalars(10, cfg), **hyper)
    torch.cuda.synchronize()
    fadam.fused_adamw_reference(*want, *adamw_scalars(10, cfg), **hyper)
    errs = adamw_ulp_errs(got, want, old, cfg)
    n = math.prod(shape)
    log(f"  fused_adamw {tag} {'x'.join(map(str, shape))} (n={n}) f32: ulp error p/mu/nu "
        f"{errs[0]:.0f}/{errs[1]:.0f}/{errs[2]:.0f} (tol {ADAMW_ULP_TOL})")
    if not max(errs) <= ADAMW_ULP_TOL:
        failed.append(f"fused_adamw {tag} n={n}")


# The EP cells' shapes (step 10c): K1-K3 at an einsum rank's rows (B 4: the
# data axis is 1, so each rank holds the whole batch) and a grouped rank's
# (B 2), H 16 / Hkv 4, L 2048; K11-K13 at --ep-seq's chunk (B 2 x Lc 1024);
# K7 on a rank's block of an expert leaf (4 of the 8 experts of w_in, d 2048
# x d_ff 8192).
EP_SHAPES = [(4, 2048, 16, 4, 128), (2, 2048, 16, 4, 128)]
EP_RING = (2, (1024, 16, 4, 128, "bfloat16"))
EP_EXPERT_BLOCK = (4, 2048, 8192)


def check_ep_shapes(torch, fa, fadam, rf) -> None:
    gen = torch.Generator(device="cuda").manual_seed(22)
    failed: list = []
    for shape in EP_SHAPES:
        check_flash_case(torch, fa, "ep", shape, gen, failed)
    B, case = EP_RING
    check_ring_case(torch, rf, case, gen, {k: [] for k in RING_KERNELS}, failed, B)
    check_adamw_case(torch, fadam, "ep expert block", EP_EXPERT_BLOCK, gen, failed)
    raise_failed(failed)


# -- The A4 paths: ResNets, LARS, schedules, accumulation, the parts'
# checkpoints, the native loader, the parity report, the LM's SGD and LARS.
A4 = dict(resnet_iters=40, resnet_bf16_iters=20, resnet50_iters=5, fused_iters=4,
          ckpt_iters=3, lars_model="vgg11", lars_batch=256, lars_iters=8, lm_iters=3,
          parity_iters=4, gate_batch=256)
A4_LOSS_RTOL = 1e-5  # the first ResNet-18 step's loss, card vs CPU (f32, TF32 off)
# Its gradients are held against an f64 CPU copy of the step: at init they
# move by a few 1e-3 relative under f32 summation order alone
# (``tools/resnet_grad_noise.py``), so the card may sit at most this factor
# above the CPU f32 step's own distance from f64, or 1e-4, over all leaves
# and per leaf.
A4_GRAD_NOISE_FACTOR = 2.5
A4_GRAD_FLOOR = 1e-4
# A LARS update, card vs the same update in f64 on the CPU (``plain_lars64``):
# the new momentum (= the scaled step, f32 norms of ~2.4 M elements) within
# this relative L2 a leaf; each new parameter within the momentum's
# difference plus 4 f32 rounding units of |p| + |m| (p - m is rounded once).
A4_LARS_TOL = 1e-5
A4_LARS_ROUND = 2.0 ** -22
A4_ACCUM_TOL = 1e-4  # --grad-accum 2 vs one step, BN-free: rel. L2 of each synced leaf
FLASH_AND_ADAMW = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_adamw")


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def a4_args(part: str, *flags: str):
    """A part CLI's flags, parsed by its own parser."""
    from distributed_machine_learning_tpu_torch.cli import common, part3

    parser = part3.make_parser() if part == "part3" else common.make_flag_parser(part)
    return common.parse_flags(parser, list(flags))


def cpu_tree(tree: dict) -> dict:
    """A nested dict of tensors, cloned to the CPU."""
    return {k: cpu_tree(v) if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in tree.items()}


def clone_tree(tree: dict) -> dict:
    """A nested dict of tensors, cloned where they lie."""
    return {k: clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


@contextlib.contextmanager
def a4_watch_update(at: int = 1):
    """Patch ``run_part``'s step factory and epoch loop so that the update
    of step ``at`` (from 0) of the run inside is seen: ``held["pre"]`` =
    (params, momentum, synced grads, step) as that update starts,
    ``held["post"]`` = (params, momentum) as the next step's starts; clones
    on the state's device."""
    from distributed_machine_learning_tpu_torch.train import loop
    from distributed_machine_learning_tpu_torch.train import step as step_mod

    held: dict = {}
    real_epoch, real_make = loop.train_epoch, step_mod.make_train_step

    def spy_epoch(step, state, *args, **kw):
        held["state"] = state
        return real_epoch(step, state, *args, **kw)

    def spy_make(model, *args, **kw):
        step = real_make(model, *args, **kw)
        calls = [0]

        def observe(grads, res):
            st = held["state"]
            if calls[0] == at:
                held["pre"] = (clone_tree(st.params), clone_tree(st.momentum),
                               {n: g.detach().clone() for n, g in zip(st.params, grads)},
                               st.step)
            elif calls[0] == at + 1:
                held["post"] = (clone_tree(st.params), clone_tree(st.momentum))
            calls[0] += 1

        step.observe = observe
        return step

    loop.train_epoch, step_mod.make_train_step = spy_epoch, spy_make
    try:
        yield held
    finally:
        loop.train_epoch, step_mod.make_train_step = real_epoch, real_make


def state_snapshot(state) -> dict:
    return {"params": cpu_tree(state.params), "batch_stats": cpu_tree(state.batch_stats),
            "momentum": cpu_tree(state.momentum), "step": int(state.step)}


def trees_bit_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(trees_bit_equal(torch, a[k], b[k]) for k in a))
    if isinstance(a, int):
        return a == b
    return bits_equal(torch, a, b)


def leaf_rel_l2(got: dict, want: dict) -> tuple:
    """(worst relative L2 over the leaves, its name)."""
    worst = max(((rel_l2(got[k].float(), want[k].float()), k) for k in want),
                key=lambda x: x[0])
    return worst


def a4_first_step_gate(torch, model_name: str = "resnet18", batch: int = 256) -> dict:
    """The first part1 step of ``model_name`` (seeded init, the first batch,
    augmentation on) on the card in f32, on the CPU in f32 and in f64: the
    card's loss against the CPU's f32 one, its gradients (all leaves and the
    worst leaf) against the f64 ones beside the CPU f32 step's own distance."""
    from distributed_machine_learning_tpu_torch.cli.common import SEED
    from distributed_machine_learning_tpu_torch.data.cifar10 import load_cifar10
    from distributed_machine_learning_tpu_torch.data.loader import BatchLoader
    from distributed_machine_learning_tpu_torch.models.registry import get_model, init_params
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    images, labels = next(iter(BatchLoader(load_cifar10("./data", train=True), batch)))
    out = {}
    for key, dev, dt in (("card", card_device(torch), torch.float32),
                         ("cpu", torch.device("cpu"), torch.float32),
                         ("f64", torch.device("cpu"), torch.float64)):
        model = init_params(get_model(model_name, device="cpu", compute_dtype=dt), SEED)
        model = model.to(dev, dt)
        state = TrainState.create(model, SGDConfig())
        step = make_train_step(model)
        seen = {}
        step.observe = lambda grads, res, m=model: seen.update(
            grads={n: g.detach().cpu().double() for (n, _), g in
                   zip(m.named_parameters(), grads)})
        _, loss = step(state, torch.from_numpy(images).to(dev),
                       torch.from_numpy(labels).to(dev, torch.long))
        out[key] = (float(loss), seen["grads"])

    def whole(a, b):
        return rel_l2(torch.cat([a[k].reshape(-1) for k in b]),
                      torch.cat([b[k].reshape(-1) for k in b]))

    (lc, gcard), (lp, gcpu), (_, g64) = out["card"], out["cpu"], out["f64"]
    noise, noise_leaf = whole(gcpu, g64), leaf_rel_l2(gcpu, g64)[0]
    leaf, name = leaf_rel_l2(gcard, g64)
    return {"loss": lc, "plain_loss": lp, "loss_rel": abs(lc - lp) / abs(lp),
            "grad_rel": whole(gcard, g64), "noise": noise,
            "limit": max(A4_GRAD_FLOOR, A4_GRAD_NOISE_FACTOR * noise),
            "leaf_rel": leaf, "grad_leaf": name, "leaf_noise": noise_leaf,
            "leaf_limit": max(A4_GRAD_FLOOR, A4_GRAD_NOISE_FACTOR * noise_leaf),
            "card_vs_cpu": whole(gcard, gcpu)}


def a4_part1(torch, build, label: str, flags: list) -> dict:
    """One part1 run through ``run_part`` with the launch counts zeroed just
    before and read just after; step ms, images/s, peak memory."""
    from distributed_machine_learning_tpu_torch.cli import common

    args = a4_args("part1", *flags)
    _sync(torch)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = common.run_part("none", 256, False, args, shutdown=False)
    _sync(torch)
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9 if torch.cuda.is_available() else 0.0
    ms = [t * 1e3 for t in res["times"]]
    med = sorted(ms)[len(ms) // 2]
    batch = args.batch_size or 256
    n_params = sum(p.numel() for p in res["state"].model.parameters())
    n_leaves = sum(1 for _ in res["state"].model.parameters())
    finite = all(math.isfinite(x) for x in res["losses"])
    log(f"a4 {label}: {args.model} part1 B {batch}, {n_params} params in {n_leaves} "
        f"leaves, {args.compute_dtype}, --optimizer {args.optimizer}; losses "
        f"{[round(x, 4) for x in res['losses'][:2]]} ... "
        f"{[round(x, 4) for x in res['losses'][-2:]]}; step ms {spread(ms)} -> "
        f"{batch / med * 1e3:.0f} images/s; peak memory {peak:.2f} GB")
    if not finite:
        raise AssertionError(f"a4 {label}: losses not finite")
    return {"res": res, "args": args, "launches": launches, "n_params": n_params,
            "n_leaves": n_leaves, "ms": ms, "peak": peak}


def a4_adamw_gate(torch, run: dict, held: dict) -> dict:
    """K7's update in the fused run (``a4_watch_update``'s step: non-zero
    moments) against ``fused_adamw_reference`` on the same leaves, on the
    same device: the worst ulp error of p, mu and nu over the leaves
    (``adamw_ulp_errs``), the largest absolute error, the leaf sizes."""
    import dataclasses

    from distributed_machine_learning_tpu_torch.cli.common import make_schedule
    from distributed_machine_learning_tpu_torch.ops import fused_adamw as fadam

    params, mom, grads, at = held["pre"]
    post_p, post_m = held["post"]
    cfg = run["res"]["state"].config
    schedule = make_schedule(run["args"], cfg.learning_rate)
    if schedule is not None:
        cfg = dataclasses.replace(cfg, learning_rate=schedule(at))
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    ulp, worst_abs, worst_leaf = [0.0, 0.0, 0.0], 0.0, None
    for k, p in params.items():
        old = (p, mom["mu"][k], mom["nu"][k], grads[k])
        want = [t.clone() for t in old]
        fadam.fused_adamw_reference(*want, *adamw_scalars(at, cfg), **hyper)
        got = (post_p[k], post_m["mu"][k], post_m["nu"][k])
        errs = adamw_ulp_errs(got, want, old, cfg, step=at)
        if max(errs) > max(ulp):
            worst_leaf = k
        ulp = [max(a, b) for a, b in zip(ulp, errs)]
        worst_abs = max(worst_abs, *(float((got[i] - want[i]).abs().max()) for i in range(3)))
    sizes = sorted(p.numel() for p in params.values())
    return {"ulp": ulp, "abs": worst_abs, "leaf": worst_leaf, "step": at,
            "n_leaves": len(sizes), "sizes": (sizes[0], sizes[-1])}


def a4_resnets(torch, build, card: str, totals: dict) -> dict:
    """Legs (a) and (b): ResNet-18 part1 in f32 and bf16 and with the fused
    AdamW update (its K7 updates held to the plain version on one step);
    ResNet-50 part1.  Returns the K7 gate's reading."""
    t0 = time.perf_counter()
    gate = a4_first_step_gate(torch, batch=A4["gate_batch"])
    log(f"a4 (a) resnet18 first step, card vs CPU copy: loss {gate['loss']:.6f} vs "
        f"{gate['plain_loss']:.6f} (rel {gate['loss_rel']:.2e}, limit {A4_LOSS_RTOL}); "
        f"gradients vs the f64 CPU step: rel L2 {gate['grad_rel']:.2e} (CPU f32's own "
        f"{gate['noise']:.2e}, limit {gate['limit']:.2e}), worst leaf {gate['leaf_rel']:.2e} "
        f"({gate['grad_leaf']}; CPU f32's worst {gate['leaf_noise']:.2e}, limit "
        f"{gate['leaf_limit']:.2e}); card vs CPU f32 {gate['card_vs_cpu']:.2e}")
    if (gate["loss_rel"] > A4_LOSS_RTOL or gate["grad_rel"] > gate["limit"]
            or gate["leaf_rel"] > gate["leaf_limit"]):
        raise AssertionError(f"a4 (a): ResNet-18's first step differs from the CPU copy: "
                             f"{gate}")
    run = a4_part1(torch, build, "(a) f32", ["--model", "resnet18", "--max-iters",
                                             str(A4["resnet_iters"])])
    if run["n_params"] != RESNET18_PARAMS:
        raise AssertionError(f"ResNet-18 (CIFAR stem) has {run['n_params']} parameters, "
                             f"want {RESNET18_PARAMS}")
    res = run["res"]
    images, labels = res["place"](*next(res["batches"]()))
    if torch.cuda.is_available():
        profile_steps(torch, "a4 resnet18 part1 step (f32, B 256)",
                      lambda i: res["step"](res["state"], images, labels), steps=3)
    log(f"a4 (a) f32: {card}")
    a4_part1(torch, build, "(a) bf16", ["--model", "resnet18", "--compute-dtype", "bfloat16",
                                        "--max-iters", str(A4["resnet_bf16_iters"])])
    with a4_watch_update() as held:
        fused = a4_part1(torch, build, "(a) adamw fused",
                         ["--model", "resnet18", "--optimizer", "adamw", "--fused-update",
                          "--max-iters", str(A4["fused_iters"]), "--eval-batches", "1"])
    want = fused["n_leaves"] * A4["fused_iters"]
    got = fused["launches"].get("fused_adamw", 0)
    k7 = a4_adamw_gate(torch, fused, held)
    log(f"a4 (a) adamw fused: K7 launches {got} (want {fused['n_leaves']} leaves x "
        f"{A4['fused_iters']} steps = {want}); step {k7['step']}'s update of the "
        f"{k7['n_leaves']} leaves ({k7['sizes'][0]} to {k7['sizes'][1]} elements) vs "
        f"fused_adamw_reference: ulp error p/mu/nu {k7['ulp'][0]:.0f}/{k7['ulp'][1]:.0f}/"
        f"{k7['ulp'][2]:.0f} (tol {ADAMW_ULP_TOL}; worst leaf {k7['leaf']}), max abs "
        f"{k7['abs']:.3g}")
    if torch.cuda.is_available() and got != want:
        raise AssertionError(f"a4 (a): K7 launched {got} times, want {want}")
    if max(k7["ulp"]) > ADAMW_ULP_TOL:
        raise AssertionError(f"a4 (a): K7's update of ResNet-18's leaves differs from the "
                             f"plain version: {k7}")
    _add_launches(totals, fused["launches"])
    del res, run, fused, held
    gc.collect()
    r50 = a4_part1(torch, build, "(b)", ["--model", "resnet50", "--max-iters",
                                         str(A4["resnet50_iters"]), "--eval-batches", "1"])
    log(f"a4 (b) resnet50: step ms {spread(r50['ms'])}, peak {r50['peak']:.2f} GB; {card}")
    del r50
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"a4 (a)-(b): {time.perf_counter() - t0:.1f} s")
    return k7


def _add_launches(totals: dict, launches: dict) -> None:
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def a4_ckpt_rank(rank: int, world: int, init_method: str, ckdir: str) -> dict:
    """Leg (c), one rank: ResNet-18 part3 int8 saves, its resume, a resumed
    part2b's next step against the uninterrupted one, an async save, and
    ``--resume auto`` over an attempt that raises."""
    import io

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the bit-for-bit gates
    torch.backends.cudnn.benchmark = False
    from distributed_machine_learning_tpu_torch.cli import common
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.train import checkpoint, loop

    legs = iter(range(1, 100))

    def im():  # a fresh file:// rendezvous for each leg's group
        return f"{init_method}_{next(legs)}"

    def flags(*extra):
        return [*extra, "--model", "resnet18", "--num-nodes", str(world), "--rank",
                str(rank), "--eval-batches", "1"]

    def part3(*extra, spy=None):
        a = a4_args("part3", *flags(*extra))
        out = io.StringIO()
        real = loop.train_epoch
        if spy is not None:
            loop.train_epoch = spy(real)
        try:
            with contextlib.redirect_stdout(out):
                res = common.run_part("ring", 64, True, a, {"bucket_bytes": a.bucket_mb * 2**20},
                                      init_method=im())
        finally:
            loop.train_epoch = real
        return res, out.getvalue()

    rec: dict = {"rank": rank}
    p3 = os.path.join(ckdir, "p3")
    int8 = ["--ring-compress", "int8", "--ring-codec-impl", "pallas"]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res, _ = part3(*int8, "--ckpt-dir", p3, "--keep-last-n", "2", "--max-iters",
                   str(A4["ckpt_iters"]))
    _sync(torch)
    rec["save_s"] = time.perf_counter() - t0
    rec["launches"] = dict(build.launches)
    rec["n_params"] = sum(p.numel() for p in res["state"].model.parameters())
    rec["ms"] = [t * 1e3 for t in res["times"]]
    saved = state_snapshot(res["state"])
    rec["saved_step"] = saved["step"]

    entry: dict = {}

    def capture(real):
        def spy(step, state, *a, **k):
            entry.setdefault("state", state_snapshot(state))
            return real(step, state, *a, **k)
        return spy

    t0 = time.perf_counter()
    res, text = part3(*int8, "--ckpt-dir", p3, "--resume", "--max-iters", "1", spy=capture)
    rec["resume_s"] = time.perf_counter() - t0
    rec["restored_bit_equal"] = trees_bit_equal(torch, entry["state"], saved)
    rec["note"] = "NOTE: error-feedback residuals" in text or rank != 0
    rec["resumed_line"] = next((ln for ln in text.splitlines() if ln.startswith("Resumed")),
                               None)

    # A resumed part2b's next step against the uninterrupted run's.
    p2 = os.path.join(ckdir, "p2b")
    a = a4_args("part2b", *flags("--ckpt-dir", p2, "--max-iters", str(A4["ckpt_iters"])))
    with contextlib.redirect_stdout(io.StringIO()):
        res = common.run_part("all_reduce", 64, False, a, init_method=im(), shutdown=False)
    try:
        images, labels = res["place"](*next(res["batches"]()))
        state, loss = res["step"](res["state"], images, labels)
        straight = (float(loss), state_snapshot(state))
    finally:
        res["ctx"].shutdown()
    a = a4_args("part2b", *flags("--ckpt-dir", p2, "--resume", "--max-iters", "1"))
    with contextlib.redirect_stdout(io.StringIO()):
        res = common.run_part("all_reduce", 64, False, a, init_method=im())
    resumed = (res["losses"][0], state_snapshot(res["state"]))
    rec["part2b_loss"] = (straight[0], resumed[0])
    rec["part2b_bit_equal"] = (straight[0] == resumed[0]
                               and trees_bit_equal(torch, straight[1], resumed[1]))

    # An async save, then --resume auto whose first attempt raises.
    pa = os.path.join(ckdir, "async")
    t0 = time.perf_counter()
    res, text = part3("--ckpt-dir", pa, "--async-ckpt", "--max-iters", "2")
    rec["async_s"] = time.perf_counter() - t0
    rec["async_valid"] = checkpoint.validate_checkpoint(os.path.join(pa, "step_2")) == []

    def flaky(real):  # the second epoch's training raises, once
        calls = [0]

        def spy(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected failure in the second epoch")
            return real(*a, **k)
        return spy

    pauto = os.path.join(ckdir, "auto")
    res, text = part3("--ckpt-dir", pauto, "--resume", "auto", "--epochs", "2",
                      "--max-iters", "2", spy=flaky)
    rec["auto_restarts"] = res["events"].restarts
    rec["auto_step"] = res["state"].step
    rec["auto_resumed"] = [ln for ln in text.splitlines() if ln.startswith("Resumed")]
    rec["auto_saved"] = sorted(os.listdir(pauto))
    return rec


def a4_checkpoints(torch, totals: dict, card: str) -> None:
    """Leg (c): ``a4_ckpt_rank`` on 2 ranks sharing the card."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    t0 = time.perf_counter()
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="a4_ckpt_", dir=build_dir)
    try:
        ranks = spawn(a4_ckpt_rank, 2, (ckdir,), timeout_s=900)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    r0 = ranks[0]
    want = {k: v * A4["ckpt_iters"] for k, v in codec_launches_per_step(2, r0["n_params"]).items()}
    got = [{k: r["launches"].get(k, 0) for k in CODEC_KERNELS} for r in ranks]
    log(f"a4 (c) resnet18 part3 int8 W 2 (gloo, one card): {r0['n_params']} params; step ms "
        f"{spread(r0['ms'])}; save run {r0['save_s']:.1f} s, resume run {r0['resume_s']:.1f} s, "
        f"async run {r0['async_s']:.1f} s; {card}")
    log(f"a4 (c) K8-K10 launches by rank {got} (want {want} over {A4['ckpt_iters']} steps)")
    log(f"a4 (c) resume: {r0['resumed_line']}; restored params/BN stats/momentum/step bit for "
        f"bit the saved ones, by rank: {[r['restored_bit_equal'] for r in ranks]}; residual "
        f"NOTE printed: {r0['note']}")
    log(f"a4 (c) part2b: the resumed run's next step vs the uninterrupted run's (loss "
        f"{r0['part2b_loss']}), bit for bit by rank: {[r['part2b_bit_equal'] for r in ranks]}")
    log(f"a4 (c) async save valid: {[r['async_valid'] for r in ranks]}; --resume auto, 2 "
        f"epochs of 2 steps, the second epoch raising once: restarts "
        f"{[r['auto_restarts'] for r in ranks]}, final step {[r['auto_step'] for r in ranks]}, "
        f"{r0['auto_resumed']}, saved {r0['auto_saved']}")
    failed = []
    if r0["n_params"] != RESNET18_PARAMS:  # check_codec holds resnet18_chunks() bit for bit
        failed.append(f"{r0['n_params']} parameters, not the {RESNET18_PARAMS} whose ring "
                      "chunks step 2 checks")
    if torch.cuda.is_available() and any(g != want for g in got):
        failed.append("K8-K10 launch counts")
    for key in ("restored_bit_equal", "part2b_bit_equal", "note", "async_valid"):
        if not all(r[key] for r in ranks):
            failed.append(key)
    if not all(r["auto_restarts"] == 1 and r["auto_step"] == 4 for r in ranks) or (
            len(r0["auto_resumed"]) != 1 or not r0["auto_resumed"][0].endswith("(step 2)")):
        failed.append("--resume auto")
    if failed:
        raise AssertionError(f"a4 (c) failed: {failed}")
    _add_launches(totals, {k: r0["launches"].get(k, 0) for k in CODEC_KERNELS})
    log(f"a4 (c): {time.perf_counter() - t0:.1f} s")


def a4_lars_rank(rank: int, world: int, init_method: str) -> dict:
    """Leg (d), one rank: part2b VGG-11 with LARS, a cosine schedule,
    ``--grad-accum 2``, ``--dist-eval`` and the native loader; then its gates."""
    import io

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_machine_learning_tpu_torch.cli import common
    from distributed_machine_learning_tpu_torch.data import native_loader
    from distributed_machine_learning_tpu_torch.data.cifar10 import load_cifar10
    from distributed_machine_learning_tpu_torch.data.distributed_loader import (
        DistributedBatchLoader,
    )
    from distributed_machine_learning_tpu_torch.data.loader import BatchLoader
    from distributed_machine_learning_tpu_torch.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.train import loop
    from distributed_machine_learning_tpu_torch.train import step as step_mod
    from distributed_machine_learning_tpu_torch.train.lars import lars_update

    B = A4["lars_batch"]
    a = a4_args("part2b", "--model", A4["lars_model"], "--optimizer", "lars",
                "--lr-schedule", "cosine", "--warmup-steps", "4", "--grad-accum", "2",
                "--dist-eval", "--loader", "native", "--batch-size", str(B),
                "--max-iters", str(A4["lars_iters"]), "--eval-batches", "4",
                "--num-nodes", str(world), "--rank", str(rank))
    with a4_watch_update() as held, contextlib.redirect_stdout(io.StringIO()):
        res = common.run_part("all_reduce", 64, False, a, init_method=init_method,
                              shutdown=False)
    rec: dict = {"rank": rank, "losses": res["losses"], "ms": [t * 1e3 for t in res["times"]]}
    try:
        state, comm = res["state"], res["ctx"].comm
        # The LARS update of step 1 (lr from the schedule) against the CPU's.
        params, mom, grads = (cpu_tree(t) for t in held["pre"][:3])
        at = held["pre"][3]
        lr = common.make_schedule(a, state.config.learning_rate)(at)
        p64, m64 = plain_lars64(params, mom, grads, state.config, lr)
        lars_update(params, mom, grads, state.config, lr=lr)  # the CPU's f32 update
        post_p, post_m = (cpu_tree(t) for t in held["post"])
        rec["lars_lr"] = lr
        rec["lars_rel"] = leaf_rel_l2(post_m, m64)
        rec["lars_cpu_rel"] = leaf_rel_l2(mom, m64)
        rec["lars_excess"] = max(float(((post_p[k].double() - p64[k]).abs()
                                        - (post_m[k].double() - m64[k]).abs()
                                        - A4_LARS_ROUND * (p64[k].abs() + m64[k].abs())).max())
                                 for k in p64)
        # --grad-accum 2 against one step of the whole batch, from one state.
        images, labels = res["place"](*next(res["batches"]()))
        seen = {}
        snap = _snapshot(state, res["step"])
        for k in (1, 2):
            st = step_mod.make_train_step(state.model, get_strategy("all_reduce"), comm,
                                          accum_steps=k)
            st.observe = lambda g, r, k=k: seen.__setitem__(
                k, {n: t.detach().cpu().clone() for n, t in zip(state.params, g)})
            st(state, images, labels)
            _restore(state, st, snap)
        rec["accum_rel"] = leaf_rel_l2(seen[2], seen[1])
        # The native loader's batches against the Python loader's.
        train_set = load_cifar10("./data", train=True)
        nat = native_loader.NativeDistributedBatchLoader(train_set, B, world, rank)
        py = DistributedBatchLoader(train_set, B, world, rank)
        rec["native_equal"] = len(nat) == len(py) and all(
            (x[0] == y[0]).all() and (x[1] == y[1]).all()
            for x, y in zip(itertools.islice(nat, 5), itertools.islice(py, 5)))
        # The sharded eval against the one-rank eval, as printed.
        test_set = load_cifar10("./data", train=False)
        with contextlib.redirect_stdout(io.StringIO()):
            sharded = loop.evaluate(step_mod.make_eval_step(state.model, comm),
                                    itertools.islice(iter(BatchLoader(test_set, 256)), 4),
                                    place_batch=res["place"])
            single = loop.evaluate(step_mod.make_eval_step(state.model),
                                   itertools.islice(iter(BatchLoader(test_set, 256)), 4),
                                   place_batch=res["place"])
        rec["eval"] = (sharded, single)
        rec["eval_equal"] = (f"{sharded[0]:.4f}" == f"{single[0]:.4f}"
                             and sharded[1] == single[1])
    finally:
        res["ctx"].shutdown()
    return rec


def plain_lars64(params: dict, mom: dict, grads: dict, config, lr: float):
    """One LARS step (``train/lars.py``'s rule) in f64 on CPU copies:
    (new params, new momentum)."""
    import torch

    new_p, new_m = {}, {}
    wd, trust = config.weight_decay, config.trust_coefficient
    for k, p in params.items():
        p, g, m = p.double(), grads[k].double(), mom[k].double()
        wn, gn = p.norm(), g.norm()
        scale = (trust * wn / (gn + wd * wn + config.eps) if wn > 0 and gn > 0
                 else torch.tensor(1.0, dtype=torch.float64))
        new_m[k] = config.momentum * m + lr * scale * (g + wd * p)
        new_p[k] = p - new_m[k]
    return new_p, new_m


def a4_lars(torch, card: str) -> None:
    """Leg (d): ``a4_lars_rank`` on 2 ranks sharing the card."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    t0 = time.perf_counter()
    ranks = spawn(a4_lars_rank, 2, (), timeout_s=900)
    r0 = ranks[0]
    B = A4["lars_batch"]
    med = sorted(r0["ms"])[len(r0["ms"]) // 2]
    log(f"a4 (d) part2b vgg11 LARS, cosine (warmup 4), --grad-accum 2, --dist-eval, native "
        f"loader, W 2 x B {B}: losses {[round(x, 4) for x in r0['losses']]}; step ms "
        f"{spread(r0['ms'])} -> {2 * B / med * 1e3:.0f} images/s; {card}")
    log(f"a4 (d) LARS update of step 1 (lr {r0['lars_lr']:.4g}) vs the f64 CPU update: new "
        f"momentum, worst leaf rel L2 by rank {[r['lars_rel'] for r in ranks]} (limit "
        f"{A4_LARS_TOL}; the CPU's f32 update: {r0['lars_cpu_rel']}); new parameters, largest "
        f"excess over the bound {[r['lars_excess'] for r in ranks]} (must be <= 0)")
    log(f"a4 (d) --grad-accum 2 vs one B {B} step (BN-free): worst synced leaf rel L2 by rank "
        f"{[r['accum_rel'] for r in ranks]} (limit {A4_ACCUM_TOL})")
    log(f"a4 (d) native loader batches == python loader's: {[r['native_equal'] for r in ranks]}"
        f"; --dist-eval (loss, accuracy) vs one-rank eval by rank "
        f"{[r['eval'] for r in ranks]}")
    failed = []
    if not all(math.isfinite(x) for r in ranks for x in r["losses"]):
        failed.append("losses not finite")
    if any(r["lars_rel"][0] > A4_LARS_TOL or r["lars_excess"] > 0 for r in ranks):
        failed.append("LARS update")
    if any(r["accum_rel"][0] > A4_ACCUM_TOL for r in ranks):
        failed.append("--grad-accum")
    if not all(r["native_equal"] and r["eval_equal"] for r in ranks):
        failed.append("native loader / dist eval")
    if failed:
        raise AssertionError(f"a4 (d) failed: {failed}")
    log(f"a4 (d): {time.perf_counter() - t0:.1f} s")


def a4_parity_start() -> dict:
    """Leg (e): the real ``cli.parity`` commands (the report, then
    ``--equivalence``), one after the other on a background thread, each in
    its own process group; ``a4_parity_finish`` joins and checks them,
    ``a4_parity_stop`` kills them."""
    import threading

    repo = Path(__file__).resolve().parent
    build_dir = repo / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="a4_parity_", dir=build_dir)
    base = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.parity",
            "--max-iters", str(A4["parity_iters"]), "--num-nodes", "2"]
    job = {"t0": time.perf_counter(), "tmp": tmp, "runs": {}, "proc": None, "stop": False,
           "rows": os.path.join(tmp, "rows.json"), "eq": os.path.join(tmp, "eq.json")}

    def work():
        for extra, what in ((["--eval-batches", "1", "--json", job["rows"]], "report"),
                            (["--equivalence", "--json", job["eq"]], "equivalence")):
            if job["stop"]:
                return
            proc = subprocess.Popen([*base, *extra], cwd=repo, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, start_new_session=True)
            job["proc"] = proc
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                _kill_group(proc)
                out, err = proc.communicate()
            job["runs"][what] = (proc.returncode, out, err)

    job["thread"] = threading.Thread(target=work, name="a4-parity", daemon=True)
    job["thread"].start()
    return job


def _kill_group(proc) -> None:
    """Kill a process started with ``start_new_session`` and its children."""
    import signal

    if proc is not None and proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def a4_parity_stop(job: dict) -> None:
    job["stop"] = True
    _kill_group(job["proc"])
    job["thread"].join(timeout=60)
    shutil.rmtree(job["tmp"], ignore_errors=True)


def a4_parity_finish(job: dict) -> None:
    try:
        job["thread"].join(timeout=1300)
        if job["thread"].is_alive():
            raise AssertionError("a4 (e): cli.parity did not finish")
        for what, (rc, out, err) in job["runs"].items():
            log(f"a4 (e) cli.parity {what}: exit code {rc}")
            for ln in out.strip().splitlines()[:24]:
                log(f"  {ln}")
            if rc != 0:
                raise AssertionError(f"cli.parity {what} failed: {(out + err)[-3000:]}")
        rows = json.loads(Path(job["rows"]).read_text())
        eq = json.loads(Path(job["eq"]).read_text())
    finally:
        a4_parity_stop(job)
    if [row["part"] for row in rows] != ["part1", "part2a", "part2b", "part3"] or not all(
            row["data"] == "synthetic" for row in rows) or not eq["ok"]:
        raise AssertionError(f"a4 (e): rows {[(r['part'], r['data']) for r in rows]}, "
                             f"equivalence {eq}")
    log(f"a4 (e): {time.perf_counter() - job['t0']:.1f} s from its start")


def a4_lm_args(opt: list):
    from distributed_machine_learning_tpu_torch.cli import lm

    return lm.make_parser().parse_args([
        "--parallel", "dp", "--d-model", str(MODEL["d_model"]),
        "--n-layers", str(MODEL["n_layers"]), "--n-heads", str(MODEL["n_heads"]),
        "--n-kv-heads", str(MODEL["n_kv_heads"]), "--vocab", str(MODEL["vocab_size"]),
        "--seq-len", str(TRAIN["seq_len"]), "--batch-size", str(TRAIN["batch_size"]),
        "--compute-dtype", "bfloat16", "--attn", "flash", "--max-iters",
        str(A4["lm_iters"]), *opt])


def a4_lm(torch, build, totals: dict, card: str) -> None:
    """Leg (f): ``cli.lm`` dp under AdamW (fused), SGD with bf16 momentum and
    LARS: launches, step-0 loss, momentum bytes, step ms."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    t0 = time.perf_counter()
    runs = {}
    for label, opt in (("adamw", ["--optimizer", "adamw", "--fused-update"]),
                       ("sgd", ["--optimizer", "sgd", "--momentum-dtype", "bfloat16"]),
                       ("lars", ["--optimizer", "lars"])):
        args = a4_lm_args(opt)
        step, state, place, model = lm.build(args)
        leaves = [t for v in state.momentum.values()
                  for t in (v.values() if isinstance(v, dict) else [v])]
        mom_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
        losses: list = []
        _sync(torch)
        build.reset_launch_counts()
        state, timer = train_epoch(recorded(step, losses), state, lm.synthetic_batches(args),
                                   place_batch=place, max_iters=args.max_iters)
        _sync(torch)
        launches = dict(build.launches)
        runs[label] = {"losses": [float(x) for x in losses], "ms": [t * 1e3 for t in timer.times],
                       "mom_gb": mom_gb, "launches": launches}
        log(f"a4 (f) cli.lm dp --optimizer {' '.join(opt[1:])}: losses "
            f"{[round(x, 4) for x in runs[label]['losses']]}; step ms "
            f"{spread(runs[label]['ms'])}; momentum {mom_gb:.3f} GB a rank; launches "
            f"{ {k: launches.get(k, 0) for k in FLASH_AND_ADAMW} }")
        if label != "adamw":
            _add_launches(totals, {k: launches.get(k, 0) for k in FLASH_KERNELS})
        del step, state, place, model, leaves
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    failed = []
    want = MODEL["n_layers"] * A4["lm_iters"]
    for label in ("sgd", "lars"):
        r = runs[label]
        if r["losses"][0] != runs["adamw"]["losses"][0]:
            failed.append(f"{label}: step-0 loss {r['losses'][0]} != AdamW's "
                          f"{runs['adamw']['losses'][0]}")
        if not all(math.isfinite(x) for x in r["losses"]):
            failed.append(f"{label}: losses not finite")
        if torch.cuda.is_available() and any(r["launches"].get(k, 0) != want
                                             for k in FLASH_KERNELS):
            failed.append(f"{label}: K1-K3 launches {r['launches']} (want {want} each)")
        if r["launches"].get("fused_adamw", 0):
            failed.append(f"{label}: K7 launched")
    log(f"a4 (f) momentum a rank: sgd bf16 {runs['sgd']['mom_gb']:.3f} GB, lars "
        f"{runs['lars']['mom_gb']:.3f} GB, AdamW's two f32 moments {runs['adamw']['mom_gb']:.3f} "
        f"GB; step ms medians sgd {sorted(runs['sgd']['ms'])[len(runs['sgd']['ms']) // 2]:.2f}, "
        f"lars {sorted(runs['lars']['ms'])[len(runs['lars']['ms']) // 2]:.2f}, adamw "
        f"{sorted(runs['adamw']['ms'])[len(runs['adamw']['ms']) // 2]:.2f}; {card}")
    if failed:
        raise AssertionError(f"a4 (f) failed: {failed}")
    log(f"a4 (f): {time.perf_counter() - t0:.1f} s")


def run_a4(torch, build, rows: dict, card: str) -> dict:
    """The A4 phase (docstring step 11): the timed legs (a), (b) and (f)
    first; then leg (e) starts in the background (``a4_parity_start``) and
    runs beside (c), (d) and the card tests, none of which is timed against
    a prediction; the caller finishes it (``a4_parity_finish``) and gets its
    job back.  Each kernel's launches over the phase go to its row's
    ``a4_launches`` (the codec's on its bare-name row: ResNet-18's chunk
    lengths are none of the timed rows', and step 2's ``check_codec`` holds
    them to the plain codec); leg (e) runs the VGG parts, which launch
    none."""
    totals: dict = {}
    t0 = time.perf_counter()
    k7 = a4_resnets(torch, build, card, totals)
    adamw = rows["fused_adamw"]
    adamw["max_abs_err"] = max(adamw["max_abs_err"], k7["abs"])
    adamw["max_ulp_err"] = max(adamw["max_ulp_err"], *k7["ulp"])
    a4_lm(torch, build, totals, card)
    parity = a4_parity_start()
    try:
        a4_checkpoints(torch, totals, card)
        a4_lars(torch, card)
    except BaseException:
        a4_parity_stop(parity)
        raise
    log(f"a4 launches over the phase: {totals}")
    for key, row in rows.items():
        name = key.split(":")[0]
        row["a4_launches"] = (totals.get(name, 0)
                              if name not in CODEC_KERNELS or key == name else 0)
    log(f"a4 phase, (e) still running: {time.perf_counter() - t0:.1f} s")
    return parity


def run_card_tests() -> None:
    """The card test of the latest slice (``tests/test_torch_kernels_cuda.py``:
    the expert-parallel paths; the other slices' card tests are left to the
    README's command for the time limit: their paths run in the phases above), as
    the README runs the file: ``--noconftest`` (the repo's conftest imports
    JAX)."""
    repo = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "pytest", "tests/test_torch_kernels_cuda.py", "-q",
           "--noconftest", "-p", "no:cacheprovider", "-k",
           "expert_parallel_paths_on_the_card"]
    res = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
    tail = (res.stdout + res.stderr).strip().splitlines()[-3:]
    log(f"card tests ({' '.join(cmd[3:])}): exit code {res.returncode}; {tail}")
    if res.returncode != 0:
        raise AssertionError(f"card tests failed: {(res.stdout + res.stderr)[-3000:]}")


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

        checks = [lambda: check_ring_flash(torch, rf, {}, timing=False),
                  lambda: check_ep_shapes(torch, fa, fadam, rf)]
    elif training:
        from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

        checks = [lambda: check_flash_bwd(torch, fa, {}, timing=False),
                  lambda: check_adamw(torch, fadam, {}, timing=False),
                  lambda: check_a5c_shapes(torch, fa, fadam),
                  lambda: check_ep_shapes(torch, fa, fadam, rf)]
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
    if kernel in ("flash_fwd", "decode_attention", "quant_matmul"):
        log(f"perturbation {name}: the A8 paths' kernel gates")
        try:
            check_a8_shapes(torch, fa, da, qm)
        except AssertionError as exc:
            caught.append(f"a8: {exc}")
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
    if kernel in ("flash_fwd", "flash_bwd", "fused_adamw"):
        log(f"perturbation {name}: the a5c tp cell's gates")
        try:
            run_a5c(torch, {}, card_line(), cells=("tp",))
        except AssertionError as exc:
            caught.append(f"a5c: {exc}")
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


# The run's phases after the kernel checks, in order, for ``--only``:
# serve (steps 4-5b), a8 (5c), train (6), ckpt (6b, with cli.distill), vgg,
# ring, ulysses, fsdp (fsdp and fsdp_pl), zero1 (zero1/fsdp_cnn and their
# checkpoints), a5c (tp, pp, 3d and their checkpoints), a4, tests (the card
# tests).
PHASES = ("serve", "a8", "train", "ckpt", "vgg", "ring", "ulysses", "fsdp", "zero1", "a5c",
          "ep", "a4", "tests")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true",
                    help="build and check the kernels, then stop")
    ap.add_argument("--perturb", choices=sorted(PERTURBATIONS),
                    help="show which checks catch a deliberately broken kernel")
    ap.add_argument("--only", metavar="PHASE,...", type=lambda v: v.split(","),
                    help="after the kernel checks (untimed), run only these phases of "
                         f"{', '.join(PHASES)}, with their gates, and print no result")
    args = ap.parse_args(argv)
    if args.only and set(args.only) - set(PHASES):
        ap.error(f"--only: unknown phases {sorted(set(args.only) - set(PHASES))}")

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
    timing = not (args.check_only or args.only)
    log("kernel vs plain on the card:")
    check_flash(torch, fa, rows, timing)
    check_decode(torch, da, rows, timing)
    check_decode_int8(torch, da, rows, timing)
    check_int8(torch, qm, rows, timing)
    check_paged(torch, da, rows)
    check_fleet_shapes(torch, da, qm)
    check_a8_shapes(torch, fa, da, qm)
    check_flash_bwd(torch, fa, rows, timing)
    check_adamw(torch, fadam, rows, timing)
    check_ulysses_shapes(torch, fa, rows, timing)
    check_flat_adamw(torch, fadam, rows, timing)
    check_flat_adamw(torch, fadam, rows, timing, "fused_adamw:flat_cnn",
                     flat_cnn_shard_len(FLAT_CNN["world"]),
                     f"{FLAT_CNN['model']} under zero1/fsdp, W {FLAT_CNN['world']}")
    check_a5c_shapes(torch, fa, fadam)
    check_codec(torch, rc, rows, timing)
    check_ring_flash(torch, rf, rows, timing)
    check_ep_shapes(torch, fa, fadam, rf)
    if args.check_only:
        log("check-only: kernels build and agree with their plain versions")
        return 0

    def wanted(phase: str) -> bool:
        return not args.only or phase in args.only

    if wanted("serve") or wanted("a8"):
        if wanted("serve"):
            crossover(torch, da)
        models, prompt = make_models(torch, pkg)
        if wanted("serve"):
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
        if wanted("a8"):
            t0 = time.perf_counter()
            serve_a8(torch, build, models, rows)
            log(f"A8 phases (a)-(f), (h): {time.perf_counter() - t0:.1f} s")
        del models, prompt
        gc.collect()
        torch.cuda.empty_cache()
    if wanted("train"):
        train(torch, build, rows)
        gc.collect()
        torch.cuda.empty_cache()
    if wanted("ckpt"):
        checkpoint_phase(torch, build, rows, card)
        gc.collect()
        torch.cuda.empty_cache()
    if wanted("vgg"):
        t0 = time.perf_counter()
        run_vgg(torch, rows)
        run_vgg_cli(torch)
        log(f"vgg phases: {time.perf_counter() - t0:.1f} s")
    cp = [p for p in ("ring", "ulysses") if wanted(p)]
    if cp:
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        dp_loss = ring_dp_loss(torch)
        # The two paths' ranks run at once (time limit): each one's times
        # carry the other's load.
        with ThreadPoolExecutor(len(cp)) as pool:
            spawned = {p: pool.submit(cp_spawn, p) for p in cp}
            for p in cp:
                run_cp(torch, rows, p, dp_loss, spawned[p].result())
        if wanted("ring"):
            run_ring_cli(torch)
        log(f"{' and '.join(cp)} phases (their ranks at once): "
            f"{time.perf_counter() - t0:.1f} s")
    if wanted("fsdp"):
        t0 = time.perf_counter()
        flat_peaks = run_fsdp(torch, rows, card)
        log(f"fsdp and flat_ckpt (LM) phases: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_fsdp_pl(torch, rows, flat_peaks, card)
        log(f"fsdp_pl phase: {time.perf_counter() - t0:.1f} s")
    if wanted("zero1"):
        t0 = time.perf_counter()
        build_dir = Path(__file__).resolve().parent / "build"
        build_dir.mkdir(exist_ok=True)
        ckdir = tempfile.mkdtemp(prefix="zero1_ckpt_", dir=build_dir)
        try:
            zero1_rec = run_flat_cnn(torch, rows, ckdir)
            flat_ckpt_zero1(torch, zero1_rec)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        log(f"zero1/fsdp_cnn and flat_ckpt (zero1) phases: {time.perf_counter() - t0:.1f} s")
    if wanted("a5c"):
        t0 = time.perf_counter()
        run_a5c(torch, rows, card)
        log(f"a5c phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    if wanted("ep"):
        t0 = time.perf_counter()
        run_ep(torch, rows, card)
        log(f"ep phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    parity = run_a4(torch, build, rows, card) if wanted("a4") else None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        if wanted("tests"):
            run_card_tests()
    except BaseException:
        if parity is not None:
            a4_parity_stop(parity)
        raise
    if parity is not None:
        a4_parity_finish(parity)
    log(f"card tests phase and the end of a4 (e): {time.perf_counter() - t0:.1f} s")
    if args.only:
        log(f"--only {','.join(args.only)}: every gate of these phases passed")
        return 0

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
            "train_launches": row["train_launches"], "ckpt_launches": row["ckpt_launches"],
            "vgg_launches": row["vgg_launches"],
            "ring_launches": row["ring_launches"],
            "ulysses_launches": row["ulysses_launches"], "fsdp_launches": row["fsdp_launches"],
            "fsdp_pl_launches": row["fsdp_pl_launches"],
            "zero1_cnn_launches": row["zero1_cnn_launches"],
            "fsdp_cnn_launches": row["fsdp_cnn_launches"],
            "flat_ckpt_launches": row["flat_ckpt_launches"],
            "a4_launches": row["a4_launches"], "a5c_launches": row.get("a5c_launches", 0),
            "ep_launches": row.get("ep_launches", 0),
            **{f"{c}_launches": row.get(f"{c}_launches", 0) for c in A8_COLUMNS},
            "shape": row["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
