#!/usr/bin/env python3
"""Quick card check of the flash backward mainloop (K2/K3 and K12/K13, bf16).

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/flash_bwd_probe.py

Builds ``flash_bwd.cu`` (K2 and K3) and ``ring_flash.cu`` (K12 and K13),
both on ``flash_bwd_sm90.cuh``, and prints ptxas' entries, registers,
spills and warnings.  Holds K2 (dq) and K3 (dk, dv) against their plain
version, and K12 and K13 (with non-zero accumulators in, both step kinds)
against theirs, at head dims 32, 64 and 128 and at lengths that end inside
a tile.  Then times, in CUDA graphs between CUDA events: K2 and K3 at the
trainer's shape (B 4, L 4096, H 16 / Hkv 4, D 128) beside SDPA's causal
backward, and the full and diagonal ring steps at the ring path's chunk
(B 1, Lc 4096) beside SDPA's non-causal backward, each with its fastest
fused backend pinned.  A shorter loop than ``chip_smoke.py`` for work on
the mainloop; ``chip_smoke.py`` is the gate.  Exits 1 if a check fails.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf  # noqa: E402

# (L, H, Hkv, D): lengths at and around the 64- and 128-row tiles, a padded
# trainer length and the full one.
CASES = [(100, 4, 4, 64), (127, 8, 2, 128), (128, 4, 2, 32), (129, 8, 2, 128),
         (200, 4, 2, 32), (300, 8, 2, 64), (2100, 16, 4, 128), (4096, 16, 4, 128)]
SOURCES = ("flash_bwd", "ring_flash")


def check_flash(gen, failed: list) -> None:
    """K2 and K3 vs flash_attention_backward_reference (B 2 below 1024)."""
    for L, H, Hkv, D in CASES:
        B = 2 if L < 1024 else 1
        args = smoke.bwd_inputs(torch, fa, B, L, H, Hkv, D, "bfloat16", gen)
        got = (fa._launch_dq(*args), *fa._launch_dkv(*args))
        torch.cuda.synchronize()
        want = fa.flash_attention_backward_reference(*args)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            smoke.compare(f"K2/K3 {name} B={B} L={L} H={H}/{Hkv} D={D}", g, w, failed,
                          smoke.GRAD_ROW_FLOOR)


def check_ring(gen, failed: list) -> None:
    """K12 and K13 vs their plain versions, both step kinds."""
    for Lc, H, Hkv, D in CASES:
        q, do, own, prev, _, lse, delta = smoke.ring_case(torch, rf, Lc, H, Hkv, D, "bfloat16",
                                                          gen)
        dq = torch.randn(1, Lc, H, D, device="cuda", generator=gen)
        dk, dv = (torch.randn(1, Lc, Hkv, D, device="cuda", generator=gen) for _ in "ab")
        blk = smoke.ring_block(Lc)
        for causal, (k, v) in ((True, own), (False, prev)):
            label = f"{'diagonal' if causal else 'full'} Lc={Lc} H={H}/{Hkv} D={D}"
            got = [dq.clone(), dk.clone(), dv.clone()]
            rf._launch_dq(q, k, v, do, lse, delta, got[0], causal)
            rf._launch_dkv(q, k, v, do, lse, delta, got[1], got[2], causal)
            torch.cuda.synchronize()
            want_dq = rf.chunk_dq_reference(q, k, v, do, lse, delta, dq, causal, blk)
            want_kv = rf.chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv, causal, blk)
            for name, g, w in (("dq", got[0], want_dq), ("dk", got[1], want_kv[0]),
                               ("dv", got[2], want_kv[1])):
                smoke.compare(f"{name} {label}", g, w, failed, smoke.GRAD_ROW_FLOOR)


def time_flash(gen) -> None:
    """K2 and K3 at B 4 x L 4096 beside SDPA's causal backward."""
    B, L, H, Hkv, D = 4, 4096, 16, 4, 128
    args = smoke.bwd_inputs(torch, fa, B, L, H, Hkv, D, "bfloat16", gen)
    pairs = B * H * L * (L + 1) / 2.0
    lib_ms, backend = smoke.sdpa_backward_ms(torch, *args[:4], True, "causal")
    total = 0.0
    for name, fn, products in (("K2", lambda: fa._launch_dq(*args), 3),
                               ("K3", lambda: fa._launch_dkv(*args), 4)):
        ms = smoke.time_ms(fn)
        total += ms
        flops = 2.0 * products * D * pairs
        bound = flops / smoke.BF16_FLOPS * 1e3
        print(f"{name} B={B} L={L}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound / ms:.1%} of its {bound:.4f} ms bound", flush=True)
    print(f"K2 + K3: {total:.4f} ms, {total / lib_ms:.2f}x SDPA's causal backward "
          f"({backend}, {lib_ms:.4f} ms)", flush=True)


def time_ring(gen) -> None:
    """The full and diagonal ring steps at B 1 x Lc 4096 beside SDPA."""
    Lc, H, Hkv, D = 4096, 16, 4, 128
    q, do, own, prev, _, lse, delta = smoke.ring_case(torch, rf, Lc, H, Hkv, D, "bfloat16", gen)
    k, v = prev
    dq = torch.zeros(1, Lc, H, D, device="cuda")
    dk, dv = torch.zeros(1, Lc, Hkv, D, device="cuda"), torch.zeros(1, Lc, Hkv, D, device="cuda")
    pairs = float(H * Lc * Lc)
    lib_ms, backend = smoke.sdpa_backward_ms(torch, q, k, v, do, False, "non-causal")
    for name, fn, products in (
            ("K12", lambda c: rf._launch_dq(q, k, v, do, lse, delta, dq, c), 3),
            ("K13", lambda c: rf._launch_dkv(q, k, v, do, lse, delta, dk, dv, c), 4)):
        full = smoke.time_ms(lambda: fn(False))
        diag = smoke.time_ms(lambda: fn(True))
        flops = 2.0 * products * D * pairs
        bound = flops / smoke.BF16_FLOPS * 1e3
        print(f"{name} full step: {full:.4f} ms, {flops / full / 1e9:.1f} TFLOP/s, "
              f"{bound / full:.1%} of its {bound:.4f} ms bound, {full / lib_ms:.2f}x SDPA "
              f"backward ({backend}, {lib_ms:.4f} ms); diagonal {diag:.4f} ms "
              f"({diag / full:.2f}x)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    print(f"card: {smoke.card_line()}", flush=True)
    t0 = time.perf_counter()
    try:
        build.build_all(SOURCES)
    finally:
        for name in SOURCES:
            log = build.BUILD_DIR / f"{name}.log"
            for line in log.read_text().splitlines() if log.exists() else ():
                if any(k in line for k in ("Compiling entry", "registers", "spill", "warning",
                                           "error", "Performance")):
                    print(f"ptxas {name}:", line.strip(), flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    failed: list = []
    check_flash(gen, failed)
    check_ring(gen, failed)
    time_flash(gen)
    time_ring(gen)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
