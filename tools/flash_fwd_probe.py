#!/usr/bin/env python3
"""Quick card check of the flash forward mainloop (K1 and K11, bf16).

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/flash_fwd_probe.py

Builds ``flash_fwd.cu`` and ``ring_flash.cu`` only (they share
``flash_fwd_sm90.cuh``), prints ptxas' warnings, holds K1 (out and lse) and
K11 (m, l, acc from a random carry, both step kinds) against their plain
versions at head dims 32, 64 and 128 and at lengths that end inside a
128-row tile, then times K1 at B 8 x L 4096 and K11 at a full and a
diagonal ring step (B 1, Lc 4096), H 16 / Hkv 4, D 128, each beside one
SDPA call (CUDA graphs between CUDA events).  A shorter loop than
``chip_smoke.py`` for work on the mainloop; ``chip_smoke.py`` is the gate.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf  # noqa: E402


def row_errors(got, want):
    """(worst element error / max|plain row|, worst rms error / rms(plain row))."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = got - want
    elem = err.abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)
    rms = err.square().mean(-1).sqrt() / want.square().mean(-1).sqrt().clamp_min(1e-30)
    return float(elem.max()), float(rms.max())


def time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        build.build_all(["flash_fwd", "ring_flash"])
    finally:
        for name in ("flash_fwd", "ring_flash"):
            log = build.BUILD_DIR / f"{name}.log"
            for line in log.read_text().splitlines() if log.exists() else ():
                if any(k in line for k in ("warning", "error", "Performance")):
                    print(name, line.strip(), flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    for B, L, H, Hkv, D in [(1, 128, 2, 1, 128), (1, 100, 2, 2, 64), (1, 300, 4, 2, 32),
                            (2, 1100, 8, 2, 128), (8, 4096, 16, 4, 128)]:
        q, k, v = randn(B, L, H, D), randn(B, L, Hkv, D), randn(B, L, Hkv, D)
        out, lse = fa._launch(q, k, v)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_reference(q, k, v, return_lse=True)
        print(f"K1 B={B} L={L} H={H}/{Hkv} D={D}: rows {row_errors(out, want)}, "
              f"lse {float((lse - want_lse).abs().max()):.2e}", flush=True)
    for Lc, H, Hkv, D in [(128, 2, 1, 128), (100, 4, 2, 64), (300, 4, 2, 32),
                          (4096, 16, 4, 128)]:
        q, k, v = randn(1, Lc, H, D), randn(1, Lc, Hkv, D), randn(1, Lc, Hkv, D)
        m = torch.randn(1, H, Lc, device="cuda", generator=gen)
        l = torch.rand(1, H, Lc, device="cuda", generator=gen) + 1
        acc = torch.randn(1, Lc, H, D, device="cuda", generator=gen)
        for causal in (True, False):
            got = [m.clone(), l.clone(), acc.clone()]
            rf._launch_fwd(q, k, v, *got, causal)
            torch.cuda.synchronize()
            want = rf.chunk_fwd_reference(q, k, v, m, l, acc, causal)
            print(f"K11 Lc={Lc} H={H}/{Hkv} D={D} causal={causal}: m "
                  f"{float((got[0] - want[0]).abs().max()):.2e}, l "
                  f"{float(((got[1] - want[1]) / want[1]).abs().max()):.2e}, acc rows "
                  f"{row_errors(got[2], want[2])}", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def heads_first(q, k, v):
        rep = q.shape[2] // k.shape[2]
        return [t.transpose(1, 2).contiguous() for t in
                (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2))]

    q, k, v = randn(8, 4096, 16, 128), randn(8, 4096, 4, 128), randn(8, 4096, 4, 128)
    flops = 4 * 128 * 4096 * 4097 / 2 * 8 * 16
    hq = heads_first(q, k, v)
    lib = time_ms(lambda: sdpa(*hq, is_causal=True))
    ms = time_ms(lambda: fa._launch(q, k, v))
    print(f"K1 B=8 L=4096: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, {ms / lib:.2f}x "
          f"SDPA causal ({lib:.4f} ms)", flush=True)
    q, k, v = randn(1, 4096, 16, 128), randn(1, 4096, 4, 128), randn(1, 4096, 4, 128)
    m = torch.randn(1, 16, 4096, device="cuda", generator=gen)
    l = torch.rand(1, 16, 4096, device="cuda", generator=gen) + 1
    acc = torch.randn(1, 4096, 16, 128, device="cuda", generator=gen)
    flops = 4 * 128 * 4096 * 4096 * 16
    hq = heads_first(q, k, v)
    lib = time_ms(lambda: sdpa(*hq))
    full = time_ms(lambda: rf._launch_fwd(q, k, v, m, l, acc, False))
    diag = time_ms(lambda: rf._launch_fwd(q, k, v, m, l, acc, True))
    print(f"K11 full step: {full:.4f} ms, {flops / full / 1e9:.1f} TFLOP/s, {full / lib:.2f}x "
          f"SDPA non-causal ({lib:.4f} ms); diagonal step {diag:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
