#!/usr/bin/env python3
"""Where the decode-regime kernels spend their time: K6's skinny route and K5.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/decode_kernel_sweep.py [--k6] [--k5]

Builds variants of ``ops/csrc/quant_matmul.cu`` and
``ops/csrc/paged_attention.cu`` (under ``build/decode_sweep/``; the
checkout is not touched) with ``tools/k6_variants.build_variants``, and
times them through CUDA graphs (``chip_smoke.time_ms``).

- K6 (``--k6``): each projection shape of one decode step at R 8, on
  weights rotated past the L2 (as serving reads them), the skinny route's
  time per GEMM for every cluster size (splits 1-8) of each variant,
  beside ``torch.matmul`` on the dequantized bf16 weight.  Variants: the
  source as it is; ``nocompute`` (the stages are waited for and read, but
  neither widened nor multiplied).
- K5 (``--k5``): the engine's decode step (``tools/ab_kernels.
  paged_step_inputs``) at 1-4 blocks per SM, and the variants
  ``nocompute`` (tiles waited for, no products) and ``nomerge`` (split
  lanes never merged).

Every variant's error against the plain version is printed: the variants
other than the source compute wrong outputs on purpose where their names
say so, and only their times mean anything.  With neither flag, both run.
"""

import argparse
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as smoke  # noqa: E402
from ab_kernels import paged_step_inputs  # noqa: E402
from k6_variants import build_variants, w8a16_functions  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import decode_attention as da  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm  # noqa: E402

K6_COMPUTE = ("#pragma unroll\n    for (int c = 0; c < 4; ++c) {  "
              "// the 32-bit words of columns 4c .. 4c + 3")
K6_VARIANTS = {
    "kernel": [],
    "nocompute": [(K6_COMPUTE, "acc[0][0][0] += __uint_as_float((w[0].x ^ w[1].y ^ w[2].z ^ "
                               "w[3].w ^ b[0][0]) & 0x3f800000u);\n    if (K < 0)\n"
                   + K6_COMPUTE)],
}
K5_TILE = "      ws.tile(ring + st * G::STAGE"
K5_VARIANTS = {
    "kernel": [],
    "nocompute": [(K5_TILE, "      if (K_NEVER) ws.tile(ring + st * G::STAGE"),
                  ("namespace {\n", "namespace {\n__device__ int K_NEVER = 0;\n")],
    "nomerge": [("    if (!s_last) continue;", "    if (true) continue;")],
}
STEP_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048), (2048, 32000)]


def sweep_k6() -> None:
    fns = w8a16_functions(build_variants("quant_matmul", K6_VARIANTS, "decode_sweep"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    skinny, R = qm.ROUTES.index("skinny"), smoke.BATCH
    for D, K in STEP_SHAPES:
        n = max(2, math.ceil(200e6 / (D * K)))  # copies past the 50 MB L2
        ws = [qm.quantize_int8(torch.randn(D, K, device="cuda", generator=gen) / D ** 0.5)
              for _ in range(n)]
        wds = [(q.float() * s).bfloat16() for q, s in ws[:max(2, n // 2)]]
        x = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        out = torch.empty(R, K, device="cuda", dtype=torch.bfloat16)
        want = qm.int8_matmul_reference(x, *ws[0]).float()
        lib_us = smoke.time_ms(lambda: [torch.matmul(x, wd) for wd in wds], iters=10) / len(wds)
        cells = [f"torch.matmul (bf16 weight) {lib_us * 1e3:.2f} us"]
        for name, fn in fns.items():
            for splits in range(1, qm.SKINNY_MAX_SPLITS + 1):
                def call(q, s, fn=fn, splits=splits):
                    status = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), R, D,
                                K, 1, splits, skinny, build.stream_handle(x.device))
                    if status:
                        raise RuntimeError(f"{name} splits {splits}: cudaError_t {status}")
                call(*ws[0])
                torch.cuda.synchronize()
                err = float((out.float() - want).abs().max())
                us = smoke.time_ms(lambda: [call(q, s) for q, s in ws], iters=10) / n * 1e3
                cells.append(f"{name}/s{splits} {us:.2f} us {D * K / us / 1e3:.0f} GB/s "
                             f"(max err {err:.1e})")
        print(f"K6 R={R} D={D} K={K} (bytes bound {D * K / smoke.HBM_BPS * 1e6:.2f} us, policy "
              f"splits {qm.skinny_splits(R, D, K, build.sm_count(x.device))}): "
              + "; ".join(cells), flush=True)
        del ws, wds
        torch.cuda.empty_cache()


def sweep_k5() -> None:
    libs = build_variants("paged_attention", K5_VARIANTS, "decode_sweep")
    q, k, v, tables, pos = paged_step_inputs(torch, smoke)
    want = da.paged_attention_reference(q, k, v, tables, pos).float()
    keep = build._libs.get(da.PAGED_KERNEL), da.PAGED_BLOCKS_PER_SM
    try:
        for name, lib in libs.items():
            build._libs[da.PAGED_KERNEL] = lib
            for bps in (1, 2, 3, 4) if name == "kernel" else (keep[1],):
                da.PAGED_BLOCKS_PER_SM = bps
                got = da.paged_flash_attention(q, k, v, tables, pos)
                torch.cuda.synchronize()
                err = float((got.float() - want).abs().max())
                us = smoke.time_ms(lambda: da.paged_flash_attention(q, k, v, tables, pos),
                                   iters=50) * 1e3
                print(f"K5 engine step {name}, {bps} blocks per SM: {us:.2f} us "
                      f"(max err {err:.2e})", flush=True)
    finally:
        da.PAGED_BLOCKS_PER_SM = keep[1]
        if keep[0] is None:
            build._libs.pop(da.PAGED_KERNEL, None)
        else:
            build._libs[da.PAGED_KERNEL] = keep[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k6", action="store_true", help="sweep K6's skinny route")
    ap.add_argument("--k5", action="store_true", help="sweep K5 at the engine step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {smoke.card_line()}", flush=True)
    if args.k6 or not args.k5:
        sweep_k6()
    if args.k5 or not args.k6:
        sweep_k5()
    return 0


if __name__ == "__main__":
    sys.exit(main())
