#!/usr/bin/env python3
"""Quick card check of K6 (the W8A16 GEMM), K4 (decode attention) and K5
(paged decode attention).

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/decode_gemm_probe.py

Builds ``quant_matmul.cu``, ``decode_attention.cu`` and
``paged_attention.cu`` only, prints ptxas' entry, register, spill and
warning lines for them, then runs
``chip_smoke.py``'s checks of the two kernels with their timings: K6
against its plain version on all three routes (the skinny decode tile,
the wgmma mainloop at prefill R and a ragged R, the byte-staged tile at
K 257) and timed over one forward's GEMMs at decode and prefill R beside
the matmul on dequantized bf16; K4 in both modes (bf16 caches, int8 rows
with f32 scales) at B 8 and B 1, at block and split edges, timed beside
SDPA (bf16) and the scale-folding einsum (int8); K5 against its plain
version on ragged lanes at block sizes 16 and 128
(``chip_smoke.check_paged``), then at the engine's decode step
(``tools/ab_kernels.time_paged_step``: the 2080-block pool, 8 lanes at
the positions chip_smoke.py logs) timed beside the gather of the pages +
SDPA.  A shorter loop than ``chip_smoke.py`` for work on these kernels;
``chip_smoke.py`` is the gate.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as smoke  # noqa: E402
from ab_kernels import time_paged_step  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import decode_attention as da  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm  # noqa: E402

SOURCES = ("quant_matmul", "decode_attention", "paged_attention")


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    print(f"card: {smoke.card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    try:
        build.build_all(SOURCES)
    finally:
        for name in SOURCES:
            log = build.BUILD_DIR / f"{name}.log"
            for line in log.read_text().splitlines() if log.exists() else ():
                if any(k in line for k in ("Compiling entry", "registers", "spill", "warning",
                                           "error", "Performance")):
                    print(name, line.strip(), flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    rows: dict = {}
    smoke.check_int8(torch, qm, rows, timing=True)
    print(f"K6 calls by route: {qm.route_calls}", flush=True)
    smoke.check_decode(torch, da, rows, timing=True)
    smoke.check_decode_int8(torch, da, rows, timing=True)
    smoke.check_paged(torch, da, rows)
    time_paged_step(torch, smoke, da, rows)
    for name, row in rows.items():
        print(f"{name}: " + ", ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                      for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
