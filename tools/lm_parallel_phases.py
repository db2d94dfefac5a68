#!/usr/bin/env python3
"""Run chip_smoke.py's Ulysses, fsdp and fused-loss phases alone, on one card.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/lm_parallel_phases.py [PHASE ...]

Builds the kernels, then runs the named phases (all by default) with
chip_smoke.py's own gates: ``checks`` (K1-K3 at the Ulysses shape and K7
on the fsdp flat shard against their plain versions, timed), ``fused``
(the fused head+loss against the unfused loss, then ``cli.lm
--fused-ce-chunks`` on synthetic tokens and on the byte corpus with its
held-out eval), ``ulysses`` (``cli.lm --parallel ulysses`` in 4 ranks
sharing the card, against the one-process dp loss), ``fsdp`` (``--parallel
fsdp`` sync and ``--overlap-update`` in 2 ranks, against one-process dp)
and ``tests`` (the card tests of those trainers).  Exits 1 if a phase
fails: a short loop for work on these paths before a whole
``chip_smoke.py``.
"""

import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
PHASES = ("checks", "fused", "ulysses", "fsdp", "tests")

if __name__ == "__main__":  # the phases spawn ranks that import this module
    import torch

    import chip_smoke as smoke
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops import fused_adamw as fadam

    if not torch.cuda.is_available():
        print("lm_parallel_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    chosen = sys.argv[1:] or list(PHASES)
    if set(chosen) - set(PHASES):
        print(f"lm_parallel_phases: unknown phases {sorted(set(chosen) - set(PHASES))}",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"card: {smoke.card_line()}; torch {torch.__version__}")
    build.build_all()
    rows: dict = {}

    def run_tests():
        r = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_cuda.py",
                            "-q", "--noconftest", "-p", "no:cacheprovider", "-k",
                            "parallel_trainers"], cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
        if r.returncode:
            raise AssertionError("card tests failed")

    def fused():
        smoke.check_fused_ce(torch, build)
        smoke.run_fused_ce_paths(torch, build)

    def checks():
        smoke.check_ulysses_shapes(torch, fa, rows, True)
        smoke.check_flat_adamw(torch, fadam, rows, True)

    phases = {"checks": checks, "fused": fused,
              "ulysses": lambda: smoke.run_cp(torch, rows, "ulysses", smoke.ring_dp_loss(torch)),
              "fsdp": lambda: smoke.run_fsdp(torch, rows), "tests": run_tests}
    failed = []
    for name in chosen:
        t0 = time.perf_counter()
        try:
            phases[name]()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        smoke.log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"FAILED: {failed}", flush=True)
        sys.exit(1)
