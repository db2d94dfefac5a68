#!/usr/bin/env python3
"""Run chip_smoke.py's multi-rank phases alone, on a card per rank.

Run from the root of a checkout on a machine with four CUDA cards:
    python3 tools/cross_card_phases.py

Drives the context-parallel LM ring (``chip_smoke.run_ring``: 4 ranks,
B 1 x L 16384) and the VGG parts (``chip_smoke.run_vgg``: world 1, 2 and
4) with their own gates: launch counts, ranks bit for bit equal, one step
kernel path vs plain path, losses.  With a card per rank the ranks choose
nccl (``runtime/distributed.plan_placement``); on one card they share it
over gloo, as ``chip_smoke.py`` runs them.  Prints each kernel's launches
over the phases; exits 1 if a phase fails.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":  # the phases spawn ranks that import this module
    import torch

    import chip_smoke as smoke
    from distributed_machine_learning_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("cross_card_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {smoke.card_line()}; {torch.cuda.device_count()} cards", flush=True)
    build.build_all()
    rows = {name: {} for name in build.KERNELS}
    failed = []
    for name, phase in (("ring", smoke.run_ring), ("vgg", smoke.run_vgg)):
        t0 = time.perf_counter()
        try:
            phase(torch, rows)
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    print({name: (row.get("ring_launches"), row.get("vgg_launches"))
           for name, row in rows.items()}, flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        sys.exit(1)
