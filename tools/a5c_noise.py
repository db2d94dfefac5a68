#!/usr/bin/env python3
"""Read the plain-vs-plain noise the A5c phase's update gate scales with.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/a5c_noise.py

Builds the kernels, then trains one-process dp twice at ``chip_smoke.py``'s
3d cell shape (the LM at full width, 4 layers, B 4 x L 2048, bf16, fused
AdamW, the stream's batches 0, 1, 2) through the plain versions, the
attention tiled by 512 and by ``RING_NOISE_BLOCK``, and prints each leaf's
distance between the two runs over the update (median and worst):
``chip_smoke.A5C_UPDATE_NOISE`` is the worst of one such reading.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    import torch

    import chip_smoke as smoke
    from distributed_machine_learning_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("a5c_noise: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"card: {smoke.card_line()}")
    build.build_all()
    worst = smoke.a5c_noise(torch)
    smoke.log(f"a5c_noise: worst leaf {worst:.4e} (chip_smoke.A5C_UPDATE_NOISE "
              f"{smoke.A5C_UPDATE_NOISE:.4e})")
