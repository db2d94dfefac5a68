#!/usr/bin/env python3
"""Quick card run of the serving fleet.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/fleet_probe.py

Builds ``flash_fwd.cu``, ``paged_attention.cu`` and ``quant_matmul.cu``
only, runs ``chip_smoke.check_fleet_shapes`` (K5 over 4-slot pages at head
dim 32, K6 at the serve CLI's tiny shapes), then ``chip_smoke.serve_fleet``
at full width: the d2048 / 8-layer LM (random weights from the seed, bf16)
served by engine replicas behind the router, run (a) steady and run (b)
with a drain, a kill and the regime scheduler, with every gate of that
phase, then ``cli.serve --engine``.  A shorter loop than ``chip_smoke.py``
for work on the fleet; ``chip_smoke.py`` is the gate.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402
import distributed_machine_learning_tpu_torch as pkg  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import decode_attention as da  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm  # noqa: E402

SOURCES = ("flash_fwd", "paged_attention", "quant_matmul")


def main() -> int:
    if not torch.cuda.is_available():
        print("fleet_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    card = smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    smoke.check_fleet_shapes(torch, da, qm)
    models, _ = smoke.make_models(torch, pkg)
    del models["int8"]
    t0 = time.perf_counter()
    smoke.serve_fleet(torch, build, models["bf16"], {}, card)
    print(f"fleet phases: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
