#!/usr/bin/env python3
"""Kernel and prefill timings of one checkout, for parent-vs-change pairs.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/ab_kernels.py TREE

TREE is a directory holding a checkout of the repo (this one, or an older
commit unpacked with ``git archive``).  Imports that tree's
``chip_smoke.py`` and port package (nothing of the running checkout),
builds its kernels into ``TREE/build/kernels``, runs its kernel checks
with their timings (K1, K4 in both modes, K6, K2/K3, K11-K13; each beside
its library call), then times its bf16 and int8-weight generate (prefill
+ first token and the decode step, ``chip_smoke.time_serving``).  Prints
one line per timed kernel and a last JSON line of every row's numbers.
Compare two versions inside one call, in turns: parent, change, change,
parent.
"""

import json
import sys
import time
from pathlib import Path


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[0]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as smoke
    import distributed_machine_learning_tpu_torch as pkg
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.ops import decode_attention as da
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    if Path(smoke.__file__).resolve().parent != tree:
        raise RuntimeError(f"imported {smoke.__file__}, not the tree's chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"tree {tree}; card: {smoke.card_line()}")
    t0 = time.perf_counter()
    build.build_all()
    smoke.log(f"build {time.perf_counter() - t0:.1f} s")
    rows: dict = {}
    smoke.check_flash(torch, fa, rows, True)
    smoke.check_decode(torch, da, rows, True)
    smoke.check_decode_int8(torch, da, rows, True)
    smoke.check_int8(torch, qm, rows, True)
    smoke.check_flash_bwd(torch, fa, rows, True)
    smoke.check_ring_flash(torch, rf, rows, True)
    models, prompt = smoke.make_models(torch, pkg)
    fns = smoke.generate_fns(models)
    for mode in ("bf16", "int8"):
        smoke.time_serving(torch, mode, models[mode], fns[mode], prompt)
    keep = ("ms", "library_ms", "bound_ms", "diag_ms")
    print(json.dumps({"tree": str(tree), "rows": {
        name: {k: row[k] for k in keep if row.get(k) is not None}
        for name, row in rows.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
