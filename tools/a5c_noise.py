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

    python3 tools/a5c_noise.py --ep

reads the same for the expert-parallel cells' model instead (the MoE LM,
E 8, 2 layers, B 4 x L 2048, the grouped one-process step, the stream's
batches 0, 1, 0): ``chip_smoke.EP_UPDATE_NOISE``; and each leaf kind's
distance between the two runs' step-0 gradients over the gradient:
``chip_smoke.EP_GRAD_NOISE``.

    python3 tools/a5c_noise.py --plant seq-sum,scale

is the EP gates' control: it runs the ``--ep-seq 2`` cell (W 4 ranks on
the card) once a fault, each planted in the ranks' gradient sync
(``chip_smoke.ep_plant``), against the one-process grouped run, and prints
what each gate reads: the step-0 gradients' and the final leaves' worst
ratio to their limits, and whether the copies of an expert block agree.
"""

import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def controls(torch, smoke, faults: list) -> None:
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="ep_plant_", dir=ROOT / "build")
    try:
        ref = smoke.ep_reference(torch, "grouped", ckdir)
        for fault in faults:
            ranks = spawn(smoke.ep_rank, smoke.EP["seq_world"], (("seq",), ckdir, None, fault),
                          900)
            recs = [out["runs"]["seq"] for out in ranks]
            for r, rec in enumerate(recs):
                g, u = rec["grad0"], rec["ref"]
                smoke.log(f"plant {fault} rank {r} (mesh {rec['mesh']}): step-0 gradients "
                          f"median {g['median']:.3e}, worst {g['worst'][1]:.3e} "
                          f"({g['worst'][0]}, ratio {g['worst'][2]:.3f} to its limit); after "
                          f"the run median {u['median']:.3e}, worst {u['worst'][1]:.3e} "
                          f"({u['worst'][0]}, ratio {u['worst'][2]:.3f} to its limit)")
            shared = smoke.ep_expert_groups(recs)
            smoke.log(f"plant {fault}: losses {recs[0]['losses']} (one-process "
                      f"{ref['losses']}); expert blocks alike across their ranks "
                      f"{({e: len(d) == 1 for e, d in shared.items()})}; leaves outside the "
                      f"experts alike {len({rec['replicated'] for rec in recs}) == 1}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


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
    argv = sys.argv[1:]
    if "--ep" in argv:
        worst, kinds = smoke.ep_noise(torch)
        smoke.log(f"a5c_noise --ep: worst leaf {worst:.4e} (chip_smoke.EP_UPDATE_NOISE "
                  f"{smoke.EP_UPDATE_NOISE:.4e}); step-0 gradients by leaf kind {kinds} "
                  f"(chip_smoke.EP_GRAD_NOISE {smoke.EP_GRAD_NOISE})")
    if "--plant" in argv:
        controls(torch, smoke, argv[argv.index("--plant") + 1].split(","))
    if not {"--ep", "--plant"} & set(argv):
        worst = smoke.a5c_noise(torch)
        smoke.log(f"a5c_noise: worst leaf {worst:.4e} (chip_smoke.A5C_UPDATE_NOISE "
                  f"{smoke.A5C_UPDATE_NOISE:.4e})")
