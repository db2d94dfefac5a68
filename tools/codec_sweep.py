#!/usr/bin/env python3
"""Quick card loop for K8 (the int8 ring encode) and the sweep behind its
launch plan.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/codec_sweep.py            # build, check, trace
    python3 tools/codec_sweep.py --sweep    # and time the plan's variants

Builds ``ring_codec.cu`` only and prints ptxas' register, shared-memory and
spill lines for it; runs ``chip_smoke.check_codec`` (K8-K10 bit for bit
their plain versions at every ``CODEC_LENGTHS`` entry and the edge chunks,
K8 in CUDA graphs replayed twice and out of order) and
``chip_smoke.codec_trace`` (one K8 call: one cooperative kernel node and
no memset in its graph, one kernel in the profiler's trace); checks that a
plan whose grid cannot be resident at once raises.  With ``--sweep`` it
times K8, with and without the residual, at the VGG path's four chunk
lengths (operands rotated out of L2 as ``chip_smoke.time_codec`` does) over
blocks per SM, the fewest elements a block is given
(``ring_codec.ENCODE_MIN_SLICE``, set for the sweep) and the bulk copies a
slice (``ENC_STAGES``: the source built once for each count under
``build/codec_sweep/``, each checked bit for bit first), and the rule's
plan with nothing staged (both passes read v from HBM/L2); prints each
variant's µs and the fastest per length.  ``chip_smoke.py`` is the gate.
"""

import argparse
import itertools
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as smoke  # noqa: E402
from k6_variants import build_variants  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import ring_codec as rc  # noqa: E402

BLOCKS_PER_SM = (1, 2)
MIN_SLICES = (2048, 4096, 16384, 65536)
STAGES = (1, 2, 4, 8)
STAGES_LINE = "constexpr int ENC_STAGES = 2;"


def check_refusal(device) -> None:
    """A grid of more blocks than can be resident must raise, not run."""
    v = torch.randn(4 * rc.ENCODE_MAX_GRID * 64, device=device)
    budget = rc.stage_budget(device, 1)
    plan = rc.EncodePlan(rc.ENCODE_MAX_GRID, 256, min(256, budget // 16 * 4))
    try:
        rc._launch_encode(v, True, plan)
    except RuntimeError as exc:
        print(f"a grid of {plan.grid} blocks is refused: {exc}", flush=True)
        return
    raise AssertionError(f"K8 launched a grid of {plan.grid} blocks cooperatively")


def sweep(device) -> None:
    libs = build_variants("ring_codec", {
        str(k): [(STAGES_LINE, f"constexpr int ENC_STAGES = {k};")] if k != 2 else []
        for k in STAGES}, "codec_sweep")
    main_lib, min_slice0 = build._libs["ring_codec"], rc.ENCODE_MIN_SLICE
    gen = torch.Generator(device="cuda").manual_seed(9)
    sms = build.sm_count(device)
    try:
        for n in smoke.CODEC_PATH_LENGTHS:
            sets = max(smoke.CODEC_SETS, math.ceil(smoke.CODEC_ROTATE_BYTES / (9 * n)))
            vs = [0.01 * torch.randn(n, device="cuda", generator=gen) for _ in range(sets)]
            want = rc.encode_int8_residual_reference(vs[0])
            for residual in (True, False):
                bound_us = (9 if residual else 5) * n / smoke.HBM_BPS * 1e6
                timed = []

                def run(label, plan, residual=residual):
                    us = smoke.time_ms(lambda: [rc._launch_encode(vs[i], residual, plan)
                                                for i in range(sets)]) / sets * 1e3
                    print(f"sweep n={n} residual={residual} {label} {plan}: {us:.3f} us "
                          f"({bound_us / us:.1%} of bound)", flush=True)
                    timed.append((us, label, plan))

                for stages, lib in libs.items():
                    build._libs["ring_codec"] = lib
                    rc._budgets.clear()
                    if residual:
                        got = rc.encode_int8_residual(vs[0])
                        if not all(smoke.bits_equal(torch, a, b) for a, b in zip(got, want)):
                            raise AssertionError(f"K8 with {stages} copies a slice, n={n}")
                    for bps, min_slice in itertools.product(BLOCKS_PER_SM, MIN_SLICES):
                        rc.ENCODE_MIN_SLICE = min_slice
                        plan = rc.encode_plan(n, sms, rc.stage_budget(device, bps), bps)
                        run(f"blocks/SM={bps} min_slice={min_slice} stages={stages}", plan)
                    rc.ENCODE_MIN_SLICE = min_slice0
                build._libs["ring_codec"] = main_lib
                rc._budgets.clear()
                rule = rc.device_encode_plan(device, n)
                run("the rule's plan, nothing staged", rule._replace(staged=0))
                us, label, plan = min(timed)
                print(f"fastest n={n} residual={residual}: {us:.3f} us ({bound_us / us:.1%} of "
                      f"the {bound_us:.3f} us bound) at {label} {plan}; the rule's plan "
                      f"{rule}", flush=True)
            del vs
    finally:
        build._libs["ring_codec"] = main_lib
        rc.ENCODE_MIN_SLICE = min_slice0
        rc._budgets.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true", help="time the plan's variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("codec_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {smoke.card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    try:
        build.build_all(["ring_codec"])
    finally:
        log = build.BUILD_DIR / "ring_codec.log"
        for line in log.read_text().splitlines() if log.exists() else ():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "warning",
                                       "error", "smem")):
                print("ring_codec", line.strip(), flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda", 0)
    for bps in BLOCKS_PER_SM:
        print(f"stage budget at {bps} block(s)/SM: {rc.stage_budget(device, bps)} bytes",
              flush=True)
    failed = []
    for check in (lambda: smoke.codec_trace(torch, rc),
                  lambda: smoke.check_codec(torch, rc, {}, timing=False),
                  lambda: check_refusal(device)):
        try:
            check()
        except AssertionError as exc:
            print(f"FAILED: {exc}", flush=True)
            failed.append(exc)
    if failed:
        return 1
    if args.sweep:
        sweep(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
