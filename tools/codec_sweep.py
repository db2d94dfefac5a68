#!/usr/bin/env python3
"""Quick card loop for the int8 ring codec K8-K10, the sweep behind K8's
launch plan and the sweep of K9's variants.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/codec_sweep.py            # build, check, trace
    python3 tools/codec_sweep.py --sweep    # and time K8's plan variants
    python3 tools/codec_sweep.py --k9       # and time K9's source variants

Builds ``ring_codec.cu`` only and prints ptxas' register, shared-memory and
spill lines for it; runs ``chip_smoke.check_codec`` (K8-K10 bit for bit
their plain versions at every ``CODEC_LENGTHS`` entry and the edge chunks,
K8 in CUDA graphs replayed twice and out of order) and
``chip_smoke.codec_trace`` (one K8 call: one cooperative kernel node and
no memset in its graph, one kernel in the profiler's trace) and
``chip_smoke.ring_call_trace`` (one int8 ring call: one batched K10 kernel
for its all-gather, no copy after it); checks that a plan whose grid cannot
be resident at once raises.  With ``--sweep`` it
times K8, with and without the residual, at the VGG path's four chunk
lengths (operands rotated out of L2 as ``chip_smoke.time_codec`` does) over
blocks per SM, the fewest elements a block is given
(``ring_codec.ENCODE_MIN_SLICE``, set for the sweep) and the bulk copies a
slice (``ENC_STAGES``: the source built once for each count under
``build/codec_sweep/``, each checked bit for bit first), and the rule's
plan with nothing staged (both passes read v from HBM/L2); prints each
variant's µs and the fastest per length.  With ``--k9`` it builds K9's
source variants (:data:`K9_VARIANTS`: the source as it is; L2 policies,
codes loaded evict-first and acc stored evict-last; each tile staged in
shared memory by two 1-D bulk copies), checks each bit for bit, and times
each at the four lengths twice: K9 alone, operands out of L2, and the hop's
pair, K9 then K8 with the residual on the same row, captured together (the
next hop's K8 reads the row K9 wrote, which is what an L2 policy would
keep on chip).  ``chip_smoke.py`` is the gate.
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

# K9's variants, as edits of csrc/ring_codec.cu (each text there once).
K9_ACCESS = """__device__ __forceinline__ uint4 load_codes(const signed char* q, long long i) {
  return reinterpret_cast<const uint4*>(q)[i];
}"""
K9_STORE = """__device__ __forceinline__ void k9_store_acc(float* acc, long long i, const float4& a) {
  reinterpret_cast<float4*>(acc)[i] = a;
}"""
K9_EVICT_LOAD = """__device__ __forceinline__ uint4 load_codes(const signed char* q, long long i) {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  uint4 c;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(c.x), "=r"(c.y), "=r"(c.z), "=r"(c.w)
               : "l"(reinterpret_cast<const uint4*>(q) + i), "l"(pol));
  return c;
}"""
K9_EVICT_STORE = """__device__ __forceinline__ void k9_store_acc(float* acc, long long i, const float4& a) {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(reinterpret_cast<float4*>(acc) + i), "f"(a.x), "f"(a.y), "f"(a.z),
                  "f"(a.w), "l"(pol) : "memory");
}"""
K9_BODY = ("// K9: acc += q * scale, in place (see the note above).", "// K10's row table")
K9_BULK = r"""// K9, staged: each tile of THREADS x 16 elements comes into shared memory by
// two 1-D bulk copies (codes, acc) on one mbarrier, one phase a tile.
__global__ void __launch_bounds__(THREADS)
    decode_add_kernel(const signed char* __restrict__ q, const float* __restrict__ scale,
                      float* __restrict__ acc, long long n) {
  __shared__ __align__(128) uint32_t sq[THREADS * 4];
  __shared__ __align__(128) float4 sa[THREADS * 4];
  __shared__ __align__(8) uint64_t bar;
  const float s = __ldg(scale);
  const long long nvec = n / 16;
  const long long tiles = (nvec + THREADS - 1) / THREADS;
  const uint32_t b = smem_u32(&bar);
  if (threadIdx.x == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
    const long long v0 = t * THREADS;
    const int cnt = static_cast<int>(min(static_cast<long long>(THREADS), nvec - v0));
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(b, static_cast<uint32_t>(cnt) * 80u);
      bulk_copy(smem_u32(sq), q + v0 * 16, static_cast<uint32_t>(cnt) * 16u, b);
      bulk_copy(smem_u32(sa), acc + v0 * 16, static_cast<uint32_t>(cnt) * 64u, b);
    }
    mbar_wait(b, parity);
    for (int j = threadIdx.x; j < cnt * 4; j += THREADS) {
      const float4 d = widen4(sq[j]);
      float4 a = sa[j];
      a.x = a.x + d.x * s;
      a.y = a.y + d.y * s;
      a.z = a.z + d.z * s;
      a.w = a.w + d.w * s;
      reinterpret_cast<float4*>(acc)[v0 * 4 + j] = a;
    }
    __syncthreads();
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - nvec * 16) {
    const long long j = nvec * 16 + threadIdx.x;
    acc[j] = acc[j] + static_cast<float>(q[j]) * s;
  }
}

"""


def k9_variants() -> dict:
    """{name: edits} of K9's variants, the source as it is first."""
    text = (build.CSRC / "ring_codec.cu").read_text()
    body = text[text.index(K9_BODY[0]):text.index(K9_BODY[1])]
    return {"as_is": [], "l2_policies": [(K9_ACCESS, K9_EVICT_LOAD), (K9_STORE, K9_EVICT_STORE)],
            "bulk_staged": [(body, K9_BULK)]}


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


def sweep_k9() -> None:
    """K9's variants, each checked bit for bit and timed alone and in the
    hop's pair with K8 (see the module note)."""
    libs = build_variants("ring_codec", k9_variants(), "codec_sweep_k9")
    main_lib = build._libs["ring_codec"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    try:
        for n in smoke.CODEC_PATH_LENGTHS:
            sets = max(smoke.CODEC_SETS, math.ceil(smoke.CODEC_ROTATE_BYTES / (9 * n)))
            accs = [torch.randn(n, device="cuda", generator=gen) for _ in range(sets)]
            encs = [rc.encode_int8(0.01 * torch.randn(n, device="cuda", generator=gen))
                    for _ in range(sets)]
            acc0 = accs[0].clone()  # the timings below update accs in place
            want = rc.decode_add_int8_reference(*encs[0], acc0.clone())
            bound_us = 9 * n / smoke.HBM_BPS * 1e6
            for name, lib in libs.items():
                build._libs["ring_codec"] = lib
                if not smoke.bits_equal(torch, rc.decode_add_int8(*encs[0], acc0.clone()), want):
                    raise AssertionError(f"K9 variant {name} differs from its plain version, n={n}")
                alone = smoke.time_ms(lambda: [rc.decode_add_int8(*encs[i], accs[i])
                                               for i in range(sets)]) / sets * 1e3
                pair = smoke.time_ms(lambda: [rc.encode_int8_residual(
                    rc.decode_add_int8(*encs[i], accs[i])) for i in range(sets)]) / sets * 1e3
                print(f"k9 n={n} {name}: alone {alone:.3f} us ({bound_us / alone:.1%} of the "
                      f"{bound_us:.3f} us bound), K9 + K8 pair {pair:.3f} us", flush=True)
            del accs, encs
    finally:
        build._libs["ring_codec"] = main_lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true", help="time K8's plan variants")
    ap.add_argument("--k9", action="store_true", help="time K9's source variants")
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
                  lambda: smoke.ring_call_trace(torch),
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
    if args.k9:
        sweep_k9()
    return 0


if __name__ == "__main__":
    sys.exit(main())
