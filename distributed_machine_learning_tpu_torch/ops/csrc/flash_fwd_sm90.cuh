// The Hopper flash-attention forward mainloop shared by K1 (flash_fwd.cu:
// causal self-attention, normalized output and lse) and K11 (ring_flash.cu:
// one ring chunk step, the f32 (m, l, acc) carry in and out, causal on the
// diagonal step, unmasked on a full one).  bf16 inputs only; the f32 modes
// keep their CUDA-core kernels.
//
// What bounds it on the H100: operations (two products of depth D per
//   query-key pair at the bf16 tensor-core rate); the score matrix never
//   reaches device memory.
//
// Design (a simplified FlashAttention-3 forward): one block of 3
//   warpgroups owns a 128-row query tile of one (batch, query head).
//   Warpgroup 0 is the producer: it drops to 24 registers (setmaxnreg) and
//   one of its threads issues TMA loads (cp.async.bulk.tensor, 4-D maps
//   over the [B, L, heads, D] views with their byte strides) of the Q tile
//   once and of 128-key K and V tiles into a 2-stage ring in shared memory,
//   each stage with transaction-counted full barriers and empty barriers
//   the consumers release, K and V apart: K of a tile is free once its S
//   is in, a turn before its V, so the next K streams in a turn earlier.
//   Warpgroups 1 and 2 are the consumers (240 registers), 64 query rows
//   each.  S = Q K^T runs on wgmma m64n128k16 with both operands in shared
//   memory (K-major); O += P V on wgmma m64nDk16 with P from registers
//   and V MN-major in shared memory (the transpose bit).  Tiles are stored
//   as TMA writes them, rows of min(D, 64) bf16 in 128-byte (D 64, 128) or
//   64-byte (D 32) swizzle atoms, so a D-128 tile is two [128][64] atoms
//   side by side; the wgmma descriptors carry the same swizzle.  The softmax runs in f32 on
//   the accumulator layout in base 2 (scores times scale * log2(e), exp2).
//   The two consumers take turns on the tensor cores through two named
//   barriers ("ping-pong"): a turn issues S of tile j and P V of tile j - 1
//   together, so one warpgroup's softmax overlaps the other's products, and
//   within a warpgroup the row max and exps of tile j overlap its P V of
//   tile j - 1.  Query tiles are issued heaviest first (the diagonal makes
//   late tiles the heaviest): the tile index is the grid's slow axis.
//
// Numerics, as the plain versions: masked scores are -1e30 and their p is
//   forced to 0; keys at or past L are masked in the score (TMA's zero fill
//   is no mask: a zero key scores 0); P is rounded to bf16 before P V while
//   the row sum l uses the f32 P; the KV head of query head h is
//   h / (H / Hkv), read in place; rows at or past L are never stored.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;   // query rows per block (64 per consumer warpgroup)
constexpr int BKV = 128;  // keys per tile
constexpr int STAGES = 2;  // 3 fit at D 128 (225 KB) and measured no faster
constexpr int THREADS = 384;

enum Kind { FLASH = 0, RING_DIAGONAL = 1, RING_FULL = 2 };

struct FwdParams {
  int L, H, Hkv;        // L: K1's length or K11's chunk length Lc
  float scale_log2;
  __nv_bfloat16* out;   // K1: [B, L, H, D] through o_sb, o_sl, o_sh
  long long o_sb, o_sl, o_sh;
  float* lse;           // K1: [B, H, L]
  float *m, *l, *acc;   // K11: the contiguous f32 carry, [B, H, Lc] and [B, Lc, H, D]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map, coordinates (d, head, row, batch), into shared
// memory; completion is counted on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across the fences and waits around it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------- wgmma wrappers
// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n32(d, a, db);
  }
}

// Shared-memory geometry of a 128-row tile of head dim D as TMA writes it.
template <int D>
struct Tile {
  static constexpr int ATOM = D < 64 ? D : 64;  // bf16 a swizzle-atom row
  static constexpr int ROW_BYTES = ATOM * 2;     // 128 (D 64, 128) or 64 (D 32)
  static constexpr int ATOMS = D / ATOM;         // atom columns side by side
  static constexpr int ATOM_BYTES = BKV * ROW_BYTES;
  static constexpr int BYTES = ATOMS * ATOM_BYTES;
  static constexpr uint32_t SWIZZLE = ROW_BYTES == 128 ? 1 : 2;  // descriptor layout type
  static constexpr uint32_t GROUP = 8 * ROW_BYTES;  // 8 rows: the descriptors' stride offset
  static constexpr int KSTEPS = ATOM / 16;           // k-steps of 16 inside an atom row
  // Q, K and V stages, the barriers, and room to align the base to 1024.
  static constexpr int SMEM = BYTES * (1 + 2 * STAGES) + 8 * (1 + 4 * STAGES) + 1024;
};

template <int D, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using T = Tile<D>;
  constexpr bool CAUSAL = KIND != RING_FULL;
  extern __shared__ unsigned char sm90_smem[];
  const uint32_t base = (smem_u32(sm90_smem) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t sQ = base, sK = base + T::BYTES, sV = sK + STAGES * T::BYTES;
  const uint32_t bars = sV + STAGES * T::BYTES;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int L = p.L, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / p.Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (latest) query tiles first
  const int q0 = qt * BQ;
  // The diagonal walks key tiles 0..qt (BQ == BKV); a full step all of them.
  const int n_tiles = CAUSAL ? qt + 1 : (L + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, T::BYTES);
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load(sQ + a * T::ATOM_BYTES, &tq, full_q, a * T::ATOM, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // K of tile j - STAGES is free once both consumers have its S; V once
        // they have its P V, a turn later.
        if (j >= STAGES) mbar_wait(empty_k(s), (j / STAGES - 1) & 1);
        mbar_expect_tx(full_k(s), T::BYTES);
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sK + s * T::BYTES + a * T::ATOM_BYTES, &tk, full_k(s), a * T::ATOM, hk,
                   j * BKV, b);
        if (j >= STAGES) mbar_wait(empty_v(s), (j / STAGES - 1) & 1);
        mbar_expect_tx(full_v(s), T::BYTES);
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sV + s * T::BYTES + a * T::ATOM_BYTES, &tv, full_v(s), a * T::ATOM, hk,
                   j * BKV, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;  // this consumer's 64 rows: c * 64 .. c * 64 + 63 of the tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wr = c * 64 + warp * 16;  // this warp's first row inside the tile
    const float scale_log2 = p.scale_log2;
    // Ping-pong: consumer c issues its products after bar.sync on barrier
    // 1 + c, then lets the other one go (bar.arrive on 2 - c).  Consumer 1
    // opens the first turn to consumer 0 and skips its last arrival, so
    // every arrival is matched.
    if (c == 1) named_arrive(1);
    auto turn_begin = [&]() { named_sync(1 + c); };
    auto turn_end = [&](bool last) {
      if (!(last && c == 1)) named_arrive(2 - c);
    };

    // The accumulator layout (wgmma m64nN, f32): element i of a thread is
    // row g + 8 * ((i >> 1) & 1) of its warp's 16 and column
    // (i >> 2) * 8 + 2t + (i & 1).
    float s[BKV / 2];
    float o[D / 2];
    uint32_t pf[BKV / 16][4];
    float m_run[2], l_run[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + g + half * 8;
      if constexpr (KIND == FLASH) {
        m_run[half] = NEG_INF;
        l_run[half] = 0.f;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) o[4 * nd + 2 * half] = o[4 * nd + 2 * half + 1] = 0.f;
      } else {
        const bool has_carry = row < L;  // padded rows start empty
        const long long r = static_cast<long long>(bh) * L + row;
        m_run[half] = has_carry ? p.m[r] : NEG_INF;
        l_run[half] = has_carry && t == 0 ? p.l[r] : 0.f;  // the quad's shares of l
        const float* ar = p.acc + ((static_cast<long long>(b) * L + (has_carry ? row : 0)) * H + h) * D;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const float2 a = has_carry ? *reinterpret_cast<const float2*>(ar + nd * 8 + 2 * t)
                                     : make_float2(0.f, 0.f);
          o[4 * nd + 2 * half] = a.x;
          o[4 * nd + 2 * half + 1] = a.y;
        }
      }
    }

    // Descriptor bases; a k-step adds its byte offset / 16 to the start
    // address field.  The bases pass through an empty asm in every turn, so
    // the compiler rebuilds the step descriptors there (two adds each)
    // instead of holding them all in registers across the loop.
    const uint64_t q_desc = smem_desc(sQ + c * 64 * T::ROW_BYTES, 16, T::GROUP, T::SWIZZLE);
    const uint64_t k_desc = smem_desc(sK, 16, T::GROUP, T::SWIZZLE);
    const uint64_t v_desc = smem_desc(sV, T::ATOM_BYTES, T::GROUP, T::SWIZZLE);
    // S = Q K^T of this consumer's 64 rows and the 128 keys of stage st.
    auto gemm_s = [&](int st) {
      uint64_t dq = q_desc, dk = k_desc + st * (T::BYTES >> 4);
      asm volatile("" : "+l"(dq), "+l"(dk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / T::KSTEPS) * T::ATOM_BYTES + (kk % T::KSTEPS) * 32) >> 4;
        wgmma_ss_n128(s, dq + off, dk + off, kk > 0);
      }
    };
    // O += P V over the 128 keys of stage st (V MN-major: the leading
    // offset steps between atom columns, the stride offset between 8 keys).
    auto gemm_pv = [&](int st) {
      uint64_t dv = v_desc + st * (T::BYTES >> 4);
      asm volatile("" : "+l"(dv));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<D>(o, pf[kk], dv + ((kk * 16 * T::ROW_BYTES) >> 4));
    };
    // Turn tile j's scores into f32 probabilities in place, in log2 space
    // (score * scale * log2(e)); updates m and this thread's share of l
    // (the quad's four shares are summed once, after the last tile) and
    // returns each row's alpha.  Only the diagonal tile (causal) and a tile
    // reaching past L hold masked keys: they take the path that masks and
    // forces a masked p to 0; every other tile takes one FFMA and one exp2
    // a score.
    auto softmax = [&](int j, float* alpha) {
      const bool edge = (CAUSAL && j == qt) || ((j + 1) * BKV > L);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          float val = s[i] * scale_log2;
          const int key = j * BKV + (i >> 2) * 8 + 2 * t + (i & 1);
          const int row = q0 + wr + g + ((i >> 1) & 1) * 8;
          if ((CAUSAL && key > row) || key >= L) val = NEG_INF;
          s[i] = val;
        }
      }
      const float sc = edge ? 1.f : scale_log2;  // the scale still to apply
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 2 * half; i < BKV / 2; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[half], mx * sc);
        alpha[half] = fast_exp2(m_run[half] - m_new);
        m_run[half] = m_new;
        float rowsum = 0.f;
        if (edge) {
#pragma unroll
          for (int i = 2 * half; i < BKV / 2; i += 4)
#pragma unroll
            for (int e = i; e < i + 2; ++e) {
              const float pv = s[e] > 0.5f * NEG_INF ? fast_exp2(s[e] - m_new) : 0.f;
              s[e] = pv;
              rowsum += pv;
            }
        } else {
#pragma unroll
          for (int i = 2 * half; i < BKV / 2; i += 4)
#pragma unroll
            for (int e = i; e < i + 2; ++e) {
              const float pv = fast_exp2(fmaf(s[e], scale_log2, -m_new));
              s[e] = pv;
              rowsum += pv;
            }
        }
        l_run[half] = l_run[half] * alpha[half] + rowsum;
      }
    };
    // O *= alpha, then P = bf16(p): the S accumulator layout of 16 keys is
    // the A-fragment layout of one k-step of P V.
    auto rescale_and_pack = [&](const float* alpha) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pf[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    float alpha[2];
    mbar_wait(full_q, 0);
    mbar_wait(full_k(0), 0);
    turn_begin();
    wgmma_fence();
    gemm_s(0);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    fence_regs<BKV / 2>(s);
    if (lane == 0) mbar_arrive(empty_k(0));  // this warp is done with K of tile 0
    softmax(0, alpha);
    rescale_and_pack(alpha);

    for (int j = 1; j < n_tiles; ++j) {
      const int sj = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(full_k(sj), (j / STAGES) & 1);
      mbar_wait(full_v(sp), ((j - 1) / STAGES) & 1);
      turn_begin();
      fence_regs<D / 2>(o);
      fence_regs<BKV / 4>(&pf[0][0]);
      wgmma_fence();
      gemm_s(sj);
      wgmma_commit();
      gemm_pv(sp);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();  // S of tile j is in; P V of tile j - 1 may still run
      fence_regs<BKV / 2>(s);
      if (lane == 0) mbar_arrive(empty_k(sj));
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_regs<BKV / 4>(&pf[0][0]);
      if (lane == 0) mbar_arrive(empty_v(sp));
      rescale_and_pack(alpha);
    }
    const int last = n_tiles - 1;
    mbar_wait(full_v(last % STAGES), (last / STAGES) & 1);
    turn_begin();
    fence_regs<D / 2>(o);
    fence_regs<BKV / 4>(&pf[0][0]);
    wgmma_fence();
    gemm_pv(last % STAGES);
    wgmma_commit();
    turn_end(true);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);
      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + g + half * 8;
      if (row >= L) continue;
      const long long r = static_cast<long long>(bh) * L + row;
      if constexpr (KIND == FLASH) {
        // out = acc / max(l, 1e-30) in bf16; lse = m + log2(max(l, 1e-30)).
        const float l_safe = fmaxf(l_run[half], 1e-30f);
        const float inv = 1.f / l_safe;
        if (t == 0) p.lse[r] = m_run[half] + log2f(l_safe);
        __nv_bfloat16* orow = p.out + b * p.o_sb + h * p.o_sh + row * p.o_sl;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
          *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t) = __floats2bfloat162_rn(
              o[4 * nd + 2 * half] * inv, o[4 * nd + 2 * half + 1] * inv);
      } else {
        // The carry out: m, l and the unnormalized acc.
        if (t == 0) {
          p.m[r] = m_run[half];
          p.l[r] = l_run[half];
        }
        float* ar = p.acc + ((static_cast<long long>(b) * L + row) * H + h) * D;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
          *reinterpret_cast<float2*>(ar + nd * 8 + 2 * t) =
              make_float2(o[4 * nd + 2 * half], o[4 * nd + 2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map of a bf16 [B, L, heads, D] view with element strides (sb,
// sl, sh), boxes of 128 rows of one head and min(D, 64) dims.  The stride
// of a dim of extent 1 is never used; it is replaced by a legal one.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int heads, long long sb,
              long long sl, long long sh) {
  using T = Tile<D>;
  EncodeTiled encode = encoder();
  if (!encode) return false;
  if (heads == 1) sh = D;
  if (L == 1) sl = heads * sh;
  if (B == 1) sb = L * sl;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::ATOM), 1, static_cast<cuuint32_t>(BKV), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the forward of kind KIND: q [B, L, H, D], k and v [B, L, Hkv, D]
// with element strides st = (q: b, l, h; k: b, l, h; v: b, l, h).
template <int D, int KIND>
int launch_fwd(const void* q, const void* k, const void* v, const long long* st, int B,
               const FwdParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, B, p.L, p.H, st[0], st[1], st[2]) ||
      !make_map<D>(&tk, k, B, p.L, p.Hkv, st[3], st[4], st[5]) ||
      !make_map<D>(&tv, v, B, p.L, p.Hkv, st[6], st[7], st[8]))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Tile<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel<D, KIND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid(B * p.H, (p.L + BQ - 1) / BQ);
  fwd_kernel<D, KIND><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
